"""Cycle profile of the DP kernels' row step on a CUDA card.

    python3 scripts/profile_chunked_rows.py [--rows 32768] [--reads 16]
        [--kernels pair,k1]

Builds, under ``build/profile_chunked_rows/``, copies of
``tombo_tpu_torch/csrc/banded_dp_chunked.cu`` and ``banded_dp.cu`` and
their headers with ``clock64()`` marks between the phases of
``dp_row_lat.cuh``'s row step, around K2''s recompute, walk and cluster
barriers, and around K1's row loop and walk, compiled with the port's own
nvcc flags.  Block 0, thread 0 adds each phase's cycles to a device array,
so the marks cost that one thread a global add a phase.  ``pair`` runs K2
then K2' on the synthetic long reads of ``scripts/time_chunked_pair.py``
at bw 300 and 1500 and prints one JSON line per kernel: cycles per row of
block 0 by phase (K2), and block 0's recompute, walk and barrier-wait
cycles (K2').  ``k1`` runs K1 at bw 300 on ``scripts/time_k1.py``'s
``long16`` (16 reads of up to 16,384 rows, fewer reads than SMs) and
``main`` (512 reads of 1,024 rows, ~4 an SM) inputs and prints block 0's
cycles per row by phase and its walk's cycles per row: where a row costs
about the same at both, one row's latency bounds the kernel; where it
costs about reads-an-SM times more at 512, the SM's issue does.  The
instrumented copies are slower than the kernels they copy; read the
shares and ratios, not the totals.
"""
import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "profile_chunked_rows")

# row-step phases: a mark goes before each anchor of dp_row_lat.cuh
PHASES = [
    ("place+stage", "    // Positions q0 + j, j < ipt, of this thread."),
    ("loads", "    float zq[MAXI];\n"),
    ("divisions",
     "    float zs[MAXI], dg[MAXI], sk[MAXI], cf[MAXI], um[MAXI], f[MAXI];\n"),
    ("positions",
     "    // exclusive prefix sum of run in thread order (barrier 1)\n"),
    ("sum scan", "    float mx = -INFINITY;\n"),
    ("cf/u/max",
     "    // exclusive running max in thread order (barrier 2)\n"),
    ("max scan", "    // the new row, and its first argmax for the next row"),
    ("row + local argmax",
     "    amax = block_argmax(bv, bi, s, ri == STAGE_ROWS - 1);\n"),
    ("argmax exchange", "    if (MOVES) {\n"),
    ("moves", "    float* t = fp; fp = fc; fc = t;\n"),
]
MARK = ("#define PROBE_MARK(i) do { long long _t = clock64(); "
        "if (threadIdx.x == 0 && blockIdx.x == 0) g_probe[i] += _t - _pt; "
        "_pt = _t; } while (0)\n")
TB_MARK = ("#define TB_MARK(i) do { long long _t = clock64(); "
           "if (threadIdx.x == 0 && blockIdx.x == 0) dplat::g_probe[i] += "
           "_t - _tp; _tp = _t; } while (0)\n")
# K2' spans: 10 recompute, 11 walk, 12 cluster barrier waits, 13 other;
# K1 spans: 14 row loop (with its start), 15 walk (with its copies)
TB_EDITS = [
    ("    if (c >= 0) {\n      for (int q = tid; q < bw; q += nt)\n",
     "    TB_MARK(13);\n"),
    ("      __syncthreads();         // the tile is whole\n    }\n", None),
    ("        if (tid == 0) {\n          if (c > 0) {", "        TB_MARK(11);\n"),
    ("      cluster.sync();\n    }\n  }\n", None),
    ("  cluster.sync();              // every block running, block 0's carry"
     " set\n", None),
]


K1_MARK = ("#define K1_MARK(i) do { long long _t = clock64(); "
           "if (threadIdx.x == 0 && blockIdx.x == 0) dplat::g_probe[i] += "
           "_t - _kp; _kp = _t; } while (0)\n")
K1_EDITS = [
    ("  rw.begin(0, rows, ps0);\n", "  long long _kp = clock64();\n", None),
    ("  // The final row is row seq_len - 1", "  K1_MARK(14);\n", None),
    ("  __syncthreads();             // the scratch rows written, the "
     "final row read\n", None, "  _kp = clock64();\n"),
    ("  if (tid == 0) {\n    if (sl >= 0 && sl <= L)", "  K1_MARK(15);\n",
     None),
]
PROBE_FNS = ("\nextern \"C\" int probe_read(unsigned long long* out) {\n"
             "  return (int)cudaMemcpyFromSymbol(out, dplat::g_probe,\n"
             "                                   sizeof(dplat::g_probe));\n}\n"
             "extern \"C\" int probe_reset() {\n"
             "  unsigned long long z[16] = {0};\n"
             "  return (int)cudaMemcpyToSymbol(dplat::g_probe, z, sizeof(z));"
             "\n}\n")


def instrumented_sources():
    csrc = os.path.join(ROOT, "tombo_tpu_torch", "csrc")
    lat = open(os.path.join(csrc, "dp_row_lat.cuh")).read()
    for i, (_, anchor) in enumerate(PHASES):
        if lat.count(anchor) != 1:
            raise SystemExit("anchor not found once: %r" % anchor)
        lat = lat.replace(anchor, "    PROBE_MARK(%d);\n" % i + anchor)
    lat = lat.replace(
        "  __device__ long long step(int r, uint8_t* mv) {\n",
        "  __device__ long long step(int r, uint8_t* mv) {\n"
        "    long long _pt = clock64();\n")
    lat = lat.replace("namespace dplat {\n", "namespace dplat {\n"
                      "__device__ unsigned long long g_probe[16];\n" + MARK, 1)
    cu = open(os.path.join(csrc, "banded_dp_chunked.cu")).read()
    for anchor, _ in TB_EDITS:
        if cu.count(anchor) != 1:
            raise SystemExit("anchor not found once: %r" % anchor)
    cu = cu.replace(TB_EDITS[0][0], TB_EDITS[0][1] + TB_EDITS[0][0])
    cu = cu.replace(TB_EDITS[1][0], TB_EDITS[1][0] + "    TB_MARK(10);\n")
    cu = cu.replace(TB_EDITS[2][0], TB_EDITS[2][1] + TB_EDITS[2][0])
    cu = cu.replace(TB_EDITS[3][0], "      TB_MARK(13);\n      cluster.sync();"
                    "\n      TB_MARK(12);\n    }\n  }\n")
    cu = cu.replace(TB_EDITS[4][0], TB_EDITS[4][0] +
                    "  long long _tp = clock64();\n")
    cu = cu.replace('#include "dp_row_lat.cuh"\n',
                    '#include "dp_row_lat.cuh"\n' + TB_MARK)
    cu += PROBE_FNS
    k1 = open(os.path.join(csrc, "banded_dp.cu")).read()
    for anchor, before, after in K1_EDITS:
        if k1.count(anchor) != 1:
            raise SystemExit("anchor not found once: %r" % anchor)
        k1 = k1.replace(anchor, (before or "") + anchor + (after or ""))
    k1 = k1.replace('#include "dp_row_lat.cuh"\n',
                    '#include "dp_row_lat.cuh"\n' + K1_MARK) + PROBE_FNS
    return {"dp_row_lat.cuh": lat, "banded_dp_chunked.cu": cu,
            "banded_dp.cu": k1,
            "dp_row.cuh": open(os.path.join(csrc, "dp_row.cuh")).read()}


def build(kernels, name):
    """The instrumented copy of csrc/<name>.cu, built and loaded."""
    lib_path = os.path.join(OUT, "lib%s_profile.so" % name)
    out = subprocess.run([kernels.find_nvcc()] + kernels.NVCC_FLAGS +
                         ["-o", lib_path, os.path.join(OUT, name + ".cu")],
                         capture_output=True, text=True)
    if out.returncode != 0:
        sys.exit(out.stdout + out.stderr)
    lib = ctypes.CDLL(lib_path)
    kernels._LIBS[name] = lib       # the wrappers launch this copy
    return lib


def profile_k1(torch, kernels, banded_dp, dp, tk1):
    """K1's block 0 by row-step phase, at a latency-bound and an
    issue-bound shape."""
    lib = build(kernels, "banded_dp")
    buf = (ctypes.c_ulonglong * 16)()
    for shape in ("long16", "main"):
        arrays, params, L, P, thresh = tk1.shapes(0)[shape]()
        args = [torch.tensor(a, device="cuda") for a in arrays]
        p = dp.DpParams(**params)
        rows0 = int(min(int(arrays[4][0]), L))
        banded_dp.adaptive_banded_dp_tb(*args, p, L, P, thresh)
        torch.cuda.synchronize()
        lib.probe_reset()
        banded_dp.adaptive_banded_dp_tb(*args, p, L, P, thresh)
        torch.cuda.synchronize()
        lib.probe_read(buf)
        c = list(buf)
        print(json.dumps({
            "card": torch.cuda.get_device_name(0), "kernel": "K1",
            "shape": shape, "B": len(arrays[0]), "L": L,
            "bw": params["bandwidth"], "block0_rows": rows0,
            "blocks_per_sm": banded_dp.banded_dp_occupancy(
                params["bandwidth"])[2],
            "cycles_per_row": {n: c[i] / rows0
                               for i, (n, _) in enumerate(PHASES)},
            "total_per_row": sum(c[:len(PHASES)]) / rows0,
            "row_loop_per_row": c[14] / rows0,
            "walk_per_row": c[15] / rows0}), flush=True)


def profile_pair(torch, kernels, banded_dp, dp, tcp, rows, B):
    """K2's block 0 by row-step phase, K2''s by span."""
    lib = build(kernels, "banded_dp_chunked")
    for bw, L in ((300, rows), (1500, min(rows, 8192))):
        arrays, P = tcp.synthetic_reads(B, L, bw, 0)
        args = [torch.tensor(a, device="cuda") for a in arrays]
        p = dp.DpParams(z_shift=2.0, skip_pen=4.0, stay_pen=4.2,
                        mask_fill_z_score=-10.0, max_half_z_score=5.0,
                        bandwidth=bw)
        rows0 = int(min(int(arrays[4][0]), L))
        buf = (ctypes.c_ulonglong * 16)()
        marks = []
        orig = kernels.count_launch

        def mark(name):
            orig(name)
            if name == "banded_dp_chunked_fwd":
                torch.cuda.synchronize()
                lib.probe_read(buf)
                marks.append(list(buf))
                lib.probe_reset()

        banded_dp.adaptive_banded_dp_tb_chunked(*args, p, L, P, 40)
        torch.cuda.synchronize()
        lib.probe_reset()
        kernels.count_launch = mark
        try:
            banded_dp.adaptive_banded_dp_tb_chunked(*args, p, L, P, 40)
        finally:
            kernels.count_launch = orig
        torch.cuda.synchronize()
        lib.probe_read(buf)
        fwd, tb = marks[0], list(buf)
        card = torch.cuda.get_device_name(0)
        print(json.dumps({
            "card": card, "kernel": "K2", "B": B, "L": L, "bw": bw,
            "block0_rows": rows0,
            "cycles_per_row": {n: fwd[i] / rows0
                               for i, (n, _) in enumerate(PHASES)},
            "total_per_row": sum(fwd[:len(PHASES)]) / rows0}))
        print(json.dumps({
            "card": card, "kernel": "K2'", "B": B, "L": L, "bw": bw,
            "block0_cycles": {"recompute": tb[10], "walk": tb[11],
                              "cluster_waits": tb[12], "other": tb[13]}}),
              flush=True)


def load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=32768)
    ap.add_argument("--reads", type=int, default=16)
    ap.add_argument("--kernels", default="pair,k1")
    opt = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    from tombo_tpu_torch import kernels
    from tombo_tpu_torch.ops import banded_dp, dp

    os.makedirs(OUT, exist_ok=True)
    for name, text in instrumented_sources().items():
        with open(os.path.join(OUT, name), "w") as f:
            f.write(text)
    which = opt.kernels.split(",")
    if "pair" in which:
        profile_pair(torch, kernels, banded_dp, dp,
                     load_script("time_chunked_pair"), opt.rows, opt.reads)
    if "k1" in which:
        profile_k1(torch, kernels, banded_dp, dp, load_script("time_k1"))


if __name__ == "__main__":
    main()
