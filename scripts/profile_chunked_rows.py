"""Cycle profile of the chunked DP pair's row step on a CUDA card.

    python3 scripts/profile_chunked_rows.py [--rows 32768] [--reads 16]

Builds, under ``build/profile_chunked_rows/``, a copy of
``tombo_tpu_torch/csrc/banded_dp_chunked.cu`` and its headers with
``clock64()`` marks between the phases of ``dp_row_lat.cuh``'s row step
and around K2''s recompute, walk and cluster barriers, compiled with the
port's own nvcc flags.  Block 0, thread 0 adds each phase's cycles to a
device array, so the marks cost that one thread a global add a phase.
It runs K2 then K2' on the synthetic long reads of
``scripts/time_chunked_pair.py`` at bw 300 and 1500 and prints one JSON
line per kernel: cycles per row of block 0 by phase (K2), and block 0's
recompute, walk and barrier-wait cycles (K2').  The instrumented copy is
slower than the kernels it copies; read the shares, not the totals.
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
# K2' spans: 10 recompute, 11 walk, 12 cluster barrier waits, 13 other
TB_EDITS = [
    ("    if (c >= 0) {\n      for (int q = tid; q < bw; q += nt)\n",
     "    TB_MARK(13);\n"),
    ("      __syncthreads();         // the tile is whole\n    }\n", None),
    ("        if (tid == 0) {\n          if (c > 0) {", "        TB_MARK(11);\n"),
    ("      cluster.sync();\n    }\n  }\n", None),
    ("  cluster.sync();              // every block running, block 0's carry"
     " set\n", None),
]


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
    cu += ("\nextern \"C\" int probe_read(unsigned long long* out) {\n"
           "  return (int)cudaMemcpyFromSymbol(out, dplat::g_probe,\n"
           "                                   sizeof(dplat::g_probe));\n}\n"
           "extern \"C\" int probe_reset() {\n"
           "  unsigned long long z[16] = {0};\n"
           "  return (int)cudaMemcpyToSymbol(dplat::g_probe, z, sizeof(z));"
           "\n}\n")
    return {"dp_row_lat.cuh": lat, "banded_dp_chunked.cu": cu,
            "dp_row.cuh": open(os.path.join(csrc, "dp_row.cuh")).read()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=32768)
    ap.add_argument("--reads", type=int, default=16)
    opt = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    from tombo_tpu_torch import kernels
    from tombo_tpu_torch.ops import banded_dp, dp
    spec = importlib.util.spec_from_file_location(
        "time_chunked_pair", os.path.join(ROOT, "scripts",
                                          "time_chunked_pair.py"))
    tcp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tcp)

    os.makedirs(OUT, exist_ok=True)
    for name, text in instrumented_sources().items():
        with open(os.path.join(OUT, name), "w") as f:
            f.write(text)
    lib_path = os.path.join(OUT, "libprofile.so")
    out = subprocess.run([kernels.find_nvcc()] + kernels.NVCC_FLAGS +
                         ["-o", lib_path,
                          os.path.join(OUT, "banded_dp_chunked.cu")],
                         capture_output=True, text=True)
    if out.returncode != 0:
        sys.exit(out.stdout + out.stderr)
    lib = ctypes.CDLL(lib_path)
    kernels._LIBS["banded_dp_chunked"] = lib   # the wrappers launch this
    B = opt.reads
    for bw, L in ((300, opt.rows), (1500, min(opt.rows, 8192))):
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
                              "cluster_waits": tb[12], "other": tb[13]}}))


if __name__ == "__main__":
    main()
