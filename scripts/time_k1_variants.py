"""Where K1's time goes, from edited copies of it, on a CUDA card.

    python3 scripts/time_k1_variants.py [--shapes long16,main] [--reps 7]

Builds, under ``build/time_k1_variants/``, copies of
``tombo_tpu_torch/csrc/banded_dp.cu`` (with its headers), each with one
edit, compiled with the port's own nvcc flags:

  base          K1 as it is
  two_ballot    the walk row without the dependent read of the found
                move (a second ballot of the codes equal to 2), bitwise
                K1's walk
  no_walk       no walk (outputs wrong: time only)
  no_walk_moves no walk and no move stores (the forward alone, as K2)
  window32      walk windows of 32 rows (K1: 64)
  window128     walk windows of 128 rows, twice the shared memory

and times each, in turns and twice over, on ``scripts/time_k1.py``'s
inputs: one JSON line per shape, variant and round with the CUDA-event
median ms and whether the outputs are bitwise ``base``'s.  base less
no_walk is the walk's time; no_walk less no_walk_moves the move stores'.
"""
import argparse
import ctypes
import hashlib
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "time_k1_variants")
CSRC = os.path.join(ROOT, "tombo_tpu_torch", "csrc")

TWO_BALLOT = '''
__device__ inline long long walk_row(const uint8_t* row, long long bsr,
                                     long long ep, int bw, int bound_thresh,
                                     bool& berr) {
  const int lane = threadIdx.x & 31;
  long long bp = ep - bsr;
  if (bp < 0) bp = 0;
  if (bp > bw - 1) bp = bw - 1;
  int pos = -1, two = 0;
  for (int b0 = (int)bp; b0 >= 0; b0 -= 32) {
    const int q = b0 - lane;
    const int m = q >= 0 ? row[q] : 0;
    const unsigned nz = __ballot_sync(FULL, m != 0);
    const unsigned t2 = __ballot_sync(FULL, m == 2);
    if (nz) {
      const int l = __ffs(nz) - 1;
      pos = b0 - l;
      two = (t2 >> l) & 1;
      break;
    }
  }
  if (pos < 0) { pos = 0; two = row[0] == 2; }
  const long long bp2 = two ? pos - 1 : pos;
  const long long edge = bp2 < bw - bp2 - 1 ? bp2 : bw - bp2 - 1;
  if (edge < bound_thresh) berr = true;
  return bsr + bp2;
}
'''
NO_WALK = [("for (int w = 0; w < n_win; ++w) {",
            "for (int w = 0; w < 0; ++w) {"),
           ("  if (n_win > 0) copy_window(0);\n", "")]
VARIANTS = {
    "base": [],
    "two_ballot": [("using namespace dprow;\n",
                    "using namespace dprow;\n" + TWO_BALLOT),
                   ("ep = tb_row(row,", "ep = walk_row(row,")],
    "no_walk": NO_WALK,
    "no_walk_moves": NO_WALK + [("LatRows<MAXI, true> rw",
                                 "LatRows<MAXI, false> rw")],
    "window32": [("constexpr int WALK_ROWS = 64;",
                  "constexpr int WALK_ROWS = 32;")],
    "window128": [("constexpr int WALK_ROWS = 64;",
                   "constexpr int WALK_ROWS = 128;"),
                  ("constexpr int WALK_SMEM = 40 * 1024;",
                   "constexpr int WALK_SMEM = 80 * 1024;")],
}


def build(kernels):
    """Every variant's library, all nvcc processes started together."""
    base = open(os.path.join(CSRC, "banded_dp.cu")).read()
    procs = {}
    for name, edits in VARIANTS.items():
        src = base
        for a, b in edits:
            if src.count(a) != 1:
                raise SystemExit("%s: anchor not found once: %r" % (name, a))
            src = src.replace(a, b)
        d = os.path.join(OUT, name)
        os.makedirs(d, exist_ok=True)
        for h in ("dp_row.cuh", "dp_row_lat.cuh"):
            shutil.copy(os.path.join(CSRC, h), d)
        with open(os.path.join(d, "banded_dp.cu"), "w") as f:
            f.write(src)
        procs[name] = subprocess.Popen(
            [kernels.find_nvcc()] + kernels.NVCC_FLAGS +
            ["-o", os.path.join(d, "lib.so"), os.path.join(d, "banded_dp.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit("%s: build failed\n%s" % (name, out))
        libs[name] = ctypes.CDLL(os.path.join(OUT, name, "lib.so"))
    return libs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", default="long16,main,start_retry,save")
    ap.add_argument("--reps", type=int, default=7)
    opt = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    from tombo_tpu_torch import kernels
    from tombo_tpu_torch.ops import banded_dp, dp
    spec = importlib.util.spec_from_file_location(
        "time_k1", os.path.join(ROOT, "scripts", "time_k1.py"))
    tk1 = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tk1)

    libs = build(kernels)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    table = tk1.shapes(0)
    for shape in opt.shapes.split(","):
        arrays, params, L, P, thresh = table[shape]()
        args = [torch.tensor(a, device="cuda") for a in arrays]
        p = dp.DpParams(**params)
        call = lambda: banded_dp.adaptive_banded_dp_tb(*args, p, L, P,
                                                       thresh)
        ref = None
        for rnd in range(2):
            for name, lib in libs.items():
                kernels._LIBS["banded_dp"] = lib   # the wrapper launches it
                out = call()
                torch.cuda.synchronize()
                h = hashlib.sha256(b"".join(
                    x.cpu().numpy().tobytes() for x in out)).hexdigest()
                ref = h if name == "base" else ref
                ms = []
                for _ in range(opt.reps):
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    call()
                    b.record()
                    b.synchronize()
                    ms.append(a.elapsed_time(b))
                print(json.dumps({
                    "card": smi, "shape": shape, "B": len(arrays[0]),
                    "L": L, "bw": params["bandwidth"], "variant": name,
                    "round": rnd, "ms": statistics.median(ms),
                    "bitwise_base": h == ref}), flush=True)


if __name__ == "__main__":
    main()
