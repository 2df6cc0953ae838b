"""Time the PyTorch/CUDA port's fused DP kernel (K1) on a CUDA card, and
check that another version of it gives the same outputs bit for bit.

    python3 scripts/time_k1.py [--tree DIR] [--save FILE] [--against FILE]
        [--reps 10] [--seed 0] [--shapes main,start,...]

The inputs are made from ``--seed`` with numpy, so every run on every tree
sees the same bytes.  The shapes:

  main          512 reads, L 1024, bw 300 (the 1 kb path's adaptive DP)
  start         512 reads, L 250, bw 750 (start discovery, static band)
  start_retry   16 reads, L 250, bw 2500 (the start retry's band)
  save          16 reads, L 1024, bw 1500 (the save-bandwidth retry)
  long16, long45, long128
                16, 45 and 128 reads, L 16,384, bw 300, read lengths
                uniform in [0.5, 1] x L (one length group of the mixed
                path's longest fused call)
  edge<bw>_<n>  1 read, L 256, seq_len n in 0, 1, L, L + 5, at bw 32, 300
                and 2500 (outputs only, no time)

Adaptive reads follow ``scripts/time_chunked_pair.py``: event means track
the read's reference levels at 1.4 events per base with noise of one
reference sd, so the band moves along the read as on real reads.  The
start shapes use the start-discovery parameterization of
``ops/banded_dp.py::start_dp_segs``.  ``--tree DIR`` imports
``tombo_tpu_torch`` from another checkout (the parent commit unpacked
under ``build/``), so two versions run in turns on one card in one chip
call.  Per shape it prints one JSON line: the card's name and power
limit, the CUDA-event median ms over ``--reps`` calls after one warm-up
call, the peak device bytes of one call, K1's bound (``chip_smoke.py``'s
``k1_bound_ms``: the larger of its bytes over the memory rate and its
band cells' operations over the float32 rate), a SHA-256 of the outputs
(segs, band and bound flags, final row) and, with ``--against`` (a file
written by ``--save`` on another run), whether they are bitwise that
run's.
"""
import argparse
import hashlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys

import numpy as np

INT32_MAX = 2 ** 31 - 1
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LONG_ROWS = 16384


def adaptive_reads(B, L, bw, lo, seed):
    """Synthetic mapped reads, lengths uniform in [lo, 1] x L."""
    rng = np.random.default_rng(seed)
    ratio = 1.4
    E = int(L * ratio) + bw
    rm = rng.normal(0, 1, (B, L)).astype(np.float32)
    rs = rng.uniform(0.08, 0.15, (B, L)).astype(np.float32)
    base = np.minimum((np.arange(E) / ratio).astype(np.int64), L - 1)
    em = (rm[:, base] + rng.normal(0, 1, (B, E)).astype(np.float32) *
          rs[:, base]).astype(np.float32)
    seq_lens = rng.integers(int(lo * L), L + 1, B)
    n_events = np.minimum((seq_lens * ratio).astype(np.int64) + bw // 2, E)
    arrays = (em, n_events, rm, rs, seq_lens, np.zeros((B, 1), np.int64),
              np.zeros(B, np.int64), np.full((B, 1), INT32_MAX, np.int64),
              np.zeros(B, np.int64))
    params = dict(z_shift=2.0, skip_pen=4.0, stay_pen=4.2,
                  mask_fill_z_score=-10.0, max_half_z_score=5.0,
                  bandwidth=bw)
    return arrays, params, L, 1, 40


def start_reads(B, nb, ne, seed):
    """Start discovery's inputs: nb bases against nb + ne events, band
    starts arange(nb) on every row, no masking."""
    rng = np.random.default_rng(seed)
    rm = rng.normal(0, 1, (B, nb)).astype(np.float32)
    rs = rng.uniform(0.08, 0.15, (B, nb)).astype(np.float32)
    em = rng.normal(0, 1, (B, nb + ne)).astype(np.float32)
    em[:, :nb] = rm + rng.normal(0, 1, (B, nb)).astype(np.float32) * rs
    full = lambda v: np.full(B, v, np.int64)
    arrays = (em, full(nb + ne), rm, rs, full(nb),
              np.broadcast_to(np.arange(nb), (B, nb)).copy(), full(0),
              np.full((B, nb), INT32_MAX, np.int64), full(nb))
    params = dict(z_shift=2.0, skip_pen=4.0, stay_pen=4.2,
                  mask_fill_z_score=0.0, max_half_z_score=5.0, bandwidth=ne)
    return arrays, params, nb, nb, -1


def shapes(seed):
    out = {
        "main": lambda: adaptive_reads(512, 1024, 300, 0.95, seed),
        "start": lambda: start_reads(512, 250, 750, seed),
        "start_retry": lambda: start_reads(16, 250, 2500, seed),
        "save": lambda: adaptive_reads(16, 1024, 1500, 0.95, seed),
    }
    for B in (16, 45, 128):
        out["long%d" % B] = (lambda B=B: adaptive_reads(
            B, LONG_ROWS, 300, 0.5, seed))
    for bw in (32, 300, 2500):
        for n in (0, 1, 256, 261):
            def edge(bw=bw, n=n):
                arrays, params, L, P, th = adaptive_reads(1, 256, bw, 1.0,
                                                          seed)
                arrays[4][0] = n
                return arrays, params, L, P, th
            out["edge%d_%d" % (bw, n)] = edge
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--save", default=None)
    ap.add_argument("--against", default=None)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shapes", default=None,
                    help="comma-separated shape names (default: all)")
    opt = ap.parse_args()
    sys.path.insert(0, os.path.abspath(opt.tree))
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    from tombo_tpu_torch.ops import banded_dp, dp
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    other = {}
    if opt.against:
        with open(opt.against) as f:
            other = json.load(f)
    table = shapes(opt.seed)
    names = opt.shapes.split(",") if opt.shapes else list(table)
    digests = {}
    for name in names:
        arrays, params, L, P, thresh = table[name]()
        args = [torch.tensor(a, device="cuda") for a in arrays]
        p = dp.DpParams(**params)
        call = lambda: banded_dp.adaptive_banded_dp_tb(*args, p, L, P,
                                                       thresh)
        out = call()
        torch.cuda.synchronize()
        h = hashlib.sha256()
        for x in out:
            h.update(x.contiguous().cpu().numpy().tobytes())
        digests[name] = h.hexdigest()
        row = {"tree": os.path.abspath(opt.tree), "card": smi,
               "shape": name, "B": args[0].shape[0], "L": L,
               "bw": params["bandwidth"], "sha256": digests[name]}
        if name in other:
            row["bitwise_against"] = digests[name] == other[name]
        if not name.startswith("edge"):
            ms = []
            for _ in range(opt.reps):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                call()
                b.record()
                b.synchronize()
                ms.append(a.elapsed_time(b))
            row["ms"] = statistics.median(ms)
            row["ms_all"] = ms
            del out
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            call()
            torch.cuda.synchronize()
            row["peak_bytes"] = torch.cuda.max_memory_allocated() - base
            row["bound_ms"], row["bound_by"] = smoke.k1_bound_ms(
                args + [p, L], params["bandwidth"])
            if hasattr(banded_dp, "banded_dp_occupancy"):
                row["threads"], row["smem_bytes"], row["blocks_per_sm"] = \
                    banded_dp.banded_dp_occupancy(params["bandwidth"])
        print(json.dumps(row), flush=True)
        del args
    if opt.save:
        with open(opt.save, "w") as f:
            json.dump(digests, f)
    if other:
        same = [n for n in names if n in other and digests[n] == other[n]]
        print(json.dumps({"tree": os.path.abspath(opt.tree), "card": smi,
                          "bitwise_shapes": len(same),
                          "compared": sum(1 for n in names if n in other),
                          "differ": [n for n in names if n in other and
                                     digests[n] != other[n]]}))


if __name__ == "__main__":
    main()
