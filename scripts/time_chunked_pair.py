"""Time the PyTorch/CUDA port's chunked DP pair (K2 forward, K2'
traceback) against its fused kernel (K1) on a CUDA card.

    python3 scripts/time_chunked_pair.py [--tree DIR] [--reads 16,32]
        [--rows 32768] [--bw 300] [--reps 5] [--seed 0]

The inputs are synthetic long reads made from ``--seed`` with numpy: the
event means follow each read's reference levels at 1.4 events per base
(the DNA recipe's events-to-bases ratio) with noise of one reference sd,
so the adaptive band moves along the read as it does on real reads; read
lengths are uniform in [0.75, 1] x rows.  ``--tree DIR`` imports
``tombo_tpu_torch`` from another checkout (for example the parent commit
unpacked under ``build/``), so two versions can be timed in turns on one
card in one run.  ``--cluster-blocks`` and ``--tb-smem-budget`` time
K2' at another cluster size or tile budget.  For each read count it
prints one JSON line: the card's name and power limit, CUDA-event
medians over ``--reps`` calls (after one warm-up call) of K2, K2' and the
pair, and K1's, whether the pair is bitwise K1, the pair's peak device
memory and, where the tree has it, K2''s clusters resident at once.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys

import numpy as np


def synthetic_reads(B, L, bw, seed):
    rng = np.random.default_rng(seed)
    ratio = 1.4
    E = int(L * ratio) + bw
    rm = rng.normal(0, 1, (B, L)).astype(np.float32)
    rs = rng.uniform(0.08, 0.15, (B, L)).astype(np.float32)
    base = np.minimum((np.arange(E) / ratio).astype(np.int64), L - 1)
    em = (rm[:, base] + rng.normal(0, 1, (B, E)).astype(np.float32) *
          rs[:, base]).astype(np.float32)
    seq_lens = rng.integers(int(0.75 * L), L + 1, B)
    n_events = np.minimum((seq_lens * ratio).astype(np.int64) + bw // 2, E)
    P = 1
    return (em, n_events, rm, rs, seq_lens, np.zeros((B, P), np.int64),
            np.zeros(B, np.int64), np.full((B, P), 2 ** 31 - 1, np.int64),
            np.zeros(B, np.int64)), P


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--reads", default="16")
    ap.add_argument("--rows", type=int, default=32768)
    ap.add_argument("--bw", type=int, default=300)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-k1", action="store_true")
    ap.add_argument("--cluster-blocks", type=int, default=None,
                    help="K2' cluster size in place of CLUSTER_BLOCKS")
    ap.add_argument("--tb-smem-budget", type=int, default=None,
                    help="K2' shared memory budget in bytes in place of "
                         "tb_smem_budget(bw) (sets the tile rows)")
    opt = ap.parse_args()
    sys.path.insert(0, os.path.abspath(opt.tree))
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    from tombo_tpu_torch import kernels
    from tombo_tpu_torch.ops import banded_dp, dp
    if opt.cluster_blocks:
        banded_dp.CLUSTER_BLOCKS = opt.cluster_blocks
    if opt.tb_smem_budget:
        if hasattr(banded_dp, "tb_smem_budget"):
            banded_dp.tb_smem_budget = lambda bw: opt.tb_smem_budget
        else:
            banded_dp.TB_SMEM_BUDGET = opt.tb_smem_budget

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    L, bw = opt.rows, opt.bw
    p = dp.DpParams(z_shift=2.0, skip_pen=4.0, stay_pen=4.2,
                    mask_fill_z_score=-10.0, max_half_z_score=5.0,
                    bandwidth=bw)
    for B in [int(x) for x in opt.reads.split(",")]:
        arrays, P = synthetic_reads(B, L, bw, opt.seed)
        args = [torch.tensor(a, device="cuda") for a in arrays]
        pair = lambda: banded_dp.adaptive_banded_dp_tb_chunked(
            *args, p, L, P, 40)
        k1 = lambda: banded_dp.adaptive_banded_dp_tb(*args, p, L, P, 40)

        # CUDA events before the call, between its two launches and after
        marks, count = [], kernels.count_launch

        def mark(name):
            count(name)
            if name == "banded_dp_chunked_fwd":
                marks.append(torch.cuda.Event(enable_timing=True))
                marks[-1].record()

        out = pair()
        torch.cuda.synchronize()
        fwd, tb, whole = [], [], []
        kernels.count_launch = mark
        try:
            for _ in range(opt.reps):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                pair()
                b.record()
                b.synchronize()
                fwd.append(a.elapsed_time(marks[-1]))
                tb.append(marks[-1].elapsed_time(b))
                whole.append(a.elapsed_time(b))
        finally:
            kernels.count_launch = count
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        pair()
        torch.cuda.synchronize()
        row = {"tree": os.path.abspath(opt.tree), "card": smi, "B": B,
               "L": L, "bw": bw,
               "Lc": (banded_dp.tile_rows(bw, min(banded_dp.CHUNK_ROWS, L))
                      if hasattr(banded_dp, "tile_rows")
                      else min(banded_dp.CHUNK_ROWS, L)),
               "fwd_ms": statistics.median(fwd),
               "tb_ms": statistics.median(tb),
               "pair_ms": statistics.median(whole),
               "pair_peak_bytes": torch.cuda.max_memory_allocated() - base}
        if hasattr(banded_dp, "chunked_tb_occupancy"):
            row["cluster_blocks"] = banded_dp.CLUSTER_BLOCKS
            row["tb_smem_bytes"], row["active_clusters"] = \
                banded_dp.chunked_tb_occupancy(bw, row["Lc"])
        if not opt.no_k1:
            ko = k1()
            row["bitwise_k1"] = all(torch.equal(x, y)
                                    for x, y in zip(out, ko))
            k1_ms = []
            for _ in range(opt.reps):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                k1()
                b.record()
                b.synchronize()
                k1_ms.append(a.elapsed_time(b))
            row["k1_ms"] = statistics.median(k1_ms)
            del ko
        print(json.dumps(row), flush=True)
        del out, args


if __name__ == "__main__":
    main()
