"""How far the JAX package's float32 level tests fall from its float64
ones, on the CPU: the tolerance that ``chip_smoke.py`` holds the port's
float32 level statistics (card and CPU) to against its float64 run.

    JAX_PLATFORMS=cpu python3 scripts/level_f32_tolerance.py [--seed 0]

Inputs at the shapes of ``chip_smoke.py``'s level path: two regions of
10,002 positions (a 10,000-base region and fm_offset 1 each side), 3,000
of them covered by ~170 sample and ~85 control levels drawn from the
level path's spread (sample shifted at one site in twenty), padded as the
JAX lane pads a chunk (P to a power of two, coverage to a multiple of
8).  Each of ks, u, t and their _stat forms runs through the JAX device
functions with x64 off and on, then through the JAX host half
(``_group_post``: blocks of >= 50 reads, Fisher's method or the window
mean over +-1 site).  Prints, per statistic, the sites compared and the
largest relative difference, and for p-values the largest difference of
log10 p where both are above 1e-30; then the same for the port's
float32 run against its float64 run on the CPU (``"port"``), through
``compute_group_stats_device_batch``."""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from tombo_tpu.stats import detect as dt  # noqa: E402
from tombo_tpu_torch.stats import detect as t_dt  # noqa: E402

REG, FM, COVERED, N_SAMP, N_CTRL = 10000, 1, 3000, 170, 85


def level_pair(rng):
    P = REG + 2 * FM
    samp = np.full((P, 512), np.nan)
    ctrl = np.full((P, 256), np.nan)
    shift = np.where(rng.random(P) < 0.05, 0.4, 0.0)
    for i in range(COVERED):
        n_s = rng.integers(N_SAMP - 30, N_SAMP + 30)
        n_c = rng.integers(N_CTRL - 15, N_CTRL + 15)
        level = rng.normal(0, 1)
        samp[i, rng.choice(512, n_s, replace=False)] = \
            level + shift[i] + rng.normal(0, 0.15, n_s)
        ctrl[i, rng.choice(256, n_c, replace=False)] = \
            level + rng.normal(0, 0.15, n_c)
    return samp, ctrl


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    rng = np.random.default_rng(args.seed)
    regions = [level_pair(rng) for _ in range(2)]
    out = {}
    for stat_type in ("ks", "u", "t", "ks_stat", "u_stat", "t_stat"):
        params = dt.TestParams(stat_type=stat_type, fm_offset=FM,
                               min_test_reads=50, region_size=REG)
        stats = {}
        for x64 in (False, True):
            jax.config.update("jax_enable_x64", x64)
            jobs = [(dt.RegionData("chr", s, FM, FM + REG), a, b)
                    for s, (a, b) in zip("+-", regions)]
            res = dt.compute_group_stats_device_batch(jobs, params)
            stats[x64] = np.concatenate([r[0][1].reg_stats for r in res])
        out[stat_type] = compare(stats[False], stats[True], stat_type)
        tp = t_dt.TestParams(stat_type=stat_type, fm_offset=FM,
                             min_test_reads=50, region_size=REG)
        for dtype in (torch.float32, torch.float64):
            jobs = [(t_dt.RegionData("chr", s, FM, FM + REG), a, b)
                    for s, (a, b) in zip("+-", regions)]
            res = t_dt.compute_group_stats_device_batch(jobs, tp, "cpu",
                                                        dtype)
            stats[dtype] = np.concatenate([r[0][1].reg_stats for r in res])
        out["port " + stat_type] = compare(stats[torch.float32],
                                           stats[torch.float64], stat_type)
        for k in (stat_type, "port " + stat_type):
            print(k, json.dumps(out[k]), flush=True)
    print(json.dumps(out))


def compare(a, b, stat_type):
    """Sites compared, sites NaN on one side only, the largest relative
    and absolute differences, and for p-values the largest difference of
    log10 p where both are above 1e-30."""
    ok = np.isfinite(a) & np.isfinite(b)
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.abs(a[ok] - b[ok]) / np.abs(b[ok])
    rec = {"sites": int(ok.sum()),
           "nan_differs": int(np.sum(np.isnan(a) != np.isnan(b))),
           "max_rel": float(np.nanmax(rel)),
           "max_abs": float(np.max(np.abs(a[ok] - b[ok])))}
    if not stat_type.endswith("_stat"):
        big = ok & (a > 1e-30) & (b > 1e-30)
        rec["max_log10_diff"] = float(np.max(np.abs(
            np.log10(a[big]) - np.log10(b[big]))))
        rec["min_p64"] = float(b[ok].min())
    return rec


if __name__ == "__main__":
    main()
