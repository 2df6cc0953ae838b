"""Re-aggregate per-read statistics into per-site fractions (counterpart
of ``tombo_tpu/stats/aggregate.py``; reference:
tombo/tombo_stats.py:4664-4777 ``aggregate_per_read_stats``): new
thresholds without testing again.

:func:`aggregate_block` is the per-block math and opens no file, so the
card path checks it without ``h5py``; :func:`aggregate_per_read_stats`
reads a ``PerReadStats`` file and writes a ``ModelStats`` file with it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .. import config
from ..errors import TomboError
from ..types import RegionStats
from .detect import apply_per_read_thresh
from .files import ModelStats, PerReadStats


def aggregate_block(block_stats: np.ndarray, chrm: str, strand: str,
                    start: int, single_read_thresh: float,
                    lower_thresh: Optional[float],
                    stat_type: str) -> RegionStats:
    """One per-read block's (pos, stat, ...) records as a region's
    per-site fractions at the given thresholds."""
    return apply_per_read_thresh(
        np.asarray(block_stats["stat"], np.float64),
        np.asarray(block_stats["pos"], np.int64), chrm, strand, start,
        single_read_thresh, lower_thresh, stat_type)


def aggregate_per_read_stats(
        per_read_stats_fn: str, stats_fn: str,
        single_read_thresh: float, lower_thresh: Optional[float],
        cov_damp_counts: Tuple[float, float] = config.COV_DAMP_COUNTS,
        min_test_reads: int = 1, num_most_signif: int = 100000) -> str:
    """Every block of a per-read statistics file, thresholded per site,
    written to a new statistics file."""
    pr_stats = PerReadStats(per_read_stats_fn)
    out = ModelStats(
        stats_fn, stat_type=pr_stats.stat_type,
        region_size=pr_stats.region_size, cov_damp_counts=cov_damp_counts,
        cov_thresh=min_test_reads, num_most_signif=num_most_signif)
    try:
        for chrm, strand, start, block_stats, _ in \
                pr_stats.iter_per_read_blocks():
            out._write_stat_block(aggregate_block(
                block_stats, chrm, strand, start, single_read_thresh,
                lower_thresh, pr_stats.stat_type))
    finally:
        out.close()
        pr_stats.close()
    if out.is_empty:
        raise TomboError(
            "No genomic positions contain --minimum-test-reads.")
    return stats_fn
