"""Host helpers of the statistics files (subset copy of
``tombo_tpu/stats/kernels.py``)."""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..config import SMALLEST_PVAL  # noqa: F401  (re-exported)


def calc_damp_fraction(cov_damp_counts: Tuple[float, float],
                       fracs: np.ndarray, valid_cov: np.ndarray
                       ) -> np.ndarray:
    """Beta-prior dampened un-modified fraction (reference:
    tombo/tombo_stats.py:2537-2553); ``cov_damp_counts`` is (unmod,
    mod)."""
    non_mod_counts = np.round(fracs * valid_cov)
    return (non_mod_counts + cov_damp_counts[0]) / (
        valid_cov + cov_damp_counts[0] + cov_damp_counts[1])
