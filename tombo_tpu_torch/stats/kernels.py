"""Host helpers of the statistics files and the level tests' windows
(subset copy of ``tombo_tpu/stats/kernels.py``; scipy's ``chi2.sf``
becomes the device lane's log-space Q of an integer shape)."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config import SMALLEST_PVAL
from ..errors import TomboError
from .device import _chi2_sf_int, _window_logp_sum


def calc_damp_fraction(cov_damp_counts: Tuple[float, float],
                       fracs: np.ndarray, valid_cov: np.ndarray
                       ) -> np.ndarray:
    """Beta-prior dampened un-modified fraction (reference:
    tombo/tombo_stats.py:2537-2553); ``cov_damp_counts`` is (unmod,
    mod)."""
    non_mod_counts = np.round(fracs * valid_cov)
    return (non_mod_counts + cov_damp_counts[0]) / (
        valid_cov + cov_damp_counts[0] + cov_damp_counts[1])


def calc_window_fishers_method(pvals: np.ndarray, lag: int) -> np.ndarray:
    """Fisher's method over a window of +-``lag`` sites (reference:
    tombo/tombo_stats.py:2252-2271): chi2.sf(-2 sum log p, 2 width) of
    the p-values floored at SMALLEST_PVAL, NaN within ``lag`` of either
    edge and in every window that holds a NaN.  Float64, on the host."""
    width = lag * 2 + 1
    if lag <= 0 or pvals.shape[-1] < width:
        raise TomboError("P-values vector too short for Fisher's Method "
                         "window computation.")
    with np.errstate(invalid="ignore"):
        logp = np.log(np.maximum(np.asarray(pvals, np.float64),
                                 SMALLEST_PVAL))
    x = -_window_logp_sum(torch.from_numpy(logp.reshape(1, -1)), lag)
    return _chi2_sf_int(x, width)[0].numpy()


def calc_window_means(stat: np.ndarray, lag: int) -> np.ndarray:
    """Mean over a window of +-``lag`` sites, NaN within ``lag`` of either
    edge (reference: tombo/tombo_stats.py:2273-2287)."""
    width = lag * 2 + 1
    if lag <= 0 or stat.shape[-1] < width:
        raise TomboError("Statistics vector too short for window mean.")
    m = np.full(stat.shape, np.nan)
    m[..., lag:-lag] = np.lib.stride_tricks.sliding_window_view(
        stat, width, axis=-1).mean(-1)
    return m
