"""Batched signal normalization (counterpart of
``tombo_tpu/ops/normalize.py``; reference: tombo/tombo_stats.py:482-573).

Reads are padded into (B, S) batches with true lengths carried apart;
medians and MADs use masked sorts so padding never enters a statistic."""
from __future__ import annotations

from typing import Optional

import torch

from .precision import prefix_sums

POS_LARGE = 1e30


def masked_median(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """numpy-style median over the first ``n`` entries of each row."""
    S = x.shape[1]
    idx = torch.arange(S, device=x.device)[None, :]
    s = torch.sort(torch.where(idx < n[:, None], x, POS_LARGE), dim=1).values
    lo = ((n - 1) // 2).clamp(0, S - 1)
    hi = (n // 2).clamp(0, S - 1)
    lo_v = s.gather(1, lo[:, None].long())[:, 0]
    hi_v = s.gather(1, hi[:, None].long())[:, 0]
    return (lo_v + hi_v) * 0.5


def masked_mad(x: torch.Tensor, med: torch.Tensor, n: torch.Tensor
               ) -> torch.Tensor:
    return masked_median(torch.abs(x - med[:, None]), n)


def normalize_median_batch(raw: torch.Tensor, sig_lens: torch.Tensor,
                           outlier_thresh: Optional[float] = None):
    """Median/MAD normalization with optional winsorizing.  Returns
    (norm, shift, scale, lower, upper); padding of ``norm`` is zero."""
    shift = masked_median(raw, sig_lens)
    scale = masked_mad(raw, shift, sig_lens)
    norm = (raw - shift[:, None]) / scale[:, None]
    if outlier_thresh is not None:
        read_med = masked_median(norm, sig_lens)
        read_mad = masked_mad(norm, read_med, sig_lens)
        lower = read_med - read_mad * outlier_thresh
        upper = read_med + read_mad * outlier_thresh
        norm = torch.minimum(torch.maximum(norm, lower[:, None]),
                             upper[:, None])
    else:
        lower = torch.full_like(shift, float("nan"))
        upper = torch.full_like(shift, float("nan"))
    idx = torch.arange(raw.shape[1], device=raw.device)[None, :]
    norm = torch.where(idx < sig_lens[:, None], norm, 0.0)
    return norm, shift, scale, lower, upper


def normalize_with_scale_batch(raw, sig_lens, shift, scale, lower, upper):
    """Apply given scale values; NaN limits disable winsorizing."""
    norm = (raw - shift[:, None]) / scale[:, None]
    do_clip = ~torch.isnan(lower) & ~torch.isnan(upper)
    lo = torch.where(do_clip, lower, -POS_LARGE)
    hi = torch.where(do_clip, upper, POS_LARGE)
    norm = torch.minimum(torch.maximum(norm, lo[:, None]), hi[:, None])
    idx = torch.arange(raw.shape[1], device=raw.device)[None, :]
    return torch.where(idx < sig_lens[:, None], norm, 0.0)


def compute_base_means_batch(norm: torch.Tensor, segs: torch.Tensor,
                             n_segs: torch.Tensor) -> torch.Tensor:
    """Per-segment means by prefix-sum differences (reference:
    tombo/_c_helper.pyx:59 ``c_new_means``).  ``segs`` (B, E+1) holds
    boundaries in [0, S]; segments past ``n_segs`` or of length 0 give 0."""
    S = norm.shape[1]
    cs = prefix_sums(norm)
    segs = segs.long().clamp(0, S)
    seg_sum = cs.gather(1, segs[:, 1:]) - cs.gather(1, segs[:, :-1])
    lens = (segs[:, 1:] - segs[:, :-1]).to(cs.dtype)
    idx = torch.arange(segs.shape[1] - 1, device=norm.device)[None, :]
    valid = (idx < n_segs[:, None]) & (lens > 0)
    # means in float64, rounded once
    return torch.where(valid, seg_sum / torch.where(lens > 0, lens, 1.0),
                       0.0).to(norm.dtype)


def compute_base_mean_stds_batch(norm: torch.Tensor, segs: torch.Tensor,
                                 n_segs: torch.Tensor):
    """Per-segment means and population SDs by prefix-sum differences
    (counterpart of ``tombo_tpu/ops/normalize.py``
    ``compute_base_mean_stds_batch``; reference: tombo/_c_helper.pyx:38
    ``c_new_mean_stds``).  ``segs`` (B, E+1) holds boundaries in [0, S];
    segments past ``n_segs`` or of length 0 give 0 and 0.  float64 sums
    sequentially, bitwise ``np.cumsum``; float32 sums and divides in
    float64 and rounds each result once."""
    S = norm.shape[1]
    cs = prefix_sums(norm)
    cs2 = prefix_sums(norm * norm)
    segs = segs.long().clamp(0, S)
    lens = (segs[:, 1:] - segs[:, :-1]).to(cs.dtype)
    safe_lens = torch.where(lens > 0, lens, 1.0)
    take = lambda c: c.gather(1, segs[:, 1:]) - c.gather(1, segs[:, :-1])
    means = take(cs) / safe_lens
    var = torch.clamp(take(cs2) / safe_lens - means * means, min=0.0)
    idx = torch.arange(segs.shape[1] - 1, device=norm.device)[None, :]
    valid = (idx < n_segs[:, None]) & (lens > 0)
    return (torch.where(valid, means, 0.0).to(norm.dtype),
            torch.where(valid, torch.sqrt(var), 0.0).to(norm.dtype))
