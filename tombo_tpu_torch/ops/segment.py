"""Batched DNA changepoint scores (counterpart of
``tombo_tpu/ops/segment.py``; reference: tombo/_c_helper.pyx:89-98)."""
from __future__ import annotations

import torch

from .precision import prefix_sums


def cpt_scores_diff_batch(signal: torch.Tensor, sig_lens: torch.Tensor,
                          running_stat_width: int) -> torch.Tensor:
    """|sum(left w) - sum(right w)| at every interior position.  Returns
    (B, S - 2w); positions at or past each read's candidate count are -1
    so they sort last."""
    w = running_stat_width
    B, S = signal.shape
    cs = prefix_sums(signal)
    # window sums in float64, rounded once: equal windows score equal
    scores = torch.abs(2.0 * cs[:, w:S - w + 1] - cs[:, :S - 2 * w + 1] -
                       cs[:, 2 * w:]).to(signal.dtype)
    n_cands = sig_lens - 2 * w + 1
    idx = torch.arange(scores.shape[1], device=signal.device)[None, :]
    return torch.where(idx < n_cands[:, None], scores, -1.0)
