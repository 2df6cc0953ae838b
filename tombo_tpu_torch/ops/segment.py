"""Batched changepoint scores, DNA and RNA (counterpart of
``tombo_tpu/ops/segment.py``; reference: tombo/_c_helper.pyx:89-98,
144-179).  Window sums come from float64 prefix sums and each score is
rounded to the signal's dtype once."""
from __future__ import annotations

import numpy as np
import torch

from .precision import prefix_sums


def _sqrt64(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of a float64 tensor.  CUDA's
    double sqrt is; PyTorch's vectorised CPU one is not (it differs from
    numpy's in the last bit on 0.7% of values on an AVX-512 host), so on
    the CPU numpy takes it, as the host reference does."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


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


def cpt_scores_t_test_batch(signal: torch.Tensor, sig_lens: torch.Tensor,
                            running_stat_width: int) -> torch.Tensor:
    """RNA score |m1 - m2| / sqrt(ss1 + ss2) of two adjacent ``w``
    windows (a monotonic transform of the Welch t-score).  Returns (B,
    S - 2w); positions at or past each read's ``len - 2w`` candidates are
    -1.  The squares of integer DAC values sum exactly in float64, so the
    float32 lane's scores are the float64 ones rounded once.  At float64
    the scores are bitwise the host reference's
    (``ref_impl.cpt_scores_t_test``); the JAX package's float64 lane
    differs from both in the last bits, as XLA on the CPU contracts its
    multiply-subtracts into fused multiply-adds and divides by a
    reciprocal square root, and cancellation in ss1 + ss2 makes those
    bits grow."""
    w = running_stat_width
    B, S = signal.shape
    cs = prefix_sums(signal)
    if signal.dtype == torch.float64:
        cs2 = prefix_sums(signal * signal)
    else:
        # squares taken in float64: a DAC value past 4096 squares beyond
        # float32's integers
        x = signal.to(torch.float64)
        cs2 = torch.nn.functional.pad(torch.cumsum(x * x, 1), (1, 0))
    n_out = S - 2 * w

    def win(off):
        s = cs[:, off + w:off + w + n_out] - cs[:, off:off + n_out]
        s2 = cs2[:, off + w:off + w + n_out] - cs2[:, off:off + n_out]
        return s / w, s2 - s * s / w

    m1, ss1 = win(0)
    m2, ss2 = win(w)
    denom = ss1 + ss2
    pos = denom > 0
    t = torch.where(pos, torch.abs(m1 - m2) /
                    _sqrt64(torch.where(pos, denom, 1.0)),
                    0.0).to(signal.dtype)
    idx = torch.arange(n_out, device=signal.device)[None, :]
    return torch.where(idx < (sig_lens - 2 * w)[:, None], t, -1.0)
