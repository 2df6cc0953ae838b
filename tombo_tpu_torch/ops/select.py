"""Greedy changepoint selection on the device (counterpart of
``tombo_tpu/ops/select.py``; reference: tombo/_c_helper.pyx:89-121
``c_valid_cpts_w_cap``).

The sequential greedy pick (descending score, min-spacing blacklist) is
the greedy maximal independent set of the candidate conflict graph, which
a parallel "local winner" iteration computes in a handful of rounds: an
undecided candidate whose rank beats every undecided candidate within
``min_base_obs - 1`` positions is accepted, and its neighbours are knocked
out.  Each round accepts at least the best undecided candidate, and every
candidate accepted this way is one the sequential greedy accepts, so the
result is identical.  The rounds run as a Python loop (the JAX package's
``lax.while_loop``)."""
from __future__ import annotations

from typing import Tuple

import torch

_BIG_I = 2 ** 30


def _dense_rank_desc(scores: torch.Tensor) -> torch.Tensor:
    """Rank by (score desc, index desc); 0 = best."""
    B, S = scores.shape
    dev = scores.device
    idx_desc = torch.arange(S - 1, -1, -1, device=dev)
    # a stable sort of -score over the index-descending order keeps the
    # higher index first among equal scores
    o = torch.sort(-scores[:, idx_desc], dim=1, stable=True).indices
    order = idx_desc[o]
    ranks = torch.empty((B, S), dtype=torch.long, device=dev)
    ranks.scatter_(1, order, torch.arange(S, device=dev).expand(B, S))
    return ranks


def _window_min(x: torch.Tensor, radius: int) -> torch.Tensor:
    out = x
    for d in range(1, radius + 1):
        left = torch.nn.functional.pad(x[:, d:], (0, d), value=_BIG_I)
        right = torch.nn.functional.pad(x[:, :-d], (d, 0), value=_BIG_I)
        out = torch.minimum(out, torch.minimum(left, right))
    return out


def _dilate(mask: torch.Tensor, radius: int) -> torch.Tensor:
    out = mask
    for d in range(1, radius + 1):
        left = torch.nn.functional.pad(mask[:, d:], (0, d))
        right = torch.nn.functional.pad(mask[:, :-d], (d, 0))
        out = out | left | right
    return out


def greedy_cpts_device(scores: torch.Tensor, n_cands: torch.Tensor,
                       num_cpts: torch.Tensor, min_base_obs: int,
                       shift: int, max_cpts: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (cpts (B, max_cpts) int64, status (B,) int32): the selected
    positions + ``shift`` ascending, zero past ``num_cpts``; status 1 when
    fewer than ``num_cpts`` spaced candidates exist."""
    B, S = scores.shape
    dev = scores.device
    radius = min_base_obs - 1
    idx = torch.arange(S, device=dev)[None, :].expand(B, S)
    valid = idx < n_cands[:, None]
    ranks = _dense_rank_desc(torch.where(valid, scores, -float("inf")))

    accepted = torch.zeros((B, S), dtype=torch.bool, device=dev)
    undecided = valid
    while bool(undecided.any()):
        r = torch.where(undecided, ranks, _BIG_I)
        winner = undecided & (r == _window_min(r, radius)) & (r < _BIG_I)
        accepted = accepted | winner
        undecided = undecided & ~_dilate(accepted, radius)

    n_sel = accepted.sum(1)
    k = torch.clamp(num_cpts.long(), max=max_cpts)
    status = (n_sel < k).to(torch.int32)

    sel_rank = torch.where(accepted, ranks, _BIG_I)
    rank_sorted = torch.sort(sel_rank, dim=1).values
    kth = rank_sorted.gather(1, (k - 1).clamp(0, S - 1)[:, None])
    final = accepted & (sel_rank <= kth) & (k > 0)[:, None]

    pos_sorted = torch.sort(torch.where(final, idx, _BIG_I), dim=1).values
    if S < max_cpts:
        pos_sorted = torch.nn.functional.pad(pos_sorted, (0, max_cpts - S),
                                             value=_BIG_I)
    pos_sorted = pos_sorted[:, :max_cpts]
    in_k = torch.arange(max_cpts, device=dev)[None, :] < k[:, None]
    return torch.where(in_k, pos_sorted + shift, 0), status
