"""Batched banded DP as PyTorch loops over rows: the plain version of the
DP kernel (counterpart of ``tombo_tpu/ops/dp.py``; reference:
tombo/_c_dynamic_programming.pyx:202-412).

The band recurrence ``fwd[p] = max(fwd[p-1] + z[p] - stay_pen, d[p])`` is
a first-order max-plus recurrence; with ``c`` the prefix sum of
``z - stay_pen`` it closes to ``fwd = c + cummax(d - c)``, one prefix sum
and one running max per row over a whole batch of reads.  The adaptive
band is placed at the first argmax of the previous row, clamped monotone;
ties in the moves break stay > diag > skip.  ``ops/banded_dp.py`` holds
the CUDA kernel that computes the same thing and its wrapper.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .precision import seq_cumsum

NEG_LARGE = -1e30   # stand-in for -inf that stays finite through arithmetic


class DpParams(NamedTuple):
    z_shift: float
    skip_pen: float
    stay_pen: float
    mask_fill_z_score: float
    max_half_z_score: float     # <= 0 disables winsorizing
    bandwidth: int


class StartDpParams(NamedTuple):
    z_shift: float
    skip_pen: float
    stay_pen: float
    max_half_z_score: float
    num_bases: int       # rows (start_n_bases)
    num_events: int      # band width (start_bw)


def _row_update(prev_fwd, shifted_z, first_val, first_move, diff,
                p: DpParams):
    """One band row for a batch: (B, bw) fwd and int8 move codes
    (0 stay, 1 skip, 2 diag)."""
    bw = p.bandwidth
    pos = torch.arange(bw, device=prev_fwd.device)[None, :]
    prev_b_pos = pos + diff[:, None]

    diag_idx = prev_b_pos - 1
    diag_valid = (diag_idx >= 0) & (diag_idx < bw)
    diag_gather = prev_fwd.gather(1, diag_idx.clamp(0, bw - 1))
    diag_score = torch.where(diag_valid, diag_gather, NEG_LARGE) + shifted_z

    skip_valid = prev_b_pos < bw
    skip_gather = prev_fwd.gather(1, prev_b_pos.clamp(0, bw - 1))
    skip_score = torch.where(skip_valid, skip_gather, NEG_LARGE) - p.skip_pen

    d = torch.maximum(diag_score, skip_score)
    s = shifted_z - p.stay_pen
    s[:, 0] = 0.0
    c = seq_cumsum(s, 1)
    u = d - c
    u[:, 0] = first_val
    fwd = c + torch.cummax(u, 1).values
    fwd[:, 0] = first_val

    stay_score = torch.cat(
        [torch.full((fwd.shape[0], 1), NEG_LARGE, dtype=fwd.dtype,
                    device=fwd.device),
         fwd[:, :-1] - p.stay_pen + shifted_z[:, 1:]], dim=1)
    moves = torch.zeros(fwd.shape, dtype=torch.int8, device=fwd.device)
    moves[diag_score > stay_score] = 2
    moves[skip_score > torch.maximum(stay_score, diag_score)] = 1
    moves[:, 0] = first_move.to(torch.int8)
    return fwd, moves


def _windows(em_shift: torch.Tensor, starts: torch.Tensor, bw: int):
    """em_shift[b, s + bw : s + 2bw] per read and start (``starts`` (B,)
    or (B, P)), with the start clamped so the window fits, as
    ``lax.dynamic_slice`` does.  Clamping moves only positions that the
    caller masks."""
    W = em_shift.shape[1]
    st = (starts + bw).clamp(0, W - bw)
    idx = st[..., None] + torch.arange(bw, device=em_shift.device)
    if idx.dim() == 2:
        return em_shift.gather(1, idx)
    B, P, _ = idx.shape
    return em_shift.gather(1, idx.reshape(B, P * bw)).reshape(B, P, bw)


def _shifted_z(window, mu, sd, p: DpParams):
    z = torch.abs((window - mu) / sd)
    if p.max_half_z_score > 0:
        z = torch.clamp(z, max=p.max_half_z_score)
    return p.z_shift - z


def adaptive_banded_dp(event_means, n_events, ref_means, ref_sds, seq_lens,
                       prefix_starts, prefix_valid_start, prefix_end,
                       start_rows, params: DpParams, n_rows: int,
                       prefix_rows: int):
    """Start-masked prefix + adaptive banded forward pass for a batch.

    Rows ``r < start_rows`` use the precomputed prefix band plan (events
    outside ``[prefix_valid_start, prefix_end[r])`` masked); later rows
    place the band adaptively.  Returns (tb (L, B, bw) int8, band_starts
    (L, B), final_fwd (B, bw), band_error (B,) bool)."""
    bw = params.bandwidth
    B = event_means.shape[0]
    dev, dtype = event_means.device, event_means.dtype
    half_bw = bw // 2
    n_events = n_events.long()
    seq_lens = seq_lens.long()
    prefix_starts = prefix_starts.long()
    prefix_valid_start = prefix_valid_start.long()
    prefix_end = prefix_end.long().clamp(0, 2 ** 31 - 1)
    start_rows = start_rows.long()
    iota = torch.arange(bw, device=dev)

    zpad = torch.zeros((B, bw), dtype=dtype, device=dev)
    em_shift = torch.cat([zpad, event_means, zpad], dim=1)

    # prefix-phase z-scores (B, P', bw); rows past L are never read
    Pz = min(prefix_rows, n_rows)
    ps = prefix_starts[:, :Pz]
    abs_pos = ps[:, :, None] + iota
    pvalid = ((abs_pos >= prefix_valid_start[:, None, None]) &
              (abs_pos < prefix_end[:, :Pz, None]) & (abs_pos >= 0) &
              (abs_pos < n_events[:, None, None]))
    pz = _shifted_z(_windows(em_shift, ps, bw), ref_means[:, :Pz, None],
                    ref_sds[:, :Pz, None], params)
    prefix_z = torch.where(pvalid, pz, params.mask_fill_z_score)

    fwd = torch.zeros((B, bw), dtype=dtype, device=dev)
    prev_start = prefix_starts[:, 0]
    final_fwd = torch.zeros((B, bw), dtype=dtype, device=dev)
    band_error = torch.zeros(B, dtype=torch.bool, device=dev)
    tb = torch.zeros((n_rows, B, bw), dtype=torch.int8, device=dev)
    band_starts = torch.zeros((n_rows, B), dtype=torch.long, device=dev)

    for r in range(n_rows):
        is_prefix = r < start_rows
        active = r < seq_lens

        amax = torch.argmax(fwd, 1)
        adapt_start = torch.maximum(prev_start + amax - half_bw + 1,
                                    prev_start)
        overrun = adapt_start >= n_events
        band_error |= overrun & (r < seq_lens - 2) & active & ~is_prefix
        adapt_start = torch.minimum(adapt_start, n_events - 1)

        pref_idx = min(r, prefix_rows - 1)
        band_start = torch.where(is_prefix, prefix_starts[:, pref_idx],
                                 adapt_start)
        band_start = torch.where(active, band_start, prev_start)

        adapt_valid = ((band_start[:, None] + iota >= 0) &
                       (band_start[:, None] + iota < n_events[:, None]))
        adapt_z = torch.where(
            adapt_valid,
            _shifted_z(_windows(em_shift, band_start, bw),
                       ref_means[:, r, None], ref_sds[:, r, None], params),
            params.mask_fill_z_score)
        z_row = torch.where(is_prefix[:, None],
                            prefix_z[:, min(r, Pz - 1)], adapt_z)

        diff = band_start - prev_start
        same = diff == 0
        diag_gather = fwd.gather(1, (diff - 1).clamp(0, bw - 1)[:, None])
        first_val = torch.where(same, fwd[:, 0] - params.skip_pen,
                                diag_gather[:, 0] + z_row[:, 0])
        first_move = torch.where(same, 1, 2)

        new_fwd, moves = _row_update(fwd, z_row, first_val, first_move,
                                     diff, params)
        fwd = torch.where(active[:, None], new_fwd, fwd)
        tb[r] = torch.where(active[:, None], moves, 0)
        final_fwd = torch.where((r == seq_lens - 1)[:, None], fwd, final_fwd)
        band_starts[r] = band_start
        prev_start = band_start
    return tb, band_starts, final_fwd, band_error


def banded_traceback(tb, band_starts, seq_lens, top_band_pos,
                     band_bound_thresh: int, bandwidth: int, n_rows: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Walk the moves back from ``top_band_pos`` on each read's last row
    (reference: pyx:281-310).  Returns (segs (B, L+1), bound_error (B,)):
    entry i is the event boundary of base i for i <= seq_len, else 0."""
    L, B, bw = tb.shape
    dev = tb.device
    seq_lens = seq_lens.long()
    iota = torch.arange(bw, device=dev)[None, :]
    last_start = band_starts.gather(0, (seq_lens - 1)[None, :])[0]
    init_event_pos = top_band_pos.long() + last_start
    event_pos = init_event_pos
    bound_err = torch.zeros(B, dtype=torch.bool, device=dev)
    segs = torch.zeros((B, L + 1), dtype=torch.long, device=dev)
    for r in range(n_rows - 1, -1, -1):
        active = r < seq_lens
        bs_row = band_starts[r]
        band_pos = (event_pos - bs_row).clamp(0, bw - 1)
        # last non-stay position <= band_pos
        nsp = torch.cummax(torch.where(tb[r] != 0, iota, -1), 1).values
        band_pos = nsp.gather(1, band_pos[:, None])[:, 0].clamp(0, bw - 1)
        move = tb[r].gather(1, band_pos[:, None])[:, 0]
        band_pos = torch.where(move == 2, band_pos - 1, band_pos)
        bound_err |= active & (torch.minimum(band_pos, bw - band_pos - 1) <
                               band_bound_thresh)
        event_pos = torch.where(active, bs_row + band_pos, event_pos)
        segs[:, r] = torch.where(active, event_pos + 1, 0)
    segs.scatter_(1, seq_lens[:, None], (init_event_pos + 1)[:, None])
    return segs, bound_err


def start_band_dp(event_means, ref_means, ref_sds, params: StartDpParams):
    """Read-start discovery DP (reference: tombo/resquiggle.py:685-752):
    a static band moving up one event per base.  ``event_means`` holds at
    least ``num_bases + num_events`` columns.  Returns (segs (B, nb+1),
    top_band_pos, final_fwd max)."""
    nb, ne = params.num_bases, params.num_events
    B = event_means.shape[0]
    dev, dtype = event_means.device, event_means.dtype
    dp = DpParams(z_shift=params.z_shift, skip_pen=params.skip_pen,
                  stay_pen=params.stay_pen, mask_fill_z_score=0.0,
                  max_half_z_score=params.max_half_z_score, bandwidth=ne)
    idx = (torch.arange(nb, device=dev)[:, None] +
           torch.arange(ne, device=dev)[None, :])
    windows = event_means[:, idx]
    zmat = _shifted_z(windows, ref_means[:, :nb, None],
                      ref_sds[:, :nb, None], dp)

    fwd = torch.zeros((B, ne), dtype=dtype, device=dev)
    tb = torch.zeros((nb, B, ne), dtype=torch.int8, device=dev)
    for r in range(nb):
        z_row = zmat[:, r]
        same = r == 0
        first_val = fwd[:, 0] - dp.skip_pen if same else fwd[:, 0] + z_row[:, 0]
        first_move = torch.full((B,), 1 if same else 2, device=dev)
        diffs = torch.full((B,), 0 if same else 1, dtype=torch.long,
                           device=dev)
        fwd, tb[r] = _row_update(fwd, z_row, first_val, first_move, diffs,
                                 dp)
    top = torch.argmax(fwd, 1)
    band_starts = torch.arange(nb, device=dev)[:, None].expand(nb, B)
    seq_lens = torch.full((B,), nb, dtype=torch.long, device=dev)
    segs, _ = banded_traceback(tb, band_starts, seq_lens, top, -1, ne, nb)
    return segs, top, fwd.max(1).values
