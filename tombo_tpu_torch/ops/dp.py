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


class DpInputs(NamedTuple):
    """Per-batch inputs of the adaptive DP in the form its rows read
    them (built once by :func:`dp_inputs`)."""
    em_shift: torch.Tensor          # (B, bw + E + bw) zero-padded
    n_events: torch.Tensor          # (B,) long
    ref_means: torch.Tensor         # (B, >= L)
    ref_sds: torch.Tensor
    seq_lens: torch.Tensor          # (B,) long
    prefix_starts: torch.Tensor     # (B, P) long
    start_rows: torch.Tensor        # (B,) long
    prefix_z: torch.Tensor          # (B, min(P, L), bw) masked prefix z
    prefix_rows: int


class FwdState(NamedTuple):
    """The forward pass's state carried from one row to the next."""
    fwd: torch.Tensor               # (B, bw) forward row
    prev_start: torch.Tensor        # (B,) long band start of that row
    band_error: torch.Tensor        # (B,) bool
    final_fwd: torch.Tensor         # (B, bw) row seq_len - 1
    last_start: torch.Tensor        # (B,) long band start of that row


def dp_inputs(event_means, n_events, ref_means, ref_sds, seq_lens,
              prefix_starts, prefix_valid_start, prefix_end, start_rows,
              params: DpParams, n_rows: int, prefix_rows: int) -> DpInputs:
    """The batch's inputs in the form the rows read them: event means
    zero-padded by bw on both sides and the masked prefix z-scores."""
    bw = params.bandwidth
    B = event_means.shape[0]
    dev, dtype = event_means.device, event_means.dtype
    n_events = n_events.long()
    prefix_starts = prefix_starts.long()
    prefix_valid_start = prefix_valid_start.long()
    prefix_end = prefix_end.long().clamp(0, 2 ** 31 - 1)
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
    return DpInputs(em_shift, n_events, ref_means, ref_sds,
                    seq_lens.long(), prefix_starts, start_rows.long(),
                    prefix_z, prefix_rows)


def init_fwd_state(x: DpInputs, bw: int) -> FwdState:
    """The state before row 0."""
    B, dev, dtype = x.em_shift.shape[0], x.em_shift.device, x.em_shift.dtype
    zeros = torch.zeros((B, bw), dtype=dtype, device=dev)
    return FwdState(zeros, x.prefix_starts[:, 0],
                    torch.zeros(B, dtype=torch.bool, device=dev), zeros,
                    x.prefix_starts[:, 0])


def adaptive_dp_rows(x: DpInputs, state: FwdState, r0: int, r1: int,
                     params: DpParams, keep_rows: bool = False):
    """Rows ``[r0, r1)`` of the forward pass from ``state``, the state
    before row ``r0``.  Rows ``r < start_rows`` use the precomputed prefix
    band plan; later rows place the band adaptively.  Returns (the state
    after row ``r1 - 1``, moves (r1 - r0, B, bw) int8, band starts
    (r1 - r0, B)), and with ``keep_rows`` also the forward rows
    (r1 - r0, B, bw) (a read's rows past its length repeat its last)."""
    bw = params.bandwidth
    half_bw = bw // 2
    fwd, prev_start, band_error, final_fwd, last_start = state
    B, dev = fwd.shape[0], fwd.device
    n_events, seq_lens = x.n_events, x.seq_lens
    iota = torch.arange(bw, device=dev)
    Pz = x.prefix_z.shape[1]
    tb = torch.zeros((r1 - r0, B, bw), dtype=torch.int8, device=dev)
    band_starts = torch.zeros((r1 - r0, B), dtype=torch.long, device=dev)
    rows = (torch.empty((r1 - r0, B, bw), dtype=fwd.dtype, device=dev)
            if keep_rows else None)

    for r in range(r0, r1):
        is_prefix = r < x.start_rows
        active = r < seq_lens

        amax = torch.argmax(fwd, 1)
        adapt_start = torch.maximum(prev_start + amax - half_bw + 1,
                                    prev_start)
        overrun = adapt_start >= n_events
        band_error = band_error | (overrun & (r < seq_lens - 2) & active &
                                   ~is_prefix)
        adapt_start = torch.minimum(adapt_start, n_events - 1)

        pref_idx = min(r, x.prefix_rows - 1)
        band_start = torch.where(is_prefix, x.prefix_starts[:, pref_idx],
                                 adapt_start)
        band_start = torch.where(active, band_start, prev_start)

        adapt_valid = ((band_start[:, None] + iota >= 0) &
                       (band_start[:, None] + iota < n_events[:, None]))
        adapt_z = torch.where(
            adapt_valid,
            _shifted_z(_windows(x.em_shift, band_start, bw),
                       x.ref_means[:, r, None], x.ref_sds[:, r, None],
                       params),
            params.mask_fill_z_score)
        z_row = torch.where(is_prefix[:, None],
                            x.prefix_z[:, min(r, Pz - 1)], adapt_z)

        diff = band_start - prev_start
        same = diff == 0
        diag_gather = fwd.gather(1, (diff - 1).clamp(0, bw - 1)[:, None])
        first_val = torch.where(same, fwd[:, 0] - params.skip_pen,
                                diag_gather[:, 0] + z_row[:, 0])
        first_move = torch.where(same, 1, 2)

        new_fwd, moves = _row_update(fwd, z_row, first_val, first_move,
                                     diff, params)
        fwd = torch.where(active[:, None], new_fwd, fwd)
        if keep_rows:
            rows[r - r0] = fwd
        tb[r - r0] = torch.where(active[:, None], moves, 0)
        is_last = r == seq_lens - 1
        final_fwd = torch.where(is_last[:, None], fwd, final_fwd)
        last_start = torch.where(is_last, band_start, last_start)
        band_starts[r - r0] = band_start
        prev_start = band_start
    out = (FwdState(fwd, prev_start, band_error, final_fwd, last_start),
           tb, band_starts)
    return out + (rows,) if keep_rows else out


def traceback_rows(tb, band_starts, seq_lens, r0: int, event_pos,
                   bound_err, band_bound_thresh: int, bandwidth: int):
    """Walk rows ``[r0, r0 + len(tb))`` back, last row first, from the
    event position and bound-error flag carried in from the row above
    (reference: pyx:281-310).  ``tb`` (n, B, bw) and ``band_starts``
    (n, B) hold those rows.  Returns (segs (B, n): event boundary + 1 of
    each active row, else 0; event_pos; bound_err)."""
    n, B, bw = tb.shape
    iota = torch.arange(bw, device=tb.device)[None, :]
    segs = torch.zeros((B, n), dtype=torch.long, device=tb.device)
    for i in range(n - 1, -1, -1):
        active = r0 + i < seq_lens
        bs_row = band_starts[i]
        band_pos = (event_pos - bs_row).clamp(0, bw - 1)
        # last non-stay position <= band_pos
        nsp = torch.cummax(torch.where(tb[i] != 0, iota, -1), 1).values
        band_pos = nsp.gather(1, band_pos[:, None])[:, 0].clamp(0, bw - 1)
        move = tb[i].gather(1, band_pos[:, None])[:, 0]
        band_pos = torch.where(move == 2, band_pos - 1, band_pos)
        bound_err = bound_err | (active & (
            torch.minimum(band_pos, bw - band_pos - 1) < band_bound_thresh))
        event_pos = torch.where(active, bs_row + band_pos, event_pos)
        segs[:, i] = torch.where(active, event_pos + 1, 0)
    return segs, event_pos, bound_err


def banded_traceback(tb, band_starts, seq_lens, top_band_pos,
                     band_bound_thresh: int, bandwidth: int, n_rows: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Walk the moves back from ``top_band_pos`` on each read's last row
    (reference: pyx:281-310).  Returns (segs (B, L+1), bound_error (B,)):
    entry i is the event boundary of base i for i <= seq_len, else 0."""
    L, B, _ = tb.shape
    seq_lens = seq_lens.long()
    last_start = band_starts.gather(0, (seq_lens - 1)[None, :])[0]
    init_event_pos = top_band_pos.long() + last_start
    segs, _, bound_err = traceback_rows(
        tb[:n_rows], band_starts[:n_rows], seq_lens, 0, init_event_pos,
        torch.zeros(B, dtype=torch.bool, device=tb.device),
        band_bound_thresh, bandwidth)
    return finish_segs(segs, seq_lens, init_event_pos, L), bound_err


def finish_segs(segs_rows, seq_lens, init_event_pos, n_rows: int):
    """(B, <= L) row boundaries -> (B, L+1), zero past the rows given,
    with entry ``seq_len`` set to the top row's event position + 1
    (reference: pyx:290-293); a read longer than L has no such entry, as
    the JAX package's ``.at[seq_len].set`` drops it."""
    segs = torch.nn.functional.pad(
        segs_rows, (0, n_rows + 2 - segs_rows.shape[1]))
    segs.scatter_(1, seq_lens.long().clamp(max=n_rows + 1)[:, None],
                  (init_event_pos + 1)[:, None])
    return segs[:, :n_rows + 1].contiguous()


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
