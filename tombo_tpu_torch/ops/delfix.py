"""Batched raw-signal deletion fix (counterpart of
``tombo_tpu/ops/delfix.py``; reference: tombo/resquiggle.py:402-545 with
the core of tombo/_c_dynamic_programming.pyx:34-184).

Every window of every read in a batch runs as one padded (NW, T)
program.  Base ``b``'s signal window is ``[b * min_obs, T - (NB-1-b) *
min_obs)``; the forward row ``g[t] = z[t] + max(diag[t], g[t-1])`` is solved
as ``g = Cz + cummax(diag - shift(Cz))``; ``diag`` takes the minimal legal
lag in 1..min_obs.  The traceback's boundary between bases k-1 and k is
the largest ``t <= sig_start + 1 - min_obs`` with ``t <= k * min_obs`` or
``fwd[k-1][t-1] > fwd[k][t-1]``.  Plain PyTorch: XLA code in the JAX
package, no TPU kernel.
"""
from __future__ import annotations

import torch

_NEG_F32 = -1.0e30
_NEG_F64 = -1.0e300


def _shift_right(x: torch.Tensor, k: int, fill) -> torch.Tensor:
    """x[..., t-k] (the first k entries = fill)."""
    if k == 0:
        return x
    pad = torch.full(x.shape[:-1] + (k,), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([pad, x[..., :-k]], dim=-1)


def raw_windows_dp(sig, mu, sd, t_len, nb_len, max_half_z, min_obs: int,
                   nb_pad: int, winsorize: bool):
    """sig (NW, T) windows, mu/sd (NW, NB_pad) levels (pad sd 1), t_len
    and nb_len (NW,).  Returns (bounds (NW, NB_pad-1) int32, window-local
    boundary j between bases j and j+1; fail (NW,) bool)."""
    dt, dev = sig.dtype, sig.device
    NW, T = sig.shape
    neg = _NEG_F64 if dt == torch.float64 else _NEG_F32
    iota = torch.arange(T, device=dev)[None, :]
    t_len = t_len.long()[:, None]
    nb_len = nb_len.long()[:, None]

    def z_row(b):
        z = -torch.abs((sig - mu[:, b:b + 1]) / sd[:, b:b + 1])
        if winsorize:
            z = torch.clamp(z, min=-float(max_half_z))
        ws = b * min_obs
        we = torch.minimum(t_len - (nb_len - 1 - b) * min_obs, t_len)
        in_win = (iota >= ws) & (iota < we)
        zm = torch.where(in_win, z, 0.0)
        # the JAX package's per-row cumsum here is XLA's, not seq_cumsum;
        # float64 rows match np.cumsum either way
        return torch.cumsum(zm, 1), in_win, we

    cz0, in0, we0 = z_row(0)
    g = torch.where(in0, cz0, neg)
    ld = torch.full((NW, T), min_obs, dtype=torch.long, device=dev)
    rows = [g]
    prev_cz, prev_we = cz0, we0
    for b in range(1, nb_pad):
        czb, in_win, we = z_row(b)
        ws = b * min_obs
        diag_g = _shift_right(g, min_obs, neg)
        diag_cz = _shift_right(prev_cz, min_obs, 0.0)
        for lag in range(min_obs - 1, 0, -1):
            legal = _shift_right(ld, lag, 1 << 20) + lag > min_obs
            diag_g = torch.where(legal, _shift_right(g, lag, neg), diag_g)
            diag_cz = torch.where(legal, _shift_right(prev_cz, lag, 0.0),
                                  diag_cz)
        diag = diag_g + (_shift_right(prev_cz, 1, 0.0) - diag_cz)
        diag = torch.where(iota == ws, _shift_right(g, 1, neg), diag)
        diag = torch.where((iota >= ws) & (iota <= prev_we), diag, neg)

        D = torch.where(in_win, diag - _shift_right(czb, 1, 0.0), neg)
        cm = torch.cummax(D, 1).values
        g = torch.where(in_win, czb + cm, neg)
        choice = D > _shift_right(cm, 1, neg)
        last_pos = torch.cummax(torch.where(choice, iota, -(1 << 20)),
                                1).values
        ld = iota - last_pos + 1
        rows.append(g)
        prev_cz, prev_we = czb, we
    G = torch.stack(rows)                                  # (NB_pad, NW, T)

    cur_bound = torch.zeros(NW, dtype=torch.long, device=dev)
    fail = torch.zeros(NW, dtype=torch.bool, device=dev)
    bounds = torch.zeros((NW, nb_pad - 1), dtype=torch.long, device=dev)
    nb1 = nb_len[:, 0]
    for k in range(nb_pad - 1, 0, -1):
        active = k <= nb1 - 1
        sig_start = torch.where(k == nb1 - 1, t_len[:, 0] - 1, cur_bound - 1)
        ok = (iota <= k * min_obs) | (_shift_right(G[k - 1], 1, neg) >
                                      _shift_right(G[k], 1, neg))
        valid = ok & (iota <= (sig_start + 1 - min_obs)[:, None])
        bound = torch.where(valid, iota, -1).max(1).values
        fail |= active & (bound < 0)
        cur_bound = torch.where(active & (bound >= 0), bound, cur_bound)
        bounds[:, k - 1] = bound
    return bounds.to(torch.int32), fail
