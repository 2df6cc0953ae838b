"""Gaussian kernel densities of many 1-D samples at once (the port's own
``scipy.stats.gaussian_kde``: the port imports no scipy).

For each sample x of n values, the density at the grid points y is what
``gaussian_kde(x, bw_method=bw / x.std(ddof=1)).evaluate(y)`` returns:
the kernel's standard deviation L is the square root of the weighted data
covariance (weights 1/n, ``np.cov(..., aweights=...)``) times the factor
bw / std; both sides are whitened by L before they are subtracted, and

    density(y) = sum_i (1/n) * exp(-((x_i / L) - (y / L))**2 / 2)
                 * (2 pi)**-0.5 / L

in that order (scipy's ``gaussian_kernel_estimate``).  Everything is
float64, on any device.  Samples are sorted by size and cut into tiles of
(samples x observations x points) so that no temporary passes
``max_bytes``; a tile's sums over observations are added to the running
density."""
from __future__ import annotations

import math

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

# bytes of one (samples, observations, points) float64 temporary; a tile
# holds four at once
MAX_BYTES = 256 << 20
_LIVE_TEMPS = 4


def _group_params(vals: torch.Tensor, n: torch.Tensor, bw: float):
    """Per row of the zero-padded (G, N) ``vals`` with ``n`` values each:
    the kernel's standard deviation L (scipy's ``cho_cov``) and the
    weights 1/n."""
    nf = n.to(torch.float64)
    live = torch.arange(vals.shape[1], device=vals.device)[None, :] < \
        n[:, None]
    mean = torch.where(live, vals, 0.0).sum(1) / nf
    dev = torch.where(live, vals - mean[:, None], 0.0)
    std = torch.sqrt((dev * dev).sum(1) / (nf - 1))
    factor = bw / std
    # np.cov(x, bias=False, aweights=w), w = 1/n: the weighted mean, then
    # sum(xc * xc * w) times 1 / (sum(w) - sum(w * w) / sum(w))
    w = 1.0 / nf
    v1 = w * nf
    avg = torch.where(live, vals * w[:, None], 0.0).sum(1) / v1
    xc = torch.where(live, vals - avg[:, None], 0.0)
    fact = v1 - (w * w * nf) / v1
    cov = (xc * (xc * w[:, None])).sum(1) * (1.0 / fact)
    return torch.sqrt(cov) * factor, w


def kde_evaluate(flat: torch.Tensor, counts, bw: float, save_x,
                 device: DeviceLike = None,
                 max_bytes: int = MAX_BYTES) -> torch.Tensor:
    """(K, P) float64 densities of K samples at the P points ``save_x``.

    ``flat``: the samples' values one after another (sample 0's first);
    ``counts``: (K,) their sizes, each at least 2."""
    device = resolve_device(device)
    counts = np.asarray(counts, np.int64)
    if counts.size and counts.min() < 2:
        raise ValueError("a kernel density needs at least two values a "
                         "sample")
    flat = flat.to(device=device, dtype=torch.float64)
    y = torch.as_tensor(np.asarray(save_x, np.float64), device=device)
    K, P = counts.shape[0], y.shape[0]
    out = torch.zeros((K, P), dtype=torch.float64, device=device)
    if K == 0:
        return out
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    order = np.argsort(-counts, kind="stable")
    cap = max(1, max_bytes // (8 * _LIVE_TEMPS))
    norm0 = math.pow(2 * math.pi, -0.5)
    g = 0
    while g < K:
        nmax = int(counts[order[g]])
        kc = max(1, min(K - g, cap // max(1, nmax * P)))
        grp = order[g:g + kc]
        g += kc
        n = torch.as_tensor(counts[grp], device=device)
        col = np.arange(nmax)[None, :]
        idx = np.minimum(starts[grp][:, None] + col,
                         starts[grp][:, None] + counts[grp][:, None] - 1)
        vals = flat[torch.as_tensor(idx, device=device)]
        live = torch.as_tensor(col < counts[grp][:, None], device=device)
        vals = torch.where(live, vals, 0.0)
        L, w = _group_params(vals, n, bw)
        pts = vals / L[:, None]                     # (kc, nmax)
        grid = y[None, :] / L[:, None]              # (kc, P)
        norm = norm0 / L
        wts = torch.where(live, w[:, None], 0.0)
        dens = torch.zeros((kc, P), dtype=torch.float64, device=device)
        step = max(1, cap // (kc * P))
        for o0 in range(0, nmax, step):
            r = pts[:, o0:o0 + step, None] - grid[:, None, :]
            e = torch.exp(-(r * r) / 2.0) * norm[:, None, None]
            dens += (wts[:, o0:o0 + step, None] * e).sum(1)
        out[torch.as_tensor(grp, device=device)] = dens
    return out

