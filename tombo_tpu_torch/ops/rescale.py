"""Exact batched Theil-Sen fit on the device (counterpart of
``tombo_tpu/ops/rescale.py``; reference: tombo/_c_helper.pyx:362
``c_compute_slopes``, tombo/tombo_stats.py:370-419).

The median of all pairwise slopes is selected exactly over the float bit
patterns: each slope maps to an order-preserving unsigned key, and a
multi-pivot range search narrows a per-read key bracket round by round;
each round is one count of keys <= pivot.  float32 fits use the compact
upper-triangle key buffer as order-preserving int32 and the streaming
count kernel ``csrc/count_le.cu`` (:func:`count_le`), selecting the upper
middle order statistic and deriving the lower one from one count/max
pass.  float64 (CPU parity mode) selects both middle order statistics
over the square key matrix.  Both are exact, so they return the same
median as the JAX package's engines, bit for bit.

torch has no unsigned 32/64-bit arithmetic: keys live in int64.  32-bit
keys are plain non-negative int64 values (a pivot sum that would wrap in
uint32 is masked to 32 bits).  64-bit keys are int64 bit patterns whose
unsigned order is compared with the sign bit flipped, and whose bracket
width ``hi - lo``, which can exceed 2**63, is divided as an unsigned
number.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import ctypes
import numpy as np
import torch

from .. import kernels

_SIGN64 = -2 ** 63
_MASK32 = 0xFFFFFFFF
_INT32_MIN = -2 ** 31
_N_PIV = 15            # pivots per round of the float64 dual selection
_COUNT_PIVOTS = 8      # pivots per count-kernel launch (float32)
_KEY_BLOCK = 64        # reads per pass of the pair-key build


# ------------------------------------------------------------------ keys
def float_to_key(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving unsigned key as int64: [0, 2**32) for float32,
    the uint64 bit pattern for float64."""
    if x.dtype == torch.float64:
        b = x.view(torch.int64)
        return torch.where(b < 0, b ^ -1, b ^ _SIGN64)
    b = x.to(torch.float32).view(torch.int32).to(torch.int64)
    return torch.where(b < 0, ~b, b + 2 ** 31)


def key_to_float(k: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of :func:`float_to_key`."""
    if dtype == torch.float64:
        return torch.where(k < 0, k ^ _SIGN64, k ^ -1).view(torch.float64)
    bits = torch.where(k >= 2 ** 31, k - 2 ** 31, ~k)
    return bits.to(torch.int32).view(torch.float32)


def _s(x, bits):
    """Signed-comparable form of an unsigned key."""
    return x ^ _SIGN64 if bits == 64 else x


def _umin(a, b, bits):
    return torch.where(_s(b, bits) < _s(a, bits), b, a)


def _umax(a, b, bits):
    return torch.where(_s(a, bits) < _s(b, bits), b, a)


def _ureduce(x, bits, fn):
    return _s(fn(_s(x, bits), dim=1).values, bits)


def _udiv(w, n: int, bits):
    if bits == 32:
        return w // n
    h = (w >> 1) & (2 ** 63 - 1)
    q = (h // n) * 2
    return q + ((w - q * n) >= n).to(torch.int64)


def _wrap(x, bits):
    return x & _MASK32 if bits == 32 else x


def _top(bits):
    return _MASK32 if bits == 32 else -1


def _select_rounds(n_bits: int, n_piv: int) -> int:
    """Rounds for an ``n_piv``-pivot grid to pin an ``n_bits`` key range
    to one value."""
    w = (1 << n_bits) - 1
    r = 0
    while w > 0:
        w = w // n_piv + 1 if w > n_piv - 1 else 0
        r += 1
    return r


def _round_update(lo, hi, p, c, k, bits):
    admit = c.to(torch.int64) >= (k + 1)[:, None]
    top = _top(bits)
    hi = _umin(hi, _ureduce(torch.where(admit, p, top), bits, torch.min),
               bits)
    lo = _umax(lo, _ureduce(torch.where(admit, 0, _wrap(p + 1, bits)),
                            bits, torch.max), bits)
    return lo, hi


def _pivots(lo, hi, n_piv, bits):
    grid = torch.arange(n_piv, device=lo.device)[None, :]
    step = _wrap(_udiv(_wrap(hi - lo, bits), n_piv, bits) + 1, bits)
    p = _wrap(lo[:, None] + step[:, None] * grid, bits)
    return _umin(p, hi[:, None], bits)


def _rank_select_single(count_fn: Callable, B, bits, k, n_piv, device):
    """Exact k-th smallest key (0-based) per read; ``count_fn`` maps
    (B, P) pivot keys to (B, P) counts of keys <= pivot."""
    lo = torch.zeros(B, dtype=torch.int64, device=device)
    hi = torch.full((B,), _top(bits) - 1, dtype=torch.int64, device=device)
    for _ in range(_select_rounds(bits, n_piv)):
        p = _pivots(lo, hi, n_piv, bits)
        lo, hi = _round_update(lo, hi, p, count_fn(p), k, bits)
    return hi


def _dual_rank_select(count_fn: Callable, B, bits, k_lo, k_hi, device):
    """Both middle order statistics, one count pass per round."""
    n_piv = _N_PIV
    zero = torch.zeros(B, dtype=torch.int64, device=device)
    start = torch.full((B,), _top(bits) - 1, dtype=torch.int64,
                       device=device)
    lo1, hi1, lo2, hi2 = zero, start, zero, start
    for _ in range(_select_rounds(bits, n_piv)):
        p1 = _pivots(lo1, hi1, n_piv, bits)
        p2 = _pivots(lo2, hi2, n_piv, bits)
        c = count_fn(torch.cat([p1, p2], dim=1))
        lo1, hi1 = _round_update(lo1, hi1, p1, c[:, :n_piv], k_lo, bits)
        lo2, hi2 = _round_update(lo2, hi2, p2, c[:, n_piv:], k_hi, bits)
    return hi1, hi2


def _pair_ranks(n_pts: torch.Tensor):
    n = n_pts.to(torch.int64)
    m = n * (n - 1) // 2
    return m, torch.clamp((m - 1) // 2, min=0), m // 2


# -------------------------------------------------------- the count (K5)
def count_le_plain(keys_i32: torch.Tensor, pivots_i32: torch.Tensor
                   ) -> torch.Tensor:
    """#{keys <= pivot} per (read, pivot): (B, M), (B, P) -> (B, P) int32."""
    return torch.stack([
        (keys_i32 <= pivots_i32[:, p:p + 1]).sum(1, dtype=torch.int32)
        for p in range(pivots_i32.shape[1])], dim=1)


def _count_fn():
    fn = kernels.load("count_le").tombo_count_le
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def count_le(keys_i32: torch.Tensor, pivots_i32: torch.Tensor
             ) -> torch.Tensor:
    """Streaming multi-pivot count: launches ``csrc/count_le.cu`` on a CUDA
    tensor, runs :func:`count_le_plain` on a CPU tensor."""
    dev = keys_i32.device
    if dev.type == "cpu":
        return count_le_plain(keys_i32, pivots_i32)
    if dev.type != "cuda":
        raise ValueError("count_le: unsupported device %s" % dev)
    if keys_i32.dtype != torch.int32 or pivots_i32.dtype != torch.int32:
        raise TypeError("count_le takes int32 keys and pivots")
    B, M = keys_i32.shape
    P = pivots_i32.shape[1]
    if pivots_i32.shape[0] != B or not 1 <= P <= 32:
        raise ValueError("count_le takes (B, P <= 32) pivots")
    keys = keys_i32.contiguous()
    piv = pivots_i32.contiguous()
    out = torch.zeros((B, P), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _count_fn()(kernels.ptr(keys), M, kernels.ptr(piv), P, B,
                          kernels.ptr(out), kernels.stream_handle(dev))
    if err != 0:
        raise RuntimeError("count_le kernel launch failed (error %d)" % err)
    kernels.count_launch("count_le")
    return out


# ------------------------------------------------------- slope medians
_TRI_CACHE: Dict[Tuple[int, str], Tuple[torch.Tensor, torch.Tensor]] = {}


def tri_indices(N: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cached upper-triangle (i, j) index vectors, i < j, row-major (the
    order of ``np.triu_indices``)."""
    key = (N, str(device))
    out = _TRI_CACHE.get(key)
    if out is None:
        t = torch.triu_indices(N, N, 1, device=device)
        out = (t[0], t[1])
        _TRI_CACHE[key] = out
    return out


def pair_keys_i32(ev, mod, n_pts, max_slope, tri=None) -> torch.Tensor:
    """(B, N(N-1)/2) order-preserving int32 keys of the pairwise slopes,
    INT32_MAX for pairs past ``n_pts``; built ``_KEY_BLOCK`` reads at a
    time to bound the float temporaries."""
    B, N = ev.shape
    ii, jj = tri if tri is not None else tri_indices(N, ev.device)
    keys = torch.empty((B, ii.shape[0]), dtype=torch.int32,
                       device=ev.device)
    block = _KEY_BLOCK
    for b0 in range(0, B, block):
        e, m = ev[b0:b0 + block], mod[b0:b0 + block]
        de = e[:, ii] - e[:, jj]
        dm = m[:, ii] - m[:, jj]
        s = torch.where(de == 0, max_slope, dm / de)
        valid = jj[None, :] < n_pts[b0:b0 + block, None]
        k = torch.where(valid, float_to_key(s), _MASK32)
        keys[b0:b0 + block] = (k - 2 ** 31).to(torch.int32)
    return keys


def pairwise_slope_median_count(ev, mod, n_pts, max_slope, tri=None,
                                count_fn=None):
    """float32 exact pairwise-slope median with streaming counts (the
    structure of ``pairwise_slope_median_pallas``): select the upper
    middle order statistic, derive the lower one exactly from one
    count/max pass (the two ranks are adjacent)."""
    assert ev.dtype == torch.float32, "count-kernel selection is f32-only"
    count_fn = count_fn or count_le
    B = ev.shape[0]
    m, _, k_hi = _pair_ranks(n_pts)
    keys = pair_keys_i32(ev, mod, n_pts, max_slope, tri)

    def count_u(p_u):
        return count_fn(keys, (p_u - 2 ** 31).to(torch.int32))

    hi_key = _rank_select_single(count_u, B, 32, k_hi, _COUNT_PIVOTS,
                                 ev.device)
    vh = (hi_key - 2 ** 31).to(torch.int32)
    lt = keys < vh[:, None]
    c_lt = lt.sum(1, dtype=torch.int64)
    max_below = torch.where(lt, keys, _INT32_MIN).max(1).values
    lo_key = torch.where(c_lt == k_hi, max_below.to(torch.int64) + 2 ** 31,
                         hi_key)
    v_hi = key_to_float(hi_key, torch.float32)
    v_lo = key_to_float(lo_key, torch.float32)
    med = torch.where(m % 2 == 1, v_hi, (v_lo + v_hi) / 2)
    return torch.where(m > 0, med, 0.0)


def pairwise_slope_median(ev, mod, n_pts, max_slope):
    """Exact median over the square (B, N*N) key matrix with dual rank
    selection (the JAX package's XLA engine); any float dtype."""
    dtype = ev.dtype
    B, N = ev.shape
    bits = 64 if dtype == torch.float64 else 32
    m, k_lo, k_hi = _pair_ranks(n_pts)
    iot = torch.arange(N, device=ev.device)
    pair_valid = ((iot[None, :, None] < iot[None, None, :]) &
                  (iot[None, None, :] < n_pts[:, None, None]))
    de = ev[:, :, None] - ev[:, None, :]
    dm = mod[:, :, None] - mod[:, None, :]
    s = torch.where(de == 0, max_slope, dm / de)
    keys_s = _s(torch.where(pair_valid, float_to_key(s), _top(bits)),
                bits).reshape(B, N * N)

    def count(p):
        ps = _s(p, bits)
        return torch.stack([(keys_s <= ps[:, j:j + 1]).sum(1)
                            for j in range(p.shape[1])], dim=1)

    hi1, hi2 = _dual_rank_select(count, B, bits, k_lo, k_hi, ev.device)
    v_lo = key_to_float(hi1, dtype)
    v_hi = key_to_float(hi2, dtype)
    med = torch.where(m % 2 == 1, v_hi, (v_lo + v_hi) / 2)
    return torch.where(m > 0, med, 0.0)


def masked_median_sorted(vals, n_valid):
    """numpy-style median of the first ``n_valid`` entries per row."""
    B, N = vals.shape
    iot = torch.arange(N, device=vals.device)
    v = torch.sort(torch.where(iot[None, :] < n_valid[:, None], vals,
                               float("inf")), dim=1).values
    n = n_valid.to(torch.int64)
    g = lambda k: v.gather(1, k.clamp(0, N - 1)[:, None])[:, 0]
    v_lo, v_hi = g(torch.clamp((n - 1) // 2, min=0)), g(n // 2)
    med = torch.where(n % 2 == 1, v_hi, (v_lo + v_hi) / 2)
    return torch.where(n > 0, med, 0.0)


def fused_residuals(mod, slope, ev):
    """float32 ``mod - slope[:, None] * ev`` rounded once, as a fused
    multiply-add rounds it: the product is exact in float64, the
    difference is held exactly as its float64 sum and that sum's error
    (Knuth's two-sum), and a sum that lies halfway between two float32
    values rounds by the sign of the error; elsewhere the float64 sum
    rounds to the float32 value the exact difference rounds to."""
    a = mod.double()
    b = -(slope.double()[:, None] * ev.double())
    d = a + b
    bb = d - a
    err = (a - (d - bb)) + (b - bb)
    f = d.float()
    r = d - f.double()
    nb = torch.nextafter(f, torch.where(r > 0, float("inf"),
                                        float("-inf")).float())
    tie = (r != 0) & (2 * r == nb.double() - f.double())
    return torch.where(tie & (err * r > 0), nb, f)


def theil_sen_device(ev, mod, n_pts, max_slope: float = 1000.0, tri=None,
                     fused: bool = False):
    """Batched Theil-Sen fit: (slopes, intercepts) with slope = median
    pairwise slope and intercept = median(mod - slope * ev).  float32 goes
    through the count kernel; float64 through the dual selection.
    ``fused``: float32 residuals rounded once (:func:`fused_residuals`),
    as the JAX package's jitted device fit computes them."""
    if ev.dtype == torch.float32:
        slope = pairwise_slope_median_count(ev, mod, n_pts, max_slope,
                                            tri=tri)
    else:
        slope = pairwise_slope_median(ev, mod, n_pts, max_slope)
    resid = (fused_residuals(mod, slope, ev)
             if fused and ev.dtype == torch.float32
             else mod - slope[:, None] * ev)
    return slope, masked_median_sorted(resid, n_pts)


def theil_sen_host(ev: np.ndarray, mod: np.ndarray, max_slope=1000.0):
    """Single-read numpy Theil-Sen (reference: tombo/tombo_stats.py:
    370-419) for the rare host-lane reads."""
    n = ev.shape[0]
    i, j = np.triu_indices(n, 1)
    de = ev[i] - ev[j]
    dm = mod[i] - mod[j]
    with np.errstate(divide="ignore", invalid="ignore"):
        slopes = dm / de
    slopes[de == 0] = max_slope
    slope = float(np.median(slopes))
    return slope, float(np.median(mod - slope * ev))
