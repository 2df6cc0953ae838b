"""Fused adaptive banded DP + traceback: the CUDA kernel's wrapper and its
plain PyTorch version (counterpart of ``tombo_tpu/ops/pallas_dp.py``
``adaptive_banded_dp_tb``).

:func:`adaptive_banded_dp_tb` launches ``csrc/banded_dp.cu`` on a CUDA
tensor and runs :func:`adaptive_banded_dp_tb_plain` (``ops/dp.py``'s row
loops) on a CPU tensor.  Both take the same arguments and return
(segs (B, L+1) int32, band_error (B,) bool, bound_error (B,) bool,
final_fwd (B, bw)).  Start discovery uses the same kernel with
``starts = arange`` covering every row and no masking
(:func:`start_dp_segs`)."""
from __future__ import annotations

import ctypes

import torch

from .. import kernels
from . import dp
from .dp import DpParams, StartDpParams

_INT32_MAX = 2 ** 31 - 1


def adaptive_banded_dp_tb_plain(event_means, n_events, ref_means, ref_sds,
                                seq_lens, prefix_starts, prefix_valid_start,
                                prefix_end, start_rows, params: DpParams,
                                n_rows: int, prefix_rows: int,
                                band_bound_thresh: int):
    tb, band_starts, final_fwd, band_err = dp.adaptive_banded_dp(
        event_means, n_events, ref_means, ref_sds, seq_lens, prefix_starts,
        prefix_valid_start, prefix_end, start_rows, params, n_rows,
        prefix_rows)
    top = torch.argmax(final_fwd, 1)
    segs, bound_err = dp.banded_traceback(
        tb, band_starts, seq_lens, top, band_bound_thresh,
        params.bandwidth, n_rows)
    return segs.to(torch.int32), band_err, bound_err, final_fwd


_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
              ctypes.c_int, ctypes.c_int, ctypes.c_int] +
             [ctypes.c_float] * 5 + [ctypes.c_int] +
             [ctypes.c_void_p] * 7)


def _kernel_fn():
    fn = kernels.load("banded_dp").tombo_banded_dp
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def adaptive_banded_dp_tb(event_means, n_events, ref_means, ref_sds,
                          seq_lens, prefix_starts, prefix_valid_start,
                          prefix_end, start_rows, params: DpParams,
                          n_rows: int, prefix_rows: int,
                          band_bound_thresh: int):
    """Start-masked + adaptive banded DP and traceback for a read batch."""
    dev = event_means.device
    if dev.type == "cpu":
        return adaptive_banded_dp_tb_plain(
            event_means, n_events, ref_means, ref_sds, seq_lens,
            prefix_starts, prefix_valid_start, prefix_end, start_rows,
            params, n_rows, prefix_rows, band_bound_thresh)
    if dev.type != "cuda":
        raise ValueError("banded DP: unsupported device %s" % dev)
    if event_means.dtype != torch.float32:
        raise TypeError("banded DP kernel takes float32 event means")
    B, E = event_means.shape
    L, bw = int(n_rows), int(params.bandwidth)
    P = prefix_starts.shape[1]
    if ref_means.shape[1] < L or ref_sds.shape != ref_means.shape:
        raise ValueError("ref levels must cover n_rows")
    if not 1 <= bw <= 4096:
        raise ValueError("banded DP kernel supports 1 <= bandwidth <= 4096")

    def i32(x):
        x = torch.as_tensor(x, device=dev)
        if x.dtype == torch.int64:
            x = x.clamp(-_INT32_MAX - 1, _INT32_MAX)
        return x.to(torch.int32).contiguous()

    em = event_means.contiguous()
    rm = ref_means.to(torch.float32).contiguous()
    rs = ref_sds.to(torch.float32).contiguous()
    nev, sl, ps, pv, pe, sr = (i32(n_events), i32(seq_lens),
                               i32(prefix_starts), i32(prefix_valid_start),
                               i32(prefix_end), i32(start_rows))
    moves = torch.empty((B, L, bw), dtype=torch.uint8, device=dev)
    bstarts = torch.empty((B, L), dtype=torch.int32, device=dev)
    segs = torch.empty((B, L + 1), dtype=torch.int32, device=dev)
    band_err = torch.empty(B, dtype=torch.uint8, device=dev)
    bound_err = torch.empty(B, dtype=torch.uint8, device=dev)
    ffwd = torch.empty((B, bw), dtype=torch.float32, device=dev)
    p = kernels.ptr
    err = _kernel_fn()(
        p(em), E, p(nev), p(rm), p(rs), rm.shape[1], p(sl), p(ps), p(pv),
        p(pe), P, p(sr), B, L, bw, params.z_shift, params.skip_pen,
        params.stay_pen, params.mask_fill_z_score, params.max_half_z_score,
        int(band_bound_thresh), p(moves), p(bstarts), p(segs), p(band_err),
        p(bound_err), p(ffwd), kernels.stream_handle(dev))
    if err != 0:
        raise RuntimeError("banded_dp kernel launch failed (error %d)" % err)
    kernels.count_launch("banded_dp")
    return segs, band_err.bool(), bound_err.bool(), ffwd


def start_dp_segs(em_rows, rm, rs, sp: StartDpParams):
    """Start-discovery traceback (B, nb+1) through the adaptive DP: the
    static band moving one event per base is the prefix phase with
    ``starts = arange`` on every row and no masking (the
    parameterization of ``tombo_tpu/pipeline/batch.py``
    ``_start_dp_pallas``; equal to :func:`dp.start_band_dp`)."""
    B, dev = em_rows.shape[0], em_rows.device
    nb, ne = sp.num_bases, sp.num_events
    dpp = DpParams(z_shift=sp.z_shift, skip_pen=sp.skip_pen,
                   stay_pen=sp.stay_pen, mask_fill_z_score=0.0,
                   max_half_z_score=sp.max_half_z_score, bandwidth=ne)
    full = lambda v: torch.full((B,), v, dtype=torch.int32, device=dev)
    pstarts = torch.arange(nb, dtype=torch.int32, device=dev)[None, :]
    segs, _, _, _ = adaptive_banded_dp_tb(
        em_rows, full(nb + ne), rm, rs, full(nb), pstarts.expand(B, nb),
        full(0), torch.full((B, nb), _INT32_MAX, dtype=torch.int32,
                            device=dev),
        full(nb), dpp, nb, nb, -1)
    return segs
