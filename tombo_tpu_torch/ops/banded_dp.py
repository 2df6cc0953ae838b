"""Adaptive banded DP + traceback: the CUDA kernels' wrappers, their plain
PyTorch versions, the layout planner that picks one and the read-sharded
launcher (counterpart of ``tombo_tpu/ops/pallas_dp.py``
``adaptive_banded_dp_tb``, ``adaptive_banded_dp_tb_chunked``,
``plan_dp_layout`` and ``adaptive_banded_dp_tb_sharded``).

:func:`adaptive_banded_dp_tb` launches the fused kernel
``csrc/banded_dp.cu`` (K1) on a CUDA tensor and runs
:func:`adaptive_banded_dp_tb_plain` (``ops/dp.py``'s row loops) on a CPU
tensor.  :func:`adaptive_banded_dp_tb_chunked` launches the
sequence-chunked pair ``csrc/banded_dp_chunked.cu`` (K2 forward, K2'
traceback) or runs :func:`adaptive_banded_dp_tb_chunked_plain`.  All take
the same arguments (the chunked ones also ``chunk_rows``) and return
(segs (B, L+1) int32, band_error (B,) bool, bound_error (B,) bool,
final_fwd (B, bw)), the same values from either layout.  With
``rows=True`` they also return each row's forward values, move codes
and band start (:func:`_dump_rows`; the one-read path's DP debug dump):
on a card through the row-writing instances of K1 and K2', which are
otherwise the normal ones.  :func:`adaptive_banded_dp_tb_sharded` (K3)
splits a batch over the devices of a reads mesh and launches K1, or K2
then K2', on each device over its own shard; shard by shard, its plain
version is theirs.  Start discovery uses K1 with ``starts = arange``
covering every row and no masking (:func:`start_dp_segs`)."""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels
from ..device import resolve_mesh
from ..parallel.mesh import gather, shard_batch
from . import dp
from .dp import DpParams, StartDpParams

_INT32_MAX = 2 ** 31 - 1

# K1 keeps each read's (L, bw) uint8 move codes in device memory (in rows
# of move_stride(bw) bytes).  Up to this many move bytes per read a group
# runs fused, above it chunked: a fused launch then holds about 8 MiB of
# moves per read (4 GiB for a 512-read batch, 5% of the card), and the
# chunked pair, which runs each row step twice, takes only the reads whose
# moves would otherwise grow without bound (bw 300 above 16,384 rows, the
# save bandwidth 1500 above 4,096).
PER_READ_MOVE_CAP = 8 * 2 ** 20
# rows per chunk of the chunked pair, at most: per-read scratch is one
# bw-float checkpoint per chunk; the traceback keeps each chunk's (Lc, bw)
# move tile in a block's shared memory (tile_rows)
CHUNK_ROWS = 512
# blocks of the traceback's thread-block cluster (K2'): one read's chunks
# are recomputed this many at a time.  8 is the portable cluster size.
CLUSTER_BLOCKS = 8

# The traceback block's shared memory, as csrc/dp_row_lat.cuh and
# csrc/banded_dp_chunked.cu lay it out: the row loop's two forward rows,
# two staged event windows of bw + _EM_MARGIN and two stages of
# _STAGE_ROWS rows of four 4-byte inputs; then per tile row, bw move codes
# and one band start.  An H100 SM has 233,472 bytes of shared memory, a
# block at most 232,448, and each block on an SM takes 1 KiB more for the
# system: TB_SMEM_BUDGET is one block an SM (less 1 KiB for the kernel's
# static shared memory), TB_SMEM_HALF two.
_EM_MARGIN, _STAGE_ROWS = 256, 32
TB_SMEM_BUDGET = 232448 - 1024
TB_SMEM_HALF = 233472 // 2 - 2048


def tb_smem_bytes(n_tile_rows: int, bandwidth: int) -> int:
    """Dynamic shared memory of one traceback block (bytes)."""
    bw = int(bandwidth)
    rows_loop = 8 * bw + 8 * (bw + _EM_MARGIN) + 2 * _STAGE_ROWS * 16
    return rows_loop + int(n_tile_rows) * (bw + 4)


def _fit_rows(budget: int, bandwidth: int) -> int:
    return (budget - tb_smem_bytes(0, bandwidth)) // (bandwidth + 4)


def tb_smem_budget(bandwidth: int) -> int:
    """The traceback block's shared memory budget at this bandwidth: half
    an SM, so two blocks share one and twice the reads' chunks recompute
    at once, while a tile still holds CHUNK_ROWS / 2 rows (bw 300, where
    two blocks an SM measured 1.6x faster at 16 reads); else one block
    an SM, so a wide band's tile keeps its rows."""
    if _fit_rows(TB_SMEM_HALF, bandwidth) >= CHUNK_ROWS // 2:
        return TB_SMEM_HALF
    return TB_SMEM_BUDGET


def tile_rows(bandwidth: int, chunk_rows: int = CHUNK_ROWS) -> int:
    """Lc_k, the chunk rows of the chunked pair at this bandwidth: at most
    ``chunk_rows``, and as many as let one chunk's move tile stay within
    :func:`tb_smem_budget` (351 at bw 300, 135 at 1500, 39 at 4096).  K2
    checkpoints every Lc_k rows."""
    fit = _fit_rows(tb_smem_budget(bandwidth), bandwidth)
    return max(1, min(int(chunk_rows), fit))


def chunked_scratch_bytes(n_rows: int, bandwidth: int, lc: int) -> int:
    """Device scratch per read of the chunked pair at chunk rows ``lc``:
    one checkpoint (bw forward floats + band start) per chunk.  The move
    tiles never leave shared memory."""
    return -(-int(n_rows) // int(lc)) * (4 * int(bandwidth) + 4)


def move_stride(bandwidth: int) -> int:
    """Bytes of one row of K1's move scratch (csrc/banded_dp.cu): the bw
    move codes, then the row's band start as an int32 in its last 4
    bytes, rows 16-byte aligned for the walk's 16-byte copies."""
    return -(-(int(bandwidth) + 4) // 16) * 16


def plan_dp_layout(n_rows: int, bandwidth: int):
    """("fused",) while one read's ``n_rows x bandwidth`` move bytes stay
    within :data:`PER_READ_MOVE_CAP`, else ("chunked", Lc)."""
    if n_rows * bandwidth <= PER_READ_MOVE_CAP:
        return ("fused",)
    return ("chunked", min(n_rows, CHUNK_ROWS))


def _dump_rows(rows, codes, starts, seq_lens):
    """The rows a ``rows=True`` call returns beside the usual outputs:
    (forward rows (B, L, bw), move codes (B, L, bw) int8 (0 stay, 1 skip,
    2 diag), band starts (B, L) int32), from the row-major (L, B, ...)
    rows of the plain row loop; a read's rows at or past its length are
    zero, as the row-writing kernels, which do not run them, leave
    them."""
    L = starts.shape[0]
    live = (torch.arange(L, device=starts.device)[:, None] <
            seq_lens.long()[None, :])
    return (torch.where(live[..., None], rows, 0).transpose(0, 1)
            .contiguous(),
            torch.where(live[..., None], codes, 0).transpose(0, 1)
            .contiguous(),
            torch.where(live, starts, 0).to(torch.int32).transpose(0, 1)
            .contiguous())


def adaptive_banded_dp_tb_plain(event_means, n_events, ref_means, ref_sds,
                                seq_lens, prefix_starts, prefix_valid_start,
                                prefix_end, start_rows, params: DpParams,
                                n_rows: int, prefix_rows: int,
                                band_bound_thresh: int, rows: bool = False):
    """K1's plain version: every row forward, then the walk back from the
    first argmax of row ``seq_len - 1``.  A read with no such row within
    ``n_rows`` (seq_len 0, or past ``n_rows``) keeps a zero final row and
    starts its walk at its first prefix band start, as K1 does.  With
    ``rows`` it also returns the rows (:func:`_dump_rows`)."""
    bw = params.bandwidth
    x = dp.dp_inputs(event_means, n_events, ref_means, ref_sds, seq_lens,
                     prefix_starts, prefix_valid_start, prefix_end,
                     start_rows, params, n_rows, prefix_rows)
    state, tb, band_starts, *fwd_rows = dp.adaptive_dp_rows(
        x, dp.init_fwd_state(x, bw), 0, n_rows, params, keep_rows=rows)
    init_event_pos = torch.argmax(state.final_fwd, 1) + state.last_start
    segs, _, bound_err = dp.traceback_rows(
        tb, band_starts, x.seq_lens, 0, init_event_pos,
        torch.zeros_like(state.band_error), band_bound_thresh, bw)
    segs = dp.finish_segs(segs, x.seq_lens, init_event_pos, n_rows)
    out = (segs.to(torch.int32), state.band_error, bound_err,
           state.final_fwd)
    if rows:
        out += _dump_rows(fwd_rows[0], tb, band_starts, x.seq_lens)
    return out


def adaptive_banded_dp_tb_chunked_plain(
        event_means, n_events, ref_means, ref_sds, seq_lens, prefix_starts,
        prefix_valid_start, prefix_end, start_rows, params: DpParams,
        n_rows: int, prefix_rows: int, band_bound_thresh: int,
        chunk_rows: int = CHUNK_ROWS, rows: bool = False):
    """The chunked pair's plain version, split as the kernels split the
    work: a forward pass that keeps one checkpoint (forward row, band
    start) per ``chunk_rows`` rows, then the chunks last to first, each
    recomputed from its checkpoint and walked back.  With ``rows`` it
    also returns the recomputed rows (:func:`_dump_rows`)."""
    bw = params.bandwidth
    x = dp.dp_inputs(event_means, n_events, ref_means, ref_sds, seq_lens,
                     prefix_starts, prefix_valid_start, prefix_end,
                     start_rows, params, n_rows, prefix_rows)
    state = dp.init_fwd_state(x, bw)
    chunks = []
    for r0 in range(0, n_rows, chunk_rows):
        r1 = min(r0 + chunk_rows, n_rows)
        chunks.append((r0, r1, state.fwd, state.prev_start))
        state = dp.adaptive_dp_rows(x, state, r0, r1, params)[0]

    init_event_pos = torch.argmax(state.final_fwd, 1) + state.last_start
    event_pos = init_event_pos
    bound_err = torch.zeros_like(state.band_error)
    segs = torch.zeros((x.seq_lens.shape[0], n_rows), dtype=torch.long,
                       device=event_means.device)
    kept = []
    for r0, r1, fwd, start in reversed(chunks):
        # only the rows come out of the recompute: its flags and final
        # row are the forward pass's already
        _, tb, band_starts, *fwd_rows = dp.adaptive_dp_rows(
            x, dp.FwdState(fwd, start, state.band_error, fwd, start), r0, r1,
            params, keep_rows=rows)
        segs[:, r0:r1], event_pos, bound_err = dp.traceback_rows(
            tb, band_starts, x.seq_lens, r0, event_pos, bound_err,
            band_bound_thresh, bw)
        if rows:
            kept.insert(0, (fwd_rows[0], tb, band_starts))
    segs = dp.finish_segs(segs, x.seq_lens, init_event_pos, n_rows)
    out = (segs.to(torch.int32), state.band_error, bound_err,
           state.final_fwd)
    if rows:
        out += _dump_rows(*(torch.cat(k) for k in zip(*kept)), x.seq_lens)
    return out


_IN_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                 ctypes.c_int, ctypes.c_int, ctypes.c_int] +
                [ctypes.c_float] * 5 + [ctypes.c_int])
_ARGTYPES = {
    "tombo_banded_dp": _IN_ARGTYPES + [ctypes.c_void_p, ctypes.c_int] +
    [ctypes.c_void_p] * 6,
    "tombo_banded_dp_occupancy": [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3,
    "tombo_banded_dp_chunked_fwd": _IN_ARGTYPES + [ctypes.c_int] +
    [ctypes.c_void_p] * 6,
    "tombo_banded_dp_chunked_tb": _IN_ARGTYPES + [ctypes.c_int] * 2 +
    [ctypes.c_void_p] * 10,
    "tombo_banded_dp_chunked_tb_occupancy": [ctypes.c_int] * 3 +
    [ctypes.c_void_p] * 2,
}


def _kernel_fn(source: str, symbol: str):
    fn = getattr(kernels.load(source), symbol)
    fn.argtypes = _ARGTYPES[symbol]
    fn.restype = ctypes.c_int
    return fn


def _kernel_inputs(event_means, n_events, ref_means, ref_sds, seq_lens,
                   prefix_starts, prefix_valid_start, prefix_end,
                   start_rows, params: DpParams, n_rows: int,
                   band_bound_thresh: int):
    """Checks the inputs on a CUDA tensor and returns the leading C
    arguments that every DP kernel takes, and the tensors behind their
    pointers (which must stay alive until the launch)."""
    dev = event_means.device
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
    p = kernels.ptr
    args = (p(em), E, p(nev), p(rm), p(rs), rm.shape[1], p(sl), p(ps),
            p(pv), p(pe), P, p(sr), B, L, bw, params.z_shift,
            params.skip_pen, params.stay_pen, params.mask_fill_z_score,
            params.max_half_z_score, int(band_bound_thresh))
    return args, (em, rm, rs, nev, sl, ps, pv, pe, sr)


def _check_launch(err: int, name: str, *also: str):
    """Raise on a failed launch, else count it under ``name`` and each
    name of ``also`` (a kernel launched on another's behalf)."""
    if err != 0:
        raise RuntimeError("%s kernel launch failed (error %d)" % (name,
                                                                   err))
    for n in (name,) + also:
        kernels.count_launch(n)


def adaptive_banded_dp_tb(event_means, n_events, ref_means, ref_sds,
                          seq_lens, prefix_starts, prefix_valid_start,
                          prefix_end, start_rows, params: DpParams,
                          n_rows: int, prefix_rows: int,
                          band_bound_thresh: int, *, also_count=(),
                          rows: bool = False):
    """Start-masked + adaptive banded DP and traceback for a read batch,
    fused (K1): device scratch of ``n_rows x move_stride(bw)`` bytes per
    read.  A launch also counts under each name of ``also_count``.  With
    ``rows`` the call also returns the rows (:func:`_dump_rows`); on a
    card it launches K1's row-writing instance, counted as
    ``banded_dp_rows``, which also writes ``n_rows x bw`` floats a read
    and returns the move scratch's codes and band starts."""
    ins = (event_means, n_events, ref_means, ref_sds, seq_lens,
           prefix_starts, prefix_valid_start, prefix_end, start_rows,
           params, n_rows)
    if event_means.device.type == "cpu":
        return adaptive_banded_dp_tb_plain(*ins, prefix_rows,
                                           band_bound_thresh, rows)
    args, _keep = _kernel_inputs(*ins, band_bound_thresh)
    B, dev = event_means.shape[0], event_means.device
    L, bw = int(n_rows), int(params.bandwidth)
    mst = move_stride(bw)
    # the row-writing instance's unrun rows read as zero
    moves = (torch.zeros if rows else torch.empty)(
        (B, L, mst), dtype=torch.uint8, device=dev)
    segs = torch.empty((B, L + 1), dtype=torch.int32, device=dev)
    band_err = torch.empty(B, dtype=torch.uint8, device=dev)
    bound_err = torch.empty(B, dtype=torch.uint8, device=dev)
    ffwd = torch.empty((B, bw), dtype=torch.float32, device=dev)
    fwd_rows = (torch.zeros((B, L, bw), dtype=torch.float32, device=dev)
                if rows else None)
    p = kernels.ptr
    with torch.cuda.device(dev):
        _check_launch(_kernel_fn("banded_dp", "tombo_banded_dp")(
            *args, p(moves), mst, p(segs), p(band_err), p(bound_err),
            p(ffwd), p(fwd_rows) if rows else None,
            kernels.stream_handle(dev)),
            "banded_dp_rows" if rows else "banded_dp", *also_count)
    out = (segs, band_err.bool(), bound_err.bool(), ffwd)
    if rows:
        out += (fwd_rows, moves[:, :, :bw].view(torch.int8).contiguous(),
                moves[:, :, mst - 4:].contiguous().view(torch.int32)[..., 0])
    return out


def adaptive_banded_dp_tb_chunked(event_means, n_events, ref_means, ref_sds,
                                  seq_lens, prefix_starts,
                                  prefix_valid_start, prefix_end, start_rows,
                                  params: DpParams, n_rows: int,
                                  prefix_rows: int, band_bound_thresh: int,
                                  chunk_rows: int = CHUNK_ROWS,
                                  rows: bool = False):
    """The same DP and traceback, chunked along the rows (K2 forward, then
    K2' traceback, one cluster of :data:`CLUSTER_BLOCKS` blocks per read)
    at :func:`tile_rows` rows a chunk: device scratch per read is one
    forward-row checkpoint per chunk, whatever the read's length.  With
    ``rows`` the call also returns the rows (:func:`_dump_rows`); on a
    card K2' is then its row-writing instance, counted as
    ``banded_dp_chunked_tb_rows``, which writes each recomputed row."""
    ins = (event_means, n_events, ref_means, ref_sds, seq_lens,
           prefix_starts, prefix_valid_start, prefix_end, start_rows,
           params, n_rows)
    if chunk_rows < 1:
        raise ValueError("chunk_rows must be positive")
    L, bw = int(n_rows), int(params.bandwidth)
    Lc = tile_rows(bw, min(int(chunk_rows), L))
    if event_means.device.type == "cpu":
        return adaptive_banded_dp_tb_chunked_plain(
            *ins, prefix_rows, band_bound_thresh, Lc, rows)
    args, _keep = _kernel_inputs(*ins, band_bound_thresh)
    B, dev = event_means.shape[0], event_means.device
    ckpt, ckpt_start = chunked_scratch(B, L, bw, Lc, dev)
    band_err = torch.empty(B, dtype=torch.uint8, device=dev)
    ffwd = torch.empty((B, bw), dtype=torch.float32, device=dev)
    last_bs = torch.empty(B, dtype=torch.int32, device=dev)
    segs = torch.empty((B, L + 1), dtype=torch.int32, device=dev)
    bound_err = torch.empty(B, dtype=torch.uint8, device=dev)
    dump = ((torch.zeros((B, L, bw), dtype=torch.float32, device=dev),
             torch.zeros((B, L, bw), dtype=torch.int8, device=dev),
             torch.zeros((B, L), dtype=torch.int32, device=dev))
            if rows else ())
    p, stream = kernels.ptr, kernels.stream_handle(dev)
    with torch.cuda.device(dev):
        _check_launch(_kernel_fn("banded_dp_chunked",
                                 "tombo_banded_dp_chunked_fwd")(
            *args, Lc, p(ckpt), p(ckpt_start), p(band_err), p(ffwd),
            p(last_bs), stream), "banded_dp_chunked_fwd")
        _check_launch(_kernel_fn("banded_dp_chunked",
                                 "tombo_banded_dp_chunked_tb")(
            *args, Lc, CLUSTER_BLOCKS, p(ckpt), p(ckpt_start), p(ffwd),
            p(last_bs), p(segs), p(bound_err),
            *([p(t) for t in dump] if rows else [None] * 3), stream),
            "banded_dp_chunked_tb_rows" if rows else "banded_dp_chunked_tb")
    return (segs, band_err.bool(), bound_err.bool(), ffwd) + dump


def chunked_scratch(n_reads: int, n_rows: int, bandwidth: int, lc: int,
                    device):
    """The device scratch of the chunked pair, which K2 writes and K2'
    reads: checkpoints (B, n_chunks, bw) float32 and their band starts
    (B, n_chunks) int32; :func:`chunked_scratch_bytes` per read."""
    n_chunks = -(-int(n_rows) // int(lc))
    return (torch.empty((n_reads, n_chunks, bandwidth), dtype=torch.float32,
                        device=device),
            torch.empty((n_reads, n_chunks), dtype=torch.int32,
                        device=device))


def banded_dp_occupancy(bandwidth: int):
    """(threads, dynamic shared memory bytes, blocks resident an SM) of
    K1's block at this bandwidth on the current card, for a report:
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``."""
    threads, smem, blocks = (ctypes.c_int(0), ctypes.c_longlong(0),
                             ctypes.c_int(0))
    err = _kernel_fn("banded_dp", "tombo_banded_dp_occupancy")(
        int(bandwidth), move_stride(bandwidth), ctypes.byref(threads),
        ctypes.byref(smem), ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError("K1 occupancy query failed (error %d)" % err)
    return threads.value, smem.value, blocks.value


def chunked_tb_occupancy(bandwidth: int, lc: int):
    """(shared memory bytes per block, clusters resident at once) of the
    traceback kernel K2' on the current card, for a report:
    ``cudaOccupancyMaxActiveClusters`` at :data:`CLUSTER_BLOCKS`."""
    smem, clusters = ctypes.c_longlong(0), ctypes.c_int(0)
    err = _kernel_fn("banded_dp_chunked",
                     "tombo_banded_dp_chunked_tb_occupancy")(
        int(bandwidth), int(lc), int(CLUSTER_BLOCKS), ctypes.byref(smem),
        ctypes.byref(clusters))
    if err != 0:
        raise RuntimeError("K2' occupancy query failed (error %d)" % err)
    return smem.value, clusters.value


def adaptive_banded_dp_tb_sharded(mesh, dp_args, params: DpParams,
                                  n_rows: int, prefix_rows: int,
                                  band_bound_thresh: int, layout):
    """The adaptive DP and traceback data parallel over the reads axis of a
    mesh (K3): each shard of reads runs K1 (``layout`` ``("fused",)``) or
    K2 then K2' (``("chunked", Lc)``) on its own device.  The recurrence
    is independent per read, so no shard needs another's data.

    ``dp_args`` is either the nine batch-axis arrays that
    :func:`adaptive_banded_dp_tb` takes, whole and on any device (they are
    split with :func:`parallel.mesh.shard_batch`), or one such 9-tuple per
    mesh device, already on it, where ``None`` or zero rows mark an empty
    shard.  ``layout`` is chosen once for the whole batch.  Every shard's
    launch is issued before any result moves, so shards on different
    cards run side by side; an empty shard launches nothing, and a CPU
    shard runs the plain version.  Returns (segs, band_error,
    bound_error, final_fwd) of the whole batch in read order, on
    ``mesh[0]``."""
    mesh = resolve_mesh(mesh)
    if torch.is_tensor(dp_args[0]) or isinstance(dp_args[0], np.ndarray):
        shards = shard_batch(mesh, *dp_args)
    elif len(dp_args) == len(mesh):
        shards = dp_args
    else:
        raise ValueError("sharded DP: %d shards for a mesh of %d" % (
            len(dp_args), len(mesh)))
    if layout[0] == "fused":
        fn, kw = adaptive_banded_dp_tb, {}
    elif layout[0] == "chunked":
        fn, kw = adaptive_banded_dp_tb_chunked, {"chunk_rows": layout[1]}
    else:
        raise ValueError("sharded DP: unknown layout %r" % (layout,))
    outs = []
    for dev, args in zip(mesh, shards):
        if args is None or args[0].shape[0] == 0:
            continue
        if args[0].device != dev:
            raise ValueError("sharded DP: a shard on %s for mesh device %s"
                             % (args[0].device, dev))
        outs.append(fn(*args, params, n_rows, prefix_rows,
                       band_bound_thresh, **kw))
        if dev.type == "cuda":
            kernels.count_launch("banded_dp_sharded")
    if not outs:
        raise ValueError("sharded DP: the batch holds no read")
    return tuple(gather(mesh, [o[i] for o in outs]) for i in range(4))


def start_dp_segs(em_rows, rm, rs, sp: StartDpParams):
    """Start-discovery traceback (B, nb+1) through the adaptive DP: the
    static band moving one event per base is the prefix phase with
    ``starts = arange`` on every row and no masking (the
    parameterization of ``tombo_tpu/pipeline/batch.py``
    ``_start_dp_pallas``; equal to :func:`dp.start_band_dp`).  On a card
    this is K4: one launch of K1, counted under ``start_dp`` too, where
    it launches."""
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
        full(nb), dpp, nb, nb, -1, also_count=("start_dp",))
    return segs
