"""Batched DNA and direct-RNA re-squiggle on the card (counterpart of
``tombo_tpu/pipeline/batch.py``).

Reads are padded to batch shapes and driven through device stages, in the
JAX package's stage order:

  A. normalize + changepoint scores + greedy selection + event means
     + start-discovery DP (banded DP kernel) + validity score  [device]
     (RNA: t-test scores, selection, stall-interval changepoint removal,
     event-based scale values, then normalize and event means)
  B. start retry with the save start band / static-band routing   [host]
  C. masked-start + adaptive banded DP + traceback (fused DP kernel, or
     the row-chunked pair for long reads) + traceback trim and raw
     coordinates                                                 [device]
  D. deletion-fix window planning [host], raw-signal deletion fix +
     exact Theil-Sen fit (count kernel) + score                  [device]
  -> up to 3 scaling iterations on reads whose scale changed; failed
     reads retried with the save bandwidth.

Host-lane reads (short reads routed to the static band, deletion windows
beyond the device caps) finish in batched calls of the host library
(``native.py``: ``finalize_batch`` at float32; ``del_fix_batch`` and
``theil_sen_batch`` at float64, and at float32 in the Python host lane
of :class:`FinalizeLanes`).  The PyTorch-side parts are plain
tensor code; the kernels are ``ops/banded_dp.py``'s (fused and chunked DP)
and ``ops/rescale.py``'s ``count_le``.  On a CPU device every kernel
wrapper runs its plain version.  A batch splits into signal-length groups
(``_length_groups``).

Every group runs over a reads mesh (``parallel/mesh.py``): its live reads
split into contiguous shards, one per mesh device, and each device stage
runs once per shard on that shard's device, at the shapes of the whole
group, so results do not depend on the shard count.  The group's adaptive
DP is one call of the read-sharded launcher (K3), which launches the
fused kernel, or one of each chunked kernel, per shard.  ``mesh=None`` is
a mesh of the one ``device``.

``const_scale`` gives every read the median shift and one shared scale
(scale values derived on the host, then the provided-scale path), and
``skip_seq_scaling`` keeps the first scale values (no Theil-Sen fit, no
further scaling iteration).  The float64 parity mode (CPU) takes the JAX
package's float64 lane where it differs from the float32 one: rescale
passes re-select changepoints, and deletion-fix reads finish on the host.

Data stays on the device between stages and passes, as in the JAX
package's float32 lane: a read's raw matrix row and changepoints are
kept as (device matrix, row) and gathered there by a rescale pass;
k-mer levels are looked up on the device from 2-bit packed bases; the
segment tables come down as uint8 deltas (a row with a longer segment
again in full); the host fetches a read's changepoints only for the
static band; and each stage's per-read scalars come down as one stacked
float32 array on the float32 lane.

``lanes=`` (a :class:`FinalizeLanes`) picks where the float32 lane trims
the traceback, fixes deletions and fits: the JAX package's alternative
lanes of its batched finalize, the defaults its defaults.

``profile=`` (a :class:`StageProfile`) records a span for every stage,
sub-stage and wait for device results, each batch and each scaling
pass, the bytes that cross between host and device and counts of the
work done, retried and routed; :func:`print_stage_timings` and
:func:`print_counters` print them.  ``resquiggle_batches(...,
trace_dir=)`` writes a torch.profiler trace (:func:`trace_ctx`) in which
the same spans are named ranges.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import os
import sys
import threading
import time
import types as _pytypes
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import config, native
from ..config import MASK_FILL_Z_SCORE, ResquiggleParams, SIG_MATCH_THRESH
from ..device import DeviceLike, resolve_device, resolve_dtype, resolve_mesh
from ..errors import TomboError
from ..ops import banded_dp, delfix, rescale
from ..ops import normalize as nrm
from ..ops import ref_impl
from ..ops import segment as seg
from ..ops import select as sel
from ..ops.dp import DpParams, StartDpParams
from ..ops.precision import prefix_sums, row_sums
from ..parallel.mesh import shard_sizes
from ..seq import encode_seq
from ..stats import device_levels
from ..types import DpResults, ResquiggleResults, ScaleValues, SeqSampleType
from . import resquiggle as rsq

_GROUP_RATIO = 2.0      # max signal-length spread within a device group
_MIN_GROUP = 24         # don't cut groups smaller than this

# deletion-fix windows beyond these route the read to the host lane
# (the reference errors out above MAX_RAW_CPTS=200 events)
_DELFIX_NB_CAP = 32
_DELFIX_T_CAP = 512
# reads a block of the Python host lane's device Theil-Sen fit
_TS_BLOCK = 64


@dataclass(frozen=True)
class FinalizeLanes:
    """The lanes of the batched finalize, one field a switch of the JAX
    package's batched lane; the defaults are its defaults.  The float64
    lane heeds ``device_finalize`` alone, as the JAX float64 lane does.

    ``device_finalize``: the traceback trim, raw coordinates and deletion
    flag on the device (``_stage_finalize``).  False: the traceback and
    its reads' changepoints come down and the host trims it
    (``_trim_traceback``, ``get_rel_raw_coords``), as the JAX
    ``_dp_and_finalize``'s host branch; no device deletion fix or fit
    follows, and every read finishes on a host lane.

    ``device_delfix``: the deletion fix, then the fit on the fixed table,
    on the device (``_delfix_and_fit``).  False: the fit rides the
    adaptive dispatch on the unfixed table (``_stage_fit``, the JAX
    ``_dp_and_finalize``'s ``use_dev_fit``), serves the reads without a
    deletion, and is skipped while the deletion rate says most of it would
    be thrown away (``_fit_mostly_wasted``); reads with a deletion finish
    on a host lane.

    ``device_fit``: None gates that fit by the deletion rate; True runs it
    without the gate (where ``device_delfix`` is False); False turns off
    the device fit and the device deletion fix together.

    ``native_finalize``: host-lane reads go through the host library's
    ``finalize_batch`` (``_finalize_native``).  False: the Python host lane
    (``_finalize_host``, the JAX ``_finalize``'s Python passes): float64
    normalization, one ``del_fix_batch``, event means, one float32
    ``theil_sen_batch``.

    ``device_theil_sen``: the Python host lane's fit runs on the device in
    blocks of ``_TS_BLOCK`` reads through the count kernel
    (``_theil_sen_device_blocks``) where it has 32 reads or more on one
    device."""
    device_finalize: bool = True
    device_delfix: bool = True
    device_fit: Optional[bool] = None
    native_finalize: bool = True
    device_theil_sen: bool = False


# the six stages; a wait for device results inside one is a span named
# ``<stage>_fetch``
STAGES = ("segment", "plan", "start", "adaptive", "static", "finalize")
# the spans whose seconds ``StageProfile.timings`` sums (the JAX package's
# keys), with every ``<stage>_fetch``
_TIMED = frozenset(STAGES + ("seg_pack", "seg_upload", "delfix_plan",
                             "delfix_apply", "finalize_native"))


class Span:
    """One record of :attr:`StageProfile.spans`.  ``parent``: the index in
    the log of the span open around it in its thread (-1: none);
    ``batch``: the sequence number of its ``batch`` span in the profile;
    ``pass_no``: the scaling pass of that batch (0 the first; a
    save-bandwidth retry's passes go on counting); -1 outside either.
    ``start_ns`` and ``end_ns``: ``time.time_ns()`` at its start and end
    (0 while open), the clock of a torch.profiler Chrome trace: an
    event's ``ts`` (µs) plus the file's ``baseTimeNanoseconds``."""
    __slots__ = ("name", "parent", "batch", "pass_no", "start_ns", "end_ns")

    def __init__(self, name: str, parent: int, batch: int, pass_no: int):
        self.name, self.parent = name, parent
        self.batch, self.pass_no = batch, pass_no
        self.start_ns = self.end_ns = 0


class _Thread(threading.local):
    """A thread's open spans (indices in the log) and its batch and
    pass."""

    def __init__(self):
        self.stack = []
        self.batch = -1
        self.pass_no = -1


class StageProfile:
    """Where a re-squiggle's wall time went (the JAX package's
    ``STAGE_TIMINGS`` and ``TRANSFER_BYTES``, as one object a caller
    passes), and what work it did.

    ``spans``: the span log (:class:`Span`), one record for each span the
    batched lane opened: every ``batch`` and each scaling ``pass`` in it,
    the stages (``STAGES``), their sub-stages and phases, and ``<stage>_
    fetch``, a wait in a stage's device to host copies.  Spans nest, and
    a child's time counts in its parent's.  ``timings``: seconds by name,
    the sums of the span log over the JAX package's keys: the stages; the
    sub-stages ``seg_pack`` and ``seg_upload`` (the raw matrix packed on
    the host and sent to the device), ``delfix_plan`` and
    ``delfix_apply`` (the deletion-fix windows planned and applied on the
    host) and ``finalize_native`` (the host library's finalize); and
    every ``<stage>_fetch``.  The other spans are in the log alone.  A
    run adds ``io_map`` and ``writeback`` (``pipeline/runner.py``).
    ``transfer_bytes``: ``upload`` (host to device) and ``fetch`` (device
    to host), counted on a CPU device too.  ``row_fetches``: rows the
    host copied from a matrix that otherwise stays on the device, by
    name: ``cpts`` (a static-band read's changepoints) and ``seg_over``
    (a segment table with a segment longer than the uint8 wire holds).
    ``counters``: counts by name (:func:`print_counters`): the work done
    (``batches``, ``reads`` of the batches asked for, ``read_passes``,
    every read entering a scaling pass, ``groups``), retried
    (``start_retry_reads``, ``save_bw_retry_reads``) and routed
    (``finalize_device_reads``, ``finalize_host_reads``,
    ``host_lane.<reason>`` for each read a host lane finishes, and
    ``fetches``, the device to host copies).

    Nothing is synchronised for the profile: device work surfaces where
    the host waits for it, in a ``_fetch`` span, or in the span whose
    ``.item()``, boolean indexing or ``nonzero`` on a card tensor waits
    for it, which no ``_fetch`` span sees.  Threads may add to one
    profile at once; each thread's spans nest on their own."""

    def __init__(self):
        self.timings = {}
        self.transfer_bytes = {}
        self.row_fetches = {}
        self.counters = {}
        self.spans: List[Span] = []
        self._batches = 0
        self._lock = threading.Lock()
        self._local = _Thread()

    def add_time(self, name: str, seconds: float):
        with self._lock:
            self.timings[name] = self.timings.get(name, 0.0) + seconds

    def add_bytes(self, direction: str, n: int):
        with self._lock:
            self.transfer_bytes[direction] = (
                self.transfer_bytes.get(direction, 0) + int(n))

    def add_rows(self, name: str, n: int):
        with self._lock:
            self.row_fetches[name] = self.row_fetches.get(name, 0) + int(n)

    def count(self, name: str, n: int = 1):
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + int(n)

    def begin(self, name: str) -> Span:
        """Open a span in this thread, inside its open span; a ``batch``
        span starts a batch, a ``pass`` span the batch's next pass."""
        loc = self._local
        with self._lock:
            if name == "batch":
                loc.batch, loc.pass_no = self._batches, -1
                self._batches += 1
            elif name == "pass":
                loc.pass_no += 1
            span = Span(name, loc.stack[-1] if loc.stack else -1, loc.batch,
                        loc.pass_no)
            loc.stack.append(len(self.spans))
            self.spans.append(span)
        span.start_ns = time.time_ns()
        return span

    def end(self, span: Span):
        """Close ``span``, this thread's innermost open span."""
        span.end_ns = time.time_ns()
        self._local.stack.pop()
        if span.name in _TIMED or span.name.endswith("_fetch"):
            self.add_time(span.name, (span.end_ns - span.start_ns) * 1e-9)


class _Span:
    """One span of a :class:`BatchedResquiggler` (its :meth:`_span`): a
    ``record_function`` range while a torch.profiler session records (as
    ``resquiggle_batches(trace_dir=)`` runs one), and a span of the
    resquiggler's profile where it has one.  The profile's span lies
    inside the range.  A stage's span makes it the stage whose
    ``_fetch`` spans its copies open."""
    __slots__ = ("owner", "name", "profile", "range", "span", "prev")

    def __init__(self, owner, name: str):
        self.owner, self.name = owner, name

    def __enter__(self):
        self.range = self.span = None
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.prev = self.owner._stage
        if self.name in STAGES:
            self.owner._stage = self.name
        self.profile = self.owner.profile
        if self.profile is not None:
            self.span = self.profile.begin(self.name)
        return self

    def __exit__(self, *exc):
        if self.span is not None:
            self.profile.end(self.span)
        self.owner._stage = self.prev
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


# what _span returns with no profile and no trace: nothing runs
_NULL_SPAN = contextlib.nullcontext()


def print_stage_timings(profile: StageProfile, out=None):
    """The JAX package's table: every key by seconds with its share of the
    sum of all keys, then the transfer bytes by direction; to stderr by
    default."""
    out = out or sys.stderr
    with profile._lock:
        timings = dict(profile.timings)
        transfer = dict(profile.transfer_bytes)
    total = sum(timings.values())
    for name, t in sorted(timings.items(), key=lambda kv: -kv[1]):
        out.write("  %-18s %8.3f s (%4.1f%%)\n" % (
            name, t, 100 * t / total if total else 0))
    for name, b in sorted(transfer.items()):
        out.write("  %-18s %8.2f MB\n" % (name, b / 2 ** 20))


def print_counters(profile: StageProfile, out=None):
    """The profile's counters by name under a ``counters`` line, to
    stderr by default; nothing where there are none."""
    out = out or sys.stderr
    with profile._lock:
        counters = dict(profile.counters)
    if counters:
        out.write("counters\n")
    for name, n in sorted(counters.items()):
        out.write("  %-30s %12d\n" % (name, n))


@contextlib.contextmanager
def trace_ctx(trace_dir: str, devices):
    """A torch.profiler trace of the block (the JAX package's
    ``jax_trace_ctx``), written into ``trace_dir`` as Chrome trace JSON
    (``<host>_<pid>.<ns>.pt.trace.json``; TensorBoard's profile plugin and
    chrome://tracing read it).  Host activity always; the cards' kernels
    and copies when ``devices`` holds a card, which is synchronised before
    the trace closes so that the last kernels queued are in it."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    cards = [d for d in devices if d.type == "cuda"]
    activities = [ProfilerActivity.CPU]
    if cards:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(trace_dir)):
        try:
            yield
        finally:
            for d in cards:
                torch.cuda.synchronize(d)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pow2_bucket(x: int, lo: int) -> int:
    b = lo
    while b < x:
        b *= 2
    return b


def _sig_bucket(x: int, lo: int = 1024) -> int:
    """Signal-axis bucket: half-octave steps (pow2 and 1.5x pow2)."""
    b = lo
    while True:
        if x <= b:
            return b
        if x <= b + b // 2:
            return b + b // 2
        b *= 2


def _as_int16(signal, raw: np.ndarray) -> Optional[np.ndarray]:
    """A read's raw ``signal`` as int16 where it is integral and below
    2^15 in magnitude (the wire's input), else None; ``raw`` is its
    float64 copy."""
    signal = np.asarray(signal)
    if signal.dtype == np.int16:
        return signal
    if (raw.size and np.abs(raw).max() < 2 ** 15 and
            np.all(raw == np.trunc(raw))):
        return raw.astype(np.int16)
    return None


def _pack_delta_wire(raws, sig_lens: np.ndarray, S: int):
    """The int8-delta wire of int16 rows (the JAX package's): each read's
    consecutive differences in one flat int8 buffer, the differences that
    int8 cannot hold as an escape list of (position in the flattened
    (B, S) matrix, residual).  Returns (flat8, offs int32 (B,), firsts
    int16 (B,), exc_dest int32, exc_res int32).  Unlike the JAX lane's,
    the buffers are not padded to bucket sizes: eager PyTorch compiles
    nothing per shape, and the padding would be a fifth of the wire."""
    B = len(raws)
    if B * S >= 2 ** 31:
        raise ValueError("a %d x %d raw matrix is past the wire's int32 "
                         "positions" % (B, S))
    d8_lens = np.maximum(sig_lens - 1, 0)
    # one byte at least: the decoder gathers from it for every row
    flat8 = np.zeros(max(int(d8_lens.sum()), 1), np.int8)
    offs = np.zeros(B, np.int64)
    np.cumsum(d8_lens[:-1], out=offs[1:])
    firsts, exc_rd, exc_pos, exc_res = native.pack_delta8_batch(
        [np.ascontiguousarray(r) for r in raws], sig_lens, flat8, offs)
    exc_dest = (exc_pos + 1 + exc_rd.astype(np.int64) * S).astype(np.int32)
    return flat8, offs.astype(np.int32), firsts, exc_dest, exc_res


def _unflatten_delta_rows(flat8, offs, firsts, exc_dest, exc_res, lens,
                          S: int) -> torch.Tensor:
    """The (B, S) int16 matrix from the int8-delta wire (the JAX
    package's ``_unflatten_delta_rows``): deltas gathered into their rows,
    the escape residuals added at their positions, an integer cumsum
    along the signal axis; zero past each read's end.  Exact."""
    B = offs.shape[0]
    pos = torch.arange(S, device=flat8.device)[None, :]
    lens = lens[:, None]
    valid = (pos >= 1) & (pos < lens)
    idx = torch.where(valid, offs.long()[:, None] + pos - 1, 0)
    d = torch.where(valid, flat8[idx].int(), 0)
    d = torch.where(pos == 0, firsts.int()[:, None], d)
    d = d.reshape(-1).index_add_(0, exc_dest.long(), exc_res)
    x = torch.cumsum(d.view(B, S), 1, dtype=torch.int32)
    return torch.where(pos < lens, x, 0).to(torch.int16)


def _pack_bases(bc: np.ndarray) -> np.ndarray:
    """Base codes 0..3 packed four to a byte, the first base in the
    lowest two bits, zero past the end (the JAX package's
    ``_pack_bases``); the device unpacks them with two-bit shifts
    (:func:`_codes_from_packed`)."""
    b = np.zeros(_round_up(bc.shape[0], 4), np.uint8)
    b[:bc.shape[0]] = bc
    b = b.reshape(-1, 4)
    return (b[:, 0] | (b[:, 1] << 2) | (b[:, 2] << 4) |
            (b[:, 3] << 6)).astype(np.uint8)


def _kmer_plan(seqs: Sequence[str], k: int):
    """The k-mer plan of a batch of sequences in a few array operations
    over one flat buffer of every read's base codes, each read starting
    at a multiple of 4 and padded with A (code 0) up to the next (the
    JAX package's ``_plan_reads`` builds a (reads, longest read) matrix
    instead, whose padding doubles the work on mixed lengths).  Returns
    (the k-mer code at each position of the buffer, first base most
    significant: a read's codes are the first ``len - k + 1`` from its
    start, exact where the read holds no invalid base; the buffer packed
    four bases to a byte, a read's from its start / 4; each read's start;
    each read's base count; whether a read holds an invalid base)."""
    lens = np.array([len(q) for q in seqs], np.int64)
    starts = np.zeros(lens.shape[0] + 1, np.int64)
    np.cumsum((lens + 3) // 4 * 4, out=starts[1:])
    N = int(starts[-1])
    # k - 1 more A's: the last position's window stays inside the buffer
    bases = encode_seq("".join(q.ljust(n, "A") for q, n in zip(
        seqs, np.diff(starts).tolist())) + "A" * (k - 1))
    invalid = np.flatnonzero(bases < 0)
    starts = starts[:-1]
    bad = (np.searchsorted(invalid, starts + lens) >
           np.searchsorted(invalid, starts))
    np.maximum(bases, 0, out=bases)
    codes = np.zeros(N, np.int32)
    for j in range(k):
        codes *= 4
        codes += bases[j:j + N]
    # int64 indices gather the levels fastest
    return codes.astype(np.int64), _pack_bases(bases[:N]), starts, lens, bad


def _codes_from_packed(packed, n_codes, width: int, k: int, n_sent: int,
                       clip: bool) -> torch.Tensor:
    """(B, width) int32 k-mer codes from (B, PB) 2-bit packed bases and
    each read's code count (the JAX package's ``_codes_from_packed``):
    the host's integer arithmetic, first base most significant; ``n_sent``
    past each read's codes, or, with ``clip``, on every row of a read
    with fewer than ``width`` codes."""
    B, PB = packed.shape
    p = packed.to(torch.int32)
    bases = torch.stack([(p >> (2 * j)) & 3 for j in range(4)],
                        -1).reshape(B, PB * 4)[:, :width + k - 1]
    codes = torch.zeros((B, width), dtype=torch.int32, device=p.device)
    for j in range(k):
        codes = codes * 4 + bases[:, j:j + width]
    nc = n_codes.to(torch.int32)[:, None]
    if clip:
        valid = nc >= width
    else:
        valid = torch.arange(width, device=p.device)[None, :] < nc
    return torch.where(valid, codes, n_sent)


def _levels_from_codes(mt, st, codes):
    """(means, sds) rows gathered from the device k-mer table; the
    sentinel index (the table's last row) gives (1.0, 1.0), so the rows
    equal the host-built, ones-padded level matrices bit for bit."""
    c = codes.long()
    return mt[c], st[c]


def _gather_rows_pad(src, rows, width: int) -> torch.Tensor:
    """``src[rows]`` cropped or zero-padded to ``width`` columns (the JAX
    package's ``_gather_rows_pad``)."""
    return _pad_cols(src[rows.long()][:, :width], width)


@dataclass
class _ReadState:
    """Per-read mutable state as it flows through the stages."""
    idx: int
    map_res: ResquiggleResults
    raw: np.ndarray
    num_events: int
    error: Optional[str] = None
    scale_values: Optional[ScaleValues] = None
    # the changepoints on the host, copied only where the host needs them
    # (:meth:`BatchedResquiggler._fetch_cpts`); on the device they are
    # (matrix, row, count), gathered there by a rescale pass
    cpts: Optional[np.ndarray] = None
    cpts_dev: Optional[tuple] = None
    # (device raw matrix at the lane's dtype, row) of the last segment
    # pass; a rescale pass gathers it instead of sending the signal again
    raw_dev: Optional[tuple] = None
    event_means: Optional[np.ndarray] = None
    ref_means: Optional[np.ndarray] = None
    ref_sds: Optional[np.ndarray] = None
    # k-mer codes of the mapped sequence and its 2-bit packed bases, from
    # which the device derives the codes and looks up the levels
    ref_codes: Optional[np.ndarray] = None
    packed_bases: Optional[np.ndarray] = None
    genome_seq_trim: Optional[str] = None
    use_static: bool = False
    n_ev: int = 0
    # the read's mesh shard, and its row in that shard's device context
    shard: int = 0
    dev_row: int = -1
    mapped_start: int = 0
    events_per_base: float = 0.0
    events_start_clip: int = 0
    mapped_start_offset: int = 0
    result: Optional[ResquiggleResults] = None
    # device DP outputs: relative segment table + raw start; has_del
    # False = no zero-length segment, None = unknown (host lane decides)
    dp_segs: Optional[np.ndarray] = None
    dp_rsrtr: int = 0
    has_del: Optional[bool] = None
    del_windows: Optional[tuple] = None
    del_fixed: bool = False
    # device fit (shift_corr, scale_corr, score, changed, fit_ok)
    dev_fit: Optional[tuple] = None
    # why the read leaves the device lane for a host lane (the profile's
    # ``host_lane.<reason>``), set where that is decided
    host_lane: Optional[str] = None

    @functools.cached_property
    def raw_i16(self) -> Optional[np.ndarray]:
        """The raw signal as int16 where it is integral and below 2^15 in
        magnitude (the input of the raw wire), else None; looked at on
        first use and kept for every later pass."""
        return _as_int16(self.map_res.raw_signal, self.raw)

    def reset_pass(self):
        """Clear per-pass products before another scaling iteration."""
        self.result = None
        self.scale_values = None
        self.use_static = False
        self.has_del = None
        self.dp_segs = None
        self.del_windows = None
        self.del_fixed = False
        self.dev_fit = None
        self.host_lane = None


def _length_groups(live: list) -> list:
    """Split a batch into signal-length groups (spread <= _GROUP_RATIO,
    groups >= _MIN_GROUP reads) so one far-tail read does not pad every
    read's device shapes."""
    if len(live) < 2 * _MIN_GROUP:
        return [live] if live else []
    order = sorted(live, key=lambda s: s.raw.shape[0])
    groups, start, base = [], 0, order[0].raw.shape[0]
    for i, s in enumerate(order):
        if i - start >= _MIN_GROUP and s.raw.shape[0] > base * _GROUP_RATIO:
            groups.append(order[start:i])
            start, base = i, s.raw.shape[0]
    groups.append(order[start:])
    return groups


# ------------------------------------------------------- device stages
def _pad_cols(x: torch.Tensor, width: int, value=0.0) -> torch.Tensor:
    if x.shape[1] >= width:
        return x
    return torch.nn.functional.pad(x, (0, width - x.shape[1]), value=value)


def _start_dp_with_score(em_rows, rm, rs, sp: StartDpParams):
    """Start DP (banded DP kernel) + validity score (reference:
    tombo/tombo_stats.py:2341-2362 ``score_valid_bases``): mean half
    z-score over the non-duplicated bases of the start traceback."""
    segs = banded_dp.start_dp_segs(em_rows, rm, rs, sp).long()
    cs = prefix_sums(em_rows)
    segs = segs.clamp(0, cs.shape[1] - 1)
    s0, s1 = segs[:, :-1], segs[:, 1:]
    lens = (s1 - s0).to(cs.dtype)
    valid = s1 != s0
    bmeans = torch.where(
        valid, (cs.gather(1, s1) - cs.gather(1, s0)) /
        torch.where(valid, lens, 1.0), 0.0).to(em_rows.dtype)
    half_z = torch.abs((bmeans - rm) / rs)
    n_valid = valid.sum(1)
    score = torch.where(
        n_valid > 0,
        row_sums(torch.where(valid, half_z, 0.0)) /
        torch.clamp(n_valid, min=1), float("inf"))
    return segs, score


def _stage_a_dna(raw, sig_lens, has_sv, sv_shift, sv_scale, sv_lower,
                 sv_upper, num_cpts, rm_start, rs_start, outlier_thresh,
                 w: int, min_base_obs: int, max_cpts: int,
                 sp: StartDpParams):
    """DNA stages 1-3: normalize (median/MAD, or given scale values) ->
    changepoint scores -> greedy selection -> event means -> start DP +
    validity score."""
    norm, shift, scale, lower, upper = nrm.normalize_median_batch(
        raw, sig_lens, outlier_thresh)
    shift = torch.where(has_sv, sv_shift, shift)
    scale = torch.where(has_sv, sv_scale, scale)
    lower = torch.where(has_sv, sv_lower, lower)
    upper = torch.where(has_sv, sv_upper, upper)
    norm_sv = torch.minimum(torch.maximum(
        (raw - shift[:, None]) / scale[:, None], lower[:, None]),
        upper[:, None])
    idx = torch.arange(raw.shape[1], device=raw.device)[None, :]
    norm_sv = torch.where(idx < sig_lens[:, None], norm_sv, 0.0)
    norm = torch.where(has_sv[:, None], norm_sv, norm)
    scores = seg.cpt_scores_diff_batch(norm, sig_lens, w)
    cpts, status = sel.greedy_cpts_device(
        scores, sig_lens - 2 * w + 1, num_cpts, min_base_obs, w, max_cpts)
    em = nrm.compute_base_means_batch(norm, cpts, num_cpts - 1)
    need = sp.num_bases + sp.num_events
    start_segs, start_score = _start_dp_with_score(
        _pad_cols(em, need)[:, :need], rm_start, rs_start, sp)
    return (norm, em, cpts, status, shift, scale, lower, upper, start_segs,
            start_score)


def rna_event_scale(raw, sig_lens, num_cpts, stall_starts, stall_ends,
                    w: int, min_base_obs: int, max_cpts: int):
    """RNA changepoints and scale: t-test changepoint scores -> greedy
    selection -> removal of the changepoints inside stall intervals,
    compacted -> event-based scale values (median and MAD of the first
    events' raw means).  Returns (cpts, n_cpts, status, shift, scale)."""
    scores = seg.cpt_scores_t_test_batch(raw, sig_lens, w)
    cpts, status = sel.greedy_cpts_device(
        scores, sig_lens - 2 * w, num_cpts, min_base_obs, w, max_cpts)

    # stall removal (reference: tombo/tombo_stats.py:1576-1597): drop
    # changepoints strictly inside any interval, then sort the kept ones
    # ahead of a sentinel
    idx = torch.arange(max_cpts, device=raw.device)[None, :]
    in_any = ((cpts[:, None, :] > stall_starts[:, :, None]) &
              (cpts[:, None, :] < stall_ends[:, :, None])).any(1)
    valid = (idx < num_cpts[:, None]) & ~in_any
    cpts = torch.sort(torch.where(valid, cpts, 2 ** 30), dim=1).values
    n_cpts = valid.sum(1)
    cpts = torch.where(idx < n_cpts[:, None], cpts, 0)

    # event-based scale values (reference: tombo/tombo_stats.py:217-233
    # ``get_scale_values_from_events``); the event cap is taken in
    # float32, as the JAX package takes it
    k_sc = torch.clamp(
        (n_cpts.to(torch.float32) *
         config.RNA_SCALE_MAX_FRAC_EVENTS).to(torch.int64),
        max=config.RNA_SCALE_NUM_EVENTS)
    em_raw = nrm.compute_base_means_batch(raw, cpts, n_cpts - 1)
    n_means = torch.clamp(k_sc - 1, min=1)
    shift = nrm.masked_median(em_raw, n_means)
    scale = nrm.masked_mad(em_raw, shift, n_means)
    return cpts, n_cpts, status, shift, scale


def _stage_a_rna(raw, sig_lens, has_sv, sv_shift, sv_scale, sv_lower,
                 sv_upper, num_cpts, stall_starts, stall_ends, rm_start,
                 rs_start, outlier_thresh, w: int, min_base_obs: int,
                 max_cpts: int, sp: StartDpParams):
    """RNA stages 1-3: changepoints and event-based scale values
    (:func:`rna_event_scale`) -> normalize -> event means -> start DP +
    validity score (reference flow: tombo/resquiggle.py:1057-1120, RNA
    branches).  Returns the compacted changepoints with their per-read
    counts."""
    cpts, n_cpts, status, shift, scale = rna_event_scale(
        raw, sig_lens, num_cpts, stall_starts, stall_ends, w, min_base_obs,
        max_cpts)
    ot = nrm.POS_LARGE if outlier_thresh is None else outlier_thresh
    lower = torch.full_like(shift, -ot)
    upper = torch.full_like(shift, ot)
    shift = torch.where(has_sv, sv_shift, shift)
    scale = torch.where(has_sv, sv_scale, scale)
    lower = torch.where(has_sv, sv_lower, lower)
    upper = torch.where(has_sv, sv_upper, upper)
    norm = nrm.normalize_with_scale_batch(raw, sig_lens, shift, scale, lower,
                                          upper)
    em = nrm.compute_base_means_batch(norm, cpts, n_cpts - 1)
    need = sp.num_bases + sp.num_events
    start_segs, start_score = _start_dp_with_score(
        _pad_cols(em, need)[:, :need], rm_start, rs_start, sp)
    return (norm, em, cpts, n_cpts, status, shift, scale, lower, upper,
            start_segs, start_score)


def _stage_a_rescale(raw, sig_lens, sv_shift, sv_scale, sv_lower, sv_upper,
                     cpts, n_cpts, rm_start, rs_start, sp: StartDpParams):
    """Rescale-pass stage A: the changepoints of the first pass are kept
    (the scores scale by a positive constant under the affine
    re-normalization), so only normalization, event means and start
    discovery are redone."""
    norm = nrm.normalize_with_scale_batch(raw, sig_lens, sv_shift, sv_scale,
                                          sv_lower, sv_upper)
    em = nrm.compute_base_means_batch(norm, cpts, n_cpts - 1)
    need = sp.num_bases + sp.num_events
    start_segs, start_score = _start_dp_with_score(
        _pad_cols(em, need)[:, :need], rm_start, rs_start, sp)
    return norm, em, start_segs, start_score


def _gather_clip_rows(em, rows, clips, out_width: int):
    """em[rows] left-clipped per read by ``clips``, zero-padded to
    ``out_width`` (``event_means[events_start_clip:]``)."""
    em_pad = _pad_cols(em[rows], em.shape[1] + out_width)
    st = clips.clamp(0, em.shape[1])
    idx = st[:, None] + torch.arange(out_width, device=em.device)[None, :]
    return em_pad.gather(1, idx)


def _stage_finalize(cpts, rows, clips, segs_dp, seq_lens, ev_lens,
                    n_rows: int):
    """Traceback trim + raw coordinates + deletion flag (reference:
    tombo/resquiggle.py:754-764 trim, then pipeline/resquiggle.py
    ``get_rel_raw_coords``; integer-exact).  Only leading (<0) and
    trailing (>events_len) positions can be out of range, so a clip is
    the trim.  Returns (seq_segs, rsrtr, has_del, seg_d8, seg_over): the
    table's wire (the JAX package's) is its (B, L) uint8 differences,
    exact for every read whose ``seg_over`` is False (no segment of its
    own bases longer than 255 samples); the host rebuilds a table by an
    integer cumsum from 0 and copies a ``seg_over`` row in full from
    ``seq_segs``, which stays on the device."""
    L = n_rows
    tb = torch.minimum(segs_dp.long().clamp(min=0), ev_lens[:, None])
    cpts_rows = cpts[rows]
    gather_idx = (clips[:, None] + tb).clamp(0, cpts_rows.shape[1] - 1)
    seq_segs_abs = cpts_rows.gather(1, gather_idx)
    rsrtr = seq_segs_abs[:, 0]
    seq_segs = seq_segs_abs - rsrtr[:, None]
    d = seq_segs[:, 1:] - seq_segs[:, :-1]
    base_valid = torch.arange(L, device=cpts.device)[None, :] < \
        seq_lens[:, None]
    has_del = ((d == 0) & base_valid).any(1)
    seg_over = ((d > 255) & base_valid).any(1)
    return seq_segs, rsrtr, has_del, d.to(torch.uint8), seg_over


def _stage_fit(norm, rows, rsrtr, seq_segs, rm, rs, seq_lens, samp, tri,
               shift_thresh: float, scale_thresh: float,
               do_fit: bool = True):
    """Event means over the final segment table -> exact Theil-Sen (count
    kernel) -> scale/shift corrections, changed mask, signal-match score
    and the rescaled event means (reference: tombo/resquiggle.py:1122-1197,
    tombo/tombo_stats.py:2327-2339).  Without ``do_fit`` (skip sequence
    rescaling) the corrections are the identity and nothing changes.  The
    score's sum runs in an order fixed by L (``row_sums``), so a read
    scores the same in a shard as in the whole batch."""
    L = seq_segs.shape[1] - 1
    # the prefix sums start at each read's mapped start, as the host
    # lane's ``new_means`` over the mapped slice does: segments of equal
    # integer sums then give bitwise-equal means, and the pair slopes
    # between them the exact ``max_slope``
    S = norm.shape[1]
    em = nrm.compute_base_means_batch(_slice_rows(norm, rows, rsrtr, S),
                                      seq_segs.clamp(0, S), seq_lens)
    if samp is not None:
        gi = samp.clamp(0, L - 1)
        ev, mod = em.gather(1, gi), rm.gather(1, gi)
        n_pts = torch.clamp(seq_lens, max=samp.shape[1])
    else:
        ev, mod, n_pts = em, rm, seq_lens
    if do_fit:
        slope, inter = rescale.theil_sen_device(ev, mod, n_pts, tri=tri)
        fit_ok = slope != 0
        safe = torch.where(fit_ok, slope, 1.0)
        scale_corr = 1.0 / safe
        shift_corr = -inter / safe
        em_s = (em - shift_corr[:, None]) / scale_corr[:, None]
        changed = ((torch.abs(shift_corr) > shift_thresh) |
                   (torch.abs(scale_corr - 1.0) > scale_thresh))
    else:
        shift_corr = torch.zeros_like(em[:, 0])
        scale_corr = torch.ones_like(em[:, 0])
        fit_ok = torch.ones_like(shift_corr, dtype=torch.bool)
        changed = torch.zeros_like(fit_ok)
        em_s = em
    valid = torch.arange(L, device=em.device)[None, :] < seq_lens[:, None]
    score = (row_sums(torch.where(valid, torch.abs((em_s - rm) / rs), 0.0)) /
             torch.clamp(seq_lens, min=1))
    return shift_corr, scale_corr, score, changed, fit_ok, em_s


def _slice_rows(mat, rows, starts, width: int):
    """mat[rows[i], starts[i] : starts[i] + width], zero past the matrix
    edge (a ``lax.dynamic_slice`` of the zero-padded row: the start
    clamps so the window fits)."""
    S = mat.shape[1]
    padded = _pad_cols(mat, S + width)
    st = starts.clamp(0, S)
    idx = st[:, None] + torch.arange(width, device=mat.device)[None, :]
    return padded[rows].gather(1, idx)


def _stage_delfix_fit(norm, rows, rsrtr, seq_segs, rm, rs, seq_lens, win_i,
                      win_bs, win_nb, win_t, win_sig_rel, max_half_z, samp,
                      tri, nb_pad: int, t_pad: int, min_obs: int,
                      winsorize: bool, shift_thresh: float,
                      scale_thresh: float, do_fit: bool = True):
    """Batched raw-signal deletion fix, then the fit on the FIXED table
    (the reference's order, tombo/resquiggle.py:1168-1195)."""
    rows_w = rows[win_i]
    sig_abs = rsrtr[win_i] + win_sig_rel
    sig_w = _slice_rows(norm, rows_w, sig_abs, t_pad)
    mu_w = _slice_rows(rm, win_i, win_bs, nb_pad)
    sd_raw = _slice_rows(rs, win_i, win_bs, nb_pad)
    jb = torch.arange(nb_pad, device=norm.device)[None, :]
    sd_w = torch.where(jb < win_nb[:, None], sd_raw, 1.0)
    bounds, fail = delfix.raw_windows_dp(
        sig_w, mu_w, sd_w, win_t, win_nb, max_half_z, min_obs=min_obs,
        nb_pad=nb_pad, winsorize=winsorize)

    # scatter boundaries back: resolved[ws+1+j] = bound_j + segs[ws]
    seg_base = seq_segs[win_i, win_bs]
    jcols = torch.arange(nb_pad - 1, device=norm.device)[None, :]
    valid = jcols < (win_nb[:, None] - 1)
    cols = win_bs[:, None] + 1 + jcols
    vals = bounds.long() + seg_base[:, None]
    seq_segs_fx = seq_segs.clone()
    wi = win_i[:, None].expand_as(cols)
    seq_segs_fx[wi[valid], cols[valid]] = vals[valid].to(seq_segs.dtype)

    fit = _stage_fit(norm, rows, rsrtr, seq_segs_fx, rm, rs, seq_lens, samp,
                     tri, shift_thresh, scale_thresh, do_fit)
    return (bounds, fail) + fit


def _build_masked_plans_batch(live, p, mask_bases=config.MASK_BASES):
    """Start-masked static band plan for every read in a few matrix ops
    (bit-identical to the per-read numpy ``np.linspace`` plan, reference:
    tombo/resquiggle.py:607-677).  Returns (pstarts (B, P_max), pvalid
    (B,), pend (B, P_max), start_rows (B,), P_max)."""
    B = len(live)
    half_bw = p.bandwidth // 2
    n_ev = np.array([s.n_ev - s.events_start_clip for s in live], np.int64)
    mso = np.array([s.mapped_start_offset for s in live], np.int64)
    epb = np.array([s.events_per_base for s in live], np.float64)
    bes_pos = np.where(half_bw <= mso, 0, mso - half_bw)

    T = np.maximum(np.maximum(half_bw, mask_bases),
                   ((half_bw + 1) / epb).astype(np.int64)) + 1
    T_max = int(T.max())
    r = np.arange(T_max, dtype=np.float64)[None, :]
    # np.linspace(start, start + T*epb, T): y = r*step + start, y[-1]=stop
    delta = T * epb
    step = delta / (T - 1)
    y = r * step[:, None] + bes_pos[:, None].astype(np.float64)
    rows = np.arange(B)
    y[rows, T - 1] = bes_pos + delta
    bes = y.astype(np.int64)

    in_T = np.arange(T_max)[None, :] < T[:, None]
    first_hit = np.argmax((bes >= mso[:, None]) & in_T, axis=1)
    P = np.maximum(mask_bases, first_hit + 2)
    P_max = _round_up(int(P.max()), 64)

    # mask_start_pos = linspace(mso+1, bes[mask_bases-1]+bw, mask_bases)
    m_start = (mso + 1).astype(np.float64)
    m_stop = (bes[:, mask_bases - 1] + p.bandwidth).astype(np.float64)
    m_step = (m_stop - m_start) / (mask_bases - 1)
    rm_ = np.arange(mask_bases, dtype=np.float64)[None, :]
    msp = rm_ * m_step[:, None] + m_start[:, None]
    msp[:, -1] = m_stop
    msp = msp.astype(np.int64)

    if P_max > bes.shape[1]:
        bes = np.pad(bes, ((0, 0), (0, P_max - bes.shape[1])))
    pstarts = bes[:, :P_max].copy()
    pad_col = np.arange(P_max)[None, :] >= P[:, None]
    np.copyto(pstarts, bes[rows, P - 1][:, None], where=pad_col)
    pend = np.broadcast_to(n_ev[:, None], (B, P_max)).copy()
    pend[:, :mask_bases] = np.minimum(msp, n_ev[:, None])
    np.copyto(pend, n_ev[:, None], where=pad_col)
    return pstarts, mso, pend, P, P_max


_TS_SAMPLE_CACHE: dict = {}


def _ts_sample_idx(n: int, max_n: int) -> np.ndarray:
    """Deterministic Theil-Sen subsample (rng(0), reference:
    tombo/tombo_stats.py:398-401)."""
    key = (n, max_n)
    out = _TS_SAMPLE_CACHE.get(key)
    if out is None:
        out = np.random.default_rng(0).choice(n, max_n, replace=False)
        _TS_SAMPLE_CACHE[key] = out
    return out


def _theil_sen_device_blocks(ev, mod, n_pts, device,
                             profile: Optional[StageProfile] = None):
    """Theil-Sen fits of (B, N) host points on ``device`` in blocks of
    ``_TS_BLOCK`` reads at float32 (the JAX package's
    ``_theil_sen_device_blocks``): the reads padded to a multiple of the
    block with empty rows, every block queued (``rescale.theil_sen_device``,
    the count kernel on a card) before one copy of every slope and
    intercept comes down; the intercepts' residuals are rounded once, as
    the JAX lane's compiled fit rounds them.  Returns float64 (slopes,
    intercepts) of the B reads.  A ``profile`` counts the bytes each way
    and the copy down; as in the JAX lane, no key times the blocks."""
    B, N = ev.shape
    Bp = _round_up(B, _TS_BLOCK)
    evp = np.zeros((Bp, N), np.float32)
    modp = np.zeros((Bp, N), np.float32)
    npts = np.zeros(Bp, np.int32)
    evp[:B], modp[:B], npts[:B] = ev, mod, n_pts
    if profile is not None:
        profile.add_bytes("upload", evp.nbytes + modp.nbytes + npts.nbytes)
    ev_j, mod_j = (torch.as_tensor(a).to(device) for a in (evp, modp))
    npts_j = torch.as_tensor(npts).to(device).long()
    tri = rescale.tri_indices(N, device)
    fits = [torch.stack(rescale.theil_sen_device(
        ev_j[b0:b0 + _TS_BLOCK], mod_j[b0:b0 + _TS_BLOCK],
        npts_j[b0:b0 + _TS_BLOCK], tri=tri, fused=True))
        for b0 in range(0, Bp, _TS_BLOCK)]
    out = torch.cat(fits, 1).cpu().numpy()
    if profile is not None:
        profile.count("fetches")
        profile.add_bytes("fetch", out.nbytes)
    out = out.astype(np.float64)
    return out[0, :B], out[1, :B]


def _dp_failed(s: _ReadState, band_err, bound_err) -> bool:
    """Set the read's error where the adaptive DP flagged it; True if it
    did."""
    if band_err:
        s.error = ("Adaptive signal to sequence alignment extended beyond "
                   "raw signal")
    elif bound_err:
        s.error = "Read event to sequence alignment extends beyond bandwidth"
    return bool(band_err or bound_err)


# --------------------------------------------------------------- driver
class BatchedResquiggler:
    """Drive batches of mapped DNA or RNA reads (raw signal adjusted by
    ``adjust_map_res``) through the device stages.

    ``device=None`` means the CUDA card; ``device="cpu"`` runs every
    kernel's plain PyTorch version.  ``mesh`` (a list of devices, or
    ``parallel.mesh.make_mesh()``) shards every length group's reads over
    its devices; results land on ``mesh[0]`` and equal the 1-device
    lane's read for read.  ``const_scale`` is one scale for every read
    (per-read median shift; reference: tombo/tombo_stats.py:505-509);
    ``skip_seq_scaling`` skips the sequence-fitted rescaling (reference:
    tombo/resquiggle.py:1177).  ``profile``: a :class:`StageProfile`
    that every batch adds its stages to (None: nothing is timed).
    ``lanes``: the finalize lanes (:class:`FinalizeLanes`)."""

    def __init__(self, std_ref, rsqgl_params: ResquiggleParams,
                 seq_samp_type: SeqSampleType,
                 outlier_thresh: Optional[float] = config.OUTLIER_THRESH,
                 dtype=None, device: DeviceLike = None, mesh=None,
                 const_scale=None, skip_seq_scaling: bool = False,
                 profile: Optional[StageProfile] = None,
                 lanes: FinalizeLanes = FinalizeLanes()):
        if seq_samp_type.name not in (config.DNA_SAMP_TYPE,
                                      config.RNA_SAMP_TYPE):
            raise ValueError("unknown sample type %r" % seq_samp_type.name)
        if mesh is None:
            self.mesh = resolve_mesh([resolve_device(device)])
        else:
            self.mesh = resolve_mesh(mesh)
            if device is not None and \
                    resolve_device(device).type != self.mesh[0].type:
                raise ValueError("device %s is not of the mesh's type %s" % (
                    device, self.mesh[0].type))
        self.device = self.mesh[0]
        self.dtype = resolve_dtype(dtype, self.device)
        self.np_dtype = (np.float64 if self.dtype == torch.float64
                         else np.float32)
        self.std_ref = std_ref
        self.params = rsqgl_params
        self.seq_samp_type = seq_samp_type
        self.outlier_thresh = outlier_thresh
        self.const_scale = const_scale
        self.skip_seq_scaling = skip_seq_scaling
        self.save_params = rsqgl_params.replace(
            bandwidth=config.load_resquiggle_parameters(
                seq_samp_type.name, use_save_bandwidth=True).bandwidth)
        self.profile = profile
        self.lanes = lanes
        # the stage whose span is open (_Span), which names its fetches
        self._stage = None
        # the device k-mer table of each mesh device (_levels_tab)
        self._level_tabs = {}
        # reads seen by the device finalize, and those with a deletion:
        # the gate of the fit on the adaptive dispatch
        self._del_seen = 0
        self._del_total = 0

    # ------------------------------------------------------- finalize lanes
    def _fit_mostly_wasted(self) -> bool:
        """True once the reads seen say most of a fit on the adaptive
        dispatch would be thrown away (a read with a deletion is fit again
        on a host lane after its deletion fix); False until 64 reads have
        been seen, so the first batches run the fit."""
        return self._del_total >= 64 and self._del_seen * 2 > self._del_total

    def _note_del_rate(self, has_del: np.ndarray):
        """Count a group's reads and those with a deletion; past 2^16
        reads both counts halve, so the rate follows recent batches."""
        self._del_total += int(has_del.shape[0])
        self._del_seen += int(np.count_nonzero(has_del))
        if self._del_total > 1 << 16:
            self._del_total //= 2
            self._del_seen //= 2

    def _fit_lanes(self) -> Tuple[bool, bool]:
        """(the deletion fix and fit on the device, the fit on the adaptive
        dispatch) for the next group: the JAX package's ``use_dev_delfix``
        and ``use_dev_fit``.  The float64 lane keeps its own: reads
        without a deletion fit on the device, the others on the host."""
        lanes = self.lanes
        if self.dtype == torch.float64:
            return True, False
        delfix = lanes.device_delfix and lanes.device_fit is not False
        fit = (not delfix and lanes.device_fit is not False and
               (lanes.device_fit or not self._fit_mostly_wasted()))
        return delfix, fit

    # ------------------------------------------------------------ helpers
    def _up(self, arr, device=None) -> torch.Tensor:
        """A host array on ``device`` (default the lane's) as it is, its
        bytes counted."""
        arr = np.asarray(arr)
        if self.profile is not None:
            self.profile.add_bytes("upload", arr.nbytes)
        return torch.as_tensor(arr).to(device or self.device)

    def _t(self, arr, float_=False, device=None) -> torch.Tensor:
        """A host array on ``device``: floats at the lane's dtype, bools
        as they are, integers sent as int32 where they fit (the JAX
        lane's ``_up`` sends index and count vectors at their own width)
        and widened to int64 on the device, where the stages gather and
        compute with them."""
        arr = np.asarray(arr)
        if float_:
            return self._up(arr.astype(self.np_dtype), device)
        if arr.dtype == np.bool_:
            return self._up(arr, device)
        fits = arr.size == 0 or (arr.min() >= -2 ** 31 and
                                 arr.max() < 2 ** 31)
        return self._up(arr.astype(np.int32 if fits else np.int64),
                        device).long()

    def _span(self, name: str):
        """A span named ``name`` (:class:`_Span`) around the block: a
        range of a running torch.profiler trace and a span of the profile.
        With neither, the shared null context, and nothing else runs."""
        if self.profile is None and not torch.autograd._profiler_enabled():
            return _NULL_SPAN
        return _Span(self, name)

    def _count(self, name: str, n: int = 1):
        """Add ``n`` to the profile's counter ``name``, if there is a
        profile."""
        if self.profile is not None:
            self.profile.count(name, n)

    def _levels_tab(self, dev):
        """The k-mer table (means, sds) on ``dev`` at the lane's dtype,
        with the sentinel row (1.0, 1.0) appended (the JAX package's
        ``_levels_tab``); sent once a device."""
        tab = self._level_tabs.get(dev)
        if tab is None:
            tab = self._level_tabs[dev] = tuple(
                self._up(np.append(a, 1.0).astype(self.np_dtype), dev)
                for a in (self.std_ref.means, self.std_ref.sds))
        return tab

    def _codes_rows(self, live, width: int, clip: bool, dev):
        """(B, width) k-mer codes of ``live`` on ``dev``, sentinel past
        each read's codes (the JAX package's ``_codes_rows``): derived on
        the device from the reads' packed bases and code counts, or,
        where a read has no packed bases, sent as dense int16 code rows;
        ``clip`` as in :meth:`_levels`."""
        n_sent = self.std_ref.means.shape[0]
        k = self.std_ref.kmer_width
        B = len(live)
        if all(s.packed_bases is not None for s in live):
            PB = _round_up(width + k - 1, 4) // 4
            packed = np.zeros((B, PB), np.uint8)
            n_codes = np.zeros(B, np.int32)
            for i, s in enumerate(live):
                m = min(PB, s.packed_bases.shape[0])
                packed[i, :m] = s.packed_bases[:m]
                n_codes[i] = s.ref_codes.shape[0]
            return _codes_from_packed(self._up(packed, dev),
                                      self._up(n_codes, dev), width, k,
                                      n_sent, clip)
        codes = np.full((B, width), n_sent,
                        np.int16 if n_sent < 2 ** 15 else np.int32)
        for i, s in enumerate(live):
            c = s.ref_codes
            if clip:
                if c.shape[0] >= width:
                    codes[i] = c[:width]
            else:
                codes[i, :c.shape[0]] = c[:width]
        return self._up(codes, dev)

    def _levels(self, live, width: int, clip: bool = False, device=None):
        """(B, width) expected means and sds on ``device`` at the lane's
        dtype, padded with 1.0, looked up on the device from the k-mer
        codes (:meth:`_codes_rows`); ``clip`` crops each read to
        ``width`` (reads shorter than ``width`` become all-padding
        rows)."""
        dev = device or self.device
        mt, st = self._levels_tab(dev)
        return _levels_from_codes(mt, st,
                                  self._codes_rows(live, width, clip, dev))

    def _start_params(self, num_events: int) -> StartDpParams:
        p = self.params
        return StartDpParams(
            z_shift=p.z_shift, skip_pen=p.skip_pen, stay_pen=p.stay_pen,
            max_half_z_score=p.max_half_z_score or -1.0,
            num_bases=p.start_n_bases, num_events=num_events)

    def _np(self, *ts):
        """Device to host copies (the JAX package's ``_fetch``): the wait
        a ``<stage>_fetch`` span of the current stage, each copy one of
        the profile's ``fetches`` and its bytes ``fetch``."""
        with self._span((self._stage or "other") + "_fetch"):
            out = [t.cpu().numpy() for t in ts]
        if self.profile is not None:
            self.profile.count("fetches", len(out))
            self.profile.add_bytes("fetch", sum(a.nbytes for a in out))
        return out

    def _np_scalars(self, reads, *ts) -> list:
        """Per-read vectors of ``reads`` to the host: on the float32 lane,
        while every raw signal is shorter than 2^24 samples, one stacked
        (k, B) float32 copy (the JAX package's ``_fetch_packed_f32`` under
        its ``pack_ok``: exact for float32 values and for integers below
        2^24: statuses, flags, event and sample positions); else one copy
        a vector, each at its own dtype."""
        if (self.dtype != torch.float32 or
                max(s.raw.shape[0] for s in reads) >= 2 ** 24):
            return self._np(*ts)
        out, = self._np(torch.stack([t.to(torch.float32) for t in ts]))
        return list(out)

    def _gather_resident(self, refs, dev, width: int) -> torch.Tensor:
        """(B, width) matrix on ``dev`` of the rows ``refs`` ((device
        matrix, row) a read), each cropped or zero-padded to ``width``:
        one gather on each source matrix's device, the rows then moved
        to ``dev`` device to device (a no-op on one device).  Every
        source row is zero past its read's values, so this is the matrix
        the host would have built and sent."""
        by_src = {}
        for i, (src, row) in enumerate(refs):
            by_src.setdefault(id(src), (src, [], []))
            by_src[id(src)][1].append(i)
            by_src[id(src)][2].append(row)
        parts = [(pos, _gather_rows_pad(
            src, self._t(rows, device=src.device), width).to(dev))
            for src, pos, rows in by_src.values()]
        if len(parts) == 1:
            return parts[0][1]
        out = torch.zeros((len(refs), width), dtype=parts[0][1].dtype,
                          device=dev)
        for pos, part in parts:
            out[self._t(pos, device=dev)] = part
        return out

    def _fetch_cpts(self, reads):
        """Each read's changepoints on the host (``s.cpts``), where it
        has none yet: one gathered copy from each device matrix that
        holds some (the JAX package's ``_cpts_of``), counted in the
        profile's ``cpts`` rows."""
        by_src = {}
        for s in reads:
            if s.cpts is None:
                by_src.setdefault(id(s.cpts_dev[0]), []).append(s)
        for group in by_src.values():
            src = group[0].cpts_dev[0]
            rows, = self._np(src[self._t([s.cpts_dev[1] for s in group],
                                         device=src.device)])
            for s, row in zip(group, rows):
                s.cpts = row[:s.cpts_dev[2]].astype(np.int64)
            if self.profile is not None:
                self.profile.add_rows("cpts", len(group))

    def _seg_tables(self, d8, over, seq_segs_j) -> np.ndarray:
        """(B, L + 1) int64 segment tables from their uint8 wire: an
        integer cumsum of ``d8`` from 0, and the rows of the ``over``
        reads copied in full from ``seq_segs_j`` in one gathered copy,
        counted in the profile's ``seg_over`` rows."""
        out = np.zeros((d8.shape[0], d8.shape[1] + 1), np.int64)
        np.cumsum(d8, axis=1, dtype=np.int64, out=out[:, 1:])
        rows = np.flatnonzero(over)
        if rows.size:
            out[rows], = self._np(seq_segs_j[self._t(
                rows, device=seq_segs_j.device)])
            if self.profile is not None:
                self.profile.add_rows("seg_over", rows.size)
        return out

    def _shards(self, reads):
        """``reads`` by mesh shard: (shard, its reads in order) for every
        shard that holds one."""
        by = [[] for _ in self.mesh]
        for s in reads:
            by[s.shard].append(s)
        return [(d, r) for d, r in enumerate(by) if r]

    # ------------------------------------------------------ stage drivers
    def _segment_batch(self, states: List[_ReadState]):
        """Stages 1-3 (+ start DP): normalize, select, event means.  The
        live reads split into contiguous shards over the mesh, each run on
        its device at the group's shape buckets (signal and changepoint
        widths), so a shard runs the shapes of the unsharded group.
        Returns one context per mesh device (None for an empty shard)."""
        live = [s for s in states if s.error is None]
        if not live:
            return None
        k = 0
        for d, n in enumerate(shard_sizes(len(live), self.mesh)):
            for i, s in enumerate(live[k:k + n]):
                s.shard, s.dev_row = d, i
            k += n
        sig_w = _sig_bucket(max(s.raw.shape[0] for s in live))
        # rescale passes keep the first pass's changepoints on the float32
        # lane; the float64 parity mode re-selects, as the JAX package's
        # float64 lane does (selection is invariant under the affine
        # re-normalization only in exact arithmetic)
        rescale_pass = self.dtype != torch.float64 and all(
            s.map_res.scale_values is not None and s.cpts_dev is not None
            for s in live)
        cpts_w = _pow2_bucket(max(
            s.cpts_dev[2] if rescale_pass else s.num_events
            for s in live), 256)
        # stall intervals per read, padded to a multiple of 8 for the group
        n_stalls = _round_up(max([1] + [
            len(s.map_res.stall_ints) for s in live
            if s.map_res.stall_ints is not None]), 8)
        ctx = [None] * len(self.mesh)
        for d, reads in self._shards(live):
            ctx[d] = self._segment_shard(reads, self.mesh[d], sig_w, cpts_w,
                                         rescale_pass, n_stalls)
        return ctx

    def _upload_raw(self, live, dev, sig_w: int):
        """The shard's (B, sig_w) raw matrix on ``dev`` at the lane's
        dtype, zero past each read's end, and its (B,) lengths.  When
        every raw signal of the shard is integral (``raw_i16``, looked at
        here once a read) they go up as int8 deltas and an escape list
        (the JAX package's wire), decoded bit for bit to the dense matrix,
        which goes up otherwise."""
        B = len(live)
        sig_lens = np.array([s.raw.shape[0] for s in live], np.int64)
        with self._span("seg_pack"):
            wire = all(s.raw_i16 is not None for s in live)
            if wire:
                host = _pack_delta_wire([s.raw_i16 for s in live],
                                        sig_lens, sig_w)
            else:
                raw_pad = np.zeros((B, sig_w), self.np_dtype)
                for i, s in enumerate(live):
                    raw_pad[i, :s.raw.shape[0]] = s.raw
                host = (raw_pad,)
        with self._span("seg_upload"):
            lens_j = self._t(sig_lens, device=dev)
            up = [torch.as_tensor(a).to(dev) for a in host]
            if self.profile is not None:
                self.profile.add_bytes("upload", sum(a.nbytes for a in host))
            raw_j = (_unflatten_delta_rows(*up, lens_j, sig_w) if wire
                     else up[0])
        return raw_j.to(self.dtype), lens_j

    def _segment_shard(self, live, dev, sig_w: int, cpts_w: int,
                       rescale_pass: bool, n_stalls: int):
        p = self.params
        if all(s.raw_dev is not None for s in live):
            # a rescale pass: the raw rows are still on the device
            with self._span("seg_gather"):
                raw_j = self._gather_resident([s.raw_dev for s in live],
                                              dev, sig_w)
                lens_j = self._t([s.raw.shape[0] for s in live], device=dev)
        else:
            raw_j, lens_j = self._upload_raw(live, dev, sig_w)
        with self._span("seg_levels"):
            for i, s in enumerate(live):
                s.raw_dev = (raw_j, i)
            rm_sj, rs_sj = self._levels(live, p.start_n_bases, clip=True,
                                        device=dev)
        sp = self._start_params(p.start_bw)
        if rescale_pass:
            return self._segment_rescale(live, dev, raw_j, lens_j, rm_sj,
                                         rs_sj, sp, cpts_w)

        if p.use_t_test_seg:
            return self._segment_rna(live, dev, raw_j, lens_j, rm_sj, rs_sj,
                                     sp, cpts_w, n_stalls)
        with self._span("stage_a_dna"):
            num_cpts = np.array([s.num_events for s in live], np.int64)
            has_sv, sv_shift, sv_scale, sv_lower, sv_upper = self._given_sv(
                live, -nrm.POS_LARGE, nrm.POS_LARGE)
            t = lambda a, f=False: self._t(a, f, dev)
            (norm_j, em_j, cpts_j, status_j, shift, scale, lower, upper,
             start_segs_j, start_score_j) = _stage_a_dna(
                raw_j, lens_j, t(has_sv), t(sv_shift, True),
                t(sv_scale, True), t(sv_lower, True), t(sv_upper, True),
                t(num_cpts), rm_sj, rs_sj,
                (None if self.outlier_thresh is None
                 else float(self.outlier_thresh)), p.running_stat_width,
                p.min_obs_per_base, cpts_w, sp)
        (status, shift, scale, lower, upper, s0, sN,
         score) = self._np_scalars(live, status_j, shift, scale, lower,
                                   upper, start_segs_j[:, 0],
                                   start_segs_j[:, -1], start_score_j)
        with self._span("seg_unpack"):
            for i, s in enumerate(live):
                if status[i] != 0:
                    s.error = "Fewer changepoints found than requested"
                    continue
                s.cpts, s.cpts_dev = None, (cpts_j, i, s.num_events)
                s.n_ev = s.num_events - 1
                s.event_means = None
                prev_sv = s.map_res.scale_values
                s.scale_values = ScaleValues(
                    float(shift[i]), float(scale[i]), float(lower[i]),
                    float(upper[i]),
                    prev_sv.outlier_thresh if prev_sv is not None
                    else self.outlier_thresh)
        return {"em": em_j, "norm": norm_j, "cpts": cpts_j,
                "start": (s0.astype(np.int64), sN.astype(np.int64),
                          score.astype(np.float64))}

    @staticmethod
    def _given_sv(live, lower_fill, upper_fill):
        """(has_sv, shift, scale, lower, upper) of the reads' given scale
        values: 0, 1 and the fills where a read has none or no limit."""
        B = len(live)
        has_sv = np.array([s.map_res.scale_values is not None
                           for s in live])
        shift, scale = np.zeros(B), np.ones(B)
        lower, upper = np.full(B, lower_fill), np.full(B, upper_fill)
        for i, s in enumerate(live):
            sv = s.map_res.scale_values
            if sv is not None:
                shift[i], scale[i] = sv.shift, sv.scale
                if sv.lower_lim is not None:
                    lower[i] = sv.lower_lim
                if sv.upper_lim is not None:
                    upper[i] = sv.upper_lim
        return has_sv, shift, scale, lower, upper

    def _segment_rna(self, live, dev, raw_j, lens_j, rm_sj, rs_sj, sp,
                     cpts_w: int, n_stalls: int):
        """RNA stage A on one shard (the JAX package's ``_stage_a_rna``
        branch): stall intervals and given scale values in, compacted
        changepoints and event-based scale values out.  Reads that stall
        removal leaves too few events for start discovery go to the
        static band."""
        p = self.params
        B = len(live)
        with self._span("stage_a_rna"):
            num_cpts = np.array([s.num_events for s in live], np.int64)
            stall_s = np.zeros((B, n_stalls), np.int64)
            stall_e = np.zeros((B, n_stalls), np.int64)
            for i, s in enumerate(live):
                for k, (a, b) in enumerate(s.map_res.stall_ints or []):
                    stall_s[i, k], stall_e[i, k] = a, b
            has_sv, sv_shift, sv_scale, sv_lower, sv_upper = self._given_sv(
                live, np.nan, np.nan)
            t = lambda a, f=False: self._t(a, f, dev)
            (norm_j, em_j, cpts_j, n_cpts_j, status_j, shift, scale, lower,
             upper, start_segs_j, start_score_j) = _stage_a_rna(
                raw_j, lens_j, t(has_sv), t(sv_shift, True),
                t(sv_scale, True), t(sv_lower, True), t(sv_upper, True),
                t(num_cpts), t(stall_s), t(stall_e), rm_sj, rs_sj,
                (None if self.outlier_thresh is None
                 else float(self.outlier_thresh)), p.running_stat_width,
                p.min_obs_per_base, cpts_w, sp)
        (n_cpts, status, shift, scale, lower, upper, s0, sN,
         score) = self._np_scalars(live, n_cpts_j, status_j, shift, scale,
                                   lower, upper, start_segs_j[:, 0],
                                   start_segs_j[:, -1], start_score_j)
        lim = lambda v: None if np.isnan(v) else float(v)
        with self._span("seg_unpack"):
            for i, s in enumerate(live):
                if status[i] != 0:
                    s.error = "Fewer changepoints found than requested"
                    continue
                s.cpts, s.cpts_dev = None, (cpts_j, i, int(n_cpts[i]))
                s.n_ev = int(n_cpts[i]) - 1
                s.event_means = None
                s.scale_values = ScaleValues(
                    float(shift[i]), float(scale[i]), lim(lower[i]),
                    lim(upper[i]), None)
                if s.n_ev < p.start_bw + p.start_n_bases:
                    s.use_static = True
        return {"em": em_j, "norm": norm_j, "cpts": cpts_j,
                "start": (s0.astype(np.int64), sN.astype(np.int64),
                          score.astype(np.float64))}

    def _segment_rescale(self, live, dev, raw_j, lens_j, rm_sj, rs_sj, sp,
                         cpts_w: int):
        """Rescale-pass segmentation reusing first-pass changepoints,
        gathered where they stay on the device (the JAX package's
        ``_segment_rescale`` with ``_gather_rows_pad``)."""
        with self._span("stage_a_rescale"):
            n_cpts = np.array([s.cpts_dev[2] for s in live], np.int64)
            _, sv_shift, sv_scale, sv_lower, sv_upper = self._given_sv(
                live, np.nan, np.nan)
            t = lambda a, f=False: self._t(a, f, dev)
            cpts_j = self._gather_resident([s.cpts_dev[:2] for s in live],
                                           dev, cpts_w)
            norm_j, em_j, start_segs_j, start_score_j = _stage_a_rescale(
                raw_j, lens_j, t(sv_shift, True), t(sv_scale, True),
                t(sv_lower, True), t(sv_upper, True), cpts_j, t(n_cpts),
                rm_sj, rs_sj, sp)
        s0, sN, score = self._np_scalars(live, start_segs_j[:, 0],
                                         start_segs_j[:, -1], start_score_j)
        with self._span("seg_unpack"):
            for i, s in enumerate(live):
                s.cpts_dev = (cpts_j, i, int(n_cpts[i]))
                s.n_ev = int(n_cpts[i]) - 1
                s.event_means = None
                s.scale_values = s.map_res.scale_values.replace()
        return {"em": em_j, "norm": norm_j, "cpts": cpts_j,
                "start": (s0.astype(np.int64), sN.astype(np.int64),
                          score.astype(np.float64))}

    def _plan_reads(self, states: List[_ReadState]):
        """Expected levels + static-band routing.  The k-mer codes, packed
        bases and levels of every read new to the resquiggler come from
        one batch of matrix operations (:func:`_kmer_plan`)."""
        p = self.params
        std_ref = self.std_ref
        k = std_ref.kmer_width
        dnstrm = k - std_ref.central_pos - 1
        fresh = [s for s in states
                 if s.error is None and s.ref_codes is None]
        if fresh:
            codes, packed, starts, lens, bad = _kmer_plan(
                [s.map_res.genome_seq for s in fresh], k)
            means, sds = std_ref.means[codes], std_ref.sds[codes]
            for s, a, n_bases, bad_read in zip(fresh, starts.tolist(),
                                               lens.tolist(), bad):
                n = n_bases - k + 1
                if bad_read or n <= 0:
                    s.error = ("Invalid sequence encountered from genome "
                               "sequence.")
                    continue
                s.ref_codes = codes[a:a + n]
                s.packed_bases = packed[a // 4:(a + n_bases + 3) // 4]
                s.ref_means, s.ref_sds = means[a:a + n], sds[a:a + n]
                s.genome_seq_trim = s.map_res.genome_seq[
                    std_ref.central_pos:-dnstrm]
        for s in states:
            if s.error is not None:
                continue
            if len(s.genome_seq_trim) != s.ref_means.shape[0]:
                s.error = "Discordant reference and sequence lengths."
                continue
            if (s.n_ev < p.start_bw + p.start_n_bases or
                    s.ref_means.shape[0] < p.start_n_bases):
                s.use_static = True

    def _start_discovery(self, states, ctx, start_bw: int,
                         check_score: bool, precomputed: bool = False):
        """Static-band start discovery + validity score (``precomputed``:
        stage A's, else a start DP per shard); returns the reads whose
        start failed the score check."""
        p = self.params
        live = [s for s in states if s.error is None and not s.use_static]
        if not live:
            return []
        nb = p.start_n_bases
        need = nb + start_bw
        shards = self._shards(live)
        if precomputed:
            with self._span("start_rows"):
                found = [(reads, [a[[s.dev_row for s in reads]]
                                  for a in ctx[d]["start"]])
                         for d, reads in shards]
        else:
            if ctx[shards[0][0]]["em"].shape[1] < need:
                # every live read has >= need events, but the group-wide
                # padded width can still be smaller
                for s in live:
                    s.use_static = True
                return []
            sp = self._start_params(start_bw)
            queued = []
            with self._span("start_dp"):
                for d, reads in shards:
                    dev = self.mesh[d]
                    rows = self._t([s.dev_row for s in reads], device=dev)
                    rm_sj, rs_sj = self._levels(reads, nb, clip=True,
                                                device=dev)
                    segs, score = _start_dp_with_score(
                        ctx[d]["em"][rows][:, :need], rm_sj, rs_sj, sp)
                    queued.append((reads, (segs[:, 0], segs[:, -1], score)))
            found = [(reads, self._np_scalars(reads, *out))
                     for reads, out in queued]
        failed = []
        thresh = SIG_MATCH_THRESH[self.seq_samp_type.name]
        with self._span("start_check"):
            for reads, (seg0, segN, score) in found:
                for i, s in enumerate(reads):
                    if check_score and (not np.isfinite(score[i]) or
                                        score[i] > thresh):
                        failed.append(s)
                        continue
                    s.events_per_base = ((int(segN[i]) - int(seg0[i])) /
                                         (nb + 1))
                    s.mapped_start = int(seg0[i])
        return failed

    def _adaptive_batch(self, states: List[_ReadState], ctx):
        """Masked-start prefix + adaptive DP + traceback."""
        p = self.params
        live = []
        half_bw = p.bandwidth // 2
        with self._span("adaptive_select"):
            for s in states:
                if s.error is not None or s.use_static:
                    continue
                if s.events_per_base == 0:
                    s.error = ("Very poor signal quality. Read likely "
                               "includes open pore.")
                    continue
                if s.mapped_start < half_bw:
                    s.events_start_clip = 0
                    s.mapped_start_offset = s.mapped_start
                else:
                    s.events_start_clip = s.mapped_start - half_bw
                    s.mapped_start_offset = half_bw
                if (int((half_bw + 1) / s.events_per_base) >=
                        s.ref_means.shape[0] or
                        s.n_ev - s.mapped_start_offset -
                        s.events_start_clip < p.bandwidth):
                    s.use_static = True
                    continue
                live.append(s)
        if live:
            self._adaptive_device_call(live, ctx)

    def _adaptive_device_call(self, live: List[_ReadState], ctx):
        """The group's adaptive DP: one read-sharded call (K3) over every
        shard's DP inputs, at shapes and a layout chosen for the whole
        group; then the device finalize per shard."""
        p = self.params
        bw = p.bandwidth
        shards = self._shards(live)
        live = [s for _, reads in shards for s in reads]     # K3's order
        with self._span("masked_plans"):
            L_max = _pow2_bucket(max(s.ref_means.shape[0] for s in live),
                                 256)
            E_max = _pow2_bucket(
                max(s.n_ev - s.events_start_clip for s in live) + bw, 256)
            pstarts, pvalid, pend, start_rows, P_max = \
                _build_masked_plans_batch(live, p)
        dpp = DpParams(
            z_shift=p.z_shift, skip_pen=p.skip_pen, stay_pen=p.stay_pen,
            mask_fill_z_score=MASK_FILL_Z_SCORE,
            max_half_z_score=p.max_half_z_score or -1.0, bandwidth=bw)
        dp_args = [None] * len(self.mesh)
        dev_in = {}
        k = 0
        with self._span("dp_inputs"):
            for d, reads in shards:
                dev = self.mesh[d]
                t = lambda a, f=False: self._t(a, f, dev)
                sl = slice(k, k + len(reads))
                k += len(reads)
                rows = t([s.dev_row for s in reads])
                clips = t([s.events_start_clip for s in reads])
                n_events = t([s.n_ev - s.events_start_clip for s in reads])
                seq_lens = t([s.ref_means.shape[0] for s in reads])
                rm_j, rs_j = self._levels(reads, L_max, device=dev)
                em_j = _gather_clip_rows(ctx[d]["em"], rows, clips, E_max)
                dp_args[d] = (em_j, n_events, rm_j, rs_j, seq_lens,
                              t(pstarts[sl]), t(pvalid[sl]), t(pend[sl]),
                              t(start_rows[sl]))
                dev_in[d] = (rows, clips, n_events, seq_lens, rm_j, rs_j)
        # fused while one read's (L, bw) move codes stay small, else
        # chunked along the rows (long reads, the save-bandwidth retry)
        with self._span("dp_enqueue"):
            segs_j, band_err, bound_err, _ = \
                banded_dp.adaptive_banded_dp_tb_sharded(
                    self.mesh, dp_args, dpp, L_max, P_max,
                    p.band_bound_thresh, banded_dp.plan_dp_layout(L_max, bw))
            sizes = [len(r) for _, r in shards]
            by = [dict(zip([d for d, _ in shards], a.split(sizes)))
                  for a in (segs_j, band_err, bound_err)]
        if not self.lanes.device_finalize:
            with self._span("host_trim"):
                self._host_trim(shards, *by)
            return
        delfix, fit = self._fit_lanes()
        fin, fits = {}, {}
        with self._span("trim_enqueue"):
            for d, reads in shards:
                rows, clips, n_events, seq_lens = dev_in[d][:4]
                fin[d] = _stage_finalize(
                    ctx[d]["cpts"], rows, clips, by[0][d].to(self.mesh[d]),
                    seq_lens, n_events, L_max)
        if fit:
            # the fit on the unfixed tables in the same pass; its scalars
            # come down with the stage's own
            with self._span("fit_points"):
                points = self._fit_points(shards, L_max)
            with self._span("fit_enqueue"):
                for d, (samp, tri) in points.items():
                    rows, _, _, seq_lens, rm_j, rs_j = dev_in[d]
                    fits[d] = _stage_fit(
                        ctx[d]["norm"], rows, fin[d][1], fin[d][0], rm_j,
                        rs_j, seq_lens, samp, tri,
                        float(config.SHIFT_CHANGE_THRESH),
                        float(config.SCALE_CHANGE_THRESH),
                        not self.skip_seq_scaling)[:5]
        # where a read without a device fit goes to a host lane
        off = None if delfix else (
            "deletion" if fit else
            "fit_gate" if self.lanes.device_fit is None else "lanes")
        has_del_all = []
        for d, reads in shards:
            seq_segs_j, rsrtr, has_del, d8_j, over_j = fin[d]
            d8, = self._np(d8_j)
            band, bound, over, rsrtr, has_del, *f = self._np_scalars(
                reads, by[1][d].to(self.mesh[d]), by[2][d].to(self.mesh[d]),
                over_j, rsrtr, has_del, *fits.get(d, ()))
            has_del_all.append(has_del)
            with self._span("seg_tables"):
                tables = self._seg_tables(
                    d8, (over != 0) & (band == 0) & (bound == 0), seq_segs_j)
            with self._span("dp_unpack"):
                for i, s in enumerate(reads):
                    if _dp_failed(s, band[i], bound[i]):
                        continue
                    s.dp_segs = tables[i, :s.ref_means.shape[0] + 1].copy()
                    s.dp_rsrtr = int(rsrtr[i])
                    s.has_del = bool(has_del[i])
                    if f and not s.has_del:
                        # as in the JAX lane, no device means are
                        # registered for these reads
                        s.dev_fit = (float(f[0][i]), float(f[1][i]),
                                     float(f[2][i]), bool(f[3][i]),
                                     bool(f[4][i]))
                    elif off is not None:
                        s.host_lane = off
        self._note_del_rate(np.concatenate(has_del_all))
        if delfix:
            self._delfix_and_fit(shards, ctx, {
                d: (rows, fin[d][1], fin[d][0], rm_j, rs_j, seq_lens)
                for d, (rows, _, _, seq_lens, rm_j, rs_j) in dev_in.items()})

    def _host_trim(self, shards, segs_by, band_by, bound_by):
        """The traceback finished on the host (``device_finalize`` False,
        the JAX ``_dp_and_finalize``'s host branch): each shard's DP
        tables and flags come down whole, then the changepoints of its
        reads that the DP did not fail (``_fetch_cpts``), and each read's
        traceback is trimmed to its events and mapped to raw coordinates.
        ``has_del`` stays unknown."""
        for d, reads in shards:
            segs, = self._np(segs_by[d])
            band, bound = self._np_scalars(reads, band_by[d], bound_by[d])
            ok = [(i, s) for i, s in enumerate(reads)
                  if not _dp_failed(s, band[i], bound[i])]
            self._fetch_cpts([s for _, s in ok])
            for i, s in ok:
                s.host_lane = "host_trim"
                tb = rsq._trim_traceback(
                    segs[i, :s.ref_means.shape[0] + 1].astype(np.int64),
                    events_len=s.n_ev - s.events_start_clip)
                s.dp_segs, s.dp_rsrtr = rsq.get_rel_raw_coords(
                    s.cpts[s.events_start_clip:], tb)

    def _fit_points(self, shards, L_max: int, only=None) -> dict:
        """(sample, pair indices) for ``_stage_fit`` of each shard (of those
        in ``only``, if given): a read of more than
        MAX_POINTS_FOR_THEIL_SEN bases fits on its rng(0) subsample
        (reference: tombo/tombo_stats.py:398-401), and when any read of the
        group does, every read fits on a sample row of that width (the
        others' bases in order); else None and the pairs of L_max
        points."""
        max_n = config.MAX_POINTS_FOR_THEIL_SEN
        sampled = any(s.ref_means.shape[0] > max_n
                      for _, reads in shards for s in reads)
        out = {}
        for d, reads in shards:
            if only is not None and d not in only:
                continue
            dev = self.mesh[d]
            samp_j = None
            if sampled:
                samp_np = np.zeros((len(reads), max_n), np.int64)
                for i, s in enumerate(reads):
                    n = s.ref_means.shape[0]
                    samp_np[i] = (_ts_sample_idx(n, max_n) if n > max_n else
                                  np.pad(np.arange(n), (0, max_n - n)))
                samp_j = self._t(samp_np, device=dev)
            out[d] = (samp_j, rescale.tri_indices(
                max_n if sampled else L_max, dev))
        return out

    def _delfix_and_fit(self, shards, ctx, dev_in):
        """Deletion-fix windows planned on the host from the segment
        tables, then one device call per shard: window DP + fit on the
        fixed table.  ``dev_in[d]`` holds shard d's device (rows, rsrtr,
        seq_segs, rm, rs, seq_lens).  Reads whose windows exceed the
        device caps go to the host lane."""
        p = self.params
        wins = {d: ([], [], [], [], []) for d, _ in shards}
        fit_reads = []
        w = config.DEL_FIX_WINDOW
        min_sig_per_base = p.raw_min_obs_per_base * config.EXTRA_SIG_FACTOR
        with self._span("delfix_plan"):
            for d, reads in shards:
                win_i, win_bs, win_nb, win_t, win_rel = wins[d]
                for i, s in enumerate(reads):
                    if s.error is not None or s.dp_segs is None:
                        continue
                    if not s.has_del:
                        fit_reads.append(s)
                        continue
                    if self.dtype == torch.float64:
                        # host lane, as the JAX package's float64 lane: the
                        # device window DP is the same recurrence in
                        # prefix-sum form, which rounds differently where
                        # integer signals tie
                        s.host_lane = "float64"
                        continue
                    segs = s.dp_segs
                    # vectorized fast path of plan_del_fix_windows: deletion
                    # clusters with gaps > 2w map one-to-one to merged
                    # windows, final unless too small; else the exact host
                    # planner
                    dels = np.flatnonzero(np.diff(segs) == 0)
                    if dels.size == 0:
                        s.has_del = False
                        fit_reads.append(s)
                        continue
                    brk = np.flatnonzero(np.diff(dels) > 2 * w) + 1
                    first = dels[np.concatenate([[0], brk])]
                    last = dels[np.concatenate([brk - 1, [dels.shape[0] - 1]])]
                    ws_arr = np.maximum(first - w, 0)
                    we_arr = np.minimum(last + w + 1, segs.shape[0] - 1)
                    n_ev = we_arr - ws_arr
                    sig_len = segs[we_arr] - segs[ws_arr]
                    if np.any(sig_len <= (n_ev + 1) * min_sig_per_base):
                        try:
                            windows = rsq.plan_del_fix_windows(
                                _pytypes.SimpleNamespace(segs=segs), p)
                        except TomboError as e:
                            s.error = str(e)
                            continue
                        if not windows:
                            s.has_del = False
                            fit_reads.append(s)
                            continue
                        ws_arr = np.array([a for a, _ in windows])
                        we_arr = np.array([b for _, b in windows])
                        n_ev = we_arr - ws_arr
                        sig_len = segs[we_arr] - segs[ws_arr]
                    # past a device cap: a host lane (s.has_del True)
                    if n_ev.max() > _DELFIX_NB_CAP:
                        s.host_lane = "delfix_nb_cap"
                        continue
                    if sig_len.max() > _DELFIX_T_CAP:
                        s.host_lane = "delfix_t_cap"
                        continue
                    s.del_windows = (
                        list(zip(ws_arr.tolist(), we_arr.tolist())),
                        len(win_i))
                    win_i.extend([i] * ws_arr.shape[0])
                    win_bs.extend(ws_arr.tolist())
                    win_nb.extend(n_ev.tolist())
                    win_t.extend(sig_len.tolist())
                    win_rel.extend(segs[ws_arr].tolist())
                    fit_reads.append(s)
        if not fit_reads:
            return

        # the group's shapes on every shard: sample points, window pads
        L_max = next(iter(dev_in.values()))[2].shape[1] - 1
        nb_pad = max([2] + [n for v in wins.values() for n in v[2]])
        t_pad = max([2] + [n for v in wins.values() for n in v[3]])
        mhz = p.max_half_z_score
        with self._span("fit_points"):
            points = self._fit_points(shards, L_max,
                                      {s.shard for s in fit_reads})
        queued = {}
        with self._span("delfix_enqueue"):
            for d, (samp_j, tri) in points.items():
                dev = self.mesh[d]
                # one inert window keeps a call without windows shape-valid
                win = wins[d] if wins[d][0] else ([0], [0], [0], [2], [0])
                rows_j, rsrtr_j, seq_segs_j, rm_j, rs_j, seq_lens_j = \
                    dev_in[d]
                queued[d] = _stage_delfix_fit(
                    ctx[d]["norm"], rows_j, rsrtr_j, seq_segs_j, rm_j, rs_j,
                    seq_lens_j, *[self._t(a, device=dev) for a in win],
                    float(mhz if mhz is not None else 0.0), samp_j, tri,
                    nb_pad=nb_pad, t_pad=t_pad,
                    min_obs=p.raw_min_obs_per_base,
                    winsorize=mhz is not None,
                    shift_thresh=float(config.SHIFT_CHANGE_THRESH),
                    scale_thresh=float(config.SCALE_CHANGE_THRESH),
                    do_fit=not self.skip_seq_scaling)
        # (bounds, fail, shift_corr, scale_corr, score, changed, fit_ok);
        # the boundaries come down as int16 (window positions, < t_pad),
        # the fit's scalars stacked; the rescaled event means stay on the
        # device
        shard_reads = dict(shards)
        res = {d: self._np(out[0].to(torch.int16), out[1]) +
               self._np_scalars(shard_reads[d], *out[2:-1])
               for d, out in queued.items()}

        with self._span("delfix_apply"):
            for s in fit_reads:
                if s.del_windows is None:
                    continue
                bounds, fail = res[s.shard][:2]
                windows, w0 = s.del_windows
                segs = s.dp_segs
                ok = True
                for k, (ws, we) in enumerate(windows):
                    if fail[w0 + k]:
                        s.error = ("Raw-signal traceback failed to find "
                                   "boundary")
                        ok = False
                        break
                    segs[ws + 1:we] = (bounds[w0 + k, :we - ws - 1].astype(
                        np.int64) + segs[ws])
                if not ok:
                    continue
                # reference validity checks (tombo/resquiggle.py:470-500)
                if np.diff(segs).min() < 1:
                    s.error = "New segments include zero length events"
                    continue
                if segs[0] < 0:
                    s.error = "New segments start with negative index"
                    continue
                s.del_fixed = True
            fit_ids = {id(s) for s in fit_reads}
            for d, reads in shards:
                if d not in res:
                    continue
                f_shc, f_scc, f_score, f_changed, f_ok = res[d][2:]
                lvl_entries = []
                for i, s in enumerate(reads):
                    if (s.error is None and id(s) in fit_ids and
                            (s.has_del is False or s.del_fixed)):
                        s.dev_fit = (float(f_shc[i]), float(f_scc[i]),
                                     float(f_score[i]), bool(f_changed[i]),
                                     bool(f_ok[i]))
                        if f_ok[i] and s.map_res.align_info is not None:
                            lvl_entries.append((
                                s.map_res.align_info.read_id, i,
                                s.ref_means.shape[0]))
                # the device fit's means serve detection in this process
                # (stats/device_levels.py); _finalize drops the reads that
                # fail or finish on a host lane
                device_levels.register_batch(queued[d][-1], lvl_entries)

    def _static_reads(self, states: List[_ReadState], ctx):
        """Short-read static-band assignment (host, numpy)."""
        need = [s for s in states if s.error is None and s.use_static and
                s.event_means is None]
        if need and ctx is not None:
            for d, reads in self._shards(need):
                em_rows, = self._np(ctx[d]["em"][self._t(
                    [s.dev_row for s in reads], device=self.mesh[d])])
                for s, row in zip(reads, em_rows):
                    s.event_means = row.astype(np.float64)[:s.n_ev]
        static = [s for s in states if s.error is None and s.use_static]
        self._fetch_cpts(static)
        for s in static:
            s.host_lane = "static_band"
            try:
                seq_events = rsq.find_static_base_assignment(
                    s.event_means, s.ref_means, s.ref_sds, self.params)
                s.dp_segs, s.dp_rsrtr = rsq.get_rel_raw_coords(s.cpts,
                                                               seq_events)
            except TomboError as e:
                s.error = str(e)

    @staticmethod
    def _host_norm(raw: np.ndarray, sv: ScaleValues, start: int,
                   end: int) -> np.ndarray:
        """Normalized raw slice in float64 from scale values."""
        norm = (raw[start:end] - sv.shift) / sv.scale
        if (sv.lower_lim is not None and sv.upper_lim is not None and
                np.isfinite(sv.lower_lim) and np.isfinite(sv.upper_lim)):
            norm = np.clip(norm, sv.lower_lim, sv.upper_lim)
        return norm

    def _apply_fit(self, s: _ReadState, slope: float, inter: float):
        """A host-lane read's Theil-Sen fit applied to its scale values.
        Returns (shift_corr, scale_corr, whether the scale changed enough
        for another scaling iteration)."""
        scale_corr, shift_corr = 1.0 / slope, -inter / slope
        sv = s.scale_values
        s.scale_values = sv.replace(
            shift=sv.shift + shift_corr * sv.scale,
            scale=sv.scale * scale_corr, outlier_thresh=self.outlier_thresh)
        return shift_corr, scale_corr, bool(
            abs(shift_corr) > config.SHIFT_CHANGE_THRESH or
            abs(scale_corr - 1) > config.SCALE_CHANGE_THRESH)

    def _finalize_native(self, host):
        """The float32 host lane (the JAX package's float32 lane): every
        read the device did not fit becomes one job of a single threaded
        ``native.finalize_batch`` call (normalize the mapped slice, fix
        deletions, per-base means, Theil-Sen, the correction).  Its score
        comes from the pre-correction means, corrected affinely.  Returns
        the reads' (state, dp_res, segs, norm, score, changed)."""
        max_n = config.MAX_POINTS_FOR_THEIL_SEN
        jobs = []
        with self._span("native_jobs"):
            for s, dp_res in host:
                sv = s.scale_values
                L = s.ref_means.shape[0]
                jobs.append((
                    s.raw[s.dp_rsrtr:s.dp_rsrtr + int(s.dp_segs[-1])],
                    sv.shift, sv.scale, sv.lower_lim, sv.upper_lim,
                    s.ref_means, s.ref_sds, s.dp_segs,
                    {True: 1, False: 0, None: -1}[s.has_del],
                    _ts_sample_idx(L, max_n) if L > max_n else None))
        with self._span("finalize_native"):
            segs_l, ev_l, norm_l, slopes, inters, status = \
                native.finalize_batch(jobs, self.params,
                                      -1 if self.skip_seq_scaling else 1)
        results = []
        with self._span("native_apply"):
            for i, (s, dp_res) in enumerate(host):
                st = int(status[i])
                if st == native.FIT_FAILED_STATUS:
                    s.error = ("Read failed sequence-based signal "
                               "re-scaling parameter estimation.")
                    continue
                if st != 0:
                    s.error = native.DEL_FIX_ERRORS.get(
                        st, "deletion fix failed")
                    continue
                ev, changed = ev_l[i], False
                if not self.skip_seq_scaling:
                    shc, scc, changed = self._apply_fit(
                        s, float(slopes[i]), float(inters[i]))
                    ev = (ev - shc) / scc
                score = rsq.get_read_seg_score(ev, dp_res.ref_means,
                                               dp_res.ref_sds)
                results.append((s, dp_res, segs_l[i], norm_l[i], score,
                                changed))
        return results

    def _finalize_host(self, host):
        """The Python host lane (the JAX package's float64 lane, and its
        float32 lane's Python passes under ``native_finalize`` False): the
        normalized mapped slice in float64, one ``native.del_fix_batch``
        call for the reads with a deletion (or not known to have none),
        event means, one ``native.theil_sen_batch`` call for the fit (at
        float32 a float32 fit, or the device blocks of
        :func:`_theil_sen_device_blocks` under ``device_theil_sen`` with 32
        reads or more on one device).  The score comes from the corrected
        slice's means at float64, from the pre-correction means corrected
        affinely at float32, each as its JAX lane.  Returns the reads'
        (state, dp_res, segs, norm, score, changed)."""
        f32 = self.dtype != torch.float64
        reads = []
        with self._span("host_norm"):
            for s, dp_res in host:
                norm = self._host_norm(s.raw, s.scale_values, s.dp_rsrtr,
                                       s.dp_rsrtr + int(s.dp_segs[-1]))
                reads.append([s, dp_res, dp_res.segs, norm])
        dels = [r for r in reads if r[0].has_del is not False]
        if dels:
            with self._span("finalize_native"):
                segs_l, status = native.del_fix_batch(
                    [(norm, dp_res.ref_means, dp_res.ref_sds, segs)
                     for _, dp_res, segs, norm in dels], self.params)
            for r, segs, st in zip(dels, segs_l, status):
                if st == 0:
                    r[2] = segs
                else:
                    r[0].error = native.DEL_FIX_ERRORS.get(
                        int(st), "deletion fix failed")
            reads = [r for r in reads if r[0].error is None]
        if not reads:
            return []
        if self.skip_seq_scaling:
            return [(s, dp_res, segs, norm, rsq.get_read_seg_score(
                ref_impl.new_means(norm, segs), dp_res.ref_means,
                dp_res.ref_sds), False) for s, dp_res, segs, norm in reads]
        max_n = config.MAX_POINTS_FOR_THEIL_SEN
        ev = np.zeros((len(reads), max_n))
        mod = np.zeros((len(reads), max_n))
        n_pts = np.zeros(len(reads), np.int64)
        ev_pre = []
        results = []
        with self._span("host_fit"):
            for i, (_, dp_res, segs, norm) in enumerate(reads):
                r_ev, r_mod = (ref_impl.new_means(norm, segs),
                               dp_res.ref_means)
                ev_pre.append(r_ev)
                n = r_mod.shape[0]
                if n > max_n:
                    samp = _ts_sample_idx(n, max_n)
                    r_ev, r_mod, n = r_ev[samp], r_mod[samp], max_n
                ev[i, :n], mod[i, :n], n_pts[i] = r_ev, r_mod, n
            if (f32 and self.lanes.device_theil_sen and
                    len(self.mesh) == 1 and len(reads) >= 32):
                slopes, inters = _theil_sen_device_blocks(
                    ev, mod, n_pts, self.device, self.profile)
            else:
                slopes, inters = native.theil_sen_batch(ev, mod, n_pts,
                                                        use_f32=f32)
            for (s, dp_res, segs, norm), r_ev, slope, inter in zip(
                    reads, ev_pre, slopes, inters):
                if slope == 0:
                    s.error = ("Read failed sequence-based signal "
                               "re-scaling parameter estimation.")
                    continue
                shc, scc, changed = self._apply_fit(s, float(slope),
                                                    float(inter))
                norm = (norm - shc) / scc
                means = ((r_ev - shc) / scc if f32 else
                         ref_impl.new_means(norm, segs))
                score = rsq.get_read_seg_score(means, dp_res.ref_means,
                                               dp_res.ref_sds)
                results.append((s, dp_res, segs, norm, score, changed))
        return results

    def _finalize(self, states: List[_ReadState], will_retry: bool = False):
        """Apply the device fit (scalar bookkeeping), finish every other
        read in batched calls of the host library (:meth:`_finalize_native`
        at float32, :meth:`_finalize_host` at float64 or without
        ``native_finalize``) and assemble results.  With
        ``skip_seq_scaling`` the scale values stay as segmentation set
        them and no read asks for another scaling iteration."""
        host, dev = [], []
        with self._span("finalize_route"):
            for s in states:
                if s.error is not None or s.result is not None:
                    continue
                if s.dp_segs is None:
                    s.error = "DP did not produce a path"
                    continue
                dp_res = DpResults(s.dp_rsrtr, s.dp_segs, s.ref_means,
                                   s.ref_sds, s.genome_seq_trim)
                if s.dev_fit is not None:
                    dev.append((s, dp_res, s.dp_segs))
                else:
                    host.append((s, dp_res))
        if self.profile is not None:
            self._count("finalize_device_reads", len(dev))
            self._count("finalize_host_reads", len(host))
            # a read no branch routed: a device fix or fit that did not
            # finish it
            for reason, n in collections.Counter(
                    s.host_lane or "device_unfinished"
                    for s, _ in host).items():
                self._count("host_lane." + reason, n)

        results = []
        if host:
            results = (self._finalize_native(host)
                       if self.dtype == torch.float32 and
                       self.lanes.native_finalize
                       else self._finalize_host(host))

        with self._span("device_apply"):
            for s, dp_res, segs in dev:
                shc, scc, score, changed, fit_ok = s.dev_fit
                start = dp_res.read_start_rel_to_raw
                if self.skip_seq_scaling:
                    norm = self._host_norm(s.raw, s.scale_values, start,
                                           start + int(segs[-1]))
                    results.append((s, dp_res, segs, norm, score, False))
                    continue
                if not fit_ok:
                    s.error = ("Read failed sequence-based signal "
                               "re-scaling parameter estimation.")
                    continue
                sv_pre = s.scale_values
                s.scale_values = sv_pre.replace(
                    shift=sv_pre.shift + shc * sv_pre.scale,
                    scale=sv_pre.scale * scc,
                    outlier_thresh=self.outlier_thresh)
                norm = None
                if not (will_retry and changed):
                    # the normalized mapped slice, two steps as the host
                    # lane: pre-fit scale values + clip, then the fitted
                    # correction
                    norm = (self._host_norm(s.raw, sv_pre, start,
                                            start + int(segs[-1])) -
                            shc) / scc
                results.append((s, dp_res, segs, norm, score, changed))

        with self._span("finalize_results"):
            for s, dp_res, segs, norm, score, changed in results:
                if segs.shape[0] != len(dp_res.genome_seq) + 1:
                    s.error = ("Aligned sequence does not match number of "
                               "segments produced")
                    continue
                s.result = s.map_res.replace(
                    read_start_rel_to_raw=dp_res.read_start_rel_to_raw,
                    segs=segs, genome_seq=dp_res.genome_seq, raw_signal=norm,
                    scale_values=s.scale_values,
                    sig_match_score=float(score),
                    norm_params_changed=bool(changed))

        # a failed read, or one finished on a host lane, must leave no
        # device means behind: an earlier pass may have registered it
        with self._span("levels_unregister"):
            for s in states:
                if ((s.error is not None or s.dev_fit is None) and
                        s.map_res.align_info is not None):
                    device_levels.unregister(s.map_res.align_info.read_id,
                                             self.device.type)

    # ------------------------------------------------------------ run API
    def _run_pass(self, states: List[_ReadState], will_retry: bool = False):
        with self._span("pass"):
            for s in states:
                if s.error is None:
                    s.n_ev = s.num_events - 1
            live = [s for s in states if s.error is None]
            groups = _length_groups(live)
            self._count("read_passes", len(live))
            self._count("groups", len(groups))
            for group in groups:
                self._run_pass_group(group, will_retry)

    def _run_pass_group(self, states: List[_ReadState],
                        will_retry: bool = False):
        p = self.params
        with self._span("plan"):
            self._plan_reads(states)
        with self._span("segment"):
            ctx = self._segment_batch(states)
        if ctx is not None:
            with self._span("start"):
                failed_start = self._start_discovery(
                    states, ctx, p.start_bw, check_score=True,
                    precomputed=True)
            # save-bandwidth start retry without score check, so no read
            # fails it (reference: tombo/resquiggle.py:996-1006)
            for s in failed_start:
                if s.n_ev < p.start_save_bw + p.start_n_bases:
                    s.use_static = True
            retry = [s for s in failed_start if not s.use_static]
            if retry:
                self._count("start_retry_reads", len(retry))
                with self._span("start"):
                    self._start_discovery(retry, ctx, p.start_save_bw,
                                          check_score=False)
            with self._span("adaptive"):
                self._adaptive_batch(states, ctx)
            with self._span("static"):
                self._static_reads(states, ctx)
        with self._span("finalize"):
            self._finalize(states, will_retry=will_retry)

    def resquiggle_batches(self, batches, pipeline_depth: int = 3,
                           max_scaling_iters: int = config.MAX_SCALING_ITERS,
                           trace_dir: Optional[str] = None):
        """Process an iterable of mapped-read batches, yielding per-batch
        result lists in order, one batch after another.

        ``pipeline_depth`` is kept for the JAX package's signature and has
        no effect: that package runs batches side by side in threads, but
        a batch here makes thousands of short PyTorch calls, each of which
        hands the GIL over, so concurrent batches slow each other down
        (PERF.md, Findings).  ``trace_dir``: trace the batches into it
        (:func:`trace_ctx`), each span a range named as in
        :class:`StageProfile`; the trace is written when the generator
        ends or is closed."""
        with contextlib.ExitStack() as stack:
            if trace_dir is not None:
                stack.enter_context(trace_ctx(trace_dir, self.mesh))
            for b in batches:
                yield self.resquiggle_batch(
                    b, max_scaling_iters=max_scaling_iters)

    def resquiggle_batch(self, map_results: Sequence[ResquiggleResults],
                         max_scaling_iters: int = config.MAX_SCALING_ITERS
                         ) -> List[Tuple[Optional[ResquiggleResults],
                                         Optional[str]]]:
        """Re-squiggle a batch of mapped reads (raw signal already
        adjusted).  Returns per-read (result, error).  The profile's
        ``batch`` span, one of its ``batches`` and its ``reads``."""
        with self._span("batch"):
            self._count("batches")
            self._count("reads", len(map_results))
            return self._resquiggle_reads(map_results, max_scaling_iters)

    def _resquiggle_reads(self, map_results, max_scaling_iters: int):
        """:meth:`resquiggle_batch`'s work, the save-bandwidth retry's
        too."""
        states = []
        with self._span("read_states"):
            for idx, mr in enumerate(map_results):
                raw = np.asarray(mr.raw_signal, np.float64)
                if self.const_scale is not None and mr.scale_values is None:
                    # one scale for every read, the median shift per read:
                    # scale values from the host into the given-scale path
                    _, sv = rsq.normalize_raw_signal(
                        raw, norm_type="median_const_scale",
                        outlier_thresh=self.outlier_thresh,
                        const_scale=self.const_scale)
                    mr = mr.replace(scale_values=sv)
                num_mapped_bases = (len(mr.genome_seq) -
                                    self.std_ref.kmer_width + 1)
                st = _ReadState(idx=idx, map_res=mr, raw=raw, num_events=0)
                st.num_events = rsq.compute_num_events(
                    raw.shape[0], num_mapped_bases,
                    self.params.mean_obs_per_event)
                if st.num_events / self.params.bandwidth > num_mapped_bases:
                    st.error = "Too much raw signal for mapped sequence"
                states.append(st)

        self._run_pass(states, will_retry=max_scaling_iters > 1)

        # iterative sequence-fitted rescaling
        for it in range(max_scaling_iters - 1):
            redo = [s for s in states
                    if s.result is not None and s.result.norm_params_changed]
            if not redo:
                break
            for s in redo:
                s.map_res = s.map_res.replace(
                    scale_values=s.result.scale_values)
                s.reset_pass()
            self._run_pass(redo, will_retry=it < max_scaling_iters - 2)
        # the device matrices the reads kept between passes
        for s in states:
            s.raw_dev = s.cpts_dev = None

        # failed reads retried with the save bandwidth
        # (reference: tombo/resquiggle.py:1586-1588)
        retry = ([] if self.params.bandwidth == self.save_params.bandwidth
                 else [s for s in states if s.result is None])
        if retry:
            self._count("save_bw_retry_reads", len(retry))
            saver = BatchedResquiggler(
                self.std_ref, self.save_params, self.seq_samp_type,
                self.outlier_thresh, self.dtype, mesh=self.mesh,
                const_scale=self.const_scale,
                skip_seq_scaling=self.skip_seq_scaling, profile=self.profile,
                lanes=self.lanes)
            with self._span("save_bw_retry"):
                retry_out = saver._resquiggle_reads(
                    [s.map_res.replace(scale_values=None) for s in retry],
                    max_scaling_iters)
            for s, (res, err) in zip(retry, retry_out):
                if res is not None:
                    s.result = res
                    s.error = None
        return [(s.result, s.error) for s in states]
