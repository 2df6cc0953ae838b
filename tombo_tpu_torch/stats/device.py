"""The device lane of de novo and model-sample-compare detection
(counterpart of ``tombo_tpu/stats/device.py:47-670``).

Per-read model tests run on (reads, span) level matrices: z-score, two
sided p-value, Fisher's-method window, then per-site (coverage, valid
coverage, above-threshold) counts reduced along the reads axis in the same
call, so only integer counts come back to the host.  The packed lane
(:class:`PackedRegionBatch`) cuts many regions into sub-spans of a fixed
width and stacks every (read, sub-span) overlap as one row of a single
(B, W) matrix, one device call per group of ~512 rows.

These are PyTorch operations on tensors of any device: the same code runs
on the card and, for the tests, on the CPU.  No Pallas kernel lies on this
path (the JAX functions are XLA), so there is no hand-written kernel here.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..config import SMALLEST_PVAL
from ..device import DeviceLike, resolve_device, resolve_dtype

# sub-span core width (the JAX lane's default)
CORE_DEFAULT = 4096
# rows of one packed dispatch before the next group starts
ROWS_PER_GROUP = 512
MODES = ("two_way", "alt", "plain")


def _window_logp_sum(logp: torch.Tensor, lag: int) -> torch.Tensor:
    """Per-window sum of +-lag neighbours, added in column order; a window
    that reaches a NaN or the array edge is NaN (the reference's strided
    window sums, reference: tombo/tombo_stats.py:2262-2266; not a cumsum
    difference)."""
    W = logp.shape[1]
    padded = torch.nn.functional.pad(logp, (lag, lag), value=math.nan)
    out = torch.zeros_like(logp)
    for d in range(2 * lag + 1):
        out = out + padded[:, d:d + W]
    return out


def _chi2_sf_int(x: torch.Tensor, width: int) -> torch.Tensor:
    """chi2.sf(2x, 2 * width) = Q(width, x) = e^-x * sum_{i<width} x^i/i!
    for an integer shape, summed in log space: logsumexp over i of
    ``i log x - lgamma(i + 1)``, minus x.  No term overflows, so a wide
    window of tiny p-values gives a tiny (or zero) p-value where the JAX
    lane's partial sum gives NaN at float32 (inf times 0).  x = +inf (a
    p-value of 0 in the window) gives 0; NaN stays NaN."""
    i = torch.arange(width, dtype=x.dtype, device=x.device)
    with torch.no_grad():
        logx = torch.log(x)[..., None]
        # the i = 0 term is log(1) = 0 at every x, 0 and inf included
        terms = torch.where(i == 0, torch.zeros_like(logx),
                            i * logx) - torch.lgamma(i + 1)
        q = torch.exp(torch.logsumexp(terms, dim=-1) - x)
    return torch.where(x == math.inf, torch.zeros_like(q), q)


def _two_sided_p(z: torch.Tensor) -> torch.Tensor:
    """2 * ndtr(-z) for |z| scores, in the JAX ``ndtr``'s form: 1 +
    erf(-w) while w = z / sqrt 2 is below 1 / sqrt 2, else erfc(w), so
    the tail keeps its digits (``torch.special.ndtr`` takes 1 + erf
    everywhere and gives 0 past z ~ 8.3 at float64).  NaN stays NaN."""
    half_sqrt_2 = math.sqrt(2.0) / 2.0
    w = z * half_sqrt_2
    return torch.where(w < half_sqrt_2, 1.0 + torch.special.erf(-w),
                       torch.special.erfc(w))


def _fisher_and_clamp(p: torch.Tensor, fm_offset: int,
                      clamp_after: bool) -> torch.Tensor:
    if fm_offset > 0:
        logp = torch.log(torch.clamp_min(p, SMALLEST_PVAL))
        p = _chi2_sf_int(-_window_logp_sum(logp, fm_offset),
                         2 * fm_offset + 1)
    if clamp_after:
        p = torch.clamp_min(p, SMALLEST_PVAL)
    return p


def model_test_pvals(r_means, ref_means, ref_sds, valid,
                     fm_offset: int, clamp_after: bool,
                     dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Two-sided z-test p-values with an optional Fisher's-method window.

    ``r_means``: (B, W) span-aligned read level means; ``ref_means`` and
    ``ref_sds`` are (W,) or (B, W); ``valid`` masks each read's testing
    columns.  ``clamp_after`` applies the de novo SMALLEST_PVAL floor
    after the window (reference: tombo/tombo_stats.py:3860-3862).  Runs
    in ``dtype`` (default ``r_means``' own)."""
    dt = dtype or r_means.dtype
    z = torch.abs((r_means.to(dt) - ref_means.to(dt)) / ref_sds.to(dt))
    z = torch.where(valid, z, torch.full_like(z, math.nan))
    return _fisher_and_clamp(_two_sided_p(z), fm_offset, clamp_after)


def _site_masks(stats, emit_valid, single_read_thresh: float,
                lower_thresh: float, mode: str):
    if mode not in MODES:
        raise ValueError("unknown accumulation mode: %s" % mode)
    ok = emit_valid & ~torch.isnan(stats)
    if mode == "two_way":
        is_valid = ok & ((stats <= lower_thresh) |
                         (stats >= single_read_thresh))
    elif mode == "alt":
        is_valid = ok & (torch.abs(stats) >= single_read_thresh)
    else:
        is_valid = ok
    return ok, is_valid, ok & (stats >= single_read_thresh)


def site_accumulate(stats, emit_valid, single_read_thresh: float,
                    lower_thresh: float, mode: str):
    """Per-site (coverage, valid coverage, above-threshold count) int32
    sums along the reads axis.  ``mode``: "two_way" also counts
    statistics at or below ``lower_thresh`` as valid, "alt" counts
    |stat| >= thresh, "plain" counts every statistic."""
    return tuple(m.sum(0, dtype=torch.int32) for m in _site_masks(
        stats, emit_valid, single_read_thresh, lower_thresh, mode))


def model_test_and_accumulate(r_means, ref_means, ref_sds, valid,
                              emit_valid, fm_offset: int, clamp_after: bool,
                              single_read_thresh: float, lower_thresh: float,
                              mode: str, dtype: Optional[torch.dtype] = None):
    """Per-read test and per-site reduction in one call: three (W,) int32
    vectors."""
    p = model_test_pvals(r_means, ref_means, ref_sds, valid, fm_offset,
                         clamp_after, dtype)
    return site_accumulate(p, emit_valid, single_read_thresh, lower_thresh,
                           mode)


# ---------------------------------------------------------------------------
# packed multi-region lane
# ---------------------------------------------------------------------------

def _pow2_at_least(x: int, lo: int) -> int:
    b = lo
    while b < x:
        b *= 2
    return b


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def gather_row_levels(flat, ivec, dev_groups, W: int, dtype: torch.dtype):
    """(B, W) row levels of one group, NaN outside each row's slice
    [m_off, m_off + m_len): host rows from the ``flat`` buffer (row i's
    values from offset offs), device-resident rows gathered from their
    source tensors, one gather a source (rows are grouped by source, so
    two sources never mix).  ``dev_groups``: list of (flat source tensor,
    meta (5, n) int64: row in the group, offset of the read's first mean
    in the source, the read's column at m_off, column step, the read's
    length)."""
    dev = ivec.device
    col = torch.arange(W, dtype=torch.int64, device=dev)[None, :]
    rel = col - ivec[1].long()[:, None]
    valid_m = (rel >= 0) & (rel < ivec[2].long()[:, None])
    if flat is not None:
        idx = (ivec[0].long()[:, None] + rel).clamp(0, flat.shape[0] - 1)
        vals = flat[idx].to(dtype)
    else:
        vals = torch.full((ivec.shape[1], W), math.nan, dtype=dtype,
                          device=dev)
    for src, meta in dev_groups:
        rows, base, scol0, step, n = meta
        scol = torch.minimum((scol0[:, None] + rel[rows] * step[:, None])
                             .clamp(min=0), n[:, None] - 1)
        vals[rows] = src[base[:, None] + scol].to(dtype)
    return torch.where(valid_m, vals, torch.full_like(vals, math.nan))


def packed_test_and_accumulate(flat, ivec, dev_groups, ref, W: int,
                               fm_offset: int, clamp_after: bool,
                               single_read_thresh: float,
                               lower_thresh: float, mode: str,
                               dtype: torch.dtype):
    """One packed dispatch: the row levels' gather, the test and the
    per-(sub-span, site) reduction of a group of rows.

    ``flat``, ``dev_groups``: the row levels (:func:`gather_row_levels`);
    ``ivec``: (8, B) int32 rows (offs, m_off, m_len, zv_lo, zv_hi, em_lo,
    em_hi, sid).  zv_lo/zv_hi bound the columns a row's z-scores come
    from (the read's lag-trimmed testing extent, so Fisher windows see
    nothing past it; reference: tombo/tombo_stats.py:3846), em_lo/em_hi
    the columns whose statistics the row contributes (its sub-span core,
    so each site lands in exactly one sub-span), sid the row's sub-span.
    ``ref``: ("codes", codes (S, W) int, means table, sds table) with a
    NaN sentinel row at the end of each table (the k-mer codes wire), or
    ("levels", means (S, W), sds (S, W)).

    Returns (counts (S, W, 3) uint8, over (S,) bool, counts (S, W, 3)
    int32): the caller fetches the bytes and re-fetches the int32 rows of
    the rare sub-spans whose counts pass 255.  The reduction is an
    ``index_add_`` of int32 masks over the sub-span id: exact and
    independent of order."""
    r_means = gather_row_levels(flat, ivec, dev_groups, W, dtype)
    sid = ivec[7].long()
    col = torch.arange(W, dtype=torch.int32, device=ivec.device)[None, :]
    if ref[0] == "codes":
        c = ref[1].long()
        rm = ref[2][c][sid]
        rs = ref[3][c][sid]
    else:
        rm, rs = ref[1][sid], ref[2][sid]
    zvalid = (col >= ivec[3][:, None]) & (col < ivec[4][:, None])
    emit = (col >= ivec[5][:, None]) & (col < ivec[6][:, None])
    z = torch.abs((r_means - rm.to(dtype)) / rs.to(dtype))
    z = torch.where(zvalid, z, torch.full_like(z, math.nan))
    p = _fisher_and_clamp(_two_sided_p(z), fm_offset, clamp_after)
    masks = torch.stack(_site_masks(p, emit, single_read_thresh,
                                    lower_thresh, mode), dim=-1)
    counts = torch.zeros((ref[1].shape[0], W, 3), dtype=torch.int32,
                         device=p.device)
    counts.index_add_(0, sid, masks.to(torch.int32))
    over = (counts > 255).any(2).any(1)
    return counts.to(torch.uint8), over, counts


class PackedRegionBatch:
    """Host-side packer: region jobs -> device rows -> per-region dense
    accumulators.  ``levels_table``: the model's (means, sds) when
    sub-spans carry k-mer codes (de novo), else None (expected levels per
    position, sample-compare)."""

    def __init__(self, fm_offset: int, core: int = CORE_DEFAULT,
                 levels_table=None, device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None):
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype, self.device)
        self.fm = fm_offset
        self.core = core
        self.W = core + 2 * fm_offset
        self.rows = []          # (means slice | site count, offsets..., sid)
        self.row_dev = []       # per row: None | (source, offset, src0,
        #                         step, read length)
        self.subs = []          # (job_idx, c_lo, c_hi, ref_m | codes, ref_s)
        self.table = levels_table
        self._table_dev = None

    def _dev_table(self):
        if self._table_dev is None:
            self._table_dev = tuple(
                torch.tensor(np.append(np.asarray(t, np.float64), np.nan),
                             dtype=self.dtype, device=self.device)
                for t in self.table)
        return self._table_dev

    def add_region(self, job_idx: int, span_lo: int, span_n: int,
                   ref_means, ref_sds, levels, place_lo: int, place_hi: int,
                   begin_lag: int, end_lag: int,
                   ref_codes: Optional[np.ndarray] = None):
        """Cut one region's span into sub-spans and emit its rows.
        ``ref_means``/``ref_sds`` are (span_n,) genome-oriented arrays, or
        with a ``levels_table`` ``ref_codes`` is the (span_n,) k-mer code
        per position (-1: no valid window); ``levels`` the region's
        ReadLevels."""
        fm, core = self.fm, self.core
        # per-read trimmed extents and emission bounds (the host lane's
        # clipping, reference: tombo/tombo_stats.py:3783-3846)
        reads = []
        for rl in levels:
            r = rl.r_data
            m = None
            if rl.dev is None:
                m = rl.means[::-1] if r.strand == "-" else rl.means
            g_lo = max(r.start, span_lo, place_lo)
            g_hi = min(r.end, span_lo + span_n, place_hi)
            if g_hi <= g_lo:
                continue
            e_lo = max(g_lo, max(r.start, place_lo) + begin_lag)
            e_hi = min(g_hi, min(r.end, place_hi) - end_lag)
            if e_hi <= e_lo:
                continue
            reads.append((r.start, g_lo, g_hi, e_lo, e_hi, m, rl.dev,
                          r.strand, r.end - r.start))
        for j in range(-(-span_n // core)):
            c_lo = span_lo + j * core
            c_hi = min(c_lo + core, span_lo + span_n)
            sid = len(self.subs)
            col0 = c_lo - fm
            lo = max(col0, span_lo)
            hi = min(col0 + self.W, span_lo + span_n)
            if ref_codes is not None:
                sent = self.table[0].shape[0]
                crow = np.full(self.W, sent, np.int16)
                if hi > lo:
                    cs = ref_codes[lo - span_lo:hi - span_lo]
                    crow[lo - col0:hi - col0] = np.where(cs >= 0, cs, sent)
                self.subs.append((job_idx, c_lo, c_hi, crow, None))
            else:
                rm = np.full(self.W, np.nan)
                rs = np.full(self.W, np.nan)
                if hi > lo:
                    rm[lo - col0:hi - col0] = ref_means[lo - span_lo:
                                                        hi - span_lo]
                    rs[lo - col0:hi - col0] = ref_sds[lo - span_lo:
                                                      hi - span_lo]
                self.subs.append((job_idx, c_lo, c_hi, rm, rs))
            for (r_start, g_lo, g_hi, e_lo, e_hi, m, dev, strand,
                 r_len) in reads:
                m_lo = max(g_lo, col0)
                m_hi = min(g_hi, col0 + self.W)
                em_lo = max(e_lo, c_lo)
                em_hi = min(e_hi, c_hi)
                if em_hi <= em_lo or m_hi <= m_lo:
                    continue
                bounds = (m_lo - col0, max(e_lo, col0) - col0,
                          min(e_hi, col0 + self.W) - col0, em_lo - col0,
                          em_hi - col0, sid)
                if dev is not None:
                    # genome position g is read column g - r_start on '+',
                    # L - 1 - (g - r_start) on '-'
                    if strand == "-":
                        src0, step = r_len - 1 - (m_lo - r_start), -1
                    else:
                        src0, step = m_lo - r_start, 1
                    self.rows.append((m_hi - m_lo,) + bounds)
                    self.row_dev.append((dev[0], int(dev[1]), src0, step,
                                         r_len))
                else:
                    self.rows.append((m[m_lo - r_start:m_hi - r_start],) +
                                     bounds)
                    self.row_dev.append(None)

    @staticmethod
    def _row_len(r0) -> int:
        return r0 if isinstance(r0, int) else r0.shape[0]

    def _group_inputs(self, r0: int, r1: int, g_s0: int, g_s1: int):
        """Device inputs of rows [r0, r1) and sub-spans [g_s0, g_s1)."""
        dev, dt = self.device, self.dtype
        Bp = _pow2_at_least(max(r1 - r0, 1), 128)
        Sp = _round_up(g_s1 - g_s0, 8)
        ivec = np.zeros((8, Bp), np.int32)
        flat_parts, by_src = [], {}
        o = 0
        for i in range(r0, r1):
            m, mo, zl, zh, el, eh, s = self.rows[i]
            j = i - r0
            n = self._row_len(m)
            if isinstance(m, int):
                src, base, src0, step, r_len = self.row_dev[i]
                by_src.setdefault(id(src), (src, []))[1].append(
                    (j, base, src0, step, r_len))
            else:
                flat_parts.append(m)
                ivec[0, j] = o
                o += n
            ivec[1:, j] = (mo, n, zl, zh, el, eh, s - g_s0)
        ivec_t = torch.from_numpy(ivec).to(dev)
        flat = None
        if flat_parts:
            flat = torch.from_numpy(np.concatenate(flat_parts).astype(
                np.float64 if dt == torch.float64 else np.float32)).to(dev)
        dev_groups = [
            (src, torch.tensor(np.array(rows_g, np.int64).T, device=dev))
            for src, rows_g in by_src.values()]
        if self.table is not None:
            sent = self.table[0].shape[0]
            codes = np.full((Sp, self.W), sent, np.int16)
            for s in range(g_s0, g_s1):
                codes[s - g_s0] = self.subs[s][3]
            ref = ("codes", torch.from_numpy(codes).to(dev)) + \
                self._dev_table()
        else:
            ref_m = np.full((Sp, self.W), np.nan)
            ref_s = np.full((Sp, self.W), np.nan)
            for s in range(g_s0, g_s1):
                ref_m[s - g_s0] = self.subs[s][3]
                ref_s[s - g_s0] = self.subs[s][4]
            ref = ("levels", torch.tensor(ref_m, dtype=dt, device=dev),
                   torch.tensor(ref_s, dtype=dt, device=dev))
        return flat, ivec_t, dev_groups, ref

    def dispatch(self, fm_offset: int, clamp_after: bool,
                 single_read_thresh: float, lower_thresh: float, mode: str):
        """Run every row; returns counts (S, W, 3) int64 (numpy), or None
        with no rows.  Sub-spans split into groups of ~``ROWS_PER_GROUP``
        rows, one device call each; every group is queued before the
        first fetch, so the card runs group g + 1 while the host waits
        for group g."""
        B, S = len(self.rows), len(self.subs)
        if B == 0:
            return None
        # rows were appended in sub-span order: contiguous ranges per
        # sub-span, then groups of sub-spans bounded by row count
        row_sid = np.array([r[6] for r in self.rows], np.int64)
        sub_row_start = np.searchsorted(row_sid, np.arange(S + 1))
        groups, g_s0 = [], 0
        for s in range(1, S + 1):
            if s == S or (sub_row_start[s] - sub_row_start[g_s0] >=
                          ROWS_PER_GROUP):
                groups.append((g_s0, s))
                g_s0 = s
        handles = []
        for g_s0, g_s1 in groups:
            r0, r1 = int(sub_row_start[g_s0]), int(sub_row_start[g_s1])
            u8, over, counts32 = packed_test_and_accumulate(
                *self._group_inputs(r0, r1, g_s0, g_s1), self.W, fm_offset,
                clamp_after, float(single_read_thresh), float(lower_thresh),
                mode, self.dtype)
            handles.append((g_s0, g_s1, u8, over, counts32))
        counts = np.zeros((S, self.W, 3), np.int64)
        for g_s0, g_s1, u8, over, counts32 in handles:
            Sg = g_s1 - g_s0
            counts[g_s0:g_s1] = u8[:Sg].cpu().numpy()
            for s in np.flatnonzero(over[:Sg].cpu().numpy()):
                counts[g_s0 + s] = counts32[int(s)].cpu().numpy()
        return counts

    def unpack_region(self, job_idx: int, span_lo: int, span_n: int,
                      counts: np.ndarray):
        """One region's dense (cov, valid, above) accumulators from the
        fetched sub-span counts."""
        out = np.zeros((3, span_n), np.int64)
        fm = self.fm
        for s, (j, c_lo, c_hi, _, _) in enumerate(self.subs):
            if j == job_idx:
                n = c_hi - c_lo
                out[:, c_lo - span_lo:c_hi - span_lo] = \
                    counts[s, fm:fm + n].T
        return out[0], out[1], out[2]
