"""The device lane of modified-base detection (counterpart of
``tombo_tpu/stats/device.py``).

Per-read model tests run on (reads, span) level matrices: z-score, two
sided p-value, Fisher's-method window, then per-site (coverage, valid
coverage, above-threshold) counts reduced along the reads axis in the same
call, so only integer counts come back to the host (and the p-values,
when per-read statistics are asked for).  The packed lane
(:class:`PackedRegionBatch`) cuts many regions into sub-spans of a fixed
width and stacks every (read, sub-span) overlap as one row of a single
(B, W) matrix, one device call per group of ~512 rows.  The
alternative-model test scores stacked (motif hits, k) level windows
(:func:`alt_llhr`); the group level tests (:func:`ks_tests`,
:func:`u_tests`, :func:`t_tests`) run on (sites, coverage) NaN-padded
level matrices.

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
                               dtype: torch.dtype, want_pvals: bool = False):
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
    int32, the (B, W) p-values or None): the caller fetches the bytes and
    re-fetches the int32 rows of the rare sub-spans whose counts pass
    255, and the p-values only with ``want_pvals``.  The reduction is an
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
    return counts.to(torch.uint8), over, counts, (p if want_pvals else None)


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
        self.row_meta = []      # (job_idx, read index in the job, col0)
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
        for ridx, rl in enumerate(levels):
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
            reads.append((ridx, r.start, g_lo, g_hi, e_lo, e_hi, m, rl.dev,
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
            for (ridx, r_start, g_lo, g_hi, e_lo, e_hi, m, dev, strand,
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
                self.row_meta.append((job_idx, ridx, col0))

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
                 single_read_thresh: float, lower_thresh: float, mode: str,
                 want_pvals: bool = False):
        """Run every row; returns (counts (S, W, 3) int64, the (B, W)
        p-values in the lane's dtype or None) as numpy, or (None, None)
        with no rows.  Sub-spans split into groups of ~``ROWS_PER_GROUP``
        rows, one device call each; every group is queued before the
        first fetch, so the card runs group g + 1 while the host waits
        for group g.  Without ``want_pvals`` no p-value leaves the
        device."""
        B, S = len(self.rows), len(self.subs)
        if B == 0:
            return None, None
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
            u8, over, counts32, pv = packed_test_and_accumulate(
                *self._group_inputs(r0, r1, g_s0, g_s1), self.W, fm_offset,
                clamp_after, float(single_read_thresh), float(lower_thresh),
                mode, self.dtype, want_pvals)
            handles.append((g_s0, g_s1, r0, r1, u8, over, counts32, pv))
        counts = np.zeros((S, self.W, 3), np.int64)
        pvals = None
        if want_pvals:
            pvals = np.empty((B, self.W), np.float64
                             if self.dtype == torch.float64 else np.float32)
        for g_s0, g_s1, r0, r1, u8, over, counts32, pv in handles:
            Sg = g_s1 - g_s0
            counts[g_s0:g_s1] = u8[:Sg].cpu().numpy()
            for s in np.flatnonzero(over[:Sg].cpu().numpy()):
                counts[g_s0 + s] = counts32[int(s)].cpu().numpy()
            if want_pvals:
                pvals[r0:r1] = pv[:r1 - r0].cpu().numpy()
        return counts, pvals

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

    def read_streams(self, job_idx: int, pvals: np.ndarray):
        """One region's per-read (positions, statistics) streams from the
        fetched p-values (per-read statistics files): {read index in the
        job: (positions ascending, float64 statistics)}, the columns each
        row contributes, NaN left out."""
        out = {}
        for i, (j, ridx, col0) in enumerate(self.row_meta):
            if j != job_idx:
                continue
            e_lo, e_hi = self.rows[i][4], self.rows[i][5]
            p_row = pvals[i, e_lo:e_hi]
            keep = ~np.isnan(p_row)
            poss = np.arange(col0 + e_lo, col0 + e_hi)[keep]
            st = p_row[keep].astype(np.float64)
            if ridx in out:
                p0, s0 = out[ridx]
                out[ridx] = (np.concatenate([p0, poss]),
                             np.concatenate([s0, st]))
            else:
                out[ridx] = (poss, st)
        return out


# ---------------------------------------------------------------------------
# alternative-model log-likelihood ratios (reference:
# tombo/_c_helper.pyx:298 c_calc_llh_ratio_const_var, :313
# c_calc_scaled_llh_ratio_const_var; docs/modified_base_detection.rst:44-50)
# ---------------------------------------------------------------------------

def alt_llhr(means_w, ref_means_w, alt_means_w, const_var, standard: bool,
             scale: float, height: float, power: float,
             dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(H,) log-likelihood ratios of stacked (H, k) motif-hit windows,
    positive where the canonical base fits better.  ``standard``: the
    constant-variance ratio, sum (m - alt)^2 - (m - ref)^2 over the
    window, over the variance; else the outlier-robust scaled ratio, sum
    exp(-(m - ref)^2 / (s v)) - exp(-(m - alt)^2 / (s v)), times h v^p.
    Runs in ``dtype`` (default ``means_w``'s own)."""
    dt = dtype or means_w.dtype
    m, ref, alt = means_w.to(dt), ref_means_w.to(dt), alt_means_w.to(dt)
    cv = const_var.to(dt)
    if standard:
        return (torch.square(m - alt).sum(-1) -
                torch.square(m - ref).sum(-1)) / cv
    scale_var = cv[:, None] * scale
    coef = height * torch.pow(cv, power)
    return (torch.exp(-torch.square(m - ref) / scale_var) -
            torch.exp(-torch.square(m - alt) / scale_var)).sum(-1) * coef


# ---------------------------------------------------------------------------
# group (level) tests (reference: tombo/tombo_stats.py:4236-4334)
# ---------------------------------------------------------------------------

def _kolmogorov_sf(x: torch.Tensor) -> torch.Tensor:
    """The Kolmogorov distribution's survival function (scipy
    ``kstwobign.sf``): 2 sum_k (-1)^(k-1) exp(-2 k^2 x^2) above x = 1, one
    minus the Jacobi-theta form of the CDF at or below it, where that
    series converges slowly."""
    x = torch.clamp_min(x, 1e-8)
    k = torch.arange(1, 26, dtype=x.dtype, device=x.device)
    sign = torch.where(k % 2 == 1, torch.ones_like(k), -torch.ones_like(k))
    sf_big = 2.0 * torch.sum(
        sign * torch.exp(-2.0 * (k[None, :] * x[:, None]) ** 2), dim=1)
    j = torch.arange(1, 21, dtype=x.dtype, device=x.device)
    w = math.sqrt(2.0 * math.pi) / x
    cdf_small = w * torch.sum(torch.exp(
        -((2.0 * j[None, :] - 1.0) ** 2) * (math.pi ** 2) /
        (8.0 * x[:, None] ** 2)), dim=1)
    return torch.where(x > 1.0, sf_big, 1.0 - cdf_small)


def _sorted_valid(levels: torch.Tensor):
    """(P, C) NaN-padded levels sorted ascending with NaN as +inf, and the
    valid count of each site."""
    n = (~torch.isnan(levels)).sum(1)
    s = torch.sort(torch.where(torch.isnan(levels),
                               torch.full_like(levels, math.inf), levels),
                   dim=1).values
    return s, n


def ks_tests(samp: torch.Tensor, ctrl: torch.Tensor, return_stat: bool,
             dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Two-sample Kolmogorov-Smirnov test of each site over (P, C)
    NaN-padded sample and control level matrices: 1 - D, or the p-value
    (reference: tombo/tombo_stats.py:4236-4264)."""
    dt = dtype or samp.dtype
    s, sn = _sorted_valid(samp.to(dt))
    c, cn = _sorted_valid(ctrl.to(dt))
    allv = torch.cat([s, c], dim=1)
    # the +inf padding counts below a +inf query: cap at the valid count
    s_cdf = torch.minimum(torch.searchsorted(s, allv, right=True),
                          sn[:, None]).to(dt) / sn[:, None]
    c_cdf = torch.minimum(torch.searchsorted(c, allv, right=True),
                          cn[:, None]).to(dt) / cn[:, None]
    d = torch.where(torch.isfinite(allv), torch.abs(s_cdf - c_cdf),
                    torch.zeros_like(s_cdf)).amax(1)
    if return_stat:
        return 1.0 - d
    sn_f, cn_f = sn.to(dt), cn.to(dt)
    en = torch.sqrt(sn_f * cn_f / (sn_f + cn_f))
    return _kolmogorov_sf((en + 0.12 + 0.11 / en) * d)


def u_tests(samp: torch.Tensor, ctrl: torch.Tensor, return_stat: bool,
            dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Mann-Whitney U test of each site: the common-language effect
    deviation (u - mu) / mu, or the two-sided p-value (reference:
    tombo/tombo_stats.py:4266-4300).  Rank ties break with sample entries
    first, as the reference's stable ranks do: a left search of each
    sample level in the sorted control."""
    dt = dtype or samp.dtype
    s, sn = _sorted_valid(samp.to(dt))
    c, cn = _sorted_valid(ctrl.to(dt))
    below = torch.minimum(torch.searchsorted(c, s), cn[:, None]).to(dt)
    iot = torch.arange(s.shape[1], device=s.device)
    u1 = torch.where(iot[None, :] < sn[:, None], below,
                     torch.zeros_like(below)).sum(1)
    sn_f, cn_f = sn.to(dt), cn.to(dt)
    tot = sn_f * cn_f
    u = torch.minimum(u1, tot - u1)
    mu = tot / 2.0
    if return_stat:
        return (u - mu) / mu
    rhou = torch.sqrt(tot * (tot + 1.0) / 12.0)
    # ndtr(z) * 2 for z = (u - mu) / rhou <= 0, in the tail-safe form
    return _two_sided_p((mu - u) / rhou)


# iterations of the incomplete beta's continued fraction: at float64 it
# has converged to ~1e-11 relative by 32 for every degree of freedom to
# 100,000 (a t of 0 to 40); its rounding leaves ~4e-13 relative to df
# 5,000 and ~2e-12 at df 20,000
BETAINC_ITERS = 64


def _lgammacor(x: torch.Tensor) -> torch.Tensor:
    """lgamma(x) - ((x - 1/2) log x - x + log(2 pi) / 2) for x >= 10, by
    its Stirling series."""
    r = 1.0 / (x * x)
    s = 1.0 / 156.0
    for c in (-691.0 / 360360.0, 1.0 / 1188.0, -1.0 / 1680.0,
              1.0 / 1260.0, -1.0 / 360.0, 1.0 / 12.0):
        s = c + r * s
    return s / x


def _lbeta(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """log B(a, b), with the Stirling corrections where a or b is 10 or
    more, so a large argument loses no digits to the difference of two
    large lgammas (the algorithm of R's ``lbeta``)."""
    p, q = torch.minimum(a, b), torch.maximum(a, b)
    qb = torch.clamp_min(q, 10.0)
    pb = torch.clamp_min(p, 10.0)
    half_log_2pi = 0.5 * math.log(2.0 * math.pi)
    both = (-0.5 * torch.log(qb) + half_log_2pi + _lgammacor(pb) +
            _lgammacor(qb) - _lgammacor(pb + qb) +
            (pb - 0.5) * torch.log(pb / (pb + qb)) +
            qb * torch.log1p(-pb / (pb + qb)))
    one = (torch.lgamma(p) + _lgammacor(qb) - _lgammacor(p + qb) + p -
           p * torch.log(p + qb) + (qb - 0.5) * torch.log1p(-p / (p + qb)))
    neither = torch.lgamma(p) + torch.lgamma(q) - torch.lgamma(p + q)
    return torch.where(p >= 10.0, both,
                       torch.where(q >= 10.0, one, neither))


def betainc(a: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
            y: Optional[torch.Tensor] = None,
            n_iter: int = BETAINC_ITERS) -> torch.Tensor:
    """The regularized incomplete beta function I_x(a, b) (PyTorch has
    none): Lentz's continued fraction over a fixed ``n_iter`` steps, on
    I_y(b, a) = 1 - I_x(a, b) where x > (a + 1) / (a + b + 2), so the
    fraction always converges fast.  ``y``: 1 - x, where the caller has
    it with more digits than the subtraction gives."""
    if y is None:
        y = 1.0 - x
    tiny = 1e-30
    swap = x > (a + 1.0) / (a + b + 2.0)
    aa, bb = torch.where(swap, b, a), torch.where(swap, a, b)
    xx, yy = torch.where(swap, y, x), torch.where(swap, x, y)
    qab, qap, qam = aa + bb, aa + 1.0, aa - 1.0

    def off_zero(v):
        return torch.where(torch.abs(v) < tiny, torch.full_like(v, tiny), v)
    c = torch.ones_like(xx)
    d = 1.0 / off_zero(1.0 - qab * xx / qap)
    h = d
    for m in range(1, n_iter + 1):
        m2 = 2.0 * m
        for num in (m * (bb - m) * xx / ((qam + m2) * (aa + m2)),
                    -(aa + m) * (qab + m) * xx / ((aa + m2) * (qap + m2))):
            d = 1.0 / off_zero(1.0 + num * d)
            c = off_zero(1.0 + num / c)
            h = h * d * c
    # log x from 1 - x where x is near 1: a large a times log x keeps
    # its digits
    log_x = torch.where(xx > 0.5, torch.log1p(-yy), torch.log(xx))
    log_y = torch.where(yy > 0.5, torch.log1p(-xx), torch.log(yy))
    r = torch.exp(aa * log_x + bb * log_y - _lbeta(aa, bb)) / aa * h
    return torch.where(swap, 1.0 - r, r)


def t_tests(samp: torch.Tensor, ctrl: torch.Tensor, return_stat: bool,
            dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Two-sample t test of each site: minus Cohen's d, or the two-sided
    p-value of the pooled-variance t (reference:
    tombo/tombo_stats.py:4302-4334)."""
    dt = dtype or samp.dtype

    def moments(x):
        x = x.to(dt)
        ok = ~torch.isnan(x)
        n = ok.sum(1).to(dt)
        xz = torch.where(ok, x, torch.zeros_like(x))
        mean = xz.sum(1) / n
        var = torch.where(ok, (x - mean[:, None]) ** 2,
                          torch.zeros_like(x)).sum(1) / n
        return n, mean, torch.sqrt(var)
    sn, s_mean, s_sd = moments(samp)
    cn, c_mean, c_sd = moments(ctrl)
    if return_stat:
        return -torch.abs(s_mean - c_mean) / torch.sqrt(
            (s_sd ** 2 + c_sd ** 2) / 2.0)
    df = sn + cn - 2.0
    sp = torch.sqrt(((sn - 1.0) * s_sd ** 2 + (cn - 1.0) * c_sd ** 2) / df)
    t = -torch.abs(s_mean - c_mean) / (sp * torch.sqrt(1.0 / sn + 1.0 / cn))
    # t.cdf(t, df) for t <= 0 is I_x(df / 2, 1 / 2) / 2, x = df / (df +
    # t^2); 1 - x = t^2 / (df + t^2) keeps its digits for small t
    t2 = t * t
    return betainc(df / 2.0, torch.full_like(df, 0.5), df / (df + t2),
                   t2 / (df + t2))


def pad_levels_pair(samp: np.ndarray, ctrl: np.ndarray, cov_mult: int = 8):
    """The coverage axes of a (P, C) sample and control pair NaN-padded
    to one width, a multiple of ``cov_mult``."""
    C = _round_up(max(samp.shape[1], ctrl.shape[1], 1), cov_mult)

    def pad(x):
        if x.shape[1] == C:
            return x
        return np.pad(x, ((0, 0), (0, C - x.shape[1])),
                      constant_values=np.nan)
    return pad(samp), pad(ctrl)
