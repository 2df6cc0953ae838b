"""The plain reference re-squiggle: one read at a time, numpy, float64.

A frozen, self-contained copy of Tombo 1.5.1's default re-squiggle of one
read (tombo/resquiggle.py ``resquiggle_read`` and its retries,
tombo/_c_helper.pyx and tombo/_c_dynamic_programming.pyx as numpy), in
the form the repository's numpy one-read path wrote it down.  It imports
nothing of the program under test and reads only its inputs: the raw
signal, the read's position on the reference, the k-mer model file and
the configuration's parameters.

``Precision`` rounds every stored intermediate: ``F64`` keeps float64;
``BF16`` rounds each one to bfloat16 (8 significant bits, float32
accumulation), the lower-precision control that the benchmark's check
has to reject.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np

HALF_NORM_EXPECTED_VAL = 0.7978845608028654
MODELS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "models")


class ResquiggleFailure(Exception):
    """The read has no re-squiggle result; the message says why."""


class Precision:
    """Rounds arrays and scalars to the working precision."""

    def __init__(self, name: str):
        if name not in ("float64", "bfloat16"):
            raise ValueError("unknown precision %r" % name)
        self.name = name

    def q(self, x):
        if self.name == "float64":
            return x
        a = np.asarray(x, dtype=np.float64)
        f = a.astype(np.float32)
        b = f.view(np.uint32).astype(np.uint64)
        r = (((b + 0x7FFF + ((b >> 16) & 1)) >> 16) << 16).astype(np.uint32)
        out = np.where(np.isfinite(f), r.view(np.float32), f).astype(
            np.float64)
        return float(out) if np.ndim(x) == 0 else out


F64 = Precision("float64")
BF16 = Precision("bfloat16")


@dataclasses.dataclass(frozen=True)
class Params:
    """The re-squiggle parameters of one sample type (Tombo's
    ``SEG_PARAMS_TABLE`` and ``ALGN_PARAMS_TABLE`` and the constants of
    tombo/_default_parameters.py), as a configuration file states them."""
    running_stat_width: int
    min_obs_per_base: int
    raw_min_obs_per_base: int
    mean_obs_per_event: int
    match_evalue: float
    skip_pen: float
    bandwidth: int
    save_bandwidth: int
    max_half_z_score: float
    band_bound_thresh: int
    start_bw: int
    start_save_bw: int
    start_n_bases: int
    use_t_test_seg: bool
    sig_match_thresh: float
    outlier_thresh: float
    mask_bases: int
    mask_fill_z_score: float
    shift_change_thresh: float
    scale_change_thresh: float
    max_scaling_iters: int
    max_points_for_theil_sen: int
    extra_sig_factor: float
    del_fix_window: int
    max_del_fix_window: int
    max_raw_cpts: int
    min_event_to_seq_ratio: float
    collapse_stalls: bool
    stall_window_size: int
    stall_threshold: float
    stall_edge_buffer: int
    stall_min_consecutive_obs: int
    stall_n_windows: int
    stall_mini_window_size: int
    rna_scale_num_events: int
    rna_scale_max_frac_events: float

    @property
    def z_shift(self) -> float:
        return HALF_NORM_EXPECTED_VAL + self.match_evalue

    @property
    def stay_pen(self) -> float:
        return self.match_evalue

    @classmethod
    def from_dict(cls, d: dict) -> "Params":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


class KmerModel:
    """Expected level and SD of each k-mer (base-4 codes, first base most
    significant), read from a model file."""

    def __init__(self, fn: str):
        with np.load(fn, allow_pickle=False) as d:
            self.means = np.asarray(d["means"], np.float64)
            self.sds = np.asarray(d["sds"], np.float64)
            self.central_pos = int(d["central_pos"])
        self.kmer_width = int(round(np.log(self.means.shape[0]) / np.log(4)))

    def levels(self, seq: str) -> Tuple[np.ndarray, np.ndarray]:
        lut = np.full(256, -1, np.int64)
        for i, b in enumerate(b"ACGT"):
            lut[b] = i
        codes_1 = lut[np.frombuffer(seq.encode(), np.uint8)]
        if np.any(codes_1 < 0):
            raise ResquiggleFailure(
                "Invalid sequence encountered from genome sequence.")
        n = codes_1.shape[0] - self.kmer_width + 1
        codes = np.zeros(max(n, 0), np.int64)
        for j in range(self.kmer_width):
            codes = codes * 4 + codes_1[j:j + n]
        return self.means[codes], self.sds[codes]


_COMP = str.maketrans("ACGTNacgtn", "TGCANtgcan")


def rev_comp(seq: str) -> str:
    return seq.translate(_COMP)[::-1]


@dataclasses.dataclass
class ScaleValues:
    shift: float
    scale: float
    lower_lim: Optional[float]
    upper_lim: Optional[float]


@dataclasses.dataclass
class Result:
    """One read's re-squiggle: the raw-signal start of the first base, the
    segment boundaries relative to it, the fitted shift and scale, the
    signal matching score and the number of bases assigned."""
    start: int
    segs: np.ndarray
    shift: float
    scale: float
    score: float
    n_bases: int
    norm_params_changed: bool = False


# ------------------------------------------------------------ input prep
def genome_seq(ref: str, strand: str, start: int, end: int,
               model: KmerModel) -> str:
    """The mapped span with the k-mer context on both sides, in read
    orientation (tombo/resquiggle.py:1344-1358; start-clip bases off)."""
    cp = model.central_pos
    dn = model.kmer_width - cp - 1
    if strand == "+":
        s0, e0 = max(start, cp) - cp, end + dn
        return ref[s0:e0]
    s0, e0 = max(start, dn) - dn, end + cp
    return rev_comp(ref[s0:e0])


def identify_stalls(x: np.ndarray, p: Params) -> list:
    """Pore-stall intervals by the running mean-difference method
    (tombo/tombo_stats.py:269 ``identify_stalls``)."""
    w, mw, nw = p.stall_window_size, p.stall_mini_window_size, \
        p.stall_n_windows
    if x.shape[0] < w:
        return []
    metric = np.full(x.shape, np.nan)
    start_offset = int(w * 0.5)
    end_offset = x.shape[0] - w + start_offset + 1
    ma = np.cumsum(np.asarray(x, np.float64))
    ma[mw:] = ma[mw:] - ma[:-mw]
    ma = ma[mw - 1:] / mw
    offsets = [ma[int(mw * off):int(-mw * (nw - off - 1))]
               for off in range(nw - 1)] + [ma[int(mw * (nw - 1)):]]
    diffs = [np.abs(offsets[i] - offsets[j])
             for i in range(nw) for j in range(i + 1, nw)]
    diff_sums = diffs[0].copy()
    for d in diffs:
        diff_sums += d
    metric[start_offset:end_offset] = diff_sums / len(diffs)
    with np.errstate(invalid="ignore"):
        below = metric <= p.stall_threshold
    locs = np.where(np.diff(np.concatenate([[False], below])))[0]
    if below[-1]:
        locs = np.concatenate([locs, [metric.shape[0]]])
    locs = locs.reshape(-1, 2)
    locs = locs[(np.diff(locs) > p.stall_min_consecutive_obs).flatten()]
    if locs.shape[0] == 0:
        return []
    expand = (w // 2) - p.stall_edge_buffer
    if expand > 0:
        locs[:, 0] -= expand
        locs[:, 1] += expand
        merged, prev = [], locs[0]
        for curr in locs:
            if curr[0] > prev[1]:
                merged.append(prev)
                prev = curr
            else:
                prev[1] = curr[1]
        merged.append(prev)
        locs = merged
    return [(int(a), int(b)) for a, b in locs]


# ---------------------------------------------------- segmentation parts
def new_means(sig: np.ndarray, segs: np.ndarray, pr: Precision):
    cs = np.concatenate([[0.0], np.cumsum(sig)])
    return pr.q((cs[segs[1:]] - cs[segs[:-1]]) / np.diff(segs))


def cpt_scores_diff(x: np.ndarray, w: int) -> np.ndarray:
    cs = np.concatenate([[0.0], np.cumsum(x)])
    return np.abs(2.0 * cs[w:-w] - cs[:-2 * w] - cs[2 * w:])


def cpt_scores_t_test(x: np.ndarray, w: int) -> np.ndarray:
    n = x.shape[0] - 2 * w
    if n <= 0:
        return np.empty(0)
    cs = np.concatenate([[0.0], np.cumsum(x)])
    cs2 = np.concatenate([[0.0], np.cumsum(x ** 2)])

    def stats(off):
        s = cs[off + w:off + w + n] - cs[off:off + n]
        s2 = cs2[off + w:off + w + n] - cs2[off:off + n]
        return s / w, s2 - (s * s) / w

    m1, ss1 = stats(0)
    m2, ss2 = stats(w)
    den = ss1 + ss2
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.abs(m1 - m2) / np.sqrt(den)
    t[den == 0] = 0.0
    return t


def greedy_cpts(scores: np.ndarray, min_base_obs: int, w: int,
                num_cpts: int) -> np.ndarray:
    """The top ``num_cpts`` candidates in descending score order, each
    blacklisting its neighbourhood, sorted and shifted by ``w``
    (tombo/_c_helper.pyx:89-120)."""
    order = np.argsort(scores, kind="stable")[::-1]
    if num_cpts <= 0:
        return np.empty(0, np.int64)
    accepted = np.empty(num_cpts, np.int64)
    black = np.zeros(scores.shape[0] + 2 * min_base_obs, dtype=bool)
    n = 0
    for cand in order.tolist():
        if black[cand + min_base_obs]:
            continue
        accepted[n] = cand
        n += 1
        if n == num_cpts:
            accepted.sort()
            return accepted + w
        black[cand + 1:cand + 2 * min_base_obs] = True
    raise ResquiggleFailure("Fewer changepoints found than requested")


def normalize(raw: np.ndarray, sv: Optional[ScaleValues], p: Params,
              pr: Precision) -> Tuple[np.ndarray, ScaleValues]:
    """Median/MAD normalization with the outlier clip, or the given scale
    values and their clip (tombo/tombo_stats.py:482-573)."""
    if sv is None:
        shift = float(np.median(raw))
        scale = float(np.median(np.abs(raw - shift)))
        norm = pr.q((raw - shift) / scale)
        med = np.median(norm)
        mad = np.median(np.abs(norm - med))
        lo, hi = med - mad * p.outlier_thresh, med + mad * p.outlier_thresh
    else:
        shift, scale, lo, hi = sv.shift, sv.scale, sv.lower_lim, sv.upper_lim
        norm = pr.q((raw - shift) / scale)
    if lo is not None and hi is not None:
        norm = np.clip(norm, lo, hi)
    return norm, ScaleValues(shift, scale, lo, hi)


def segment(raw: np.ndarray, stalls: list, sv: Optional[ScaleValues],
            num_events: int, p: Params, pr: Precision):
    """Changepoints, the normalized signal and its scale values
    (tombo/resquiggle.py:1057-1120)."""
    if p.use_t_test_seg:
        cpts = greedy_cpts(pr.q(cpt_scores_t_test(raw, p.running_stat_width)),
                           p.min_obs_per_base, p.running_stat_width,
                           num_events)
        if stalls:
            keep = np.ones(cpts.shape[0], dtype=bool)
            for a, b in stalls:
                keep &= ~((cpts > a) & (cpts < b))
            cpts = cpts[keep]
        if sv is None:
            n_ev = p.rna_scale_num_events
            if cpts.shape[0] * p.rna_scale_max_frac_events < n_ev:
                n_ev = int(cpts.shape[0] * p.rna_scale_max_frac_events)
            ev = new_means(raw, cpts[:n_ev], pr)
            med = float(np.median(ev))
            mad = float(np.median(np.abs(ev - med)))
            sv = ScaleValues(med, mad, -p.outlier_thresh, p.outlier_thresh)
        norm, sv = normalize(raw, sv, p, pr)
        return cpts, norm, sv
    norm, sv = normalize(raw, sv, p, pr)
    cpts = greedy_cpts(pr.q(cpt_scores_diff(norm, p.running_stat_width)),
                       p.min_obs_per_base, p.running_stat_width, num_events)
    if stalls:
        keep = np.ones(cpts.shape[0], dtype=bool)
        for a, b in stalls:
            keep &= ~((cpts > a) & (cpts < b))
        cpts = cpts[keep]
    return cpts, norm, sv


# ------------------------------------------------------ banded DP parts
def band_row(prev_fwd, z, first_val, first_move, stay_pen, skip_pen,
             diff, pr: Precision):
    """One row of the banded DP: stay, skip and diagonal moves over the
    band (tombo/_c_dynamic_programming.pyx:202-236), as a max-plus prefix
    scan; move codes 0 stay, 1 skip, 2 diagonal."""
    bw = z.shape[0]
    pb = np.arange(bw) + diff
    di = pb - 1
    diag = np.where((di >= 0) & (di < bw), prev_fwd[np.clip(di, 0, bw - 1)],
                    -np.inf) + z
    skip = np.where(pb < bw, prev_fwd[np.clip(pb, 0, bw - 1)],
                    -np.inf) - skip_pen
    d = np.maximum(diag, skip)
    s = z - stay_pen
    c = pr.q(np.concatenate([[0.0], np.cumsum(s[1:])]))
    u = d - c
    u[0] = first_val
    fwd = pr.q(c + np.maximum.accumulate(u))
    stay = np.empty(bw)
    stay[0] = -np.inf
    stay[1:] = fwd[:-1] - stay_pen + z[1:]
    moves = np.zeros(bw, np.int8)
    moves[diag > stay] = 2
    moves[skip > np.maximum(stay, diag)] = 1
    moves[0] = first_move
    fwd[0] = first_val
    return fwd, moves


def banded_forward(z_rows, starts, p: Params, pr: Precision):
    n, bw = z_rows.shape
    fwd = np.empty((n + 1, bw))
    tb = np.zeros((n + 1, bw), np.int8)
    fwd[0] = 0.0
    for r in range(n):
        diff = starts[r] - starts[r - 1] if r > 0 else 0
        if diff == 0:
            fv, fm = fwd[r, 0] - p.skip_pen, 1
        else:
            fv, fm = pr.q(fwd[r, diff - 1] + z_rows[r, 0]), 2
        fwd[r + 1], tb[r + 1] = band_row(fwd[r], z_rows[r], fv, fm,
                                         p.stay_pen, p.skip_pen, diff, pr)
    return fwd, tb


def traceback(tb, starts, band_pos, bound_thresh=-1):
    n = tb.shape[0] - 1
    bw = tb.shape[1]
    out = np.empty(n + 1, np.int64)
    ev = band_pos + starts[n - 1]
    out[n] = ev + 1
    for r in range(n, 0, -1):
        bp = ev - starts[r - 1]
        while tb[r, bp] == 0:
            bp -= 1
        if tb[r, bp] == 2:
            bp -= 1
        if bound_thresh >= 0 and min(bp, bw - bp - 1) < bound_thresh:
            raise ResquiggleFailure(
                "Read event to sequence alignment extends beyond bandwidth")
        ev = starts[r - 1] + bp
        out[r - 1] = ev + 1
    return out


def half_z(x, mean, sd, p: Params, pr: Precision):
    return pr.q(p.z_shift - np.minimum(np.abs((x - mean) / sd),
                                       p.max_half_z_score))


def seg_score(means, rm, rs, pr: Precision) -> float:
    return float(pr.q(np.mean(np.abs((means - rm) / rs))))


def score_valid_bases(read_tb, em, rm, rs, pr: Precision) -> float:
    valid = np.where(np.diff(read_tb) != 0)[0]
    if valid.shape[0] == 0:
        raise ResquiggleFailure("Invalid path through read start")
    means = np.array([em[s:e].mean() for s, e in
                      zip(read_tb[:-1], read_tb[1:]) if s != e])
    return seg_score(means, rm[valid], rs[valid], pr)


def find_start(em, rm, rs, p: Params, num_bases, num_events, check,
               pr: Precision):
    """The sequence start within the events: a static-band DP over the
    first ``num_bases`` (tombo/resquiggle.py:685-752)."""
    if em.shape[0] < num_events + num_bases:
        raise ResquiggleFailure("Read too short for start/end discovery")
    if rm.shape[0] < num_bases:
        raise ResquiggleFailure(
            "Genomic mapping too short for start/end discovery")
    z = np.empty((num_bases, num_events))
    for pos in range(num_bases):
        z[pos] = half_z(em[pos:pos + num_events], rm[pos], rs[pos], p, pr)
    starts = np.arange(num_bases, dtype=np.int64)
    fwd, tb = banded_forward(z, starts, p, pr)
    start_tb = traceback(tb, starts, int(np.argmax(fwd[-1])))
    if check and score_valid_bases(start_tb, em, rm, rs, pr) > \
            p.sig_match_thresh:
        raise ResquiggleFailure(
            "Poor raw to expected signal matching in beginning of read.")
    return int(start_tb[0]), (start_tb[-1] - start_tb[0]) / len(start_tb)


def static_assignment(em, rm, rs, p: Params, pr: Precision):
    """Short reads: one static band over all events
    (tombo/resquiggle.py:547-600)."""
    seq_len, ev_len = rm.shape[0], em.shape[0]
    mask_len = min(seq_len, ev_len) // 4
    starts = np.concatenate([np.zeros(seq_len - mask_len * 2),
                             np.linspace(0, mask_len, mask_len * 2)]
                            ).astype(np.int64)
    bw = ev_len - mask_len
    z = np.empty((starts.shape[0], bw))
    for r, e0 in enumerate(starts):
        z[r] = half_z(em[e0:e0 + bw], rm[r], rs[r], p, pr)
    fwd, tb = banded_forward(z, starts, p, pr)
    return traceback(tb, starts, int(np.argmax(fwd[-1])))


def adaptive_forward(fwd, tb, starts, em, rm, rs, p: Params, first_row,
                     pr: Precision):
    """The adaptive band: each row's band starts at the previous row's
    argmax less half the band (tombo/_c_dynamic_programming.pyx:314)."""
    n = fwd.shape[0] - 1
    bw = fwd.shape[1]
    hb = bw // 2
    n_ev = em.shape[0]
    for r in range(first_row, n):
        prev = starts[r - 1]
        cur = prev + int(np.argmax(fwd[r])) - hb + 1
        if cur < prev:
            cur = prev
        if cur >= n_ev:
            if r < n - 2:
                raise ResquiggleFailure(
                    "Adaptive signal to sequence alignment extended beyond "
                    "raw signal")
            cur = n_ev - 1
        starts[r] = cur
        nv = min(bw, n_ev - cur)
        z = np.full(bw, p.mask_fill_z_score)
        z[:nv] = half_z(em[cur:cur + nv], rm[r], rs[r], p, pr)
        diff = cur - prev
        if diff == 0:
            fv, fm = fwd[r, 0] - p.skip_pen, 1
        else:
            fv, fm = pr.q(fwd[r, diff - 1] + z[0]), 2
        fwd[r + 1], tb[r + 1] = band_row(fwd[r], z, fv, fm, p.stay_pen,
                                         p.skip_pen, diff, pr)


def masked_start_forward(em, rm, rs, offset, p: Params, epb, pr: Precision):
    """The first rows of the adaptive DP: a static band whose first
    ``mask_bases`` rows may not start before the mapped start
    (tombo/resquiggle.py:607-683)."""
    n_ev = em.shape[0]
    bw = p.bandwidth
    if n_ev - offset < bw:
        raise ResquiggleFailure(
            "Read sequence to signal matching starts too far into events "
            "for full adaptive assignment")
    hb = bw // 2
    first = 0 if hb <= offset else offset - hb
    tmp_len = max(hb, p.mask_bases, int((hb + 1) / epb)) + 1
    starts = np.linspace(first, first + tmp_len * epb, tmp_len).astype(
        np.int64)
    hit = int(np.argmax(starts >= offset))
    starts = starts[:max(p.mask_bases, hit + 2)]
    mask_pos = np.linspace(offset + 1, starts[p.mask_bases - 1] + bw,
                           p.mask_bases).astype(np.int64)
    row_end = np.full(starts.shape[0], np.int64(n_ev))
    row_end[:p.mask_bases] = np.minimum(mask_pos, n_ev)
    z = np.empty((starts.shape[0], bw))
    for r in range(starts.shape[0]):
        pos = starts[r] + np.arange(bw)
        rz = half_z(em[np.clip(pos, 0, n_ev - 1)], rm[r], rs[r], p, pr)
        rz[(pos < offset) | (pos >= row_end[r])] = p.mask_fill_z_score
        z[r] = rz
    fwd, tb = banded_forward(z, starts, p, pr)
    return fwd, tb, starts


def assign_bases(cpts, em, p: Params, rm, rs, pr: Precision):
    """Event boundaries of each base: start discovery, then the adaptive
    banded DP, or the static band for short reads
    (tombo/resquiggle.py:866-1050).  Returns (segs, start)."""
    seq_len = rm.shape[0]

    def short():
        ev = static_assignment(em, rm, rs, p, pr)
        segs = cpts[ev]
        return segs - segs[0], int(segs[0])

    if em.shape[0] < p.start_bw + p.start_n_bases or \
            seq_len < p.start_n_bases:
        return short()
    try:
        mapped, epb = find_start(em, rm, rs, p, p.start_n_bases, p.start_bw,
                                 True, pr)
    except ResquiggleFailure:
        if em.shape[0] < p.start_save_bw + p.start_n_bases:
            return short()
        mapped, epb = find_start(em, rm, rs, p, p.start_n_bases,
                                 p.start_save_bw, False, pr)
    if epb == 0:
        raise ResquiggleFailure(
            "Very poor signal quality. Read likely includes open pore.")
    hb = p.bandwidth // 2
    if mapped < hb:
        clip, offset = 0, mapped
    else:
        clip, offset = mapped - hb, hb
    if (int((hb + 1) / epb) >= seq_len or
            em.shape[0] - offset - clip < p.bandwidth):
        return short()
    cem = em[clip:]
    sfwd, stb, sstarts = masked_start_forward(cem, rm, rs, offset, p, epb,
                                              pr)
    n0 = sstarts.shape[0]
    fwd = np.empty((seq_len + 1, p.bandwidth))
    fwd[:n0 + 1] = sfwd
    tb = np.zeros((seq_len + 1, p.bandwidth), np.int8)
    tb[:n0 + 1] = stb
    starts = np.empty(seq_len, np.int64)
    starts[:n0] = sstarts
    adaptive_forward(fwd, tb, starts, cem, rm, rs, p, n0, pr)
    read_tb = traceback(tb, starts, int(np.argmax(fwd[-1])),
                        p.band_bound_thresh)
    ev_len = em.shape[0] - clip
    i = 0
    while read_tb[i] < 0:
        read_tb[i] = 0
        i += 1
    j = 1
    while read_tb[-j] > ev_len:
        read_tb[-j] = ev_len
        j += 1
    segs = cpts[clip:][read_tb]
    return segs - segs[0], int(segs[0])


# ---------------------------------------------------- the deletion fix
def del_fix_windows(segs, p: Params):
    """Windows of bases around zero-length segments, merged and grown
    until each holds enough signal (tombo/resquiggle.py:402-480)."""
    def merge(ws):
        out = []
        for s, e in ws:
            if out and s < out[-1][1]:
                out[-1] = (out[-1][0], e)
            else:
                out.append((s, e))
        return out

    def too_small(s, e):
        return segs[e] - segs[s] <= ((e - s + 1) * p.raw_min_obs_per_base) \
            * p.extra_sig_factor

    def trim(ws):
        if ws[0][0] < 0:
            ws[0] = (0, ws[0][1])
        if ws[-1][1] > len(segs) - 1:
            ws[-1] = (ws[-1][0], len(segs) - 1)
        return ws

    ws = []
    for d in np.where(np.diff(segs) == 0)[0]:
        if ws and d < ws[-1][1] + p.del_fix_window:
            ws[-1] = (ws[-1][0], d + p.del_fix_window + 1)
        else:
            ws.append((d - p.del_fix_window, d + p.del_fix_window + 1))
    if not ws:
        return []
    grown = False
    ws = trim(merge(ws))
    for _ in range(p.max_del_fix_window - p.del_fix_window):
        out, grown = [], False
        for s, e in ws:
            if too_small(s, e):
                grown = True
                s, e = s - 1, e + 1
            out.append((s, e))
        ws = out
        if not grown:
            break
        ws = trim(merge(ws))
    if grown and any(too_small(s, e) for s, e in ws):
        raise ResquiggleFailure(
            "Not enough raw signal around potential genomic deletion(s)")
    if max(e - s for s, e in ws) > p.max_raw_cpts:
        raise ResquiggleFailure(
            "Read contains too many potential genomic deletions")
    return ws


def raw_window_dp(sig, rm, rs, n_bases, p: Params, pr: Precision):
    """Raw-signal DP of one window: each base at least
    ``raw_min_obs_per_base`` samples (tombo/_c_dynamic_programming.pyx
    :34-183, tombo/resquiggle.py:345-400).  Returns the inner boundaries
    relative to the window's start."""
    mo = p.raw_min_obs_per_base
    b_starts = np.linspace(0, sig.shape[0], n_bases + 1, dtype=np.int64)
    s_starts, s_ends = np.empty(n_bases, np.int64), np.empty(n_bases,
                                                              np.int64)
    prev = None
    for i in range(n_bases):
        b = b_starts[max(0, i - n_bases)]
        if prev is not None and b < prev + mo:
            b = prev + mo
        s_starts[i] = prev = b
    prev = None
    for i in range(n_bases - 1, -1, -1):
        b = b_starts[min(n_bases, i + n_bases + 1)]
        if prev is not None and b > prev - mo:
            b = prev - mo
        s_ends[i] = prev = b
    zs = []
    for i in range(n_bases):
        z = -np.abs((sig[s_starts[i]:s_ends[i]] - rm[i]) / rs[i])
        zs.append((pr.q(np.maximum(z, -p.max_half_z_score)),
                   int(s_starts[i]), int(s_ends[i])))

    data, st, en = zs[0]
    fwd_d = pr.q(np.cumsum(data))
    last = np.full(en - st, mo, np.int64)
    rows = [(fwd_d, st, en)]
    for b_data, b0, b1 in zs[1:]:
        pcs = np.cumsum(data)
        bf = np.empty(b1 - b0)
        bl = np.empty(b1 - b0, np.int64)
        bf[0] = b_data[0] + fwd_d[b0 - st - 1]
        bl[0] = 1
        for pos in range(b0 + 1, en + 1):
            lag = 1
            while last[pos - st - lag] + lag <= mo:
                lag += 1
            dsc = fwd_d[pos - st - lag]
            if lag > 1:
                dsc += pcs[pos - st - 1] - pcs[pos - st - lag]
            ssc = bf[pos - b0 - 1]
            if dsc > ssc:
                psc, pd = dsc, 1
            else:
                psc, pd = ssc, bl[pos - b0 - 1] + 1
            bf[pos - b0] = b_data[pos - b0] + psc
            bl[pos - b0] = pd
        if b1 > en + 1:
            k = en - b0
            fv, ld = bf[k], bl[k]
            for i in range(k + 1, b1 - b0):
                fv += b_data[i]
                ld += 1
                bf[i] = fv
                bl[i] = ld
        bf = pr.q(bf)
        rows.append((bf, b0, b1))
        data, fwd_d, st, en, last = b_data, bf, b0, b1, bl

    def back(cur, cur_start, nxt, nxt_start, nxt_end, sig_start):
        n_sig = 1
        for sp in range(sig_start, -1, -1):
            n_sig += 1
            if n_sig <= mo or sp - 1 >= nxt_end:
                continue
            if sp <= cur_start or nxt[sp - nxt_start - 1] > \
                    cur[sp - cur_start - 1]:
                return sp
        raise ResquiggleFailure("Raw-signal traceback failed to find boundary")

    out = np.empty(n_bases - 1, np.int64)
    cur, cs, ce = rows[-1]
    nxt, ns, ne = rows[-2]
    out[-1] = back(cur, cs, nxt, ns, ne, ce - 1)
    for b in range(n_bases - 3, -1, -1):
        cur, cs = nxt, ns
        nxt, ns, ne = rows[b]
        out[b] = back(cur, cs, nxt, ns, ne, out[b + 1] - 1)
    return out


def fix_deletions(segs, norm, rm, rs, p: Params, pr: Precision):
    ws = del_fix_windows(segs, p)
    if not ws:
        return segs.copy()
    out = segs.copy()
    for s, e in ws:
        inner = raw_window_dp(norm[segs[s]:segs[e]], rm[s:e], rs[s:e], e - s,
                              p, pr)
        out[s + 1:e] = inner + segs[s]
    if np.diff(out).min() < 1:
        raise ResquiggleFailure("New segments include zero length events")
    if out[0] < 0:
        raise ResquiggleFailure("New segments start with negative index")
    if out[-1] > norm.shape[0]:
        raise ResquiggleFailure("New segments end past raw signal values")
    return out


# ------------------------------------------------------------ the fit
def theil_sen(ev, mod, p: Params, pr: Precision):
    """Theil-Sen line of the model levels on the event means, on a fixed
    draw of ``max_points_for_theil_sen`` points above that many
    (tombo/tombo_stats.py:370-450).  Returns (shift, scale) corrections."""
    n = mod.shape[0]
    if n > p.max_points_for_theil_sen:
        samp = np.random.default_rng(0).choice(
            n, p.max_points_for_theil_sen, replace=False)
        ev, mod = ev[samp], mod[samp]
    iu = np.triu_indices(ev.shape[0], k=1)
    de = ev[iu[0]] - ev[iu[1]]
    dm = mod[iu[0]] - mod[iu[1]]
    with np.errstate(divide="ignore", invalid="ignore"):
        slopes = pr.q(dm / de)
    slopes[de == 0] = 1000.0
    slope = float(pr.q(np.median(slopes)))
    inter = float(pr.q(np.median(mod - slope * ev)))
    if slope == 0:
        raise ResquiggleFailure(
            "Read failed sequence-based signal re-scaling parameter "
            "estimation.")
    return pr.q(-inter / slope), pr.q(1.0 / slope)


# ------------------------------------------------------------ one read
def resquiggle_pass(raw, stalls, gseq, sv, model: KmerModel, p: Params,
                    pr: Precision) -> Tuple[Result, ScaleValues]:
    """One pass of the re-squiggle (tombo/resquiggle.py:1122-1214)."""
    k = model.kmer_width
    n_mapped = len(gseq) - k + 1
    num_events = max(raw.shape[0] // p.mean_obs_per_event,
                     int(n_mapped * p.min_event_to_seq_ratio))
    if num_events / p.bandwidth > n_mapped:
        raise ResquiggleFailure("Too much raw signal for mapped sequence")
    cpts, norm, sv = segment(raw, stalls, sv, num_events, p, pr)
    em = new_means(norm, cpts, pr)
    rm, rs = model.levels(gseq)
    dn = k - model.central_pos - 1
    seq = gseq[model.central_pos:len(gseq) - dn]
    if len(seq) != rm.shape[0]:
        raise ResquiggleFailure("Discordant reference and sequence lengths.")
    segs, start = assign_bases(cpts, em, p, rm, rs, pr)
    norm = norm[start:start + segs[-1]]
    segs = fix_deletions(segs, norm, rm, rs, p, pr)
    shc, scc = theil_sen(new_means(norm, segs, pr), rm, p, pr)
    sv = ScaleValues(float(pr.q(sv.shift + shc * sv.scale)),
                     float(pr.q(sv.scale * scc)), sv.lower_lim, sv.upper_lim)
    norm = pr.q((norm - shc) / scc)
    changed = bool(abs(shc) > p.shift_change_thresh or
                   abs(scc - 1) > p.scale_change_thresh)
    score = seg_score(new_means(norm, segs, pr), rm, rs, pr)
    if segs.shape[0] != len(seq) + 1:
        raise ResquiggleFailure(
            "Aligned sequence does not match number of segments produced")
    return Result(start, segs, sv.shift, sv.scale, score, len(seq),
                  changed), sv


def resquiggle(raw: np.ndarray, ref: str, strand: str, start: int, end: int,
               model: KmerModel, p: Params, rna: bool,
               pr: Precision = F64) -> Result:
    """Re-squiggle one read from its raw signal as the sequencer gave it
    (3' to 5' for direct RNA) and its mapped span ``[start, end)`` of
    ``ref`` on ``strand``: the scaling iterations at the bandwidth, then,
    if they fail, again at the save bandwidth
    (tombo/resquiggle.py:1488-1600)."""
    raw = np.asarray(raw, np.float64)
    if rna:
        raw = raw[::-1].copy()
    stalls = identify_stalls(raw, p) if p.collapse_stalls else []
    gseq = genome_seq(ref, strand, start, end, model)

    def run(pp: Params) -> Result:
        res, sv = resquiggle_pass(raw, stalls, gseq, None, model, pp, pr)
        n = 1
        while n < pp.max_scaling_iters and res.norm_params_changed:
            res, sv = resquiggle_pass(raw, stalls, gseq, sv, model, pp, pr)
            n += 1
        return res

    try:
        return run(p)
    except ResquiggleFailure:
        return run(dataclasses.replace(p, bandwidth=p.save_bandwidth))


def resquiggle_job(job) -> Tuple[Optional[Result], Optional[str]]:
    """A worker's entry: ``job`` = (raw, ref, strand, start, end, model
    file, parameter dict, rna, precision name).  Returns (result, None) or
    (None, the failure's message)."""
    raw, ref, strand, start, end, model_fn, pdict, rna, prec = job
    model = _model(model_fn)
    try:
        return resquiggle(raw, ref, strand, start, end, model,
                          Params.from_dict(pdict), rna,
                          Precision(prec)), None
    except ResquiggleFailure as e:
        return None, str(e)


_MODELS = {}


def _model(fn: str) -> KmerModel:
    if fn not in _MODELS:
        _MODELS[fn] = KmerModel(os.path.join(MODELS_DIR, fn))
    return _MODELS[fn]
