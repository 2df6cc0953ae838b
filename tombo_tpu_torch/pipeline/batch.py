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
beyond the device caps) finish in numpy.  The PyTorch-side parts are plain
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
"""
from __future__ import annotations

import types as _pytypes
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import config
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
from ..seq import encode_seq, seq_to_kmer_codes
from ..stats import device_levels
from ..types import DpResults, ResquiggleResults, ScaleValues, SeqSampleType
from . import resquiggle as rsq

_GROUP_RATIO = 2.0      # max signal-length spread within a device group
_MIN_GROUP = 24         # don't cut groups smaller than this

# deletion-fix windows beyond these route the read to the host lane
# (the reference errors out above MAX_RAW_CPTS=200 events)
_DELFIX_NB_CAP = 32
_DELFIX_T_CAP = 512


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


@dataclass
class _ReadState:
    """Per-read mutable state as it flows through the stages."""
    idx: int
    map_res: ResquiggleResults
    raw: np.ndarray
    num_events: int
    error: Optional[str] = None
    scale_values: Optional[ScaleValues] = None
    cpts: Optional[np.ndarray] = None
    event_means: Optional[np.ndarray] = None
    ref_means: Optional[np.ndarray] = None
    ref_sds: Optional[np.ndarray] = None
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
    the trim."""
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
    return seq_segs, rsrtr, has_del


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
    tombo/resquiggle.py:1177)."""

    def __init__(self, std_ref, rsqgl_params: ResquiggleParams,
                 seq_samp_type: SeqSampleType,
                 outlier_thresh: Optional[float] = config.OUTLIER_THRESH,
                 dtype=None, device: DeviceLike = None, mesh=None,
                 const_scale=None, skip_seq_scaling: bool = False):
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

    # ------------------------------------------------------------ helpers
    def _t(self, arr, float_=False, device=None) -> torch.Tensor:
        arr = np.asarray(arr)
        if float_:
            arr = arr.astype(self.np_dtype)
        elif arr.dtype != np.bool_:
            arr = arr.astype(np.int64)
        return torch.as_tensor(arr).to(device or self.device)

    def _levels(self, live, width: int, clip: bool = False, device=None):
        """(B, width) expected means and sds, padded with 1.0; ``clip``
        crops each read to ``width`` (reads shorter than ``width`` become
        all-padding rows)."""
        rm = np.ones((len(live), width))
        rs = np.ones((len(live), width))
        for i, s in enumerate(live):
            n = s.ref_means.shape[0]
            if clip:
                if n >= width:
                    rm[i], rs[i] = s.ref_means[:width], s.ref_sds[:width]
            else:
                m = min(n, width)
                rm[i, :m], rs[i, :m] = s.ref_means[:m], s.ref_sds[:m]
        return self._t(rm, True, device), self._t(rs, True, device)

    def _start_params(self, num_events: int) -> StartDpParams:
        p = self.params
        return StartDpParams(
            z_shift=p.z_shift, skip_pen=p.skip_pen, stay_pen=p.stay_pen,
            max_half_z_score=p.max_half_z_score or -1.0,
            num_bases=p.start_n_bases, num_events=num_events)

    @staticmethod
    def _np(*ts):
        return [t.cpu().numpy() for t in ts]

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
            s.map_res.scale_values is not None and s.cpts is not None
            for s in live)
        cpts_w = _pow2_bucket(max(
            s.cpts.shape[0] if rescale_pass else s.num_events
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

    def _segment_shard(self, live, dev, sig_w: int, cpts_w: int,
                       rescale_pass: bool, n_stalls: int):
        p = self.params
        B = len(live)
        sig_lens = np.array([s.raw.shape[0] for s in live], np.int64)
        raw_pad = np.zeros((B, sig_w), self.np_dtype)
        for i, s in enumerate(live):
            raw_pad[i, :s.raw.shape[0]] = s.raw
        raw_j = torch.as_tensor(raw_pad).to(dev)
        lens_j = self._t(sig_lens, device=dev)
        rm_sj, rs_sj = self._levels(live, p.start_n_bases, clip=True,
                                    device=dev)
        sp = self._start_params(p.start_bw)
        if rescale_pass:
            return self._segment_rescale(live, dev, raw_j, lens_j, rm_sj,
                                         rs_sj, sp, cpts_w)

        if p.use_t_test_seg:
            return self._segment_rna(live, dev, raw_j, lens_j, rm_sj, rs_sj,
                                     sp, cpts_w, n_stalls)
        w = p.running_stat_width
        num_cpts = np.array([s.num_events for s in live], np.int64)
        has_sv, sv_shift, sv_scale, sv_lower, sv_upper = self._given_sv(
            live, -nrm.POS_LARGE, nrm.POS_LARGE)
        t = lambda a, f=False: self._t(a, f, dev)
        (norm_j, em_j, cpts_j, status_j, shift, scale, lower, upper,
         start_segs_j, start_score_j) = _stage_a_dna(
            raw_j, lens_j, t(has_sv), t(sv_shift, True), t(sv_scale, True),
            t(sv_lower, True), t(sv_upper, True), t(num_cpts), rm_sj, rs_sj,
            (None if self.outlier_thresh is None
             else float(self.outlier_thresh)), w, p.min_obs_per_base,
            cpts_w, sp)
        (cpts_np, status, shift, scale, lower, upper, s0, sN,
         score) = self._np(cpts_j, status_j, shift, scale, lower, upper,
                           start_segs_j[:, 0], start_segs_j[:, -1],
                           start_score_j)
        for i, s in enumerate(live):
            if status[i] != 0:
                s.error = "Fewer changepoints found than requested"
                continue
            s.cpts = cpts_np[i, :s.num_events].astype(np.int64)
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
            raw_j, lens_j, t(has_sv), t(sv_shift, True), t(sv_scale, True),
            t(sv_lower, True), t(sv_upper, True), t(num_cpts), t(stall_s),
            t(stall_e), rm_sj, rs_sj,
            (None if self.outlier_thresh is None
             else float(self.outlier_thresh)), p.running_stat_width,
            p.min_obs_per_base, cpts_w, sp)
        (cpts_np, n_cpts, status, shift, scale, lower, upper, s0, sN,
         score) = self._np(cpts_j, n_cpts_j, status_j, shift, scale, lower,
                           upper, start_segs_j[:, 0], start_segs_j[:, -1],
                           start_score_j)
        lim = lambda v: None if np.isnan(v) else float(v)
        for i, s in enumerate(live):
            if status[i] != 0:
                s.error = "Fewer changepoints found than requested"
                continue
            s.cpts = cpts_np[i, :n_cpts[i]].astype(np.int64)
            s.n_ev = int(n_cpts[i]) - 1
            s.event_means = None
            s.scale_values = ScaleValues(float(shift[i]), float(scale[i]),
                                         lim(lower[i]), lim(upper[i]), None)
            if s.n_ev < p.start_bw + p.start_n_bases:
                s.use_static = True
        return {"em": em_j, "norm": norm_j, "cpts": cpts_j,
                "start": (s0.astype(np.int64), sN.astype(np.int64),
                          score.astype(np.float64))}

    def _segment_rescale(self, live, dev, raw_j, lens_j, rm_sj, rs_sj, sp,
                         cpts_w: int):
        """Rescale-pass segmentation reusing first-pass changepoints."""
        B = len(live)
        n_cpts = np.array([s.cpts.shape[0] for s in live], np.int64)
        cpts = np.zeros((B, cpts_w), np.int64)
        for i, s in enumerate(live):
            cpts[i, :n_cpts[i]] = s.cpts
        _, sv_shift, sv_scale, sv_lower, sv_upper = self._given_sv(
            live, np.nan, np.nan)
        t = lambda a, f=False: self._t(a, f, dev)
        cpts_j = t(cpts)
        norm_j, em_j, start_segs_j, start_score_j = _stage_a_rescale(
            raw_j, lens_j, t(sv_shift, True), t(sv_scale, True),
            t(sv_lower, True), t(sv_upper, True), cpts_j, t(n_cpts), rm_sj,
            rs_sj, sp)
        s0, sN, score = self._np(start_segs_j[:, 0], start_segs_j[:, -1],
                                 start_score_j)
        for i, s in enumerate(live):
            s.n_ev = int(n_cpts[i]) - 1
            s.event_means = None
            s.scale_values = s.map_res.scale_values.replace()
        return {"em": em_j, "norm": norm_j, "cpts": cpts_j,
                "start": (s0.astype(np.int64), sN.astype(np.int64),
                          score.astype(np.float64))}

    def _plan_reads(self, states: List[_ReadState]):
        """Expected levels + static-band routing."""
        p = self.params
        std_ref = self.std_ref
        k = std_ref.kmer_width
        dnstrm = k - std_ref.central_pos - 1
        for s in states:
            if s.error is not None:
                continue
            if s.ref_means is None:
                codes = seq_to_kmer_codes(encode_seq(s.map_res.genome_seq),
                                          k)
                if codes.shape[0] <= 0 or np.any(codes < 0):
                    s.error = ("Invalid sequence encountered from genome "
                               "sequence.")
                    continue
                s.ref_means = std_ref.means[codes]
                s.ref_sds = std_ref.sds[codes]
                s.genome_seq_trim = s.map_res.genome_seq[
                    std_ref.central_pos:-dnstrm]
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
            for d, reads in shards:
                dev = self.mesh[d]
                rows = self._t([s.dev_row for s in reads], device=dev)
                rm_sj, rs_sj = self._levels(reads, nb, clip=True, device=dev)
                segs, score = _start_dp_with_score(
                    ctx[d]["em"][rows][:, :need], rm_sj, rs_sj, sp)
                queued.append((reads, (segs[:, 0], segs[:, -1], score)))
            found = [(reads, self._np(*out)) for reads, out in queued]
        failed = []
        thresh = SIG_MATCH_THRESH[self.seq_samp_type.name]
        for reads, (seg0, segN, score) in found:
            for i, s in enumerate(reads):
                if check_score and (not np.isfinite(score[i]) or
                                    score[i] > thresh):
                    failed.append(s)
                    continue
                s.events_per_base = (int(segN[i]) - int(seg0[i])) / (nb + 1)
                s.mapped_start = int(seg0[i])
        return failed

    def _adaptive_batch(self, states: List[_ReadState], ctx):
        """Masked-start prefix + adaptive DP + traceback."""
        p = self.params
        live = []
        half_bw = p.bandwidth // 2
        for s in states:
            if s.error is not None or s.use_static:
                continue
            if s.events_per_base == 0:
                s.error = ("Very poor signal quality. Read likely includes "
                           "open pore.")
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
        L_max = _pow2_bucket(max(s.ref_means.shape[0] for s in live), 256)
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
        segs_j, band_err, bound_err, _ = \
            banded_dp.adaptive_banded_dp_tb_sharded(
                self.mesh, dp_args, dpp, L_max, P_max, p.band_bound_thresh,
                banded_dp.plan_dp_layout(L_max, bw))
        band_err, bound_err = self._np(band_err, bound_err)
        segs_by = dict(zip([d for d, _ in shards],
                           segs_j.split([len(r) for _, r in shards])))
        fin = {}
        for d, reads in shards:
            rows, clips, n_events, seq_lens = dev_in[d][:4]
            fin[d] = _stage_finalize(
                ctx[d]["cpts"], rows, clips, segs_by[d].to(self.mesh[d]),
                seq_lens, n_events, L_max)
        k = 0
        for d, reads in shards:
            seq_segs, rsrtr, has_del = self._np(*fin[d])
            for i, s in enumerate(reads):
                if band_err[k + i]:
                    s.error = ("Adaptive signal to sequence alignment "
                               "extended beyond raw signal")
                    continue
                if bound_err[k + i]:
                    s.error = ("Read event to sequence alignment extends "
                               "beyond bandwidth")
                    continue
                s.dp_segs = seq_segs[i, :s.ref_means.shape[0] + 1].astype(
                    np.int64)
                s.dp_rsrtr = int(rsrtr[i])
                s.has_del = bool(has_del[i])
            k += len(reads)
        self._delfix_and_fit(shards, ctx, {
            d: (rows, fin[d][1], fin[d][0], rm_j, rs_j, seq_lens)
            for d, (rows, _, _, seq_lens, rm_j, rs_j) in dev_in.items()})

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
                if (n_ev.max() > _DELFIX_NB_CAP or
                        sig_len.max() > _DELFIX_T_CAP):
                    continue                  # host lane (s.has_del True)
                s.del_windows = (list(zip(ws_arr.tolist(), we_arr.tolist())),
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
        max_n = config.MAX_POINTS_FOR_THEIL_SEN
        L_max = next(iter(dev_in.values()))[2].shape[1] - 1
        sampled = any(s.ref_means.shape[0] > max_n
                      for _, reads in shards for s in reads)
        nb_pad = max([2] + [n for v in wins.values() for n in v[2]])
        t_pad = max([2] + [n for v in wins.values() for n in v[3]])
        mhz = p.max_half_z_score
        fit_shards = {s.shard for s in fit_reads}
        queued = {}
        for d, reads in shards:
            if d not in fit_shards:
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
            tri = rescale.tri_indices(max_n if sampled else L_max, dev)
            # one inert window keeps a call without windows shape-valid
            win = wins[d] if wins[d][0] else ([0], [0], [0], [2], [0])
            rows_j, rsrtr_j, seq_segs_j, rm_j, rs_j, seq_lens_j = dev_in[d]
            queued[d] = _stage_delfix_fit(
                ctx[d]["norm"], rows_j, rsrtr_j, seq_segs_j, rm_j, rs_j,
                seq_lens_j, *[self._t(a, device=dev) for a in win],
                float(mhz if mhz is not None else 0.0), samp_j, tri,
                nb_pad=nb_pad, t_pad=t_pad, min_obs=p.raw_min_obs_per_base,
                winsorize=mhz is not None,
                shift_thresh=float(config.SHIFT_CHANGE_THRESH),
                scale_thresh=float(config.SCALE_CHANGE_THRESH),
                do_fit=not self.skip_seq_scaling)
        # (bounds, fail, shift_corr, scale_corr, score, changed, fit_ok);
        # the rescaled event means stay on the device
        res = {d: self._np(*out[:-1]) for d, out in queued.items()}

        for s in fit_reads:
            if s.del_windows is None:
                continue
            bounds, fail = res[s.shard][:2]
            windows, w0 = s.del_windows
            segs = s.dp_segs
            ok = True
            for k, (ws, we) in enumerate(windows):
                if fail[w0 + k]:
                    s.error = "Raw-signal traceback failed to find boundary"
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
                        lvl_entries.append((s.map_res.align_info.read_id, i,
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
        for s in states:
            if s.error is not None or not s.use_static:
                continue
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

    def _finalize(self, states: List[_ReadState], will_retry: bool = False):
        """Apply the device fit (scalar bookkeeping) or run the numpy host
        lane (deletion fix + Theil-Sen) and assemble results.  With
        ``skip_seq_scaling`` the scale values stay as segmentation set
        them and no read asks for another scaling iteration."""
        host, dev = [], []
        for s in states:
            if s.error is not None or s.result is not None:
                continue
            if s.dp_segs is None:
                s.error = "DP did not produce a path"
                continue
            dp_res = DpResults(s.dp_rsrtr, s.dp_segs, s.ref_means, s.ref_sds,
                               s.genome_seq_trim)
            if s.dev_fit is not None:
                dev.append((s, dp_res, s.dp_segs))
                continue
            try:
                norm = self._host_norm(
                    s.raw, s.scale_values, s.dp_rsrtr,
                    s.dp_rsrtr + int(s.dp_segs[-1]))
                segs = (dp_res.segs if s.has_del is False else
                        rsq.resolve_skipped_bases_with_raw(dp_res, norm,
                                                           self.params))
                host.append((s, dp_res, segs, norm))
            except TomboError as e:
                s.error = str(e)

        results = []
        max_n = config.MAX_POINTS_FOR_THEIL_SEN
        for s, dp_res, segs, norm in host:
            if self.skip_seq_scaling:
                score = rsq.get_read_seg_score(ref_impl.new_means(norm, segs),
                                               dp_res.ref_means,
                                               dp_res.ref_sds)
                results.append((s, dp_res, segs, norm, score, False))
                continue
            ev = ref_impl.new_means(norm, segs)
            mod = dp_res.ref_means
            n = mod.shape[0]
            if n > max_n:
                samp = _ts_sample_idx(n, max_n)
                ev, mod = ev[samp], mod[samp]
            slope, inter = rescale.theil_sen_host(ev, mod)
            if slope == 0:
                s.error = ("Read failed sequence-based signal re-scaling "
                           "parameter estimation.")
                continue
            scale_corr, shift_corr = 1.0 / slope, -inter / slope
            sv = s.scale_values
            s.scale_values = sv.replace(
                shift=sv.shift + shift_corr * sv.scale,
                scale=sv.scale * scale_corr,
                outlier_thresh=self.outlier_thresh)
            norm = (norm - shift_corr) / scale_corr
            changed = bool(
                abs(shift_corr) > config.SHIFT_CHANGE_THRESH or
                abs(scale_corr - 1) > config.SCALE_CHANGE_THRESH)
            score = rsq.get_read_seg_score(ref_impl.new_means(norm, segs),
                                           dp_res.ref_means, dp_res.ref_sds)
            results.append((s, dp_res, segs, norm, score, changed))

        for s, dp_res, segs in dev:
            shc, scc, score, changed, fit_ok = s.dev_fit
            start = dp_res.read_start_rel_to_raw
            if self.skip_seq_scaling:
                norm = self._host_norm(s.raw, s.scale_values, start,
                                       start + int(segs[-1]))
                results.append((s, dp_res, segs, norm, score, False))
                continue
            if not fit_ok:
                s.error = ("Read failed sequence-based signal re-scaling "
                           "parameter estimation.")
                continue
            sv_pre = s.scale_values
            s.scale_values = sv_pre.replace(
                shift=sv_pre.shift + shc * sv_pre.scale,
                scale=sv_pre.scale * scc,
                outlier_thresh=self.outlier_thresh)
            norm = None
            if not (will_retry and changed):
                # the normalized mapped slice, two steps as the host lane:
                # pre-fit scale values + clip, then the fitted correction
                norm = (self._host_norm(s.raw, sv_pre, start,
                                        start + int(segs[-1])) - shc) / scc
            results.append((s, dp_res, segs, norm, score, changed))

        for s, dp_res, segs, norm, score, changed in results:
            if segs.shape[0] != len(dp_res.genome_seq) + 1:
                s.error = ("Aligned sequence does not match number of "
                           "segments produced")
                continue
            s.result = s.map_res.replace(
                read_start_rel_to_raw=dp_res.read_start_rel_to_raw,
                segs=segs, genome_seq=dp_res.genome_seq, raw_signal=norm,
                scale_values=s.scale_values, sig_match_score=float(score),
                norm_params_changed=bool(changed))

        # a failed read, or one finished on a host lane, must leave no
        # device means behind: an earlier pass may have registered it
        for s in states:
            if ((s.error is not None or s.dev_fit is None) and
                    s.map_res.align_info is not None):
                device_levels.unregister(s.map_res.align_info.read_id,
                                         self.device.type)

    # ------------------------------------------------------------ run API
    def _run_pass(self, states: List[_ReadState], will_retry: bool = False):
        for s in states:
            if s.error is None:
                s.n_ev = s.num_events - 1
        live = [s for s in states if s.error is None]
        for group in _length_groups(live):
            self._run_pass_group(group, will_retry)

    def _run_pass_group(self, states: List[_ReadState],
                        will_retry: bool = False):
        p = self.params
        self._plan_reads(states)
        ctx = self._segment_batch(states)
        if ctx is not None:
            failed_start = self._start_discovery(
                states, ctx, p.start_bw, check_score=True, precomputed=True)
            # save-bandwidth start retry without score check, so no read
            # fails it (reference: tombo/resquiggle.py:996-1006)
            for s in failed_start:
                if s.n_ev < p.start_save_bw + p.start_n_bases:
                    s.use_static = True
            retry = [s for s in failed_start if not s.use_static]
            if retry:
                self._start_discovery(retry, ctx, p.start_save_bw,
                                      check_score=False)
            self._adaptive_batch(states, ctx)
            self._static_reads(states, ctx)
        self._finalize(states, will_retry=will_retry)

    def resquiggle_batches(self, batches, pipeline_depth: int = 3,
                           max_scaling_iters: int = config.MAX_SCALING_ITERS):
        """Process an iterable of mapped-read batches, yielding per-batch
        result lists in order, one batch after another.

        ``pipeline_depth`` is kept for the JAX package's signature and has
        no effect: that package runs batches side by side in threads, but
        a batch here makes thousands of short PyTorch calls, each of which
        hands the GIL over, so concurrent batches slow each other down
        (PERF.md, Findings)."""
        for b in batches:
            yield self.resquiggle_batch(b, max_scaling_iters=max_scaling_iters)

    def resquiggle_batch(self, map_results: Sequence[ResquiggleResults],
                         max_scaling_iters: int = config.MAX_SCALING_ITERS
                         ) -> List[Tuple[Optional[ResquiggleResults],
                                         Optional[str]]]:
        """Re-squiggle a batch of mapped reads (raw signal already
        adjusted).  Returns per-read (result, error)."""
        states = []
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
            num_mapped_bases = len(mr.genome_seq) - self.std_ref.kmer_width + 1
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

        # failed reads retried with the save bandwidth
        # (reference: tombo/resquiggle.py:1586-1588)
        retry = ([] if self.params.bandwidth == self.save_params.bandwidth
                 else [s for s in states if s.result is None])
        if retry:
            saver = BatchedResquiggler(
                self.std_ref, self.save_params, self.seq_samp_type,
                self.outlier_thresh, self.dtype, mesh=self.mesh,
                const_scale=self.const_scale,
                skip_seq_scaling=self.skip_seq_scaling)
            retry_out = saver.resquiggle_batch(
                [s.map_res.replace(scale_values=None) for s in retry],
                max_scaling_iters=max_scaling_iters)
            for s, (res, err) in zip(retry, retry_out):
                if res is not None:
                    s.result = res
                    s.error = None
        return [(s.result, s.error) for s in states]
