"""Host (numpy) pieces of re-squiggle that the batched path calls
(subset copy of ``tombo_tpu/pipeline/resquiggle.py``; reference:
tombo/resquiggle.py): event counts, read mapping, the RNA signal
adjustments (3'->5' flip, adapter trim, stall intervals), per-read
normalization (every normalization type) and scale values, the
sequence-fitted shift and scale, traceback trimming and raw coordinates,
the short-read static assignment, and the deletion-fix window planner and
numpy fix for host-lane reads."""
from __future__ import annotations

from typing import Optional

import numpy as np

from .. import config
from ..config import (DEL_FIX_WINDOW, EXTRA_SIG_FACTOR, MAX_DEL_FIX_WINDOW,
                      MAX_RAW_CPTS, MIN_EVENT_TO_SEQ_RATIO, ResquiggleParams)
from ..errors import TomboError
from ..ops import ref_impl
from ..ops.ref_impl import valid_cpts_w_cap, valid_cpts_w_cap_t_test  # noqa
from ..seq import rev_comp
from ..types import (AlignInfo, DpResults, GenomeLocation, ResquiggleResults,
                     ScaleValues, SeqSampleType, SequenceData)


def compute_num_events(signal_len, seq_len, mean_obs_per_event,
                       min_event_to_seq_ratio=MIN_EVENT_TO_SEQ_RATIO):
    """Reference: tombo/tombo_stats.py:1558-1574."""
    return max(signal_len // mean_obs_per_event,
               int(seq_len * min_event_to_seq_ratio))


def get_read_seg_score(r_means, r_ref_means, r_ref_sds) -> float:
    """Mean half z-score of observed vs expected levels."""
    return float(np.mean(np.abs((r_means - r_ref_means) / r_ref_sds)))


def find_static_base_assignment(event_means, r_ref_means, r_ref_sds,
                                rsqgl_params: ResquiggleParams):
    """Short-read static-band assignment (reference:
    tombo/resquiggle.py:547-600)."""
    seq_len = r_ref_means.shape[0]
    events_len = event_means.shape[0]
    mask_len = min(seq_len, events_len) // 4
    band_event_starts = np.concatenate([
        np.zeros(seq_len - mask_len * 2),
        np.linspace(0, mask_len, mask_len * 2)]).astype(np.int64)
    bandwidth = events_len - mask_len
    shifted_z = np.empty((band_event_starts.shape[0], bandwidth))
    for seq_pos, event_pos in enumerate(band_event_starts):
        z = np.abs((event_means[event_pos:event_pos + bandwidth] -
                    r_ref_means[seq_pos]) / r_ref_sds[seq_pos])
        if rsqgl_params.max_half_z_score is not None:
            z = np.minimum(z, rsqgl_params.max_half_z_score)
        shifted_z[seq_pos, :] = rsqgl_params.z_shift - z
    fwd, tb = ref_impl.banded_forward_pass(
        shifted_z, band_event_starts, rsqgl_params.skip_pen,
        rsqgl_params.stay_pen)
    return ref_impl.banded_traceback(tb, band_event_starts,
                                     int(np.argmax(fwd[-1])))


def get_rel_raw_coords(valid_cpts, seq_events):
    """Raw coordinates relative to the assigned-signal start."""
    seq_segs = valid_cpts[seq_events]
    read_start_rel_to_raw = int(seq_segs[0])
    return seq_segs - read_start_rel_to_raw, read_start_rel_to_raw


def plan_del_fix_windows(
        dp_res: DpResults, rsqgl_params: ResquiggleParams,
        max_raw_cpts=MAX_RAW_CPTS, del_fix_window=DEL_FIX_WINDOW,
        max_del_fix_window=MAX_DEL_FIX_WINDOW,
        extra_sig_factor=EXTRA_SIG_FACTOR):
    """Merged/expanded (start, end) base windows around zero-length
    segments, or [] (reference: tombo/resquiggle.py:402-480)."""

    def merge_windows(ws):
        merged = []
        for start, end in ws:
            if merged and start < merged[-1][1]:
                merged[-1] = (merged[-1][0], end)
            else:
                merged.append((start, end))
        return merged

    def window_too_small(start, end):
        n_events = end - start
        sig_len = dp_res.segs[end] - dp_res.segs[start]
        return sig_len <= ((n_events + 1) *
                           rsqgl_params.raw_min_obs_per_base) * \
            extra_sig_factor

    def expand_small(ws):
        out, expanded = [], False
        for start, end in ws:
            if window_too_small(start, end):
                expanded = True
                start -= 1
                end += 1
            out.append((start, end))
        return out, expanded

    def trim_ends(ws):
        if ws[0][0] < 0:
            ws[0] = (0, ws[0][1])
        if ws[-1][1] > len(dp_res.segs) - 1:
            ws[-1] = (ws[-1][0], len(dp_res.segs) - 1)
        return ws

    all_del_windows = []
    for del_pos in np.where(np.diff(dp_res.segs) == 0)[0]:
        if (all_del_windows and
                del_pos < all_del_windows[-1][1] + del_fix_window):
            all_del_windows[-1] = (all_del_windows[-1][0],
                                   del_pos + del_fix_window + 1)
        else:
            all_del_windows.append((del_pos - del_fix_window,
                                    del_pos + del_fix_window + 1))
    if not all_del_windows:
        return []

    windows_expanded = False
    all_del_windows = trim_ends(merge_windows(all_del_windows))
    for _ in range(max_del_fix_window - del_fix_window):
        all_del_windows, windows_expanded = expand_small(all_del_windows)
        if not windows_expanded:
            break
        all_del_windows = trim_ends(merge_windows(all_del_windows))

    if windows_expanded and any(
            window_too_small(s, e) for s, e in all_del_windows):
        raise TomboError(
            "Not enough raw signal around potential genomic deletion(s)")
    if max_raw_cpts is not None and max(
            e - s for s, e in all_del_windows) > max_raw_cpts:
        raise TomboError("Read contains too many potential genomic deletions")
    return all_del_windows


def resolve_skipped_bases_with_raw(dp_res: DpResults, norm_signal,
                                   rsqgl_params: ResquiggleParams):
    """Raw-signal DP in windows around skipped bases, numpy (reference:
    tombo/resquiggle.py:402 ``resolve_skipped_bases_with_raw``)."""
    windows = plan_del_fix_windows(dp_res, rsqgl_params)
    if not windows:
        return dp_res.segs.copy()
    min_obs = rsqgl_params.raw_min_obs_per_base
    resolved = dp_res.segs.copy()
    for start, end in windows:
        n_events = end - start
        sig_start, sig_end = dp_res.segs[start], dp_res.segs[end]
        pseudo_starts = np.linspace(0, sig_end - sig_start, n_events + 1,
                                    dtype=np.int64)
        reg_zs = ref_impl.reg_z_scores(
            norm_signal[sig_start:sig_end], dp_res.ref_means[start:end],
            dp_res.ref_sds[start:end], pseudo_starts, 0, n_events, n_events,
            min_obs, max_half_z_score=rsqgl_params.max_half_z_score)
        reg_segs = ref_impl.raw_traceback(
            ref_impl.raw_forward_pass(reg_zs, min_obs), min_obs)
        if reg_segs.shape[0] != end - start - 1:
            raise TomboError("Invalid segmentation results.")
        resolved[start + 1:end] = reg_segs + dp_res.segs[start]
    if np.diff(resolved).min() < 1:
        raise TomboError("New segments include zero length events")
    if resolved[0] < 0:
        raise TomboError("New segments start with negative index")
    if resolved[-1] > norm_signal.shape[0]:
        raise TomboError("New segments end past raw signal values")
    return resolved


def normalize_raw_signal(all_raw_signal, read_start_rel_to_raw=0,
                         read_obs_len=None, norm_type="median",
                         outlier_thresh=None, channel_info=None,
                         scale_values: Optional[ScaleValues] = None,
                         const_scale=None, event_means=None,
                         model_means=None, model_inv_vars=None):
    """Normalize raw signal (reference: tombo/tombo_stats.py:482
    ``normalize_raw_signal``).  Returns (norm_signal, ScaleValues).

    ``none`` keeps the DAC values; ``pA_raw`` converts them to pA through
    the channel's offset, range and digitisation; ``pA`` then fits a
    method-of-moments correction of the basecaller's event means
    (``event_means``) to the pore model's levels (``model_means``,
    ``model_inv_vars``); ``median`` and ``median_const_scale`` shift by
    the median; ``robust_median`` by the mean of the ``ROBUST_QUANTS``
    percentiles."""
    if read_obs_len is None:
        read_obs_len = all_raw_signal.shape[0] - read_start_rel_to_raw
    raw_signal = np.asarray(
        all_raw_signal[read_start_rel_to_raw:
                       read_start_rel_to_raw + read_obs_len], np.float64)
    if scale_values is not None:
        shift, scale = scale_values.shift, scale_values.scale
    elif norm_type == "none":
        shift, scale = 0.0, 1.0
    elif norm_type in ("pA_raw", "pA"):
        if channel_info is None:
            raise TomboError("pA normalization requires channel info")
        shift = -1.0 * channel_info.offset
        scale = channel_info.digitisation / channel_info.range
        if norm_type == "pA":
            if event_means is None or model_means is None:
                raise TomboError(
                    "pA normalization requires basecaller event means "
                    "and a pore model")
            shift, scale, _, _ = calc_kmer_fitted_shift_scale(
                shift, scale, event_means, model_means, model_inv_vars,
                method="mom")
    elif norm_type == "median":
        shift = float(np.median(raw_signal))
        scale = float(np.median(np.abs(raw_signal - shift)))
    elif norm_type == "median_const_scale":
        if const_scale is None:
            raise TomboError("median_const_scale needs a constant scale")
        shift = float(np.median(raw_signal))
        scale = float(const_scale)
    elif norm_type == "robust_median":
        shift = float(np.mean(np.percentile(raw_signal,
                                            config.ROBUST_QUANTS)))
        scale = float(np.median(np.abs(raw_signal - shift)))
    else:
        raise TomboError("Invalid normalization type: " + norm_type)
    norm_signal = (raw_signal - shift) / scale

    lower_lim, upper_lim = None, None
    if outlier_thresh is not None:
        read_med = np.median(norm_signal)
        read_mad = np.median(np.abs(norm_signal - read_med))
        lower_lim = read_med - read_mad * outlier_thresh
        upper_lim = read_med + read_mad * outlier_thresh
    elif scale_values is not None:
        lower_lim, upper_lim = scale_values.lower_lim, scale_values.upper_lim
    if lower_lim is not None and upper_lim is not None:
        norm_signal = np.clip(norm_signal, lower_lim, upper_lim)
    return norm_signal, ScaleValues(shift, scale, lower_lim, upper_lim,
                                    outlier_thresh)


def calc_kmer_fitted_shift_scale(prev_shift, prev_scale, r_event_means,
                                 r_model_means, r_model_inv_vars=None,
                                 method="theil_sen",
                                 rng: Optional[np.random.Generator] = None):
    """Sequence-fitted correction of a shift and scale (reference:
    tombo/tombo_stats.py:370 ``calc_kmer_fitted_shift_scale``): the
    Theil-Sen line of the model levels on the event means (at most
    ``MAX_POINTS_FOR_THEIL_SEN`` points, drawn from ``rng``, default
    ``np.random.default_rng(0)``) or the inverse-variance weighted
    method of moments (``mom``).  Returns (shift, scale, shift
    correction, scale correction)."""
    if method == "theil_sen":
        n = r_model_means.shape[0]
        if n > config.MAX_POINTS_FOR_THEIL_SEN:
            if rng is None:
                rng = np.random.default_rng(0)
            samp = rng.choice(n, config.MAX_POINTS_FOR_THEIL_SEN,
                              replace=False)
            r_model_means = r_model_means[samp]
            r_event_means = r_event_means[samp]
        slope = float(np.median(ref_impl.compute_slopes(
            r_event_means, r_model_means)))
        inter = float(np.median(r_model_means - slope * r_event_means))
        if slope == 0:
            raise TomboError(
                "Read failed sequence-based signal re-scaling parameter "
                "estimation.")
        scale_corr_factor = 1.0 / slope
        shift_corr_factor = -inter / slope
    elif method == "mom":
        mmv = r_model_means * r_model_inv_vars
        mmv_sum = mmv.sum()
        coef = np.array([[r_model_inv_vars.sum(), mmv_sum],
                         [mmv_sum, (mmv * r_model_means).sum()]])
        rev = r_event_means * r_model_inv_vars
        dep = np.array([rev.sum(), (rev * r_model_means).sum()])
        shift_corr_factor, scale_corr_factor = np.linalg.solve(coef, dep)
    else:
        raise TomboError(
            "Invalid k-mer fitted normalization method: " + method)
    shift = prev_shift + shift_corr_factor * prev_scale
    scale = prev_scale * scale_corr_factor
    return shift, scale, shift_corr_factor, scale_corr_factor


def get_scale_values_from_events(all_raw_signal, valid_cpts, outlier_thresh,
                                 num_events=None, max_frac_events=None
                                 ) -> ScaleValues:
    """RNA scale values from the median and MAD of the first events' means,
    which keeps the adapter out (reference: tombo/tombo_stats.py:217-233)."""
    if num_events is not None or max_frac_events is not None:
        if (num_events is None or
                valid_cpts.shape[0] * max_frac_events < num_events):
            num_events = int(valid_cpts.shape[0] * max_frac_events)
        valid_cpts = valid_cpts[:num_events]
    event_means = ref_impl.new_means(
        np.asarray(all_raw_signal, np.float64), valid_cpts)
    read_med = float(np.median(event_means))
    read_mad = float(np.median(np.abs(event_means - read_med)))
    return ScaleValues(shift=read_med, scale=read_mad,
                       lower_lim=-outlier_thresh, upper_lim=outlier_thresh,
                       outlier_thresh=None)


def identify_stalls(all_raw_signal, stall_params: config.StallParams,
                    return_metric=False):
    """Pore-stall intervals [start, end) of the raw signal, by the running
    mean-difference method (the default) or the rolling-percentile method
    (reference: tombo/tombo_stats.py:269 ``identify_stalls``)."""
    sp = stall_params
    x = np.asarray(all_raw_signal)
    if x.shape[0] < sp.window_size:
        return ([], np.full(x.shape[0], np.nan)) if return_metric else []

    stall_metric = np.full(x.shape, np.nan, dtype=np.float64)
    start_offset = int(sp.window_size * 0.5)
    end_offset = x.shape[0] - sp.window_size + start_offset + 1
    if sp.lower_pctl is not None and sp.upper_pctl is not None:
        stall_metric[start_offset:end_offset] = \
            ref_impl.compute_running_pctl_diffs(
                x, sp.window_size, sp.lower_pctl, sp.upper_pctl)
    elif sp.n_windows is not None and sp.mini_window_size is not None:
        assert sp.window_size == sp.mini_window_size * sp.n_windows
        mw, nw = sp.mini_window_size, sp.n_windows
        # moving averages of the mini windows
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
        stall_metric[start_offset:end_offset] = diff_sums / len(diffs)
    else:
        raise TomboError(
            "Must provide method specific parameters for stall detection")

    with np.errstate(invalid="ignore"):
        below = stall_metric <= sp.threshold
    stall_locs = np.where(np.diff(np.concatenate([[False], below])))[0]
    if below[-1]:
        stall_locs = np.concatenate([stall_locs, [stall_metric.shape[0]]])
    stall_locs = stall_locs.reshape(-1, 2)
    stall_locs = stall_locs[
        (np.diff(stall_locs) > sp.min_consecutive_obs).flatten()]
    if stall_locs.shape[0] == 0:
        return ([], stall_metric) if return_metric else []

    expand_width = (sp.window_size // 2) - sp.edge_buffer
    if expand_width > 0:
        stall_locs[:, 0] -= expand_width
        stall_locs[:, 1] += expand_width
        merged = []
        prev = stall_locs[0]
        for curr in stall_locs:
            if curr[0] > prev[1]:
                merged.append(prev)
                prev = curr
            else:
                prev[1] = curr[1]
        merged.append(prev)
        stall_locs = merged
    return (stall_locs, stall_metric) if return_metric else stall_locs


def remove_stall_cpts(stall_ints, valid_cpts):
    """Drop changepoints strictly inside a stall interval (reference:
    tombo/tombo_stats.py:1576-1597)."""
    if len(stall_ints) == 0:
        return valid_cpts
    keep = np.ones(valid_cpts.shape[0], dtype=bool)
    for start, end in stall_ints:
        keep &= ~((valid_cpts > start) & (valid_cpts < end))
    return valid_cpts[keep]


def adjust_map_res(map_res: ResquiggleResults, seq_samp_type: SeqSampleType,
                   rsqgl_params: ResquiggleParams,
                   trim_rna_adapter: bool = False) -> ResquiggleResults:
    """Pre-resquiggle signal adjustments: the RNA 3'->5' signal flip, the
    optional adapter trim, and stall intervals where collapsing is on
    (RNA by default; reference: tombo/resquiggle.py:1506-1530)."""
    if seq_samp_type.name == config.RNA_SAMP_TYPE:
        if trim_rna_adapter:
            adapter_end = trim_rna(map_res.raw_signal, rsqgl_params)
            map_res = map_res.replace(
                raw_signal=map_res.raw_signal[adapter_end:])
        map_res = map_res.replace(raw_signal=map_res.raw_signal[::-1])
    if ((config.COLLAPSE_RNA_STALLS and
         seq_samp_type.name == config.RNA_SAMP_TYPE) or
            (config.COLLAPSE_DNA_STALLS and
             seq_samp_type.name == config.DNA_SAMP_TYPE)):
        map_res = map_res.replace(stall_ints=identify_stalls(
            map_res.raw_signal, config.DEFAULT_STALL_PARAMS))
    return map_res


def trim_rna(all_raw_signal, rsqgl_params: ResquiggleParams,
             trim_rna_params=config.DEFAULT_TRIM_RNA_PARAMS) -> int:
    """The end of the DNA adapter on a direct-RNA read, in raw samples (0
    when none is found; reference: tombo/tombo_stats.py:235-267)."""
    x = np.asarray(all_raw_signal[:trim_rna_params.max_raw_obs], np.float64)
    num_events = int(x.shape[0] // rsqgl_params.mean_obs_per_event)
    valid_cpts = valid_cpts_w_cap(
        x, rsqgl_params.min_obs_per_base, rsqgl_params.running_stat_width,
        num_events)
    _, window_sds = ref_impl.new_mean_stds(x, valid_cpts)

    w = trim_rna_params.moving_window_size
    if window_sds.shape[0] < w:
        return 0
    mov = np.convolve(window_sds, np.ones(w) / w, mode="valid")
    thresh = mov.mean() * trim_rna_params.thresh_scale
    m = trim_rna_params.min_running_values
    if mov.shape[0] < m:
        return 0
    running_mins = np.lib.stride_tricks.sliding_window_view(mov, m).min(-1)
    above = np.where(running_mins > thresh)[0]
    if above.shape[0] == 0:
        return 0
    return int(valid_cpts[above[0]])


def map_read(seq_data: SequenceData, aligner, std_ref,
             seq_samp_type=SeqSampleType(config.DNA_SAMP_TYPE, False),
             bc_subgrp="BaseCalled_template",
             seq_len_rng=None) -> ResquiggleResults:
    """Map basecalls and extract the k-mer-context-expanded genome
    sequence (reference: tombo/resquiggle.py:1278 ``map_read``);
    ``seq_len_rng`` (exclusive bounds) fails a read whose mapped span
    lies outside it."""
    alignment = aligner.map(str(seq_data.seq))
    if alignment is None:
        raise TomboError("Alignment not produced")
    chrm, ref_start, ref_end = alignment.ctg, alignment.r_st, alignment.r_en
    if not (seq_len_rng is None or
            seq_len_rng[0] < ref_end - ref_start < seq_len_rng[1]):
        raise TomboError(
            "Mapped location not within --sequence-length-range")
    strand = "+" if alignment.strand == 1 else "-"
    num_ins = num_del = num_aligned = 0
    for op_len, op in alignment.cigar:
        if op == 1:
            num_ins += op_len
        elif op in (2, 3):
            num_del += op_len
        elif op in (0, 7, 8):
            num_aligned += op_len
        elif op != 6:
            raise TomboError("Invalid cigar operation")
    if strand == "+":
        num_start_clipped = alignment.q_st
        num_end_clipped = len(seq_data.seq) - alignment.q_en
    else:
        num_start_clipped = len(seq_data.seq) - alignment.q_en
        num_end_clipped = alignment.q_st
    align_info = AlignInfo(
        read_id=seq_data.id, subgroup=bc_subgrp,
        clip_start=num_start_clipped, clip_end=num_end_clipped,
        insertions=num_ins, deletions=num_del, matches=alignment.mlen,
        mismatches=num_aligned - alignment.mlen)

    # expand to cover model-able positions (reference:
    # tombo/resquiggle.py:1344-1358).  Without start-clip bases (the
    # reference hard-codes them off) the DNA and the RNA rule pick the
    # same branch for each strand
    dnstrm_bases = std_ref.kmer_width - std_ref.central_pos - 1
    if strand == "+":
        if ref_start < std_ref.central_pos:
            ref_start = std_ref.central_pos
        ref_seq_start = ref_start - std_ref.central_pos
        ref_seq_end = ref_end + dnstrm_bases
    else:
        if ref_start < dnstrm_bases:
            ref_start = dnstrm_bases
        ref_seq_start = ref_start - dnstrm_bases
        ref_seq_end = ref_end + std_ref.central_pos
    genome_seq = aligner.seq(chrm, ref_seq_start, ref_seq_end)
    if genome_seq is None or genome_seq == "":
        raise TomboError("Invalid mapping location")
    if strand == "-":
        genome_seq = rev_comp(genome_seq)
    return ResquiggleResults(
        align_info=align_info,
        genome_loc=GenomeLocation(ref_start, strand, chrm),
        genome_seq=genome_seq, mean_q_score=seq_data.mean_q_score)
