"""Re-squiggle of one read, and the host (numpy) steps the batched path
calls (counterpart of ``tombo_tpu/pipeline/resquiggle.py``; reference:
tombo/resquiggle.py).

The one-read API follows the JAX package's call flow::

    map_read -> adjust_map_res -> resquiggle_read(_with_retries)
        -> segment_signal (normalize + changepoints, on the host)
        -> find_adaptive_base_assignment: start discovery through the
           start DP (K4, ``ops/banded_dp.py::start_dp_segs``), then the
           masked-start adaptive DP and its traceback (K1, or the chunked
           pair K2/K2' for a long read), each at a batch of one; short
           reads take the static band of the host library
        -> resolve_skipped_bases_with_raw (the host library's window DP)
        -> Theil-Sen sequence-fitted rescaling: the count kernel (K5,
           ``ops/rescale.py::theil_sen_device``) at float32, the numpy
           fit at float64

``device=None`` means the card; on the CPU every kernel wrapper runs its
plain version.  The DP inputs are float32 on the card; the CPU may run
float64, the parity mode, where the results equal the JAX package's bit
for bit.  Normalization, changepoint scores, the deletion fix and the raw
coordinates stay float64 numpy, as in the JAX package.

The host steps that the JAX package routes through its native library
(greedy changepoint selection, the short-read static band, the
deletion-window DP) go through the port's copy of it (``native.py``);
their numpy bodies stay here as the plain versions.  Also here: event
counts, read mapping, the RNA signal adjustments (3'->5' flip, adapter
trim, stall intervals), per-read normalization (every normalization type)
and scale values, the sequence-fitted shift and scale, and the
deletion-fix window planner.  The JAX package's debug dump of the DP
(an environment switch) is not ported: K1 keeps no forward matrix."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import config, native
from ..config import (DEL_FIX_WINDOW, EXTRA_SIG_FACTOR, MASK_BASES,
                      MASK_FILL_Z_SCORE, MAX_DEL_FIX_WINDOW, MAX_RAW_CPTS,
                      MIN_EVENT_TO_SEQ_RATIO, ResquiggleParams,
                      SIG_MATCH_THRESH)
from ..device import DeviceLike, resolve_device, resolve_dtype
from ..errors import TomboError
from ..ops import banded_dp, ref_impl, rescale
from ..ops.dp import DpParams, StartDpParams
from ..seq import rev_comp
from ..types import (AlignInfo, DpResults, GenomeLocation, ResquiggleResults,
                     ScaleValues, SeqSampleType, SequenceData)


def _greedy_cpts(scores, min_base_obs, running_stat_width, num_cpts):
    cpts, status = native.greedy_cpts_batch(
        scores[None], np.array([scores.shape[0]]), np.array([num_cpts]),
        shift=running_stat_width, min_base_obs=min_base_obs)
    if status[0] != 0:
        raise TomboError("Fewer changepoints found than requested")
    return cpts[0]


def valid_cpts_w_cap(signal, min_base_obs, running_stat_width, num_cpts):
    """DNA event detection, sorted: difference scores and the host
    library's greedy selection (plain version
    ``ref_impl.valid_cpts_w_cap``)."""
    return _greedy_cpts(ref_impl.cpt_scores_diff(signal, running_stat_width),
                        min_base_obs, running_stat_width, num_cpts)


def valid_cpts_w_cap_t_test(signal, min_base_obs, running_stat_width,
                            num_cpts):
    """RNA event detection, sorted: t-test scores and the host library's
    greedy selection (plain version ``ref_impl.valid_cpts_w_cap_t_test``)."""
    return _greedy_cpts(
        ref_impl.cpt_scores_t_test(signal, running_stat_width),
        min_base_obs, running_stat_width, num_cpts)


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
    tombo/resquiggle.py:547-600) in one call of the host library, bit for
    bit :func:`_find_static_base_assignment_plain`."""
    return native.static_base_assignment(
        event_means, r_ref_means, r_ref_sds, rsqgl_params.z_shift,
        rsqgl_params.skip_pen, rsqgl_params.stay_pen,
        rsqgl_params.max_half_z_score)


def _find_static_base_assignment_plain(event_means, r_ref_means, r_ref_sds,
                                       rsqgl_params: ResquiggleParams):
    """The static band as a numpy row loop."""
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


def build_del_fix_inputs(dp_res: DpResults, norm_signal, windows):
    """The window DP's inputs of planned windows: (signal slice, expected
    levels, SDs, evenly spaced pseudo starts) per window."""
    return [
        (norm_signal[dp_res.segs[start]:dp_res.segs[end]],
         dp_res.ref_means[start:end], dp_res.ref_sds[start:end],
         np.linspace(0, dp_res.segs[end] - dp_res.segs[start],
                     end - start + 1, dtype=np.int64))
        for start, end in windows]


def apply_del_fix(dp_res: DpResults, norm_signal, windows, segs_list,
                  status):
    """Scatter each window's boundaries back into the segment table and
    run the reference's validity checks (reference:
    tombo/resquiggle.py:470-500)."""
    resolved_segs = dp_res.segs.copy()
    for (start, end), reg_segs, st in zip(windows, segs_list, status):
        if st != 0:
            raise TomboError("Raw-signal traceback failed to find boundary")
        resolved_segs[start + 1:end] = reg_segs + dp_res.segs[start]
    if np.diff(resolved_segs).min() < 1:
        raise TomboError("New segments include zero length events")
    if resolved_segs[0] < 0:
        raise TomboError("New segments start with negative index")
    if resolved_segs[-1] > norm_signal.shape[0]:
        raise TomboError("New segments end past raw signal values")
    return resolved_segs


def resolve_skipped_bases_with_raw(
        dp_res: DpResults, norm_signal, rsqgl_params: ResquiggleParams,
        max_raw_cpts=MAX_RAW_CPTS, del_fix_window=DEL_FIX_WINDOW,
        max_del_fix_window=MAX_DEL_FIX_WINDOW,
        extra_sig_factor=EXTRA_SIG_FACTOR):
    """Raw-signal DP in windows around skipped bases (reference:
    tombo/resquiggle.py:402 ``resolve_skipped_bases_with_raw``): every
    window in one call of the host library's window DP, bit for bit
    :func:`_resolve_skipped_bases_with_raw_plain`."""
    windows = plan_del_fix_windows(
        dp_res, rsqgl_params, max_raw_cpts, del_fix_window,
        max_del_fix_window, extra_sig_factor)
    if not windows:
        return dp_res.segs.copy()
    segs_list, status = native.raw_windows_dp_batch(
        build_del_fix_inputs(dp_res, norm_signal, windows),
        rsqgl_params.raw_min_obs_per_base, rsqgl_params.max_half_z_score)
    return apply_del_fix(dp_res, norm_signal, windows, segs_list, status)


def _resolve_skipped_bases_with_raw_plain(
        dp_res: DpResults, norm_signal, rsqgl_params: ResquiggleParams,
        max_raw_cpts=MAX_RAW_CPTS, del_fix_window=DEL_FIX_WINDOW,
        max_del_fix_window=MAX_DEL_FIX_WINDOW,
        extra_sig_factor=EXTRA_SIG_FACTOR):
    """The deletion fix with the window DP as numpy loops."""
    windows = plan_del_fix_windows(
        dp_res, rsqgl_params, max_raw_cpts, del_fix_window,
        max_del_fix_window, extra_sig_factor)
    if not windows:
        return dp_res.segs.copy()
    min_obs = rsqgl_params.raw_min_obs_per_base
    segs_list = []
    for (start, end), (sig, means, sds, pseudo_starts) in zip(
            windows, build_del_fix_inputs(dp_res, norm_signal, windows)):
        n_events = end - start
        reg_zs = ref_impl.reg_z_scores(
            sig, means, sds, pseudo_starts, 0, n_events, n_events, min_obs,
            max_half_z_score=rsqgl_params.max_half_z_score)
        segs_list.append(ref_impl.raw_traceback(
            ref_impl.raw_forward_pass(reg_zs, min_obs), min_obs))
    return apply_del_fix(dp_res, norm_signal, windows, segs_list,
                         [0] * len(windows))


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
        r_event_means, r_model_means = _theil_sen_points(
            r_event_means, r_model_means, rng)
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


# --------------------------------------------------------- one-read API
def segment_signal(map_res: ResquiggleResults, num_events: int,
                   rsqgl_params: ResquiggleParams, outlier_thresh=None,
                   const_scale=None):
    """Normalize and segment the raw signal (reference:
    tombo/resquiggle.py:1057-1120 ``segment_signal``): DNA normalizes
    (median/MAD, a constant scale or given scale values) and then selects
    changepoints on the normalized signal; RNA selects changepoints on
    the raw signal by t-test scores, drops those inside stalls and scales
    by the first events' means (the reference's default
    ``USE_RNA_EVENT_SCALE``).  Returns (valid_cpts, norm_signal,
    scale_values)."""
    raw = np.asarray(map_res.raw_signal, np.float64)
    w, min_obs = rsqgl_params.running_stat_width, rsqgl_params.min_obs_per_base
    if rsqgl_params.use_t_test_seg:
        valid_cpts = valid_cpts_w_cap_t_test(raw, min_obs, w, num_events)
        if map_res.stall_ints is not None:
            valid_cpts = remove_stall_cpts(map_res.stall_ints, valid_cpts)
        if map_res.scale_values is not None:
            return (valid_cpts,) + normalize_raw_signal(
                raw, scale_values=map_res.scale_values)
        if const_scale is not None:
            return (valid_cpts,) + normalize_raw_signal(
                raw, norm_type="median_const_scale",
                outlier_thresh=outlier_thresh, const_scale=const_scale)
        scale_values = get_scale_values_from_events(
            raw, valid_cpts, outlier_thresh,
            num_events=config.RNA_SCALE_NUM_EVENTS,
            max_frac_events=config.RNA_SCALE_MAX_FRAC_EVENTS)
        return (valid_cpts,) + normalize_raw_signal(
            raw, scale_values=scale_values)
    if map_res.scale_values is not None:
        norm_signal, scale_values = normalize_raw_signal(
            raw, scale_values=map_res.scale_values)
    elif const_scale is not None:
        norm_signal, scale_values = normalize_raw_signal(
            raw, norm_type="median_const_scale",
            outlier_thresh=outlier_thresh, const_scale=const_scale)
    else:
        norm_signal, scale_values = normalize_raw_signal(
            raw, norm_type="median", outlier_thresh=outlier_thresh)
    valid_cpts = valid_cpts_w_cap(norm_signal, min_obs, w, num_events)
    if map_res.stall_ints is not None:
        valid_cpts = remove_stall_cpts(map_res.stall_ints, valid_cpts)
    return valid_cpts, norm_signal, scale_values


def score_valid_bases(read_tb, event_means, r_ref_means, r_ref_sds
                      ) -> float:
    """Matching score over the bases the traceback gave events
    (reference: tombo/tombo_stats.py:2341-2362)."""
    valid_bases = np.where(np.diff(read_tb) != 0)[0]
    if valid_bases.shape[0] == 0:
        raise TomboError("Invalid path through read start")
    base_means = np.array([
        event_means[s:e].mean()
        for s, e in zip(read_tb[:-1], read_tb[1:]) if s != e])
    return get_read_seg_score(base_means, r_ref_means[valid_bases],
                              r_ref_sds[valid_bases])


def build_masked_start_plan(n_events: int, mapped_start_offset: int,
                            rsqgl_params: ResquiggleParams,
                            events_per_base: float,
                            mask_bases: int = MASK_BASES):
    """The start-masked static band of the adaptive DP's first rows
    (the planning half of reference: tombo/resquiggle.py:607-677
    ``_get_masked_start_fwd_pass``), as the batched path's
    ``pipeline/batch.py::_build_masked_plans_batch`` plans it for a batch
    of one, in K1's input layout: (band starts (1, P_max), valid start
    (1,), row ends (1, P_max), rows P (1,), P_max, a multiple of 64).
    Events below the valid start or at or past a row's end score the
    mask fill; the columns from P on repeat the last band start and end
    at the last event."""
    if n_events - mapped_start_offset < rsqgl_params.bandwidth:
        raise TomboError(
            "Read sequence to signal matching starts too far into events "
            "for full adaptive assignment")
    from types import SimpleNamespace
    from .batch import _build_masked_plans_batch
    return _build_masked_plans_batch(
        [SimpleNamespace(n_ev=n_events, events_start_clip=0,
                         mapped_start_offset=mapped_start_offset,
                         events_per_base=events_per_base)],
        rsqgl_params, mask_bases)


def _device_rows(dev, dt, *arrays):
    """Each array as one (1, n) tensor of ``dt`` on ``dev``."""
    return [torch.as_tensor(np.ascontiguousarray(a, np.float64)[None]).to(
        device=dev, dtype=dt) for a in arrays]


def find_seq_start_in_events(event_means, r_ref_means, r_ref_sds,
                             rsqgl_params: ResquiggleParams, num_bases: int,
                             num_events: int,
                             seq_samp_type: Optional[SeqSampleType] = None,
                             device: DeviceLike = None, dtype=None):
    """Where the expected levels start in the observed events (reference:
    tombo/resquiggle.py:685-752): the start DP over the first
    ``num_bases`` bases and ``num_bases + num_events`` events, a static
    band moving one event a base, through K4
    (``ops/banded_dp.py::start_dp_segs``) at a batch of one.  With
    ``seq_samp_type`` the start's matching score is checked against the
    sample type's threshold.  Returns (start event, events per base)."""
    if event_means.shape[0] < num_events + num_bases:
        raise TomboError("Read too short for start/end discovery")
    if r_ref_means.shape[0] < num_bases:
        raise TomboError("Genomic mapping too short for start/end "
                         "discovery")
    dev = resolve_device(device)
    dt = resolve_dtype(dtype, dev)
    p = rsqgl_params
    sp = StartDpParams(z_shift=p.z_shift, skip_pen=p.skip_pen,
                       stay_pen=p.stay_pen,
                       max_half_z_score=p.max_half_z_score or -1.0,
                       num_bases=num_bases, num_events=num_events)
    em, rm, rs = _device_rows(dev, dt, event_means[:num_bases + num_events],
                              r_ref_means[:num_bases],
                              r_ref_sds[:num_bases])
    start_tb = banded_dp.start_dp_segs(em, rm, rs, sp)[0].cpu().numpy(
        ).astype(np.int64)
    if (seq_samp_type is not None and
            score_valid_bases(start_tb, event_means, r_ref_means, r_ref_sds)
            > SIG_MATCH_THRESH[seq_samp_type.name]):
        raise TomboError(
            "Poor raw to expected signal matching in beginning of read.")
    events_per_base = (start_tb[-1] - start_tb[0]) / len(start_tb)
    return int(start_tb[0]), events_per_base


def _trim_traceback(read_tb, events_len):
    """Clip the traceback's positions before the first event and past the
    last (reference: tombo/resquiggle.py:754-764)."""
    i = 0
    while read_tb[i] < 0:
        read_tb[i] = 0
        i += 1
    j = 1
    while read_tb[-j] > events_len:
        read_tb[-j] = events_len
        j += 1
    return read_tb


def _adaptive_dp_read(event_means, r_ref_means, r_ref_sds, plan,
                      rsqgl_params: ResquiggleParams, dev, dt):
    """The masked-start adaptive DP and its traceback for one read: K1, or
    the chunked pair K2/K2' where :func:`banded_dp.plan_dp_layout` picks
    it for the read's rows rounded up as the batched path rounds them.
    ``plan`` is :func:`build_masked_start_plan`'s.  Returns (traceback
    (L + 1,) int64, band error, bound error)."""
    p = rsqgl_params
    bw = p.bandwidth
    pstarts, pvalid, pend, P, P_max = plan
    n_ev, L = event_means.shape[0], r_ref_means.shape[0]
    em = np.zeros(n_ev + bw)
    em[:n_ev] = event_means
    em_t, rm_t, rs_t = _device_rows(dev, dt, em, r_ref_means, r_ref_sds)
    i64 = lambda a: torch.as_tensor(np.asarray(a, np.int64)).to(dev)
    args = (em_t, i64([n_ev]), rm_t, rs_t, i64([L]), i64(pstarts),
            i64(pvalid), i64(pend), i64(P))
    dpp = DpParams(z_shift=p.z_shift, skip_pen=p.skip_pen,
                   stay_pen=p.stay_pen, mask_fill_z_score=MASK_FILL_Z_SCORE,
                   max_half_z_score=p.max_half_z_score or -1.0, bandwidth=bw)
    from .batch import _pow2_bucket
    layout = banded_dp.plan_dp_layout(_pow2_bucket(L, 256), bw)
    if layout[0] == "fused":
        out = banded_dp.adaptive_banded_dp_tb(
            *args, dpp, L, P_max, p.band_bound_thresh)
    else:
        out = banded_dp.adaptive_banded_dp_tb_chunked(
            *args, dpp, L, P_max, p.band_bound_thresh, chunk_rows=layout[1])
    segs, band_err, bound_err = (t.cpu().numpy() for t in out[:3])
    return segs[0].astype(np.int64), bool(band_err[0]), bool(bound_err[0])


def find_adaptive_base_assignment(
        valid_cpts, event_means, rsqgl_params: ResquiggleParams, std_ref,
        genome_seq, start_clip_bases=None,
        seq_samp_type=SeqSampleType(config.DNA_SAMP_TYPE, False),
        read_id=None, device: DeviceLike = None, dtype=None) -> DpResults:
    """Adaptive-band assignment of the events to the sequence (reference:
    tombo/resquiggle.py:866-1050): start discovery (K4; the save start
    band, without the score check, when the first fails), then the
    masked-start adaptive DP and traceback (K1 or K2/K2') on the events
    from the clipped start; reads too short for either take the host
    library's static band.  ``read_id`` is kept for the JAX package's
    signature (its debug dump is not ported)."""
    dev = resolve_device(device)
    dt = resolve_dtype(dtype, dev)
    p = rsqgl_params

    def get_short_read_results(r_ref_means, r_ref_sds, genome_seq):
        seq_events = find_static_base_assignment(
            event_means, r_ref_means, r_ref_sds, p)
        seq_segs, rsrtr = get_rel_raw_coords(valid_cpts, seq_events)
        return DpResults(rsrtr, seq_segs, r_ref_means, r_ref_sds, genome_seq)

    if start_clip_bases is not None:
        raise TomboError(
            "start-clip-based read start discovery is not enabled "
            "(reference hardcodes USE_START_CLIP_BASES=False)")

    dnstrm_bases = std_ref.kmer_width - std_ref.central_pos - 1
    r_ref_means, r_ref_sds = std_ref.get_exp_levels_from_seq(genome_seq)
    genome_seq = genome_seq[std_ref.central_pos:-dnstrm_bases]
    seq_len = len(genome_seq)
    if seq_len != r_ref_means.shape[0]:
        raise TomboError("Discordant reference and sequence lengths.")

    if (event_means.shape[0] < p.start_bw + p.start_n_bases or
            seq_len < p.start_n_bases):
        return get_short_read_results(r_ref_means, r_ref_sds, genome_seq)
    try:
        mapped_start, events_per_base = find_seq_start_in_events(
            event_means, r_ref_means, r_ref_sds, p, p.start_n_bases,
            p.start_bw, seq_samp_type, device=dev, dtype=dt)
    except TomboError:
        if event_means.shape[0] < p.start_save_bw + p.start_n_bases:
            return get_short_read_results(r_ref_means, r_ref_sds,
                                          genome_seq)
        mapped_start, events_per_base = find_seq_start_in_events(
            event_means, r_ref_means, r_ref_sds, p, p.start_n_bases,
            p.start_save_bw, device=dev, dtype=dt)

    if events_per_base == 0:
        raise TomboError(
            "Very poor signal quality. Read likely includes open pore.")

    half_bandwidth = p.bandwidth // 2
    if mapped_start < half_bandwidth:
        events_start_clip = 0
        mapped_start_offset = mapped_start
    else:
        events_start_clip = mapped_start - half_bandwidth
        mapped_start_offset = half_bandwidth

    if (int((half_bandwidth + 1) / events_per_base) >= r_ref_means.shape[0]
            or event_means.shape[0] - mapped_start_offset -
            events_start_clip < p.bandwidth):
        return get_short_read_results(r_ref_means, r_ref_sds, genome_seq)

    clipped_event_means = event_means[events_start_clip:]
    plan = build_masked_start_plan(clipped_event_means.shape[0],
                                   mapped_start_offset, p, events_per_base)
    read_tb, band_err, bound_err = _adaptive_dp_read(
        clipped_event_means, r_ref_means, r_ref_sds, plan, p, dev, dt)
    if band_err:
        raise TomboError("Adaptive signal to sequence alignment extended "
                         "beyond raw signal")
    if bound_err:
        raise TomboError(
            "Read event to sequence alignment extends beyond bandwidth")
    read_tb = _trim_traceback(
        read_tb, events_len=event_means.shape[0] - events_start_clip)
    seq_segs, rsrtr = get_rel_raw_coords(valid_cpts[events_start_clip:],
                                         read_tb)
    return DpResults(rsrtr, seq_segs, r_ref_means, r_ref_sds, genome_seq)


def _theil_sen_points(r_event_means, r_model_means,
                      rng: Optional[np.random.Generator] = None):
    """The points of the Theil-Sen line: all of them, or above
    ``MAX_POINTS_FOR_THEIL_SEN`` a draw without replacement from ``rng``
    (default ``np.random.default_rng(0)``)."""
    n = r_model_means.shape[0]
    if n > config.MAX_POINTS_FOR_THEIL_SEN:
        if rng is None:
            rng = np.random.default_rng(0)
        samp = rng.choice(n, config.MAX_POINTS_FOR_THEIL_SEN, replace=False)
        return r_event_means[samp], r_model_means[samp]
    return r_event_means, r_model_means


def _fitted_corrections_device(r_event_means, r_model_means, dev, dt):
    """(shift correction, scale correction) of the Theil-Sen line through
    ``ops/rescale.py::theil_sen_device`` (K5 at float32) at a batch of
    one, computed as the batched path's fit computes them.  The points
    are padded to 256, 512 or 1,000 columns, so few pair-index tables
    are ever built."""
    ev, mod = _theil_sen_points(r_event_means, r_model_means)
    n = ev.shape[0]
    from .batch import _pow2_bucket
    width = max(n, min(_pow2_bucket(n, 256),
                       config.MAX_POINTS_FOR_THEIL_SEN))
    pad = lambda a: np.pad(a, (0, width - n))
    ev_t, mod_t = _device_rows(dev, dt, pad(ev), pad(mod))
    slope, inter = rescale.theil_sen_device(
        ev_t, mod_t, torch.tensor([n], device=dev),
        tri=rescale.tri_indices(width, dev))
    if float(slope[0]) == 0:
        raise TomboError("Read failed sequence-based signal re-scaling "
                         "parameter estimation.")
    scale_corr = 1.0 / slope
    shift_corr = -inter / slope
    return float(shift_corr[0]), float(scale_corr[0])


def resquiggle_read(
        map_res: ResquiggleResults, std_ref,
        rsqgl_params: ResquiggleParams, outlier_thresh=None,
        all_raw_signal=None, max_raw_cpts=MAX_RAW_CPTS,
        min_event_to_seq_ratio=MIN_EVENT_TO_SEQ_RATIO, const_scale=None,
        skip_seq_scaling=False,
        seq_samp_type=SeqSampleType(config.DNA_SAMP_TYPE, False),
        device: DeviceLike = None, dtype=None) -> ResquiggleResults:
    """Assign one read's raw signal to its mapped sequence (reference:
    tombo/resquiggle.py:1122-1214).  ``map_res`` comes from
    :func:`map_read` and :func:`adjust_map_res` with the raw signal set.
    The DP runs on ``device`` (None: the card) in ``dtype`` (float32 by
    default; float64 on the CPU is the parity mode), the fit through K5
    at float32 and in numpy at float64.  Raises :class:`TomboError` on a
    failed read."""
    dev = resolve_device(device)
    dt = resolve_dtype(dtype, dev)
    if all_raw_signal is not None:
        map_res = map_res.replace(raw_signal=all_raw_signal)
    if map_res.raw_signal is None:
        raise TomboError(
            "Must have raw signal in order to complete re-squiggle algorithm")

    num_mapped_bases = len(map_res.genome_seq) - std_ref.kmer_width + 1
    num_events = compute_num_events(
        map_res.raw_signal.shape[0], num_mapped_bases,
        rsqgl_params.mean_obs_per_event, min_event_to_seq_ratio)
    if num_events / rsqgl_params.bandwidth > num_mapped_bases:
        raise TomboError("Too much raw signal for mapped sequence")

    valid_cpts, norm_signal, new_scale_values = segment_signal(
        map_res, num_events, rsqgl_params, outlier_thresh, const_scale)
    event_means = ref_impl.new_means(norm_signal, valid_cpts)

    dp_res = find_adaptive_base_assignment(
        valid_cpts, event_means, rsqgl_params, std_ref, map_res.genome_seq,
        start_clip_bases=map_res.start_clip_bases,
        seq_samp_type=seq_samp_type,
        read_id=(map_res.align_info.read_id
                 if map_res.align_info is not None else None),
        device=dev, dtype=dt)
    norm_signal = norm_signal[
        dp_res.read_start_rel_to_raw:
        dp_res.read_start_rel_to_raw + dp_res.segs[-1]]

    segs = resolve_skipped_bases_with_raw(
        dp_res, norm_signal, rsqgl_params, max_raw_cpts)

    if skip_seq_scaling:
        norm_params_changed = False
    else:
        r_event_means = ref_impl.new_means(norm_signal, segs)
        if dt == torch.float64:
            (shift, scale, shift_corr_factor,
             scale_corr_factor) = calc_kmer_fitted_shift_scale(
                 new_scale_values.shift, new_scale_values.scale,
                 r_event_means, dp_res.ref_means, method="theil_sen")
        else:
            shift_corr_factor, scale_corr_factor = \
                _fitted_corrections_device(r_event_means, dp_res.ref_means,
                                           dev, dt)
            shift = (new_scale_values.shift +
                     shift_corr_factor * new_scale_values.scale)
            scale = new_scale_values.scale * scale_corr_factor
        new_scale_values = new_scale_values.replace(
            shift=shift, scale=scale, outlier_thresh=outlier_thresh)
        norm_signal = (norm_signal - shift_corr_factor) / scale_corr_factor
        norm_params_changed = (
            np.abs(shift_corr_factor) > config.SHIFT_CHANGE_THRESH or
            np.abs(scale_corr_factor - 1) > config.SCALE_CHANGE_THRESH)

    sig_match_score = get_read_seg_score(
        ref_impl.new_means(norm_signal, segs), dp_res.ref_means,
        dp_res.ref_sds)
    if segs.shape[0] != len(dp_res.genome_seq) + 1:
        raise TomboError(
            "Aligned sequence does not match number of segments produced")

    return map_res.replace(
        read_start_rel_to_raw=dp_res.read_start_rel_to_raw, segs=segs,
        genome_seq=dp_res.genome_seq, raw_signal=norm_signal,
        scale_values=new_scale_values, sig_match_score=sig_match_score,
        norm_params_changed=norm_params_changed)


def resquiggle_read_with_retries(
        map_res, std_ref, rsqgl_params, save_params, outlier_thresh=None,
        const_scale=None, skip_seq_scaling=False,
        seq_samp_type=SeqSampleType(config.DNA_SAMP_TYPE, False),
        max_scaling_iters=config.MAX_SCALING_ITERS,
        device: DeviceLike = None, dtype=None):
    """:func:`resquiggle_read` with up to ``max_scaling_iters`` passes
    while the fitted scale changes, and a failed read run again at the
    save parameters (reference: tombo/resquiggle.py:1488-1600
    ``_resquiggle_worker``)."""
    dev = resolve_device(device)

    def run_iters(params):
        kw = dict(const_scale=const_scale, skip_seq_scaling=skip_seq_scaling,
                  seq_samp_type=seq_samp_type, device=dev, dtype=dtype)
        rsqgl_res = resquiggle_read(map_res, std_ref, params,
                                    outlier_thresh, **kw)
        n_iters = 1
        while (n_iters < max_scaling_iters and
               rsqgl_res.norm_params_changed):
            rsqgl_res = resquiggle_read(
                map_res.replace(scale_values=rsqgl_res.scale_values),
                std_ref, params, outlier_thresh, **kw)
            n_iters += 1
        return rsqgl_res

    try:
        return run_iters(rsqgl_params)
    except TomboError:
        return run_iters(save_params)


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
