"""numpy host kernels for the rare host-lane reads, RNA adapter trimming
and stall detection, and the oracles of the one-read path (subset copy of
``tombo_tpu/ops/ref_impl.py``; reference: tombo/_c_helper.pyx,
tombo/_c_dynamic_programming.pyx).  Float64 throughout."""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..errors import TomboError


def mean_std(values: np.ndarray) -> Tuple[float, float]:
    """Mean and population standard deviation (reference:
    tombo/_c_helper.pyx:22 ``c_mean_std``)."""
    values = np.asarray(values, dtype=np.float64)
    return float(values.mean()), float(values.std())


def new_means(norm_signal: np.ndarray, segs: np.ndarray) -> np.ndarray:
    """Per-segment means by prefix-sum differences."""
    norm_signal = np.asarray(norm_signal, dtype=np.float64)
    segs = np.asarray(segs, dtype=np.int64)
    cs = np.concatenate([[0.0], np.cumsum(norm_signal)])
    return (cs[segs[1:]] - cs[segs[:-1]]) / np.diff(segs)


def new_mean_stds(norm_signal: np.ndarray, segs: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-segment means and population SDs (reference:
    tombo/_c_helper.pyx:38 ``c_new_mean_stds``)."""
    norm_signal = np.asarray(norm_signal, dtype=np.float64)
    segs = np.asarray(segs, dtype=np.int64)
    cs = np.concatenate([[0.0], np.cumsum(norm_signal)])
    cs2 = np.concatenate([[0.0], np.cumsum(norm_signal ** 2)])
    lens = np.diff(segs).astype(np.float64)
    means = (cs[segs[1:]] - cs[segs[:-1]]) / lens
    ex2 = (cs2[segs[1:]] - cs2[segs[:-1]]) / lens
    return means, np.sqrt(np.maximum(ex2 - means ** 2, 0.0))


def apply_outlier_thresh(raw_signal: np.ndarray, lower_lim: float,
                         upper_lim: float) -> np.ndarray:
    """Clip the signal into [lower_lim, upper_lim] (reference:
    tombo/_c_helper.pyx:73 ``c_apply_outlier_thresh``)."""
    return np.clip(np.asarray(raw_signal, dtype=np.float64), lower_lim,
                   upper_lim)


# --------------------------------------------------- event detection
def cpt_scores_diff(raw_signal: np.ndarray, running_stat_width: int
                    ) -> np.ndarray:
    """DNA changepoint score |sum(left w) - sum(right w)| (reference:
    tombo/_c_helper.pyx:89-98)."""
    cs = np.concatenate([[0.0], np.cumsum(np.asarray(raw_signal,
                                                     np.float64))])
    w = running_stat_width
    return np.abs(2.0 * cs[w:-w] - cs[:-2 * w] - cs[2 * w:])


def cpt_scores_t_test(raw_signal: np.ndarray, running_stat_width: int
                      ) -> np.ndarray:
    """RNA changepoint score |m1 - m2| / sqrt(ss1 + ss2) over two adjacent
    windows, a monotonic transform of the Welch t-score (reference:
    tombo/_c_helper.pyx:144-179)."""
    x = np.asarray(raw_signal, dtype=np.float64)
    w = running_stat_width
    n_cands = x.shape[0] - 2 * w
    if n_cands <= 0:
        return np.empty(0, dtype=np.float64)
    cs = np.concatenate([[0.0], np.cumsum(x)])
    cs2 = np.concatenate([[0.0], np.cumsum(x ** 2)])

    def win_stats(off):
        s = cs[off + w:off + w + n_cands] - cs[off:off + n_cands]
        s2 = cs2[off + w:off + w + n_cands] - cs2[off:off + n_cands]
        return s / w, s2 - (s * s) / w

    m1, ss1 = win_stats(0)
    m2, ss2 = win_stats(w)
    denom = ss1 + ss2
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.abs(m1 - m2) / np.sqrt(denom)
    t[denom == 0] = 0.0
    return t


def greedy_select_cpts(scores: np.ndarray, min_base_obs: int,
                       num_cpts: int) -> np.ndarray:
    """Greedy top-``num_cpts`` selection in the order of
    ``np.argsort(scores)[::-1]`` with a min-spacing blacklist (reference:
    tombo/_c_helper.pyx:100-120); unshifted positions in acceptance
    order."""
    order = np.argsort(scores, kind="stable")[::-1]
    if num_cpts <= 0:
        return np.empty(0, dtype=np.int64)
    accepted = np.empty(num_cpts, dtype=np.int64)
    blacklist = np.zeros(scores.shape[0] + 2 * min_base_obs, dtype=bool)
    n_accepted = 0
    for cand in order:
        if blacklist[cand + min_base_obs]:
            continue
        accepted[n_accepted] = cand
        n_accepted += 1
        if n_accepted == num_cpts:
            return accepted
        blacklist[cand + 1:cand + 2 * min_base_obs] = True
    raise TomboError("Fewer changepoints found than requested")


def _sorted_cpts(scores, min_base_obs, running_stat_width, num_cpts):
    cpts = greedy_select_cpts(scores, min_base_obs, num_cpts)
    cpts = cpts + running_stat_width
    cpts.sort()
    return cpts


def valid_cpts_w_cap(raw_signal: np.ndarray, min_base_obs: int,
                     running_stat_width: int, num_cpts: int) -> np.ndarray:
    """DNA event detection, sorted (reference: tombo/_c_helper.pyx:89
    ``c_valid_cpts_w_cap``)."""
    return _sorted_cpts(cpt_scores_diff(raw_signal, running_stat_width),
                        min_base_obs, running_stat_width, num_cpts)


def valid_cpts_w_cap_t_test(raw_signal: np.ndarray, min_base_obs: int,
                            running_stat_width: int, num_cpts: int
                            ) -> np.ndarray:
    """RNA event detection, sorted (reference: tombo/_c_helper.pyx:144
    ``c_valid_cpts_w_cap_t_test``)."""
    return _sorted_cpts(cpt_scores_t_test(raw_signal, running_stat_width),
                        min_base_obs, running_stat_width, num_cpts)


def valid_cpts(raw_signal: np.ndarray, min_base_obs: int,
               running_stat_width: int) -> np.ndarray:
    """Uncapped changepoint detection (reference: tombo/_c_helper.pyx:122
    ``c_valid_cpts``); this variant blacklists one more position on the
    right (``+ min_base_obs + 1``)."""
    scores = cpt_scores_diff(raw_signal, running_stat_width)
    order = np.argsort(scores, kind="stable")[::-1]
    accepted = [order[0]]
    blacklist = np.zeros(scores.shape[0] + 2 * min_base_obs + 2, dtype=bool)
    for cand in order[1:]:
        if blacklist[cand + min_base_obs]:
            continue
        accepted.append(cand)
        blacklist[cand + 1:cand + 2 * min_base_obs + 1] = True
    return np.array(accepted, dtype=np.int64) + running_stat_width


def compute_running_pctl_diffs(arr: np.ndarray, window_size: int,
                               lower_pctl: float, upper_pctl: float
                               ) -> np.ndarray:
    """Rolling-window (upper - lower) percentile difference, the order
    statistics ``int((w - 1) * pctl / 100)`` of each sorted window
    (reference: tombo/_c_helper.pyx:221 ``c_compute_running_pctl_diffs``)."""
    arr = np.asarray(arr)
    w = int(window_size)
    lo_idx = int((w - 1) * lower_pctl / 100.0)
    hi_idx = int((w - 1) * upper_pctl / 100.0)
    if arr.shape[0] - w + 1 <= 0:
        return np.empty(0, dtype=arr.dtype)
    windows = np.lib.stride_tricks.sliding_window_view(arr, w)
    part = np.partition(windows, (lo_idx, hi_idx), axis=1)
    return part[:, hi_idx] - part[:, lo_idx]


# ---------------------------------------------------------- banded DP
def base_z_scores(b_sig: np.ndarray, ref_mean: float, ref_sd: float,
                  do_winsorize_z: bool = False,
                  max_half_z_score: float = 10.0) -> np.ndarray:
    """Lower-tail half z-scores of observations against one (mean, sd),
    optionally winsorized (reference: tombo/_c_dynamic_programming.pyx:17
    ``c_base_z_scores``)."""
    z = -np.abs((np.asarray(b_sig, np.float64) - ref_mean) / ref_sd)
    if do_winsorize_z:
        z = np.maximum(z, -max_half_z_score)
    return z


def process_band_row(prev_fwd, shifted_z, first_val, first_move, stay_pen,
                     skip_pen, band_starts_diff):
    """One band row as a max-plus prefix scan (stay > diag > skip)."""
    bandwidth = shifted_z.shape[0]
    prev_b_pos = np.arange(bandwidth) + band_starts_diff
    diag_idx = prev_b_pos - 1
    diag_valid = (diag_idx >= 0) & (diag_idx < bandwidth)
    diag_score = np.where(
        diag_valid, prev_fwd[np.clip(diag_idx, 0, bandwidth - 1)],
        -np.inf) + shifted_z
    skip_valid = prev_b_pos < bandwidth
    skip_score = np.where(
        skip_valid, prev_fwd[np.clip(prev_b_pos, 0, bandwidth - 1)],
        -np.inf) - skip_pen
    d = np.maximum(diag_score, skip_score)
    s = shifted_z - stay_pen
    c = np.concatenate([[0.0], np.cumsum(s[1:])])
    u = d - c
    u[0] = first_val
    fwd = c + np.maximum.accumulate(u)
    stay_score = np.empty(bandwidth)
    stay_score[0] = -np.inf
    stay_score[1:] = fwd[:-1] - stay_pen + shifted_z[1:]
    moves = np.zeros(bandwidth, dtype=np.int8)
    moves[diag_score > stay_score] = 2
    moves[skip_score > np.maximum(stay_score, diag_score)] = 1
    moves[0] = first_move
    fwd[0] = first_val
    return fwd, moves


def banded_forward_pass(shifted_z_scores, event_starts, skip_pen, stay_pen):
    """Static-band DP over a precomputed z-score matrix."""
    n_bases, bandwidth = shifted_z_scores.shape
    fwd_pass = np.empty((n_bases + 1, bandwidth), dtype=np.float64)
    fwd_pass_tb = np.zeros((n_bases + 1, bandwidth), dtype=np.int8)
    fwd_pass[0] = 0.0
    for seq_pos in range(n_bases):
        diff = (event_starts[seq_pos] - event_starts[seq_pos - 1]
                if seq_pos > 0 else 0)
        if diff == 0:
            first_val = fwd_pass[seq_pos, 0] - skip_pen
            first_move = 1
        else:
            first_val = (fwd_pass[seq_pos, diff - 1] +
                         shifted_z_scores[seq_pos, 0])
            first_move = 2
        fwd_pass[seq_pos + 1], fwd_pass_tb[seq_pos + 1] = process_band_row(
            fwd_pass[seq_pos], shifted_z_scores[seq_pos], first_val,
            first_move, stay_pen, skip_pen, diff)
    return fwd_pass, fwd_pass_tb


def adaptive_banded_forward_pass(
        fwd_pass: np.ndarray, fwd_pass_tb: np.ndarray,
        event_starts: np.ndarray, event_means: np.ndarray,
        r_ref_means: np.ndarray, r_ref_sds: np.ndarray, z_shift: float,
        skip_pen: float, stay_pen: float, start_seq_pos: int,
        mask_fill_z_score: float, do_winsorize_z: bool,
        max_half_z_score: float, return_z_scores: bool = False
        ) -> Optional[np.ndarray]:
    """Adaptive-band DP from row ``start_seq_pos``: each row's band starts
    at the previous row's argmax less half the band (never before the
    previous start), its shifted winsorized z-scores fill it (the mask
    fill past the last event), then the band recurrence (reference:
    tombo/_c_dynamic_programming.pyx:314
    ``c_adaptive_banded_forward_pass``).  Fills ``fwd_pass``,
    ``fwd_pass_tb`` and ``event_starts`` in place; returns the rows'
    z-scores with ``return_z_scores``."""
    n_bases = fwd_pass.shape[0] - 1
    bandwidth = fwd_pass.shape[1]
    half_bandwidth = bandwidth // 2
    n_events = event_means.shape[0]
    all_z = (np.empty((n_bases - start_seq_pos, bandwidth))
             if return_z_scores else None)
    for seq_pos in range(start_seq_pos, n_bases):
        prev_band_start = event_starts[seq_pos - 1]
        curr_band_start = (prev_band_start +
                           int(np.argmax(fwd_pass[seq_pos])) -
                           half_bandwidth + 1)
        if curr_band_start < prev_band_start:
            curr_band_start = prev_band_start
        if curr_band_start >= n_events:
            if seq_pos < n_bases - 2:
                raise TomboError(
                    "Adaptive signal to sequence alignment extended beyond "
                    "raw signal")
            curr_band_start = n_events - 1
        event_starts[seq_pos] = curr_band_start

        n_valid = min(bandwidth, n_events - curr_band_start)
        z = -np.abs((event_means[curr_band_start:curr_band_start + n_valid]
                     - r_ref_means[seq_pos]) / r_ref_sds[seq_pos])
        if do_winsorize_z:
            z = np.maximum(z, -max_half_z_score)
        shifted_z = np.full(bandwidth, mask_fill_z_score, dtype=np.float64)
        shifted_z[:n_valid] = z_shift + z
        if return_z_scores:
            all_z[seq_pos - start_seq_pos] = shifted_z

        diff = curr_band_start - prev_band_start
        if diff == 0:
            first_val = fwd_pass[seq_pos, 0] - skip_pen
            first_move = 1
        else:
            first_val = fwd_pass[seq_pos, diff - 1] + shifted_z[0]
            first_move = 2
        fwd_pass[seq_pos + 1], fwd_pass_tb[seq_pos + 1] = process_band_row(
            fwd_pass[seq_pos], shifted_z, first_val, first_move, stay_pen,
            skip_pen, diff)
    return all_z


def banded_traceback(fwd_pass_tb, event_starts, band_pos,
                     band_boundary_thresh: int = -1) -> np.ndarray:
    n_bases = fwd_pass_tb.shape[0] - 1
    bandwidth = fwd_pass_tb.shape[1]
    seq_poss = np.empty(n_bases + 1, dtype=np.int64)
    curr_event_pos = band_pos + event_starts[n_bases - 1]
    seq_poss[n_bases] = curr_event_pos + 1
    for curr_seq_pos in range(n_bases, 0, -1):
        band_pos = curr_event_pos - event_starts[curr_seq_pos - 1]
        while fwd_pass_tb[curr_seq_pos, band_pos] == 0:
            band_pos -= 1
        if fwd_pass_tb[curr_seq_pos, band_pos] == 2:
            band_pos -= 1
        if (band_boundary_thresh >= 0 and
                min(band_pos, bandwidth - band_pos - 1) <
                band_boundary_thresh):
            raise TomboError(
                "Read event to sequence alignment extends beyond bandwidth")
        curr_event_pos = event_starts[curr_seq_pos - 1] + band_pos
        seq_poss[curr_seq_pos - 1] = curr_event_pos + 1
    return seq_poss


# ------------------------------------------------- raw-signal (del fix) DP
def reg_z_scores(r_sig, r_ref_means, r_ref_sds, r_b_starts, reg_start: int,
                 reg_end: int, max_base_shift: int, min_obs_per_base: int,
                 max_half_z_score: Optional[float] = None
                 ) -> List[Tuple[np.ndarray, Tuple[int, int]]]:
    do_winsorize = max_half_z_score is not None
    reg_len = reg_end - reg_start
    base_range = np.arange(reg_start, reg_end)
    sig_starts = np.empty(reg_len, dtype=np.int64)
    prev_start = None
    for idx, base_i in enumerate(base_range):
        b_start = r_b_starts[max(reg_start, base_i - max_base_shift)]
        if prev_start is not None and b_start < prev_start + min_obs_per_base:
            b_start = prev_start + min_obs_per_base
        sig_starts[idx] = b_start
        prev_start = b_start
    sig_ends = np.empty(reg_len, dtype=np.int64)
    prev_end = None
    for ridx, base_i in enumerate(base_range[::-1]):
        b_end = r_b_starts[min(reg_end, base_i + max_base_shift + 1)]
        if prev_end is not None and b_end > prev_end - min_obs_per_base:
            b_end = prev_end - min_obs_per_base
        sig_ends[reg_len - ridx - 1] = b_end
        prev_end = b_end
    out = []
    reg_sig_offset = r_b_starts[reg_start]
    for idx, base_i in enumerate(base_range):
        b_start, b_end = sig_starts[idx], sig_ends[idx]
        z = -np.abs((np.asarray(r_sig[b_start:b_end], np.float64) -
                     r_ref_means[base_i]) / r_ref_sds[base_i])
        if do_winsorize:
            z = np.maximum(z, -max_half_z_score)
        out.append((z, (b_start - reg_sig_offset, b_end - reg_sig_offset)))
    return out


def base_forward_pass(b_data, b_start, b_end, prev_b_data, prev_b_start,
                      prev_b_end, prev_b_fwd_data, prev_b_last_diag,
                      min_obs_per_base):
    b_len = b_end - b_start
    b_fwd_data = np.empty(b_len, dtype=np.float64)
    b_last_diag = np.empty(b_len, dtype=np.int64)
    prev_cumsum = np.cumsum(prev_b_data)
    b_fwd_data[0] = b_data[0] + prev_b_fwd_data[b_start - prev_b_start - 1]
    b_last_diag[0] = 1
    for pos in range(b_start + 1, prev_b_end + 1):
        lag = 1
        while (prev_b_last_diag[pos - prev_b_start - lag] + lag
               <= min_obs_per_base):
            lag += 1
        diag_score = prev_b_fwd_data[pos - prev_b_start - lag]
        if lag > 1:
            diag_score += (prev_cumsum[pos - prev_b_start - 1] -
                           prev_cumsum[pos - prev_b_start - lag])
        stay_score = b_fwd_data[pos - b_start - 1]
        if diag_score > stay_score:
            pos_score, pos_diag = diag_score, 1
        else:
            pos_score = stay_score
            pos_diag = b_last_diag[pos - b_start - 1] + 1
        b_fwd_data[pos - b_start] = b_data[pos - b_start] + pos_score
        b_last_diag[pos - b_start] = pos_diag
    if b_end > prev_b_end + 1:
        start_i = prev_b_end - b_start
        fwd_value = b_fwd_data[start_i]
        last_diag = b_last_diag[start_i]
        for i in range(start_i + 1, b_len):
            fwd_value += b_data[i]
            last_diag += 1
            b_fwd_data[i] = fwd_value
            b_last_diag[i] = last_diag
    return b_fwd_data, b_last_diag


def base_traceback(curr_b_data, curr_start, next_b_data, next_start,
                   next_end, sig_start, min_obs_per_base):
    curr_base_sig = 1
    for sig_pos in range(sig_start, -1, -1):
        curr_base_sig += 1
        if curr_base_sig <= min_obs_per_base or sig_pos - 1 >= next_end:
            continue
        if (sig_pos <= curr_start or
                next_b_data[sig_pos - next_start - 1] >
                curr_b_data[sig_pos - curr_start - 1]):
            return sig_pos
    raise TomboError("Raw-signal traceback failed to find boundary")


def raw_forward_pass(reg_zs, min_obs_per_base):
    prev_b_data, (prev_b_start, prev_b_end) = reg_zs[0]
    prev_b_fwd_data = np.cumsum(prev_b_data)
    prev_b_last_diag = np.full(prev_b_end - prev_b_start, min_obs_per_base,
                               dtype=np.int64)
    reg_fwd_scores = [(prev_b_fwd_data, prev_b_last_diag,
                       (prev_b_start, prev_b_end))]
    for b_data, (b_start, b_end) in reg_zs[1:]:
        b_fwd_data, prev_b_last_diag = base_forward_pass(
            b_data, b_start, b_end, prev_b_data, prev_b_start, prev_b_end,
            prev_b_fwd_data, prev_b_last_diag, min_obs_per_base)
        reg_fwd_scores.append(
            (b_fwd_data, prev_b_last_diag, (b_start, b_end)))
        prev_b_data, prev_b_fwd_data, prev_b_start, prev_b_end = (
            b_data, b_fwd_data, b_start, b_end)
    return reg_fwd_scores


def raw_traceback(reg_fwd_scores, min_obs_per_base):
    new_segs = np.empty(len(reg_fwd_scores) - 1, dtype=np.int64)
    curr_b_data, _, (curr_start, curr_end) = reg_fwd_scores[-1]
    next_b_data, _, (next_start, next_end) = reg_fwd_scores[-2]
    new_segs[-1] = base_traceback(
        curr_b_data, curr_start, next_b_data, next_start, next_end,
        curr_end - 1, min_obs_per_base)
    for base_pos in range(len(reg_fwd_scores) - 3, -1, -1):
        curr_b_data, curr_start = next_b_data, next_start
        next_b_data, _, (next_start, next_end) = reg_fwd_scores[base_pos]
        new_segs[base_pos] = base_traceback(
            curr_b_data, curr_start, next_b_data, next_start, next_end,
            new_segs[base_pos + 1] - 1, min_obs_per_base)
    return new_segs


def compute_slopes(r_event_means: np.ndarray, r_model_means: np.ndarray,
                   max_slope: float = 1000.0) -> np.ndarray:
    """All-pairs slopes of the Theil-Sen estimator, (i < j) pairs in
    ``itertools.combinations`` order; pairs of equal event means get
    ``max_slope`` (reference: tombo/_c_helper.pyx:362
    ``c_compute_slopes``)."""
    n = r_event_means.shape[0]
    iu = np.triu_indices(n, k=1)
    de = r_event_means[iu[0]] - r_event_means[iu[1]]
    dm = r_model_means[iu[0]] - r_model_means[iu[1]]
    with np.errstate(divide="ignore", invalid="ignore"):
        slopes = dm / de
    slopes[de == 0] = max_slope
    return slopes
