"""Host (numpy) pieces of re-squiggle that the batched path calls
(subset copy of ``tombo_tpu/pipeline/resquiggle.py``; reference:
tombo/resquiggle.py): event counts, read mapping, traceback trimming and
raw coordinates, the short-read static assignment, and the deletion-fix
window planner and numpy fix for host-lane reads."""
from __future__ import annotations

import numpy as np

from .. import config
from ..config import (DEL_FIX_WINDOW, EXTRA_SIG_FACTOR, MAX_DEL_FIX_WINDOW,
                      MAX_RAW_CPTS, MIN_EVENT_TO_SEQ_RATIO, ResquiggleParams)
from ..errors import TomboError
from ..ops import ref_impl
from ..seq import rev_comp
from ..types import (AlignInfo, DpResults, GenomeLocation, ResquiggleResults,
                     SeqSampleType, SequenceData)


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


def adjust_map_res(map_res: ResquiggleResults, seq_samp_type: SeqSampleType,
                   rsqgl_params: ResquiggleParams) -> ResquiggleResults:
    """Pre-resquiggle signal adjustments.  DNA needs none (no stall
    collapsing by default); RNA is a later slice."""
    if seq_samp_type.name != config.DNA_SAMP_TYPE:
        raise NotImplementedError(
            "RNA re-squiggle is not ported yet (ROADMAP.md, Queue 1: RNA)")
    return map_res


def map_read(seq_data: SequenceData, aligner, std_ref,
             seq_samp_type=SeqSampleType(config.DNA_SAMP_TYPE, False),
             bc_subgrp="BaseCalled_template") -> ResquiggleResults:
    """Map basecalls and extract the k-mer-context-expanded genome
    sequence (reference: tombo/resquiggle.py:1278 ``map_read``)."""
    if seq_samp_type.name != config.DNA_SAMP_TYPE:
        raise NotImplementedError(
            "RNA re-squiggle is not ported yet (ROADMAP.md, Queue 1: RNA)")
    alignment = aligner.map(str(seq_data.seq))
    if alignment is None:
        raise TomboError("Alignment not produced")
    chrm, ref_start, ref_end = alignment.ctg, alignment.r_st, alignment.r_en
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

    # expand to cover model-able positions (DNA, no start-clip bases)
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
