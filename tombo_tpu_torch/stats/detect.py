"""Modified-base detection on one host or several: the de novo,
model-sample-compare and alternative-model per-read tests, the group
level tests (KS, U, t) and per-read statistics, through the device lane
(counterpart of ``tombo_tpu/stats/detect.py:55-1147, 1194-1544,
1604-1613``).

:func:`iter_region_stats` is the region loop of the JAX
``test_significance`` with the writers lifted out: it chunks the covered
regions, prepares each chunk's region jobs on a thread pool, runs the
chunk on the device and yields each region's statistics in region order,
opening no file of its own (the card path reads its levels from the
device-resident means of re-squiggle).  :func:`test_significance`
consumes it and writes the statistics files.

Over several hosts (a ``parallel/distributed.py::DistContext``), model
statistics shard reads: each host runs only the reads it owns through the
same lane, keeps each region's dense (coverage, valid coverage, above)
counts before they become ``RegionStats``, and ``psum_hosts`` sums a
chunk's counts over the hosts in one gather.  Level statistics shard
regions: the owning host tests a region with all its reads, the others
add zeros.  Chunks are cut from the full index, which every host holds,
and merged on the calling thread in region order, so every host runs the
same collectives and ends with the same statistics as one host.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import config
from ..device import DeviceLike, resolve_device, resolve_dtype
from ..errors import TomboError
from ..io.model_io import AltModel, KmerModel
from ..parallel import distributed
from ..seq import encode_seq, rev_comp, seq_to_kmer_codes
from ..types import GroupStats, RegionStats
from . import device as dev_lane
from . import levels_cache
from .files import (ALT_MODEL_TXT, DE_NOVO_TXT, KS_STAT_TEST_TXT,
                    KS_TEST_TXT, LEVEL_STATS_TXTS, PER_READ_STATS,
                    SAMP_COMP_TXT, T_STAT_TEST_TXT, T_TEST_TXT,
                    U_STAT_TEST_TXT, U_TEST_TXT, LevelStats, ModelStats,
                    PerReadStats)
from .kernels import calc_window_fishers_method, calc_window_means
from .region import ReadLevels, RegionData

# a chunk of regions is one packed pass: up to this many site-observations
# and regions (the JAX lane's defaults)
CHUNK_OBS = 1_500_000
CHUNK_REGIONS = 64
# regions of one level-test dispatch (the JAX lane's default)
LEVEL_CHUNK_REGIONS = 16


@dataclass
class TestParams:
    """Testing configuration (reference: the argparse layer and
    tombo/_default_parameters.py:107-140)."""
    stat_type: str
    fm_offset: int = config.FM_OFFSET_DEFAULT
    min_test_reads: int = 1
    single_read_thresh: Optional[float] = None
    lower_thresh: Optional[float] = None
    region_size: int = config.DEFAULT_REGION_SIZE
    prior_weights: Tuple[float, float] = (config.MEAN_PRIOR_CONST,
                                          config.SD_PRIOR_CONST)
    use_standard_llhr: bool = False
    num_most_signif: int = 100000
    cov_damp_counts: Tuple[float, float] = config.COV_DAMP_COUNTS


def _check_stat_type(stat_type: str):
    if stat_type not in PER_READ_STATS + LEVEL_STATS_TXTS:
        raise TomboError("unknown statistic type %r" % stat_type)


def _lags(std_ref: KmerModel, strand: str) -> Tuple[int, int]:
    """(begin_lag, end_lag): k-mer bases before and after the central
    base, in genome order."""
    dnstrm = std_ref.kmer_width - std_ref.central_pos - 1
    if strand == "+":
        return std_ref.central_pos, dnstrm
    return dnstrm, std_ref.central_pos


def _oriented_seq(reg_data: RegionData, fasta, seq_start: int,
                  seq_end: int) -> str:
    """Reference bases [seq_start, seq_end), N-padded past the
    chromosome's ends (N windows give NaN levels), reverse complemented
    on the '-' strand."""
    reg_seq = fasta.get_seq(reg_data.chrm, max(seq_start, 0), seq_end,
                            error_end=False)
    if seq_start < 0:
        reg_seq = "N" * -seq_start + reg_seq
    if len(reg_seq) < seq_end - seq_start:
        reg_seq = reg_seq + "N" * (seq_end - seq_start - len(reg_seq))
    return rev_comp(reg_seq) if reg_data.strand == "-" else reg_seq


# --------------------------------------------------------------------------
# control-sample levels (reference: tombo/tombo_stats.py:3572-3674)
# --------------------------------------------------------------------------

def compute_posterior_samp_dists(ctrl_means, ctrl_sds, ctrl_cov,
                                 ctrl_reg_data, fasta, std_ref,
                                 prior_weights, fm_offset):
    """Control-sample level estimates sharpened with the model's levels
    as priors (reference: tombo/tombo_stats.py:3572-3626)."""
    begin_lag, end_lag = _lags(std_ref, ctrl_reg_data.strand)
    reg_seq = _oriented_seq(ctrl_reg_data, fasta,
                            ctrl_reg_data.start - begin_lag - fm_offset,
                            ctrl_reg_data.end + end_lag + fm_offset)
    reg_ref_means, reg_ref_sds = std_ref.get_exp_levels_from_seq_with_gaps(
        reg_seq, ctrl_reg_data.strand == "-")
    post_means = ((prior_weights[0] * reg_ref_means +
                   ctrl_cov * ctrl_means) / (prior_weights[0] + ctrl_cov))
    post_sds = ((prior_weights[1] * reg_ref_sds + ctrl_cov * ctrl_sds) /
                (prior_weights[1] + ctrl_cov))
    return post_means, post_sds


def get_reads_ref(reg_data: RegionData, fasta, min_test_reads: int,
                  fm_offset: int, std_ref: Optional[KmerModel] = None,
                  prior_weights=None, device: Optional[torch.device] = None):
    """Per-site median level and SD of a control sample over the region
    and ``fm_offset`` bases each side (reference:
    tombo/tombo_stats.py:3627-3674).  ``device``: serve device-resident
    means of that device type first."""
    reg_size = reg_data.end - reg_data.start + fm_offset * 2
    level_means = np.full(reg_size, np.nan)
    level_sds = np.full(reg_size, np.nan)
    exp_reg = reg_data.copy_update(reg_data.start - fm_offset,
                                   reg_data.end + fm_offset)
    bases_levels = exp_reg.get_base_levels(device)
    valid = ~np.isnan(bases_levels)
    cov = valid.sum(axis=1)
    ok = cov >= min_test_reads
    # sites of equal coverage in one (sites, coverage) matrix each: numpy
    # reduces each row as it reduces the row alone, so the medians and
    # SDs are bitwise the JAX package's per-site loop, at a fraction of
    # its host time
    idx = np.where(ok)[0]
    for n in np.unique(cov[idx]):
        rows = idx[cov[idx] == n]
        vals = bases_levels[rows][valid[rows]].reshape(rows.shape[0], n)
        level_means[rows] = np.median(vals, axis=1)
        level_sds[rows] = np.std(vals, axis=1)
    if std_ref is not None:
        if prior_weights is None:
            prior_weights = (config.MEAN_PRIOR_CONST, config.SD_PRIOR_CONST)
        level_means, level_sds = compute_posterior_samp_dists(
            level_means, level_sds, cov, reg_data, fasta, std_ref,
            prior_weights, fm_offset)
    cov_d = dict(zip(range(reg_data.start - fm_offset,
                           reg_data.end + fm_offset), cov))
    zero_sd = level_sds == 0
    level_means[zero_sd] = np.nan
    level_sds[zero_sd] = np.nan
    return level_means, level_sds, cov_d


# --------------------------------------------------------------------------
# per-read statistics and their per-site aggregation (reference:
# tombo/tombo_stats.py:4084-4180)
# --------------------------------------------------------------------------

def apply_per_read_thresh(stats: np.ndarray, poss: np.ndarray, chrm: str,
                          strand: str, start: int,
                          single_read_thresh: float,
                          lower_thresh: Optional[float],
                          stat_type: str) -> Optional[RegionStats]:
    """A region's per-site fractions from its per-read statistics (the
    JAX per-site lists of ``detect.py:402``, in array form; NaN
    statistics left out, None when none is left): the
    :func:`site_accumulators` of the span the positions cover, unpacked
    by :func:`region_stats_from_accumulators`."""
    keep = ~np.isnan(stats)
    if not keep.any():
        return None
    lo, hi = int(poss[keep].min()), int(poss[keep].max())
    return region_stats_from_accumulators(
        chrm, strand, start, lo, *site_accumulators(
            stats, poss, lo, hi - lo + 1, single_read_thresh, lower_thresh,
            stat_type), None, stat_type)


def site_accumulators(stats: np.ndarray, poss: np.ndarray, span_lo: int,
                      span_n: int, single_read_thresh: float,
                      lower_thresh: Optional[float], stat_type: str):
    """Dense (coverage, valid coverage, above-threshold) counts over a
    span from per-read statistics at genome positions, NaN left out;
    they add across hosts (counterpart of
    ``tombo_tpu/stats/detect.py:477``).  Above: at or above
    ``single_read_thresh``.  Valid: at or below ``lower_thresh`` or above
    when there is a lower threshold, |stat| at or above the threshold for
    the alternative-model test, every statistic otherwise."""
    keep = ~np.isnan(stats)
    stats, rel = stats[keep], poss[keep] - span_lo
    if rel.shape[0] and (rel.min() < 0 or rel.max() >= span_n):
        raise TomboError("Per-read statistic position outside accumulator "
                         "span")
    if lower_thresh is not None:
        is_valid = (stats <= lower_thresh) | (stats >= single_read_thresh)
    elif stat_type == ALT_MODEL_TXT:
        is_valid = np.abs(stats) >= single_read_thresh
    else:
        is_valid = np.ones(stats.shape[0], bool)
    return (np.bincount(rel, minlength=span_n),
            np.bincount(rel[is_valid], minlength=span_n),
            np.bincount(rel[stats >= single_read_thresh], minlength=span_n))


def per_read_block(stats_l, locs_l, read_ids, reg_data: RegionData,
                   stat_name: str):
    """A region's per-read statistics block for ``PerReadStats``:
    (stat_name, (pos u4, stat f8, read_id u4) records, {read id: number},
    chrm, strand, start), or None with no valid statistic.  ``read_ids``:
    one (read id, statistic count) per entry of ``stats_l``.  Read ids
    are numbered in order of first appearance (the JAX package numbers
    them in a Python set's order, which varies between processes)."""
    stats = np.concatenate(stats_l)
    locs = np.concatenate(locs_l)
    owner = np.repeat(np.arange(len(read_ids)),
                      [n for _, n in read_ids])
    valid = ~np.isnan(stats)
    if not valid.any():
        return None
    lookup: Dict[str, int] = {}
    for i in np.unique(owner[valid]):
        lookup.setdefault(read_ids[i][0], len(lookup))
    num = np.array([lookup.get(rid, 0) for rid, _ in read_ids], np.int64)
    block = np.empty(int(valid.sum()), dtype=[("pos", "u4"), ("stat", "f8"),
                                              ("read_id", "u4")])
    block["pos"] = locs[valid]
    block["stat"] = stats[valid]
    block["read_id"] = num[owner[valid]]
    return (stat_name, block, lookup, reg_data.chrm, reg_data.strand,
            reg_data.start)


# --------------------------------------------------------------------------
# region jobs and the packed lane
# --------------------------------------------------------------------------

def _accum_span(reg_data: RegionData, params: TestParams):
    """(first position, width) of a region's dense accumulators: per-read
    statistics reach ``fm_offset`` (plus k-mer lags) past the region."""
    margin = params.fm_offset + 16
    return reg_data.start - margin, (reg_data.end - reg_data.start) + \
        2 * margin


def region_stats_from_accumulators(chrm: str, strand: str, start: int,
                                   span_lo: int, cov, valid, above,
                                   ctrl_cov_dense,
                                   stat_type) -> Optional[RegionStats]:
    """The ``RegionStats`` of the region at (chrm, strand, start) from its
    dense (coverage, valid coverage, above-threshold) accumulators over a
    span from ``span_lo``; None with no covered site."""
    poss = np.where(cov > 0)[0]
    if poss.shape[0] == 0:
        return None
    with np.errstate(invalid="ignore"):
        frac_std = np.where(valid[poss] > 0,
                            above[poss] / np.maximum(valid[poss], 1),
                            np.nan)
    if stat_type == SAMP_COMP_TXT and ctrl_cov_dense is not None:
        out_ctrl = ctrl_cov_dense[poss]
    else:
        out_ctrl = np.zeros(poss.shape[0], np.int64)
    return RegionStats(frac_std, poss + span_lo, chrm, strand, start,
                       cov[poss], np.asarray(out_ctrl), valid[poss])


def _span_exp_codes(reg_data: RegionData, fasta, std_ref: KmerModel,
                    span_lo: int, span_n: int) -> np.ndarray:
    """k-mer code of each span position in genome order (-1: the window
    runs off the chromosome or holds an N); the model table gathered by
    these codes gives the expected (mean, sd), NaN at -1 through the
    table's sentinel row."""
    begin_lag, end_lag = _lags(std_ref, reg_data.strand)
    reg_seq = _oriented_seq(reg_data, fasta, span_lo - begin_lag,
                            span_lo + span_n + end_lag)
    codes = seq_to_kmer_codes(encode_seq(reg_seq), std_ref.kmer_width)
    return codes[::-1] if reg_data.strand == "-" else codes


def _device_region_job(reg_data: RegionData, params: TestParams,
                       ctrl_reg_data: Optional[RegionData], fasta,
                       std_ref: Optional[KmerModel],
                       device: Optional[torch.device] = None):
    """One region's packed-lane inputs (expected levels or k-mer codes,
    read levels, clipping bounds).  A region whose reads give no levels
    keeps its job, which adds zero counts (a host of a multi-host run
    owns no read of some regions)."""
    span_lo, span_n = _accum_span(reg_data, params)
    fm = params.fm_offset
    ctrl_cov_dense = ref_means = ref_sds = ref_codes = None
    if params.stat_type == SAMP_COMP_TXT:
        ctrl_means, ctrl_sds, ctrl_cov = get_reads_ref(
            ctrl_reg_data, fasta, params.min_test_reads, fm, std_ref,
            params.prior_weights, device=device)
        ctrl_cov_dense = np.zeros(span_n, np.int64)
        for pos, c in ctrl_cov.items():
            if 0 <= pos - span_lo < span_n:
                ctrl_cov_dense[pos - span_lo] = c
        # the control arrays cover [start - fm, end + fm): align to the
        # span
        ref_means = np.full(span_n, np.nan)
        ref_sds = np.full(span_n, np.nan)
        off = (reg_data.start - fm) - span_lo
        ref_means[off:off + ctrl_means.shape[0]] = ctrl_means
        ref_sds[off:off + ctrl_sds.shape[0]] = ctrl_sds
        begin_lag = end_lag = 0
        place_lo, place_hi = reg_data.start - fm, reg_data.end + fm
        clamp_after = False
    elif params.stat_type == DE_NOVO_TXT:
        begin_lag, end_lag = _lags(std_ref, reg_data.strand)
        ref_codes = _span_exp_codes(reg_data, fasta, std_ref, span_lo,
                                    span_n)
        place_lo = reg_data.start - begin_lag - fm
        place_hi = reg_data.end + end_lag + fm
        clamp_after = True
    else:
        raise ValueError("the packed lane runs de_novo and sample_compare "
                         "only, not %r" % params.stat_type)
    levels = reg_data.load_levels_packed(device)
    return dict(reg=reg_data, span_lo=span_lo, span_n=span_n,
                ref_means=ref_means, ref_sds=ref_sds, ref_codes=ref_codes,
                table=((std_ref.means, std_ref.sds)
                       if ref_codes is not None else None),
                levels=levels, place_lo=place_lo, place_hi=place_hi,
                begin_lag=begin_lag, end_lag=end_lag,
                clamp_after=clamp_after, ctrl_cov_dense=ctrl_cov_dense)


def packed_accumulators(jobs, params: TestParams,
                        core: int = dev_lane.CORE_DEFAULT,
                        device: DeviceLike = None, dtype=None,
                        emit_per_read: bool = False):
    """Many prepared region jobs through one packed pass: per job its
    dense (coverage, valid coverage, above-threshold) int64 counts over
    its span and, with ``emit_per_read``, its per-read block
    (:func:`per_read_block`, None with no valid statistic); None for a
    None job.  The p-values come back from the same dispatches, in the
    lane's dtype, only with ``emit_per_read``."""
    table = next((j["table"] for j in jobs
                  if j is not None and j["table"] is not None), None)
    packer = dev_lane.PackedRegionBatch(params.fm_offset, core=core,
                                        levels_table=table, device=device,
                                        dtype=dtype)
    for j, job in enumerate(jobs):
        if job is not None:
            packer.add_region(j, job["span_lo"], job["span_n"],
                              job["ref_means"], job["ref_sds"], job["levels"],
                              job["place_lo"], job["place_hi"],
                              job["begin_lag"], job["end_lag"],
                              ref_codes=job["ref_codes"])
    clamp_after = next((j["clamp_after"] for j in jobs if j is not None),
                       True)
    counts, pvals = packer.dispatch(
        params.fm_offset, clamp_after, float(params.single_read_thresh),
        float(params.lower_thresh if params.lower_thresh is not None
              else -1e30),
        "two_way" if params.lower_thresh is not None else "plain",
        want_pvals=emit_per_read)
    out = []
    for j, job in enumerate(jobs):
        if job is None:
            out.append(None)
            continue
        if counts is None:
            cov = valid_cov = above = np.zeros(job["span_n"], np.int64)
        else:
            cov, valid_cov, above = packer.unpack_region(
                j, job["span_lo"], job["span_n"], counts)
        payload = None
        if emit_per_read and cov.any():
            streams = packer.read_streams(j, pvals)
            ridxs = [i for i in sorted(streams) if streams[i][1].shape[0]]
            if ridxs:
                payload = per_read_block(
                    [streams[i][1] for i in ridxs],
                    [streams[i][0] for i in ridxs],
                    [(job["levels"][i].read_id, streams[i][1].shape[0])
                     for i in ridxs], job["reg"], params.stat_type)
        out.append((cov, valid_cov, above, payload))
    return out


def compute_reg_stats_device_batch(jobs, params: TestParams,
                                   core: int = dev_lane.CORE_DEFAULT,
                                   device: DeviceLike = None, dtype=None,
                                   emit_per_read: bool = False):
    """Many prepared region jobs (None: a skipped region) through one
    packed pass, as one host's chunk of :func:`iter_region_stats`;
    returns one list per job, [(stat_type, RegionStats, per-read block or
    None)] or [] (the shape of the JAX ``compute_reg_stats`` output).
    With ``emit_per_read`` each region also gets its per-read block."""
    return _one_host_batch(jobs, params, [params.stat_type], None, core,
                           device, dtype, emit_per_read)


def compute_reg_stats_device(reg_data: RegionData, params: TestParams,
                             ctrl_reg_data: Optional[RegionData], fasta,
                             std_ref: Optional[KmerModel],
                             core: int = dev_lane.CORE_DEFAULT,
                             device: DeviceLike = None, dtype=None,
                             emit_per_read: bool = False):
    """The packed lane over one region; raises TomboError where it has no
    tested site."""
    _check_stat_type(params.stat_type)
    device = resolve_device(device)
    job = _device_region_job(reg_data, params, ctrl_reg_data, fasta,
                             std_ref, device)
    (res,) = compute_reg_stats_device_batch([job], params, core, device,
                                            dtype, emit_per_read)
    if not res:
        raise TomboError("No valid positions in this region.")
    return res


# --------------------------------------------------------------------------
# the alternative-model test (reference: tombo/tombo_stats.py:3889-4084)
# --------------------------------------------------------------------------

def _trim_seq_and_means(seq, means, r_start, reg_start, reg_end, strand,
                        kmer_width, central_pos, max_motif_bb, max_motif_ab):
    """A read's k-mer codes and means trimmed to the region, its first
    tested position and its N-padded motif search sequence (reference:
    tombo/tombo_stats.py:3889-3970 ``trim_seq_and_means``)."""
    r_end = r_start + means.shape[0]
    motif_search_seq = seq
    n_start_clip = n_end_clip = 0
    if r_start + kmer_width - 1 < reg_start:
        if strand == "+":
            n_start_clip = reg_start - (r_start + kmer_width - 1)
        else:
            n_end_clip = reg_start - (r_start + kmer_width - 1)
        r_start = reg_start - (kmer_width - 1)
    if r_end - kmer_width + 1 > reg_end:
        if strand == "+":
            n_end_clip = r_end - kmer_width + 1 - reg_end
        else:
            n_start_clip = r_end - kmer_width + 1 - reg_end
    seq = seq[n_start_clip:]
    if n_end_clip > 0:
        seq = seq[:-n_end_clip]
    means = means[n_start_clip + central_pos:]
    means = means[:-(n_end_clip + kmer_width - central_pos - 1)]
    if means.shape[0] < kmer_width:
        raise TomboError("Read sequence too short in this region.")
    kmer_codes = seq_to_kmer_codes(encode_seq(seq), kmer_width)
    if kmer_codes.shape[0] != means.shape[0]:
        raise TomboError("Mismatching k-mer and mean levels.")
    r_start += kmer_width - 1
    bb = n_start_clip + kmer_width - 1 - max_motif_bb
    if bb >= 0:
        motif_search_seq = motif_search_seq[bb:]
    else:
        motif_search_seq = "N" * -bb + motif_search_seq
    ab = n_end_clip + kmer_width - 1 - max_motif_ab
    if ab > 0:
        motif_search_seq = motif_search_seq[:-ab]
    elif ab < 0:
        motif_search_seq = motif_search_seq + "N" * -ab
    return kmer_codes, means, r_start, motif_search_seq


def alt_model_read_windows(rl: ReadLevels, std_ref: KmerModel,
                           alt_refs: Sequence[Tuple[str, AltModel]],
                           reg_data: RegionData):
    """The host half of the alternative-model test for one read: trim,
    motif search and the stacked (hits, k) windows of each model.
    Returns ({name: None (no hit) or (positions, read means, canonical
    means, alternative means, alternative SDs, the canonical variance at
    each hit)}, read id); :func:`dev_lane.alt_llhr` scores the windows."""
    r_data = rl.r_data
    max_motif_bb = max(a.motif.mod_pos - 1 for _, a in alt_refs)
    max_motif_ab = max(a.motif.motif_len - a.motif.mod_pos
                       for _, a in alt_refs)
    if rl.means is None or rl.seq is None:
        raise TomboError("Read does not contain valid re-squiggled data.")
    kmer_codes, r_means, r_start, motif_search_seq = _trim_seq_and_means(
        rl.seq, rl.means, r_data.start, reg_data.start, reg_data.end,
        r_data.strand, std_ref.kmer_width, std_ref.central_pos,
        max_motif_bb, max_motif_ab)
    k = std_ref.kmer_width
    testable_len = r_means.shape[0] - k + 1
    r_ref_means, r_ref_sds = std_ref.get_exp_levels_from_kmer_codes(
        kmer_codes)
    r_ref_vars = np.square(r_ref_sds)
    out = {}
    for alt_name, alt_ref in alt_refs:
        search_seq = motif_search_seq[
            max_motif_bb - (alt_ref.motif.mod_pos - 1):]
        ab_clip = max_motif_ab - (alt_ref.motif.motif_len -
                                  alt_ref.motif.mod_pos)
        if ab_clip > 0:
            search_seq = search_seq[:-ab_clip]
        hits = [m.start() for m in
                alt_ref.motif.motif_pat.finditer(search_seq)]
        if not hits:
            out[alt_name] = None
            continue
        hits = np.array(hits, np.int64)
        poss = (r_start + hits if r_data.strand == "+"
                else r_start + testable_len - hits - 1)
        win = hits[:, None] + np.arange(k)[None, :]
        alt_means_w, alt_sds_w = alt_ref.get_exp_levels_from_kmer_codes(
            kmer_codes[win])
        out[alt_name] = (poss, r_means[win], r_ref_means[win], alt_means_w,
                         alt_sds_w, r_ref_vars[hits])
    return out, rl.read_id


def _alt_device_region_job(reg_data: RegionData, std_ref: KmerModel,
                           alt_items, fasta, device=None):
    """One region's alternative-model inputs: each read's motif-hit
    windows for every model.  Levels are host copies (device-resident
    means of ``device``'s type first), sequences the FAST5 ``base``
    column or, for device-resident reads, the reference's bases."""
    per_alt = {name: [] for name, _ in alt_items}
    for rl in reg_data.load_levels(device, with_seq=True, fasta=fasta):
        try:
            wins, read_id = alt_model_read_windows(rl, std_ref, alt_items,
                                                   reg_data)
        except TomboError:
            continue
        for name, w in wins.items():
            if w is not None:
                per_alt[name].append((read_id, w))
    if all(len(v) == 0 for v in per_alt.values()):
        raise TomboError("Reads contain no statistics in this region.")
    return dict(reg=reg_data, per_alt=per_alt)


def alt_read_stats(jobs, params: TestParams, alt_items,
                   device: DeviceLike = None, dtype=None):
    """The alternative-model ratios of many prepared regions, one
    :func:`dev_lane.alt_llhr` dispatch a model over every motif hit of
    every read of the chunk, stacked to a power of two (>= 256) of rows.
    Returns {model name: {job index: [(read id, positions, float64
    ratios)]}}, reads in job order."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype, device)
    out = {}
    for name, _ in alt_items:
        chunks, wins = [], []
        h0 = 0
        for j, job in enumerate(jobs):
            if job is None:
                continue
            for read_id, w in job["per_alt"][name]:
                H = w[0].shape[0]
                chunks.append((j, read_id, w[0], slice(h0, h0 + H)))
                wins.append(w)
                h0 += H
        out[name] = per_job = {}
        if h0 == 0:
            continue
        k = wins[0][1].shape[1]
        Hp = dev_lane._pow2_at_least(h0, 256)
        mw, rw, aw = (np.zeros((Hp, k)) for _ in range(3))
        cv = np.ones(Hp)      # padded rows: finite ratios, never read
        for a, i in ((mw, 1), (rw, 2), (aw, 3), (cv, 5)):
            a[:h0] = np.concatenate([w[i] for w in wins])
        llhrs = dev_lane.alt_llhr(
            *(torch.tensor(a, dtype=dtype, device=device)
              for a in (mw, rw, aw, cv)),
            bool(params.use_standard_llhr), float(config.OCLLHR_SCALE),
            float(config.OCLLHR_HEIGHT), float(config.OCLLHR_POWER)
        ).cpu().numpy().astype(np.float64)[:h0]
        for j, read_id, poss, sl in chunks:
            per_job.setdefault(j, []).append((read_id, poss, llhrs[sl]))
    return out


def compute_alt_stats_device_batch(jobs, params: TestParams, alt_items,
                                   emit_per_read: bool = False,
                                   device: DeviceLike = None, dtype=None):
    """The alternative-model test of many prepared regions (None: a
    skipped region), as one host's chunk of :func:`iter_region_stats`.
    Returns one list per job of (model name, RegionStats, per-read block
    or None), in model order."""
    return _one_host_batch(jobs, params, [name for name, _ in alt_items],
                           alt_items, dev_lane.CORE_DEFAULT, device, dtype,
                           emit_per_read)


def _alt_stats_fn(base_fn: str, alt_name: str) -> str:
    """The reference's naming of one model's file: ``<base>.<name>
    .tombo.stats`` (reference: tombo/tombo_stats.py:4655-4662)."""
    for ext in (".tombo.stats", ".tombo.per_read_stats"):
        if base_fn.endswith(ext):
            return base_fn[:-len(ext)] + "." + alt_name + ext
    return base_fn + "." + alt_name


# --------------------------------------------------------------------------
# group (level) tests (reference: tombo/tombo_stats.py:4236-4398)
# --------------------------------------------------------------------------

# statistic type -> (function of the device lane, return the statistic)
_LEVEL_TESTS = {
    KS_TEST_TXT: ("ks_tests", False),
    KS_STAT_TEST_TXT: ("ks_tests", True),
    U_TEST_TXT: ("u_tests", False),
    U_STAT_TEST_TXT: ("u_tests", True),
    T_TEST_TXT: ("t_tests", False),
    T_STAT_TEST_TXT: ("t_tests", True),
}


def _group_device_tests(samp_p: np.ndarray, ctrl_p: np.ndarray,
                        stat_type: str, device: torch.device,
                        dtype: torch.dtype) -> np.ndarray:
    """One device call of the level test over a (P, C) padded pair (P
    may concatenate many regions); float64 statistics on the host."""
    try:
        name, return_stat = _LEVEL_TESTS[stat_type]
    except KeyError:
        raise TomboError("Unrecognized test type.")
    npdt = np.float64 if dtype == torch.float64 else np.float32
    out = getattr(dev_lane, name)(
        torch.from_numpy(samp_p.astype(npdt)).to(device),
        torch.from_numpy(ctrl_p.astype(npdt)).to(device), return_stat)
    return out.cpu().numpy().astype(np.float64)


def _group_levels_pair(reg_data: RegionData, ctrl_reg_data: RegionData,
                       fm_offset: int, device=None):
    """(positions, reads) sample and control level matrices over the
    region and ``fm_offset`` bases each side."""
    return tuple(r.copy_update(r.start - fm_offset,
                               r.end + fm_offset).get_base_levels(device)
                 for r in (reg_data, ctrl_reg_data))


def compute_group_stats_device_batch(jobs, params: TestParams,
                                     device: DeviceLike = None, dtype=None):
    """The level test of a chunk of regions in one device call: the
    per-site tests do not depend on position, so the regions' sites
    concatenate along P (padded to a power of two) and their coverage
    axes pad to one multiple of 8.  ``jobs``: (RegionData, samp, ctrl) or
    None per region; returns one :func:`compute_group_reg_stats`-shaped
    list per job."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype, device)
    live = [(i, j) for i, j in enumerate(jobs) if j is not None]
    out = [[] for _ in jobs]
    if not live:
        return out
    C = max(max(s.shape[1], c.shape[1]) for _, (_, s, c) in live)
    pads = [dev_lane.pad_levels_pair(s, c, cov_mult=_round8(C))
            for _, (_, s, c) in live]
    lens = [s.shape[0] for _, (_, s, _) in live]
    Pp = 1 << max(sum(lens) - 1, 1).bit_length()
    Cp = pads[0][0].shape[1]
    samp_all = np.full((Pp, Cp), np.nan)
    ctrl_all = np.full((Pp, Cp), np.nan)
    o = 0
    for (sp, cp), n in zip(pads, lens):
        samp_all[o:o + n] = sp
        ctrl_all[o:o + n] = cp
        o += n
    stats_all = _group_device_tests(samp_all, ctrl_all, params.stat_type,
                                    device, dtype)
    o = 0
    for (i, (reg, samp, ctrl)), n in zip(live, lens):
        out[i] = _group_post(reg, params, samp, ctrl, stats_all[o:o + n])
        o += n
    return out


def _round8(x: int) -> int:
    return (x + 7) // 8 * 8


def compute_group_reg_stats(reg_data: RegionData, ctrl_reg_data: RegionData,
                            params: TestParams, device: DeviceLike = None,
                            dtype=None):
    """The level test of one region: [(stat_type, GroupStats)] or []."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype, device)
    samp, ctrl = _group_levels_pair(reg_data, ctrl_reg_data,
                                    params.fm_offset, device)
    samp_p, ctrl_p = dev_lane.pad_levels_pair(samp, ctrl)
    return _group_post(reg_data, params, samp, ctrl, _group_device_tests(
        samp_p, ctrl_p, params.stat_type, device, dtype))


def _group_post(reg_data: RegionData, params: TestParams, samp, ctrl,
                dev_stats: np.ndarray):
    """The host half of the level tests: the covered blocks (both samples
    at ``min_test_reads`` or more; a block shorter than 2 fm + 1 sites is
    skipped), Fisher's method (p-values) or the window mean (effect
    sizes) over +-fm sites inside each block, and the GroupStats
    (reference: tombo/tombo_stats.py:4335-4398)."""
    fm = params.fm_offset
    stat_type = params.stat_type
    samp_cov = (~np.isnan(samp)).sum(axis=1)
    ctrl_cov = (~np.isnan(ctrl)).sum(axis=1)
    edges = np.where(np.diff(np.concatenate([
        [False], (samp_cov >= params.min_test_reads) &
        (ctrl_cov >= params.min_test_reads), [False]])))[0]
    reg_stats, reg_poss, reg_cov, reg_ctrl_cov = [], [], [], []
    for cs, ce in zip(edges[:-1:2], edges[1::2]):
        if ce - cs < fm * 2 + 1:
            continue
        cstats = dev_stats[cs:ce]
        if fm > 0:
            if stat_type in (KS_TEST_TXT, U_TEST_TXT, T_TEST_TXT):
                cstats = calc_window_fishers_method(cstats, fm)
            else:
                cstats = calc_window_means(cstats, fm)
        reg_stats.append(cstats)
        reg_poss.append(np.arange(reg_data.start - fm + cs,
                                  reg_data.start - fm + ce))
        reg_cov.append(samp_cov[cs:ce])
        reg_ctrl_cov.append(ctrl_cov[cs:ce])
    if not reg_stats:
        return []
    return [(stat_type, GroupStats(
        np.concatenate(reg_stats), np.concatenate(reg_poss),
        reg_data.chrm, reg_data.strand, reg_data.start,
        np.concatenate(reg_cov), np.concatenate(reg_ctrl_cov)))]


def group_stats_dense(reg_data: RegionData, params: TestParams, results):
    """A region's level statistics as dense (statistic float64, mask,
    coverage, control coverage) arrays over its span, zeros where it has
    none, so a host that does not own the region adds zeros to the
    cross-host sum (counterpart of ``tombo_tpu/stats/detect.py:603``)."""
    span_lo, span_n = _accum_span(reg_data, params)
    stat = np.zeros(span_n, np.float64)
    ints = np.zeros((3, span_n), np.int64)
    for _, gs in results:
        rel = gs.reg_poss - span_lo
        stat[rel] = gs.reg_stats
        ints[0, rel] = 1
        ints[1, rel] = gs.reg_cov
        ints[2, rel] = gs.ctrl_cov
    return stat, ints


def group_stats_from_dense(reg_data: RegionData, params: TestParams, stat,
                           ints) -> Optional[GroupStats]:
    """The GroupStats of :func:`group_stats_dense`'s arrays (summed over
    hosts), None with no tested site (counterpart of
    ``tombo_tpu/stats/detect.py:621``)."""
    span_lo, _ = _accum_span(reg_data, params)
    rel = np.where(ints[0] > 0)[0]
    if rel.shape[0] == 0:
        return None
    return GroupStats(stat[rel], rel + span_lo, reg_data.chrm,
                      reg_data.strand, reg_data.start, ints[1, rel],
                      ints[2, rel])


# --------------------------------------------------------------------------
# orchestration (reference: tombo/tombo_stats.py:4400-4634)
# --------------------------------------------------------------------------

def _stat_names(params: TestParams, alt_items) -> list:
    if params.stat_type == ALT_MODEL_TXT:
        return [name for name, _ in alt_items]
    return [params.stat_type]


def _chunks_by_obs(regions, reads_index):
    """Regions with their reads, in chunks of up to ``CHUNK_OBS``
    site-observations and ``CHUNK_REGIONS`` regions."""
    i = 0
    while i < len(regions):
        c_regs, obs = [], 0
        while i < len(regions) and (not c_regs or (
                obs < CHUNK_OBS and len(c_regs) < CHUNK_REGIONS)):
            reg = regions[i].add_reads(reads_index)
            i += 1
            obs += sum(min(r.end, reg.end) - max(r.start, reg.start)
                       for r in reg.reads)
            c_regs.append(reg)
        yield c_regs


def _prep_chunk(pool, regs, params, reads_index, ctrl_reads_index, fasta,
                std_ref, device, alt_items=None):
    """Region jobs of one chunk of regions with their reads, prepared on
    the thread pool (the control's reads, expected levels, level loads,
    motif windows); None where a region has nothing to test.  A de novo
    or sample-compare region whose reads give no levels keeps its job,
    which adds zero counts (:func:`_device_region_job`)."""
    def prep_one(reg):
        ctrl_reg = None
        if ctrl_reads_index is not None:
            ctrl_reg = RegionData(reg.chrm, reg.strand, reg.start,
                                  reg.end).add_reads(ctrl_reads_index)
        try:
            if params.stat_type in LEVEL_STATS_TXTS:
                return (reg,) + _group_levels_pair(reg, ctrl_reg,
                                                   params.fm_offset, device)
            if params.stat_type == ALT_MODEL_TXT:
                return _alt_device_region_job(reg, std_ref, alt_items,
                                              fasta, device)
            return _device_region_job(reg, params, ctrl_reg, fasta, std_ref,
                                      device)
        except TomboError:
            return None
    return list(pool.map(prep_one, regs))


def _host_model_counts(regs, jobs, params, names, alt_items, core, device,
                       dtype, emit_per_read):
    """One host's part of a chunk of model statistics: (counts (names, 3,
    regions, span) int64 over the host's reads, zeros where it has none;
    per region its control coverage or None and {name: per-read block or
    None})."""
    span_n = _accum_span(regs[0], params)[1]
    counts = np.zeros((len(names), 3, len(regs), span_n), np.int64)
    ctrl = [None] * len(regs)
    payloads = [{} for _ in regs]
    if params.stat_type == ALT_MODEL_TXT:
        for n, (name, per_job) in enumerate(alt_read_stats(
                jobs, params, alt_items, device, dtype).items()):
            for j, reads in per_job.items():
                counts[n, :, j] = site_accumulators(
                    np.concatenate([st for _, _, st in reads]),
                    np.concatenate([p for _, p, _ in reads]),
                    _accum_span(regs[j], params)[0], span_n,
                    params.single_read_thresh, params.lower_thresh,
                    ALT_MODEL_TXT)
                if emit_per_read:
                    payloads[j][name] = per_read_block(
                        [st for _, _, st in reads], [p for _, p, _ in reads],
                        [(rid, st.shape[0]) for rid, _, st in reads], regs[j],
                        name)
        return counts, ctrl, payloads
    for j, acc in enumerate(packed_accumulators(jobs, params, core, device,
                                                dtype, emit_per_read)):
        if acc is not None:
            counts[0, :, j] = acc[:3]
            ctrl[j] = jobs[j]["ctrl_cov_dense"]
            payloads[j][names[0]] = acc[3]
    return counts, ctrl, payloads


def _model_stats_chunk(dist, regs, jobs, params, names, alt_items, core,
                       device, dtype, emit_per_read):
    """A chunk's model statistics: this host's counts, summed over the
    hosts in one gather (none with one host), then unpacked region by
    region.  Returns one list a region of (name, RegionStats, this
    host's per-read block or None), in name order."""
    counts, ctrl, payloads = _host_model_counts(
        regs, jobs, params, names, alt_items, core, device, dtype,
        emit_per_read)
    (counts,) = distributed.psum_hosts(dist, counts)
    out = []
    for j, reg in enumerate(regs):
        span_lo = _accum_span(reg, params)[0]
        out.append([])
        for n, name in enumerate(names):
            reg_stats = region_stats_from_accumulators(
                reg.chrm, reg.strand, reg.start, span_lo, *counts[n, :, j],
                ctrl[j], params.stat_type)
            if reg_stats is not None:
                out[-1].append((name, reg_stats, payloads[j].get(name)))
    return out


def _one_host_batch(jobs, params, names, alt_items, core, device, dtype,
                    emit_per_read):
    """:func:`_model_stats_chunk` on one host over prepared jobs, [] for
    a None job."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype, device)
    live = [j for j, job in enumerate(jobs) if job is not None]
    out = [[] for _ in jobs]
    if live:
        for j, res in zip(live, _model_stats_chunk(
                distributed.DistContext(), [jobs[j]["reg"] for j in live],
                [jobs[j] for j in live], params, names, alt_items, core,
                device, dtype, emit_per_read)):
            out[j] = res
    return out


def _level_stats_chunk(dist, offset, regs, pool, params, reads_index,
                       ctrl_reads_index, device, dtype):
    """A chunk of level statistics: the regions this host owns
    (``dist.owns_region`` of their index in the run; every region with
    one host), each with all its reads, in one dispatch; the others
    zeros; summed over the hosts in one gather of the statistics
    (float64) and one of the counts.  Yields (stat_type, GroupStats,
    None) in region order."""
    own = [i for i in range(len(regs)) if dist.owns_region(offset + i)]
    jobs = [None] * len(regs)
    for i, job in zip(own, _prep_chunk(
            pool, [regs[i].add_reads(reads_index) for i in own], params,
            reads_index, ctrl_reads_index, None, None, device)):
        jobs[i] = job
    dense = [group_stats_dense(reg, params, res) for reg, res in zip(
        regs, compute_group_stats_device_batch(jobs, params, device,
                                               dtype))]
    stat, ints = distributed.psum_hosts(
        dist, np.stack([d[0] for d in dense]),
        np.stack([d[1] for d in dense]))
    for j, reg in enumerate(regs):
        gs = group_stats_from_dense(reg, params, stat[j], ints[j])
        if gs is not None:
            yield params.stat_type, gs, None


def iter_region_stats(reads_index, params: TestParams, fasta,
                      std_ref: Optional[KmerModel], ctrl_reads_index=None,
                      device: DeviceLike = None, dtype=None,
                      core: int = dev_lane.CORE_DEFAULT,
                      num_processes: int = 4, alt_refs=None,
                      emit_per_read: bool = False, dist=None
                      ) -> Iterator[Tuple[str, object, Optional[tuple]]]:
    """The statistics of every covered region with a tested site, in
    region order (the regions of ``reads_index.iter_cov_regs``, summed
    with the control's coverage when there is a control): per region one
    (statistic name, RegionStats or GroupStats, per-read block or None)
    a statistic (a model of ``alt_refs`` for the alternative-model test,
    in name order; else the statistic type).

    Per-read tests (de novo, sample-compare) go in chunks of up to
    ``CHUNK_OBS`` site-observations and ``CHUNK_REGIONS`` regions, as
    packed dispatches of ~512 rows; the alternative-model test chunks the
    same way, one :func:`dev_lane.alt_llhr` dispatch a model a chunk;
    level tests go ``LEVEL_CHUNK_REGIONS`` regions a dispatch and need
    ``ctrl_reads_index``.  A chunk's jobs are prepared on a pool of
    ``num_processes`` threads and run on ``device`` (None: the card) in
    ``dtype`` (float32; float64 on the CPU only).  ``core``: the
    sub-span core width.  ``emit_per_read``: also each region's per-read
    block (not for level tests).

    ``dist`` (a ``DistContext``; None: one host): every host of the run
    calls this with the same arguments and gets the same statistics.  A
    per-read test's chunk runs the reads this host owns, as dense counts
    merged with one ``psum_hosts``; the per-read blocks are this host's
    reads'.  Level tests go ``LEVEL_CHUNK_REGIONS`` regions a host a
    chunk, each chunk merged with one ``psum_hosts``.  With one host the
    merges are no-ops and the statistics those of the lane functions
    (:func:`compute_reg_stats_device_batch`,
    :func:`compute_alt_stats_device_batch`, which run one chunk on one
    host, and :func:`compute_group_stats_device_batch`)."""
    stat_type = params.stat_type
    _check_stat_type(stat_type)
    if stat_type in (SAMP_COMP_TXT,) + LEVEL_STATS_TXTS and \
            ctrl_reads_index is None:
        raise TomboError("%s needs a control reads index" % stat_type)
    alt_items = None
    if stat_type == ALT_MODEL_TXT:
        if not alt_refs:
            raise TomboError("model_compare needs alternative models")
        alt_items = sorted(alt_refs.items())
    device = resolve_device(device)
    dtype = resolve_dtype(dtype, device)
    if dist is None:
        dist = distributed.DistContext()
    regions = [RegionData(chrm, strand, start, start + params.region_size)
               for chrm, strand, start in reads_index.iter_cov_regs(
                   1, params.region_size, ctrl_reads_index)]
    with ThreadPoolExecutor(max_workers=num_processes) as pool:
        if stat_type in LEVEL_STATS_TXTS:
            step = LEVEL_CHUNK_REGIONS * dist.n_hosts
            for c0 in range(0, len(regions), step):
                yield from _level_stats_chunk(
                    dist, c0, regions[c0:c0 + step], pool, params,
                    reads_index, ctrl_reads_index, device, dtype)
            return
        names = _stat_names(params, alt_items)
        # the chunks are cut from the full index on every host, so the
        # hosts' merges pair the same regions
        for c_regs in _chunks_by_obs(regions, reads_index):
            for reg in c_regs:
                reg.reads = [r for r in reg.reads if dist.owns_read(
                    distributed.read_key(r))]
            jobs = _prep_chunk(pool, c_regs, params, reads_index,
                               ctrl_reads_index, fasta, std_ref, device,
                               alt_items)
            for res in _model_stats_chunk(
                    dist, c_regs, jobs, params, names, alt_items, core,
                    device, dtype, emit_per_read):
                yield from res


def test_significance(reads_index, params: TestParams, stats_fn: str,
                      fasta=None, std_ref: Optional[KmerModel] = None,
                      alt_refs: Optional[Dict[str, AltModel]] = None,
                      ctrl_reads_index=None,
                      per_read_bn: Optional[str] = None,
                      num_processes: int = 4, verbose: bool = False,
                      dist=None, device: DeviceLike = None, dtype=None,
                      core: int = dev_lane.CORE_DEFAULT,
                      levels_sidecar: bool = True) -> str:
    """Test every covered region and write the statistics files
    (reference: tombo/tombo_stats.py:4574-4634 ``test_significance``):
    a ``ModelStats`` file (one a model for the alternative-model test,
    named by :func:`_alt_stats_fn` when there is more than one), a
    ``LevelStats`` file for the level tests, and with ``per_read_bn`` the
    ``PerReadStats`` files of the per-read tests.  Blocks are written in
    region order, so the files do not depend on the worker count
    (reference guarantee: docs/modified_base_detection.rst:151-153).
    Levels loaded from FAST5 files are appended to their directory's
    levels sidecar; with ``levels_sidecar`` false no sidecar is read or
    written.

    ``dist`` (a ``DistContext`` of more than one host; every host calls
    this with the same arguments): the statistics files, written by the
    main host alone, equal one host's; each host writes the per-read
    blocks of its own reads to ``<per-read file>.host<i>``; sidecars are
    read and never written."""
    stat_type = params.stat_type
    _check_stat_type(stat_type)
    multi = dist is not None and dist.n_hosts > 1
    is_level = stat_type in LEVEL_STATS_TXTS
    alt_items = sorted(alt_refs.items()) if alt_refs else None
    names = _stat_names(params, alt_items)
    stats_files, pr_files = {}, {}
    resolved = config.resolved_params_json(test_params=params)
    try:
        for name in names:
            fn = (stats_fn if len(names) == 1 else
                  _alt_stats_fn(stats_fn, name))
            if not multi or dist.is_main:
                if is_level:
                    stats_files[name] = LevelStats(
                        fn, stat_type, params.region_size,
                        params.min_test_reads, params.num_most_signif)
                else:
                    stats_files[name] = ModelStats(
                        fn, stat_type, params.region_size,
                        params.cov_damp_counts, params.min_test_reads,
                        params.num_most_signif)
                stats_files[name].set_resolved_params(resolved)
            if per_read_bn is not None and not is_level:
                pr_fn = (per_read_bn if len(names) == 1 else
                         _alt_stats_fn(per_read_bn, name))
                if multi:
                    pr_fn += ".host%d" % dist.host_id
                pr_files[name] = PerReadStats(pr_fn, stat_type,
                                              params.region_size)
                pr_files[name].set_resolved_params(resolved)
        with levels_cache.building(levels_sidecar, write=not multi):
            for name, stats, payload in iter_region_stats(
                    reads_index, params, fasta, std_ref, ctrl_reads_index,
                    device, dtype, core, num_processes, alt_refs,
                    bool(pr_files), dist):
                if name in stats_files:
                    stats_files[name]._write_stat_block(stats)
                if payload is not None and name in pr_files:
                    pr_files[name]._write_per_read_block(*payload[1:])
                if verbose:
                    print("  processed %s:%s:%d %s" % (
                        stats.chrm, stats.strand, stats.start, name))
        for sf in stats_files.values():
            if sf.is_empty:
                raise TomboError(
                    "No genomic positions contain --minimum-test-reads.")
    finally:
        for f in list(stats_files.values()) + list(pr_files.values()):
            f.close()
    return stats_fn
