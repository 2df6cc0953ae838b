"""Modified-base detection: the de novo and model-sample-compare tests
over many regions through the packed device lane (counterpart of
``tombo_tpu/stats/detect.py:55-106, 467-535, 631-831, 917-930,
1194-1503``).

:func:`iter_region_stats` is the region loop of the JAX
``test_significance`` with the writer lifted out: it chunks the covered
regions, prepares each chunk's region jobs on a thread pool, runs the
chunk as packed device dispatches and yields each region's
:class:`RegionStats` in region order, opening no file of its own (the card
path reads its levels from the device-resident means of re-squiggle).
:func:`test_significance` consumes it and writes the statistics file.

Not ported here, and refused with a :class:`TomboError` that names it: the
alternative-model test, level statistics, per-read statistics files and
detection over more than one host (``ROADMAP.md``, Queue 1).
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from .. import config
from ..device import DeviceLike, resolve_device, resolve_dtype
from ..errors import TomboError
from ..io.model_io import KmerModel
from ..seq import encode_seq, rev_comp, seq_to_kmer_codes
from ..types import RegionStats
from . import device as dev_lane
from . import levels_cache
from .files import (ALT_MODEL_TXT, DE_NOVO_TXT, LEVEL_STATS_TXTS,
                    SAMP_COMP_TXT, ModelStats)
from .region import RegionData

# a chunk of regions is one packed pass: up to this many site-observations
# and regions (the JAX lane's defaults)
CHUNK_OBS = 1_500_000
CHUNK_REGIONS = 64


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
    num_most_signif: int = 100000
    cov_damp_counts: Tuple[float, float] = config.COV_DAMP_COUNTS


def _check_ported(stat_type: str):
    if stat_type == ALT_MODEL_TXT:
        raise TomboError("alternative_model (model_compare) testing is not "
                         "ported")
    if stat_type in LEVEL_STATS_TXTS:
        raise TomboError("level statistics (%s) are not ported" % stat_type)
    if stat_type not in (DE_NOVO_TXT, SAMP_COMP_TXT):
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
# region jobs and the packed lane
# --------------------------------------------------------------------------

def _accum_span(reg_data: RegionData, params: TestParams):
    """(first position, width) of a region's dense accumulators: per-read
    statistics reach ``fm_offset`` (plus k-mer lags) past the region."""
    margin = params.fm_offset + 16
    return reg_data.start - margin, (reg_data.end - reg_data.start) + \
        2 * margin


def region_stats_from_accumulators(reg_data: RegionData, span_lo: int,
                                   cov, valid, above, ctrl_cov_dense,
                                   stat_type) -> Optional[RegionStats]:
    """A region's ``RegionStats`` from its dense (coverage, valid
    coverage, above-threshold) accumulators; None with no covered site."""
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
    return RegionStats(frac_std, poss + span_lo, reg_data.chrm,
                       reg_data.strand, reg_data.start, cov[poss],
                       np.asarray(out_ctrl), valid[poss])


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
    read levels, clipping bounds); raises TomboError where the host lane
    skips the region."""
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
    else:
        begin_lag, end_lag = _lags(std_ref, reg_data.strand)
        ref_codes = _span_exp_codes(reg_data, fasta, std_ref, span_lo,
                                    span_n)
        place_lo = reg_data.start - begin_lag - fm
        place_hi = reg_data.end + end_lag + fm
        clamp_after = True
    levels = reg_data.load_levels_packed(device)
    if not levels:
        raise TomboError("Reads contain no statistics in this region.")
    return dict(reg=reg_data, span_lo=span_lo, span_n=span_n,
                ref_means=ref_means, ref_sds=ref_sds, ref_codes=ref_codes,
                table=((std_ref.means, std_ref.sds)
                       if ref_codes is not None else None),
                levels=levels, place_lo=place_lo, place_hi=place_hi,
                begin_lag=begin_lag, end_lag=end_lag,
                clamp_after=clamp_after, ctrl_cov_dense=ctrl_cov_dense)


def compute_reg_stats_device_batch(jobs, params: TestParams,
                                   core: int = dev_lane.CORE_DEFAULT,
                                   device: DeviceLike = None, dtype=None):
    """Many prepared region jobs (None: a skipped region) through one
    packed pass; returns one list per job, [(stat_type, RegionStats,
    None)] or [] (the shape of the JAX ``compute_reg_stats`` output)."""
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
    counts = packer.dispatch(
        params.fm_offset, clamp_after, float(params.single_read_thresh),
        float(params.lower_thresh if params.lower_thresh is not None
              else -1e30),
        "two_way" if params.lower_thresh is not None else "plain")
    out = []
    for j, job in enumerate(jobs):
        reg_stats = None
        if job is not None and counts is not None:
            cov, valid_cov, above = packer.unpack_region(
                j, job["span_lo"], job["span_n"], counts)
            reg_stats = region_stats_from_accumulators(
                job["reg"], job["span_lo"], cov, valid_cov, above,
                job["ctrl_cov_dense"], params.stat_type)
        out.append([] if reg_stats is None else
                   [(params.stat_type, reg_stats, None)])
    return out


def compute_reg_stats_device(reg_data: RegionData, params: TestParams,
                             ctrl_reg_data: Optional[RegionData], fasta,
                             std_ref: Optional[KmerModel],
                             core: int = dev_lane.CORE_DEFAULT,
                             device: DeviceLike = None, dtype=None):
    """The packed lane over one region."""
    _check_ported(params.stat_type)
    device = resolve_device(device)
    job = _device_region_job(reg_data, params, ctrl_reg_data, fasta,
                             std_ref, device)
    (res,) = compute_reg_stats_device_batch([job], params, core, device,
                                            dtype)
    if not res:
        raise TomboError("No valid positions in this region.")
    return res


def _prep_chunk(pool, regs, params, reads_index, ctrl_reads_index, fasta,
                std_ref, device):
    """Region jobs of one chunk, prepared on the thread pool (index
    lookups, expected levels, level loads); None where a region has
    nothing to test."""
    def prep_one(reg):
        ctrl_reg = None
        if ctrl_reads_index is not None:
            ctrl_reg = RegionData(reg.chrm, reg.strand, reg.start,
                                  reg.end).add_reads(ctrl_reads_index)
        try:
            return _device_region_job(reg, params, ctrl_reg, fasta, std_ref,
                                      device)
        except TomboError:
            return None
    return list(pool.map(prep_one, regs))


def iter_region_stats(reads_index, params: TestParams, fasta,
                      std_ref: Optional[KmerModel], ctrl_reads_index=None,
                      device: DeviceLike = None, dtype=None,
                      core: int = dev_lane.CORE_DEFAULT,
                      num_processes: int = 4) -> Iterator[RegionStats]:
    """``RegionStats`` of every covered region with a tested site, in
    region order (the regions of ``reads_index.iter_cov_regs``, summed
    with the control's coverage for sample-compare).

    Regions go in chunks of up to ``CHUNK_OBS`` site-observations and
    ``CHUNK_REGIONS`` regions; a chunk's jobs are prepared on a pool of
    ``num_processes`` threads and run as packed dispatches of ~512 rows on
    ``device`` (None: the card) in ``dtype`` (float32; float64 on the
    CPU only).  ``core``: the sub-span core width."""
    _check_ported(params.stat_type)
    if params.stat_type == SAMP_COMP_TXT and ctrl_reads_index is None:
        raise TomboError("sample_compare needs a control reads index")
    device = resolve_device(device)
    dtype = resolve_dtype(dtype, device)
    regions = [RegionData(chrm, strand, start, start + params.region_size)
               for chrm, strand, start in reads_index.iter_cov_regs(
                   1, params.region_size, ctrl_reads_index)]
    with ThreadPoolExecutor(max_workers=num_processes) as pool:
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
            jobs = _prep_chunk(pool, c_regs, params, reads_index,
                               ctrl_reads_index, fasta, std_ref, device)
            for results in compute_reg_stats_device_batch(
                    jobs, params, core, device, dtype):
                for _, reg_stats, _ in results:
                    yield reg_stats


def test_significance(reads_index, params: TestParams, stats_fn: str,
                      fasta=None, std_ref: Optional[KmerModel] = None,
                      alt_refs=None, ctrl_reads_index=None,
                      per_read_bn: Optional[str] = None,
                      num_processes: int = 4, verbose: bool = False,
                      dist=None, device: DeviceLike = None, dtype=None,
                      core: int = dev_lane.CORE_DEFAULT) -> str:
    """Test every covered region and write the statistics file
    (reference: tombo/tombo_stats.py:4574-4634 ``test_significance``).
    Blocks are written in region order, so the file does not depend on
    the worker count (reference guarantee:
    docs/modified_base_detection.rst:151-153).  Levels loaded from FAST5
    files are appended to their directory's levels sidecar."""
    _check_ported(params.stat_type)
    if alt_refs:
        raise TomboError("alternative_model testing is not ported")
    if per_read_bn is not None:
        raise TomboError("per-read statistics files are not ported")
    if dist is not None and dist.n_hosts > 1:
        raise TomboError("detection over more than one host is not ported")
    stats_file = ModelStats(stats_fn, params.stat_type, params.region_size,
                            params.cov_damp_counts, params.min_test_reads,
                            params.num_most_signif)
    try:
        stats_file.set_resolved_params(
            config.resolved_params_json(test_params=params))
        with levels_cache.building():
            for reg_stats in iter_region_stats(
                    reads_index, params, fasta, std_ref, ctrl_reads_index,
                    device, dtype, core, num_processes):
                stats_file._write_stat_block(reg_stats)
                if verbose:
                    print("  processed %s:%s:%d" % (
                        reg_stats.chrm, reg_stats.strand, reg_stats.start))
        if stats_file.is_empty:
            raise TomboError(
                "No genomic positions contain --minimum-test-reads.")
    finally:
        stats_file.close()
    return stats_fn
