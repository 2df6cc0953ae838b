"""K-mer model estimation: canonical, motif and density-based alternative
models (counterpart of ``tombo_tpu/stats/estimate.py``; reference:
tombo/tombo_stats.py:1242-2190).

- Canonical and motif models: per-site level statistics of each region
  (``stats/estimate_device.py``, the one lane of every variant), tabulated
  per k-mer (or per (k-mer, offset of the modified base)) as the median of
  the sites' centers and spreads.
- The re-centring fit (:func:`center_model_to_median_norm`): a batch of
  reads is re-normalized, its event means are taken and fitted to the
  model's expected levels by Theil-Sen (``ops/rescale.py``: at float32
  through the count kernel ``csrc/count_le.cu``); the model is shifted and
  scaled by the median corrections.  Reads come from a read source: the
  FAST5 loader, or :class:`MemoryReadSource` over re-squiggle results and
  the raw signals a process holds.
- The density-based alternative model: per-k-mer level observations of an
  alternative and a control sample (:func:`parse_base_levels`), their
  Gaussian kernel densities (``stats/kde.py``), and the alternative base's
  isolated density (:func:`isolate_alt_density`, numpy).

Reads whose means are device-resident (``stats/device_levels.py``) carry
no sequence of their own: their sequence comes from the reference
(``fasta``)."""
from __future__ import annotations

import io as _io
import re
from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import config
from ..device import DeviceLike, resolve_device, resolve_dtype
from ..errors import TomboError
from ..io import fast5 as f5io
from ..io.model_io import AltModel, KmerModel
from ..ops import normalize as nrm
from ..ops import rescale
from ..pipeline import resquiggle as rsq
from ..pipeline.batch import (_pow2_bucket, _slice_rows, _ts_sample_idx,
                              rna_event_scale)
from ..seq import TomboMotif, all_kmers, rev_comp, seq_to_kmer_codes
from ..types import ReadData
from . import device_levels
from .estimate_device import get_region_kmer_levels_device
from .kde import kde_evaluate
from .region import RegionData, load_read_levels

# reads a batch of the re-centring fit: on the card the count kernel's
# (B, 499,500) keys (1 GB at 512); float64 selects over (B, N * N) keys
RECENTER_BATCH = {torch.float32: 512, torch.float64: 16}
# reads a chunk of base-level parsing
PARSE_CHUNK_READS = 512


# --------------------------------------------------------------------------
# canonical and motif models (reference: tombo/tombo_stats.py:1242-1740)
# --------------------------------------------------------------------------

def extract_kmer_levels(reads_index, fasta, region_size, cov_thresh,
                        upstrm_bases, dnstrm_bases, cs_cov_thresh,
                        est_mean=False, motif: Optional[TomboMotif] = None,
                        valid_poss=None,
                        rng: Optional[np.random.Generator] = None,
                        device: DeviceLike = None, dtype=None):
    """{key: [(center, sd), ...]} per covered region (reference:
    tombo/tombo_stats.py:1361-1452)."""
    regions = [RegionData(chrm, strand, start, start + region_size)
               for chrm, strand, start in reads_index.iter_cov_regs(
                   cov_thresh, region_size)]
    for reg in regions:
        reg.add_reads(reads_index)
    return get_region_kmer_levels_device(
        regions, fasta, cov_thresh, upstrm_bases, dnstrm_bases,
        cs_cov_thresh, est_mean, region_size, rng=rng, motif=motif,
        valid_poss=valid_poss, device=device, dtype=dtype)


def _tabulate(all_reg_kmer_levels, min_kmer_obs, keys, key_name):
    all_kmer_mean_sds = []
    for key in keys:
        levels = [reg_levels[key] for reg_levels in all_reg_kmer_levels
                  if len(reg_levels[key]) > 0]
        if not levels:
            raise TomboError(
                "At least one %s is not covered at any positions by "
                "--minimum-test-reads." % key_name)
        kmer_levels = np.concatenate(levels)
        if kmer_levels.shape[0] < min_kmer_obs:
            raise TomboError(
                "K-mers represented in fewer observations than requested "
                "in the provided reads. Consider a shorter k-mer or "
                "providing more reads. %d observations found in least "
                "common kmer." % kmer_levels.shape[0])
        out_key = key if isinstance(key, tuple) else (key,)
        all_kmer_mean_sds.append(
            out_key + (float(np.median(kmer_levels[:, 0])),
                       float(np.median(kmer_levels[:, 1]))))
    return all_kmer_mean_sds


def tabulate_kmer_levels(all_reg_kmer_levels, min_kmer_obs):
    """(k-mer, mean, sd) per k-mer (reference:
    tombo/tombo_stats.py:1454-1500)."""
    kmer_width = len(next(iter(all_reg_kmer_levels[0].keys())))
    return _tabulate(all_reg_kmer_levels, min_kmer_obs,
                     all_kmers(kmer_width), "k-mer")


def tabulate_mod_kmer_levels(all_reg_kmer_levels, min_kmer_obs,
                             motif: TomboMotif):
    """(k-mer, offset, mean, sd) per motif key (reference:
    tombo/tombo_stats.py:2110-2158)."""
    kmer_width = len(next(iter(all_reg_kmer_levels[0].keys()))[0])
    keys = [(km, offset - 1) for km in all_kmers(kmer_width)
            for offset in motif.find_mod_poss(km)]
    return _tabulate(all_reg_kmer_levels, min_kmer_obs, keys,
                     "modified k-mer")


# --------------------------------------------------------------------------
# the re-centring fit (reference: tombo/tombo_stats.py:1599-1704)
# --------------------------------------------------------------------------

@dataclass
class RecenterRead:
    """What the fit needs of one read: the stored raw signal (not
    normalized; RNA not yet flipped), the event starts relative to
    ``rsrtr`` (``segs[:-1]``), the read-centric sequence, the RNA flag and
    the start of the mapped signal in the (flipped) raw signal."""
    raw: np.ndarray
    event_starts: np.ndarray
    seq: str
    rna: bool
    rsrtr: int


def load_fast5_read(r_data: ReadData) -> RecenterRead:
    """A read source: the read's FAST5 file (needs ``h5py``)."""
    raw, starts, seq = f5io.read_raw_and_events(r_data.fn,
                                                r_data.corr_group)
    return RecenterRead(raw, starts, seq, bool(r_data.rna),
                        int(r_data.read_start_rel_to_raw))


class MemoryReadSource:
    """A read source over re-squiggle results held in memory (the card's
    route, which writes no file): ``results`` are ResquiggleResults (or
    (result, error) pairs), ``raw_signals`` maps a read id to the raw
    signal as stored, before any RNA flip.  It hands the fit what the
    FAST5 loader would read back."""

    def __init__(self, results, raw_signals: Dict[str, np.ndarray]):
        self.results = {}
        for res in results:
            if isinstance(res, tuple):
                res = res[0]
            if res is not None:
                self.results[res.align_info.read_id] = res
        self.raw_signals = raw_signals

    def __call__(self, r_data: ReadData) -> RecenterRead:
        res = self.results[r_data.read_id]
        return RecenterRead(np.asarray(self.raw_signals[r_data.read_id]),
                            np.asarray(res.segs[:-1], np.int64),
                            res.genome_seq, bool(r_data.rna),
                            int(r_data.read_start_rel_to_raw))


def _rna_norm(raw, lens, reads, dev):
    """Event-scaled RNA normalization of the (flipped) raw rows: t-test
    changepoints, stall removal, the event-based scale, clipped at the
    outlier threshold (reference: tombo/tombo_stats.py:1627-1645)."""
    p = config.load_resquiggle_parameters(config.RNA_SAMP_TYPE)
    num_ev = np.array([rsq.compute_num_events(
        r.shape[0], len(rd.seq), p.mean_obs_per_event,
        config.MIN_EVENT_TO_SEQ_RATIO) for r, rd in reads], np.int64)
    stalls = [rsq.identify_stalls(r, config.DEFAULT_STALL_PARAMS)
              if config.COLLAPSE_RNA_STALLS else [] for r, _ in reads]
    n_st = max([1] + [len(s) for s in stalls])
    st_s = np.zeros((len(reads), n_st), np.int64)
    st_e = np.zeros((len(reads), n_st), np.int64)
    for i, st in enumerate(stalls):
        for j, (a, b) in enumerate(st):
            st_s[i, j], st_e[i, j] = a, b
    t = lambda a: torch.as_tensor(a, device=dev)
    _, _, status, shift, scale = rna_event_scale(
        raw, lens, t(num_ev), t(st_s), t(st_e), p.running_stat_width,
        p.min_obs_per_base, _pow2_bucket(int(num_ev.max()), 256))
    ot = torch.full_like(shift, config.OUTLIER_THRESH)
    return (nrm.normalize_with_scale_batch(raw, lens, shift, scale, -ot, ot),
            status == 0)


def read_corr_factors(reads: Sequence[RecenterRead], init_ref: KmerModel,
                      device: DeviceLike = None, dtype=None
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-read (shift correction, scale correction, fitted) of one batch
    of reads against ``init_ref``: the stored signal re-normalized
    (median/MAD for DNA, the event-based scale for RNA), the event means
    of the events from the model's central base on, Theil-Sen over at
    most ``MAX_POINTS_FOR_THEIL_SEN`` of them (the same rng(0) subsample
    a read), and the corrections 1 / slope and -intercept / slope.  A
    read that fails (too few events, a non-ACGT base, too few
    changepoints, a zero slope) is not fitted."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype, device)
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    B = len(reads)
    up = init_ref.central_pos
    dn = init_ref.kmer_width - up - 1
    ok = np.zeros(B, bool)
    # the reads that prepare: their (flipped) raw signal, mapped start,
    # event starts from the central base and expected levels
    idx, raws, rnas, starts, ess, refs = [], [], [], [], [], []
    for i, rd in enumerate(reads):
        try:
            es = np.asarray(rd.event_starts, np.int64)
            start = rd.rsrtr + int(es[up])
            es = es[up:-(dn - 1)] if dn > 1 else es[up:]
            es = es - es[0]
            ref_means, _ = init_ref.get_exp_levels_from_seq(rd.seq)
        except (IndexError, TomboError):
            continue
        if ref_means.shape[0] != es.shape[0] - 1 or ref_means.shape[0] < 2:
            continue
        raw = np.asarray(rd.raw, np.float64)
        idx.append(i)
        raws.append(raw[::-1] if rd.rna else raw)
        rnas.append(rd.rna)
        starts.append(start)
        ess.append(es)
        refs.append(ref_means)
    shift_corr, scale_corr = np.full(B, np.nan), np.full(B, np.nan)
    n = len(idx)
    if n == 0:
        return shift_corr, scale_corr, ok
    raw_pad = np.zeros((n, max(r.shape[0] for r in raws)), np_dt)
    for j, r in enumerate(raws):
        raw_pad[j, :r.shape[0]] = r
    raw_t = torch.as_tensor(raw_pad, device=device)
    lens = torch.as_tensor([r.shape[0] for r in raws], device=device)
    norm = torch.zeros_like(raw_t)
    fit_ok = torch.ones(n, dtype=torch.bool, device=device)
    for sel_rna in (False, True):
        rows = [j for j in range(n) if rnas[j] == sel_rna]
        if not rows:
            continue
        r_t = torch.as_tensor(rows, device=device)
        if sel_rna:
            norm[r_t], fit_ok[r_t] = _rna_norm(
                raw_t[r_t], lens[r_t],
                [(raws[j], reads[idx[j]]) for j in rows], device)
        else:
            norm[r_t] = nrm.normalize_median_batch(raw_t[r_t],
                                                   lens[r_t])[0]

    # event means over each read's mapped signal
    n_ev = np.array([es.shape[0] - 1 for es in ess], np.int64)
    segs = np.zeros((n, n_ev.max() + 1), np.int64)
    rm = np.ones((n, n_ev.max()), np_dt)
    for j, es in enumerate(ess):
        segs[j, :es.shape[0]] = es
        segs[j, es.shape[0]:] = es[-1]
        rm[j, :n_ev[j]] = refs[j]
    em = nrm.compute_base_means_batch(
        _slice_rows(norm, torch.arange(n, device=device),
                    torch.as_tensor(starts, device=device),
                    int(max(es[-1] for es in ess))),
        torch.as_tensor(segs, device=device),
        torch.as_tensor(n_ev, device=device))

    # the Theil-Sen points: every event, or the rng(0) subsample
    max_n = config.MAX_POINTS_FOR_THEIL_SEN
    N = int(min(n_ev.max(), max_n))
    samp = np.zeros((n, N), np.int64)
    for j, m in enumerate(n_ev):
        samp[j, :min(m, max_n)] = (_ts_sample_idx(int(m), max_n)
                                   if m > max_n else np.arange(m))
    samp_t = torch.as_tensor(samp, device=device)
    rm_t = torch.as_tensor(rm, device=device)
    n_pts = torch.as_tensor(np.minimum(n_ev, max_n), device=device)
    slope, inter = rescale.theil_sen_device(
        em.gather(1, samp_t), rm_t.gather(1, samp_t), n_pts,
        tri=(rescale.tri_indices(N, device) if dtype == torch.float32
             else None))
    fit_ok &= slope != 0
    safe = torch.where(fit_ok, slope, 1.0)
    sh = (-inter / safe).cpu().numpy().astype(np.float64)
    sc = (1.0 / safe).cpu().numpy().astype(np.float64)
    good = fit_ok.cpu().numpy()
    ok[idx] = good
    shift_corr[idx] = np.where(good, sh, np.nan)
    scale_corr[idx] = np.where(good, sc, np.nan)
    return shift_corr, scale_corr, ok


def read_corrections(reads_index, init_ref: KmerModel,
                     max_reads: int = config.NUM_READS_TO_ADJUST_MODEL,
                     read_source: Optional[Callable] = None,
                     batch_size: Optional[int] = None,
                     device: DeviceLike = None, dtype=None
                     ) -> Tuple[List[float], List[float]]:
    """(shift, scale) corrections of the first ``max_reads`` reads that
    load and fit, in the order of ``default_rng(0).shuffle`` of the
    index's reads, fitted ``batch_size`` reads at a time."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype, device)
    load = read_source or load_fast5_read
    batch_size = batch_size or RECENTER_BATCH[dtype]
    all_reads = list(reads_index.iter_reads())
    np.random.default_rng(0).shuffle(all_reads)
    shifts, scales = [], []
    i = 0
    while i < len(all_reads) and len(shifts) < max_reads:
        batch = []
        while i < len(all_reads) and len(batch) < batch_size:
            try:
                batch.append(load(all_reads[i]))
            except (OSError, KeyError, ValueError, TomboError):
                pass
            i += 1
        if not batch:
            continue
        sh, sc, ok = read_corr_factors(batch, init_ref, device, dtype)
        shifts.extend(float(x) for x in sh[ok])
        scales.extend(float(x) for x in sc[ok])
    return shifts[:max_reads], scales[:max_reads]


def center_model_to_median_norm(
        reads_index, init_ref: KmerModel,
        max_reads: int = config.NUM_READS_TO_ADJUST_MODEL,
        read_source: Optional[Callable] = None,
        batch_size: Optional[int] = None, device: DeviceLike = None,
        dtype=None) -> KmerModel:
    """``init_ref`` shifted and scaled by the median corrections of
    :func:`read_corrections` (reference: tombo/tombo_stats.py:1599-1704)."""
    shifts, scales = read_corrections(reads_index, init_ref, max_reads,
                                      read_source, batch_size, device, dtype)
    if not shifts:
        raise TomboError(
            "No reads successfully processed for sequence-based "
            "normalization parameter re-fitting.")
    return init_ref.center_model(float(np.median(shifts)),
                                 float(np.median(scales)))


def estimate_kmer_model(reads_index, fasta, cov_thresh, upstrm_bases,
                        dnstrm_bases, min_kmer_obs, kmer_specific_sd,
                        cs_cov_thresh, est_mean=False,
                        region_size=config.DEFAULT_REGION_SIZE,
                        read_source: Optional[Callable] = None,
                        rng: Optional[np.random.Generator] = None,
                        device: DeviceLike = None, dtype=None) -> KmerModel:
    """A canonical model from re-squiggled reads (reference:
    tombo/tombo_stats.py:1716-1740)."""
    all_reg_kmer_levels = extract_kmer_levels(
        reads_index, fasta, region_size, cov_thresh, upstrm_bases,
        dnstrm_bases, cs_cov_thresh, est_mean, rng=rng, device=device,
        dtype=dtype)
    if not all_reg_kmer_levels:
        raise TomboError("No regions contain enough coverage for model "
                         "estimation.")
    mean_sds = tabulate_kmer_levels(all_reg_kmer_levels, min_kmer_obs)
    init_ref = KmerModel.from_kmer_ref(mean_sds, upstrm_bases)
    centered = center_model_to_median_norm(
        reads_index, init_ref, read_source=read_source, device=device,
        dtype=dtype)
    if not kmer_specific_sd:
        centered = centered.make_constant_sd()
    return centered


def estimate_motif_alt_model(reads_index, fasta, motif_desc, upstrm_bases,
                             dnstrm_bases, min_kmer_obs, cov_thresh,
                             cs_cov_thresh, valid_poss=None,
                             region_size=config.DEFAULT_REGION_SIZE,
                             rng: Optional[np.random.Generator] = None,
                             device: DeviceLike = None,
                             dtype=None) -> AltModel:
    """An alternative model of the motif's modified base from a fully
    modified sample (reference: tombo/tombo_stats.py:2160-2189)."""
    try:
        raw_motif, mod_pos = motif_desc.split(":")
    except ValueError:
        raise TomboError("Invalid motif description format.")
    motif = TomboMotif(raw_motif, int(mod_pos))
    all_reg_kmer_levels = extract_kmer_levels(
        reads_index, fasta, region_size, cov_thresh, upstrm_bases,
        dnstrm_bases, cs_cov_thresh, False, motif, valid_poss, rng=rng,
        device=device, dtype=dtype)
    if not all_reg_kmer_levels:
        raise TomboError("No regions contain enough coverage for model "
                         "estimation.")
    mean_sds = tabulate_mod_kmer_levels(all_reg_kmer_levels, min_kmer_obs,
                                        motif)
    alt_ref = AltModel.from_kmer_ref(mean_sds, upstrm_bases, motif.mod_base,
                                     motif=motif)
    return alt_ref.make_constant_sd()


# --------------------------------------------------------------------------
# the density-based alternative model (reference:
# tombo/tombo_stats.py:1811-2108)
# --------------------------------------------------------------------------

_STRICT_LUT = np.full(256, -1, np.int8)
for _i, _b in enumerate(b"ACGT"):
    _STRICT_LUT[_b] = _i


def _read_kmer_codes(seq: str, k: int) -> np.ndarray:
    """Codes of a read's k-mer windows; -1 where a window holds anything
    but the upper-case bases A, C, G, T (no k-mer of the model)."""
    return seq_to_kmer_codes(_STRICT_LUT[np.frombuffer(seq.encode("ascii"),
                                                       np.uint8)], k)


def _load_base_read(chrm: str, r: ReadData, fasta, device):
    """(means source, sequence) of one read: ((tensor, offset), the
    reference's bases) where its means are device-resident, else (host
    means, the FAST5 bases); None where it cannot be loaded."""
    hit = device_levels.lookup(r.read_id, r.end - r.start, device)
    if hit is not None:
        if fasta is None:
            raise TomboError("a device-resident read's sequence needs the "
                             "reference")
        seq = fasta.get_seq(chrm, r.start, r.end)
        return hit, (rev_comp(seq) if r.strand == "-" else seq)
    try:
        rl = load_read_levels(r, with_seq=True)
    except (OSError, KeyError, TomboError):
        return None
    return rl.means, rl.seq


def parse_base_levels_flat(all_reads, std_ref: KmerModel, kmer_obs_thresh,
                           max_kmer_obs, min_kmer_obs_to_est, fasta=None,
                           device: DeviceLike = None, dtype=None):
    """:func:`parse_base_levels` as (levels, counts): the kept
    observations of every k-mer one after another, k-mers in code order
    (a tensor on ``device``), and (4**k,) numpy counts.

    ``all_reads``: (chrm, ReadData) in the order to take them.  A
    running count per (read, k-mer), ``PARSE_CHUNK_READS`` reads at a
    time, finds which observations the reference's read-by-read loop
    keeps: a k-mer's first ``max_kmer_obs + 1``, up to the first read
    after which every k-mer has them all or the fewest exceed
    ``kmer_obs_thresh``."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype, device)
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    k = std_ref.kmer_width
    central = std_ref.central_pos
    dnstrm = k - central - 1
    K = 4 ** k
    cap = max_kmer_obs + 1
    totals = np.zeros(K, np.int64)
    kept = []
    done = False
    for c0 in range(0, len(all_reads), PARSE_CHUNK_READS):
        if done:
            break
        # per observation: its k-mer code, read, source and index there;
        # source 0 holds the host reads' values, uploaded once a chunk
        codes_l, read_l, src_l, idx_l = [], [], [], []
        sources, src_ids, host_vals, n_host = [None], {}, [], 0
        R = 0
        for chrm, r in all_reads[c0:c0 + PARSE_CHUNK_READS]:
            got = _load_base_read(chrm, r, fasta, device)
            if got is None:
                continue
            means, seq = got
            on_dev = isinstance(means, tuple)
            n_means = r.end - r.start if on_dev else means.shape[0]
            n_pos = max(0, n_means - central - dnstrm) if dnstrm else 0
            codes = _read_kmer_codes(seq, k)[:n_pos]
            pos = np.flatnonzero(codes >= 0)
            if on_dev:
                src, off = means
                sid = src_ids.setdefault(id(src), len(sources))
                if sid == len(sources):
                    sources.append(src)
                idx_l.append(off + central + pos)
            else:
                sid = 0
                host_vals.append(means[central + pos])
                idx_l.append(np.arange(n_host, n_host + pos.shape[0]))
                n_host += pos.shape[0]
            codes_l.append(codes[pos])
            read_l.append(np.full(pos.shape[0], R, np.int64))
            src_l.append(np.full(pos.shape[0], sid, np.int64))
            R += 1
        if R == 0:
            continue
        codes = np.concatenate(codes_l)
        read_i = np.concatenate(read_l)
        cnt = np.bincount(read_i * K + codes, minlength=R * K).reshape(R, K)
        capped = np.minimum(totals[None, :] + np.cumsum(cnt, axis=0), cap)
        stop = (capped == cap).all(1) | (capped.min(1) > kmer_obs_thresh)
        r_stop = int(np.argmax(stop)) if stop.any() else R - 1
        done = bool(stop.any())
        # each observation's rank among its k-mer's, over all reads so far
        order = np.argsort(codes, kind="stable")
        cs = codes[order]
        first = np.searchsorted(cs, cs, side="left")
        rank = np.empty_like(order)
        rank[order] = totals[cs] + np.arange(cs.shape[0]) - first
        totals = capped[r_stop]
        km = np.flatnonzero((read_i <= r_stop) & (rank < cap))
        # the kept values, one gather a source
        if host_vals:
            sources[0] = torch.from_numpy(np.concatenate(host_vals).astype(
                np_dt)).to(device)
        src_k = np.concatenate(src_l)[km]
        idx_k = np.concatenate(idx_l)[km]
        vals = torch.empty(km.shape[0], dtype=dtype, device=device)
        for sid, src in enumerate(sources):
            m = np.flatnonzero(src_k == sid)
            if m.size:
                vals[torch.as_tensor(m, device=device)] = src[
                    torch.as_tensor(idx_k[m], device=src.device)].to(
                        device=device, dtype=dtype)
        kept.append((codes[km], rank[km], vals))
    if not kept:
        return torch.empty(0, dtype=dtype, device=device), totals
    codes = np.concatenate([c for c, _, _ in kept])
    ranks = np.concatenate([r for _, r, _ in kept])
    vals = torch.cat([v for _, _, v in kept])
    order = np.lexsort((ranks, codes))
    return vals[torch.as_tensor(order, device=device)], totals


def _check_fewest(counts, kmer_obs_thresh, min_kmer_obs_to_est):
    fewest = int(counts.min())
    if fewest < kmer_obs_thresh and fewest < min_kmer_obs_to_est:
        raise TomboError(
            "Too few minimal k-mer observations to continue to "
            "alternative estimation. Minimal k-mer has %d total "
            "observations and %d observations per k-mer are required."
            % (fewest, min_kmer_obs_to_est))


def _index_reads(reads_index, rng: Optional[np.random.Generator]):
    """(chrm, ReadData) of every read of the index, shuffled in the
    reference's order (``rng``, default rng(0))."""
    reads = [(cs[0], r) for cs, cs_reads in reads_index.reads_index.items()
             for r in cs_reads]
    (rng or np.random.default_rng(0)).shuffle(reads)
    return reads


def parse_base_levels(all_reads, std_ref: KmerModel, kmer_obs_thresh,
                      max_kmer_obs, min_kmer_obs_to_est, fasta=None,
                      device: DeviceLike = None, dtype=None
                      ) -> Dict[str, List[float]]:
    """{k-mer: [level, ...]}: per-k-mer level observations from the reads
    until every k-mer has ``max_kmer_obs + 1`` or the fewest exceed
    ``kmer_obs_thresh`` (reference: tombo/tombo_stats.py:1811-1884)."""
    flat, counts = parse_base_levels_flat(
        all_reads, std_ref, kmer_obs_thresh, max_kmer_obs,
        min_kmer_obs_to_est, fasta, device, dtype)
    _check_fewest(counts, kmer_obs_thresh, min_kmer_obs_to_est)
    vals = flat.cpu().numpy().astype(np.float64)
    ends = np.cumsum(counts)
    return {km: [float(x) for x in vals[e - c:e]]
            for km, c, e in zip(all_kmers(std_ref.kmer_width), counts, ends)}


def est_kernel_density(reads_index, std_ref: KmerModel, kmer_obs_thresh,
                       density_basename, save_x, kernel_dens_bw,
                       alt_or_stnd_name="alt",
                       max_kmer_obs=config.MAX_KMER_OBS,
                       min_kmer_obs_to_est=config.MIN_KMER_OBS_TO_EST,
                       rng: Optional[np.random.Generator] = None,
                       fasta=None, device: DeviceLike = None, dtype=None
                       ) -> Dict[str, np.ndarray]:
    """{k-mer: density at ``save_x``} of one sample's level observations
    (reference: tombo/tombo_stats.py:1916-1944); written to
    ``<density_basename>.<alt_or_stnd_name>_density.txt`` when a basename
    is given."""
    device = resolve_device(device)
    flat, counts = parse_base_levels_flat(
        _index_reads(reads_index, rng), std_ref, kmer_obs_thresh,
        max_kmer_obs, min_kmer_obs_to_est, fasta, device, dtype)
    _check_fewest(counts, kmer_obs_thresh, min_kmer_obs_to_est)
    dens = kde_evaluate(flat, counts, kernel_dens_bw, save_x,
                        device).cpu().numpy()
    kmer_dens = dict(zip(all_kmers(std_ref.kmer_width), dens))
    if density_basename is not None:
        write_kmer_densities_file(
            density_basename + "." + alt_or_stnd_name + "_density.txt",
            kmer_dens, save_x)
    return kmer_dens


def write_kmer_densities_file(dens_fn, kmer_dens, save_x):
    """(reference: tombo/tombo_stats.py:1886-1893)."""
    with _io.open(dens_fn, "wt") as fp:
        fp.write("Kmer\tSignal\tDensity\n")
        fp.write("\n".join(
            "\t".join(map(str, (km, x, y)))
            for km, dens in kmer_dens.items()
            for x, y in zip(save_x, dens)) + "\n")


def parse_kmer_densities_file(dens_fn):
    """(reference: tombo/tombo_stats.py:1895-1914)."""
    raw = defaultdict(list)
    with _io.open(dens_fn) as fp:
        fp.readline()
        for line in fp:
            km, _, dens_i = line.split()
            raw[km].append(float(dens_i))
    out = {}
    first_len = None
    for km, dens in raw.items():
        if first_len is None:
            first_len = len(dens)
        if len(dens) != first_len:
            raise TomboError("Density file is not valid.")
        out[km] = np.array(dens)
    return out


def isolate_alt_density(alt_dens, std_dens, alt_base, alt_frac_pctl,
                        std_ref: KmerModel, save_x) -> AltModel:
    """Quadratic density-shift correction, then spectral subtraction of
    the control density (reference: tombo/tombo_stats.py:1991-2072)."""
    def calc_mean(dens):
        sel = dens > 1e-10
        return np.average(save_x[sel], weights=dens[sel])

    no_alt_means, no_alt_diffs = [], []
    for km in std_dens:
        if alt_base in km:
            continue
        m = calc_mean(std_dens[km])
        no_alt_means.append(m)
        no_alt_diffs.append(calc_mean(alt_dens[km]) - m)
    calc_offset = np.poly1d(np.polyfit(no_alt_means, no_alt_diffs, 2))
    unit = save_x[1] - save_x[0]

    shifted_alt_dens = {}
    for km, kad in alt_dens.items():
        est_offset = int(calc_offset(calc_mean(std_dens[km])) / unit)
        if est_offset < 0:
            shifted_alt_dens[km] = np.concatenate(
                [[0.0] * -est_offset, kad[:est_offset]])
        else:
            shifted_alt_dens[km] = np.concatenate(
                [kad[est_offset:], [0.0] * est_offset])

    def get_peak_frac(ksd, kad):
        std_peak = np.argmax(ksd)
        local_peaks = np.where(np.concatenate([
            [False], (kad[1:-1] > kad[:-2]) & (kad[1:-1] > kad[2:]),
            [False]]))[0]
        if local_peaks.shape[0] == 0:
            return 1.0
        matched = local_peaks[np.argmin(np.abs(local_peaks - std_peak))]
        return kad[matched] / ksd[std_peak]

    std_frac = np.percentile([
        get_peak_frac(std_dens[km], shifted_alt_dens[km])
        for km in std_dens if km.count(alt_base) == 1], alt_frac_pctl)

    model_sd = float(np.nanmean(std_ref.sds))
    alt_ref_entries = []
    for km in all_kmers(std_ref.kmer_width):
        n_alt = km.count(alt_base)
        if n_alt == 0:
            continue
        kmer_std_frac = std_frac ** n_alt
        with np.errstate(under="ignore"):
            diff_dens = shifted_alt_dens[km] - std_dens[km] * kmer_std_frac
            diff_dens[diff_dens < 0] = 0
            alt_level = float(np.average(save_x, weights=diff_dens))
        for m in re.finditer(alt_base, km):
            alt_ref_entries.append((km, m.start(), alt_level, model_sd))
    return AltModel.from_kmer_ref(alt_ref_entries, std_ref.central_pos,
                                  alt_base)


def estimate_alt_model(reads_index, ctrl_reads_index, std_ref: KmerModel,
                       alt_base, alt_frac_pctl, kmer_obs_thresh,
                       density_basename=None, kernel_dens_bw=0.05,
                       alt_dens_fn=None, std_dens_fn=None,
                       num_dens_points=config.NUM_DENS_POINTS, fasta=None,
                       device: DeviceLike = None, dtype=None) -> AltModel:
    """An alternative-base model from an alternative sample and a control
    sample, or from their density files (reference:
    tombo/tombo_stats.py:2073-2106).  ``fasta`` gives the sequence of
    reads whose means are device-resident."""
    if alt_dens_fn is None or std_dens_fn is None:
        save_x = np.linspace(config.KERNEL_DENSITY_RANGE[0],
                             config.KERNEL_DENSITY_RANGE[1],
                             num_dens_points)
        kw = dict(fasta=fasta, device=device, dtype=dtype)
        alt_dens = est_kernel_density(
            reads_index, std_ref, kmer_obs_thresh, density_basename,
            save_x, kernel_dens_bw, "alternate", **kw)
        std_dens = est_kernel_density(
            ctrl_reads_index, std_ref, kmer_obs_thresh, density_basename,
            save_x, kernel_dens_bw, "control", **kw)
    else:
        alt_dens = parse_kmer_densities_file(alt_dens_fn)
        std_dens = parse_kmer_densities_file(std_dens_fn)
        n_pts = next(iter(alt_dens.values())).shape[0]
        if n_pts != next(iter(std_dens.values())).shape[0]:
            raise TomboError("Alternative and standard density estimates "
                             "do not correspond.")
        save_x = np.linspace(config.KERNEL_DENSITY_RANGE[0],
                             config.KERNEL_DENSITY_RANGE[1], n_pts)
    return isolate_alt_density(alt_dens, std_dens, alt_base, alt_frac_pctl,
                               std_ref, save_x)
