"""Legacy event-table re-squiggle, ``build_model event_resquiggle``
(counterpart of ``tombo_tpu/pipeline/event_resquiggle.py``; reference:
tombo/_event_resquiggle.py).

Instead of the banded signal-to-sequence DP, a read's segments are the
basecaller's ``Events`` table boundaries, and raw signal is re-segmented
only around the alignment's indels (the "ambiguous indel group"
machinery, reference: _event_resquiggle.py:76-248) by the changepoint
selection of ``ops/ref_impl.py``.  Alignments come from an in-process
aligner (``pipeline/aligner.py``), a SAM or M5 file, or an external
minimap2, bwa-mem or graphmap run as subprocesses on FASTA batches.

Every read is host work on its FAST5 file, in numpy at float64 (the JAX
package has no device code here either); ``h5py`` is imported inside
the functions that open a file.
"""
from __future__ import annotations

import os
import re
import time as _time
from collections import namedtuple
from typing import List, Optional, Tuple

import numpy as np

from .. import config
from ..errors import TomboError
from ..io import fast5 as f5io
from ..io.index import ReadsIndex
from ..ops import ref_impl
from ..seq import rev_comp
from ..types import AlignInfo, GenomeLocation, ReadData, ResquiggleResults
from . import resquiggle as rsq

GAP_PAT = re.compile("-+")
indelStats = namedtuple("indelStats", ("start", "end", "diff"))
indelGroupStats = namedtuple("indelGroupStats",
                             ("start", "end", "cpts", "indels"))

# mappy cigar op codes: 0=M, 1=I (read ins), 2=D (read del)
_CIG_M, _CIG_I, _CIG_D = 0, 1, 2

# SAM text cigar (reference: tombo/_event_resquiggle.py:68)
CIGAR_PAT = re.compile(r"(\d+)([MIDNSHP=X])")
SAM_FIELDS = ("qName", "flag", "rName", "pos", "mapq", "cigar", "rNext",
              "pNext", "tLen", "seq", "qual")

# parsed external alignment: (read_base, genome_base) '-'-gapped columns
# in read orientation, the 0-based genome location, and basecall clips
SamAlignment = namedtuple(
    "SamAlignment", ("align_vals", "genome_loc", "start_clip", "end_clip"))


def parse_sam_record(fields: dict, fasta) -> SamAlignment:
    """One SAM record -> gapped alignment columns
    (reference: tombo/_event_resquiggle.py:615-712 ``parse_sam_record``):
    hard/soft clips are stripped into clip counts, leading/trailing
    non-match ops are trimmed, and M/=/X, I/P, D/N ops emit
    (read, genome) column pairs against the FASTA-fetched target."""
    cigar = [(int(n), op) for n, op in CIGAR_PAT.findall(fields["cigar"])]
    if not cigar:
        raise TomboError("Invalid cigar string produced.")
    strand = "-" if int(fields["flag"]) & 0x10 else "+"
    if strand == "-":
        cigar = cigar[::-1]

    q_seq = (fields["seq"] if strand == "+"
             else rev_comp(fields["seq"]))
    start_clip = end_clip = 0
    if cigar[0][1] == "H":
        start_clip += cigar[0][0]
        cigar = cigar[1:]
    if cigar[-1][1] == "H":
        end_clip += cigar[-1][0]
        cigar = cigar[:-1]
    if cigar[0][1] == "S":
        start_clip += cigar[0][0]
        q_seq = q_seq[cigar[0][0]:]
        cigar = cigar[1:]
    if cigar[-1][1] == "S":
        end_clip += cigar[-1][0]
        q_seq = q_seq[:-cigar[-1][0]]
        cigar = cigar[:-1]

    t_len = sum(n for n, op in cigar if op in "MDN=X")
    t_seq = fasta.get_seq(fields["rName"], int(fields["pos"]) - 1,
                          int(fields["pos"]) + t_len - 1)
    if strand == "-":
        t_seq = rev_comp(t_seq)

    # trim to matched-base bounds (reference: _event_resquiggle.py:664-680)
    while cigar and cigar[0][1] not in "M=X":
        if cigar[0][1] in "ND":
            t_seq = t_seq[cigar[0][0]:]
        else:
            q_seq = q_seq[cigar[0][0]:]
            start_clip += cigar[0][0]
        cigar = cigar[1:]
    while cigar and cigar[-1][1] not in "M=X":
        if cigar[-1][1] in "ND":
            t_seq = t_seq[:-cigar[-1][0]]
        else:
            q_seq = q_seq[:-cigar[-1][0]]
            end_clip += cigar[-1][0]
        cigar = cigar[:-1]
    if not cigar:
        raise TomboError("Invalid cigar string produced.")
    q_len = sum(n for n, op in cigar if op in "MI=X")
    if len(q_seq) != q_len:
        raise TomboError("Read sequence from SAM and corresponding "
                            "cigar string do not agree.")

    align_vals = []
    t_pos = q_pos = 0
    for n, op in cigar:
        if op in "M=X":
            align_vals.extend(zip(q_seq[q_pos:q_pos + n],
                                  t_seq[t_pos:t_pos + n]))
            t_pos += n
            q_pos += n
        elif op in "IP":
            align_vals.extend((qb, "-") for qb in q_seq[q_pos:q_pos + n])
            q_pos += n
        else:
            align_vals.extend(("-", tb) for tb in t_seq[t_pos:t_pos + n])
            t_pos += n
    return SamAlignment(
        align_vals,
        GenomeLocation(int(fields["pos"]) - 1, strand, fields["rName"]),
        start_clip, end_clip)


def parse_sam_file(sam_fn: str, fasta) -> dict:
    """Parse a SAM file from any external aligner into per-read
    alignments, keeping the highest-mapq record per read name
    (reference: tombo/_event_resquiggle.py:714-760 ``parse_sam_output``).
    Records that fail to parse are left out."""
    best = {}
    with open(sam_fn) as fp:
        for line in fp:
            if line.startswith("@"):
                continue
            fields = dict(zip(SAM_FIELDS, line.rstrip("\n").split("\t")))
            if len(fields) < len(SAM_FIELDS):
                continue
            if fields["rName"] == "*":
                continue
            prev = best.get(fields["qName"])
            if prev is None or int(prev["mapq"]) < int(fields["mapq"]):
                best[fields["qName"]] = fields
    out = {}
    for qname, fields in best.items():
        try:
            out[qname] = parse_sam_record(fields, fasta)
        except (TomboError, KeyError, ValueError):
            continue
    return out


# blasr/graphmap m5 alignment format
# (reference: tombo/_event_resquiggle.py:60-66)
M5_FIELDS = (
    "qName", "qLength", "qStart", "qEnd", "qStrand",
    "tName", "tLength", "tStart", "tEnd", "tStrand",
    "score", "numMatch", "numMismatch", "numIns", "numDel",
    "mapQV", "qAlignedSeq", "matchPattern", "tAlignedSeq")


def parse_m5_record(rec: dict) -> SamAlignment:
    """One m5 record -> gapped alignment columns
    (reference: tombo/_event_resquiggle.py:529-585 ``clip_m5_alignment``
    + ``parse_m5_record``): the '-'-gapped aligned sequence pair is
    re-oriented to the read, clipped to its first/last matching columns,
    and the genome start adjusted by the genome bases clipped on the
    strand-appropriate end."""
    if rec["tStrand"] != "+":
        raise TomboError(
            "Mapping indicates negative strand reference mapping.")
    q, t = rec["qAlignedSeq"], rec["tAlignedSeq"]
    if rec["qStrand"] != "+":
        q, t = rev_comp(q), rev_comp(t)
    align_vals = list(zip(q, t))

    start_clip_read = start_clip_genome = s = 0
    while align_vals[s][0] == "-" or align_vals[s][1] == "-":
        start_clip_read += align_vals[s][0] != "-"
        start_clip_genome += align_vals[s][1] != "-"
        s += 1
    end_clip_read = end_clip_genome = e = 0
    while (align_vals[-1 - e][0] == "-" or align_vals[-1 - e][1] == "-"):
        end_clip_read += align_vals[-1 - e][0] != "-"
        end_clip_genome += align_vals[-1 - e][1] != "-"
        e += 1
    align_vals = align_vals[s:len(align_vals) - e]

    start = int(rec["tStart"])
    if rec["qStrand"] == "+":
        start += start_clip_genome
    else:
        start += end_clip_genome
    return SamAlignment(
        align_vals, GenomeLocation(start, rec["qStrand"], rec["tName"]),
        start_clip_read, end_clip_read)


def parse_m5_file(m5_fn: str) -> dict:
    """Parse an m5 alignment file (blasr/graphmap ``-printMD``-style
    output) keeping the highest-score record per read
    (reference: tombo/_event_resquiggle.py:587-613 ``parse_m5_output``).
    No FASTA needed: m5 records carry the aligned target sequence."""
    best = {}
    with open(m5_fn) as fp:
        for line in fp:
            rec = dict(zip(M5_FIELDS, line.strip().split()))
            if len(rec) != len(M5_FIELDS):
                continue
            prev = best.get(rec["qName"])
            if prev is None or int(prev["score"]) < int(rec["score"]):
                best[rec["qName"]] = rec
    out = {}
    for qname, rec in best.items():
        try:
            out[qname] = parse_m5_record(rec)
        except (TomboError, KeyError, ValueError, IndexError):
            continue
    return out


def parse_pore_model_file(pore_model_fn: str):
    """Load a tab-separated pore model (columns including ``kmer``,
    ``level_mean``, ``level_stdv``) for pA fitted normalization
    (reference: tombo/_event_resquiggle.py pore-model path /
    tombo/_option_parsers.py:57-62).  Returns dict kmer -> (mean, sd)."""
    model = {}
    with open(pore_model_fn) as fp:
        header = None
        for line in fp:
            if line.startswith("#"):
                continue
            parts = line.rstrip("\n").split("\t")
            if header is None:
                header = {name: i for i, name in enumerate(parts)}
                for col in ("kmer", "level_mean", "level_stdv"):
                    if col not in header:
                        raise TomboError(
                            "Pore model file must contain kmer, level_mean "
                            "and level_stdv columns")
                continue
            model[parts[header["kmer"]]] = (
                float(parts[header["level_mean"]]),
                float(parts[header["level_stdv"]]))
    if not model:
        raise TomboError("Empty pore model file")
    return model


def get_read_event_starts(fast5_data, basecall_group: str,
                          basecall_subgroup: str):
    """Per-called-base signal start offsets from the basecaller Events
    table (reference: tombo/_event_resquiggle.py:490-612
    ``get_read_data``).  Handles albacore>=2.0-style integer starts with
    ``move``/``model_state`` columns and simple per-base tables.

    Returns (seq, starts_rel_to_read (n_bases + 1,), rsrtr)."""
    try:
        events = fast5_data["/Analyses/" + basecall_group + "/" +
                            basecall_subgroup + "/Events"][:]
    except KeyError:
        raise TomboError(
            "No events or corrupted events in file. Likely a "
            "segmentation error or mis-specified basecall-subgroups.")
    names = events.dtype.names
    starts = events["start"].astype(np.int64)
    rsrtr = int(starts[0])
    if "move" in names and "model_state" in names:
        moves = events["move"].astype(np.int64)
        states = [s.decode() if isinstance(s, bytes) else s
                  for s in events["model_state"]]
        kmer_width = len(states[0])
        central = kmer_width // 2
        # base i is called at the event where cumulative moves reach i
        base_starts = [starts[0]]
        seq_bases = [states[0]]
        for ev_i in range(1, len(moves)):
            if moves[ev_i] > 0:
                for sub in range(int(moves[ev_i])):
                    base_starts.append(starts[ev_i])
                    seq_bases.append(states[ev_i])
        seq = "".join(st[central] for st in seq_bases)
        lengths = events["length"].astype(np.int64)
        end = int(starts[-1] + lengths[-1])
        starts_rel = np.array(base_starts + [end], np.int64) - rsrtr
        return seq, starts_rel, rsrtr
    # simple per-base events (one row per base)
    if "base" in names:
        seq = b"".join(events["base"]).decode()
    elif "model_state" in names:
        seq = "".join(
            (s.decode() if isinstance(s, bytes) else s)[0]
            for s in events["model_state"])
    else:
        raise TomboError("Events table lacks base calls.")
    lengths = events["length"].astype(np.int64)
    end = int(starts[-1] + lengths[-1])
    starts_rel = np.concatenate([starts, [end]]) - rsrtr
    return seq, starts_rel, rsrtr


def align_vals_from_cigar(read_seq: str, genome_seq: str, cigar,
                          q_st: int) -> List[Tuple[str, str]]:
    """(read_base, genome_base) pairs with '-' gaps from a cigar."""
    out = []
    ri, gi = q_st, 0
    for length, op in cigar:
        if op == _CIG_M:
            for _ in range(length):
                out.append((read_seq[ri], genome_seq[gi]))
                ri += 1
                gi += 1
        elif op == _CIG_I:
            for _ in range(length):
                out.append((read_seq[ri], "-"))
                ri += 1
        elif op == _CIG_D:
            for _ in range(length):
                out.append(("-", genome_seq[gi]))
                gi += 1
        # soft clips handled by caller via q_st/q_en
    return out


def get_indel_groups(align_vals, align_segs, norm_signal,
                     min_obs_per_base, running_stat_width,
                     timeout=None, num_cpts_limit=None):
    """(reference: tombo/_event_resquiggle.py:76-248)."""
    def get_all_indels():
        read_align = "".join(rb for rb, gb in align_vals)
        genome_align = "".join(gb for rb, gb in align_vals)
        genome_gaps = [(m.start(), m.end())
                       for m in GAP_PAT.finditer(genome_align)]
        read_gaps = [(m.start(), m.end())
                     for m in GAP_PAT.finditer(read_align)]
        all_indel_locs = sorted(
            genome_gaps + read_gaps +
            [(0, 0), (len(read_align), len(read_align))])
        btwn = [genome_align[e0:s1] for (_, e0), (s1, _) in
                zip(all_indel_locs[:-1], all_indel_locs[1:])]
        all_is_ins = [read_align[s:e].startswith("-")
                      for s, e in all_indel_locs[1:-1]]
        indel_seqs = [genome_align[s:e] if is_ins else read_align[s:e]
                      for is_ins, (s, e) in
                      zip(all_is_ins, all_indel_locs[1:-1])]
        unambig = []
        curr_read_len = len(btwn[0])
        for indel_seq, before_seq, after_seq, is_ins in zip(
                indel_seqs, btwn[:-1], btwn[1:], all_is_ins):
            indel_len = len(indel_seq)
            indel_end = (curr_read_len + 1 if is_ins
                         else curr_read_len + indel_len + 1)
            indel_diff = indel_len if is_ins else -indel_len
            u, d = -1, 0
            while (d < len(after_seq) - 1 and
                   indel_seq[d % indel_len] == after_seq[d]):
                d += 1
            while (u * -1 <= len(before_seq) - 1 and
                   indel_seq[(u % indel_len) - indel_len] ==
                   before_seq[u]):
                u -= 1
            unambig.append(indelStats(curr_read_len + u, indel_end + d,
                                      indel_diff))
            if not is_ins:
                curr_read_len += indel_len
            curr_read_len += len(after_seq)
        return unambig

    indel_groups: List[indelGroupStats] = []

    def extend_group(indel_group):
        group_start = min(i.start for i in indel_group)
        group_end = max(i.end for i in indel_group)
        num_cpts = sum(i.diff for i in indel_group) + \
            group_end - group_start - 1
        prev_num_cpts = num_cpts
        while align_segs[group_end] - align_segs[group_start] < (
                (num_cpts + 1) * min_obs_per_base) + \
                (running_stat_width * 2):
            num_cpts += int(group_start > 0) + int(
                group_end < len(align_segs) - 1)
            if num_cpts == prev_num_cpts:
                raise TomboError(
                    "Entire read does not contain enough signal to "
                    "re-squiggle")
            prev_num_cpts = num_cpts
            group_start = max(0, group_start - 1)
            group_end = min(len(align_segs) - 1, group_end + 1)
        return group_start, group_end, num_cpts

    def extend_and_join(indel_group):
        group_start, group_end, num_cpts = extend_group(indel_group)
        while indel_groups and group_start <= indel_groups[-1].end:
            indel_group = indel_groups[-1].indels + indel_group
            del indel_groups[-1]
            group_start, group_end, num_cpts = extend_group(indel_group)
        return group_start, group_end, num_cpts, indel_group

    def get_cpts(group_start, group_end, num_cpts):
        if num_cpts_limit is not None and num_cpts > num_cpts_limit:
            raise TomboError("Reached maximum number of changepoints "
                                "for a single indel")
        try:
            cpts = ref_impl.valid_cpts_w_cap(
                norm_signal[align_segs[group_start]:
                            align_segs[group_end]].astype(np.float64),
                min_obs_per_base, running_stat_width, num_cpts)
        except TomboError:
            return None
        cpts.sort()
        return cpts

    def extend_for_cpts(group_start, group_end, num_cpts, indel_group):
        cpts = get_cpts(group_start, group_end, num_cpts)
        while cpts is None:
            num_cpts += int(group_start > 0) + int(
                group_end < len(align_segs) - 1)
            group_start = max(0, group_start - 1)
            group_end = min(len(align_segs) - 1, group_end + 1)
            while indel_groups and group_start <= indel_groups[-1].end:
                indel_group = indel_groups[-1].indels + indel_group
                del indel_groups[-1]
                group_start, group_end, num_cpts = extend_group(
                    indel_group)
            cpts = get_cpts(group_start, group_end, num_cpts)
        return (cpts + align_segs[group_start], group_start, group_end,
                indel_group)

    all_indels = get_all_indels()
    if not all_indels:
        return []
    start_clock = _time.time() if timeout is not None else None
    curr_group = [all_indels[0]]
    for indel in all_indels[1:]:
        if (start_clock is not None and
                _time.time() - start_clock > timeout):
            # reference enforces a per-read processing timeout
            # (tombo/_option_parsers.py:302-304 ``timeout_opt``)
            raise TomboError("Read took too long to re-segment.")
        if max(g.end for g in curr_group) >= indel.start:
            curr_group.append(indel)
        else:
            (curr_start, curr_stop, num_cpts,
             curr_group) = extend_and_join(curr_group)
            cpts, curr_start, curr_stop, curr_group = extend_for_cpts(
                curr_start, curr_stop, num_cpts, curr_group)
            if curr_stop >= indel.start:
                curr_group.append(indel)
            else:
                indel_groups.append(indelGroupStats(
                    curr_start, curr_stop, cpts, curr_group))
                curr_group = [indel]
    if not indel_groups or \
            indel_groups[-1].indels[-1] != all_indels[-1]:
        curr_start, curr_stop, num_cpts, curr_group = extend_and_join(
            curr_group)
        cpts, curr_start, curr_stop, curr_group = extend_for_cpts(
            curr_start, curr_stop, num_cpts, curr_group)
        indel_groups.append(indelGroupStats(
            curr_start, curr_stop, cpts, curr_group))
    return indel_groups


def event_resquiggle_read(fast5_fn: str, aligner,
                          basecall_group: str = "Basecall_1D_000",
                          basecall_subgroup: str =
                          config.DEFAULT_BASECALL_SUBGROUP,
                          corr_grp: str = config.DEFAULT_CORRECTED_GROUP,
                          outlier_thresh: Optional[float] =
                          config.OUTLIER_THRESH,
                          seg_params=None, overwrite: bool = True,
                          compute_sd: bool = False,
                          norm_type: str = "median", pore_model=None,
                          alignment: Optional[SamAlignment] = None,
                          timeout: Optional[float] = None,
                          num_cpts_limit: Optional[int] = None):
    """Re-squiggle one read from its basecaller Events table
    (reference: tombo/_event_resquiggle.py:295-417).

    ``alignment`` (a parsed external-aligner SAM record) replaces the
    in-process aligner when given; ``norm_type`` supports
    median/pA_raw/pA/none (pA needs ``pore_model``, the parsed
    --pore-model-filename table)."""
    import h5py
    with h5py.File(fast5_fn, "r") as fast5_data:
        raw = f5io.get_raw_signal(fast5_data)
        rna = f5io.is_read_rna(fast5_data)
        read_id = f5io.get_read_id(fast5_data)
        seq, starts_rel_to_read, rsrtr = get_read_event_starts(
            fast5_data, basecall_group, basecall_subgroup)
        channel_info = None
        ev_means = model_means = model_inv_vars = None
        if norm_type in ("pA", "pA_raw"):
            channel_info = f5io.get_channel_info(fast5_data)
        if norm_type == "pA":
            if pore_model is None:
                raise TomboError(
                    "pA normalization requires --pore-model-filename")
            events = fast5_data["/Analyses/" + basecall_group + "/" +
                                basecall_subgroup + "/Events"][:]
            if "mean" not in events.dtype.names or \
                    "model_state" not in events.dtype.names:
                raise TomboError(
                    "Events table lacks mean/model_state columns required "
                    "for pA normalization")
            ev_means = events["mean"].astype(np.float64)
            try:
                mm_sd = [pore_model[
                    (k.decode() if isinstance(k, bytes) else k)]
                    for k in events["model_state"]]
            except KeyError:
                raise TomboError(
                    "Events table contains k-mers missing from the pore "
                    "model")
            model_means = np.array([m for m, _ in mm_sd])
            model_inv_vars = np.array([1.0 / (sd * sd) for _, sd in mm_sd])
    if rna:
        raw = raw[::-1]
        seq = seq.replace("U", "T")

    samp_type = config.RNA_SAMP_TYPE if rna else config.DNA_SAMP_TYPE
    if seg_params is None:
        p = config.SEG_PARAMS_TABLE[samp_type]
        running_stat_width = p.running_stat_width
        min_obs_per_base = p.min_obs_per_base
    else:
        running_stat_width, min_obs_per_base = seg_params

    if alignment is not None:
        align_vals = alignment.align_vals
        genome_loc = alignment.genome_loc
        strand = genome_loc.strand
        start_clip, end_clip = alignment.start_clip, alignment.end_clip
        aln = None
    else:
        aln = aligner.map(seq)
        if aln is None:
            raise TomboError("Alignment not produced")
        if aln.strand == 1:
            genome_seq = aligner.seq(aln.ctg, aln.r_st, aln.r_en)
            strand = "+"
        else:
            genome_seq = rev_comp(aligner.seq(aln.ctg, aln.r_st, aln.r_en))
            strand = "-"
        genome_loc = GenomeLocation(aln.r_st, strand, aln.ctg)
        start_clip, end_clip = aln.q_st, len(seq) - aln.q_en

    # clip basecalls outside the alignment (reference:
    # tombo/_event_resquiggle.py:477-489)
    if start_clip > 0:
        clip_obs = int(starts_rel_to_read[start_clip])
        starts_rel_to_read = starts_rel_to_read[start_clip:] - clip_obs
        rsrtr += clip_obs
    if end_clip > 0:
        starts_rel_to_read = starts_rel_to_read[:-end_clip]

    if alignment is None:
        align_vals = align_vals_from_cigar(
            seq[aln.q_st:aln.q_en], genome_seq, aln.cigar, 0)
    if len(align_vals) - sum(1 for rb, _ in align_vals if rb == "-") != \
            starts_rel_to_read.shape[0] - 1:
        raise TomboError(
            "Alignment and basecall lengths do not agree")

    norm_signal, scale_values = rsq.normalize_raw_signal(
        raw, rsrtr, int(starts_rel_to_read[-1]), norm_type=norm_type,
        outlier_thresh=outlier_thresh, channel_info=channel_info,
        event_means=ev_means, model_means=model_means,
        model_inv_vars=model_inv_vars)

    indel_groups = get_indel_groups(
        align_vals, starts_rel_to_read, norm_signal, min_obs_per_base,
        running_stat_width, timeout=timeout, num_cpts_limit=num_cpts_limit)

    new_segs = []
    prev_stop = 0
    for group_start, group_end, cpts, _ in indel_groups:
        new_segs.append(np.append(
            starts_rel_to_read[prev_stop:group_start + 1], cpts))
        prev_stop = group_end
    new_segs.append(starts_rel_to_read[prev_stop:])
    new_segs = np.concatenate(new_segs).astype(np.int64)
    if np.diff(new_segs).min() < 1:
        raise TomboError("New segments include zero length events.")
    align_seq = "".join(gb for _, gb in align_vals).replace("-", "")
    if new_segs.shape[0] != len(align_seq) + 1:
        raise TomboError(
            "Aligned sequence does not match number of segments produced.")

    n_ins = sum(1 for _, gb in align_vals if gb == "-")
    n_del = sum(1 for rb, _ in align_vals if rb == "-")
    n_match = sum(1 for rb, gb in align_vals if rb == gb and rb != "-")
    n_mismatch = sum(1 for rb, gb in align_vals
                     if rb != gb and rb != "-" and gb != "-")
    align_info = AlignInfo(
        read_id=read_id, subgroup=basecall_subgroup,
        clip_start=start_clip, clip_end=end_clip,
        insertions=n_ins, deletions=n_del, matches=n_match,
        mismatches=n_mismatch)
    rsqgl_res = ResquiggleResults(
        align_info=align_info, genome_loc=genome_loc, genome_seq=align_seq,
        mean_q_score=None, raw_signal=norm_signal,
        read_start_rel_to_raw=rsrtr, segs=new_segs,
        scale_values=scale_values)
    f5io.prep_fast5(fast5_fn, corr_grp, overwrite, basecall_group)
    f5io.write_new_fast5_group(
        fast5_fn, corr_grp, rsqgl_res, norm_type, compute_sd, rna=rna,
        resolved_params=config.resolved_params_json(
            norm_type=norm_type, outlier_thresh=outlier_thresh,
            seg_params=seg_params, compute_sd=compute_sd,
            pipeline="event_resquiggle"))
    return genome_loc.chrom, ReadData(
        genome_loc.start, genome_loc.start + len(align_seq), False, rsrtr,
        strand, fast5_fn, corr_grp + "/" + basecall_subgroup, rna,
        read_id=read_id)


def _external_command(mapper_exe: str, mapper_type: str, genome_fn: str,
                      reads_fn: str, out_fn: str, align_threads: int,
                      index_fn: Optional[str]):
    """(argv, whether the SAM comes on stdout) of one aligner run, as the
    reference prepares them (reference:
    tombo/_event_resquiggle.py:750-762)."""
    if mapper_type == "graphmap":
        return [mapper_exe, "align", "-r", genome_fn, "-d", reads_fn,
                "-o", out_fn, "-L", "sam", "-t", str(align_threads)], False
    if mapper_type == "bwa_mem":
        return [mapper_exe, "mem", "-x", "ont2d", "-v", "1",
                "-t", str(align_threads), genome_fn, reads_fn], True
    if mapper_type == "minimap2":
        return [mapper_exe, "-ax", "map-ont", "-t", str(align_threads),
                index_fn or genome_fn, reads_fn], True
    raise TomboError("Mapper not supported: " + mapper_type)


def run_external_aligner(fast5_fns, genome_fn: str, mapper_exe: str,
                         mapper_type: str,
                         basecall_group: str = "Basecall_1D_000",
                         basecall_subgroup: str =
                         config.DEFAULT_BASECALL_SUBGROUP,
                         index_fn: Optional[str] = None,
                         batch_size: int = 1000,
                         align_threads: int = 1,
                         num_align_processes: int = 1,
                         out_sam_fn: Optional[str] = None) -> str:
    """Map the reads' basecalls with an external aligner and return the
    path of the merged SAM file (reference:
    tombo/_event_resquiggle.py:750-812 ``align_to_genome``).

    Every read's basecalls are first written, in the main thread, to one
    FASTA file a batch of ``batch_size`` reads (named by read id); only
    then do the aligner runs start, ``num_align_processes`` at a time
    from a thread pool, so no FAST5 file is open while a subprocess is
    spawned (a spawned process would keep the file's HDF5 lock).  One
    header, the first batch's, heads the merged file.  ``mapper_type``
    is ``graphmap``, ``bwa_mem`` or ``minimap2``."""
    import subprocess
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import h5py

    fast5_fns = list(fast5_fns)
    batches = [fast5_fns[i:i + batch_size]
               for i in range(0, len(fast5_fns), batch_size)]
    reads_fns = []
    try:
        for batch in batches:
            n_reads = 0
            with tempfile.NamedTemporaryFile(
                    mode="w", suffix=".fasta", delete=False) as reads_fp:
                reads_fns.append(reads_fp.name)
                for fn in batch:
                    try:
                        with h5py.File(fn, "r") as fp:
                            sd = f5io.get_read_seq(
                                fp, basecall_group, basecall_subgroup,
                                q_score_thresh=None)
                    except (TomboError, OSError, KeyError):
                        continue
                    reads_fp.write(">%s\n%s\n" % (sd.id, sd.seq))
                    n_reads += 1
            if n_reads == 0:
                os.unlink(reads_fns.pop())

        def map_batch(reads_fn):
            with tempfile.NamedTemporaryFile(
                    mode="w+", suffix=".sam", delete=False) as out_fp:
                cmd, to_stdout = _external_command(
                    mapper_exe, mapper_type, genome_fn, reads_fn,
                    out_fp.name, align_threads, index_fn)
                try:
                    rc = subprocess.call(
                        cmd, stdout=out_fp if to_stdout
                        else subprocess.DEVNULL, stderr=subprocess.DEVNULL)
                except OSError as e:
                    os.unlink(out_fp.name)
                    raise TomboError("Problem running genome mapper %r: %s"
                                     % (mapper_exe, e))
                if rc != 0:
                    os.unlink(out_fp.name)
                    raise TomboError(
                        "Genome mapper exited with status %d" % rc)
                out_fp.seek(0)
                lines = out_fp.read().splitlines(True)
            os.unlink(out_fp.name)
            return lines

        with ThreadPoolExecutor(max(1, num_align_processes)) as pool:
            all_lines = list(pool.map(map_batch, reads_fns))
    finally:
        for fn in reads_fns:
            try:
                os.unlink(fn)
            except OSError:
                pass

    if out_sam_fn is None:
        with tempfile.NamedTemporaryFile(suffix=".sam",
                                         delete=False) as fp:
            out_sam_fn = fp.name
    with open(out_sam_fn, "w") as out:
        for i, lines in enumerate(all_lines):
            out.writelines(line for line in lines
                           if i == 0 or not line.startswith("@"))
    return out_sam_fn


def event_resquiggle_all_reads(fast5s_dir: str, aligner,
                               basecall_group: str = "Basecall_1D_000",
                               basecall_subgroup: str =
                               config.DEFAULT_BASECALL_SUBGROUP,
                               corr_grp: str =
                               config.DEFAULT_CORRECTED_GROUP,
                               overwrite: bool = True,
                               num_threads: int = 4,
                               skip_index: bool = False,
                               norm_type: str = "median",
                               pore_model_fn: Optional[str] = None,
                               sam_fn: Optional[str] = None,
                               fasta=None,
                               genome_fn: Optional[str] = None,
                               mapper_exe: Optional[str] = None,
                               mapper_type: Optional[str] = None,
                               minimap2_index: Optional[str] = None,
                               alignment_batch_size: int = 1000,
                               align_processes: int = 1,
                               align_threads_per_process: int = 1,
                               timeout: Optional[float] = None,
                               num_cpts_limit: Optional[int] = None):
    """Event re-squiggle of every FAST5 under ``fast5s_dir`` on
    ``num_threads`` threads (reference:
    tombo/_event_resquiggle.py:1103-1218).  Returns (succeeded, failed,
    {failure message: count}).

    ``sam_fn`` (SAM with ``fasta``, or ``.m5``) gives the alignments,
    keyed by read id or else by the FAST5 basename; ``mapper_exe`` and
    ``mapper_type`` (graphmap, bwa_mem or minimap2) run the external
    aligner first, before any reader thread opens a FAST5.  Otherwise
    ``aligner`` maps each read in process."""
    from concurrent.futures import ThreadPoolExecutor

    import h5py

    reads_index = None if skip_index else ReadsIndex(
        [fast5s_dir], corrected_group=corr_grp, for_writing=True)
    pore_model = (parse_pore_model_file(pore_model_fn)
                  if pore_model_fn else None)
    if mapper_exe is not None and sam_fn is None:
        if genome_fn is None:
            raise TomboError(
                "External-aligner event re-squiggle requires the genome "
                "FASTA path")
        sam_fn = run_external_aligner(
            f5io.iter_fast5_reads(fast5s_dir), genome_fn, mapper_exe,
            mapper_type, basecall_group, basecall_subgroup,
            index_fn=minimap2_index, batch_size=alignment_batch_size,
            align_threads=align_threads_per_process,
            num_align_processes=align_processes)
    sam_alignments = None
    if sam_fn is not None:
        if sam_fn.endswith(".m5"):
            sam_alignments = parse_m5_file(sam_fn)
        else:
            if fasta is None:
                raise TomboError(
                    "SAM-based event re-squiggle requires the reference "
                    "FASTA")
            sam_alignments = parse_sam_file(sam_fn, fasta)

    def one(fn):
        try:
            alignment = None
            if sam_alignments is not None:
                with h5py.File(fn, "r") as fp:
                    rid = f5io.get_read_id(fp)
                alignment = sam_alignments.get(rid)
                if alignment is None:
                    alignment = sam_alignments.get(
                        os.path.splitext(os.path.basename(fn))[0])
                if alignment is None:
                    raise TomboError("Alignment not produced")
            return event_resquiggle_read(
                fn, aligner, basecall_group, basecall_subgroup, corr_grp,
                overwrite=overwrite, norm_type=norm_type,
                pore_model=pore_model, alignment=alignment,
                timeout=timeout, num_cpts_limit=num_cpts_limit)
        except TomboError as e:
            return str(e)

    n_ok = n_fail = 0
    fails = {}
    with ThreadPoolExecutor(num_threads) as pool:
        for out in pool.map(one, f5io.iter_fast5_reads(fast5s_dir)):
            if isinstance(out, str):
                n_fail += 1
                fails[out] = fails.get(out, 0) + 1
            else:
                chrm, rd = out
                n_ok += 1
                if reads_index is not None:
                    reads_index.add_read_data(chrm, rd.strand, rd)
    if reads_index is not None and n_ok:
        reads_index.write_index_file()
    return n_ok, n_fail, fails
