"""Wiggle, bedGraph and FASTA text output (copy of
``tombo_tpu/output/text.py``; reference:
tombo/_text_output_commands.py:64-427): the same track headers, file
names, variableStep blocks and per-type semantics (coverage, signal,
signal_sd, dwell, difference, fraction, dampened_fraction, statistic,
valid_coverage), and the FASTA of the most significant regions.  The
statistics files are read through ``stats/files.py``; ``h5py`` is
imported inside the function that reads a FAST5 slot."""
from __future__ import annotations

import io
from typing import Dict

import numpy as np

from ..errors import TomboError
from ..seq import TomboMotif, rev_comp
from ..stats.files import LEVEL_STATS_TXTS, LevelStats, ModelStats

OUT_HEADER = ('track type={0} name="{1}_{2}_{3}{4}" '
              'description="{1} {2} {3}{5}"\n')
BG_TYPE = "bedgraph"
WIG_TYPE = "wig"
OUT_TYPES = {WIG_TYPE: "wiggle_0", BG_TYPE: "bedGraph"}
GROUP_NAME = "sample"
CTRL_NAME = "control"

COV_WIG_TYPE = "coverage"
SIG_SLOT = "norm_mean"
SD_SLOT = "norm_stdev"
DWELL_SLOT = "length"
SIG_WIG_TYPE = "signal"
DIFF_WIG_TYPE = "difference"
SD_WIG_TYPE = "signal_sd"
DWELL_WIG_TYPE = "dwell"
FRAC_WIG_TYPE = "fraction"
DFRAC_WIG_TYPE = "dampened_fraction"
STAT_WIG_TYPE = "statistic"
VCOV_WIG_TYPE = "valid_coverage"
FRAC_WIG_NAME = "fraction_modified_reads"
DFRAC_WIG_NAME = "dampened_fraction_modified_reads"
STAT_WIG_NAME = "statistic"
VCOV_WIG_NAME = "valid_coverage"

ALL_WIG_TYPES = (COV_WIG_TYPE, SIG_WIG_TYPE, SD_WIG_TYPE, DWELL_WIG_TYPE,
                 DIFF_WIG_TYPE, FRAC_WIG_TYPE, DFRAC_WIG_TYPE,
                 STAT_WIG_TYPE, VCOV_WIG_TYPE)


def parse_motif_descs(stat_motif_descs: str):
    """Parse ``motif:mod_pos:name[::...]`` motif descriptions
    (reference: tombo/tombo_helper.py:710-728)."""
    parsed = []
    try:
        for desc in stat_motif_descs.split("::"):
            raw_motif, mod_pos, mod_name = desc.split(":")
            parsed.append((TomboMotif(raw_motif, int(mod_pos)), mod_name))
    except (ValueError, IndexError, TomboError):
        raise TomboError(
            "Invalid motif decriptions format. Format descriptions as: "
            '"motif:mod_pos:name[::motif2:mod_pos2:name2...]".')
    return parsed


def get_chrm_sizes(reads_index, ctrl_reads_index=None) -> Dict[str, int]:
    """Chromosome sizes as the maximum covered position
    (reference: tombo/tombo_helper.py:1586-1600)."""
    sizes: Dict[str, int] = {}
    for idx in (reads_index, ctrl_reads_index):
        if idx is None:
            continue
        for (chrm, _strand), reads in idx.reads_index.items():
            if not reads:
                continue
            m = max(r.end for r in reads)
            sizes[chrm] = max(sizes.get(chrm, 0), m)
    return sizes


def _get_single_slot_genome_centric(r_data, slot_name):
    """One read's corrected-group Events slot in genome order, float64;
    None where the file or slot cannot be read."""
    import h5py
    try:
        with h5py.File(r_data.fn, "r") as fp:
            vals = fp["/Analyses/" + r_data.corr_group + "/Events"][
                slot_name][:]
    except (OSError, KeyError):
        return None
    if r_data.strand == "-":
        vals = vals[::-1]
    return vals.astype(np.float64)


def get_mean_slot_genome_centric(cs_reads, chrm_len, slot_name):
    """(reference: tombo/tombo_helper.py:1661-1676)."""
    base_sums = np.zeros(chrm_len)
    base_cov = np.zeros(chrm_len, np.int64)
    for r_data in cs_reads:
        vals = _get_single_slot_genome_centric(r_data, slot_name)
        if vals is None:
            continue
        base_sums[r_data.start:r_data.start + len(vals)] += vals
        base_cov[r_data.start:r_data.start + len(vals)] += 1
    with np.errstate(all="ignore"):
        return base_sums / base_cov


def iter_mean_slot_values(reads_index, chrm_sizes, slot_name,
                          ctrl_reads_index=None):
    """(reference: tombo/tombo_helper.py:1678-1712)."""
    for chrm in sorted(chrm_sizes):
        for strand in ("+", "-"):
            if ctrl_reads_index is None:
                if (chrm, strand) not in reads_index:
                    continue
                yield chrm, strand, get_mean_slot_genome_centric(
                    reads_index.get_cs_reads(chrm, strand),
                    chrm_sizes[chrm], slot_name), None
            else:
                cs_vals = ctrl_vals = None
                if (chrm, strand) in reads_index:
                    cs_vals = get_mean_slot_genome_centric(
                        reads_index.get_cs_reads(chrm, strand),
                        chrm_sizes[chrm], slot_name)
                if (chrm, strand) in ctrl_reads_index:
                    ctrl_vals = get_mean_slot_genome_centric(
                        ctrl_reads_index.get_cs_reads(chrm, strand),
                        chrm_sizes[chrm], slot_name)
                if cs_vals is None and ctrl_vals is None:
                    continue
                yield chrm, strand, cs_vals, ctrl_vals


def open_browser_files(wig_base, group_text, type_name, out_type=WIG_TYPE):
    """(reference: tombo/_text_output_commands.py:64-81)."""
    g_dot = "" if group_text == "" else "." + group_text
    g_us = "" if group_text == "" else "_" + group_text
    g_sp = "" if group_text == "" else " " + group_text
    plus_fp = io.open(
        wig_base + "." + type_name + g_dot + ".plus." + out_type, "wt")
    minus_fp = io.open(
        wig_base + "." + type_name + g_dot + ".minus." + out_type, "wt")
    plus_fp.write(OUT_HEADER.format(
        OUT_TYPES[out_type], wig_base, type_name, "fwd_strand", g_us, g_sp))
    minus_fp.write(OUT_HEADER.format(
        OUT_TYPES[out_type], wig_base, type_name, "rev_strand", g_us, g_sp))
    return plus_fp, minus_fp


def _write_cs_data(fp, chrm, poss, vals):
    fp.write("variableStep chrom={} span=1\n".format(chrm))
    fp.write("\n".join("{:d} {:.4f}".format(int(p) + 1, v)
                       for p, v in zip(poss, vals)) + "\n")


def _write_cs_int_data(fp, chrm, poss, vals):
    fp.write("variableStep chrom={} span=1\n".format(chrm))
    fp.write("\n".join("{:d} {:d}".format(int(p) + 1, int(v))
                       for p, v in zip(poss, vals)) + "\n")


def _filter_cs_nans(vals):
    poss = np.where(~np.isnan(vals))[0]
    return poss, vals[poss]


def write_cov_wig(reads_index, out_base, group_text):
    """(reference: tombo/_text_output_commands.py:300-321)."""
    plus_fp, minus_fp = open_browser_files(
        out_base, group_text, COV_WIG_TYPE, BG_TYPE)
    for chrm, strand, cs_cov, cs_cov_starts in \
            reads_index.iter_coverage_regions():
        fp = plus_fp if strand == "+" else minus_fp
        fp.write("\n".join(
            "\t".join((chrm, str(int(cs_cov_starts[i])),
                       str(int(cs_cov_starts[i + 1])), str(int(cs_cov[i]))))
            for i in range(len(cs_cov))) + "\n")
    plus_fp.close()
    minus_fp.close()


def write_slot_mean_wig(reads_index, chrm_sizes, wig_base, group_name,
                        wig_type, slot_name):
    """(reference: tombo/_text_output_commands.py:235-249)."""
    plus_fp, minus_fp = open_browser_files(wig_base, group_name, wig_type)
    for chrm, strand, cs_vals, _ in iter_mean_slot_values(
            reads_index, chrm_sizes, slot_name):
        fp = plus_fp if strand == "+" else minus_fp
        poss, vals = _filter_cs_nans(cs_vals)
        _write_cs_data(fp, chrm, poss, vals)
    plus_fp.close()
    minus_fp.close()


def write_signal_and_diff_wigs(reads_index, ctrl_reads_index, chrm_sizes,
                               wig_base, group_name, write_sig, write_diff):
    """(reference: tombo/_text_output_commands.py:251-299)."""
    opened = []
    if write_sig:
        plus1, minus1 = open_browser_files(wig_base, group_name,
                                           SIG_WIG_TYPE)
        opened += [plus1, minus1]
        if ctrl_reads_index is not None:
            plus2, minus2 = open_browser_files(wig_base, CTRL_NAME,
                                               SIG_WIG_TYPE)
            opened += [plus2, minus2]
    if write_diff:
        plusd, minusd = open_browser_files(wig_base, "", DIFF_WIG_TYPE)
        opened += [plusd, minusd]

    for chrm, strand, cs1, cs2 in iter_mean_slot_values(
            reads_index, chrm_sizes, SIG_SLOT, ctrl_reads_index):
        if cs1 is not None:
            poss1, means1 = _filter_cs_nans(cs1)
            if write_sig:
                _write_cs_data(plus1 if strand == "+" else minus1,
                               chrm, poss1, means1)
        if cs2 is not None:
            poss2, means2 = _filter_cs_nans(cs2)
            if write_sig:
                _write_cs_data(plus2 if strand == "+" else minus2,
                               chrm, poss2, means2)
            if cs1 is not None and write_diff:
                both = np.intersect1d(poss1, poss2, assume_unique=True)
                _write_cs_data(plusd if strand == "+" else minusd,
                               chrm, both, cs1[both] - cs2[both])
    for fp in opened:
        fp.close()


def write_frac_wigs(all_stats, wig_base, do_frac, do_damp, do_stats,
                    do_vcov, fasta=None, motif_descs=None):
    """(reference: tombo/_text_output_commands.py:95-232)."""
    filter_motifs = fasta is not None and motif_descs is not None
    motifs = (parse_motif_descs("::".join(motif_descs)) if filter_motifs
              else [(None, "")])

    def open_set(type_name):
        return dict(
            kv for _, mod_name in motifs
            for kv in zip((("+", mod_name), ("-", mod_name)),
                          open_browser_files(wig_base, mod_name, type_name)))

    frac_fps = open_set(FRAC_WIG_NAME) if do_frac else None
    damp_fps = open_set(DFRAC_WIG_NAME) if do_damp else None
    stat_fps = open_set(STAT_WIG_NAME) if do_stats else None
    vcov_fps = open_set(VCOV_WIG_NAME) if do_vcov else None

    def write_cs(chrm, strand, poss, fracs, dampf, statv, vcov):
        poss = np.concatenate(poss)
        fracs = np.concatenate(fracs) if do_frac else None
        dampf = np.concatenate(dampf) if do_damp else None
        statv = np.concatenate(statv) if do_stats else None
        vcov = np.concatenate(vcov) if do_vcov else None
        chrm_seq = fasta.get_seq(chrm) if filter_motifs else None
        for motif, mod_name in motifs:
            m_poss, m_fracs, m_damp, m_stat, m_vcov = (
                poss, fracs, dampf, statv, vcov)
            if filter_motifs:
                if strand == "-":
                    motif_poss = np.array([
                        m.start() + motif.motif_len - motif.mod_pos
                        for m in motif.rev_comp_pat.finditer(chrm_seq)])
                else:
                    motif_poss = np.array([
                        m.start() + motif.mod_pos - 1
                        for m in motif.motif_pat.finditer(chrm_seq)])
                sel = np.isin(poss, motif_poss, assume_unique=True)
                m_poss = poss[sel]
                if do_frac:
                    m_fracs = fracs[sel]
                if do_damp:
                    m_damp = dampf[sel]
                if do_stats:
                    m_stat = statv[sel]
                if do_vcov:
                    m_vcov = vcov[sel]
            if do_frac:
                _write_cs_data(frac_fps[(strand, mod_name)], chrm, m_poss,
                               m_fracs)
            if do_damp:
                _write_cs_data(damp_fps[(strand, mod_name)], chrm, m_poss,
                               m_damp)
            if do_stats:
                _write_cs_data(stat_fps[(strand, mod_name)], chrm, m_poss,
                               m_stat)
            if do_vcov:
                _write_cs_int_data(vcov_fps[(strand, mod_name)], chrm,
                                   m_poss, m_vcov)

    curr = (None, None)
    poss, fracs, dampf, statv, vcov = [], [], [], [], []
    for chrm, strand, start, end, block_stats in all_stats:
        if (chrm, strand) != curr:
            if poss:
                write_cs(curr[0], curr[1], poss, fracs, dampf, statv, vcov)
            curr = (chrm, strand)
            poss, fracs, dampf, statv, vcov = [], [], [], [], []
        poss.append(block_stats["pos"])
        if do_frac:
            fracs.append(1 - block_stats["frac"])
        if do_damp:
            dampf.append(1 - block_stats["damp_frac"])
        if do_stats:
            statv.append(all_stats._stat_transform(block_stats))
        if do_vcov:
            vcov.append(block_stats["valid_cov"])
    if poss:
        write_cs(curr[0], curr[1], poss, fracs, dampf, statv, vcov)

    for fps in (frac_fps, damp_fps, stat_fps, vcov_fps):
        if fps:
            for fp in fps.values():
                fp.close()


def load_stats_file(stats_fn):
    """Open a stats file as ModelStats or LevelStats by content."""
    try:
        return ModelStats(stats_fn)
    except TomboError:
        return LevelStats(stats_fn)


def write_all_browser_files(reads_index, ctrl_reads_index, stats_fn,
                            wig_base, wig_types, motif_descs=None,
                            fasta=None):
    """(reference: tombo/_text_output_commands.py:322-390)."""
    group_name = "" if ctrl_reads_index is None else GROUP_NAME
    chrm_sizes = None
    if reads_index is not None:
        chrm_sizes = get_chrm_sizes(reads_index, ctrl_reads_index)
    if ctrl_reads_index is not None:
        if COV_WIG_TYPE in wig_types:
            write_cov_wig(ctrl_reads_index, wig_base, CTRL_NAME)
        if SD_WIG_TYPE in wig_types:
            write_slot_mean_wig(ctrl_reads_index, chrm_sizes, wig_base,
                                CTRL_NAME, SD_WIG_TYPE, SD_SLOT)
        if DWELL_WIG_TYPE in wig_types:
            write_slot_mean_wig(ctrl_reads_index, chrm_sizes, wig_base,
                                CTRL_NAME, DWELL_WIG_TYPE, DWELL_SLOT)
        if SIG_WIG_TYPE in wig_types or DIFF_WIG_TYPE in wig_types:
            write_signal_and_diff_wigs(
                reads_index, ctrl_reads_index, chrm_sizes, wig_base,
                group_name, SIG_WIG_TYPE in wig_types,
                DIFF_WIG_TYPE in wig_types)
    elif reads_index is not None:
        if SIG_WIG_TYPE in wig_types:
            write_signal_and_diff_wigs(
                reads_index, None, chrm_sizes, wig_base, group_name,
                True, False)
    if reads_index is not None:
        if COV_WIG_TYPE in wig_types:
            write_cov_wig(reads_index, wig_base, group_name)
        if SD_WIG_TYPE in wig_types:
            write_slot_mean_wig(reads_index, chrm_sizes, wig_base,
                                group_name, SD_WIG_TYPE, SD_SLOT)
        if DWELL_WIG_TYPE in wig_types:
            write_slot_mean_wig(reads_index, chrm_sizes, wig_base,
                                group_name, DWELL_WIG_TYPE, DWELL_SLOT)
    if any(t in wig_types for t in (FRAC_WIG_TYPE, DFRAC_WIG_TYPE,
                                    STAT_WIG_TYPE, VCOV_WIG_TYPE)):
        all_stats = load_stats_file(stats_fn)
        is_model = all_stats.stat_type not in LEVEL_STATS_TXTS
        if not is_model and any((FRAC_WIG_TYPE in wig_types,
                                 DFRAC_WIG_TYPE in wig_types,
                                 VCOV_WIG_TYPE in wig_types)):
            raise TomboError(
                "Cannot output --file-type fraction, dampened_fraction or "
                "valid_coverage for level sample compare statistics.")
        if is_model and STAT_WIG_TYPE in wig_types:
            raise TomboError(
                "Cannot output `--file-type statistic` for aggregated "
                "per-read statistics.")
        write_frac_wigs(all_stats, wig_base, FRAC_WIG_TYPE in wig_types,
                        DFRAC_WIG_TYPE in wig_types,
                        STAT_WIG_TYPE in wig_types,
                        VCOV_WIG_TYPE in wig_types, fasta, motif_descs)


def write_most_signif(stats_fn, seqs_fn, num_regions, num_bases, fasta):
    """FASTA of the most significant regions
    (reference: tombo/_text_output_commands.py:393-427)."""
    all_stats = load_stats_file(stats_fn)
    regions = all_stats.get_most_signif_regions(
        num_bases, num_regions, prepend_loc_to_text=True)
    with io.open(seqs_fn, "wt") as fp:
        for chrm, start, end, strand, _reg_id, reg_text in regions:
            seq = fasta.get_seq(chrm, start, end, error_end=False)
            if strand == "-":
                seq = rev_comp(seq)
            fp.write(">{0}\n{1}\n".format(reg_text, seq))
