"""Reversible read filters of the index (copy of ``tombo_tpu/filters.py``;
reference: tombo/_filter_reads.py:29-342).

Each filter sets the ``filtered`` flag of index records and rewrites the
directory's index; no FAST5 is changed, and ``clear_filters`` undoes
them all: observations per base (``stuck``), even coverage, mean q-score,
signal matching score and genome position.  ``parse_obs_filter`` also
serves the re-squiggle runner as it builds the index.  ``h5py`` is
imported inside the filters that open a FAST5 file."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .errors import TomboError
from .io.index import ReadsIndex
from .seq import get_mean_q_score


def _print_filter_mess(num_filt, prev_unfilt, total, fast5s_dir, text,
                       quiet=False):
    if prev_unfilt == 0:
        raise TomboError(
            "No unfiltered reads present in current Tombo index.")
    if not quiet:
        print("Filtered {:d} reads ({:.1%} of previously unfiltered and "
              "{:.1%} of all valid reads) due to {} filter from {}.".format(
                  num_filt, num_filt / prev_unfilt, num_filt / total,
                  text, fast5s_dir))


def _all_reads(fast5s_dir: str, corr_grp: str) -> ReadsIndex:
    return ReadsIndex([fast5s_dir], corr_grp, remove_filtered=False)


def clear_filters(fast5s_dir: str, corr_grp: str):
    """Unmark every read (reference: tombo/_filter_reads.py:29-42)."""
    reads_index = _all_reads(fast5s_dir, corr_grp)
    reads_index.replace_index({
        cs: [dataclasses.replace(rd, filtered=False) for rd in cs_reads]
        for cs, cs_reads in reads_index})
    reads_index.write_index_file()


def _apply_read_filter(fast5s_dir, corr_grp, read_fails, filter_text,
                       quiet=False):
    """Mark the unfiltered reads for which ``read_fails`` is true."""
    reads_index = _all_reads(fast5s_dir, corr_grp)
    filt_index = {}
    num_filt = prev_unfilt = total = 0
    for cs, cs_reads in reads_index:
        out = []
        for rd in cs_reads:
            total += 1
            if not rd.filtered:
                prev_unfilt += 1
                if read_fails(rd):
                    num_filt += 1
                    rd = dataclasses.replace(rd, filtered=True)
            out.append(rd)
        filt_index[cs] = out
    _print_filter_mess(num_filt, prev_unfilt, total, fast5s_dir,
                       filter_text, quiet)
    reads_index.replace_index(filt_index)
    reads_index.write_index_file()


def filter_reads_for_stuck(fast5s_dir: str, corr_grp: str,
                           obs_filter: Sequence[Tuple[int, float]],
                           quiet=False):
    """Mark reads where a percentile of the observations per base passes
    its threshold, and unreadable reads (reference:
    tombo/_filter_reads.py:58-97)."""
    import h5py

    def read_is_stuck(rd):
        try:
            with h5py.File(rd.fn, "r") as fp:
                base_lens = fp["/Analyses/" + rd.corr_group + "/Events"][
                    "length"][:]
        except (OSError, KeyError, ValueError):
            return True
        return any(np.percentile(base_lens, pctl) > thresh
                   for pctl, thresh in obs_filter)

    _apply_read_filter(fast5s_dir, corr_grp, read_is_stuck,
                       "observations per base", quiet)


def filter_reads_for_coverage(fast5s_dir: str, corr_grp: str,
                              frac_to_filter: float, quiet=False,
                              rng: Optional[np.random.Generator] = None):
    """Mark a random ``frac_to_filter`` of the unfiltered reads, each
    drawn with a weight of the coverage at its middle, so deep regions
    lose the most (reference: tombo/_filter_reads.py:99-155).  ``rng``:
    the generator of the draw (a fresh unseeded one when None); a seeded
    generator gives the JAX package's draw."""
    reads_index = _all_reads(fast5s_dir, corr_grp)
    filt_index: Dict[Tuple[str, str], list] = {
        cs: [] for cs in reads_index.get_all_cs()}
    unfilt_reads, unfilt_cov = [], []
    total = 0
    for cs, cs_reads in reads_index:
        cov = np.zeros(max(rd.end for rd in cs_reads), np.int64)
        for rd in cs_reads:
            total += 1
            if rd.filtered:
                filt_index[cs].append(rd)
            cov[rd.start:rd.end] += 1
        for rd in cs_reads:
            if rd.filtered:
                continue
            unfilt_cov.append(cov[rd.start + (rd.end - rd.start) // 2])
            unfilt_reads.append((cs, rd))
    prev_unfilt = len(unfilt_reads)
    if prev_unfilt == 0:
        raise TomboError(
            "No unfiltered reads present in current Tombo index.")
    num_filt = int(frac_to_filter * prev_unfilt)
    _print_filter_mess(num_filt, prev_unfilt, total, fast5s_dir,
                       "even coverage", quiet)
    cov_arr = np.array(unfilt_cov, np.float64)
    if rng is None:
        rng = np.random.default_rng()
    filt_indices = set(rng.choice(prev_unfilt, size=num_filt,
                                  replace=False, p=cov_arr / cov_arr.sum()))
    for i, (cs, rd) in enumerate(unfilt_reads):
        if i in filt_indices:
            rd = dataclasses.replace(rd, filtered=True)
        filt_index[cs].append(rd)
    reads_index.replace_index(filt_index)
    reads_index.write_index_file()


def filter_reads_for_qscore(fast5s_dir: str, bc_grp: str, corr_grp: str,
                            q_score_thresh: float, quiet=False):
    """Mark reads whose mean basecall q-score (the index's, else the
    FAST5 basecall's) is below the threshold, and unreadable reads
    (reference: tombo/_filter_reads.py:157-194)."""
    import h5py

    def read_fails(rd):
        if rd.mean_q_score is not None:
            return rd.mean_q_score < q_score_thresh
        try:
            with h5py.File(rd.fn, "r") as fp:
                fastq = fp["/Analyses/" + bc_grp + "/" +
                           rd.corr_group.split("/")[-1] + "/Fastq"][()]
        except (OSError, KeyError, ValueError):
            return True
        if isinstance(fastq, bytes):
            fastq = fastq.decode()
        lines = fastq.split("\n")
        return len(lines) < 4 or get_mean_q_score(lines[3]) < q_score_thresh

    _apply_read_filter(fast5s_dir, corr_grp, read_fails, "q-score", quiet)


def filter_reads_for_signal_matching(fast5s_dir: str, corr_grp: str,
                                     sig_match_thresh: float, quiet=False):
    """Mark reads whose signal matching score (the index's, else the
    corrected group's) passes the threshold, and unreadable reads
    (reference: tombo/_filter_reads.py:196-236)."""
    import h5py

    def read_fails(rd):
        if rd.sig_match_score is not None:
            return rd.sig_match_score > sig_match_thresh
        try:
            with h5py.File(rd.fn, "r") as fp:
                return fp["/Analyses/" + rd.corr_group].attrs[
                    "signal_match_score"] > sig_match_thresh
        except (OSError, KeyError, ValueError):
            return True

    _apply_read_filter(fast5s_dir, corr_grp, read_fails, "signal matching",
                       quiet)


def filter_reads_for_genome_pos(fast5s_dir: str, corr_grp: str,
                                include_regs: Dict[str, Optional[List[
                                    Tuple[int, int]]]],
                                include_partial: bool = False, quiet=False):
    """Mark reads outside ``include_regs`` ({chrm: None (all of it) or
    [(start, end)]}; a read must lie inside an interval, or overlap one
    with ``include_partial``) (reference: tombo/_filter_reads.py:238-280).
    """
    def read_included(rd, chrm_regs):
        if chrm_regs is None:
            return True
        if include_partial:
            return any(not (rd.start > e or rd.end < s)
                       for s, e in chrm_regs)
        return any(rd.start >= s and rd.end <= e for s, e in chrm_regs)

    reads_index = _all_reads(fast5s_dir, corr_grp)
    filt_index: Dict[Tuple[str, str], list] = {
        cs: [] for cs in reads_index.get_all_cs()}
    num_filt = prev_unfilt = total = 0
    for (chrm, strand), cs_reads in reads_index:
        cs_excluded = chrm not in include_regs
        for rd in cs_reads:
            total += 1
            if rd.filtered:
                filt_index[(chrm, strand)].append(rd)
                continue
            prev_unfilt += 1
            if cs_excluded or not read_included(rd, include_regs[chrm]):
                num_filt += 1
                rd = dataclasses.replace(rd, filtered=True)
            filt_index[(chrm, strand)].append(rd)
    _print_filter_mess(num_filt, prev_unfilt, total, fast5s_dir,
                       "genomic position", quiet)
    reads_index.replace_index(filt_index)
    reads_index.write_index_file()


def parse_obs_filter(obs_filter: Sequence[str]) -> List[Tuple[int, int]]:
    """``pctl:thresh`` pairs: a read is filtered when the given percentile
    of its observations per base exceeds the threshold (reference:
    tombo/tombo_helper.py ``parse_obs_filter``)."""
    if not obs_filter:
        return []
    try:
        return [(int(p), int(t)) for p, t in
                (of.split(":") for of in obs_filter)]
    except ValueError:
        raise TomboError("Invalid format for observation filter")


def parse_genome_regions(all_regs: Sequence[str]
                         ) -> Dict[str, Optional[List[Tuple[int, int]]]]:
    """``chrm`` (the whole chromosome) or ``chrm:start-end`` strings (commas
    allowed in the numbers) as {chrm: None or [(start, end)]}; a
    malformed string raises ValueError (reference:
    tombo/tombo_helper.py ``parse_genome_regions``)."""
    include_regs: Dict[str, Optional[List[Tuple[int, int]]]] = {}
    for reg in all_regs:
        if ":" in reg:
            chrm, pos = reg.split(":")
            start, end = (int(x.replace(",", "")) for x in pos.split("-"))
            if include_regs.get(chrm, []) is None:
                continue
            include_regs.setdefault(chrm, []).append((start, end))
        else:
            include_regs[reg] = None
    return include_regs
