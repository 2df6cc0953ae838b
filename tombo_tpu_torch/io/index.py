"""Reads index: per-(chrm, strand) read records with coverage queries
(copy of ``tombo_tpu/io/index.py:33-315``).

It reads and writes the hidden pickle index
``.<dir>.<corr_grp>.tombo.index`` of a re-squiggle run (the reference's
11-field record layout, pickle protocol 2, reference:
tombo/tombo_helper.py:1093-1586), falls back to scanning the FAST5
corrected groups when the index is missing or corrupt, and builds in
memory from re-squiggle results (``add_read_data``), the card's route,
which writes no file."""
from __future__ import annotations

import glob
import io
import os
import pickle
import re
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..config import DEFAULT_CORRECTED_GROUP
from ..errors import TomboError
from ..types import ReadData
from . import fast5 as f5io


def get_index_fn(fast5s_dir: str, corr_grp: str) -> str:
    if fast5s_dir.endswith("/"):
        fast5s_dir = fast5s_dir[:-1]
    head, tail = os.path.split(fast5s_dir)
    return os.path.join(head, "." + tail + "." + corr_grp + ".tombo.index")


class ReadsIndex:
    """Per-(chrm, strand) lists of :class:`ReadData` with lazy coverage;
    filtered reads are left out unless asked for.  With no directories it
    starts empty, for ``add_read_data``."""

    def __init__(self, fast5s_basedirs: Optional[List[str]] = None,
                 corrected_group: str = DEFAULT_CORRECTED_GROUP,
                 basecall_subgroups: Optional[List[str]] = None,
                 for_writing: bool = False, remove_filtered: bool = True):
        """``basecall_subgroups``: keep only reads of these subgroups.
        ``for_writing``: start empty for one directory (given alone),
        whose old index file is removed; ``write_index_file`` writes the
        new one.  ``remove_filtered`` false keeps the reads the filters
        marked (the filters read and rewrite every record)."""
        self.fast5s_dirs: Dict[str, str] = {}
        self.corr_grp = corrected_group
        self.bc_subgrps = basecall_subgroups
        self.remove_filtered = remove_filtered
        self.coverage: Optional[Dict[Tuple[str, str], np.ndarray]] = None
        self.reads_index: Dict[Tuple[str, str], List[ReadData]] = \
            defaultdict(list)
        if for_writing:
            if len(fast5s_basedirs or []) != 1:
                raise ValueError("an index for writing takes one FAST5 "
                                 "base directory")
            d = fast5s_basedirs[0]
            d = d if d.endswith("/") else d + "/"
            self.fast5s_dirs[d] = get_index_fn(d, self.corr_grp)
            if os.path.exists(self.fast5s_dirs[d]):
                os.remove(self.fast5s_dirs[d])
        elif fast5s_basedirs:
            self._parse_fast5s(fast5s_basedirs)

    # ------------------------------------------------------------ building
    def add_read_data(self, chrm: str, strand: str, read_data: ReadData):
        self.reads_index[(chrm, strand)].append(read_data)
        self.coverage = None

    def replace_index(self, new_reads_index):
        if sum(len(x) for x in new_reads_index.values()) == 0:
            raise TomboError("Cannot replace with an empty index.")
        self.reads_index = defaultdict(list, new_reads_index)
        self.coverage = None

    def write_index_file(self, shard_suffix: str = ""):
        """Write the pickle index of the one directory, in the reference's
        record layout (reference: tombo/tombo_helper.py:1149-1185).
        ``shard_suffix`` (``.host<i>``) names one host's shard of a
        multi-host run; readers merge ``<index>.host*``."""
        if len(self.fast5s_dirs) != 1:
            raise ValueError("an index file is written for one directory")
        basedir, index_fn = next(iter(self.fast5s_dirs.items()))
        index_data = defaultdict(list)
        for chrm_strand, cs_reads in self.reads_index.items():
            for rd in cs_reads:
                index_data[chrm_strand].append((
                    re.sub(re.escape(basedir), "", rd.fn, 1), rd.start,
                    rd.end, rd.read_start_rel_to_raw,
                    rd.corr_group.split("/")[0],
                    rd.corr_group.split("/")[-1], rd.filtered, rd.rna,
                    rd.sig_match_score, rd.mean_q_score, rd.read_id))
        with io.open(index_fn + shard_suffix, "wb") as fp:
            pickle.dump(dict(index_data), fp, protocol=2)

    # ------------------------------------------------------------- parsing
    def _load_index_data(self, fast5s_dir: str, index_fn: str):
        """Parse the pickle index, accepting the reference's 8/10/11-field
        record layouts (reference: tombo/tombo_helper.py:1235-1283)."""
        with io.open(index_fn, "rb") as fp:
            raw = pickle.load(fp)
        try:
            n_vals = len(next(iter(raw.values()))[0])
        except StopIteration:
            raise TomboError("Tombo index file appears to be empty")
        if n_vals not in (8, 10, 11):
            raise TomboError("Invalid Tombo index file.")
        out = {}
        for (chrm, strand), cs_raw in raw.items():
            cs_data = []
            for rec in cs_raw:
                (from_base_fn, start, end, rsrtr, _c_grp, s_grp, filtered,
                 rna) = rec[:8]
                cs_data.append(ReadData(
                    start, end, filtered, rsrtr, strand,
                    os.path.join(fast5s_dir, from_base_fn),
                    self.corr_grp + "/" + s_grp, rna,
                    rec[8] if n_vals >= 10 else None,
                    rec[9] if n_vals >= 10 else None,
                    rec[10] if n_vals >= 11 else None))
            if cs_data:
                out[(chrm, strand)] = cs_data
        return out

    def _parse_fast5s_wo_index(self, dirs: List[str]):
        """Scan the corrected groups directly (missing or corrupt index;
        reference: tombo/tombo_helper.py:1189-1233)."""
        import h5py
        out = defaultdict(list)
        for d in dirs:
            for read_fn in f5io.iter_fast5_reads(d):
                try:
                    with h5py.File(read_fn, "r") as fast5_data:
                        subgrps = (
                            list(fast5_data["/Analyses/" + self.corr_grp])
                            if self.bc_subgrps is None else self.bc_subgrps)
                        for bc_subgrp in subgrps:
                            corr = fast5_data["/Analyses/" + self.corr_grp +
                                              "/" + bc_subgrp]
                            if "Events" not in corr:
                                continue
                            align = dict(corr["Alignment"].attrs.items())
                            chrm = align["mapped_chrom"]
                            strand = align["mapped_strand"]
                            if isinstance(chrm, bytes):
                                chrm = chrm.decode()
                            if isinstance(strand, bytes):
                                strand = strand.decode()
                            out[(chrm, strand)].append(ReadData(
                                align["mapped_start"], align["mapped_end"],
                                False,
                                corr["Events"].attrs["read_start_rel_to_raw"],
                                strand, read_fn,
                                self.corr_grp + "/" + bc_subgrp,
                                bool(corr.attrs.get("rna", False)),
                                read_id=f5io.get_read_id(fast5_data)))
                except (OSError, KeyError, TomboError):
                    continue
        return dict(out)

    def _parse_fast5s(self, fast5s_basedirs: List[str]):
        wo_index_dirs = []
        merged = defaultdict(list)
        for d in fast5s_basedirs:
            d = d if d.endswith("/") else d + "/"
            self.fast5s_dirs[d] = get_index_fn(d, self.corr_grp)
            # a single-host run writes the plain index, a multi-host one
            # per-host ``.host<i>`` shards: merge whichever exist
            index_fns = ([self.fast5s_dirs[d]]
                         if os.path.exists(self.fast5s_dirs[d]) else [])
            index_fns += sorted(glob.glob(self.fast5s_dirs[d] + ".host*"))
            failed = not index_fns
            for index_fn in index_fns:
                try:
                    parsed = self._load_index_data(d, index_fn)
                except (OSError, EOFError, pickle.UnpicklingError,
                        TomboError, ValueError, TypeError, AttributeError,
                        IndexError):
                    failed = True
                    continue
                for cs, reads in parsed.items():
                    merged[cs].extend(
                        rd for rd in reads
                        if rd.corr_group.split("/")[0] == self.corr_grp and
                        (self.bc_subgrps is None or
                         rd.corr_group.split("/")[-1] in self.bc_subgrps)
                        and not (self.remove_filtered and rd.filtered))
            if failed and not merged:
                wo_index_dirs.append(d)
        if wo_index_dirs:
            for cs, reads in self._parse_fast5s_wo_index(
                    wo_index_dirs).items():
                merged[cs].extend(reads)
        self.reads_index = defaultdict(
            list, {cs: r for cs, r in merged.items() if r})

    # ------------------------------------------------------------ coverage
    def _compute_coverage(self):
        self.coverage = {}
        for cs, cs_reads in self.reads_index.items():
            if cs_reads:
                cov = np.zeros(max(rd.end for rd in cs_reads), np.int64)
                for rd in cs_reads:
                    cov[rd.start:rd.end] += 1
                self.coverage[cs] = cov
        return self

    def iter_coverage_regions(self, ctrl_reads_index=None):
        """(chrm, strand, cov_levels, cov_starts) run-length coverage,
        summed with ``ctrl_reads_index``'s where given (reference:
        tombo/tombo_helper.py:1430-1456)."""
        if self.coverage is None:
            self._compute_coverage()
        coverage = self.coverage
        if ctrl_reads_index is not None:
            if ctrl_reads_index.coverage is None:
                ctrl_reads_index._compute_coverage()
            merged = {}
            for cs, ctrl_cov in ctrl_reads_index.coverage.items():
                if cs in coverage:
                    a, b = coverage[cs], ctrl_cov
                    if a.shape[0] < b.shape[0]:
                        a, b = b, a
                    m = a.copy()
                    m[:b.shape[0]] += b
                else:
                    m = ctrl_cov.copy()
                merged[cs] = m
            coverage = merged
        for (chrm, strand), cs_cov in coverage.items():
            starts = np.concatenate([
                [0], np.where(np.diff(cs_cov))[0] + 1, [cs_cov.shape[0]]])
            yield chrm, strand, cs_cov[starts[:-1]], starts

    def iter_cov_regs(self, cov_thresh: int,
                      region_size: Optional[int] = None,
                      ctrl_reads_index=None):
        """Regions with coverage >= ``cov_thresh``, snapped to
        ``region_size`` blocks when given (reference:
        tombo/tombo_helper.py:1457-1484)."""
        for chrm, strand, cov, starts in self.iter_coverage_regions(
                ctrl_reads_index):
            curr_reg_start = -1
            valid_cov = np.where(np.diff(np.concatenate([
                [False], np.greater_equal(cov, cov_thresh), [False]])))[0]
            for cov_start_i, cov_end_i in zip(valid_cov[:-1:2],
                                              valid_cov[1::2]):
                cov_start, cov_end = starts[cov_start_i], starts[cov_end_i]
                if region_size is None:
                    yield chrm, strand, int(cov_start), int(cov_end)
                    continue
                reg0 = int(region_size * np.floor(
                    cov_start / float(region_size)))
                reg1 = int(region_size * np.ceil(cov_end / float(region_size)))
                for reg_start in range(reg0, reg1, region_size):
                    if reg_start != curr_reg_start:
                        yield chrm, strand, reg_start
                        curr_reg_start = reg_start

    # ------------------------------------------------------------- queries
    def get_all_cs(self) -> List[Tuple[str, str]]:
        return list(self.reads_index.keys())

    def is_empty(self) -> bool:
        return all(len(v) == 0 for v in self.reads_index.values())

    def __contains__(self, chrm_strand) -> bool:
        return chrm_strand in self.reads_index

    def __iter__(self):
        return iter(self.reads_index.items())

    def iter_reads(self) -> Iterator[ReadData]:
        for cs_reads in self.reads_index.values():
            yield from cs_reads

    def get_cs_reads(self, chrm: str, strand: str, invalid_return=()):
        return self.reads_index.get((chrm, strand), list(invalid_return))

    def _strand_cov(self, chrm, pos, strand, invalid_return):
        cov = self.coverage.get((chrm, strand))
        if cov is None or pos >= cov.shape[0]:
            return invalid_return
        return int(cov[pos])

    def get_coverage(self, chrm: str, pos: int, strand: Optional[str] = None,
                     invalid_return=0):
        """Reads covering ``pos`` on ``strand``, or the larger strand's
        count with no strand."""
        if self.coverage is None:
            self._compute_coverage()
        if strand is None:
            return max(self._strand_cov(chrm, pos, "+", invalid_return),
                       self._strand_cov(chrm, pos, "-", invalid_return))
        return self._strand_cov(chrm, pos, strand, invalid_return)

    def get_cs_coverage(self, chrm: str, strand: str, invalid_return=None):
        if self.coverage is None:
            self._compute_coverage()
        return self.coverage.get((chrm, strand), invalid_return)

    def iter_cs_coverage(self):
        if self.coverage is None:
            self._compute_coverage()
        return self.coverage.items()
