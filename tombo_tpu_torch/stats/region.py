"""Genomic regions and their reads' level means (subset copy of
``tombo_tpu/stats/region.py:43-224``; reference: tombo/tombo_helper.py:
1749-2088 ``intervalData``).

A read's means come from, in this order: the device-resident means of a
re-squiggle in this process (``stats/device_levels.py``), the directory's
levels sidecar (``stats/levels_cache.py``), then the FAST5 corrected
group, which needs ``h5py``.  The card path has no FAST5 file: its reads
come from the first source alone.  A read's sequence, which the
alternative-model test reads, is the FAST5 ``base`` column where the
means came from a file, and the reference's bases over the read's span
(reverse complemented on '-') where they are device-resident."""
from __future__ import annotations

import os
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..errors import TomboError
from ..io import fast5 as f5io
from ..seq import rev_comp
from ..types import ReadData
from . import device_levels, levels_cache

_N_IO_THREADS = 8

# reads that span several regions would re-open their FAST5 once a region
# (the reference's files x regions reads); an LRU keyed by (fn, group,
# mtime, size) loads each read once a pass (the JAX lane's
# default)
LEVELS_LRU_CAP = 4096
_lru: "OrderedDict[tuple, tuple]" = OrderedDict()
_lru_lock = threading.Lock()


def clear_levels_cache():
    with _lru_lock:
        _lru.clear()


@dataclass
class ReadLevels:
    """One read's level means over its mapped span, read-centric.  ``dev``
    is a (flat tensor, offset) handle of device-resident means, and then
    ``means`` is None; ``seq`` is the read-centric sequence, where asked
    for."""
    r_data: ReadData
    means: Optional[np.ndarray]
    read_id: Optional[str] = None
    dev: Optional[tuple] = None
    seq: Optional[str] = None

    def tensor(self, device: torch.device) -> torch.Tensor:
        """The means as a float64 tensor on ``device``: the device-resident
        ones gathered where they lie, a file's uploaded."""
        if self.dev is not None:
            flat, off = self.dev
            n = self.r_data.end - self.r_data.start
            return flat[off:off + n].to(device, torch.float64)
        return torch.from_numpy(np.array(self.means, np.float64)).to(
            device)


def _fasta_seq(chrm: str, r: ReadData, fasta) -> str:
    """The read-centric sequence of a read from the reference: the bases
    of [start, end), reverse complemented on '-' (what re-squiggle
    writes to the FAST5 ``base`` column)."""
    if fasta is None:
        raise TomboError("a device-resident read's sequence needs the "
                         "reference")
    seq = fasta.get_seq(chrm, r.start, r.end)
    return rev_comp(seq) if r.strand == "-" else seq


def load_read_levels(r_data: ReadData, with_seq: bool = False,
                     device: Optional[torch.device] = None, fasta=None,
                     chrm: Optional[str] = None) -> ReadLevels:
    """One read's norm_mean (and base sequence): with ``device``, the
    device-resident means of a re-squiggle in this process first (a
    handle, ``dev``; the sequence from ``fasta`` at ``chrm``), then
    through the LRU, the levels sidecar and the FAST5 corrected group
    (reference: tombo/tombo_helper.py:1593-1659).  The file's mtime and
    size are in the key, so a re-squiggled file never serves stale
    levels."""
    if device is not None:
        h = device_levels.lookup(r_data.read_id,
                                 r_data.end - r_data.start, device)
        if h is not None:
            return ReadLevels(r_data, None, r_data.read_id, dev=h, seq=(
                _fasta_seq(chrm, r_data, fasta) if with_seq else None))
    try:
        st = os.stat(r_data.fn)
        key = (r_data.fn, r_data.corr_group, st.st_mtime_ns, st.st_size)
    except OSError:
        st = None
        key = (r_data.fn, r_data.corr_group, None, None)
    with _lru_lock:
        hit = _lru.get(key)
        if hit is not None:
            _lru.move_to_end(key)
    if hit is None:
        if st is not None:
            hit = levels_cache.lookup(r_data.fn, r_data.corr_group,
                                      st.st_mtime_ns, st.st_size)
        if hit is None:
            hit = f5io.read_corrected_levels(r_data.fn, r_data.corr_group,
                                             r_data.read_id)
            if st is not None:
                levels_cache.record(r_data.fn, r_data.corr_group, hit[2],
                                    st.st_mtime_ns, st.st_size, hit[0],
                                    hit[1])
        if LEVELS_LRU_CAP > 0:
            with _lru_lock:
                _lru[key] = hit
                _lru.move_to_end(key)
                while len(_lru) > LEVELS_LRU_CAP:
                    _lru.popitem(last=False)
    return ReadLevels(r_data, hit[0], hit[2],
                      seq=hit[1] if with_seq else None)


def _safe_load(r_data: ReadData, with_seq: bool = False
               ) -> Optional[ReadLevels]:
    try:
        return load_read_levels(r_data, with_seq)
    except (OSError, KeyError, TomboError):
        return None


@dataclass
class RegionData:
    """A genomic interval and the reads that overlap it (reference:
    tombo/tombo_helper.py:1749 ``intervalData``)."""
    chrm: str
    strand: str
    start: int
    end: int
    reads: List[ReadData] = field(default_factory=list)

    def copy_update(self, start: int, end: int) -> "RegionData":
        return RegionData(self.chrm, self.strand, start, end,
                          list(self.reads))

    def add_reads(self, reads_index, require_full_span: bool = False
                  ) -> "RegionData":
        """Select the index's reads that overlap this interval, or with
        ``require_full_span`` those that cover all of it; none where the
        index has no read of the (chromosome, strand) (reference:
        tombo/tombo_helper.py:1860-1927)."""
        if (self.chrm, self.strand) not in reads_index:
            self.reads = []
            return self
        cs_reads = reads_index.get_cs_reads(self.chrm, self.strand)
        if require_full_span:
            self.reads = [r for r in cs_reads
                          if r.start <= self.start and r.end >= self.end]
        else:
            self.reads = [r for r in cs_reads
                          if not (r.end <= self.start or r.start >= self.end)]
        return self

    def _device_hits(self, device: Optional[torch.device]) -> dict:
        if device is None:
            return {}
        hits = {}
        for r in self.reads:
            h = device_levels.lookup(r.read_id, r.end - r.start, device)
            if h is not None:
                hits[id(r)] = h
        return hits

    @staticmethod
    def _load_files(reads, with_seq: bool = False) -> dict:
        if not reads:
            return {}
        with ThreadPoolExecutor(_N_IO_THREADS) as pool:
            return {id(r): rl for r, rl in zip(reads, pool.map(
                lambda r: _safe_load(r, with_seq), reads))}

    def load_levels_packed(self, device: Optional[torch.device] = None
                           ) -> List[ReadLevels]:
        """Levels for the packed lane: reads with device-resident means on
        ``device``'s type give handle-only ReadLevels (no file read, no
        level upload); the rest load from the sidecar or FAST5.  Reads
        found nowhere are left out."""
        hits = self._device_hits(device)
        loaded = self._load_files(
            [r for r in self.reads if id(r) not in hits])
        out = []
        for r in self.reads:
            if id(r) in hits:
                out.append(ReadLevels(r, None, r.read_id, dev=hits[id(r)]))
            elif loaded.get(id(r)) is not None:
                out.append(loaded[id(r)])
        return out

    def load_levels(self, device: Optional[torch.device] = None,
                    with_seq: bool = False, fasta=None) -> List[ReadLevels]:
        """Host (float64) levels of every read found: with ``device``,
        device-resident means first (copied to the host in one gather a
        source tensor), then the sidecar or FAST5.  ``with_seq``: each
        read's sequence too, from ``fasta`` for the device-resident
        reads."""
        hits = self._device_hits(device)
        host = {}
        by_src: dict = {}
        for r in self.reads:
            if id(r) in hits:
                arr, row = hits[id(r)]
                by_src.setdefault(id(arr), (arr, []))[1].append((r, row))
        for arr, rr in by_src.values():
            lens = [r.end - r.start for r, _ in rr]
            idx = torch.from_numpy(np.concatenate([
                np.arange(off, off + n) for (_, off), n in zip(rr, lens)]))
            vals = np.split(arr[idx.to(arr.device)].cpu().numpy().astype(
                np.float64), np.cumsum(lens)[:-1])
            for (r, _), v in zip(rr, vals):
                host[id(r)] = ReadLevels(r, v, r.read_id, seq=(
                    self._fasta_seq(r, fasta) if with_seq else None))
        host.update(self._load_files(
            [r for r in self.reads if id(r) not in hits], with_seq))
        return [host[id(r)] for r in self.reads
                if host.get(id(r)) is not None]

    def _fasta_seq(self, r: ReadData, fasta) -> str:
        return _fasta_seq(self.chrm, r, fasta)

    def get_base_levels(self, device: Optional[torch.device] = None
                        ) -> np.ndarray:
        """(region size, reads) genome-oriented level matrix, NaN where a
        read does not cover a position (reference:
        tombo/tombo_helper.py:1976-2030)."""
        reg_size = self.end - self.start
        levels = self.load_levels(device)
        if not levels:
            return np.full((reg_size, 1), np.nan)
        mat = np.full((reg_size, len(levels)), np.nan)
        for i, rl in enumerate(levels):
            r = rl.r_data
            means = rl.means[::-1] if r.strand == "-" else rl.means
            g_start = max(r.start, self.start)
            g_end = min(r.end, self.end)
            if g_end > g_start:
                mat[g_start - self.start:g_end - self.start, i] = \
                    means[g_start - r.start:g_end - r.start]
        return mat
