"""Genomic alignment engines (copy of ``tombo_tpu/pipeline/aligner.py``).

The reference maps basecalls with minimap2 through ``mappy`` (reference:
tombo/resquiggle.py:14-21, 2031-2032).  Three engines give the same
mapping record to ``map_read``:

* :class:`MappyAligner`: minimap2, when ``mappy`` is installed;
* :class:`MinimizerAligner`: the native minimizer engine
  (``csrc/aligner.cpp``, built by :mod:`tombo_tpu_torch.native`), which
  maps real error-prone basecalls;
* :class:`ExactAligner`: exact seeds, for synthetic error-free reads
  only.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..errors import TomboError
from ..io.fasta import Fasta
from ..seq import rev_comp


@dataclass
class Alignment:
    """Minimal alignment record (mappy.Alignment equivalent)."""
    ctg: str
    r_st: int
    r_en: int
    strand: int          # +1 / -1
    q_st: int
    q_en: int
    mlen: int
    blen: int
    cigar: List[Tuple[int, int]]


class MappyAligner:
    """minimap2 through mappy (preset map-ont)."""

    def __init__(self, reference_fn: str, preset: str = "map-ont"):
        try:
            import mappy
        except ImportError:
            raise TomboError(
                "mappy is not installed; use ExactAligner or provide "
                "pre-computed mappings")
        self.reference_fn = reference_fn
        self.preset = preset
        self.aligner = mappy.Aligner(reference_fn, preset=preset)
        if not self.aligner:
            raise TomboError("Failed to load reference with minimap2")

    def map(self, seq: str) -> Optional[Alignment]:
        try:
            aln = list(self.aligner.map(seq))[0]
        except IndexError:
            return None
        return Alignment(
            ctg=aln.ctg, r_st=aln.r_st, r_en=aln.r_en, strand=aln.strand,
            q_st=aln.q_st, q_en=aln.q_en, mlen=aln.mlen, blen=aln.blen,
            cigar=[(l, op) for l, op in aln.cigar])

    def seq(self, chrm: str, start: int, end: int) -> Optional[str]:
        return self.aligner.seq(chrm, start, end)


class MinimizerAligner:
    """The native minimizer engine over an in-memory reference: the best
    hit of (w,k)-minimizer seeding, gap-cost anchor chaining and banded
    base-level alignment between anchors, minimap2's map-ont recipe at
    tombo's level of need (reference: tombo/resquiggle.py:1303 keeps
    only the first hit).  Maps reads with ~10-15% errors on both strands.
    The ctypes handle does not cross a process boundary: a worker
    rebuilds the engine from its ``fasta`` (``ingest.aligner_spec``)."""

    def __init__(self, fasta: Fasta, k: int = 15, w: int = 10,
                 max_occ: int = 200):
        from ..native import get_lib
        self._lib = get_lib()
        self.fasta = fasta
        self._chrms = list(fasta.iter_chrms())
        seqs = [fasta.get_seq(c) for c in self._chrms]
        offsets = np.zeros(len(seqs) + 1, np.int64)
        for i, s in enumerate(seqs):
            offsets[i + 1] = offsets[i] + len(s)
        self._handle = self._lib.aln_index_build(
            "".join(seqs).encode(),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(seqs), k, w, max_occ)

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.aln_index_free(self._handle)
            self._handle = None

    def map(self, seq: str) -> Optional[Alignment]:
        out = np.zeros(10, np.int64)
        cap = 4096
        while True:
            cig = np.zeros(cap, np.int32)
            n_cig = self._lib.aln_map(
                self._handle, seq.encode(), len(seq),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                cig.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap)
            if n_cig != -2:
                break
            cap *= 4
        if n_cig < 0:
            return None
        return Alignment(
            ctg=self._chrms[int(out[0])], r_st=int(out[1]),
            r_en=int(out[2]), strand=int(out[5]), q_st=int(out[3]),
            q_en=int(out[4]), mlen=int(out[6]), blen=int(out[7]),
            cigar=[(int(v) >> 4, int(v) & 0xF) for v in cig[:n_cig]])

    def seq(self, chrm: str, start: int, end: int) -> Optional[str]:
        try:
            return self.fasta.get_seq(chrm, start, end, error_end=False)
        except TomboError:
            return None


class ExactAligner:
    """Finds the query (or its reverse complement) by its first
    ``seed_len`` bases and keeps the candidate of least Hamming distance.
    Adequate for synthetic error-free reads only."""

    def __init__(self, fasta: Fasta, seed_len: int = 24):
        self.fasta = fasta
        self.seed_len = seed_len
        self._seed_index = {}
        for chrm in fasta.iter_chrms():
            s = fasta.get_seq(chrm)
            for i in range(0, max(1, len(s) - seed_len + 1)):
                self._seed_index.setdefault(s[i:i + seed_len], []).append(
                    (chrm, i))

    def _find(self, query: str):
        best = None
        for chrm, pos in self._seed_index.get(query[:self.seed_len], []):
            ref = self.fasta.get_seq(chrm)
            end = pos + len(query)
            if end > len(ref):
                continue
            mism = sum(a != b for a, b in zip(query, ref[pos:end]))
            if best is None or mism < best[3]:
                best = (chrm, pos, end, mism)
        return best

    def map(self, seq: str) -> Optional[Alignment]:
        fwd = self._find(seq)
        rc = self._find(rev_comp(seq))
        if fwd is None and rc is None:
            return None
        use_rc = fwd is None or (rc is not None and rc[3] < fwd[3])
        chrm, r_st, r_en, mism = rc if use_rc else fwd
        qlen = len(seq)
        return Alignment(
            ctg=chrm, r_st=r_st, r_en=r_en, strand=-1 if use_rc else 1,
            q_st=0, q_en=qlen, mlen=qlen - mism, blen=qlen,
            cigar=[(qlen, 0)])

    def seq(self, chrm: str, start: int, end: int) -> Optional[str]:
        try:
            return self.fasta.get_seq(chrm, start, end, error_end=False)
        except TomboError:
            return None


def open_aligner(reference_fn: str):
    """minimap2 first, then the native minimizer engine, then, for
    error-free reads only, the exact aligner."""
    try:
        return MappyAligner(reference_fn)
    except TomboError:
        pass
    fasta = Fasta.read(reference_fn)
    try:
        return MinimizerAligner(fasta)
    except TomboError:
        return ExactAligner(fasta)
