"""Exact-substring aligner for synthetic reads (subset copy of
``tombo_tpu/pipeline/aligner.py``: ``ExactAligner`` only)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

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
