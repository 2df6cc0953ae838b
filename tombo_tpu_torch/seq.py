"""Base encoding, k-mer codes and IUPAC motifs (subset copy of
``tombo_tpu/seq.py``)."""
from __future__ import annotations

import re
from typing import List, Optional

import numpy as np

from .errors import TomboError

BASES = "ACGT"

# IUPAC single-letter codes (reference: tombo/tombo_helper.py:490-505
# SINGLE_LETTER_CODE, used by TomboMotif)
IUPAC_CODES = {
    "A": "A", "C": "C", "G": "G", "T": "T",
    "B": "CGT", "D": "AGT", "H": "ACT", "K": "GT", "M": "AC",
    "N": "ACGT", "R": "AG", "S": "CG", "V": "ACG", "W": "AT", "Y": "CT",
}

_COMP = str.maketrans("ACGTBDHKMNRSVWYacgtbdhkmnrsvwy",
                      "TGCAVHDMKNYSBWRtgcavhdmknysbwr")

# base-to-code lookup over the full byte range; invalid bases map to -1
_BASE_LUT = np.full(256, -1, dtype=np.int8)
for _i, _b in enumerate(BASES):
    _BASE_LUT[ord(_b)] = _i
    _BASE_LUT[ord(_b.lower())] = _i


_INVALID_BASES = re.compile("[^ACGT]")


def rev_comp(seq: str) -> str:
    return seq.translate(_COMP)[::-1]


def rev_transcribe(seq: str) -> str:
    """RNA U -> DNA T (reference: tombo/tombo_helper.py:384-386)."""
    return seq.replace("U", "T").replace("u", "t")


def invalid_seq(seq: str) -> bool:
    """True if the sequence holds a base other than A, C, G, T
    (reference: tombo/tombo_helper.py:380-381)."""
    return bool(_INVALID_BASES.search(seq))


def get_mean_q_score(read_q: str, phred_base: int = 33) -> float:
    """Mean basecall q-score of a FASTQ quality string (reference:
    tombo/tombo_helper.py:368-373)."""
    return float(np.mean([ord(c) - phred_base for c in read_q]))


def encode_seq(seq: str) -> np.ndarray:
    """ACGT string -> int8 codes 0..3; non-ACGT become -1."""
    return _BASE_LUT[np.frombuffer(seq.encode("ascii"), dtype=np.uint8)]


def seq_to_kmer_codes(seq_codes: np.ndarray, kmer_width: int) -> np.ndarray:
    """Base-4 code of every k-mer (first base most significant); windows
    holding an invalid base get -1."""
    n = seq_codes.shape[0] - kmer_width + 1
    if n <= 0:
        return np.empty(0, dtype=np.int64)
    codes = np.zeros(n, dtype=np.int64)
    valid = np.ones(n, dtype=bool)
    for j in range(kmer_width):
        window = seq_codes[j:j + n]
        codes = codes * 4 + np.maximum(window, 0).astype(np.int64)
        valid &= window >= 0
    codes[~valid] = -1
    return codes


def kmer_code_to_str(code: int, kmer_width: int) -> str:
    out = []
    for _ in range(kmer_width):
        out.append(BASES[code % 4])
        code //= 4
    return "".join(reversed(out))


def all_kmers(kmer_width: int) -> List[str]:
    """Every ACGT k-mer in base-4 code order (first base most
    significant)."""
    return [kmer_code_to_str(c, kmer_width) for c in range(4 ** kmer_width)]


class TomboMotif:
    """An IUPAC motif with a marked modified position (reference:
    tombo/tombo_helper.py:542-640 ``TomboMotif``): the raw motif compiled
    to forward and reverse-complement regular expressions, scanned
    without overlaps as the reference scans."""

    def __init__(self, raw_motif: str, mod_pos: Optional[int] = None):
        raw_motif = raw_motif.upper()
        invalid = [b for b in raw_motif if b not in IUPAC_CODES]
        if invalid:
            raise TomboError(
                "Invalid IUPAC code(s) in motif: " + "".join(invalid))
        self.raw_motif = raw_motif
        self.motif_len = len(raw_motif)
        # 1-based modified position within the motif
        self.mod_pos = mod_pos
        self.motif_pat = self._compile(raw_motif)
        self.rev_comp_pat = self._compile(rev_comp(raw_motif))
        self.is_palindrome = raw_motif == rev_comp(raw_motif)
        self.mod_base = None if mod_pos is None else raw_motif[mod_pos - 1]

    @staticmethod
    def _compile(motif: str) -> "re.Pattern":
        return re.compile("".join(
            b if len(IUPAC_CODES[b]) == 1 else "[" + IUPAC_CODES[b] + "]"
            for b in motif))

    def find_mod_poss(self, seq: str) -> List[int]:
        """1-based positions of the modified base within forward-strand
        matches of the motif in ``seq``, including partial matches hanging
        off either end of ``seq`` that still place the modified base inside
        it (reference: tombo/tombo_helper.py:672-707)."""
        poss = set()
        L, ml, mp = len(seq), self.motif_len, self.mod_pos
        if L >= ml:
            for m in self.motif_pat.finditer(seq):
                poss.add(m.start() + mp)
        else:
            # seq shorter than the motif: slide the motif over the seq
            for off in range(ml - L + 1):
                if 1 <= mp - off <= L and re.match(
                        self._compile(self.raw_motif[off:off + L]).pattern,
                        seq):
                    poss.add(mp - off)
        # motif hanging off the start: its length-sl suffix matches seq[:sl]
        for sl in range(1, min(L + 1, ml)):
            off = ml - sl
            smp = mp - off
            if 1 <= smp <= sl and re.match(
                    self._compile(self.raw_motif[off:]).pattern, seq[:sl]):
                poss.add(smp)
        # motif hanging off the end: its length-el prefix matches seq[-el:]
        for el in range(1, min(L + 1, ml)):
            if mp <= el and re.match(
                    self._compile(self.raw_motif[:el]).pattern, seq[-el:]):
                poss.add(L - el + mp)
        return sorted(poss)

    def __repr__(self):
        return "TomboMotif({!r}, mod_pos={})".format(self.raw_motif,
                                                     self.mod_pos)
