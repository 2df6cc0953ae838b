"""Base encoding and k-mer codes (subset copy of ``tombo_tpu/seq.py``)."""
from __future__ import annotations

import numpy as np

BASES = "ACGT"

_COMP = str.maketrans("ACGTBDHKMNRSVWYacgtbdhkmnrsvwy",
                      "TGCAVHDMKNYSBWRtgcavhdmknysbwr")

# base-to-code lookup over the full byte range; invalid bases map to -1
_BASE_LUT = np.full(256, -1, dtype=np.int8)
for _i, _b in enumerate(BASES):
    _BASE_LUT[ord(_b)] = _i
    _BASE_LUT[ord(_b.lower())] = _i


def rev_comp(seq: str) -> str:
    return seq.translate(_COMP)[::-1]


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
