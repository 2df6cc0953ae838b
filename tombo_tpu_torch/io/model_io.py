"""Canonical k-mer level model (subset copy of ``tombo_tpu/io/model_io.py``).

Models are dense float64 arrays indexed by base-4 k-mer code, so the
expected levels of a sequence are one gather."""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from .. import config
from ..errors import TomboError
from ..seq import encode_seq, seq_to_kmer_codes

_MODELS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "models")


class KmerModel:
    """kmer_width, central_pos, and (4**k,) float64 ``means``/``sds``."""

    def __init__(self, means: np.ndarray, sds: np.ndarray, central_pos: int,
                 name: str = "standard",
                 seq_samp_type: Optional[str] = None):
        self.means = np.asarray(means, np.float64)
        self.sds = np.asarray(sds, np.float64)
        n = self.means.shape[0]
        k = int(round(np.log(n) / np.log(4)))
        if 4 ** k != n:
            raise TomboError("Model table size must be a power of 4")
        self.kmer_width = k
        self.central_pos = int(central_pos)
        self.name = name
        self.seq_samp_type = seq_samp_type

    @classmethod
    def load_npz(cls, fn: str) -> "KmerModel":
        with np.load(fn, allow_pickle=False) as d:
            return cls(d["means"], d["sds"], int(d["central_pos"]),
                       str(d["model_name"]))

    @classmethod
    def load_default(cls, seq_samp_type: str) -> "KmerModel":
        model = cls.load_npz(os.path.join(
            _MODELS_DIR, config.STANDARD_MODELS[seq_samp_type]))
        model.seq_samp_type = seq_samp_type
        return model

    def get_kmer_codes(self, seq: str) -> np.ndarray:
        codes = seq_to_kmer_codes(encode_seq(seq), self.kmer_width)
        if np.any(codes < 0):
            raise TomboError(
                "Invalid sequence encountered from genome sequence.")
        return codes

    def get_exp_levels_from_seq(self, seq: str
                                ) -> Tuple[np.ndarray, np.ndarray]:
        """Level i maps to base i + central_pos of ``seq``."""
        codes = self.get_kmer_codes(seq)
        return self.means[codes], self.sds[codes]
