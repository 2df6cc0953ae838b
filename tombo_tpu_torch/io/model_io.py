"""Canonical and alternative-base k-mer level models (subset copy of
``tombo_tpu/io/model_io.py``).

Models are dense float64 arrays indexed by base-4 k-mer code, so the
expected levels of a sequence are one gather.  The bundled ``.npz``
models load with numpy; the reference Tombo HDF5 format needs ``h5py``,
imported inside its loader."""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from .. import config
from ..errors import TomboError
from ..seq import TomboMotif, encode_seq, seq_to_kmer_codes

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

    def get_exp_levels_from_kmer_codes(self, codes: np.ndarray
                                       ) -> Tuple[np.ndarray, np.ndarray]:
        if np.any(codes < 0):
            raise TomboError(
                "Invalid sequence encountered from genome sequence.")
        return self.means[codes], self.sds[codes]

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

    def get_exp_levels_from_seq_with_gaps(self, seq: str, rev_strand: bool
                                          ) -> Tuple[np.ndarray, np.ndarray]:
        """As ``get_exp_levels_from_seq``, but windows holding a non-ACGT
        base give NaN, and ``rev_strand`` reverses the result (reference:
        tombo/tombo_stats.py:886-919)."""
        codes = seq_to_kmer_codes(encode_seq(seq), self.kmer_width)
        means = np.where(codes >= 0, self.means[np.maximum(codes, 0)],
                         np.nan)
        sds = np.where(codes >= 0, self.sds[np.maximum(codes, 0)], np.nan)
        if rev_strand:
            means, sds = means[::-1], sds[::-1]
        return means, sds


def _kmer_strs_to_codes(kmers: np.ndarray, kmer_width: int) -> np.ndarray:
    """Base-4 codes of an array of k-mer byte strings."""
    flat = np.frombuffer(b"".join(k if isinstance(k, bytes) else
                                  k.encode() for k in kmers),
                         dtype=np.uint8).reshape(len(kmers), kmer_width)
    lut = np.full(256, -1, np.int64)
    for i, b in enumerate(b"ACGT"):
        lut[b] = i
    codes = np.zeros(len(kmers), np.int64)
    for j in range(kmer_width):
        codes = codes * 4 + lut[flat[:, j]]
    return codes


class AltModel:
    """Alternative-base k-mer model: (4**k, k) float64 ``means``/``sds``;
    entry [code, pos] is the level of k-mer ``code`` with the modified
    base at offset ``pos`` of the k-mer, NaN where the model has none
    (reference: tombo/tombo_stats.py:1084-1094)."""

    def __init__(self, means: np.ndarray, sds: np.ndarray, central_pos: int,
                 alt_base: str, name: str, motif: Optional[TomboMotif] = None):
        self.means = np.asarray(means, np.float64)
        self.sds = np.asarray(sds, np.float64)
        self.kmer_width = self.means.shape[1]
        self.central_pos = int(central_pos)
        self.alt_base = alt_base
        self.name = name
        self.motif = motif if motif is not None else TomboMotif(alt_base, 1)

    @classmethod
    def load(cls, fn: str) -> "AltModel":
        if fn.endswith(".npz"):
            return cls.load_npz(fn)
        return cls.load_tombo_h5(fn)

    @classmethod
    def load_npz(cls, fn: str) -> "AltModel":
        with np.load(fn, allow_pickle=False) as d:
            motif = TomboMotif(str(d["motif"]), int(d["mod_pos"]))
            return cls(d["means"], d["sds"], int(d["central_pos"]),
                       str(d["alt_base"]), str(d["model_name"]), motif)

    @classmethod
    def load_tombo_h5(cls, fn: str) -> "AltModel":
        """The reference's HDF5 model: dataset ``model`` of (kmer, pos,
        mean, sd) records (reference: tombo/tombo_stats.py:929-953)."""
        import h5py
        with h5py.File(fn, "r") as fp:
            raw = fp["model"][:]
            attrs = {k: (v.decode() if isinstance(v, bytes) else v)
                     for k, v in fp.attrs.items()}
        k = len(raw["kmer"][0])
        codes = _kmer_strs_to_codes(raw["kmer"], k)
        means = np.full((4 ** k, k), np.nan)
        sds = np.full((4 ** k, k), np.nan)
        means[codes, raw["pos"]] = raw["mean"]
        sds[codes, raw["pos"]] = raw["sd"]
        motif = None
        if attrs.get("motif") is not None and \
                attrs.get("mod_pos") is not None:
            motif = TomboMotif(attrs["motif"], int(attrs["mod_pos"]))
        return cls(means, sds, int(attrs["central_pos"]), attrs["alt_base"],
                   attrs["model_name"], motif)

    @classmethod
    def load_default(cls, alt_name: str, seq_samp_type: str
                     ) -> Optional["AltModel"]:
        """A bundled model by name, or None where there is none."""
        fn = config.ALTERNATE_MODELS.get(seq_samp_type + "_" + alt_name)
        if fn is None or not os.path.isfile(os.path.join(_MODELS_DIR, fn)):
            return None
        return cls.load_npz(os.path.join(_MODELS_DIR, fn))

    def make_constant_sd(self) -> "AltModel":
        """Every defined SD set to the median SD (reference:
        tombo/tombo_stats.py ``_make_constant_sd``)."""
        med = np.nanmedian(self.sds)
        return AltModel(self.means,
                        np.where(np.isnan(self.sds), np.nan, med),
                        self.central_pos, self.alt_base, self.name,
                        self.motif)

    def get_exp_levels_from_kmer_codes(self, codes: np.ndarray,
                                       rev_strand: bool = False
                                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Levels of the k-mers around a tested base: the modified base
        is the last base of the first k-mer and walks back one position a
        k-mer (reference: tombo/tombo_stats.py:1096-1123).  ``codes``:
        (..., k) k-mer codes."""
        k = self.kmer_width
        pos_range = (np.arange(k) if rev_strand
                     else np.arange(k - 1, -1, -1))
        return self.means[codes, pos_range], self.sds[codes, pos_range]


def load_alt_refs(alt_names, seq_samp_type: str,
                  alt_model_fns=None) -> Dict[str, AltModel]:
    """Alternative models by bundled name, or from files (reference:
    tombo/tombo_stats.py:1185-1209 ``load_alt_refs``)."""
    alt_refs: Dict[str, AltModel] = {}
    if alt_model_fns:
        for fn in alt_model_fns:
            ref = AltModel.load(fn)
            alt_refs.setdefault(ref.name, ref)
    else:
        for alt_name in alt_names:
            ref = AltModel.load_default(alt_name, seq_samp_type)
            if ref is not None:
                alt_refs[alt_name] = ref
    return alt_refs
