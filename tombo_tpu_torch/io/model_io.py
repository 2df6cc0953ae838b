"""Canonical and alternative-base k-mer level models (subset copy of
``tombo_tpu/io/model_io.py``).

Models are dense float64 arrays indexed by base-4 k-mer code, so the
expected levels of a sequence are one gather.  Formats: ``.npz`` (the
bundled models, and what the card path writes and reads), the reference
Tombo HDF5 format (``h5py`` is imported inside its reader and writer),
and nanopolish-style text (k-mer, mean, sd columns; reference:
tombo/tombo_stats.py:602-684, 929-976)."""
from __future__ import annotations

import io as _io
import os
from typing import Dict, Optional, Tuple

import numpy as np

from .. import config
from ..errors import TomboError
from ..seq import TomboMotif, all_kmers, encode_seq, seq_to_kmer_codes

STANDARD_MODEL_NAME = "standard"

_MODELS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "models")


class KmerModel:
    """kmer_width, central_pos, and (4**k,) float64 ``means``/``sds``."""

    def __init__(self, means: np.ndarray, sds: np.ndarray, central_pos: int,
                 name: str = STANDARD_MODEL_NAME,
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
    def load(cls, fn: str, is_text_model: bool = False) -> "KmerModel":
        """A model file: text (``is_text_model`` or a .txt/.tsv name),
        ``.npz``, else the reference's HDF5."""
        if is_text_model or fn.endswith((".txt", ".tsv")):
            return cls.load_text(fn)
        if fn.endswith(".npz"):
            return cls.load_npz(fn)
        return cls.load_tombo_h5(fn)

    @classmethod
    def load_npz(cls, fn: str) -> "KmerModel":
        with np.load(fn, allow_pickle=False) as d:
            return cls(d["means"], d["sds"], int(d["central_pos"]),
                       str(d["model_name"]))

    @classmethod
    def load_tombo_h5(cls, fn: str) -> "KmerModel":
        """The reference's HDF5 model: dataset ``model`` of (kmer, mean,
        sd) records, attrs ``central_pos`` and ``model_name``."""
        import h5py
        with h5py.File(fn, "r") as fp:
            raw = fp["model"][:]
            central_pos = int(fp.attrs["central_pos"])
            name = fp.attrs.get("model_name")
            if isinstance(name, bytes):
                name = name.decode()
        k = len(raw["kmer"][0])
        codes = _kmer_strs_to_codes(raw["kmer"], k)
        means = np.full(4 ** k, np.nan)
        sds = np.full(4 ** k, np.nan)
        means[codes] = raw["mean"]
        sds[codes] = raw["sd"]
        return cls(means, sds, central_pos, name or STANDARD_MODEL_NAME)

    @classmethod
    def load_text(cls, fn: str) -> "KmerModel":
        """Whitespace columns k-mer, mean, sd; lines starting with '#' and
        lines that do not parse are skipped."""
        means_d: Dict[str, float] = {}
        sds_d: Dict[str, float] = {}
        with _io.open(fn) as fp:
            for line in fp:
                if line.startswith("#"):
                    continue
                parts = line.split()
                if len(parts) < 3:
                    continue
                try:
                    m, sd = float(parts[1]), float(parts[2])
                except ValueError:
                    continue
                means_d[parts[0]] = m
                sds_d[parts[0]] = sd
        if not means_d:
            raise TomboError("Invalid text model file: " + fn)
        k = len(next(iter(means_d)))
        means = np.full(4 ** k, np.nan)
        sds = np.full(4 ** k, np.nan)
        for i, kmer in enumerate(all_kmers(k)):
            if kmer in means_d:
                means[i] = means_d[kmer]
                sds[i] = sds_d[kmer]
        return cls(means, sds, config.NANOPOLISH_CENTRAL_POS,
                   STANDARD_MODEL_NAME)

    @classmethod
    def from_kmer_ref(cls, kmer_ref, central_pos: int,
                      name: str = STANDARD_MODEL_NAME) -> "KmerModel":
        """From (kmer, mean, sd) tuples (reference:
        tombo/tombo_stats.py:664-668)."""
        k = len(kmer_ref[0][0])
        codes = _kmer_strs_to_codes([km for km, _, _ in kmer_ref], k)
        means = np.full(4 ** k, np.nan)
        sds = np.full(4 ** k, np.nan)
        means[codes] = [m for _, m, _ in kmer_ref]
        sds[codes] = [sd for _, _, sd in kmer_ref]
        return cls(means, sds, central_pos, name)

    def save_npz(self, fn: str):
        np.savez(fn, means=self.means, sds=self.sds,
                 central_pos=self.central_pos, model_name=self.name)

    def write_model(self, fn: str):
        """The reference's HDF5 format (reference:
        tombo/tombo_stats.py:602-621)."""
        import h5py
        kmers = all_kmers(self.kmer_width)
        valid = ~np.isnan(self.means)
        rec = np.array(
            [(kmers[i].encode(), self.means[i], self.sds[i])
             for i in range(len(kmers)) if valid[i]],
            dtype=[("kmer", "S" + str(self.kmer_width)),
                   ("mean", "f8"), ("sd", "f8")])
        with h5py.File(fn, "w") as fp:
            fp.create_dataset("model", data=rec, compression="gzip")
            fp.attrs["central_pos"] = self.central_pos
            fp.attrs["model_name"] = STANDARD_MODEL_NAME

    def make_constant_sd(self) -> "KmerModel":
        """Every SD set to the median SD (reference:
        tombo/tombo_stats.py:597-600)."""
        return KmerModel(self.means,
                         np.full_like(self.sds, np.nanmedian(self.sds)),
                         self.central_pos, self.name, self.seq_samp_type)

    def center_model(self, shift_corr: float, scale_corr: float
                     ) -> "KmerModel":
        """means * scale_corr + shift_corr (reference:
        tombo/tombo_stats.py:587-595)."""
        return KmerModel(self.means * scale_corr + shift_corr, self.sds,
                         self.central_pos, self.name, self.seq_samp_type)

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
    def from_kmer_ref(cls, kmer_ref, central_pos: int, alt_base: str,
                      name: str = "alt",
                      motif: Optional[TomboMotif] = None) -> "AltModel":
        """From (kmer, pos, level, sd) tuples (reference:
        tombo/tombo_stats.py:957-976)."""
        k = len(kmer_ref[0][0])
        means = np.full((4 ** k, k), np.nan)
        sds = np.full((4 ** k, k), np.nan)
        codes = _kmer_strs_to_codes([e[0] for e in kmer_ref], k)
        for (_, pos, level, sd), code in zip(kmer_ref, codes):
            means[code, pos] = level
            sds[code, pos] = sd
        return cls(means, sds, central_pos, alt_base, name, motif)

    def save_npz(self, fn: str):
        np.savez(fn, means=self.means, sds=self.sds,
                 central_pos=self.central_pos, model_name=self.name,
                 alt_base=self.alt_base, motif=self.motif.raw_motif,
                 mod_pos=self.motif.mod_pos)

    def write_model(self, fn: str):
        """The reference's HDF5 format: (kmer, pos, mean, sd) records
        (reference: tombo/tombo_stats.py:929-953)."""
        import h5py
        k = self.kmer_width
        kmers = all_kmers(k)
        entries = [(kmers[code].encode(), pos, self.means[code, pos],
                    self.sds[code, pos])
                   for code, pos in zip(*np.nonzero(~np.isnan(self.means)))]
        rec = np.array(entries, dtype=[
            ("kmer", "S" + str(k)), ("pos", "u4"), ("mean", "f8"),
            ("sd", "f8")])
        with h5py.File(fn, "w") as fp:
            fp.create_dataset("model", data=rec, compression="gzip")
            fp.attrs["central_pos"] = self.central_pos
            fp.attrs["model_name"] = self.name
            fp.attrs["alt_base"] = self.alt_base
            fp.attrs["motif"] = self.motif.raw_motif
            fp.attrs["mod_pos"] = self.motif.mod_pos

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
