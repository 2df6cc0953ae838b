"""Synthetic reads for tests and the card smoke run (subset copy of
``tombo_tpu/testing.py``; the same seeds give the same reads), and pore
stalls to insert into them."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from .io.fasta import Fasta
from .io.model_io import KmerModel
from .seq import rev_comp


@dataclass
class SyntheticRead:
    read_id: str
    seq: str                   # basecalled (read-oriented) sequence
    raw_signal: np.ndarray     # int16 DAC-like values
    chrm: str
    strand: str
    start: int                 # 0-based reference start of mapped bases
    end: int
    true_segs: np.ndarray      # ground-truth boundaries in raw signal
    read_start_rel_to_raw: int


def random_reference(rng: np.random.Generator, length: int = 20000,
                     name: str = "chr_test") -> Fasta:
    return Fasta(seqs={name: "".join(rng.choice(list("ACGT"), length))})


def simulate_read(
        rng: np.random.Generator, fasta: Fasta, model: KmerModel,
        read_len: int = 800, strand: Optional[str] = None,
        mean_dwell: float = 7.0, noise_sd: float = 0.18,
        adapter_len: Tuple[int, int] = (50, 300),
        dac_scale: float = 60.0, dac_shift: float = 450.0,
        rev_sig: bool = False, read_id: Optional[str] = None
        ) -> SyntheticRead:
    """Per-base levels from the k-mer model, integer dwells, Gaussian
    noise, flanking adapter signal and DAC-like scaling."""
    chrm = fasta.iter_chrms()[0]
    ref = fasta.get_seq(chrm)
    k, cp = model.kmer_width, model.central_pos
    dn = k - cp - 1

    if strand is None:
        strand = "+" if rng.random() < 0.5 else "-"
    start = int(rng.integers(k, len(ref) - read_len - k))
    end = start + read_len
    if strand == "+":
        read_seq = ref[start:end]
        expanded = ref[start - cp:end + dn]
    else:
        read_seq = rev_comp(ref[start:end])
        expanded = rev_comp(ref[start - dn:end + cp])

    levels, _ = model.get_exp_levels_from_seq(expanded)
    dwells = np.maximum(
        2, rng.poisson(mean_dwell - 2, read_len) + 2).astype(np.int64)
    segs = np.concatenate([[0], np.cumsum(dwells)])
    sig = np.repeat(levels, dwells)
    sig = sig + rng.normal(0, noise_sd, sig.shape[0])

    pre_len = int(rng.integers(*adapter_len))
    post_len = int(rng.integers(*adapter_len))
    pre = rng.normal(levels.mean() + 1.5, 0.8, pre_len)
    post = rng.normal(levels.mean() - 0.5, 0.6, post_len)
    full = np.concatenate([pre, sig, post])

    raw = np.round(full * dac_scale + dac_shift).astype(np.int16)
    if rev_sig:
        raw = raw[::-1]

    return SyntheticRead(
        read_id=read_id or "read_%06d" % rng.integers(10 ** 6),
        seq=read_seq, raw_signal=raw, chrm=chrm, strand=strand,
        start=start, end=end, true_segs=segs + pre_len,
        read_start_rel_to_raw=pre_len)


def mutate_seq(rng: np.random.Generator, seq: str,
               err: float = 0.05) -> str:
    """Nanopore-like basecall errors at total rate ``err``: half
    substitutions, a quarter insertions, a quarter deletions."""
    bases = "ACGT"
    out = []
    for c in seq:
        r = rng.random()
        if r < err * 0.5:
            out.append(bases[int(rng.integers(0, 4))])
        elif r < err * 0.75:
            out.append(c)
            out.append(bases[int(rng.integers(0, 4))])
        elif r < err:
            pass
        else:
            out.append(c)
    return "".join(out)


def insert_stall(rng: np.random.Generator, raw: np.ndarray, pos: int,
                 n_obs: int, noise_sd: float = 11.0) -> np.ndarray:
    """``raw`` with a pore stall before sample ``pos``: ``n_obs`` samples
    at the level of ``raw[pos]`` plus Gaussian noise (DAC units)."""
    stall = np.round(raw[pos] + rng.normal(0, noise_sd, n_obs))
    return np.concatenate([raw[:pos], stall.astype(raw.dtype), raw[pos:]])
