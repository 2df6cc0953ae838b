"""Synthetic reads for tests and the card smoke run (copy of
``tombo_tpu/testing.py``; the same seeds give the same reads and files),
pore stalls to insert into them, and the writers of single-read FAST5
files with basecalls and basecaller event tables (``h5py`` is imported
inside them)."""
from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import List, Optional, Tuple

import numpy as np

from . import config
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


def write_synthetic_fast5(path: str, read: SyntheticRead,
                          with_basecalls: bool = True,
                          bc_grp: str = config.DEFAULT_BASECALL_GROUP,
                          bc_subgrp: str = config.DEFAULT_BASECALL_SUBGROUP):
    """A single-read FAST5 in the layout re-squiggle reads: the raw
    signal, the channel (offset 0, range 1400, digitisation 8192) and,
    with ``with_basecalls``, the basecalls' Fastq slot."""
    import h5py
    with h5py.File(path, "w") as f:
        rg = f.create_group("Raw/Reads/Read_%d" % 1)
        rg.attrs["read_id"] = read.read_id
        rg.create_dataset("Signal", data=read.raw_signal.astype(np.int16))
        cid = f.create_group("UniqueGlobalKey/channel_id")
        cid.attrs["offset"] = 0.0
        cid.attrs["range"] = 1400.0
        cid.attrs["digitisation"] = 8192.0
        cid.attrs["channel_number"] = 1
        cid.attrs["sampling_rate"] = 4000
        f.create_group("Analyses")
        if with_basecalls:
            bc = f.create_group("Analyses/" + bc_grp + "/" + bc_subgrp)
            qual = "#" * len(read.seq)
            fastq = "@%s\n%s\n+\n%s\n" % (read.read_id, read.seq, qual)
            bc.create_dataset("Fastq", data=np.bytes_(fastq.encode()))


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


def make_synthetic_dataset(tmpdir: str, n_reads: int = 10, seed: int = 42,
                           ref_len: int = 20000, read_len: int = 800,
                           model: Optional[KmerModel] = None,
                           noisy_frac: float = 0.0,
                           noisy_err: float = 0.05
                           ) -> Tuple[Fasta, List[SyntheticRead], str]:
    """A reference (written to ``tmpdir/reference.fasta``) and a
    directory of FAST5 files of simulated reads.  Returns (fasta, reads,
    fast5 directory).  A ``noisy_frac`` share of the reads get basecalls
    with errors at rate ``noisy_err``; their raw signal stays the clean
    simulation."""
    rng = np.random.default_rng(seed)
    if model is None:
        model = KmerModel.load_default(config.DNA_SAMP_TYPE)
    fasta = random_reference(rng, ref_len)
    fast5_dir = os.path.join(tmpdir, "fast5s")
    os.makedirs(fast5_dir, exist_ok=True)
    reads = []
    for i in range(n_reads):
        read = simulate_read(rng, fasta, model, read_len=read_len,
                             read_id="synth_%04d" % i)
        if noisy_frac > 0 and rng.random() < noisy_frac:
            read = replace(read, seq=mutate_seq(rng, read.seq, noisy_err))
        write_synthetic_fast5(
            os.path.join(fast5_dir, read.read_id + ".fast5"), read)
        reads.append(read)
    fasta.write(os.path.join(tmpdir, "reference.fasta"))
    return fasta, reads, fast5_dir


def write_basecaller_events(path: str, read: SyntheticRead,
                            bc_grp: str = config.DEFAULT_BASECALL_GROUP,
                            bc_subgrp: str =
                            config.DEFAULT_BASECALL_SUBGROUP,
                            jitter: int = 0,
                            rng: Optional[np.random.Generator] = None,
                            model: Optional[KmerModel] = None):
    """Add a basecaller-style per-base ``Events`` table to a synthetic
    FAST5, which the event re-squiggle reads.  ``jitter`` moves each
    inner boundary by up to that many samples (drawn from ``rng``).
    With ``model``, each event's mean in pA (the channel of
    :func:`write_synthetic_fast5`) and its ``model_state`` k-mer, which
    pA normalization needs."""
    import h5py
    segs = read.true_segs.copy()
    if jitter and rng is not None:
        inner = segs[1:-1] + rng.integers(-jitter, jitter + 1,
                                          segs.shape[0] - 2)
        segs[1:-1] = np.maximum.accumulate(
            np.clip(inner, segs[0] + 1, segs[-1] - 1))
        for i in range(1, segs.shape[0]):
            if segs[i] <= segs[i - 1]:
                segs[i] = segs[i - 1] + 1
    starts = segs[:-1]
    lengths = np.diff(segs)
    n = len(lengths)
    bases = [b.encode() for b in read.seq]
    if model is not None:
        raw = read.raw_signal.astype(np.float64)
        means = np.array([raw[s:e].mean()
                          for s, e in zip(segs[:-1], segs[1:])]) * \
            (1400.0 / 8192.0)
        k, cp = model.kmer_width, model.central_pos
        pad = "A" * cp + read.seq + "A" * (k - cp - 1)
        states = [pad[i:i + k].encode() for i in range(n)]
        rec = np.array(
            list(zip(starts, lengths, means, bases, states)),
            dtype=[("start", "u8"), ("length", "u8"), ("mean", "f8"),
                   ("base", "S1"), ("model_state", "S%d" % k)])
    else:
        rec = np.array(
            list(zip(starts, lengths, np.zeros(n), bases)),
            dtype=[("start", "u8"), ("length", "u8"), ("mean", "f8"),
                   ("base", "S1")])
    with h5py.File(path, "r+") as f:
        grp = f.require_group("Analyses/" + bc_grp + "/" + bc_subgrp)
        if "Events" in grp:
            del grp["Events"]
        grp.create_dataset("Events", data=rec)
