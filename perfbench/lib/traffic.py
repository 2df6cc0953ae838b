"""The one general generator of the benchmark's traffic: simulated nanopore
reads over a random reference, both made from the run's seed, with the
shapes a traffic file sets.

A traffic file (``perfbench/traffic/<name>.json``) holds:
  ``n_reads``, ``batch``: the pool and its batches;
  ``ref_len``: the reference's length in bases;
  ``lengths``: ``{"fixed": n}``, or ``{"mean_n50": [mean, N50], "clip":
  [lo, hi]}``, the log-normal with a published run's mean read length
  and read N50;
  the lengths are the same for every seed (the distribution's
  quantiles), only their order changes with it;
  ``source``: where the lengths come from (read by no code);
  ``mean_dwell``: samples a base (each read has its length times this,
  spread over its bases with at least 2 a base);
  ``noise_sd``, ``adapter_len``, ``dac_scale``, ``dac_shift``;
  ``rev_sig``: the signal runs 3' to 5' (direct RNA);
  ``stall``: none, or ``{"every": k, "n_obs": [lo, hi]}``, a pore stall at
  the middle base boundary of one read in k, of a length from an even
  grid over ``n_obs``;
  ``warmup_batches``: batches the set-up runs before the window;
  ``check_reads``: reads of the window held against the reference.

The simulation is a frozen copy of the repository's synthetic-read recipe
(per-base k-mer levels, random dwells, Gaussian noise, flanking adapter
signal, DAC scaling), so later changes to the program cannot move it."""
from __future__ import annotations

import dataclasses
import math
import statistics
from typing import List, Tuple

import numpy as np

from perfbench.reference.resquiggle import KmerModel, rev_comp


@dataclasses.dataclass
class SimRead:
    read_id: str
    seq: str                 # basecalls, read orientation
    raw: np.ndarray          # int16, as the sequencer gives it
    strand: str
    start: int               # reference span of the mapped bases
    end: int
    stall: int = 0           # samples of a pore stall inserted


def seed_rng(seed: int, stream: int) -> np.random.Generator:
    """An independent generator for each use of the run's seed."""
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), stream])


def random_reference(rng: np.random.Generator, length: int) -> str:
    return "".join(rng.choice(list("ACGT"), length))


def simulate_read(rng, ref: str, model: KmerModel, read_len: int,
                  n_samples: int, noise_sd: float, adapters: Tuple[int, int],
                  dac_scale: float, dac_shift: float, rev_sig: bool,
                  read_id: str):
    """A simulated read of ``n_samples`` samples over its bases (dwells of
    at least 2, the rest spread over the bases at random, so each dwell
    is close to a shifted Poisson) between adapters of ``adapters``
    samples, and the raw-signal boundaries of its bases (in the 5' to 3'
    signal, before ``rev_sig`` turns it)."""
    k, cp = model.kmer_width, model.central_pos
    dn = k - cp - 1
    strand = "+" if rng.random() < 0.5 else "-"
    start = int(rng.integers(k, len(ref) - read_len - k))
    end = start + read_len
    if strand == "+":
        seq = ref[start:end]
        expanded = ref[start - cp:end + dn]
    else:
        seq = rev_comp(ref[start:end])
        expanded = rev_comp(ref[start - dn:end + cp])
    levels, _ = model.levels(expanded)
    dwells = 2 + rng.multinomial(n_samples - 2 * read_len,
                                 np.full(read_len, 1.0 / read_len))
    sig = np.repeat(levels, dwells) + rng.normal(0, noise_sd, n_samples)
    pre = rng.normal(levels.mean() + 1.5, 0.8, adapters[0])
    post = rng.normal(levels.mean() - 0.5, 0.6, adapters[1])
    raw = np.round(np.concatenate([pre, sig, post]) * dac_scale +
                   dac_shift).astype(np.int16)
    if rev_sig:
        raw = raw[::-1].copy()
    return SimRead(read_id, seq, raw, strand, start, end), \
        np.concatenate([[0], np.cumsum(dwells)]) + pre.shape[0]


def insert_stall(rng, raw: np.ndarray, pos: int, n_obs: int,
                 noise_sd: float = 11.0) -> np.ndarray:
    """``raw`` with ``n_obs`` samples at the level of ``raw[pos]`` plus
    noise inserted before sample ``pos`` (DAC units)."""
    stall = np.round(raw[pos] + rng.normal(0, noise_sd, n_obs))
    return np.concatenate([raw[:pos], stall.astype(raw.dtype), raw[pos:]])


def read_lengths(spec: dict, n: int) -> np.ndarray:
    """The pool's read lengths, sorted: a fixed length, or the quantiles
    (i + 0.5) / n of a clipped log-normal."""
    if "fixed" in spec:
        return np.full(n, int(spec["fixed"]), np.int64)
    mu, sigma = lognormal_of(*spec["mean_n50"])
    lo, hi = spec["clip"]
    nd = statistics.NormalDist(mu, sigma)
    q = [np.exp(nd.inv_cdf((i + 0.5) / n)) for i in range(n)]
    return np.clip(np.round(q), lo, hi).astype(np.int64)


def lognormal_of(mean: float, n50: float) -> Tuple[float, float]:
    """(ln median, sigma) of the log-normal whose mean and N50 are these.
    The bases lie in reads whose lengths are log-normal with the same
    sigma and ln median + sigma**2, so N50 = exp(mu + sigma**2) and
    mean = exp(mu + sigma**2 / 2)."""
    sigma = math.sqrt(2.0 * math.log(n50 / mean))
    return math.log(mean) - sigma * sigma / 2.0, sigma


def batch_lengths(lens: np.ndarray, n_batches: int) -> List[np.ndarray]:
    """The sorted lengths dealt to the batches in a snake order (0, 1,
    ..., n-1, n-1, ..., 0, ...), so that every batch holds the same
    spread of lengths."""
    i = np.arange(lens.shape[0])
    g, pos = i // n_batches, i % n_batches
    batch = np.where(g % 2 == 0, pos, n_batches - 1 - pos)
    return [lens[batch == b] for b in range(n_batches)]


@dataclasses.dataclass
class Pool:
    reads: List[SimRead]
    batches: List[List[int]]     # read indices of each batch
    order: np.ndarray            # the batches' order in the window
    ref: str


def make_pool(traffic: dict, seed: int, model: KmerModel) -> Pool:
    """The run's reads.  Their sizes are the same for every seed: the
    lengths spread evenly over the batches (:func:`batch_lengths`), each
    read's samples (``mean_dwell`` a base) and adapters (from a draw
    fixed for all seeds), and the stalls' lengths; so every seed brings
    the same work.  The seed draws their order, positions, strands,
    dwells and noise."""
    n, bsz = int(traffic["n_reads"]), int(traffic["batch"])
    if n % bsz:
        raise ValueError("n_reads must be a multiple of batch")
    n_batches = n // bsz
    lens = read_lengths(traffic["lengths"], n)
    rng = seed_rng(seed, 0)
    ref = random_reference(seed_rng(seed, 1), int(traffic["ref_len"]))
    sizes = seed_rng(0, 3)
    dwell = float(traffic["mean_dwell"])
    stall = traffic.get("stall")
    stall_lens = []
    if stall:
        n_st = len(range(0, n, int(stall["every"])))
        lo, hi = stall["n_obs"]
        stall_lens = list(sizes.permutation(np.round(
            lo + (hi - lo) * (np.arange(n_st) + 0.5) / n_st).astype(int)))
    slots = []
    for b, x in enumerate(batch_lengths(lens, n_batches)):
        ads = sizes.integers(*traffic["adapter_len"], (x.shape[0], 2))
        slots.append([
            (int(L), int(round(L * dwell)), (int(a), int(c)),
             int(stall_lens.pop()) if stall and
             (b * bsz + j) % int(stall["every"]) == 0 else 0)
            for j, (L, (a, c)) in enumerate(zip(x, ads))])
        slots[-1] = [slots[-1][j] for j in rng.permutation(x.shape[0])]
    reads, batches = [], []
    for b in range(n_batches):
        idx = []
        for read_len, n_samples, adapters, n_obs in slots[b]:
            i = len(reads)
            read, segs = simulate_read(
                rng, ref, model, read_len, n_samples,
                float(traffic["noise_sd"]), adapters,
                float(traffic["dac_scale"]), float(traffic["dac_shift"]),
                bool(traffic.get("rev_sig", False)), "read_%06d" % i)
            if n_obs:
                raw = read.raw
                if traffic.get("rev_sig", False):
                    pos = raw.shape[0] - int(segs[read_len // 2])
                else:
                    pos = int(segs[read_len // 2])
                read.raw = insert_stall(rng, raw, pos, n_obs)
                read.stall = n_obs
            reads.append(read)
            idx.append(i)
        batches.append(idx)
    return Pool(reads, batches, rng.permutation(n_batches), ref)


class Reservoir:
    """A uniform sample of ``k`` items from a stream, drawn from ``rng``:
    ``add(item)`` each; ``items`` holds the sample."""

    def __init__(self, rng: np.random.Generator, k: int):
        self.rng, self.k = rng, k
        self.items: list = []
        self.seen = 0

    def add(self, item):
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen))
            if j < self.k:
                self.items[j] = item
