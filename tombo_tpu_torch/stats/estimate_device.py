"""Per-site statistics of stacked read levels for model estimation
(counterpart of ``tombo_tpu/stats/estimate_device.py``; reference:
tombo/tombo_stats.py:1242-1452 ``get_region_kmer_levels`` and its process
fan-out).

Every read-region intersection of a chunk of regions becomes one row of a
(rows, region size) level matrix, gathered on the device from the reads'
sources: the device-resident means of a re-squiggle in this process
(``stats/device_levels.py``), gathered where they are, and host means
(sidecar or FAST5) uploaded once a chunk.  Rows are grouped by source
tensor, one gather a source, so rows from two sources never mix.  The
rows are re-stacked per region into (S, C, W) and reduced over C with NaN
masking: per site the count, the median (numpy's: the mean of the two
middle values) or the mean, and the population standard deviation.  The
sums run in numpy's pairwise order (:func:`np_order_sum`), so at float64
means and standard deviations equal ``np.mean`` / ``np.std`` over the
same values bit for bit.

The host then buckets the covered sites by k-mer, or by (k-mer, offset of
the modified base) for motif models and for given positions
(``valid_poss``), in the site order of the reference's per-site loop.
This is the port's one lane: every variant of estimation runs it, on CPU
and CUDA tensors alike."""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, resolve_dtype
from ..seq import TomboMotif, all_kmers
from .device import gather_row_levels
from .region import RegionData

_BASE_CODE = {"A": 0, "C": 1, "G": 2, "T": 3}
# numpy's pairwise summation: blocks of up to 128 values summed with eight
# accumulators; longer runs split in two at a multiple of 8
_PW_BLOCK = 128
_PW_UNROLL = 8


def _pow2_at_least(x: int, lo: int) -> int:
    b = lo
    while b < x:
        b *= 2
    return b


# ------------------------------------------------------------- the sums
def _pairwise_leaf(vals: torch.Tensor, start: torch.Tensor,
                   n: torch.Tensor) -> torch.Tensor:
    """numpy's pairwise sum of vals[r, start[r]:start[r] + n[r]] for rows
    with n <= 128 (others give a value the caller replaces)."""
    C = vals.shape[1]
    j = torch.arange(_PW_BLOCK, device=vals.device)
    sub = vals.gather(1, (start[:, None] + j[None, :]).clamp(max=C - 1))
    n = n.clamp(max=_PW_BLOCK)
    u = _PW_UNROLL
    # fewer than 8: one running sum from 0
    seq = torch.zeros_like(sub[:, 0])
    for t in range(u - 1):
        seq = torch.where(t < n, seq + sub[:, t], seq)
    # eight running sums over whole blocks of 8, added as a tree, then the
    # rest one by one
    nb = n // u
    r = sub[:, :u]
    for b in range(1, _PW_BLOCK // u):
        r = torch.where((b < nb)[:, None], r + sub[:, b * u:(b + 1) * u], r)
    res = (((r[:, 0] + r[:, 1]) + (r[:, 2] + r[:, 3])) +
           ((r[:, 4] + r[:, 5]) + (r[:, 6] + r[:, 7])))
    for t in range(u - 1):
        col = (nb * u + t).clamp(max=_PW_BLOCK - 1)
        res = torch.where(t < n % u, res + sub.gather(1, col[:, None])[:, 0],
                          res)
    return torch.where(n < u, seq, res)


def _pairwise(vals, start, n):
    out = _pairwise_leaf(vals, start, n)
    big = n > _PW_BLOCK
    if bool(big.any()):
        rows = torch.nonzero(big)[:, 0]
        v, s, m = vals[rows], start[rows], n[rows]
        h = m // 2
        h = h - h % _PW_UNROLL
        out[rows] = _pairwise(v, s, h) + _pairwise(v, s + h, m - h)
    return out


def np_order_sum(vals: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Sum of the first ``n[r]`` values of each row of ``vals`` (R, C) in
    the order of numpy's ``add.reduce`` over a contiguous float array."""
    return _pairwise(vals, torch.zeros_like(n), n)


def site_stats(r_means: torch.Tensor, sub_r0: torch.Tensor,
               sub_r1: torch.Tensor, C: int, est_mean: bool):
    """Per-site (median or mean, population variance, count) of stacked
    rows (the JAX package's ``_site_stats_kernel``; the caller takes the
    square root on the host, where numpy's is correctly rounded: PyTorch's
    CPU ``sqrt`` is not).

    ``r_means``: (B, W) row levels, NaN where a row has none; rows
    [sub_r0[s], sub_r1[s]) belong to region s, at most C of them.
    Returns (center, var, count), each (S, W)."""
    B, W = r_means.shape
    S = sub_r0.shape[0]
    dev = r_means.device
    cidx = torch.arange(C, device=dev)[None, :]
    row_idx = sub_r0[:, None] + cidx
    row_idx = torch.where(row_idx < sub_r1[:, None], row_idx.clamp(0, B - 1),
                          B)
    r_pad = torch.cat([r_means, torch.full((1, W), float("nan"),
                                           dtype=r_means.dtype, device=dev)])
    # site-major: (S * W, C), one site's reads along a row in row order
    x = r_pad[row_idx].permute(0, 2, 1).reshape(S * W, C)
    dead = torch.isnan(x)
    cnt = (~dead).sum(1)
    # the live values first, in row order
    order = torch.sort(dead.to(torch.int8), dim=1, stable=True).indices
    live_first = torch.where(dead, 0.0, x).gather(1, order)
    denom = cnt.clamp(min=1).to(x.dtype)
    mean = np_order_sum(live_first, cnt) / denom
    live = torch.arange(C, device=dev)[None, :] < cnt[:, None]
    d = torch.where(live, live_first - mean[:, None], 0.0)
    var = np_order_sum(d * d, cnt) / denom
    if est_mean:
        center = mean
    else:
        # NaNs sort last: the middle order statistics of the first cnt
        srt = torch.sort(x, dim=1).values
        lo = srt.gather(1, ((cnt - 1) // 2).clamp(min=0)[:, None])[:, 0]
        hi = srt.gather(1, (cnt // 2).clamp(max=C - 1)[:, None])[:, 0]
        center = (lo + hi) / 2
    return (center.reshape(S, W), var.reshape(S, W),
            cnt.reshape(S, W).to(torch.int32))


# ------------------------------------------------------ k-mers and keys
def _kmer_codes(seq: str, kmer_width: int, strand: str) -> np.ndarray:
    """Per-start-position k-mer codes of ``seq`` (base 4, leftmost base
    most significant, the order of ``all_kmers``); on '-' the site k-mer
    is the reverse complement.  -1 marks a window with a non-ACGT base."""
    arr = np.frombuffer(seq.upper().encode(), np.uint8)
    code = np.full(arr.shape[0], -1, np.int64)
    for b, v in _BASE_CODE.items():
        code[arr == ord(b)] = v
    if strand == "-":
        code = np.where(code >= 0, 3 - code, -1)
    n = arr.shape[0] - kmer_width + 1
    if n <= 0:
        return np.empty(0, np.int64)
    out = np.zeros(n, np.int64)
    bad = np.zeros(n, bool)
    for j in range(kmer_width):
        c = code[j:j + n]
        # on '-' the reverse complement reverses the bases of a window
        w = (kmer_width - 1 - j) if strand == "-" else j
        out += np.where(c >= 0, c, 0) << (2 * (kmer_width - 1 - w))
        bad |= c < 0
    return np.where(bad, -1, out)


class _Keys:
    """The keys of one estimation: k-mers, or (k-mer, offset of the
    modified base) pairs that the motif places in the k-mer (reference:
    tombo/tombo_stats.py:1300-1307), in the reference's dict order."""

    def __init__(self, kmer_width: int, motif: Optional[TomboMotif]):
        self.k = kmer_width
        self.motif = motif
        self.kmers = all_kmers(kmer_width)
        self.allowed = None
        if motif is not None:
            self.allowed = np.zeros((4 ** kmer_width, kmer_width), bool)
            for code, km in enumerate(self.kmers):
                for p in motif.find_mod_poss(km):
                    self.allowed[code, p - 1] = True

    def empty(self) -> Dict:
        if self.motif is None:
            return {km: [] for km in self.kmers}
        return {(self.kmers[c], int(o)): []
                for c, o in zip(*np.nonzero(self.allowed))}

    def key(self, code: int, offset: Optional[int]):
        return self.kmers[code] if offset is None else (self.kmers[code],
                                                        offset)


def _padded_seq(fasta, chrm: str, seq_start: int, seq_end: int) -> str:
    seq = fasta.get_seq(chrm, max(0, seq_start), seq_end, error_end=False)
    if seq_start < 0:
        seq = "N" * -seq_start + seq
    if len(seq) < seq_end - seq_start:
        seq += "N" * (seq_end - seq_start - len(seq))
    return seq


def _fill(out: Dict, keys: _Keys, codes, offsets, sites, center, sd):
    """Append (center, sd) of each site to its key's list, sites in the
    given order within a key."""
    if sites.size == 0:
        return
    kid = codes * keys.k + (0 if offsets is None else offsets)
    order = np.argsort(kid, kind="stable")
    kid, sites = kid[order], sites[order]
    cuts = np.flatnonzero(np.diff(kid)) + 1
    for g_sites, k0 in zip(np.split(sites, cuts),
                           kid[np.concatenate([[0], cuts])]):
        key = keys.key(int(k0 // keys.k),
                       None if offsets is None else int(k0 % keys.k))
        out[key].extend((float(center[w]), float(sd[w])) for w in g_sites)


def _bucket_region(reg: RegionData, center, sd, covered, fasta,
                   upstrm_bases: int, dnstrm_bases: int, keys: _Keys,
                   valid_poss=None):
    """{key: [(center, sd), ...]} of one region's covered sites."""
    k = keys.k
    bb, ab = ((upstrm_bases, dnstrm_bases) if reg.strand == "+"
              else (dnstrm_bases, upstrm_bases))
    out = keys.empty()
    motif = keys.motif
    if motif is None and valid_poss is None:
        seq = _padded_seq(fasta, reg.chrm, reg.start - bb, reg.end + ab)
        codes = _kmer_codes(seq, k, reg.strand)
        w_idx = np.flatnonzero(covered[:min(codes.shape[0],
                                            covered.shape[0])])
        c = codes[w_idx]
        keep = c >= 0
        _fill(out, keys, c[keep], None, w_idx[keep], center, sd)
        return out
    if motif is None:
        # given positions without a motif: the reference keys the sites
        # by (k-mer, offset), which no k-mer key matches
        return out
    edges = np.flatnonzero(np.diff(np.concatenate(
        [[False], covered, [False]])))
    offs = (np.arange(k) if reg.strand == "+"
            else k - 1 - np.arange(k))
    all_c, all_o, all_w = [], [], []
    for cs, ce in zip(edges[::2], edges[1::2]):
        cs, ce = int(cs), int(ce)
        int_seq = _padded_seq(fasta, reg.chrm, reg.start + cs - bb,
                              reg.start + ce + ab)
        int_len = ce - cs
        if valid_poss is not None:
            vp = valid_poss.get((reg.chrm, reg.strand))
            if vp is None:
                continue
            mod = np.asarray(vp, np.int64) - reg.start - cs
            mod = mod[(mod >= 0) & (mod < int_len)]
        elif reg.strand == "+":
            mod = np.array([m.start() + motif.mod_pos - 1 - bb
                            for m in motif.motif_pat.finditer(int_seq)],
                           np.int64)
        else:
            mod = np.array([m.start() + motif.motif_len - motif.mod_pos - bb
                            for m in motif.rev_comp_pat.finditer(int_seq)],
                           np.int64)
        mod = mod[(mod >= 0) & (mod < int_len)]
        # each modified base's k windows, offsets in order
        pos = (mod[:, None] - np.arange(k)[None, :] + bb).reshape(-1)
        off = np.broadcast_to(offs, (mod.shape[0], k)).reshape(-1)
        ok = (pos >= 0) & (pos < int_len)
        pos, off = pos[ok], off[ok]
        codes = _kmer_codes(int_seq, k, reg.strand)[pos]
        ok = codes >= 0
        ok[ok] = keys.allowed[codes[ok], off[ok]]
        all_c.append(codes[ok])
        all_o.append(off[ok])
        all_w.append(pos[ok] + cs)
    if all_c:
        _fill(out, keys, np.concatenate(all_c), np.concatenate(all_o),
              np.concatenate(all_w), center, sd)
    return out


# ------------------------------------------------------------ the lane
def _chunk_device(chunk, fasta, cov_thresh, upstrm_bases, dnstrm_bases,
                  est_mean, W, keys: _Keys, device, dtype, valid_poss=None):
    """One chunk of regions: ``chunk`` lists (RegionData, its ReadLevels).
    Returns one {key: [(center, sd), ...]} per region, None where no site
    is covered past ``cov_thresh``."""
    flat_parts, ivec, by_src = [], [], {}
    sub_r0, sub_r1 = [], []
    o = 0
    for reg, levels in chunk:
        sub_r0.append(len(ivec))
        for rl in levels:
            r = rl.r_data
            g_lo, g_hi = max(r.start, reg.start), min(r.end, reg.end)
            if g_hi <= g_lo:
                continue
            n, L = g_hi - g_lo, r.end - r.start
            if rl.dev is not None:
                src, base = rl.dev
                if r.strand == "-":
                    src0, step = L - 1 - (g_lo - r.start), -1
                else:
                    src0, step = g_lo - r.start, 1
                by_src.setdefault(id(src), (src, []))[1].append(
                    (len(ivec), int(base), src0, step, L))
                ivec.append((0, g_lo - reg.start, n))
            else:
                m = rl.means
                if m is None or m.shape[0] != L:
                    continue
                if r.strand == "-":
                    m = m[::-1]
                flat_parts.append(m[g_lo - r.start:g_hi - r.start])
                ivec.append((o, g_lo - reg.start, n))
                o += n
        sub_r1.append(len(ivec))
    if not ivec:
        return [None] * len(chunk)
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    flat = (torch.from_numpy(np.concatenate(flat_parts).astype(np_dt))
            .to(device) if flat_parts else None)
    ivec_t = torch.tensor(np.array(ivec, np.int64).T, device=device)
    dev_groups = [(src, torch.tensor(np.array(rows, np.int64).T,
                                     device=device))
                  for src, rows in by_src.values()]
    r_means = gather_row_levels(flat, ivec_t, dev_groups, W, dtype)
    C = _pow2_at_least(max(b - a for a, b in zip(sub_r0, sub_r1)), 16)
    center, var, cnt = site_stats(
        r_means, torch.tensor(sub_r0, device=device),
        torch.tensor(sub_r1, device=device), C, est_mean)
    center, var, cnt = (t.cpu().numpy() for t in (center, var, cnt))
    sd = np.sqrt(var)
    out = []
    for s, (reg, _) in enumerate(chunk):
        covered = cnt[s] > cov_thresh
        out.append(_bucket_region(reg, center[s], sd[s], covered, fasta,
                                  upstrm_bases, dnstrm_bases, keys,
                                  valid_poss)
                   if covered.any() else None)
    return out


def subsample_reads(reg: RegionData, cs_cov_thresh, region_size: int,
                    rng: np.random.Generator) -> RegionData:
    """The first shuffled reads that reach ``cs_cov_thresh`` times the
    region size in bases (reference: tombo/tombo_stats.py:1250-1262)."""
    reads = list(reg.reads)
    rng.shuffle(reads)
    thresh_bases = region_size * cs_cov_thresh
    cumm = np.cumsum([max(r.end, reg.end) - min(r.start, reg.start)
                      for r in reads])
    sel = np.argmax(cumm >= thresh_bases)
    if cumm.shape[0] and cumm[-1] >= thresh_bases:
        reads = reads[:max(int(sel), 1)]
    return RegionData(reg.chrm, reg.strand, reg.start, reg.end, reads)


def get_region_kmer_levels_device(
        regions: List[RegionData], fasta, cov_thresh, upstrm_bases,
        dnstrm_bases, cs_cov_thresh, est_mean, region_size,
        rng: Optional[np.random.Generator] = None, rows_budget: int = 512,
        motif: Optional[TomboMotif] = None, valid_poss=None,
        device: DeviceLike = None, dtype=None) -> List[Dict]:
    """{key: [(center, sd), ...]} per region with a covered site, regions
    in order, chunked by ``rows_budget`` reads (the JAX device lane's
    chunking); the canonical, motif and given-position variants alike.
    ``rng`` shuffles each region's reads, in region order, where
    ``cs_cov_thresh`` subsamples them (a fresh generator if None, as
    the JAX package does)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype, device)
    keys = _Keys(upstrm_bases + dnstrm_bases + 1, motif)
    if cs_cov_thresh is not None:
        r = rng if rng is not None else np.random.default_rng()
        regions = [subsample_reads(reg, cs_cov_thresh, region_size, r)
                   for reg in regions]
    out, i = [], 0
    while i < len(regions):
        chunk, rows = [], 0
        while i < len(regions) and (not chunk or rows < rows_budget):
            chunk.append(regions[i])
            rows += len(regions[i].reads)
            i += 1
        out.extend(_chunk_device(
            [(reg, reg.load_levels_packed(device)) for reg in chunk],
            fasta, cov_thresh, upstrm_bases, dnstrm_bases, est_mean,
            region_size, keys, device, dtype, valid_poss))
    return [r for r in out if r is not None]
