"""Genome-anchored signal plots, k-mer level distributions, per-read
statistic matrices and trace clustering (counterpart of
``tombo_tpu/plot/signal.py``; reference: tombo/_plot_commands.py:451-2268
and R_scripts/).

Each plot is a data function and a renderer.  The data functions return
arrays; the renderers draw them with ``matplotlib``, imported inside
them.  Where the data are the reads' level means (k-mer levels, the
sample/control difference, clustered traces), the means are read where
they lie (``stats/region.py::load_read_levels``: the device-resident
means of a re-squiggle in this process, else the levels sidecar or the
FAST5 file) and the bulk work runs as tensor operations on ``device``
(default the card): the k-mer grouping sort, the per-position means, the
slide-span alignment over every offset at once and the traces' distance
matrix.  Ward's merges are a short host loop.  The raw-signal segments,
the model levels, the region selections and the statistic lists are
host work on files, as in the JAX package.
"""
from __future__ import annotations

from collections import namedtuple
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..errors import TomboError
from ..io import fast5 as f5io
from ..seq import encode_seq, rev_comp, seq_to_kmer_codes
from ..stats.region import RegionData, load_read_levels

_BASE_COLORS = {"A": "#00CC00", "C": "#0000CC", "G": "#FFB300",
                "T": "#CC0000", "N": "#888888"}

# one region's signal: per-read (x, y, strand) traces, or with more reads
# than the overplot threshold and a summary type, (positions, values):
# per-base lists of per-read base levels (Boxplot, Density) or their
# 10/25/50/75/90 percentiles (Quantile); and the reads drawn or summarized
RegionSignal = namedtuple("RegionSignal",
                          ("traces", "summary", "n_plotted"))


# ------------------------------------------------------------ region signal

def _load_read_signal_segments(r_data, reg_start, reg_end):
    """(genome position, normalized signal) of each base of a read within
    [reg_start, reg_end), from its FAST5 file (reference:
    tombo/tombo_helper.py:2090-2207 ``get_raw_signal``)."""
    import h5py
    with h5py.File(r_data.fn, "r") as fp:
        raw = f5io.get_raw_signal(fp)
        grp = fp["/Analyses/" + r_data.corr_group]
        events = grp["Events"][:]
        rsrtr = int(grp["Events"].attrs["read_start_rel_to_raw"])
        shift = float(grp.attrs["shift"])
        scale = float(grp.attrs["scale"])
        rna = bool(grp.attrs.get("rna", False))
    if rna:
        raw = raw[::-1]
    norm = (raw.astype(np.float64) - shift) / scale
    starts = events["start"].astype(np.int64)
    lengths = events["length"].astype(np.int64)
    segs = []
    for i in range(starts.shape[0]):
        g_pos = (r_data.start + i if r_data.strand == "+"
                 else r_data.end - 1 - i)
        if not (reg_start <= g_pos < reg_end):
            continue
        s = rsrtr + starts[i]
        segs.append((g_pos, norm[s:s + lengths[i]]))
    return segs


def _model_levels_for_region(model, fasta, reg, alt=False):
    """Expected (mean, sd) of each genome base of ``reg`` under a k-mer
    model, NaN where the context is incomplete or not ACGT; an alternative
    model's with the modified base at its central position."""
    k, cpos = model.kmer_width, model.central_pos
    if reg.strand == "+":
        s, e = reg.start - cpos, reg.end + (k - 1 - cpos)
    else:
        s, e = reg.start - (k - 1 - cpos), reg.end + cpos
    pad_l = max(0, -s)
    seq = fasta.get_seq(reg.chrm, max(0, s), e, error_end=False)
    seq = "N" * pad_l + seq + "N" * (e - max(0, s) + pad_l - len(seq))
    if reg.strand == "-":
        seq = rev_comp(seq)
    if alt:
        codes = seq_to_kmer_codes(encode_seq(seq), k)
        means = np.where(codes >= 0,
                         model.means[np.maximum(codes, 0), cpos], np.nan)
        sds = np.where(codes >= 0,
                       model.sds[np.maximum(codes, 0), cpos], np.nan)
    else:
        means, sds = model.get_exp_levels_from_seq_with_gaps(seq, False)
    if reg.strand == "-":
        means, sds = means[::-1], sds[::-1]
    return means, sds


def region_signal_data(reg: RegionData, num_reads=None, overplot_thresh=50,
                       overplot_type="Downsample") -> RegionSignal:
    """The signal of a region's reads: each read's trace, or past
    ``overplot_thresh`` reads with ``overplot_type`` Boxplot, Quantile or
    Density, per-base summaries of the reads' base levels (reference:
    tombo/_option_parsers.py:343-346,649-652).  Downsample keeps the
    first ``overplot_thresh`` reads."""
    reads = reg.reads[:num_reads] if num_reads else reg.reads
    summarize = (overplot_type != "Downsample" and
                 len(reads) > overplot_thresh)
    traces = []
    base_levels: List[List[float]] = [[] for _ in range(reg.end - reg.start)]
    n_plotted = 0
    for r_data in reads:
        if not summarize and n_plotted >= overplot_thresh:
            break
        try:
            segs = _load_read_signal_segments(r_data, reg.start, reg.end)
        except (OSError, KeyError, TomboError):
            continue
        if summarize:
            for g_pos, sig in segs:
                if sig.shape[0]:
                    base_levels[g_pos - reg.start].append(
                        float(np.mean(sig)))
            n_plotted += 1
            continue
        xs, ys = [], []
        for g_pos, sig in segs:
            if sig.shape[0] == 0:
                continue
            xs.append(g_pos - reg.start +
                      np.linspace(0, 1, sig.shape[0], endpoint=False))
            ys.append(sig)
        if not xs:
            continue
        traces.append((np.concatenate(xs), np.concatenate(ys),
                       r_data.strand))
        n_plotted += 1
    summary = None
    if summarize and any(base_levels):
        filled = [(i, lv) for i, lv in enumerate(base_levels) if lv]
        poss = [i + 0.5 for i, _ in filled]
        vals = [lv for _, lv in filled]
        if overplot_type == "Quantile":
            summary = (np.asarray(poss), np.array(
                [np.percentile(lv, (10, 25, 50, 75, 90)) for lv in vals]))
        else:
            summary = (poss, vals)
    return RegionSignal(traces, summary, n_plotted)


def plot_region_signal(ax, reg: RegionData, fasta=None, num_reads=None,
                       overplot_thresh=50, overplot_type="Downsample",
                       model=None, alt_model=None):
    """Draw ``region_signal_data`` of a region on ``ax``, with the models'
    expected levels and the reference bases where given.  Returns the
    reads drawn or summarized."""
    data = region_signal_data(reg, num_reads, overplot_thresh,
                              overplot_type)
    for xs, ys, strand in data.traces:
        ax.plot(xs, ys, lw=0.4, alpha=0.5,
                color="#1f77b4" if strand == "+" else "#d62728")
    if data.summary is not None:
        poss, vals = data.summary
        if overplot_type == "Boxplot":
            ax.boxplot(vals, positions=poss, widths=0.7,
                       manage_ticks=False, showfliers=False)
        elif overplot_type == "Density":
            ax.violinplot(vals, positions=poss, widths=0.9,
                          showmedians=True, showextrema=False)
        else:
            ax.fill_between(poss, vals[:, 0], vals[:, 4], alpha=0.25,
                            color="#1f77b4", lw=0)
            ax.fill_between(poss, vals[:, 1], vals[:, 3], alpha=0.45,
                            color="#1f77b4", lw=0)
            ax.plot(poss, vals[:, 2], color="#0a3d6e", lw=1.0)
    for mdl, is_alt, color in ((model, False, "#444444"),
                               (alt_model, True, "#b0226e")):
        if mdl is None or fasta is None:
            continue
        means, sds = _model_levels_for_region(mdl, fasta, reg, alt=is_alt)
        xs = np.arange(reg.end - reg.start) + 0.5
        ax.errorbar(xs, means, yerr=sds, fmt="_", ms=9, lw=0,
                    elinewidth=1.0, capsize=2, color=color, alpha=0.8,
                    label="alt model" if is_alt else "standard model")
    if fasta is not None:
        try:
            seq = fasta.get_seq(reg.chrm, reg.start, reg.end,
                                error_end=False)
        except TomboError:
            seq = ""
        ylim = ax.get_ylim()
        for i, b in enumerate(seq):
            ax.text(i + 0.5, ylim[0], b, ha="center", va="bottom",
                    fontsize=7, color=_BASE_COLORS.get(b, "#888888"))
    ax.set_xlim(0, reg.end - reg.start)
    ax.set_title("%s:%d-%d (%s)" % (reg.chrm, reg.start + 1, reg.end,
                                    reg.strand), fontsize=8)
    return data.n_plotted


def _new_pdf(pdf_fn):
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib.backends.backend_pdf import PdfPages
    return PdfPages(pdf_fn)


def plot_intervals(regions: Sequence[RegionData], pdf_fn, fasta=None,
                   num_reads=None, titles=None, overplot_thresh=50,
                   overplot_type="Downsample", model=None, alt_model=None):
    """One PDF page of signal per region."""
    import matplotlib.pyplot as plt
    with _new_pdf(pdf_fn) as pdf:
        for i, reg in enumerate(regions):
            fig, ax = plt.subplots(figsize=(10, 3.5))
            plot_region_signal(ax, reg, fasta, num_reads,
                               overplot_thresh, overplot_type,
                               model=model, alt_model=alt_model)
            ax.set_ylabel("Normalized signal")
            if titles is not None and i < len(titles):
                ax.set_title(titles[i], fontsize=8)
            fig.tight_layout()
            pdf.savefig(fig)
            plt.close(fig)


# -------------------------------------------------------- region choices

def select_max_coverage_regions(reads_index, num_regions, num_bases):
    """Regions of ``num_bases`` centred on each strand's coverage peak,
    deepest first (reference: tombo/_plot_commands.py:1659-1730)."""
    cov_peaks = []
    for (chrm, strand), cov in reads_index.iter_cs_coverage():
        if cov is None or cov.shape[0] == 0:
            continue
        best = int(np.argmax(cov))
        cov_peaks.append((int(cov[best]), chrm, strand, best))
    cov_peaks.sort(reverse=True)
    out = []
    for _, chrm, strand, pos in cov_peaks[:num_regions]:
        start = max(0, pos - num_bases // 2)
        out.append(RegionData(chrm, strand, start, start + num_bases))
    return out


def select_motif_regions(fasta, motif, reads_index, num_regions,
                         num_bases, deepest_coverage=False, rng=None):
    """Regions centred on covered motif occurrences (reference:
    tombo/_plot_commands.py:1831-2000): a sample shuffled with ``rng``
    (default ``np.random.default_rng(0)``), or with ``deepest_coverage``
    the deepest (reference: tombo/_option_parsers.py:493-495)."""
    out = []
    for chrm in fasta.iter_chrms():
        seq = fasta.get_seq(chrm)
        for m in motif.motif_pat.finditer(seq):
            pos = m.start() + motif.mod_pos - 1
            for strand in "+-":
                cov = reads_index.get_coverage(chrm, pos, strand)
                if cov and cov > 0:
                    start = max(0, pos - num_bases // 2)
                    out.append((cov, RegionData(chrm, strand, start,
                                                start + num_bases)))
        if len(out) > num_regions * 50:
            break
    if deepest_coverage:
        out.sort(key=lambda x: -x[0])
    else:
        (rng or np.random.default_rng(0)).shuffle(out)
    return [reg for _, reg in out[:num_regions]]


def _chrm_of(reads_index) -> dict:
    return {id(r): chrm for (chrm, _), reads in reads_index
            for r in reads}


def max_difference_regions(reads_index, ctrl_reads_index, num_regions,
                           num_bases, device: DeviceLike = None,
                           fasta=None) -> List[RegionData]:
    """Regions of ``num_bases`` around the positions where the sample's
    and the control's mean levels differ most (NaN counts as no
    difference).  The per-position means are tensor operations on
    ``device``; the picks are numpy's ``argsort`` on the host, as in the
    JAX command, so ties fall as they fall there."""
    from ..output.text import get_chrm_sizes
    dev = resolve_device(device)
    chrm_sizes = get_chrm_sizes(reads_index, ctrl_reads_index)
    diffs = []
    for chrm in sorted(chrm_sizes):
        for strand in ("+", "-"):
            means = [mean_levels_genome_centric(
                idx.get_cs_reads(chrm, strand), chrm, chrm_sizes[chrm],
                dev, fasta) if (chrm, strand) in idx else None
                for idx in (reads_index, ctrl_reads_index)]
            if means[0] is None or means[1] is None:
                continue
            d = (means[0] - means[1]).abs()
            d = torch.where(torch.isnan(d), torch.zeros_like(d), d)
            d = d.cpu().numpy()
            for pos in np.argsort(d)[::-1][:num_regions]:
                diffs.append((d[pos], chrm, strand, int(pos)))
    diffs.sort(reverse=True)
    regions = []
    for _, chrm, strand, pos in diffs[:num_regions]:
        start = max(0, pos - num_bases // 2)
        regions.append(RegionData(chrm, strand, start,
                                  start + num_bases).add_reads(reads_index))
    return regions


def mean_levels_genome_centric(cs_reads, chrm, chrm_len, device: DeviceLike,
                               fasta=None) -> torch.Tensor:
    """Each genome position's mean level over the reads covering it,
    float64 on ``device`` (NaN where none does; reference:
    tombo/tombo_helper.py:1661-1676).  The reads are added one after
    another, in the order numpy adds them, so the sums are bitwise."""
    dev = resolve_device(device)
    sums = torch.zeros(chrm_len, dtype=torch.float64, device=dev)
    cov = torch.zeros(chrm_len, dtype=torch.int64, device=dev)
    for r in cs_reads:
        try:
            vals = load_read_levels(r, device=dev, fasta=fasta,
                                    chrm=chrm).tensor(dev)
        except (OSError, KeyError, TomboError):
            continue
        if r.strand == "-":
            vals = vals.flip(0)
        sums[r.start:r.start + vals.shape[0]] += vals
        cov[r.start:r.start + vals.shape[0]] += 1
    return sums / cov


# ------------------------------------------------------------- k-mer levels

def kmer_levels(reads_index, kmer_width=2, num_reads=100, read_mean=False,
                rng=None, num_kmer_threshold=1, device: DeviceLike = None,
                fasta=None) -> Dict[str, List[float]]:
    """{k-mer: levels} of up to ``num_reads`` reads in an order shuffled
    with ``rng`` (default ``np.random.default_rng(0)``): each k-mer's
    level is the mean of its last base (reference:
    tombo/_plot_commands.py:451-560).  A read's k-mers seen fewer than
    ``num_kmer_threshold`` times are left out; with ``read_mean`` each
    read gives one mean a k-mer, and a read with any k-mer under the
    threshold is left out.  The levels come from the device means where
    a re-squiggle left them on ``device`` (their sequence from
    ``fasta``), else from the files; the grouping is a stable sort on
    ``device``, and read means are numpy's."""
    dev = resolve_device(device)
    reads = list(reads_index.iter_reads())
    chrm_of = _chrm_of(reads_index)
    (rng or np.random.default_rng(0)).shuffle(reads)
    kmer_ids: Dict[str, int] = {}
    vals, ids = [], []
    mean_levels: Dict[str, List[float]] = {}
    n_parsed = 0
    k = kmer_width
    for r_data in reads:
        try:
            rl = load_read_levels(r_data, with_seq=True, device=dev,
                                  fasta=fasta, chrm=chrm_of[id(r_data)])
        except (OSError, KeyError, TomboError):
            continue
        seq = rl.seq
        r_ids = np.array([kmer_ids.setdefault(seq[i:i + k], len(kmer_ids))
                          for i in range(len(seq) - k + 1)], np.int64)
        counts = np.bincount(r_ids, minlength=len(kmer_ids))
        seen = counts > 0
        if read_mean and num_kmer_threshold > 1 and np.any(
                counts[seen] < num_kmer_threshold):
            continue
        keep = counts[r_ids] >= num_kmer_threshold
        if read_mean:
            host = rl.tensor(torch.device("cpu")).numpy()[k - 1:]
            names = list(kmer_ids)
            for kid in dict.fromkeys(r_ids[keep].tolist()):
                mean_levels.setdefault(names[kid], []).append(
                    float(np.mean(host[r_ids == kid])))
        elif r_ids.shape[0]:
            vals.append(rl.tensor(dev)[k - 1:][
                torch.from_numpy(keep).to(dev)])
            ids.append(r_ids[keep])
        n_parsed += 1
        if n_parsed >= num_reads:
            break
    if read_mean:
        levels = mean_levels
    elif ids and sum(i.shape[0] for i in ids):
        all_ids = np.concatenate(ids)
        order = torch.sort(torch.from_numpy(all_ids).to(dev),
                           stable=True).indices
        grouped = torch.cat(vals)[order].cpu().numpy()
        counts = np.bincount(all_ids, minlength=len(kmer_ids))
        parts = np.split(grouped, np.cumsum(counts)[:-1])
        levels = {km: parts[kid].tolist() for km, kid in kmer_ids.items()
                  if counts[kid]}
    else:
        levels = {}
    if not levels:
        raise TomboError("No valid reads for k-mer distribution plot.")
    return levels


def plot_kmer_dist(reads_index, pdf_fn, kmer_width=2, num_reads=100,
                   read_mean=False, rng=None, num_kmer_threshold=1,
                   dont_plot=False, data_fn=None, device: DeviceLike = None,
                   fasta=None):
    """``kmer_levels`` as one violin a k-mer to a PDF; ``data_fn`` pickles
    the levels (the JAX package's substitute for the reference's
    ``--r-data-filename`` R workspace), ``dont_plot`` writes only that."""
    levels = kmer_levels(reads_index, kmer_width, num_reads, read_mean,
                         rng, num_kmer_threshold, device, fasta)
    if data_fn is not None:
        import pickle
        with open(data_fn, "wb") as fp:
            pickle.dump(levels, fp)
    if dont_plot:
        return
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    kms = sorted(levels)
    fig, ax = plt.subplots(figsize=(max(6, len(kms) * 0.3), 4))
    ax.violinplot([levels[km] for km in kms], showmedians=True)
    ax.set_xticks(np.arange(1, len(kms) + 1))
    ax.set_xticklabels(kms, rotation=90, fontsize=6)
    ax.set_ylabel("Normalized signal level")
    fig.tight_layout()
    fig.savefig(pdf_fn)
    plt.close(fig)


# ------------------------------------------------------ per-read statistics

def per_read_matrix(pr_stats, reg: RegionData, num_reads=50):
    """(sorted read ids, reads x positions matrix of per-read statistics,
    NaN where a read has none) of a region, or None where it has no
    statistic (reference: tombo/_plot_commands.py plot_per_read)."""
    blk = pr_stats.get_region_per_read_stats(
        reg.chrm, reg.strand, reg.start, reg.end, num_reads)
    if blk is None or blk.shape[0] == 0:
        return None
    read_ids = sorted(set(blk["read_id"]))
    row = {rid: i for i, rid in enumerate(read_ids)}
    mat = np.full((len(read_ids), reg.end - reg.start), np.nan)
    for rec in blk:
        mat[row[rec["read_id"]], int(rec["pos"]) - reg.start] = rec["stat"]
    return read_ids, mat


def plot_per_read_stats(pr_stats, regions, pdf_fn, num_reads=50,
                        box_center=False):
    """One heat map page of ``per_read_matrix`` a region; ``box_center``
    outlines the central base (reference: tombo/_option_parsers.py:
    490-492)."""
    import matplotlib.pyplot as plt
    with _new_pdf(pdf_fn) as pdf:
        for reg in regions:
            data = per_read_matrix(pr_stats, reg, num_reads)
            if data is None:
                continue
            mat = data[1]
            fig, ax = plt.subplots(figsize=(10, 3.5))
            im = ax.imshow(mat, aspect="auto", interpolation="nearest",
                           cmap="RdBu")
            if box_center:
                from matplotlib.patches import Rectangle
                c = (reg.end - reg.start) // 2
                ax.add_patch(Rectangle(
                    (c - 0.5, -0.5), 1.0, mat.shape[0], fill=False,
                    edgecolor="black", lw=1.2))
            fig.colorbar(im, ax=ax, label="per-read statistic")
            ax.set_title("%s:%d-%d (%s)" % (
                reg.chrm, reg.start + 1, reg.end, reg.strand), fontsize=8)
            ax.set_xlabel("Position")
            ax.set_ylabel("Reads")
            fig.tight_layout()
            pdf.savefig(fig)
            plt.close(fig)


# ------------------------------------------------- motif with statistics

def _motif_site_start(fasta, motif, chrm, pos, strand):
    """Start of the motif occurrence whose modified base is ``pos`` on
    ``strand``, else None."""
    if strand == "+":
        m_start = pos - (motif.mod_pos - 1)
        seq = fasta.get_seq(chrm, max(0, m_start),
                            m_start + motif.motif_len, error_end=False)
    else:
        m_start = pos - (motif.motif_len - motif.mod_pos)
        seq = rev_comp(fasta.get_seq(
            chrm, max(0, m_start), m_start + motif.motif_len,
            error_end=False))
    if m_start < 0 or len(seq) < motif.motif_len:
        return None
    return m_start if motif.motif_pat.match(seq) else None


def motif_stat_offsets(stats, fasta, motif, num_statistics=200,
                       num_context=5):
    """(motif sites, {offset from the motif start: statistics}): the first
    ``num_statistics`` most significant sites that are a motif's
    modified base, as (chrm, strand, pos, motif start), and the
    statistics at each offset within the motif +/- ``num_context`` around
    them, counted along the motif (reference:
    tombo/_plot_commands.py:2034-2130)."""
    width = motif.motif_len + 2 * num_context
    motif_sites = []
    for pos_stat in stats.most_signif_stats:
        chrm = stats._get_chrm_name(pos_stat)
        strand = pos_stat["strand"].decode()
        pos = int(pos_stat["pos"])
        m_start = _motif_site_start(fasta, motif, chrm, pos, strand)
        if m_start is None:
            continue
        motif_sites.append((chrm, strand, pos, m_start))
        if len(motif_sites) >= num_statistics:
            break
    by_offset: Dict[int, List[float]] = {}
    for chrm, strand, pos, m_start in motif_sites:
        start = max(0, m_start - num_context)
        blk = stats.get_reg_stats(chrm, strand, start, start + width)
        if blk is None:
            continue
        for rec in blk:
            off = int(rec["pos"]) - m_start
            if strand == "-":
                off = motif.motif_len - 1 - off
            by_offset.setdefault(off, []).append(float(rec[stats.stat_slot]))
    return motif_sites, by_offset


def plot_motif_with_stats(reads_index, fasta, motif, stats_fn, pdf_fn,
                          num_regions=10, num_context=5,
                          num_statistics=200, num_reads=50,
                          overplot_thresh=50,
                          overplot_type="Downsample",
                          model=None, alt_model=None):
    """Signal at the ``num_regions`` most significant motif sites, then a
    page of ``motif_stat_offsets`` boxplots (reference:
    tombo/_plot_commands.py:2034-2130 ``plot_motif_centered_signif``)."""
    import matplotlib.pyplot as plt
    from ..output.text import load_stats_file

    stats = load_stats_file(stats_fn)
    motif_sites, by_offset = motif_stat_offsets(
        stats, fasta, motif, num_statistics, num_context)
    if not motif_sites:
        raise TomboError(
            "No most-significant sites match the provided motif.")
    width = motif.motif_len + 2 * num_context
    with _new_pdf(pdf_fn) as pdf:
        for chrm, strand, pos, m_start in motif_sites[:num_regions]:
            start = max(0, m_start - num_context)
            reg = RegionData(chrm, strand, start,
                             start + width).add_reads(reads_index)
            fig, ax = plt.subplots(figsize=(10, 3.5))
            plot_region_signal(ax, reg, fasta, num_reads,
                               overplot_thresh, overplot_type,
                               model=model, alt_model=alt_model)
            ax.set_ylabel("Normalized signal")
            fig.tight_layout()
            pdf.savefig(fig)
            plt.close(fig)
        if by_offset:
            offs = sorted(by_offset)
            fig, ax = plt.subplots(figsize=(10, 3.5))
            ax.boxplot([by_offset[o] for o in offs], positions=offs,
                       manage_ticks=False, showfliers=False)
            ax.axvspan(-0.5, motif.motif_len - 0.5, color="#ffdd55",
                       alpha=0.25)
            ax.set_xlabel("Offset from motif start (motif shaded)")
            ax.set_ylabel(stats.stat_slot)
            ax.set_title("%s (%d motif sites)" % (motif.raw_motif,
                                                  len(motif_sites)),
                         fontsize=9)
            fig.tight_layout()
            pdf.savefig(fig)
            plt.close(fig)


# --------------------------------------------------------------- clustering

def _ward_update(d_xi, d_yi, d_xy, n_x, n_y, n_i):
    """Lance-Williams update of Ward's distance, in scipy's operation
    order (scipy/cluster/_hierarchy_distance_update.pxi ``_ward``)."""
    t = 1.0 / (n_x + n_y + n_i)
    return np.sqrt((n_i + n_x) * t * d_xi * d_xi +
                   (n_i + n_y) * t * d_yi * d_yi -
                   n_i * t * d_xy * d_xy)


def ward_linkage(dists: np.ndarray) -> np.ndarray:
    """Ward linkage of a square Euclidean distance matrix, as
    ``scipy.cluster.hierarchy.linkage(obs, "ward")`` builds it: the
    nearest-neighbour chain (preferring the chain's previous cluster, and
    else the lowest index, on a tie), Lance-Williams updates, the merges
    stably sorted by height, then relabelled through a union-find with
    the smaller cluster id on the left.  Returns scipy's (n - 1, 4)
    matrix."""
    n = dists.shape[0]
    dist = np.array(dists, np.float64)
    size = np.ones(n, np.int64)
    z = np.empty((n - 1, 4))
    chain: List[int] = []
    for k in range(n - 1):
        if not chain:
            chain = [int(np.flatnonzero(size > 0)[0])]
        while True:
            x = chain[-1]
            if len(chain) > 1:
                y = chain[-2]
                current_min = dist[x, y]
            else:
                current_min = np.inf
            row = np.where(size > 0, dist[x], np.inf)
            row[x] = np.inf
            m = row.min()
            if m < current_min:
                current_min = m
                y = int(np.argmax(row == m))
            if len(chain) > 1 and y == chain[-2]:
                break
            chain.append(y)
        del chain[-2:]
        x, y = min(x, y), max(x, y)
        n_x, n_y = size[x], size[y]
        z[k] = (x, y, current_min, n_x + n_y)
        size[x] = 0
        size[y] = n_x + n_y
        others = np.flatnonzero(size > 0)
        others = others[others != y]
        new = _ward_update(dist[others, x], dist[others, y], current_min,
                           n_x, n_y, size[others])
        dist[others, y] = new
        dist[y, others] = new
    z = z[np.argsort(z[:, 2], kind="mergesort")]
    parent = np.arange(2 * n - 1)

    def find(c):
        root = c
        while parent[root] != root:
            root = parent[root]
        while parent[c] != root:
            parent[c], c = root, parent[c]
        return root
    for i in range(n - 1):
        xr, yr = find(int(z[i, 0])), find(int(z[i, 1]))
        z[i, 0], z[i, 1] = min(xr, yr), max(xr, yr)
        parent[xr] = parent[yr] = n + i
    return z


def leaves_list(z: np.ndarray) -> np.ndarray:
    """The leaves of a linkage matrix in pre-order, left first (scipy's
    ``leaves_list``)."""
    n = z.shape[0] + 1
    out, stack = [], [2 * n - 2]
    while stack:
        c = stack.pop()
        if c < n:
            out.append(c)
        else:
            stack.append(int(z[c - n, 1]))
            stack.append(int(z[c - n, 0]))
    return np.array(out, np.int64)


def slide_align(mat: torch.Tensor, ext: int) -> torch.Tensor:
    """Each row (a trace over the core window widened by ``ext`` a side)
    cut to the core window at the offset of least squared distance to
    the rows' median core trace, the lowest offset on a tie: every
    offset of every row at once."""
    w = mat.shape[1] - 2 * ext
    srt = torch.sort(mat[:, ext:ext + w], dim=0).values
    n = mat.shape[0]
    med = (srt[(n - 1) // 2] + srt[n // 2]) / 2
    windows = mat.unfold(1, w, 1)
    diff = windows - med
    best = (diff * diff).sum(-1).argmin(1)
    return windows[torch.arange(n, device=mat.device), best]


def cluster_order(mat: torch.Tensor) -> torch.Tensor:
    """Ward order of the rows of ``mat``: their Euclidean distance matrix
    on its device, the linkage and leaf order on the host."""
    diff = mat[:, None, :] - mat[None, :, :]
    dists = (diff * diff).sum(-1).sqrt().cpu().numpy()
    return torch.from_numpy(leaves_list(ward_linkage(dists)))


def cluster_traces(regions, reads_index, ctrl_reads_index=None,
                   slide_span=0, device: DeviceLike = None
                   ) -> Dict[str, np.ndarray]:
    """{region text: its traces in Ward order} of the regions given as
    ``get_most_signif_regions`` gives them (reference:
    tombo/_plot_commands.py:2122-2268).  A region's traces are the base
    levels of the sample's and the control's reads that cover it all
    (from ``RegionData.get_base_levels(device)``), rows with a NaN left
    out; with ``slide_span`` each is first aligned to the median trace
    at the best of +/- ``slide_span`` offsets.  Regions with fewer than
    three traces are left out."""
    dev = resolve_device(device)
    ext = max(0, int(slide_span))
    saved = {}
    for chrm, start, end, strand, _rid, txt in regions:
        traces = []
        for idx in (reads_index, ctrl_reads_index):
            if idx is None:
                continue
            reg = RegionData(chrm, strand, max(0, start - ext),
                             end + ext).add_reads(
                idx, require_full_span=True)
            traces.append(reg.get_base_levels(dev).T)
        if not traces:
            continue
        mat = np.concatenate(traces, axis=0)
        mat = torch.from_numpy(mat[~np.isnan(mat).any(axis=1)]).to(dev)
        if ext > 0 and mat.shape[0] >= 3:
            mat = slide_align(mat, ext)
        if mat.shape[0] < 3:
            continue
        saved[txt] = mat[cluster_order(mat).to(dev)].cpu().numpy()
    return saved


def cluster_most_significant(reads_index, ctrl_reads_index, stats_fn,
                             fasta, pdf_fn, num_regions=10, num_bases=21,
                             slide_span=0, data_fn=None,
                             device: DeviceLike = None):
    """``cluster_traces`` at a statistics file's most significant regions,
    one heat map page a region; ``data_fn`` pickles the ordered matrices
    (the JAX package's substitute for ``--r-data-filename``)."""
    from ..output.text import load_stats_file
    regions = load_stats_file(stats_fn).get_most_signif_regions(
        num_bases, num_regions)
    saved = cluster_traces(regions, reads_index, ctrl_reads_index,
                           slide_span, device)
    import matplotlib.pyplot as plt
    with _new_pdf(pdf_fn) as pdf:
        for txt, mat in saved.items():
            fig, ax = plt.subplots(figsize=(8, 4))
            im = ax.imshow(mat, aspect="auto", cmap="viridis")
            fig.colorbar(im, ax=ax, label="level")
            ax.set_title(txt, fontsize=8)
            fig.tight_layout()
            pdf.savefig(fig)
            plt.close(fig)
    if data_fn is not None:
        import pickle
        with open(data_fn, "wb") as fp:
            pickle.dump(saved, fp)
