"""Ground-truth accuracy: (statistic, label) pairs, ROC and
precision-recall rates, and their PDF (counterpart of
``tombo_tpu/plot/accuracy.py``; reference: tombo/tombo_stats.py:2377-2533,
tombo/_plot_commands.py:60-450).

The rates run as tensor operations on ``device`` (default the card): a
stable sort of the pairs by label and then by statistic (the order of
Python's ``sorted`` on (statistic, label) tuples, ``False`` first on a
tied statistic), integer cumulative sums of the labels, and a gather at
the plotted points, whose indices numpy's ``linspace`` picks on the host
(``torch.linspace`` rounds them differently).  The AUC and mean average
precision take their terms on the device and their sums over the
``ROC_PLOT_POINTS`` terms with numpy, in numpy's order, so every number
is bitwise the JAX package's at float64.  A NaN statistic sorts after
every other (Python's ``sorted`` gives it no defined place).

Matching statistics to motifs or to ground-truth locations stays on the
host, as in the JAX package; so does the adapter that feeds per-read
statistics files to the same machinery.  ``plot_roc_curves`` renders
with ``matplotlib``, imported inside it.
"""
from __future__ import annotations

import sys
from typing import Optional

import numpy as np
import torch

from .. import config
from ..device import DeviceLike, resolve_device
from ..errors import TomboError
from ..io.bed import parse_locs_file  # noqa: F401  (the plot API's name)
from ..seq import rev_comp

ROC_PLOT_POINTS = config.ROC_PLOT_POINTS


def _as_tensor(x, device: Optional[torch.device] = None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


def _picks(n: int, num: int) -> torch.Tensor:
    """``np.linspace(0, n - 1, num).astype(np.int64)``: the plotted
    points' indices, truncated as numpy truncates them."""
    return torch.from_numpy(np.linspace(0, n - 1, num).astype(np.int64))


def compute_accuracy_rates(stat_has_mod,
                           num_plot_points: int = ROC_PLOT_POINTS,
                           device: DeviceLike = None):
    """(true positive rate, false positive rate, precision) at the
    plotted points of labels in statistic order (reference:
    tombo/tombo_stats.py:2384-2404), float64 tensors on ``device`` (a
    tensor's own device where ``stat_has_mod`` is one)."""
    dev = (stat_has_mod.device if isinstance(stat_has_mod, torch.Tensor)
           else resolve_device(device))
    lab = _as_tensor(stat_has_mod, dev).to(torch.int64)
    n = lab.shape[0]
    tp_cum = torch.cumsum(lab, 0)
    fp_cum = torch.arange(1, n + 1, device=dev) - tp_cum
    idx = _picks(n, num_plot_points).to(dev)
    tp_rate = tp_cum[idx].double() / tp_cum[-1].double()
    fp_rate = fp_cum[idx].double() / fp_cum[-1].double()
    pidx = _picks(n, num_plot_points + 1)[1:].to(dev)
    precision = tp_cum[pidx].double() / (pidx + 1).double()
    return tp_rate, fp_rate, precision


def compute_auc(tp_rate, fp_rate) -> np.float64:
    """Area under the ROC curve (reference: tombo/tombo_stats.py:
    2377-2378): terms on the rates' device, their sum with numpy."""
    tp = _as_tensor(tp_rate)
    fp = _as_tensor(fp_rate, tp.device)
    terms = tp[:-1] * (fp[1:] - fp[:-1])
    return np.sum(terms.cpu().numpy())


def compute_mean_avg_precision(tp_rate, precision) -> np.float64:
    """Mean average precision (reference: tombo/tombo_stats.py:
    2380-2382): terms on the rates' device, their sum with numpy."""
    tp = _as_tensor(tp_rate)
    prec = _as_tensor(precision, tp.device)
    one = tp.new_ones(1)
    recall = torch.cat([one * 0, tp, one])
    terms = (recall[1:] - recall[:-1]) * torch.cat([one * 0, prec])
    return np.sum(terms.cpu().numpy())


def accuracy_order(stats: torch.Tensor, labels: torch.Tensor
                   ) -> torch.Tensor:
    """Indices putting (statistic, label) pairs in the order of Python's
    ``sorted`` on the tuples: a stable sort by label, then a stable sort
    by statistic.  ``-0.0`` is made ``0.0`` first (Python compares them
    equal; a radix sort does not)."""
    by_label = torch.sort(labels.to(torch.uint8), stable=True).indices
    by_stat = torch.sort((stats.double() + 0.0)[by_label],
                         stable=True).indices
    return by_label[by_stat]


def pairs_to_tensors(mod_stats, device: torch.device):
    """(float64 statistics, bool labels) on ``device`` from a list of
    (statistic, label) tuples or from a (statistics, labels) pair of
    arrays or tensors."""
    if isinstance(mod_stats, tuple) and len(mod_stats) == 2 and \
            hasattr(mod_stats[0], "shape"):
        stats, labels = mod_stats
        return (_as_tensor(stats, device).double(),
                _as_tensor(labels, device).bool())
    n = len(mod_stats)
    stats = np.fromiter((s for s, _ in mod_stats), np.float64, n)
    labels = np.fromiter((bool(b) for _, b in mod_stats), bool, n)
    return (torch.from_numpy(stats).to(device),
            torch.from_numpy(labels).to(device))


def compute_motif_stats(stats, motif_descs, fasta, stats_per_block=None,
                        total_stats_limit=None,
                        rng: Optional[np.random.Generator] = None):
    """{name: [(statistic, whether the site matches the motif)]} over the
    sites whose base is a motif's modified base (reference:
    tombo/tombo_stats.py:2406-2456).  A block of more than
    ``stats_per_block`` sites keeps a sample of that many, drawn from
    ``rng`` (default ``np.random.default_rng(0)``)."""
    all_motif_stats = {mod_name: [] for _, mod_name in motif_descs}
    before_bases = max(m.mod_pos for m, _ in motif_descs) - 1
    after_bases = max(m.motif_len - m.mod_pos for m, _ in motif_descs)
    total = 0
    if rng is None:
        rng = np.random.default_rng(0)
    for chrm, strand, start, end, block_stats in stats:
        if strand == "+":
            seq_start = max(start - before_bases, 0)
            seq_end = end + after_bases
        else:
            seq_start = max(start - after_bases, 0)
            seq_end = end + before_bases
        reg_seq = fasta.get_seq(chrm, seq_start, seq_end, error_end=False)
        if stats_per_block is not None and \
                block_stats.shape[0] > stats_per_block:
            block_stats = block_stats[rng.choice(
                block_stats.shape[0], stats_per_block, replace=False)]
        total += block_stats.shape[0]
        slot = stats.stat_slot if hasattr(stats, "stat_slot") else "stat"
        for r_pos_stat in block_stats:
            pos = int(r_pos_stat["pos"])
            if strand == "+":
                r_pos_seq = reg_seq[pos - seq_start - before_bases:
                                    pos - seq_start + after_bases + 1]
            else:
                r_pos_seq = rev_comp(
                    reg_seq[pos - seq_start - after_bases:
                            pos - seq_start + before_bases + 1])
            if len(r_pos_seq) < before_bases + after_bases + 1:
                continue
            for motif, mod_name in motif_descs:
                if r_pos_seq[before_bases] != motif.mod_base:
                    continue
                all_motif_stats[mod_name].append((
                    r_pos_stat[slot],
                    bool(motif.motif_pat.match(
                        r_pos_seq[before_bases - motif.mod_pos + 1:]))))
        if total_stats_limit is not None and total >= total_stats_limit:
            break
    return all_motif_stats


def compute_ctrl_motif_stats(stats, ctrl_stats, motif_descs, fasta,
                             stats_per_block=None, total_stats_limit=None):
    """{name: [(statistic, is native)]} at motif sites: the sample's
    statistics labelled True, the control's at the same positions False
    (reference: tombo/tombo_stats.py:2485-2533)."""
    all_motif_stats = {mod_name: [] for _, mod_name in motif_descs}
    before_bases = max(m.mod_pos for m, _ in motif_descs) - 1
    after_bases = max(m.motif_len - m.mod_pos for m, _ in motif_descs)
    total = 0
    for chrm, strand, start, end, block_stats in stats:
        if strand == "+":
            seq_start = max(start - before_bases, 0)
            seq_end = end + after_bases
        else:
            seq_start = max(start - after_bases, 0)
            seq_end = end + before_bases
        reg_seq = fasta.get_seq(chrm, seq_start, seq_end, error_end=False)
        ctrl_block_stats = ctrl_stats.get_reg_stats(chrm, strand, start,
                                                    end)
        slot = stats.stat_slot if hasattr(stats, "stat_slot") else "stat"
        ctrl_slot = (ctrl_stats.stat_slot
                     if hasattr(ctrl_stats, "stat_slot") else slot)
        for motif, mod_name in motif_descs:
            if strand == "+":
                mod_poss = np.array(
                    [m.start() + motif.mod_pos - 1
                     for m in motif.motif_pat.finditer(reg_seq)],
                    dtype=np.int64) + seq_start
            else:
                mod_poss = np.array(
                    [m.start() + motif.motif_len - motif.mod_pos
                     for m in motif.rev_comp_pat.finditer(reg_seq)],
                    dtype=np.int64) + seq_start
            for r_pos_stat in block_stats[
                    np.isin(block_stats["pos"], mod_poss)]:
                all_motif_stats[mod_name].append((r_pos_stat[slot], True))
                total += 1
            if ctrl_block_stats is not None:
                for r_pos_stat in ctrl_block_stats[
                        np.isin(ctrl_block_stats["pos"], mod_poss)]:
                    all_motif_stats[mod_name].append(
                        (r_pos_stat[ctrl_slot], False))
                    total += 1
        if total_stats_limit is not None and total >= total_stats_limit:
            break
    return all_motif_stats


def compute_ground_truth_stats(stats, ground_truth_locs):
    """{name: [(statistic, is a modified location)]} over the sites listed
    as modified or unmodified (reference: tombo/tombo_stats.py:
    2458-2483).  ``ground_truth_locs``: (modified locations, unmodified
    locations, name), locations as ``parse_locs_file`` gives them."""
    mod_locs, unmod_locs, mod_name = ground_truth_locs
    all_stats = []
    for chrm, strand, start, end, block_stats in stats:
        cs_mod = mod_locs.get((chrm, strand), np.array([]))
        cs_unmod = unmod_locs.get((chrm, strand), np.array([]))
        b_mod = cs_mod[(cs_mod >= start) & (cs_mod < end)]
        b_unmod = cs_unmod[(cs_unmod >= start) & (cs_unmod < end)]
        valid = block_stats[np.isin(
            block_stats["pos"], np.concatenate([b_mod, b_unmod]))]
        slot = stats.stat_slot if hasattr(stats, "stat_slot") else "stat"
        all_stats.extend(zip(valid[slot], np.isin(valid["pos"], b_mod)))
    return {mod_name: all_stats}


def _iter_per_read_blocks_as_stats(pr_stats):
    """(chrm, strand, start, end, block) of every per-read block."""
    for chrm, strand, start, block_stats, _ in pr_stats.iter_per_read_blocks():
        yield chrm, strand, start, start + pr_stats.region_size, block_stats


class _PerReadStatsIterAdapter:
    """A per-read statistics file as the block iterable the motif and
    ground-truth functions read; p-values become -log10 p-values where
    ``transform_pvals``."""

    stat_slot = "stat"

    def __init__(self, pr_stats, transform_pvals: bool):
        self.pr = pr_stats
        self.transform = transform_pvals

    def __iter__(self):
        for chrm, strand, start, bs, _ in self.pr.iter_per_read_blocks():
            if self.transform:
                bs = bs.copy()
                with np.errstate(divide="ignore"):
                    bs["stat"] = -np.log10(np.maximum(bs["stat"], 1e-50))
            yield (chrm, strand, start, start + self.pr.region_size, bs)

    def get_reg_stats(self, chrm, strand, start, end):
        """Records with the (pos, stat) fields of a statistics block over
        [start, end), so the control ROC runs on per-read files too."""
        bs = self.pr.get_region_per_read_stats(chrm, strand, start, end)
        if bs is None or not self.transform:
            return bs
        bs = bs.copy()
        with np.errstate(divide="ignore"):
            bs["stat"] = -np.log10(np.maximum(
                bs["stat"].astype(np.float64), 1e-50))
        return bs


def prep_accuracy_rates(all_motif_stats, verbose: bool = True,
                        device: DeviceLike = None):
    """{name: (tp rate, fp rate, precision, AUC)} of each non-empty set of
    (statistic, label) pairs, numpy float64 (reference:
    tombo/_plot_commands.py:60-82); a set is a list of tuples or a
    (statistics, labels) pair of arrays or tensors.  The sort and the
    rates run on ``device`` (default the card)."""
    dev = resolve_device(device)
    curves = {}
    for mod_name, mod_stats in all_motif_stats.items():
        stats, labels = pairs_to_tensors(mod_stats, dev)
        if stats.shape[0] == 0:
            continue
        tp, fp, prec = compute_accuracy_rates(
            labels[accuracy_order(stats, labels)])
        auc = compute_auc(tp, fp)
        mean_ap = compute_mean_avg_precision(tp, prec)
        if verbose:
            sys.stderr.write("      %-30s AUC %.4f  mean AP %.4f\n" %
                             (mod_name, auc, mean_ap))
        curves[mod_name] = (tp.cpu().numpy(), fp.cpu().numpy(),
                            prec.cpu().numpy(), auc)
    if not curves:
        raise TomboError(
            "No provided statistics contain any valid sites overlapping "
            "ground truth data.")
    return curves


def plot_roc_curves(curves, pdf_fn):
    """ROC and precision-recall panels of ``prep_accuracy_rates``'s
    curves, to a PDF (reference: R_scripts/plotROC.R)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax_roc, ax_pr) = plt.subplots(1, 2, figsize=(10, 4))
    for mod_name, (tp, fp, prec, auc) in curves.items():
        ax_roc.plot(fp, tp, label="%s (AUC %.3f)" % (mod_name, auc))
        ax_pr.plot(tp, prec, label=mod_name)
    ax_roc.plot([0, 1], [0, 1], "k--", lw=0.5)
    ax_roc.set_xlabel("False positive rate")
    ax_roc.set_ylabel("True positive rate")
    ax_roc.set_title("ROC")
    ax_roc.legend(fontsize=7)
    ax_pr.set_xlabel("Recall")
    ax_pr.set_ylabel("Precision")
    ax_pr.set_title("Precision-Recall")
    fig.tight_layout()
    fig.savefig(pdf_fn)
    plt.close(fig)
