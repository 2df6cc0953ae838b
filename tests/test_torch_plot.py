"""The port's ``plot`` data functions and commands held against the JAX
package's on the CPU, at float64.

Two directories of reads on one 2.5 kb reference (12 x 400 bases each,
as tests/test_plot.py builds them) are re-squiggled by the JAX command
line, then de novo statistics (and per-read statistics) are written for
each.  Held equal: the accuracy rates, AUC and mean average precision
(bitwise, ties in the statistic included), the motif, control and
ground-truth (statistic, label) lists, the region selections under the
same generator, the signal data each overplot type draws and the model
levels (captured from the JAX renderer's matplotlib calls), the
per-read matrices and statistic-by-offset lists, the k-mer level and
cluster pickles, the max-difference regions, and the Ward order against
scipy on tie-free data.  Every ``plot`` subcommand of the port writes a
PDF."""
import importlib
import os
import pickle
import random

import numpy as np
import pytest
import torch

from tombo_tpu import testing as j_testing
from tombo_tpu.io.fasta import Fasta as JFasta
from tombo_tpu.io.index import ReadsIndex as JIndex
from tombo_tpu.io.model_io import AltModel as JAltModel
from tombo_tpu.io.model_io import KmerModel as JKmerModel
from tombo_tpu.output.text import load_stats_file as j_load_stats
from tombo_tpu.output.text import parse_motif_descs as j_motif_descs
from tombo_tpu.plot import accuracy as j_acc
from tombo_tpu.plot import signal as j_sig
from tombo_tpu.seq import TomboMotif as JMotif
from tombo_tpu.stats.files import PerReadStats as JPerRead
from tombo_tpu.stats.region import RegionData as JRegion
from tombo_tpu_torch.cli import main as t_cli
from tombo_tpu_torch.io.fasta import Fasta as TFasta
from tombo_tpu_torch.io.index import ReadsIndex as TIndex
from tombo_tpu_torch.io.model_io import AltModel as TAltModel
from tombo_tpu_torch.io.model_io import KmerModel as TKmerModel
from tombo_tpu_torch.output.text import load_stats_file as t_load_stats
from tombo_tpu_torch.output.text import parse_motif_descs as t_motif_descs
from tombo_tpu_torch.plot import accuracy as t_acc
from tombo_tpu_torch.plot import signal as t_sig
from tombo_tpu_torch.seq import TomboMotif as TMotif
from tombo_tpu_torch.stats import device_levels
from tombo_tpu_torch.stats.files import PerReadStats as TPerRead
from tombo_tpu_torch.stats.region import RegionData as TRegion

j_cli = importlib.import_module("tombo_tpu.cli.main")


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("plot_ds"))
    fasta, reads, samp = j_testing.make_synthetic_dataset(
        tmp, n_reads=12, seed=17, read_len=400, ref_len=2500)
    ref = os.path.join(tmp, "reference.fasta")
    ctrl = os.path.join(tmp, "ctrl")
    os.makedirs(ctrl)
    rng = np.random.default_rng(18)
    model = JKmerModel.load_default("DNA")
    for i in range(12):
        read = j_testing.simulate_read(rng, fasta, model, read_len=400,
                                       read_id="ctrl_%04d" % i)
        j_testing.write_synthetic_fast5(
            os.path.join(ctrl, read.read_id + ".fast5"), read)
    out = {}
    for name, d in (("samp", samp), ("ctrl", ctrl)):
        assert j_cli.main(["resquiggle", d, ref, "--overwrite", "--dna",
                           "--allow-exact-aligner", "-q"]) == 0
        bn = os.path.join(tmp, name)
        assert j_cli.main(["detect_modifications", "de_novo", d,
                           "--statistics-file-basename", bn,
                           "--per-read-statistics-basename", bn,
                           "--reference", ref, "-q"]) == 0
        out[name] = (d, bn + ".tombo.stats", bn + ".tombo.per_read_stats")
    return dict(tmp=tmp, ref=ref, samp=out["samp"], ctrl=out["ctrl"])


def _pdf(fn):
    with open(fn, "rb") as fp:
        return fp.read(5) == b"%PDF-"


# ------------------------------------------------------------ accuracy

def _pairs(case):
    rng = np.random.default_rng(7)
    if case == "ties":
        return [(float(np.round(s, 1)), bool(b)) for s, b in zip(
            rng.normal(0, 1, 3000), rng.random(3000) < 0.3)]
    if case == "signed_zeros":
        s = rng.choice([-0.0, 0.0, 1.0, -1.0], 500)
        return list(zip(s, rng.random(500) < 0.5))
    if case == "float32_numpy":
        s = rng.normal(0, 1, 5000).astype(np.float32)
        return list(zip(s, rng.random(5000) < 0.6))
    if case == "few":
        return [(0.3, True), (0.1, False), (0.3, False), (0.2, True),
                (0.5, True)]
    s = rng.normal(0, 1, 120000)
    return list(zip(s, rng.random(120000) < (s < 0)))


@pytest.mark.parametrize("case", ["ties", "signed_zeros", "float32_numpy",
                                  "few", "many"])
def test_accuracy_rates_bitwise(case):
    """Rates, AUC and mean AP bitwise the JAX function's at float64; also
    given as arrays instead of tuples."""
    pairs = _pairs(case)
    want = j_acc.prep_accuracy_rates({"m": pairs}, verbose=False)["m"]
    got = t_acc.prep_accuracy_rates({"m": pairs}, verbose=False,
                                    device="cpu")["m"]
    arrs = (np.array([s for s, _ in pairs], np.float64),
            np.array([b for _, b in pairs]))
    got2 = t_acc.prep_accuracy_rates({"m": arrs}, verbose=False,
                                     device="cpu")["m"]
    for g in (got, got2):
        for a, b in zip(g[:3], want[:3]):
            assert a.dtype == b.dtype == np.float64
            np.testing.assert_array_equal(a, b)
        assert g[3] == want[3]
    assert t_acc.compute_mean_avg_precision(got[0], got[2]) == \
        j_acc.compute_mean_avg_precision(want[0], want[2])


def test_accuracy_rates_need_a_site():
    with pytest.raises(Exception, match="No provided statistics"):
        t_acc.prep_accuracy_rates({"m": []}, device="cpu")


def test_motif_control_and_ground_truth_pairs(ds, tmp_path):
    """compute_motif_stats (with a per-block sample drawn from the same
    generator), compute_ctrl_motif_stats and compute_ground_truth_stats
    give the JAX lists, for statistics files and per-read files."""
    jf, tf = JFasta(ds["ref"]), TFasta.read(ds["ref"])
    desc = "CG:1:CpG::A:1:A"
    jd, td = j_motif_descs(desc), t_motif_descs(desc)
    js, ts = j_load_stats(ds["samp"][1]), t_load_stats(ds["samp"][1])
    jc, tc = j_load_stats(ds["ctrl"][1]), t_load_stats(ds["ctrl"][1])
    for per_block, limit in ((None, None), (50, 120)):
        want = j_acc.compute_motif_stats(js, jd, jf, per_block, limit,
                                         rng=np.random.default_rng(3))
        got = t_acc.compute_motif_stats(ts, td, tf, per_block, limit,
                                        rng=np.random.default_rng(3))
        assert got == want and want["CpG"] and want["A"]
    assert t_acc.compute_ctrl_motif_stats(ts, tc, td, tf) == \
        j_acc.compute_ctrl_motif_stats(js, jc, jd, jf)
    jp = j_acc._PerReadStatsIterAdapter(JPerRead(ds["samp"][2]), True)
    tp = t_acc._PerReadStatsIterAdapter(TPerRead(ds["samp"][2]), True)
    want = j_acc.compute_motif_stats(jp, jd, jf)
    assert t_acc.compute_motif_stats(tp, td, tf) == want and want["CpG"]
    jpc = j_acc._PerReadStatsIterAdapter(JPerRead(ds["ctrl"][2]), True)
    tpc = t_acc._PerReadStatsIterAdapter(TPerRead(ds["ctrl"][2]), True)
    assert t_acc.compute_ctrl_motif_stats(tp, tpc, td, tf) == \
        j_acc.compute_ctrl_motif_stats(jp, jpc, jd, jf)
    seq = jf.get_seq("chr_test")
    beds = {}
    for name, bases in (("mod", "C"), ("unmod", "AT")):
        beds[name] = str(tmp_path / (name + ".bed"))
        with open(beds[name], "w") as fp:
            for i, b in enumerate(seq):
                if b in bases:
                    fp.write("chr_test\t%d\t%d\t.\t0\t+\n" % (i, i + 1))
                if rev_base(b) in bases:
                    fp.write("chr_test\t%d\t%d\t.\t0\t-\n" % (i, i + 1))
    gt_j = (j_acc.parse_locs_file(beds["mod"]),
            j_acc.parse_locs_file(beds["unmod"]), "C")
    gt_t = (t_acc.parse_locs_file(beds["mod"]),
            t_acc.parse_locs_file(beds["unmod"]), "C")
    want = j_acc.compute_ground_truth_stats(js, gt_j)
    got = t_acc.compute_ground_truth_stats(ts, gt_t)
    assert [(float(s), bool(b)) for s, b in got["C"]] == \
        [(float(s), bool(b)) for s, b in want["C"]] and want["C"]
    w = j_acc.prep_accuracy_rates(want, verbose=False)["C"]
    g = t_acc.prep_accuracy_rates(got, verbose=False, device="cpu")["C"]
    for a, b in zip(g, w):
        np.testing.assert_array_equal(a, b)


def rev_base(b):
    return {"A": "T", "C": "G", "G": "C", "T": "A"}.get(b, "N")


# -------------------------------------------------------------- signal

@pytest.fixture
def capture(monkeypatch):
    """Record the data the JAX renderer hands to matplotlib."""
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib.axes import Axes
    calls = []
    for name in ("plot", "boxplot", "violinplot", "fill_between",
                 "errorbar", "imshow"):
        orig = getattr(Axes, name)

        def rec(self, *a, _orig=orig, _name=name, **kw):
            calls.append((_name, a, kw))
            return _orig(self, *a, **kw)
        monkeypatch.setattr(Axes, name, rec)
    return calls


def _indices(ds):
    return (JIndex([ds["samp"][0]]), TIndex([ds["samp"][0]]),
            JIndex([ds["ctrl"][0]]), TIndex([ds["ctrl"][0]]))


def _same_regions(got, want):
    return [(r.chrm, r.strand, r.start, r.end, [x.read_id for x in r.reads])
            for r in got] == \
        [(r.chrm, r.strand, r.start, r.end, [x.read_id for x in r.reads])
         for r in want]


def test_region_selections(ds):
    ji, ti, _, _ = _indices(ds)
    assert _same_regions(t_sig.select_max_coverage_regions(ti, 3, 21),
                         j_sig.select_max_coverage_regions(ji, 3, 21))
    jf, tf = JFasta(ds["ref"]), TFasta.read(ds["ref"])
    for deep in (False, True):
        want = j_sig.select_motif_regions(
            jf, JMotif("CG", 1), ji, 4, 21, deep,
            rng=np.random.default_rng(5))
        got = t_sig.select_motif_regions(
            tf, TMotif("CG", 1), ti, 4, 21, deep,
            rng=np.random.default_rng(5))
        assert _same_regions(got, want) and len(want) == 4


@pytest.mark.parametrize("op_type", ["Downsample", "Boxplot", "Quantile",
                                     "Density"])
def test_region_signal_data_and_model_levels(ds, capture, op_type):
    """What each overplot type draws, and the standard and alternative
    model levels, equal to the JAX renderer's arrays."""
    import matplotlib.pyplot as plt
    ji, ti, _, _ = _indices(ds)
    jreg = j_sig.select_max_coverage_regions(ji, 1, 21)[0].add_reads(ji)
    treg = t_sig.select_max_coverage_regions(ti, 1, 21)[0].add_reads(ti)
    thresh = 50 if op_type == "Downsample" else 2
    fig, ax = plt.subplots()
    j_sig.plot_region_signal(
        ax, jreg, JFasta(ds["ref"]), None, thresh, op_type,
        model=JKmerModel.load_default("DNA"),
        alt_model=JAltModel.load_default("5mC", "DNA"))
    plt.close(fig)
    data = t_sig.region_signal_data(treg, None, thresh, op_type)
    drawn = {}
    for name, a, kw in capture:
        drawn.setdefault(name, []).append((a, kw))
    if op_type == "Downsample":
        assert len(data.traces) == len(drawn["plot"]) == len(treg.reads)
        for (xs, ys, _), (a, _) in zip(data.traces, drawn["plot"]):
            np.testing.assert_array_equal(xs, a[0])
            np.testing.assert_array_equal(ys, a[1])
    elif op_type == "Quantile":
        poss, qs = data.summary
        (a0, _), (a1, _) = drawn["fill_between"]
        np.testing.assert_array_equal(a0[0], poss)
        for got, want in ((qs[:, 0], a0[1]), (qs[:, 4], a0[2]),
                          (qs[:, 1], a1[1]), (qs[:, 3], a1[2]),
                          (qs[:, 2], drawn["plot"][0][0][1])):
            np.testing.assert_array_equal(got, want)
    else:
        (a, kw), = drawn["boxplot" if op_type == "Boxplot"
                         else "violinplot"]
        assert data.summary == (kw["positions"], a[0])
    models = (TKmerModel.load_default("DNA"),
              TAltModel.load_default("5mC", "DNA"))
    for (a, kw), mdl, alt in zip(drawn["errorbar"], models, (False, True)):
        means, sds = t_sig._model_levels_for_region(
            mdl, TFasta.read(ds["ref"]), treg, alt)
        np.testing.assert_array_equal(means, a[1])
        np.testing.assert_array_equal(sds, kw["yerr"])


def test_per_read_matrices_and_offsets(ds, capture, tmp_path):
    """Per-read matrices and the statistic-by-offset lists of
    motif_with_stats equal to what the JAX renderers draw."""
    regions = [JRegion("chr_test", s, 1000 - 25, 1000 + 26)
               for s in "+-"]
    random.seed(0)
    j_sig.plot_per_read_stats(JPerRead(ds["samp"][2]), regions,
                              str(tmp_path / "j.pdf"), num_reads=100)
    mats = [a[0] for name, a, _ in capture if name == "imshow"]
    tp = TPerRead(ds["samp"][2])
    got = [t_sig.per_read_matrix(tp, TRegion(r.chrm, r.strand, r.start,
                                             r.end), 100) for r in regions]
    got = [g[1] for g in got if g is not None]
    assert len(got) == len(mats) > 0
    for g, w in zip(got, mats):
        np.testing.assert_array_equal(g, w)

    capture.clear()
    ji, _, _, _ = _indices(ds)
    j_sig.plot_motif_with_stats(
        ji, JFasta(ds["ref"]), JMotif("CG", 1), ds["samp"][1],
        str(tmp_path / "m.pdf"), num_regions=1, num_context=3,
        num_statistics=60)
    (a, kw), = [(a, kw) for name, a, kw in capture if name == "boxplot"]
    sites, by_off = t_sig.motif_stat_offsets(
        t_load_stats(ds["samp"][1]), TFasta.read(ds["ref"]),
        TMotif("CG", 1), 60, 3)
    assert sorted(by_off) == list(kw["positions"])
    assert [by_off[o] for o in sorted(by_off)] == a[0] and len(sites) > 1


@pytest.mark.parametrize("extra", [
    [], ["--read-mean"], ["--num-kmer-threshold", "2"],
    ["--read-mean", "--num-kmer-threshold", "2"], ["--kmer-width", "3"]],
    ids=["levels", "read_mean", "threshold", "read_mean_threshold", "k3"])
def test_kmer_data_file_matches_jax(ds, tmp_path, extra):
    fns = [str(tmp_path / "j.pkl"), str(tmp_path / "t.pkl")]
    argv = ["plot", "kmer", ds["samp"][0], "--num-reads", "5",
            "--dont-plot", "-q"] + extra
    assert j_cli.main(argv + ["--r-data-filename", fns[0]]) == 0
    assert t_cli.main(argv + ["--r-data-filename", fns[1],
                              "--device", "cpu"]) == 0
    want, got = (pickle.load(open(fn, "rb")) for fn in fns)
    assert got == want and want


@pytest.mark.parametrize("slide_span,with_ctrl", [(0, False), (2, False),
                                                  (0, True), (3, True)])
def test_cluster_data_file_matches_jax(ds, tmp_path, slide_span,
                                       with_ctrl):
    """The clustered matrices (scipy's Ward order in the JAX package, the
    port's own linkage) equal, at slide_span 0 and > 0."""
    fns = [str(tmp_path / "j.pkl"), str(tmp_path / "t.pkl")]
    argv = ["plot", "cluster_most_significant", ds["samp"][0],
            "--statistics-filename", ds["samp"][1], "--genome-fasta",
            ds["ref"], "--num-regions", "4", "--slide-span",
            str(slide_span), "-q"]
    if with_ctrl:
        argv += ["--control-fast5-basedirs", ds["ctrl"][0]]
    assert j_cli.main(argv + ["--r-data-filename", fns[0],
                              "--pdf-filename", fns[0] + ".pdf"]) == 0
    assert t_cli.main(argv + ["--r-data-filename", fns[1], "--pdf-filename",
                              fns[1] + ".pdf", "--device", "cpu"]) == 0
    want, got = (pickle.load(open(fn, "rb")) for fn in fns)
    assert list(got) == list(want) and want
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert _pdf(fns[1] + ".pdf")


@pytest.mark.parametrize("n,dim,seed", [(3, 4, 0), (12, 21, 1),
                                        (40, 21, 2), (90, 7, 3)])
def test_ward_order_matches_scipy(n, dim, seed):
    from scipy.cluster import hierarchy
    mat = np.random.default_rng(seed).normal(0, 1, (n, dim))
    want_z = hierarchy.linkage(mat, "ward")
    got = t_sig.cluster_order(torch.from_numpy(mat)).numpy()
    np.testing.assert_array_equal(got, hierarchy.leaves_list(want_z))
    diff = mat[:, None] - mat[None]
    z = t_sig.ward_linkage(np.sqrt((diff * diff).sum(-1)))
    np.testing.assert_array_equal(z[:, [0, 1, 3]], want_z[:, [0, 1, 3]])
    np.testing.assert_allclose(z[:, 2], want_z[:, 2], rtol=1e-12)


def test_max_difference_regions_match_jax(ds, monkeypatch, tmp_path):
    """The regions the JAX command hands its renderer."""
    seen = []
    monkeypatch.setattr(j_sig, "plot_intervals",
                        lambda regions, *a, **kw: seen.append(regions))
    argv = ["plot", "max_difference", ds["samp"][0],
            "--control-fast5-basedirs", ds["ctrl"][0], "--num-regions",
            "5", "--num-bases", "15", "-q",
            "--pdf-filename", str(tmp_path / "md.pdf")]
    assert j_cli.main(argv) == 0
    _, ti, _, tc = _indices(ds)
    got = t_sig.max_difference_regions(ti, tc, 5, 15, device="cpu")
    assert _same_regions(got, seen[0]) and len(got) == 5


def test_data_from_device_means_equals_files(ds):
    """kmer_levels, max_difference_regions and cluster_traces from means
    registered as device-resident (CPU tensors of the files' means) equal
    the same functions on the files."""
    from tombo_tpu_torch.io import fast5 as f5
    _, ti, _, tc = _indices(ds)
    tf = TFasta.read(ds["ref"])
    want = (t_sig.kmer_levels(ti, 2, 5, device="cpu"),
            t_sig.max_difference_regions(ti, tc, 5, 15, device="cpu"),
            t_sig.cluster_traces(
                t_load_stats(ds["samp"][1]).get_most_signif_regions(21, 3),
                ti, tc, 2, device="cpu"))
    device_levels.clear()
    try:
        for idx in (ti, tc):
            reads = list(idx.iter_reads())
            means = [torch.from_numpy(np.array(f5.read_corrected_levels(
                r.fn, r.corr_group)[0])) for r in reads]
            width = max(m.shape[0] for m in means)
            mat = torch.stack([torch.nn.functional.pad(
                m, (0, width - m.shape[0])) for m in means])
            device_levels.register_batch(mat, [
                (r.read_id, i, m.shape[0])
                for i, (r, m) in enumerate(zip(reads, means))])
        for r in ti.iter_reads():
            r.fn = "/nonexistent/" + os.path.basename(r.fn)
        got = (t_sig.kmer_levels(ti, 2, 5, device="cpu", fasta=tf),
               t_sig.max_difference_regions(ti, tc, 5, 15, device="cpu"),
               t_sig.cluster_traces(
                   t_load_stats(ds["samp"][1]).get_most_signif_regions(
                       21, 3), ti, tc, 2, device="cpu"))
    finally:
        device_levels.clear()
    assert got[0] == want[0]
    assert _same_regions(got[1], want[1])
    assert list(got[2]) == list(want[2]) and want[2]
    for k in want[2]:
        np.testing.assert_array_equal(got[2][k], want[2][k])


def _plot_argv(name, ds, out):
    samp_dir, stats, pr_stats = ds["samp"]
    ref = ds["ref"]
    roc = ["--statistics-filenames", stats, "--motif-descriptions",
           "CG:1:CpG", "--genome-fasta", ref]
    pr_roc = ["--per-read-statistics-filenames", pr_stats,
              "--motif-descriptions", "CG:1:CpG", "--genome-fasta", ref]
    return {
        "max_coverage": [samp_dir, "--genome-fasta", ref, "--num-regions",
                         "2", "--plot-standard-model"],
        "genome_locations": [samp_dir, "--genome-locations",
                             "chr_test:1000:+", "--genome-fasta", ref,
                             "--overplot-type", "Quantile",
                             "--overplot-threshold", "2"],
        "motif_centered": [samp_dir, "--motif", "CG", "--genome-fasta", ref,
                           "--num-regions", "2", "--deepest-coverage"],
        "max_difference": [samp_dir, "--control-fast5-basedirs",
                           ds["ctrl"][0], "--num-regions", "2",
                           "--device", "cpu"],
        "most_significant": [samp_dir, "--statistics-filename", stats,
                             "--genome-fasta", ref, "--num-regions", "2",
                             "--plot-alternate-model", "5mC"],
        "per_read": ["--per-read-statistics-filename", pr_stats,
                     "--genome-locations", "chr_test:1000:+",
                     "--box-center"],
        "roc": roc + ["--device", "cpu"],
        "sample_compare_roc": roc + ["--control-statistics-filenames",
                                     ds["ctrl"][1], "--device", "cpu"],
        "per_read_roc": pr_roc + ["--device", "cpu"],
        "sample_compare_per_read_roc": pr_roc + [
            "--per-read-control-statistics-filenames", ds["ctrl"][2],
            "--device", "cpu"],
        "kmer": [samp_dir, "--num-reads", "5", "--device", "cpu"],
        "cluster_most_significant": [
            samp_dir, "--statistics-filename", stats, "--genome-fasta", ref,
            "--num-regions", "2", "--device", "cpu"],
        "motif_with_stats": [samp_dir, "--motif", "CG", "--genome-fasta",
                             ref, "--statistics-filename", stats,
                             "--num-regions", "2", "--num-context", "3",
                             "--num-statistics", "50"],
    }[name] + ["--pdf-filename", out, "-q"]


PLOTS = ["max_coverage", "genome_locations", "motif_centered",
         "max_difference", "most_significant", "per_read", "roc",
         "sample_compare_roc", "per_read_roc",
         "sample_compare_per_read_roc", "kmer", "cluster_most_significant",
         "motif_with_stats"]


@pytest.mark.parametrize("name", PLOTS)
def test_every_plot_command_writes_a_pdf(ds, tmp_path, name):
    out = str(tmp_path / (name + ".pdf"))
    assert t_cli.main(["plot", name] + _plot_argv(name, ds, out)) == 0
    assert _pdf(out)


def test_roc_command_curves_match_jax(ds, monkeypatch, tmp_path):
    """The curves the roc commands hand their renderers, both packages."""
    seen = {}
    for key, mod in (("jax", j_acc), ("port", t_acc)):
        monkeypatch.setattr(mod, "plot_roc_curves",
                            lambda c, fn, _k=key: seen.setdefault(_k, c))
    out = str(tmp_path / "r.pdf")
    argv = ["plot", "sample_compare_roc"] + \
        _plot_argv("sample_compare_roc", ds, out)
    assert j_cli.main(argv[:-5] + argv[-3:]) == 0
    assert t_cli.main(argv) == 0
    assert list(seen["port"]) == list(seen["jax"]) == ["CpG"]
    for a, b in zip(seen["port"]["CpG"], seen["jax"]["CpG"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("full_span", [False, True])
def test_add_reads_matches_jax(ds, full_span):
    """``RegionData.add_reads`` with and without ``require_full_span``,
    and for a (chromosome, strand) the index lacks, selects the JAX
    function's reads."""
    ji, ti, _, _ = _indices(ds)
    n = 0
    for chrm, strand, start, end in [("chr_test", s, a, a + w)
                                     for s in "+-" for a in (0, 700, 1500)
                                     for w in (21, 300)] + \
            [("chr_none", "+", 0, 100)]:
        want = JRegion(chrm, strand, start, end).add_reads(ji, full_span)
        got = TRegion(chrm, strand, start, end).add_reads(ti, full_span)
        assert [r.read_id for r in got.reads] == \
            [r.read_id for r in want.reads]
        n += len(want.reads)
    assert n > 0
