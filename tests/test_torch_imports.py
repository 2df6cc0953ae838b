"""The PyTorch port stands alone: no jax, nothing of tombo_tpu, and no
silent CPU fallback."""
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT_MODULES = [
    "tombo_tpu_torch", "tombo_tpu_torch.config", "tombo_tpu_torch.convert",
    "tombo_tpu_torch.device", "tombo_tpu_torch.errors",
    "tombo_tpu_torch.kernels", "tombo_tpu_torch.seq",
    "tombo_tpu_torch.testing", "tombo_tpu_torch.types",
    "tombo_tpu_torch.io.fasta", "tombo_tpu_torch.io.model_io",
    "tombo_tpu_torch.ops.banded_dp", "tombo_tpu_torch.ops.delfix",
    "tombo_tpu_torch.ops.dp", "tombo_tpu_torch.ops.normalize",
    "tombo_tpu_torch.ops.precision", "tombo_tpu_torch.ops.ref_impl",
    "tombo_tpu_torch.ops.rescale", "tombo_tpu_torch.ops.segment",
    "tombo_tpu_torch.ops.select", "tombo_tpu_torch.parallel",
    "tombo_tpu_torch.parallel.distributed", "tombo_tpu_torch.parallel.mesh",
    "tombo_tpu_torch.pipeline", "tombo_tpu_torch.pipeline.aligner",
    "tombo_tpu_torch.pipeline.batch",
    "tombo_tpu_torch.pipeline.resquiggle", "tombo_tpu_torch.io.fast5",
    "tombo_tpu_torch.io.index", "tombo_tpu_torch.stats",
    "tombo_tpu_torch.stats.detect", "tombo_tpu_torch.stats.device",
    "tombo_tpu_torch.stats.device_levels", "tombo_tpu_torch.stats.files",
    "tombo_tpu_torch.stats.kernels", "tombo_tpu_torch.stats.levels_cache",
    "tombo_tpu_torch.stats.region", "tombo_tpu_torch.stats.aggregate",
    "tombo_tpu_torch.stats.estimate", "tombo_tpu_torch.stats.estimate_device",
    "tombo_tpu_torch.stats.kde", "tombo_tpu_torch.io.bed",
    "tombo_tpu_torch._version", "tombo_tpu_torch.native",
    "tombo_tpu_torch.filters", "tombo_tpu_torch.pipeline.ingest",
    "tombo_tpu_torch.pipeline.runner", "tombo_tpu_torch.cli",
    "tombo_tpu_torch.cli.main", "tombo_tpu_torch.__main__",
    "tombo_tpu_torch.output", "tombo_tpu_torch.output.text",
    "tombo_tpu_torch.preprocess", "tombo_tpu_torch.plot",
    "tombo_tpu_torch.plot.accuracy", "tombo_tpu_torch.plot.signal",
    "tombo_tpu_torch.plot.cli", "tombo_tpu_torch.pipeline.event_resquiggle",
]


def test_port_source_names_no_jax_no_jax_package_and_no_scipy():
    """No module of the port imports jax, tombo_tpu or scipy, at the top
    or inside a function."""
    bad = re.compile(
        r"^\s*(from|import)\s+(jax|jaxlib|tombo_tpu|scipy)\b(?!_)")
    hits = []
    for root, _, fns in os.walk(os.path.join(ROOT, "tombo_tpu_torch")):
        for fn in fns:
            if fn.endswith(".py"):
                path = os.path.join(root, fn)
                hits += [(path, ln) for ln in open(path) if bad.match(ln)]
    assert not hits


def test_port_imports_no_jax_and_no_jax_package():
    code = textwrap.dedent("""
        import importlib, sys
        for m in %r:
            importlib.import_module(m)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "tombo_tpu",
                                            "scipy"))
        print(",".join(bad))
    """ % (PORT_MODULES,))
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", out.stdout


def test_port_imports_no_h5py():
    """h5py is imported only inside the functions that open an HDF5 file:
    importing every module of the port loads none of it."""
    code = textwrap.dedent("""
        import importlib, sys
        for m in %r:
            importlib.import_module(m)
        print("h5py" in sys.modules)
    """ % (PORT_MODULES,))
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_port_source_imports_h5py_only_inside_functions():
    """No module of the port imports h5py at its top level (the JAX
    package's text output, filters and preprocess modules do)."""
    top = re.compile(r"^(from|import)\s+h5py\b")
    hits = []
    for root, _, fns in os.walk(os.path.join(ROOT, "tombo_tpu_torch")):
        for fn in fns:
            if fn.endswith(".py"):
                path = os.path.join(root, fn)
                hits += [(path, ln) for ln in open(path) if top.match(ln)]
    assert not hits
    nested = [os.path.join(ROOT, "tombo_tpu_torch", *p) for p in (
        ("output", "text.py"), ("filters.py",), ("preprocess.py",))]
    assert all("    import h5py\n" in open(p).read() for p in nested)


def test_plot_and_event_resquiggle_import_no_matplotlib_or_h5py():
    """The plot package and the event re-squiggle import neither
    matplotlib nor h5py: each is imported inside the functions that draw
    or open a file, never at a module's top level."""
    code = textwrap.dedent("""
        import importlib, sys
        for m in ("tombo_tpu_torch.plot", "tombo_tpu_torch.plot.signal",
                  "tombo_tpu_torch.plot.accuracy",
                  "tombo_tpu_torch.pipeline.event_resquiggle",
                  "tombo_tpu_torch.cli.main"):
            importlib.import_module(m)
        print("matplotlib" in sys.modules, "h5py" in sys.modules)
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "False"]
    top = re.compile(r"^(from|import)\s+matplotlib\b")
    hits = []
    for root, _, fns in os.walk(os.path.join(ROOT, "tombo_tpu_torch")):
        for fn in fns:
            if fn.endswith(".py"):
                path = os.path.join(root, fn)
                hits += [(path, ln) for ln in open(path) if top.match(ln)]
    assert not hits


def test_plot_data_runs_without_matplotlib_or_h5py():
    """The plot data functions with matplotlib and h5py unimportable, on
    device-resident means (CPU tensors): k-mer levels, the max-difference
    regions, clustered traces and the accuracy rates."""
    code = textwrap.dedent("""
        import sys
        sys.modules["matplotlib"] = None
        sys.modules["h5py"] = None
        import numpy as np, torch
        from tombo_tpu_torch import testing
        from tombo_tpu_torch.io.index import ReadsIndex
        from tombo_tpu_torch.io.model_io import KmerModel
        from tombo_tpu_torch.plot import accuracy, signal
        from tombo_tpu_torch.stats import device_levels
        from tombo_tpu_torch.types import ReadData
        rng = np.random.default_rng(0)
        model = KmerModel.load_default("DNA")
        fasta = testing.random_reference(rng, 3000)
        idx = {"s": ReadsIndex(), "c": ReadsIndex()}
        means = torch.tensor(rng.normal(0, 1, (12, 400)))
        entries = []
        for i in range(12):
            name, strand = "sc"[i % 2], "+-"[(i // 2) % 2]
            start = 100 + 13 * i
            idx[name].add_read_data("chr_test", strand, ReadData(
                start, start + 400, False, 0, strand, "", "g", False,
                read_id="r%d" % i))
            entries.append(("r%d" % i, i, 400))
        device_levels.register_batch(means, entries)
        cpu = torch.device("cpu")
        km = signal.kmer_levels(idx["s"], 2, 4, device=cpu, fasta=fasta)
        regs = signal.max_difference_regions(idx["s"], idx["c"], 3, 21,
                                             device=cpu)
        cl = signal.cluster_traces(
            [("chr_test", 300, 321, "+", "000", "a"),
             ("chr_test", 300, 321, "-", "001", "b")],
            idx["s"], idx["c"], 2, device=cpu)
        curves = accuracy.prep_accuracy_rates(
            {"m": (rng.normal(0, 1, 1000), rng.random(1000) < 0.5)},
            verbose=False, device=cpu)
        print(len(km), sum(len(v) for v in km.values()), len(regs),
              sorted(cl), [v.shape for v in cl.values()],
              curves["m"][0].shape[0], "matplotlib" in sys.modules and
              sys.modules["matplotlib"] is not None)
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [
        "16", str(4 * 399), "3", "['a',", "'b']",
        "[(6,", "21),", "(6,", "21)]", "1000", "False"], out.stdout


def test_detection_runs_without_h5py():
    """The card's detection paths with h5py unimportable: device-resident
    means on the CPU, an in-memory index, iter_region_stats for de novo
    with per-read blocks (and their file-free aggregation), the
    alternative-model test and a level test."""
    code = textwrap.dedent("""
        import sys
        sys.modules["h5py"] = None
        import numpy as np, torch
        from tombo_tpu_torch import testing
        from tombo_tpu_torch.io.index import ReadsIndex
        from tombo_tpu_torch.io.model_io import KmerModel
        from tombo_tpu_torch.stats import detect, device_levels
        from tombo_tpu_torch.types import ReadData
        rng = np.random.default_rng(0)
        model = KmerModel.load_default("DNA")
        fasta = testing.random_reference(rng, 3000)
        index = ReadsIndex()
        means = torch.zeros((6, 400), dtype=torch.float32)
        entries = []
        for i in range(6):
            start, strand = 200 + 300 * i, "+-"[i % 2]
            # genome-ordered expected levels, read-centric on '-'
            cp = model.central_pos
            seq = fasta.get_seq("chr_test", start - cp,
                                start + 400 + model.kmer_width - cp - 1)
            lv, _ = model.get_exp_levels_from_seq_with_gaps(seq, False)
            if strand == "-":
                lv = lv[::-1]
            means[i] = torch.tensor(lv + rng.normal(0, 0.1, 400))
            index.add_read_data("chr_test", strand, ReadData(
                start, start + 400, False, 0, strand, "", "g", False,
                read_id="r%d" % i))
            entries.append(("r%d" % i, i, 400))
        device_levels.register_batch(means, entries)
        from tombo_tpu_torch.io.model_io import load_alt_refs
        from tombo_tpu_torch.stats import aggregate
        p = detect.TestParams("de_novo", single_read_thresh=0.5,
                              lower_thresh=0.15, region_size=1000)
        out = list(detect.iter_region_stats(index, p, fasta, model,
                                            device="cpu",
                                            emit_per_read=True))
        agg = [aggregate.aggregate_block(pr[1], *pr[3:], 0.5, 0.15,
                                         "de_novo") for _, _, pr in out]
        same = all((a.reg_poss == s.reg_poss).all() and
                   (a.valid_cov == s.valid_cov).all()
                   for a, (_, s, _) in zip(agg, out))
        alt = detect.TestParams("model_compare", single_read_thresh=2.5,
                                lower_thresh=-1.5, region_size=1000)
        n_alt = len(list(detect.iter_region_stats(
            index, alt, fasta, model, device="cpu",
            alt_refs=load_alt_refs(["5mC", "CpG"], "DNA"))))
        # the reads their own control: the level test runs, D is 0
        lv = detect.TestParams("ks", min_test_reads=1, region_size=1000)
        n_lv = sum(int(s.reg_cov.sum()) for _, s, _ in
                   detect.iter_region_stats(index, lv, None, None, index,
                                            device="cpu"))
        print(len(out), sum(int(s.reg_cov.sum()) for _, s, _ in out),
              same, n_alt, n_lv,
              "h5py" in sys.modules and sys.modules["h5py"] is not None)
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_regs, n_obs, same, n_alt, n_lv, h5 = out.stdout.split()
    assert int(n_regs) >= 3 and int(n_obs) > 1500 and same == "True"
    assert int(n_alt) >= 3 and int(n_lv) > 300 and h5 == "False"


def test_estimation_runs_without_h5py(tmp_path):
    """Model estimation on the card's route with h5py unimportable:
    device-resident means of simulated reads (on the CPU), an in-memory
    index and read source; the canonical 3-mer model with its re-centring
    fit, a motif model and the density model of an alternative sample
    (the same reads, C-containing 3-mers raised by 1.0), each written to
    and read back from ``.npz``."""
    code = textwrap.dedent("""
        import sys
        sys.modules["h5py"] = None
        import numpy as np, torch
        from tombo_tpu_torch import testing
        from tombo_tpu_torch.io.index import ReadsIndex
        from tombo_tpu_torch.io.model_io import AltModel, KmerModel
        from tombo_tpu_torch.ops.ref_impl import new_means
        from tombo_tpu_torch.seq import all_kmers
        from tombo_tpu_torch.stats import device_levels, estimate as est
        from tombo_tpu_torch.types import (AlignInfo, GenomeLocation,
                                           ReadData, ResquiggleResults)
        rng = np.random.default_rng(0)
        model = KmerModel.load_default("DNA")
        fasta = testing.random_reference(rng, 3000)
        tri = KmerModel(np.zeros(64), np.ones(64), 1)
        has_c = np.array(["C" in km for km in all_kmers(3)])
        idx = {"s": ReadsIndex(), "a": ReadsIndex()}
        results, raws = [], {}
        mats = {"s": torch.zeros((16, 400)), "a": torch.zeros((16, 400))}
        for i in range(16):
            read = testing.simulate_read(rng, fasta, model, read_len=400,
                                         read_id="r%d" % i)
            segs = read.true_segs - read.read_start_rel_to_raw
            raw = read.raw_signal.astype(np.float64)
            sig = raw[read.read_start_rel_to_raw:]
            m = new_means((sig - np.median(raw)) /
                          np.median(np.abs(raw - np.median(raw))), segs)
            codes = tri.get_kmer_codes("A" + read.seq + "A")
            for k, shift in (("s", 0.0), ("a", 1.0)):
                mats[k][i] = torch.tensor(m + shift * has_c[codes])
                idx[k].add_read_data(read.chrm, read.strand, ReadData(
                    read.start, read.end, False,
                    read.read_start_rel_to_raw, read.strand, "", "g",
                    False, read_id=k + read.read_id))
            results.append(ResquiggleResults(
                align_info=AlignInfo("sr%d" % i), genome_seq=read.seq,
                genome_loc=GenomeLocation(read.start, read.strand,
                                          read.chrm),
                read_start_rel_to_raw=read.read_start_rel_to_raw,
                segs=segs))
            raws["sr%d" % i] = read.raw_signal
        for k in "sa":
            device_levels.register_batch(
                mats[k], [(k + "r%d" % i, i, 400) for i in range(16)])
        src = est.MemoryReadSource(results, raws)
        std = est.estimate_kmer_model(idx["s"], fasta, 0, 1, 1, 1, False,
                                      None, region_size=1000,
                                      read_source=src, device="cpu")
        std.save_npz("@DIR@/std.npz")
        back = KmerModel.load("@DIR@/std.npz")
        motif = est.estimate_motif_alt_model(
            idx["s"], fasta, "CG:1", 1, 1, 1, 0, None, region_size=1000,
            device="cpu")
        alt = est.estimate_alt_model(idx["a"], idx["s"], std, "C", 5, 10,
                                     fasta=fasta, device="cpu")
        alt.save_npz("@DIR@/alt.npz")
        alt_back = AltModel.load("@DIR@/alt.npz")
        single = [c for c, km in enumerate(all_kmers(3))
                  if km.count("C") == 1]
        shift = np.mean([alt_back.means[c, all_kmers(3)[c].index("C")] -
                         std.means[c] for c in single])
        print(bool(np.array_equal(back.means, std.means) and
                   np.isfinite(std.means).all()),
              int(np.isfinite(motif.means).sum()), round(float(shift), 2),
              "h5py" in sys.modules and sys.modules["h5py"] is not None)
    """).replace("@DIR@", str(tmp_path))
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    same, n_motif, shift, h5 = out.stdout.split()
    assert same == "True" and int(n_motif) > 0 and h5 == "False"
    assert 0.5 < float(shift) < 1.5


def test_runner_runs_without_h5py():
    """The card's route through the re-squiggle runner with h5py
    unimportable: simulated reads with 8% basecall errors in a memory
    source, the native minimizer aligner, the runner on the CPU; it maps,
    re-squiggles, builds an in-memory index and writes no file."""
    code = textwrap.dedent("""
        import os, sys
        sys.modules["h5py"] = None
        import numpy as np
        from tombo_tpu_torch import config, testing
        from tombo_tpu_torch.io.model_io import KmerModel
        from tombo_tpu_torch.pipeline import runner
        from tombo_tpu_torch.pipeline.aligner import MinimizerAligner
        from tombo_tpu_torch.types import SeqSampleType, SequenceData
        rng = np.random.default_rng(4)
        model = KmerModel.load_default("DNA")
        fasta = testing.random_reference(rng, 8000)
        reads = []
        for i in range(12):
            r = testing.simulate_read(rng, fasta, model, read_len=400,
                                      read_id="m%d" % i)
            reads.append(("m%d" % i, r.raw_signal, SequenceData(
                testing.mutate_seq(rng, r.seq, 0.08), r.read_id, 12.0)))
        before = sorted(os.listdir("."))
        summary, index = runner.resquiggle_all_reads(
            runner.MemoryReads(reads), MinimizerAligner(fasta), model,
            SeqSampleType("DNA", False),
            config.load_resquiggle_parameters("DNA"),
            runner.RunConfig(batch_size=8, device="cpu"))
        print(summary.n_success, sum(1 for _ in index.iter_reads()),
              sorted(os.listdir(".")) == before,
              "h5py" in sys.modules and sys.modules["h5py"] is not None)
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_ok, n_index, no_files, h5 = out.stdout.split()
    assert int(n_ok) >= 10 and int(n_index) >= 10
    assert no_files == "True" and h5 == "False"


def test_setup_names_the_console_script():
    src = open(os.path.join(ROOT, "setup.py")).read()
    assert "tombo-tpu-torch = tombo_tpu_torch.cli.main:main" in src
    assert "tombo-tpu = tombo_tpu.cli.main:main" in src


def test_port_reads_no_tombo_tpu_environment_variable():
    """Every switch of the JAX lane's TOMBO_TPU_* variables is an argument
    or a module constant in the port."""
    hits = []
    for root, _, fns in os.walk(os.path.join(ROOT, "tombo_tpu_torch")):
        for fn in fns:
            if fn.endswith((".py", ".cu", ".cuh")):
                path = os.path.join(root, fn)
                hits += [path for ln in open(path) if "TOMBO_TPU_" in ln]
    assert not hits


def test_setup_packages_the_port():
    """An install of the repo carries the port: every package of it, its
    model files and its CUDA sources."""
    import setuptools
    seen = {}
    old = setuptools.setup
    setuptools.setup = lambda **kw: seen.update(kw)
    try:
        code = open(os.path.join(ROOT, "setup.py")).read()
        cwd = os.getcwd()
        os.chdir(ROOT)
        try:
            exec(compile(code, "setup.py", "exec"), {"__name__": "__main__"})
        finally:
            os.chdir(cwd)
    finally:
        setuptools.setup = old
    port = sorted(
        os.path.relpath(root, ROOT).replace(os.sep, ".")
        for root, _, fns in os.walk(os.path.join(ROOT, "tombo_tpu_torch"))
        if "__init__.py" in fns)
    assert set(port) <= set(seen["packages"])
    assert "tombo_tpu_torch.pipeline" in port
    assert set(seen["package_data"]["tombo_tpu_torch"]) == {
        "models/*.npz", "csrc/*"}


def test_chip_smoke_imports_no_jax():
    src = open(os.path.join(ROOT, "chip_smoke.py")).read()
    bad = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|tombo_tpu)\b(?!_)")
    assert not [ln for ln in src.splitlines() if bad.match(ln)]


def test_default_device_needs_a_card(monkeypatch):
    from tombo_tpu_torch import config
    from tombo_tpu_torch.device import resolve_device, resolve_dtype
    from tombo_tpu_torch.io.model_io import KmerModel
    from tombo_tpu_torch.pipeline.batch import BatchedResquiggler
    from tombo_tpu_torch.types import SeqSampleType

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = KmerModel.load_default("DNA")
    params = config.load_resquiggle_parameters("DNA")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchedResquiggler(model, params, SeqSampleType("DNA", False))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"
    br = BatchedResquiggler(model, params, SeqSampleType("DNA", False),
                            device="cpu")
    assert br.dtype == torch.float32
    with pytest.raises(ValueError, match="float32"):
        resolve_dtype(torch.float64, torch.device("cuda"))
    assert resolve_dtype(None, torch.device("cpu")) == torch.float32


@pytest.mark.parametrize("kw,exc,item", [
    (dict(seq_samp_type=("DNA_5mC", False)), ValueError,
     "unknown sample type"),
    (dict(mesh=[]), ValueError, "at least one device"),
])
def test_unported_options_name_their_roadmap_item(kw, exc, item):
    """An invalid mesh raises, as every mesh the port cannot run does;
    so does a sample type the port has no parameters for."""
    from tombo_tpu_torch import config
    from tombo_tpu_torch.io.model_io import KmerModel
    from tombo_tpu_torch.pipeline.batch import BatchedResquiggler
    from tombo_tpu_torch.types import SeqSampleType

    sst = SeqSampleType(*kw.pop("seq_samp_type", ("DNA", False)))
    with pytest.raises(exc, match=item):
        BatchedResquiggler(KmerModel.load_default("DNA"),
                           config.load_resquiggle_parameters("DNA"), sst,
                           device="cpu", **kw)


@pytest.mark.parametrize("samp_type,kw", [
    ("RNA", {}), ("DNA", dict(const_scale=55.0)),
    ("RNA", dict(const_scale=55.0, skip_seq_scaling=True))],
    ids=["RNA", "const_scale", "RNA_const_scale_skip_seq_scaling"])
def test_rna_and_const_scale_run(samp_type, kw):
    """RNA and constant-scale normalization, once refused, run on the
    CPU: two short simulated reads come back re-squiggled."""
    from tombo_tpu_torch import config, testing
    from tombo_tpu_torch.io.model_io import KmerModel
    from tombo_tpu_torch.pipeline import resquiggle as rsq
    from tombo_tpu_torch.pipeline.aligner import ExactAligner
    from tombo_tpu_torch.pipeline.batch import BatchedResquiggler
    from tombo_tpu_torch.types import SeqSampleType, SequenceData

    rna = samp_type == "RNA"
    rng = np.random.default_rng(2)
    model = KmerModel.load_default(samp_type)
    fasta = testing.random_reference(np.random.default_rng(3), 5000)
    aligner = ExactAligner(fasta)
    sst = SeqSampleType(samp_type, rna)
    params = config.load_resquiggle_parameters(samp_type)
    maps = []
    for i in range(2):
        read = testing.simulate_read(rng, fasta, model, read_len=400,
                                     mean_dwell=12.0 if rna else 7.0,
                                     rev_sig=rna)
        mr = rsq.map_read(SequenceData(read.seq, read.read_id, 12.0),
                          aligner, model, sst)
        maps.append(rsq.adjust_map_res(
            mr.replace(raw_signal=read.raw_signal), sst, params))
    out = BatchedResquiggler(model, params, sst, device="cpu",
                             **kw).resquiggle_batch(maps)
    for res, err in out:
        assert err is None, err
        assert res.segs.shape[0] == len(res.genome_seq) + 1
        if "const_scale" in kw and "skip_seq_scaling" in kw:
            assert res.scale_values.scale == 55.0


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    from tombo_tpu_torch import kernels
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build()


def test_header_edit_changes_library_hash(monkeypatch, tmp_path):
    """A library is keyed on its source and every local header the
    source includes, so editing a shared header rebuilds its users."""
    import shutil
    from tombo_tpu_torch import kernels
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, csrc)
    monkeypatch.setattr(kernels, "CSRC", str(csrc))
    before = {n: kernels._lib_path(n) for n in kernels.SOURCES}
    with open(csrc / "dp_row.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: kernels._lib_path(n) for n in kernels.SOURCES}
    assert after["banded_dp"] != before["banded_dp"]
    assert after["banded_dp_chunked"] != before["banded_dp_chunked"]
    assert after["count_le"] == before["count_le"]


def test_model_file_is_the_jax_package_copy():
    a = open(os.path.join(ROOT, "tombo_tpu", "models",
                          "tombo.DNA.model.npz"), "rb").read()
    b = open(os.path.join(ROOT, "tombo_tpu_torch", "models",
                          "tombo.DNA.model.npz"), "rb").read()
    assert a == b


def test_native_sources_are_the_jax_package_copies():
    """The port's host library is built from byte copies of the JAX
    package's sources, so its results equal the JAX library's."""
    for fn in ("tombo_native.cpp", "resquiggle_baseline.cpp", "aligner.cpp"):
        a = open(os.path.join(ROOT, "csrc", fn), "rb").read()
        b = open(os.path.join(ROOT, "tombo_tpu_torch", "csrc", fn),
                 "rb").read()
        assert a == b, fn


def test_one_read_runs_without_jax_or_jax_package():
    """The one-read API with jax, tombo_tpu and scipy unimportable: a
    simulated 1 kb read through resquiggle_read_with_retries on the CPU,
    on the port's own host library under build/tombo_tpu_torch/."""
    code = textwrap.dedent("""
        import sys
        for m in ("jax", "jaxlib", "tombo_tpu", "scipy"):
            sys.modules[m] = None
        import numpy as np
        from tombo_tpu_torch import config, native, testing
        from tombo_tpu_torch.io.model_io import KmerModel
        from tombo_tpu_torch.pipeline import resquiggle as rsq
        from tombo_tpu_torch.pipeline.aligner import ExactAligner
        from tombo_tpu_torch.types import SeqSampleType, SequenceData
        rng = np.random.default_rng(3)
        model = KmerModel.load_default("DNA")
        fasta = testing.random_reference(np.random.default_rng(4), 8000)
        sst = SeqSampleType("DNA", False)
        params = config.load_resquiggle_parameters("DNA")
        save = config.load_resquiggle_parameters("DNA",
                                                 use_save_bandwidth=True)
        read = testing.simulate_read(rng, fasta, model, read_len=1000)
        mr = rsq.map_read(SequenceData(read.seq, "r", 12.0),
                          ExactAligner(fasta), model, sst)
        mr = rsq.adjust_map_res(mr.replace(raw_signal=read.raw_signal),
                                sst, params)
        res = rsq.resquiggle_read_with_retries(
            mr, model, params, save, outlier_thresh=config.OUTLIER_THRESH,
            seq_samp_type=sst, device="cpu", dtype="float64")
        print(res.segs.shape[0], bool(np.all(np.diff(res.segs) > 0)),
              native._NATIVE_LIB._name)
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n, ok, lib = out.stdout.split()
    assert (n, ok) == ("1001", "True")
    assert lib.startswith(os.path.join(ROOT, "build", "tombo_tpu_torch"))
