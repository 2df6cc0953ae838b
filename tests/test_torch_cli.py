"""The port's command line (``python -m tombo_tpu_torch``) held against the
JAX package's (``tombo_tpu.cli.main``) on the CPU.

``resquiggle`` runs in a subprocess where ``import tombo_tpu`` raises and
is held to the JAX command's corrected groups at their default float32
within the bars of tests/test_batch_parity.py, with the same failure
statuses.  The five ``detect_modifications`` and four ``build_model``
commands run on directories re-squiggled by the JAX command line:
statistics files with positions and coverage equal and at most
max(1, n/10,000) differing entries, level statistics within the float32
level bar, models within the float32 bar of the estimation tests, the
scale equal.  ``detect_modifications de_novo`` in two gloo processes
(``--num-hosts 2``) writes the one-host statistics file bit for bit.
Also --help, --version, --print-advanced-arguments, and exit code 1 with
the device's error without ``--device cpu``."""
import os
import shutil
import socket
import subprocess
import sys
import textwrap

import importlib

import h5py
import numpy as np
import pytest

from tombo_tpu.testing import make_synthetic_dataset
from tombo_tpu_torch.cli import main as t_cli
from tombo_tpu_torch.io.model_io import AltModel, KmerModel
from tombo_tpu_torch.stats.files import LevelStats, ModelStats

# tombo_tpu.cli exports its main function under the module's name
j_cli = importlib.import_module("tombo_tpu.cli.main")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CG = "RawGenomeCorrected_000/BaseCalled_template"
# the float32 level statistics' bar (chip_smoke.LEVEL_F32_ABS_TOL)
LEVEL_F32_ABS_TOL = {"ks": 4e-6, "u": 2.3e-4, "t": 2.7e-3, "ks_stat": 2e-7,
                     "u_stat": 2.2e-4, "t_stat": 9e-6}
# models: the float32 bar of tests/test_torch_estimate.py against the
# JAX host lane (levels within 5e-3)
MODEL_ATOL = 5e-3


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """A sample and a control directory (12 reads each, half with 8%
    basecall errors) on one reference, re-squiggled by the JAX command
    line; and a fresh copy of the sample for the resquiggle test."""
    base = str(tmp_path_factory.mktemp("cli"))
    _, _, fast5_dir = make_synthetic_dataset(
        base, n_reads=24, seed=5, read_len=600, ref_len=5000,
        noisy_frac=0.5, noisy_err=0.08)
    samp, ctrl = os.path.join(base, "samp"), os.path.join(base, "ctrl")
    for d in (samp, ctrl):
        os.makedirs(d)
    for i, fn in enumerate(sorted(os.listdir(fast5_dir))):
        shutil.move(os.path.join(fast5_dir, fn),
                    os.path.join(samp if i % 2 == 0 else ctrl, fn))
    fresh = os.path.join(base, "fresh")
    shutil.copytree(samp, fresh)
    ref = os.path.join(base, "reference.fasta")
    for d in (samp, ctrl):
        assert j_cli.main(["resquiggle", d, ref, "--processes", "2",
                           "--quiet"]) == 0
    model3 = os.path.join(base, "three.tombo.model")
    KmerModel(np.random.default_rng(3).normal(0, 1, 64), np.full(64, 0.2),
              1, "three").write_model(model3)
    return dict(base=base, samp=samp, ctrl=ctrl, fresh=fresh, ref=ref,
                model3=model3)


def _port_cli(args, block_jax_package=False):
    """``python -m tombo_tpu_torch <args>`` in a subprocess."""
    code = textwrap.dedent("""
        import runpy, sys
        if %r:
            class _Block:
                def find_spec(self, name, path=None, target=None):
                    if name.split(".")[0] in ("tombo_tpu", "jax"):
                        raise ImportError("blocked: " + name)
            sys.meta_path.insert(0, _Block())
        sys.argv = ["tombo_tpu_torch"] + %r
        runpy.run_module("tombo_tpu_torch", run_name="__main__")
    """ % (block_jax_package, list(args)))
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def _groups(d):
    out = {}
    for fn in sorted(f for f in os.listdir(d) if f.endswith(".fast5")):
        with h5py.File(os.path.join(d, fn), "r") as f:
            g = f["Analyses/" + CG]
            rec = dict(status=g.attrs["status"])
            if "Events" in g:
                ev = g["Events"][:]
                rec.update(
                    rsrtr=int(g["Events"].attrs["read_start_rel_to_raw"]),
                    starts=ev["start"].astype(np.int64),
                    lens=ev["length"].astype(np.int64),
                    bases=b"".join(ev["base"]),
                    shift=float(g.attrs["shift"]),
                    scale=float(g.attrs["scale"]),
                    score=float(g.attrs["signal_match_score"]),
                    mapped=dict(g["Alignment"].attrs.items()))
            out[fn] = rec
    return out


def _close(t, j):
    """tests/test_batch_parity.py's bars for one read."""
    return (t["starts"].shape == j["starts"].shape and
            np.mean(t["rsrtr"] + t["starts"] == j["rsrtr"] + j["starts"]) >
            0.99 and abs(t["score"] - j["score"]) < 1e-2 and
            abs(t["shift"] - j["shift"]) / j["scale"] < 2e-3 and
            abs(t["scale"] - j["scale"]) / j["scale"] < 2e-3)


def _jax_f64_resquiggle(d, ref):
    """The JAX runner at float64 (its command line has no dtype
    option)."""
    import jax.numpy as jnp
    from tombo_tpu import config
    from tombo_tpu.io.fasta import Fasta
    from tombo_tpu.io.model_io import KmerModel as JKmerModel
    from tombo_tpu.pipeline import runner
    from tombo_tpu.pipeline.aligner import MinimizerAligner
    from tombo_tpu.pipeline.batch import BatchedResquiggler
    from tombo_tpu.types import SeqSampleType
    model = JKmerModel.load_default("DNA")
    sst = SeqSampleType("DNA", False)
    params = config.load_resquiggle_parameters("DNA")
    runner.resquiggle_all_reads(
        d, MinimizerAligner(Fasta(ref)), model, sst, params,
        runner.RunConfig(overwrite=True),
        resquiggler=BatchedResquiggler(model, params, sst,
                                       dtype=jnp.float64))


def test_resquiggle_matches_jax_command(dirs, tmp_path):
    """Both command lines at their defaults (float32) on copies of one
    directory, the port's in a process without the JAX package: the same
    statuses, mappings and bases, and each read within the batch-parity
    bars of the JAX command's, or, where the JAX float32 lane itself is
    outside those bars of the JAX float64 lane, within them of the
    float64 lane."""
    j_dir, t_dir, f_dir = (str(tmp_path / n) for n in ("j", "t", "f64"))
    for d in (j_dir, t_dir, f_dir):
        shutil.copytree(dirs["fresh"], d)
    assert j_cli.main(["resquiggle", j_dir, dirs["ref"], "--processes", "2",
                       "--quiet"]) == 0
    _jax_f64_resquiggle(f_dir, dirs["ref"])
    out = _port_cli(["resquiggle", t_dir, dirs["ref"], "--processes", "2",
                     "--device", "cpu",
                     "--failed-reads-filename", str(tmp_path / "f.txt")],
                    block_jax_package=True)
    assert out.returncode == 0, out.stderr
    assert "Re-squiggle complete" in out.stdout
    jg, tg, fg = _groups(j_dir), _groups(t_dir), _groups(f_dir)
    assert sorted(jg) == sorted(tg)
    n_ok = n_jax_off = 0
    for fn, j in jg.items():
        t = tg[fn]
        assert t["status"] == j["status"], fn
        if "starts" not in j:
            continue
        n_ok += 1
        assert t["bases"] == j["bases"] and t["mapped"] == j["mapped"]
        if not _close(t, j):
            assert not _close(j, fg[fn]) and _close(t, fg[fn]), fn
            n_jax_off += 1
    assert n_ok >= 10 and n_jax_off <= 2


def _stat_blocks(fn, cls):
    f = cls(fn)
    try:
        return [(c, s, st, b) for c, s, st, _, b in f]
    finally:
        f.close()


def _assert_stats_close(t_fn, j_fn, cls=ModelStats, abs_tol=None):
    """Blocks of the same regions, positions and coverage equal; model
    statistics: at most max(1, n/10,000) differing entries; level
    statistics within ``abs_tol``."""
    tb, jb = _stat_blocks(t_fn, cls), _stat_blocks(j_fn, cls)
    assert [b[:3] for b in tb] == [b[:3] for b in jb]
    sites = flips = 0
    for (_, _, _, a), (_, _, _, b) in zip(tb, jb):
        assert a.dtype.names == b.dtype.names
        np.testing.assert_array_equal(a["pos"], b["pos"])
        sites += a.shape[0]
        for name in a.dtype.names:
            if "cov" in name or name == "pos":
                np.testing.assert_array_equal(a[name], b[name])
            elif abs_tol is not None:
                np.testing.assert_allclose(a[name], b[name], rtol=0,
                                           atol=abs_tol)
            else:
                x, y = a[name], b[name]
                flips += int(np.sum(~((x == y) | (np.isnan(x) &
                                                  np.isnan(y)))))
    assert sites > 100
    assert flips <= max(1, 2 * sites // 10000), (flips, sites)


def _both(argv_fn, tmp_path):
    """Run a command of each package with its own output basename."""
    os.makedirs(tmp_path, exist_ok=True)
    j_out, t_out = str(tmp_path / "jax"), str(tmp_path / "port")
    assert j_cli.main(argv_fn(j_out)) == 0
    assert t_cli.main(argv_fn(t_out) + ["--device", "cpu"]) == 0
    return j_out, t_out


DETECT = {
    "de_novo": lambda d, o: [
        "detect_modifications", "de_novo", d["samp"], "--reference",
        d["ref"], "--statistics-file-basename", o,
        "--per-read-statistics-basename", o],
    "alternative_model": lambda d, o: [
        "detect_modifications", "alternative_model", d["samp"],
        "--reference", d["ref"], "--alternate-bases", "5mC", "CpG",
        "--single-read-threshold", "0", "--statistics-file-basename", o],
    "model_sample_compare": lambda d, o: [
        "detect_modifications", "model_sample_compare", d["samp"],
        "--control-fast5-basedirs", d["ctrl"], "--reference", d["ref"],
        "--statistics-file-basename", o],
    "level_sample_compare": lambda d, o: [
        "detect_modifications", "level_sample_compare", d["samp"],
        "--alternate-fast5-basedirs", d["ctrl"], "--minimum-test-reads",
        "2", "--statistic-type", "ks", "--statistics-file-basename", o],
}


@pytest.mark.parametrize("cmd", sorted(DETECT))
def test_detect_commands_match_jax(dirs, tmp_path, cmd):
    j_out, t_out = _both(lambda o: DETECT[cmd](dirs, o) +
                         ["--processes", "2"], tmp_path)
    if cmd == "level_sample_compare":
        _assert_stats_close(t_out + ".tombo.stats", j_out + ".tombo.stats",
                            LevelStats, LEVEL_F32_ABS_TOL["ks_stat"])
    elif cmd == "alternative_model":
        for name in ("5mC", "CpG"):
            _assert_stats_close("%s.%s.tombo.stats" % (t_out, name),
                                "%s.%s.tombo.stats" % (j_out, name))
    else:
        _assert_stats_close(t_out + ".tombo.stats", j_out + ".tombo.stats")
    if cmd == "de_novo":
        # the per-read file the port wrote, aggregated by each package
        pr = t_out + ".tombo.per_read_stats"
        assert os.path.exists(pr)
        j_agg, t_agg = _both(lambda o: [
            "detect_modifications", "aggregate_per_read_stats",
            "--per-read-statistics-filename", pr,
            "--statistics-file-basename", o,
            "--single-read-threshold", "0.15", "0.5"], tmp_path / "agg")
        _assert_stats_close(t_agg + ".tombo.stats", j_agg + ".tombo.stats")


def test_aggregate_per_read_stats_matches_jax(dirs, tmp_path):
    """aggregate_per_read_stats on the JAX de novo per-read file."""
    pr = str(tmp_path / "jax_pr")
    assert j_cli.main(DETECT["de_novo"](dirs, pr)) == 0
    j_out, t_out = _both(lambda o: [
        "detect_modifications", "aggregate_per_read_stats",
        "--per-read-statistics-filename", pr + ".tombo.per_read_stats",
        "--statistics-file-basename", o, "--single-read-threshold", "0.5"],
        tmp_path / "agg")
    _assert_stats_close(t_out + ".tombo.stats", j_out + ".tombo.stats")


BUILD = {
    "estimate_reference": lambda d, o: [
        "build_model", "estimate_reference", d["samp"], d["ctrl"],
        "--reference", d["ref"], "--tombo-model-filename", o + ".tombo.model",
        "--minimum-test-reads", "1", "--minimum-kmer-observations", "1"],
    "estimate_motif_alt_reference": lambda d, o: [
        "build_model", "estimate_motif_alt_reference", d["samp"],
        d["ctrl"], "--reference", d["ref"], "--alternate-model-filename",
        o + ".tombo.model", "--alternate-model-name", "m", "--motif-description",
        "CG:1", "--minimum-test-reads", "1",
        "--minimum-kmer-observations", "1"],
    # a 3-mer canonical model, so 12 reads give every k-mer the 50
    # observations the density estimate needs
    "estimate_alt_reference": lambda d, o: [
        "build_model", "estimate_alt_reference", "--fast5-basedirs",
        d["samp"], "--control-fast5-basedirs", d["ctrl"],
        "--tombo-model-filename", d["model3"],
        "--alternate-model-filename", o + ".tombo.model",
        "--alternate-model-name", "a", "--alternate-model-base", "C",
        "--minimum-kmer-observations", "1"],
}


@pytest.mark.parametrize("cmd", sorted(BUILD))
def test_build_model_commands_match_jax(dirs, tmp_path, cmd):
    j_out, t_out = _both(lambda o: BUILD[cmd](dirs, o), tmp_path)
    cls = KmerModel if cmd == "estimate_reference" else AltModel
    got, want = cls.load(t_out + ".tombo.model"), cls.load(j_out + ".tombo.model")
    assert got.kmer_width == want.kmer_width
    ok = np.isfinite(want.means)
    assert ok.sum() > 10
    np.testing.assert_array_equal(np.isfinite(got.means), ok)
    np.testing.assert_allclose(got.means[ok], want.means[ok], rtol=0,
                               atol=MODEL_ATOL)
    np.testing.assert_allclose(got.sds[ok], want.sds[ok], rtol=0,
                               atol=MODEL_ATOL)


def test_estimate_scale_matches_jax(dirs, capsys):
    argv = ["build_model", "estimate_scale", dirs["samp"]]
    assert j_cli.main(argv) == 0
    want = capsys.readouterr().out
    assert t_cli.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want and got.startswith("Global scaling estimate: ")


def test_help_version_and_advanced_arguments():
    out = _port_cli(["--help"])
    assert out.returncode == 0
    for cmd in ("resquiggle", "preprocess", "filter",
                "detect_modifications", "text_output", "build_model",
                "plot"):
        assert cmd in out.stdout
    out = _port_cli(["--version"])
    assert out.returncode == 0 and out.stdout.strip() == \
        "tombo-tpu-torch 0.1.0"
    out = _port_cli(["resquiggle", "x", "y", "--print-advanced-arguments"])
    assert out.returncode == 0
    assert "--signal-align-parameters" in out.stdout
    out = _port_cli(["build_model", "event_resquiggle", "--help"])
    assert out.returncode == 0 and "--pore-model-filename" in out.stdout
    with pytest.raises(SystemExit):
        t_cli.main(["plot", "no_such_plot"])


def _subparsers(parser):
    import argparse
    for act in parser._actions:
        if isinstance(act, argparse._SubParsersAction):
            return act.choices
    return {}


def _options(parser):
    """{option or positional: (default, nargs, type, choices, required,
    action)} of an argparse parser."""
    return {(act.option_strings[0] if act.option_strings else act.dest): (
        act.default, act.nargs, act.type, act.choices, act.required,
        type(act).__name__) for act in parser._actions
        if act.dest != "help"}


def _jax_parser():
    import argparse
    from tombo_tpu.plot import add_plot_parsers
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="command")
    j_cli._add_build_model_parsers(sub)
    add_plot_parsers(sub)
    return parser


PLOT_COMMANDS = [
    "max_coverage", "genome_locations", "motif_centered", "max_difference",
    "most_significant", "per_read", "roc", "sample_compare_roc",
    "per_read_roc", "sample_compare_per_read_roc", "kmer",
    "cluster_most_significant", "motif_with_stats"]
# the plots whose data the port computes as tensor operations
DEVICE_PLOTS = {"max_difference", "roc", "sample_compare_roc",
                "per_read_roc", "sample_compare_per_read_roc", "kmer",
                "cluster_most_significant"}


@pytest.mark.parametrize("group,cmd", [("build_model", "event_resquiggle")] +
                         [("plot", c) for c in PLOT_COMMANDS])
def test_parsers_match_jax(group, cmd):
    """The port's ``plot`` and ``build_model event_resquiggle`` parsers
    have the JAX parsers' options and defaults, and ``--device`` where
    the data run as tensor operations."""
    want = _options(_subparsers(_subparsers(_jax_parser())[group])[cmd])
    got = _options(_subparsers(_subparsers(t_cli.build_parser())[group])[cmd])
    extra = {"--device"} if cmd in DEVICE_PLOTS else set()
    assert set(got) == set(want) | extra
    assert {k: v for k, v in got.items() if k not in extra} == want
    if extra:
        assert got["--device"][0] == "cuda"
    assert set(_subparsers(_subparsers(t_cli.build_parser())["plot"])) == \
        set(PLOT_COMMANDS)


@pytest.mark.parametrize("argv", [
    ["resquiggle", "d", "r.fa"],
    ["detect_modifications", "de_novo", "d", "--reference", "r.fa",
     "--statistics-file-basename", "o"],
    ["build_model", "estimate_scale", "d"],
    ["plot", "kmer", "d"],
    ["plot", "roc", "--statistics-filenames", "s.tombo.stats"]])
def test_no_card_exits_1_with_the_device_error(argv, capsys):
    assert t_cli.main(argv) == 1
    assert "no CUDA device is available" in capsys.readouterr().err


def test_two_host_detection_command_writes_the_one_host_file(dirs,
                                                             tmp_path):
    """``detect_modifications de_novo --num-hosts 2`` in two processes
    that meet over gloo on 127.0.0.1: host 0 writes the statistics file
    of the one-host command, bit for bit; each host writes the per-read
    blocks of its own reads to ``<file>.host<i>``."""
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    assert t_cli.main(DETECT["de_novo"](dirs, one) +
                      ["--device", "cpu", "--processes", "2"]) == 0
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tombo_tpu_torch"] +
        DETECT["de_novo"](dirs, two) +
        ["--device", "cpu", "--processes", "2", "--num-hosts", "2",
         "--host-id", str(rank), "--coordinator-address",
         "127.0.0.1:%d" % port], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=240)
            assert p.returncode == 0, err
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    got = _stat_blocks(two + ".tombo.stats", ModelStats)
    want = _stat_blocks(one + ".tombo.stats", ModelStats)
    assert [b[:3] for b in got] == [b[:3] for b in want] and len(want) > 1
    for (_, _, _, a), (_, _, _, b) in zip(got, want):
        assert a.dtype == b.dtype
        for name in a.dtype.names:
            np.testing.assert_array_equal(a[name], b[name])
    pr = two + ".tombo.per_read_stats"
    assert not os.path.exists(pr)
    assert all(os.path.exists("%s.host%d" % (pr, i)) for i in range(2))
