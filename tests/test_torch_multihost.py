"""Multi-host detection of the port (``stats/detect.py`` with a
``DistContext``) in 1, 2 and 3 gloo processes on the CPU.

A dataset written by the JAX runner (40 reads of 600 bases on a
2,500-base reference, both strands, regions of 1,000) goes through the
port's ``test_significance`` in subprocesses on 127.0.0.1, each with its
own timeout: de novo and the alternative-model test (5mC, CpG; a single
read threshold of 0, as tests/test_torch_cli.py runs it) on every read
with per-read files, model_sample_compare and KS on a split into a
sample (even reads) and a control (odd reads), at float64 and float32,
with chunks of two regions (model statistics) and one region a host
(level statistics), so every run merges several chunks.

Held: the statistics files of 1, 2 and 3 processes are equal, at both
dtypes (the ``invariant_1_vs_2`` / ``invariant_1_vs_4`` of
MULTIHOST_r05.json); at float64 they equal the JAX package's single-host
files, positions and coverage exact, fractions within 1e-12 and the KS
statistic within 1e-9 (tests/test_torch_levels.py's bar); the union of
the hosts' ``.host<i>`` per-read files, matched by read id, equals the
single-host per-read file; a multi-host run writes no levels sidecar."""
import glob
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from tombo_tpu import config as j_config
from tombo_tpu.io.index import ReadsIndex as JReadsIndex
from tombo_tpu.io.model_io import KmerModel as JKmerModel
from tombo_tpu.io.model_io import load_alt_refs as j_load_alt_refs
from tombo_tpu.pipeline.aligner import ExactAligner as JExactAligner
from tombo_tpu.pipeline.runner import RunConfig, resquiggle_all_reads
from tombo_tpu.stats import detect as j_dt
from tombo_tpu.testing import make_synthetic_dataset
from tombo_tpu.types import SeqSampleType as JSeqSampleType
from tombo_tpu_torch.stats.files import LevelStats, ModelStats, PerReadStats

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = ("float64", "float32")
ALTS = ["5mC", "CpG"]
# statistic -> the files it writes (per-read files: de novo and the
# alternative models)
STATS = {
    "de_novo": ["de_novo.tombo.stats"],
    "model_compare": ["alt.%s.tombo.stats" % a for a in ALTS],
    "sample_compare": ["sample_compare.tombo.stats"],
    "ks": ["ks.tombo.stats"],
}
PER_READ = {
    "de_novo": ["de_novo.tombo.per_read_stats"],
    "model_compare": ["alt.%s.tombo.per_read_stats" % a for a in ALTS],
}

# one host of a run: every statistic at one dtype, then a JSON line
_WORKER = textwrap.dedent("""
    import json, os, sys
    import torch
    from tombo_tpu_torch import config
    from tombo_tpu_torch.io.fasta import Fasta
    from tombo_tpu_torch.io.index import ReadsIndex
    from tombo_tpu_torch.io.model_io import KmerModel, load_alt_refs
    from tombo_tpu_torch.parallel import distributed
    from tombo_tpu_torch.stats import detect
    port, n_hosts, rank = (int(x) for x in sys.argv[1:4])
    fast5_dir, ref_fn, out_dir, dtype = sys.argv[4:8]
    dtype = getattr(torch, dtype)
    # small chunks: every run merges several
    detect.CHUNK_REGIONS, detect.LEVEL_CHUNK_REGIONS = 2, 1
    dist = distributed.init_distributed("127.0.0.1:%d" % port, n_hosts,
                                        rank) if n_hosts > 1 else None
    full = ReadsIndex([fast5_dir])
    samp, ctrl = ReadsIndex(), ReadsIndex()
    for (chrm, strand), reads in full.reads_index.items():
        for i, r in enumerate(sorted(reads, key=lambda r: r.read_id)):
            (samp, ctrl)[i % 2].add_read_data(chrm, strand, r)
    fasta = Fasta.read(ref_fn)
    model = KmerModel.load_default("DNA")

    def params(stat_type, thresh=None, **kw):
        th = thresh["DNA"] if thresh else (None, None)
        return detect.TestParams(stat_type=stat_type, lower_thresh=th[0],
                                 single_read_thresh=th[1], region_size=1000,
                                 **kw)
    out = lambda n: os.path.join(out_dir, n)
    common = dict(device="cpu", dtype=dtype, dist=dist, num_processes=2)
    detect.test_significance(
        full, params("de_novo", config.DE_NOVO_THRESH),
        out("de_novo.tombo.stats"), fasta=fasta, std_ref=model,
        per_read_bn=out("de_novo.tombo.per_read_stats"), **common)
    detect.test_significance(
        full, params("model_compare", {"DNA": (None, 0.0)}),
        out("alt.tombo.stats"), fasta=fasta, std_ref=model,
        alt_refs=load_alt_refs(["5mC", "CpG"], "DNA"),
        per_read_bn=out("alt.tombo.per_read_stats"), **common)
    detect.test_significance(
        samp, params("sample_compare", config.SAMP_COMP_THRESH),
        out("sample_compare.tombo.stats"), fasta=fasta, std_ref=model,
        ctrl_reads_index=ctrl, **common)
    detect.test_significance(
        samp, params("ks", min_test_reads=3), out("ks.tombo.stats"),
        ctrl_reads_index=ctrl, **common)
    if dist is not None:
        torch.distributed.destroy_process_group()
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "tombo_tpu"))
    print(json.dumps({"bad": bad}))
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_hosts(n_hosts, fast5_dir, ref_fn, out_dir, dtype):
    """One run of ``n_hosts`` processes; each must end within its
    timeout and import neither JAX nor the JAX package."""
    os.makedirs(out_dir)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(port), str(n_hosts), str(rank),
         fast5_dir, ref_fn, out_dir, dtype], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(n_hosts)]
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, err
            assert out.strip().splitlines()[-1] == '{"bad": []}'
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def _sidecars(fast5_dir):
    return sorted(glob.glob(os.path.join(fast5_dir, ".*.tombo.levels*")))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The dataset, the port's runs {(hosts, dtype): directory} and the
    JAX package's float64 single-host files; the JAX runner's sidecar is
    removed first, so the runs load their levels from FAST5."""
    tmp = str(tmp_path_factory.mktemp("multihost"))
    fasta, _, fast5_dir = make_synthetic_dataset(
        tmp, n_reads=40, seed=31, read_len=600, ref_len=2500)
    model = JKmerModel.load_default(j_config.DNA_SAMP_TYPE)
    summary, _ = resquiggle_all_reads(
        fast5_dir, JExactAligner(fasta), model,
        JSeqSampleType(j_config.DNA_SAMP_TYPE, False),
        j_config.load_resquiggle_parameters(j_config.DNA_SAMP_TYPE),
        RunConfig(overwrite=True, batch_size=8, num_io_threads=2))
    assert summary.n_success == 40
    for fn in _sidecars(fast5_dir):
        os.remove(fn)
    ref_fn = os.path.join(tmp, "reference.fasta")
    dirs, sidecars_after = {}, {}
    for n_hosts in (3, 2, 1):
        for dtype in DTYPES:
            d = os.path.join(tmp, "h%d_%s" % (n_hosts, dtype))
            _run_hosts(n_hosts, fast5_dir, ref_fn, d, dtype)
            dirs[(n_hosts, dtype)] = d
        sidecars_after[n_hosts] = _sidecars(fast5_dir)
    jax_dir = os.path.join(tmp, "jax")
    os.makedirs(jax_dir)
    _jax_files(fasta, model, fast5_dir, jax_dir)
    return dict(dirs=dirs, jax=jax_dir, sidecars=sidecars_after)


def _jax_files(fasta, model, fast5_dir, out_dir):
    full = JReadsIndex([fast5_dir])
    samp, ctrl = JReadsIndex(), JReadsIndex()
    for (chrm, strand), reads in full.reads_index.items():
        for i, r in enumerate(sorted(reads, key=lambda r: r.read_id)):
            (samp, ctrl)[i % 2].add_read_data(chrm, strand, r)

    def params(stat_type, thresh=None, **kw):
        th = thresh["DNA"] if thresh else (None, None)
        return j_dt.TestParams(stat_type=stat_type, lower_thresh=th[0],
                               single_read_thresh=th[1], region_size=1000,
                               **kw)
    out = lambda n: os.path.join(out_dir, n)  # noqa: E731
    j_dt.test_significance(full, params("de_novo", j_config.DE_NOVO_THRESH),
                           out("de_novo.tombo.stats"), fasta=fasta,
                           std_ref=model, num_processes=2)
    j_dt.test_significance(full, params("model_compare",
                                        {"DNA": (None, 0.0)}),
                           out("alt.tombo.stats"), fasta=fasta,
                           std_ref=model,
                           alt_refs=j_load_alt_refs(ALTS, "DNA"),
                           num_processes=2)
    j_dt.test_significance(samp, params("sample_compare",
                                        j_config.SAMP_COMP_THRESH),
                           out("sample_compare.tombo.stats"), fasta=fasta,
                           std_ref=model, ctrl_reads_index=ctrl,
                           num_processes=2)
    j_dt.test_significance(samp, params("ks", min_test_reads=3),
                           out("ks.tombo.stats"), ctrl_reads_index=ctrl,
                           num_processes=2)


def _blocks(fn):
    cls = LevelStats if os.path.basename(fn).startswith("ks") else ModelStats
    f = cls(fn)
    try:
        return [(c, s, st, b) for c, s, st, _, b in f], f.stat_type
    finally:
        f.close()


def _assert_blocks(got_fn, want_fn, frac_rtol=0.0, stat_rtol=0.0):
    got, got_type = _blocks(got_fn)
    want, want_type = _blocks(want_fn)
    assert got_type == want_type
    assert [b[:3] for b in got] == [b[:3] for b in want]
    sites = 0
    for (_, _, _, a), (_, _, _, b) in zip(got, want):
        assert a.dtype == b.dtype
        sites += a.shape[0]
        for name in a.dtype.names:
            if a[name].dtype.kind != "f":
                np.testing.assert_array_equal(a[name], b[name])
            else:
                np.testing.assert_allclose(
                    a[name], b[name], rtol=stat_rtol if name == "stat"
                    else frac_rtol, atol=0, equal_nan=True)
    assert sites > 300
    return sites


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("stat", sorted(STATS))
def test_stats_files_equal_across_host_counts(runs, stat, dtype):
    """The files of 2 and 3 processes are the 1-process files, bit for
    bit in every value, at float64 and at float32."""
    for fn in STATS[stat]:
        for n_hosts in (2, 3):
            _assert_blocks(os.path.join(runs["dirs"][(n_hosts, dtype)], fn),
                           os.path.join(runs["dirs"][(1, dtype)], fn))
        # only the main host writes the statistics files
        assert not glob.glob(os.path.join(runs["dirs"][(2, dtype)],
                                          fn + ".host*"))


@pytest.mark.parametrize("stat", sorted(STATS))
def test_float64_files_match_jax_single_host(runs, stat):
    """At float64 the 3-process files equal the JAX package's single-host
    files: positions and coverage exact, fractions within 1e-12, the KS
    statistic within 1e-9."""
    for fn in STATS[stat]:
        _assert_blocks(os.path.join(runs["dirs"][(3, "float64")], fn),
                       os.path.join(runs["jax"], fn), frac_rtol=1e-12,
                       stat_rtol=1e-9)


def _per_read_records(fns):
    """{(chrm, strand, start): sorted (pos, read id, stat) records} over
    per-read files, read ids by name."""
    out = {}
    for fn in fns:
        f = PerReadStats(fn)
        try:
            for chrm, strand, start, block, names in \
                    f.iter_per_read_blocks():
                out.setdefault((chrm, strand, start), []).extend(
                    (int(p), names[int(r)], float(s))
                    for p, s, r in zip(block["pos"], block["stat"],
                                       block["read_id"]))
        finally:
            f.close()
    return {k: sorted(v) for k, v in out.items()}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("stat", sorted(PER_READ))
def test_per_read_host_files_union_is_single_host(runs, stat, dtype):
    """Each host writes the per-read blocks of its own reads to
    ``<file>.host<i>``; their union, matched by read id, is the
    single-host file, and no read is in two hosts' files."""
    for fn in PER_READ[stat]:
        want = _per_read_records([os.path.join(runs["dirs"][(1, dtype)],
                                               fn)])
        assert sum(len(v) for v in want.values()) > 1000
        for n_hosts in (2, 3):
            d = runs["dirs"][(n_hosts, dtype)]
            assert not os.path.exists(os.path.join(d, fn))
            host_fns = [os.path.join(d, "%s.host%d" % (fn, i))
                        for i in range(n_hosts)]
            assert _per_read_records(host_fns) == want
            owners = [{r for recs in _per_read_records([h]).values()
                       for _, r, _ in recs} for h in host_fns]
            assert sum(len(o) for o in owners) == len(set().union(*owners))


def test_multi_host_runs_write_no_sidecar(runs):
    """The 3- and 2-host runs load every read from FAST5 and append
    nothing to the levels sidecar; the 1-host runs after them write it."""
    assert runs["sidecars"][3] == [] and runs["sidecars"][2] == []
    assert runs["sidecars"][1]
