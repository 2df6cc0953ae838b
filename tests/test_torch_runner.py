"""The port's re-squiggle runner (``pipeline/runner.py``, ``ingest.py``,
the FAST5, index and sidecar writers) held against the JAX runner on two
copies of one FAST5 directory, both at float64 on the CPU through the
native minimizer aligner.

The dataset has reads with 8% basecall errors, two basecall subgroups, a
read whose reference span holds non-canonical bases, a read outside
``--signal-length-range`` and an unmappable read.  The port's run, inline
or with writer processes or with the ingest pool, writes every corrected
group bitwise the JAX run's (every dataset and attribute), the same
error statuses, index, levels sidecar records, summary and failed-reads
file; each package's ReadsIndex reads the other's index.  Also: the
``.host1`` index shard of a two-host run, ``estimate_global_scale``, the
in-memory read source against the FAST5 one, and the writer processes'
flush barrier."""
import os
import pickle
import shutil

import h5py
import jax.numpy as jnp
import numpy as np
import pytest

from tombo_tpu import config as j_config
from tombo_tpu.io.fasta import Fasta as JFasta
from tombo_tpu.io.index import ReadsIndex as JReadsIndex
from tombo_tpu.io.model_io import KmerModel as JKmerModel
from tombo_tpu.parallel.distributed import DistContext as JDist
from tombo_tpu.pipeline import runner as j_runner
from tombo_tpu.pipeline.aligner import MinimizerAligner as JMinimizer
from tombo_tpu.pipeline.batch import BatchedResquiggler as JBatched
from tombo_tpu.stats import levels_cache as j_lc
from tombo_tpu.testing import (make_synthetic_dataset, random_reference,
                               simulate_read, write_synthetic_fast5)
from tombo_tpu.types import SeqSampleType as JSst
from tombo_tpu_torch import config as t_config
from tombo_tpu_torch.io import fast5 as t_fast5
from tombo_tpu_torch.io.fasta import Fasta as TFasta
from tombo_tpu_torch.io.index import ReadsIndex as TReadsIndex
from tombo_tpu_torch.io.model_io import KmerModel as TKmerModel
from tombo_tpu_torch.parallel.distributed import DistContext as TDist
from tombo_tpu_torch.pipeline import ingest as t_ingest
from tombo_tpu_torch.pipeline import runner as t_runner
from tombo_tpu_torch.pipeline.aligner import MinimizerAligner as TMinimizer
from tombo_tpu_torch.pipeline.batch import BatchedResquiggler as TBatched
from tombo_tpu_torch.stats import levels_cache as t_lc
from tombo_tpu_torch.types import SeqSampleType as TSst
from tombo_tpu_torch.types import SequenceData as TSequenceData

DNA = "DNA"
SUBGROUPS = ("BaseCalled_template", "BaseCalled_complement")
CG = j_config.DEFAULT_CORRECTED_GROUP
BATCH = 8


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """(directory with fast5s/ and reference.fasta, signal length
    range)."""
    base = str(tmp_path_factory.mktemp("runner_ds"))
    _, reads, fast5_dir = make_synthetic_dataset(
        base, n_reads=12, seed=31, read_len=450, ref_len=9000,
        noisy_frac=0.6, noisy_err=0.08)
    model = JKmerModel.load_default(DNA)
    rng = np.random.default_rng(8)
    other = random_reference(np.random.default_rng(99), 4000, name="other")
    bad = simulate_read(rng, other, model, read_len=400,
                        read_id="unmappable")
    write_synthetic_fast5(os.path.join(fast5_dir, "unmappable.fast5"), bad)
    # non-canonical bases in the reference inside the first read's span
    fa = JFasta(os.path.join(base, "reference.fasta"))
    chrm = fa.iter_chrms()[0]
    seq = list(fa.get_seq(chrm))
    mid = (reads[0].start + reads[0].end) // 2
    seq[mid:mid + 3] = "NNN"
    JFasta(seqs={chrm: "".join(seq)}).write(
        os.path.join(base, "reference.fasta"))
    # a second basecall subgroup in every file
    for fn in sorted(os.listdir(fast5_dir)):
        with h5py.File(os.path.join(fast5_dir, fn), "r+") as f:
            src = "Analyses/%s/%s" % (j_config.DEFAULT_BASECALL_GROUP,
                                      SUBGROUPS[0])
            f.copy(f[src], f[src].parent, name=SUBGROUPS[1])
    # the longest signal falls outside the range (its bounds are
    # exclusive)
    lens = []
    for fn in sorted(os.listdir(fast5_dir)):
        with h5py.File(os.path.join(fast5_dir, fn), "r") as f:
            lens.append(next(iter(f["Raw/Reads"].values()))["Signal"]
                        .shape[0])
    return base, (100, max(lens))


def _copy(dataset, dst):
    base, _ = dataset
    shutil.copytree(os.path.join(base, "fast5s"), dst)
    return dst


def _ref_fn(dataset):
    return os.path.join(dataset[0], "reference.fasta")


def _run_jax(dataset, fast5_dir, **kw):
    model = JKmerModel.load_default(DNA)
    sst = JSst(DNA, False)
    params = j_config.load_resquiggle_parameters(DNA)
    rc = j_runner.RunConfig(
        overwrite=True, batch_size=BATCH, num_io_threads=2,
        basecall_subgroups=SUBGROUPS, signal_length_range=dataset[1],
        failed_reads_fn=fast5_dir + ".failed.txt", num_write_procs=0,
        **kw)
    br = JBatched(model, params, sst, j_config.OUTLIER_THRESH,
                  dtype=jnp.float64)
    summary, _ = j_runner.resquiggle_all_reads(
        fast5_dir, JMinimizer(JFasta(_ref_fn(dataset))), model, sst, params,
        rc, resquiggler=br)
    return summary


def _run_port(dataset, fast5_dir, **kw):
    model = TKmerModel.load_default(DNA)
    sst = TSst(DNA, False)
    params = t_config.load_resquiggle_parameters(DNA)
    opts = dict(num_write_procs=0)
    opts.update(kw)
    rc = t_runner.RunConfig(
        overwrite=True, batch_size=BATCH, num_io_threads=2,
        basecall_subgroups=SUBGROUPS, signal_length_range=dataset[1],
        failed_reads_fn=fast5_dir + ".failed.txt", **opts)
    br = TBatched(model, params, sst, t_config.OUTLIER_THRESH,
                  dtype="float64", device="cpu")
    summary, index = t_runner.resquiggle_all_reads(
        fast5_dir, TMinimizer(TFasta.read(_ref_fn(dataset))), model, sst,
        params, rc, resquiggler=br)
    return summary, index


def _walk(fast5_dir):
    """Every attribute and dataset under each file's corrected group:
    {(file, path): ("attr", value, dtype) or ("data", array)}."""
    out = {}
    for fn in sorted(os.listdir(fast5_dir)):
        if not fn.endswith(".fast5"):
            continue
        with h5py.File(os.path.join(fast5_dir, fn), "r") as f:
            if "Analyses/" + CG not in f:
                continue

            def visit(name, obj, fn=fn):
                for k, v in obj.attrs.items():
                    out[(fn, name, k)] = ("attr", v,
                                          getattr(v, "dtype", type(v)))
                if isinstance(obj, h5py.Dataset):
                    out[(fn, name)] = ("data", obj[()], obj.dtype,
                                       obj.compression)
            grp = f["Analyses/" + CG]
            visit("", grp)
            grp.visititems(visit)
    return out


def _assert_same_groups(a, b, f64_rtol=0.0):
    """Every group, dataset and attribute of ``a`` is in ``b`` with the
    same dtype, compression and value; with ``f64_rtol`` float64 values
    are held to that relative bar instead of bit for bit."""
    assert sorted(a) == sorted(b)

    def same(x, y, key):
        if f64_rtol and np.asarray(x).dtype == np.float64:
            np.testing.assert_allclose(x, y, rtol=f64_rtol, atol=0,
                                       err_msg=str(key))
        else:
            np.testing.assert_array_equal(x, y, err_msg=str(key))

    for key, va in a.items():
        vb = b[key]
        assert va[0] == vb[0] and va[2] == vb[2], key
        if va[0] == "data":
            assert va[3] == vb[3], key
            for name in va[1].dtype.names:
                same(va[1][name], vb[1][name], key)
        else:
            same(va[1], vb[1], key)


def _index_pickle(fast5_dir, suffix=""):
    d = os.path.dirname(fast5_dir.rstrip("/"))
    fn = os.path.join(d, "." + os.path.basename(fast5_dir) + "." + CG +
                      ".tombo.index" + suffix)
    with open(fn, "rb") as fp:
        return pickle.load(fp)


def _failed_lines(fast5_dir):
    with open(fast5_dir + ".failed.txt") as fp:
        return [ln.replace(fast5_dir, "<dir>") for ln in fp]


def _sidecar(fast5_dir, lc_mod):
    """{(file, group): (means, seq, read id, fresh)} of each key's last
    record; ``fresh``: its (mtime_ns, size) are the file's now (writing a
    read's second subgroup leaves the first one's record stale, in both
    packages)."""
    out = {}
    for sg in SUBGROUPS:
        group = CG + "/" + sg
        cache = lc_mod.LevelsCache(lc_mod.cache_fn(fast5_dir, group))
        for (fn, grp), ents in cache._idx.items():
            _, _, mt, sz = ents[-1]
            path = os.path.join(fast5_dir, fn)
            st = os.stat(path)
            out[(fn, grp)] = cache.get(path, grp, mt, sz) + (
                (mt, sz) == (st.st_mtime_ns, st.st_size),)
        cache.close()
    return out


def _index_rows(idx, fast5_dir):
    return sorted(
        (chrm, strand, rd.start, rd.end, os.path.relpath(rd.fn, fast5_dir),
         rd.corr_group, rd.filtered, rd.read_start_rel_to_raw,
         rd.sig_match_score, rd.mean_q_score, rd.read_id)
        for (chrm, strand), reads in idx.reads_index.items()
        for rd in reads)


# float64 values computed by the re-squiggle lanes (normalized means,
# signal-match score, a fitted shift) differ from the JAX lane's by a few
# ulps where XLA contracts multiply-adds; everything else is bit for bit
F64_RTOL = 1e-12


def _assert_index_close(a, b):
    """Index pickles equal, the signal-match score (field 8) to
    F64_RTOL."""
    assert sorted(a) == sorted(b)
    for cs, recs in a.items():
        assert len(recs) == len(b[cs])
        for ra, rb in zip(recs, b[cs]):
            assert ra[:8] + ra[9:] == rb[:8] + rb[9:]
            np.testing.assert_allclose(ra[8], rb[8], rtol=F64_RTOL, atol=0)


def _rows_no_score(rows):
    return [r[:8] + r[9:] for r in rows]


@pytest.fixture(scope="module")
def jax_run(dataset, tmp_path_factory):
    d = _copy(dataset, str(tmp_path_factory.mktemp("jax_run") / "fast5s"))
    summary = _run_jax(dataset, d)
    return d, summary, _walk(d)


@pytest.fixture(scope="module")
def port_inline(dataset, tmp_path_factory):
    d = _copy(dataset, str(tmp_path_factory.mktemp("port_run") / "fast5s"))
    summary, _ = _run_port(dataset, d)
    return d, summary, _walk(d)


def test_runner_matches_jax_runner(jax_run, port_inline):
    """Inline writeback against the JAX run: summary, failure modes,
    failed-reads file, every corrected group and error status, the index
    (each package reads the other's) and the sidecar records."""
    j_dir, j_summary, j_groups = jax_run
    t_dir, t_summary, t_groups = port_inline
    assert t_summary.as_dict() == j_summary.as_dict()
    modes = t_summary.failure_modes
    for mode in ("Reference mapping contains non-canonical bases",
                 "Raw signal not within --signal-length-range",
                 "Alignment not produced"):
        assert modes[mode] == 2, modes        # one read, two subgroups
    assert t_summary.n_success >= 20
    assert _failed_lines(t_dir) == _failed_lines(j_dir)
    _assert_same_groups(t_groups, j_groups, F64_RTOL)
    _assert_index_close(_index_pickle(t_dir), _index_pickle(j_dir))
    rows = [_rows_no_score(_index_rows(idx, d)) for idx, d in (
        (JReadsIndex([t_dir]), t_dir), (JReadsIndex([j_dir]), j_dir),
        (TReadsIndex([j_dir]), j_dir), (TReadsIndex([t_dir]), t_dir))]
    assert len(rows[0]) == t_summary.n_success
    assert rows[0] == rows[1] == rows[2] == rows[3]
    t_side, j_side = _sidecar(t_dir, t_lc), _sidecar(j_dir, j_lc)
    assert len(t_side) == t_summary.n_success
    assert sum(v[3] for v in t_side.values()) == t_summary.n_success // 2
    assert sorted(t_side) == sorted(j_side)
    for k, (m, seq, rid, fresh) in t_side.items():
        np.testing.assert_allclose(m, j_side[k][0], rtol=F64_RTOL, atol=0)
        assert (seq, rid, fresh) == j_side[k][1:]
    # each package's sidecar reader serves the other's records
    assert sorted(_sidecar(t_dir, j_lc)) == sorted(t_side)


@pytest.mark.parametrize("lane", ["writer_procs", "ingest_pool"])
def test_runner_lanes_write_the_same_files(dataset, port_inline, tmp_path,
                                           lane):
    """Writer processes, and the spawned ingest pool, give inline
    writeback's files bit for bit: groups, index, sidecar records,
    summary and failed-reads file."""
    i_dir, i_summary, i_groups = port_inline
    t_dir = _copy(dataset, str(tmp_path / "fast5s"))
    kw = {"writer_procs": dict(num_write_procs=2),
          "ingest_pool": dict(ingest_min=1, ingest_procs=2)}[lane]
    try:
        t_summary, _ = _run_port(dataset, t_dir, **kw)
    finally:
        t_ingest.shutdown_pool()
        t_runner.shutdown_write_pool()
    assert t_summary.as_dict() == i_summary.as_dict()
    assert _failed_lines(t_dir) == _failed_lines(i_dir)
    _assert_same_groups(_walk(t_dir), i_groups)
    assert _index_pickle(t_dir) == _index_pickle(i_dir)
    t_side, i_side = _sidecar(t_dir, t_lc), _sidecar(i_dir, t_lc)
    assert sorted(t_side) == sorted(i_side)
    for k, (m, seq, rid, fresh) in t_side.items():
        np.testing.assert_array_equal(m, i_side[k][0])
        assert (seq, rid, fresh) == i_side[k][1:]


def test_host_shard_index(dataset, tmp_path):
    """A two-host run's host 1 re-squiggles its hash shard of the files
    and writes the ``.host1`` index shard, the JAX run's."""
    j_dir = _copy(dataset, str(tmp_path / "j" / "fast5s"))
    t_dir = _copy(dataset, str(tmp_path / "t" / "fast5s"))
    j_sum = _run_jax(dataset, j_dir, dist=JDist(2, 1))
    t_sum, _ = _run_port(dataset, t_dir, dist=TDist(2, 1))
    assert t_sum.as_dict() == j_sum.as_dict()
    assert 0 < t_sum.n_success + t_sum.n_failed < 2 * 15
    _assert_index_close(_index_pickle(t_dir, ".host1"),
                        _index_pickle(j_dir, ".host1"))
    assert not os.path.exists(os.path.join(
        os.path.dirname(t_dir), ".fast5s.%s.tombo.index" % CG))
    assert (_rows_no_score(_index_rows(TReadsIndex([t_dir]), t_dir)) ==
            _rows_no_score(_index_rows(JReadsIndex([j_dir]), j_dir)))
    _assert_same_groups(_walk(t_dir), _walk(j_dir), F64_RTOL)


def test_estimate_global_scale_matches_jax(dataset):
    fns = list(t_fast5.iter_fast5_reads(os.path.join(dataset[0],
                                                     "fast5s")))
    assert (t_runner.estimate_global_scale(fns, len(fns)) ==
            j_runner.estimate_global_scale(fns, len(fns)))


def test_memory_source_matches_fast5_source(dataset, jax_run, tmp_path):
    """The in-memory source (names, raw signals, basecalls) gives the
    FAST5 run's results, summary and index and writes no file."""
    j_dir, _, _ = jax_run
    src_dir = os.path.join(dataset[0], "fast5s")
    reads = []
    for fn in sorted(os.listdir(src_dir)):
        with h5py.File(os.path.join(src_dir, fn), "r") as f:
            reads.append((fn, t_fast5.get_raw_signal(f),
                          t_fast5.get_read_seq(f)))
    before = sorted(os.listdir(tmp_path))
    model = TKmerModel.load_default(DNA)
    sst = TSst(DNA, False)
    params = t_config.load_resquiggle_parameters(DNA)
    rc = t_runner.RunConfig(batch_size=BATCH, num_io_threads=2,
                            signal_length_range=dataset[1])
    summary, index = t_runner.resquiggle_all_reads(
        t_runner.MemoryReads(reads), TMinimizer(TFasta.read(
            _ref_fn(dataset))), model, sst, params, rc,
        resquiggler=TBatched(model, params, sst, dtype="float64",
                             device="cpu"))
    assert sorted(os.listdir(tmp_path)) == before
    # the JAX run's template subgroup alone
    j_rows = [r for r in _index_rows(JReadsIndex([j_dir]), j_dir)
              if r[5].endswith(SUBGROUPS[0])]
    t_rows = _index_rows(index, ".")
    assert [r[:4] + r[5:8] + r[9:] for r in t_rows] == \
        [r[:4] + r[5:8] + r[9:] for r in j_rows]
    assert summary.n_success == len(j_rows)
    assert summary.timings["run"] > 0


def test_memory_source_q_score_filter():
    src = t_runner.MemoryReads([("a", np.zeros(10, np.int16),
                                 TSequenceData("ACGT", "a", 5.0))])
    rc = t_runner.RunConfig(q_score_thresh=7.0)
    raw, seqs = src.read("a", rc, False)
    assert str(seqs[0]) == "Read filtered by q-score."


def test_writer_flush_reports_failures_with_the_barrier(tmp_path):
    """A write that fails in a writer process is answered with the flush
    barrier itself, never after it; written files are closed by then."""
    from tombo_tpu_torch.types import (AlignInfo, GenomeLocation,
                                       ResquiggleResults, ScaleValues)
    res = ResquiggleResults(
        align_info=AlignInfo(read_id="x"),
        genome_loc=GenomeLocation(0, "+", "c"), genome_seq="ACGT",
        raw_signal=np.arange(8, dtype=np.float64),
        read_start_rel_to_raw=0, segs=np.array([0, 2, 4, 6, 8]),
        scale_values=ScaleValues(0.0, 1.0), sig_match_score=0.5)
    good = str(tmp_path / "good.fast5")
    with h5py.File(good, "w") as f:
        f.create_group("Analyses/" + CG)
    writers = t_runner._ShardedWriters(2)
    try:
        for i in range(6):
            writers.submit(str(tmp_path / ("missing%d.fast5" % i)), res, CG,
                           False, False, None, False)
        writers.submit(good, res, CG, False, False, None, True)
        errs = writers.flush()
        assert sorted(errs) == sorted(
            (str(tmp_path / ("missing%d.fast5" % i)), "BaseCalled_template")
            for i in range(6))
        with h5py.File(good, "r") as f:
            assert "Events" in f["Analyses/%s/BaseCalled_template" % CG]
        assert writers.flush() == []
    finally:
        writers.shutdown()
