"""The port's host library (``tombo_tpu_torch/native.py`` over its copies
of ``csrc/tombo_native.cpp`` and ``csrc/resquiggle_baseline.cpp``) against
the JAX package's bindings (``tombo_tpu/native``) on the same seeded numpy
inputs, bit for bit: the sources are the same and so are the flags.  Also:
the three host steps of ``pipeline/resquiggle.py`` that now call the
library equal their numpy plain versions, and a build without a compiler
raises instead of falling back."""
import dataclasses
import shutil

import numpy as np
import pytest

from tombo_tpu import config as j_config
from tombo_tpu import native as j_native
from tombo_tpu import testing as j_testing
from tombo_tpu.errors import TomboTpuError
from tombo_tpu.io.model_io import KmerModel as JKmerModel
from tombo_tpu.pipeline import resquiggle as j_rsq
from tombo_tpu.pipeline.aligner import ExactAligner as JExactAligner
from tombo_tpu.types import SeqSampleType as JSeqSampleType
from tombo_tpu.types import SequenceData as JSequenceData
from tombo_tpu_torch import config as t_config
from tombo_tpu_torch import convert, native
from tombo_tpu_torch.errors import TomboError
from tombo_tpu_torch.ops import ref_impl
from tombo_tpu_torch.pipeline import resquiggle as t_rsq
from tombo_tpu_torch.types import DpResults


@pytest.fixture(scope="module", autouse=True)
def jax_lib():
    assert j_native.get_lib() is not None, "the JAX native library is needed"


def _equal(a, b):
    """Bitwise equality of nested tuples/lists of arrays and scalars."""
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
        assert a.tobytes() == np.asarray(b).tobytes()
    else:
        assert a == b or (np.isnan(a) and np.isnan(b))


def _scores(rng, B, lo, hi, ties=False):
    lens = rng.integers(lo, hi, B)
    C = int(lens.max())
    scores = np.full((B, C), -1.0)
    for b in range(B):
        n = int(lens[b])
        scores[b, :n] = (rng.integers(0, 20, n) if ties
                         else rng.random(n) * 100)
    return scores, lens.astype(np.int64)


@pytest.mark.parametrize("case", ["capped", "ties", "too_few", "uncapped"])
def test_greedy_cpts(case):
    rng = np.random.default_rng(7)
    if case == "uncapped":
        s = rng.random(2500) * 50
        _equal(native.greedy_cpts_uncapped(s, 3),
               j_native.greedy_cpts_uncapped(s, 3))
        return
    if case == "too_few":
        scores, n_cands = np.array([[5.0, 4.0, 3.0, 2.0, 1.0]]), np.array([5])
        num = np.array([4])
    else:
        scores, n_cands = _scores(rng, 8, 500, 3000, ties=case == "ties")
        num = n_cands // 12
    t = native.greedy_cpts_batch(scores, n_cands, num, shift=5,
                                 min_base_obs=3)
    _equal(t, j_native.greedy_cpts_batch(scores, n_cands, num, shift=5,
                                         min_base_obs=3))
    assert (t[1] == (1 if case == "too_few" else 0)).all()


@pytest.mark.parametrize("variant", ["exact", "fast", "f32"])
def test_theil_sen_batch(variant):
    rng = np.random.default_rng(17)
    B, max_n = 6, 700
    n_pts = rng.integers(10, max_n + 1, B)
    ev = rng.normal(0, 1, (B, max_n))
    mod = 0.8 * ev + 0.1 + rng.normal(0, 0.2, (B, max_n))
    ev[:, 2] = ev[:, 1]                    # equal event means: max slope
    ev[1] = np.round(ev[1], 2)             # ties
    kw = {"use_fast": variant == "fast", "use_f32": variant == "f32"}
    _equal(native.theil_sen_batch(ev, mod, n_pts, **kw),
           j_native.theil_sen_batch(ev, mod, n_pts, **kw))


def _windows(seed, n_windows=12, min_obs=4):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_windows):
        n_ev = int(rng.integers(3, 12))
        sig_len = int(rng.integers(n_ev * (min_obs + 2) + 5, n_ev * 15))
        out.append((rng.normal(0, 1, sig_len), rng.normal(0, 1, n_ev),
                    np.abs(rng.normal(1, 0.1, n_ev)),
                    np.linspace(0, sig_len, n_ev + 1).astype(np.int64)))
    return out


@pytest.mark.parametrize("max_half_z", [20.0, None])
def test_raw_windows_dp_batch(max_half_z):
    windows = _windows(23)
    t = native.raw_windows_dp_batch(windows, 4, max_half_z)
    _equal(t, j_native.raw_windows_dp_batch(windows, 4, max_half_z))
    assert (t[1] == 0).all()


# tests/test_native.py's four shapes (bases, events)
STATIC_SHAPES = [(40, 120), (150, 420), (220, 300), (333, 901)]


@pytest.mark.parametrize("seq_len,events_len", STATIC_SHAPES)
def test_static_base_assignment(seq_len, events_len):
    rng = np.random.default_rng(seq_len)
    p = t_config.load_resquiggle_parameters("DNA")
    ev = rng.normal(0, 1, events_len)
    rm = rng.normal(0, 1, seq_len)
    rs = rng.uniform(0.2, 0.6, seq_len)
    args = (ev, rm, rs, p.z_shift, p.skip_pen, p.stay_pen,
            p.max_half_z_score)
    _equal(native.static_base_assignment(*args),
           j_native.static_base_assignment(*args))


def _finalize_jobs(seed, n_jobs=6):
    """Jobs in the layout of the JAX lane's finalize (tombo_tpu/pipeline/
    batch.py:2330-2372): the mapped raw slice, scale values (a read with
    no limits among them), expected levels, a segment table with
    zero-length segments on the reads flagged for the deletion fix
    (has_del 1; 0 clean; -1 unknown) and the Theil-Sen subsample above
    1,000 bases."""
    rng = np.random.default_rng(seed)
    model = JKmerModel.load_default("DNA")
    jobs = []
    for r in range(n_jobs):
        L = [400, 900, 1300][r % 3]
        codes = rng.integers(0, model.means.shape[0], L)
        rm, rs = model.means[codes], model.sds[codes]
        dwells = np.maximum(2, rng.poisson(5, L) + 2)
        sig = np.repeat(rm, dwells) + rng.normal(0, 0.15, dwells.sum())
        raw = np.round(sig * 60 + 450).astype(np.float64)
        segs = np.concatenate([[0], np.cumsum(dwells)]).astype(np.int64)
        segs[1:-1] += rng.integers(-1, 2, L - 1)
        has_del = [1, 0, -1][r % 3]
        if has_del:
            for k in rng.choice(np.arange(10, L - 10), 3, replace=False):
                segs[k] = segs[k + 1]
        shift = float(np.median(raw))
        scale = float(np.median(np.abs(raw - shift)))
        lims = (None, None) if r == 1 else (-5.0, 5.0)
        samp = (np.random.default_rng(0).choice(L, 1000, replace=False)
                if L > 1000 else None)
        jobs.append((raw, shift, scale) + lims +
                    (rm, rs, segs, has_del, samp))
    return jobs


@pytest.mark.parametrize("ts_mode", [-1, 0, 1, 2])
def test_finalize_batch(ts_mode):
    jobs = _finalize_jobs(11)
    j_params = j_config.load_resquiggle_parameters("DNA")
    t_params = t_config.load_resquiggle_parameters("DNA")
    _equal(native.finalize_batch(jobs, t_params, ts_mode),
           j_native.finalize_batch(jobs, j_params, ts_mode))


@pytest.mark.parametrize("samp_type", ["DNA", "RNA"])
def test_del_fix_batch(samp_type):
    jobs = [((raw - sh) / sc, rm, rs, segs)
            for raw, sh, sc, _, _, rm, rs, segs, hd, _ in
            _finalize_jobs(13, 9) if hd]
    t = native.del_fix_batch(jobs, t_config.load_resquiggle_parameters(
        samp_type))
    _equal(t, j_native.del_fix_batch(
        jobs, j_config.load_resquiggle_parameters(samp_type)))
    assert (t[1] == 0).any()


@pytest.mark.parametrize("case", ["small_deltas", "escapes", "short_buffer"])
def test_pack_delta8_batch(case):
    spread = 20 if case == "small_deltas" else 400
    rng = np.random.default_rng(spread)
    raws = [np.cumsum(rng.integers(-spread, spread + 1, n)).astype(np.int16)
            for n in rng.integers(50, 4000, 7)]
    lens = np.array([r.shape[0] for r in raws], np.int64)
    offs = np.concatenate([[0], np.cumsum(lens - 1)[:-1]])
    flat_t = np.zeros(int((lens - 1).sum()), np.int8)
    flat_j = flat_t.copy()
    if case == "short_buffer":
        # checked before any pointer reaches the library
        with pytest.raises(ValueError, match="flat8"):
            native.pack_delta8_batch(raws, lens, flat_t[:-1], offs)
        return
    t = native.pack_delta8_batch(raws, lens, flat_t, offs)
    j = j_native.pack_delta8_batch(raws, lens, flat_j, offs)
    _equal(flat_t, flat_j)
    _equal(t[0], j[0])
    # the threads append escapes in the order they finish: compare them
    # ordered by (read, position)
    order = lambda x: np.lexsort((x[2], x[1]))
    _equal([a[order(t)] for a in t[1:]], [a[order(j)] for a in j[1:]])
    assert (t[1].shape[0] > 0) == (case == "escapes")


def _baseline_reads(samp, n, seed):
    rng = np.random.default_rng(seed)
    model = JKmerModel.load_default(samp)
    fasta = j_testing.random_reference(np.random.default_rng(seed + 1),
                                       40000)
    aligner = JExactAligner(fasta)
    sst = JSeqSampleType(samp, samp == "RNA")
    params = j_config.load_resquiggle_parameters(samp)
    kw = (dict(read_len=950, rev_sig=True, mean_dwell=24.0,
               adapter_len=(600, 900)) if samp == "RNA"
          else dict(read_len=900))
    maps = []
    for i in range(n):
        read = j_testing.simulate_read(rng, fasta, model,
                                       read_id="bl_%02d" % i, **kw)
        raw = read.raw_signal.astype(np.float64)
        if i == n - 1:                           # a read that fails
            raw = rng.normal(400.0, 5.0, raw.shape[0])
        mr = j_rsq.map_read(JSequenceData(read.seq, read.read_id, 12.0),
                            aligner, model, sst)
        maps.append(j_rsq.adjust_map_res(mr.replace(raw_signal=raw), sst,
                                         params))
    return model, params, maps


def _result_or_error(fn, err, *args, **kw):
    try:
        return fn(*args, **kw)
    except err as e:
        return str(e)


@pytest.mark.parametrize("samp_type", ["DNA", "RNA"])
def test_resquiggle_read_baseline(samp_type):
    """Both baselines, with and without the save-bandwidth retry, on reads
    that succeed and one that fails (the error message equal)."""
    model, j_params, maps = _baseline_reads(samp_type, 4, 71)
    j_save = j_config.load_resquiggle_parameters(samp_type,
                                                 use_save_bandwidth=True)
    t_params = convert.resquiggle_params(dataclasses.asdict(j_params))
    t_save = convert.resquiggle_params(dataclasses.asdict(j_save))
    smt = j_config.SIG_MATCH_THRESH[samp_type]
    ot = j_config.OUTLIER_THRESH
    n_ok = 0
    for mr in maps:
        rm, rs = model.get_exp_levels_from_seq(mr.genome_seq)
        t = _result_or_error(
            native.resquiggle_read_baseline_with_retries, TomboError,
            mr.raw_signal, rm, rs, t_params, t_save, ot, smt,
            stall_ints=mr.stall_ints)
        _equal(t, _result_or_error(
            j_native.resquiggle_read_baseline_with_retries, TomboTpuError,
            mr.raw_signal, rm, rs, j_params, j_save, ot, smt,
            stall_ints=mr.stall_ints))
        n_ok += not isinstance(t, str)
        _equal(_result_or_error(
            native.resquiggle_read_baseline, TomboError, mr.raw_signal, rm,
            rs, t_params, ot, smt, 1, stall_ints=mr.stall_ints),
            _result_or_error(
                j_native.resquiggle_read_baseline, TomboTpuError,
                mr.raw_signal, rm, rs, j_params, ot, smt, 1,
                stall_ints=mr.stall_ints))
    assert n_ok == len(maps) - 1


def _dp_res_with_deletions(seed):
    """A segment table with zero-length segments over simulated signal."""
    rng = np.random.default_rng(seed)
    model = JKmerModel.load_default("DNA")
    L = 600
    codes = rng.integers(0, model.means.shape[0], L)
    rm, rs = model.means[codes], model.sds[codes]
    dwells = np.maximum(2, rng.poisson(5, L) + 2)
    norm = np.repeat(rm, dwells) + rng.normal(0, 0.15, dwells.sum())
    segs = np.concatenate([[0], np.cumsum(dwells)]).astype(np.int64)
    for k in (40, 41, 200, 350, 352, 500):
        segs[k] = segs[k + 1]
    return DpResults(0, segs, rm, rs, "A" * L), norm


@pytest.mark.parametrize("step", ["valid_cpts_w_cap",
                                  "valid_cpts_w_cap_t_test", "static_band",
                                  "del_fix"])
def test_rewired_host_step_equals_its_plain_version(step, monkeypatch):
    """Each host step that calls the library equals its numpy body, and
    calls the library (the plain version runs with the library gone)."""
    p = t_config.load_resquiggle_parameters("DNA")
    rng = np.random.default_rng(5)
    if step.startswith("valid_cpts"):
        # integer DAC levels: many tied scores
        sig = np.repeat(rng.integers(400, 460, 700),
                        rng.integers(3, 9, 700)).astype(np.float64)
        args = (sig, p.min_obs_per_base, p.running_stat_width,
                sig.shape[0] // 8)
        got = getattr(t_rsq, step)(*args)
        plain = lambda: getattr(ref_impl, step)(*args)
    elif step == "static_band":
        ev, rm = rng.normal(0, 1, 700), rng.normal(0, 1, 260)
        rs = rng.uniform(0.2, 0.6, 260)
        got = t_rsq.find_static_base_assignment(ev, rm, rs, p)
        plain = lambda: t_rsq._find_static_base_assignment_plain(ev, rm, rs,
                                                                 p)
    else:
        dp_res, norm = _dp_res_with_deletions(9)
        assert t_rsq.plan_del_fix_windows(dp_res, p)
        got = t_rsq.resolve_skipped_bases_with_raw(dp_res, norm, p)
        plain = lambda: t_rsq._resolve_skipped_bases_with_raw_plain(
            dp_res, norm, p)

    def gone():
        raise AssertionError("the plain version called the library")
    monkeypatch.setattr(native, "get_native_lib", gone)
    _equal(got, plain())


@pytest.mark.parametrize("name", ["aligner", "tombo_native"])
def test_no_compiler_raises(name, monkeypatch):
    monkeypatch.setattr(native, native.LIBRARIES[name][2], None)
    monkeypatch.setattr(shutil, "which", lambda *a, **kw: None)
    with pytest.raises(TomboError, match="no C\\+\\+ compiler"):
        native._load(name)
    if name == "tombo_native":
        with pytest.raises(TomboError, match="no C\\+\\+ compiler"):
            native.greedy_cpts_uncapped(np.arange(10.0), 2)
