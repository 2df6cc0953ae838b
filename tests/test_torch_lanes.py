"""The finalize lanes of the port's batched re-squiggle
(``tombo_tpu_torch/pipeline/batch.py``: ``FinalizeLanes``,
``BatchedResquiggler(lanes=)``) on the CPU, against the JAX package's
batched lane run under the environment switches each lane stands for,
set by the test around the JAX call alone.

Each of the six lanes that differ from the default runs a DNA batch (6
reads of 500 bases at a mean dwell of 14 samples, two of them with a
zero-length segment in the first pass) in both packages at float32:
the same reads reach each call of the host library (``finalize_batch``,
``del_fix_batch``, ``theil_sen_batch``) and the device Theil-Sen
blocks, a read known by its reference levels; the results lie within
tests/test_batch_parity.py's float32 bars of the JAX lane's; the stage
profile's keys equal the JAX profiler's.  Two reads of the RNA recipe
of tests/test_torch_rna.py (one clean, one with a 3,000-sample stall)
run each lane too, one scaling pass, held to the JAX float64 lane (the
JAX float32 RNA lane is no reference there; the JAX float64 lane's
results do not depend on the switches).  At float64 the lanes are
bitwise the JAX float64 lane under the same switches (three of the DNA
reads; the lanes that set every switch the float64 lane ignores run end
to end, every lane's decisions alone).  The device Theil-Sen blocks are bitwise the JAX function's on the same
float32 points, and the lane reaches them with 32 host-lane reads.  The
deletion-rate gate keeps the JAX counters and decisions, and a closed
gate skips the fit in both packages.  A 2-shard mesh without the device
deletion fix is held to the JAX mesh lane, and a run's ``RunConfig.lanes``
reaches its resquiggler and the save-bandwidth retry's."""
import contextlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tombo_tpu import config as j_config
from tombo_tpu import native as j_native
from tombo_tpu.parallel import mesh as j_mesh
from tombo_tpu.pipeline import batch as j_batch
from tombo_tpu.pipeline.batch import BatchedResquiggler as JBatched
from tombo_tpu_torch import config as t_config
from tombo_tpu_torch import convert, native
from tombo_tpu_torch import testing as t_testing
from tombo_tpu_torch.io.model_io import KmerModel as TKmerModel
from tombo_tpu_torch.parallel import mesh as t_mesh
from tombo_tpu_torch.pipeline import batch as t_batch
from tombo_tpu_torch.pipeline import runner as t_runner
from tombo_tpu_torch.pipeline.aligner import ExactAligner as TExactAligner
from tombo_tpu_torch.pipeline.batch import FinalizeLanes
from tombo_tpu_torch.types import SeqSampleType as TSeqSampleType
from tombo_tpu_torch.types import SequenceData as TSequenceData

from test_torch_batch import (_assert_f32_close, _assert_f64_exact,
                              _convert, _prep_reads)
from test_torch_finalize import _jax_states
from test_torch_profile import _JaxProfile, _same_results
from test_torch_rna import RECIPE, _rna_reads, _t_model

RNA = j_config.RNA_SAMP_TYPE

# lane -> (FinalizeLanes fields, the JAX package's switches)
LANES = {
    "host_trim": ({"device_finalize": False},
                  {"TOMBO_TPU_DEV_FINALIZE": "0"}),
    "fit_gated": ({"device_delfix": False},
                  {"TOMBO_TPU_DEV_DELFIX": "0"}),
    "fit_forced": ({"device_delfix": False, "device_fit": True},
                   {"TOMBO_TPU_DEV_DELFIX": "0", "TOMBO_TPU_DEV_FIT": "1"}),
    "no_device_fit": ({"device_fit": False}, {"TOMBO_TPU_DEV_FIT": "0"}),
    "python_host": ({"native_finalize": False},
                    {"TOMBO_TPU_NATIVE_FINALIZE": "0"}),
    "python_device_ts": ({"device_fit": False, "native_finalize": False,
                          "device_theil_sen": True},
                         {"TOMBO_TPU_DEV_FIT": "0",
                          "TOMBO_TPU_NATIVE_FINALIZE": "0",
                          "TOMBO_TPU_DEV_TS": "1"}),
}
# lanes in which every read finishes on a host lane
ALL_HOST = {"host_trim", "no_device_fit", "python_device_ts"}


@contextlib.contextmanager
def _env(switches):
    """The JAX package's switches set for the block, then restored."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in switches.items():
            mp.setenv(k, v)
        yield


def _lanes(name):
    return FinalizeLanes(**LANES[name][0]) if name != "default" else \
        FinalizeLanes()


def _switches(name):
    return LANES[name][1] if name != "default" else {}


# host-library calls that finish every host-lane read of a pass
FINISHING = ("finalize_batch", "theil_sen_batch", "_theil_sen_device_blocks")


@contextlib.contextmanager
def _host_calls(calls):
    """Each call of either package's host library (and device Theil-Sen
    blocks) appended to ``calls[package]`` as (kind, the reads' keys): a
    read is known by the bytes of its reference levels (or of its fit's
    model points); a fit's key also holds its float32 switch."""
    def rows(mod, n_pts):
        return frozenset(mod[i, :n_pts[i]].tobytes()
                         for i in range(mod.shape[0]))

    kinds = {
        "finalize_batch": lambda jobs, *a, **k: frozenset(
            j[5].tobytes() for j in jobs),
        "del_fix_batch": lambda jobs, *a, **k: frozenset(
            j[1].tobytes() for j in jobs),
        "theil_sen_batch": lambda ev, mod, n_pts, **k: rows(
            mod, n_pts) | {("use_f32", k.get("use_f32"))},
    }
    with pytest.MonkeyPatch.context() as mp:
        for pkg, mod, bmod in (("jax", j_native, j_batch),
                               ("port", native, t_batch)):
            calls.setdefault(pkg, [])
            for kind, key in list(kinds.items()) + [(
                    "_theil_sen_device_blocks",
                    lambda ev, mod, n_pts, *a, **k: rows(mod, n_pts))]:
                owner = bmod if kind.startswith("_") else mod
                fn = getattr(owner, kind)

                def rec(*a, _fn=fn, _kind=kind, _key=key, _pkg=pkg, **kw):
                    calls[_pkg].append((_kind, _key(*a, **kw)))
                    return _fn(*a, **kw)

                mp.setattr(owner, kind, rec)
        yield


def _port(t_inputs, samp_type, dtype, **kw):
    t_model, t_params, _ = t_inputs
    return t_batch.BatchedResquiggler(
        t_model, t_params, convert.seq_samp_type(samp_type,
                                                 samp_type == RNA),
        j_config.OUTLIER_THRESH, dtype=dtype, device="cpu", **kw)


def _jax(j_inputs, dtype, **kw):
    model, params, sst, _ = j_inputs
    return JBatched(model, params, sst, j_config.OUTLIER_THRESH,
                    dtype=getattr(jnp, dtype), **kw)


def _dna(n=6, **sim):
    model, params, sst, maps = _prep_reads(n, **sim)
    t_model = convert.kmer_model(model.means, model.sds, model.central_pos,
                                 model.name, "DNA")
    return (model, params, sst, maps), (t_model, *_convert(params, maps))


@pytest.fixture(scope="module")
def dna():
    return _dna(read_len=500, mean_dwell=14.0)


def _run_both(j_inputs, t_inputs, lane, before=None):
    """Both packages' float32 results, host-library calls and profile keys
    for one lane of the DNA batch; ``before(jax instance, port instance)``
    runs first."""
    calls = {}
    jb = _jax(j_inputs, "float32")
    tb = _port(t_inputs, "DNA", "float32", lanes=_lanes(lane),
               profile=t_batch.StageProfile())
    if before is not None:
        before(jb, tb)
    with _host_calls(calls):
        with _JaxProfile(), _env(dict(_switches(lane),
                                      TOMBO_TPU_PROFILE="1")):
            j_out = jb.resquiggle_batch(j_inputs[3])
            j_keys = set(j_batch.STAGE_TIMINGS)
        t_out = tb.resquiggle_batch(t_inputs[2])
    return {"jax": j_out, "port": t_out, "calls": calls,
            "jax_keys": j_keys, "port_keys": set(tb.profile.timings)}


@pytest.fixture(scope="module")
def dna_f32(dna):
    return {lane: _run_both(*dna, lane)
            for lane in ["default"] + list(LANES)}


def _same_calls(calls):
    assert [k for k, _ in calls["port"]] == [k for k, _ in calls["jax"]]
    for (kind, got), (_, want) in zip(calls["port"], calls["jax"]):
        assert got == want, kind


@pytest.mark.parametrize("lane", list(LANES))
def test_lane_sends_the_jax_lanes_reads(dna_f32, lane):
    """The same host-library calls in the same order, each with the same
    reads (and, for the fit, the same float32 switch); where the lane
    sends every read to the host, all six reach it."""
    run = dna_f32[lane]
    _same_calls(run["calls"])
    calls = run["calls"]["port"]
    python = LANES[lane][0].get("native_finalize") is False
    assert ("finalize_batch" in [k for k, _ in calls]) != python
    assert all(("use_f32", True) in keys for k, keys in calls
               if k == "theil_sen_batch")
    finished = [keys - {("use_f32", True)} for k, keys in calls
                if k in FINISHING]
    if lane in ALL_HOST:
        assert len(finished[0]) == len(run["port"])
    # the default lane fits every read of this batch on the device; the
    # Python host lane takes none of them while the device fit does
    assert not dna_f32["default"]["calls"]["port"]
    assert bool(finished) == (lane != "python_host")


@pytest.mark.parametrize("lane", list(LANES))
def test_lane_results_within_the_float32_bars(dna_f32, lane):
    run = dna_f32[lane]
    assert sum(r is not None for r, _ in run["port"]) >= 5
    for j, t in zip(run["jax"], run["port"]):
        _assert_f32_close(*j, *t, same_start=True)


@pytest.mark.parametrize("lane", list(LANES))
def test_stage_keys_match_jax(dna_f32, lane):
    run = dna_f32[lane]
    assert run["port_keys"] == run["jax_keys"]
    assert {"segment", "adaptive", "finalize"} <= run["port_keys"]
    if lane in ("host_trim", "no_device_fit") or lane.startswith("fit"):
        assert not run["port_keys"] & {"delfix_plan", "delfix_apply"}


@pytest.mark.parametrize("lane", ["default", "host_trim", "fit_gated",
                                  "python_device_ts"])
def test_float64_lane_bitwise_jax(dna, lane):
    """At float64 bitwise the JAX float64 lane under the same switches:
    the default, the one switch the float64 lane heeds (without the
    device finalize every read goes through the host deletion fix, as
    ``TOMBO_TPU_DEV_FINALIZE=0`` sends them), and lanes that set every
    other switch, which the lane ignores (every lane's float64 decisions:
    ``test_lane_decisions_under_a_closed_gate``)."""
    (j_inputs, t_inputs), n = dna, 3
    with _env(_switches(lane)):
        j_out = _jax(j_inputs, "float64").resquiggle_batch(j_inputs[3][:n])
    calls = {}
    with _host_calls(calls):
        t_out = _port(t_inputs, "DNA", "float64", lanes=_lanes(
            lane)).resquiggle_batch(t_inputs[2][:n])
    assert _assert_f64_exact(j_out, t_out) == n
    fixed = [keys for k, keys in calls["port"] if k == "del_fix_batch"]
    if lane == "host_trim":
        assert len(fixed[0]) == len(t_out)
    else:
        assert not fixed or len(fixed[0]) < len(t_out)


@pytest.fixture(scope="module")
def rna():
    model, params, sst, maps, _ = _rna_reads(RECIPE[:4])
    maps = [maps[0], maps[3]]
    return (model, params, sst, maps), (_t_model(model),
                                        *_convert(params, maps))


@pytest.fixture(scope="module")
def rna_f64(rna):
    j_inputs, t_inputs = rna
    return {"jax": _jax(j_inputs, "float64").resquiggle_batch(
                j_inputs[3], max_scaling_iters=1),
            "host_trim": _port(t_inputs, RNA, "float64",
                               lanes=_lanes("host_trim")).resquiggle_batch(
                                   t_inputs[2], max_scaling_iters=1)}


@pytest.mark.parametrize("lane", list(LANES))
def test_rna_lane_within_the_float32_bars(rna, rna_f64, lane):
    """The RNA reads through each lane at float32 (one scaling pass),
    within the float32 bars of the JAX float64 lane, every read."""
    out = _port(rna[1], RNA, "float32", lanes=_lanes(lane)).resquiggle_batch(
        rna[1][2], max_scaling_iters=1)
    assert all(r is not None for r, _ in out)
    for j, t in zip(rna_f64["jax"], out):
        _assert_f32_close(*j, *t, same_start=True)


def test_rna_host_trim_float64_bitwise_jax(rna_f64):
    assert _assert_f64_exact(rna_f64["jax"], rna_f64["host_trim"]) == \
        len(rna_f64["jax"])


def test_default_lanes_are_no_argument(dna, dna_f32):
    """``lanes=FinalizeLanes()`` is the resquiggler without the argument,
    bit for bit, and both keep the JAX package's defaults."""
    out = _port(dna[1], "DNA", "float32").resquiggle_batch(dna[1][2])
    _same_results(out, dna_f32["default"]["port"])
    assert FinalizeLanes() == FinalizeLanes(
        device_finalize=True, device_delfix=True, device_fit=None,
        native_finalize=True, device_theil_sen=False)


@pytest.mark.parametrize("B", [1, 64, 100])
def test_theil_sen_device_blocks_bitwise_jax(B):
    """The same float32 points (some reads short, one pair of equal event
    means, empty padding rows) give the JAX function's slopes and
    intercepts bit for bit."""
    rng = np.random.default_rng(B)
    N = 96
    ev = rng.normal(0, 1, (B, N))
    mod = ev * 1.1 + 0.2 + rng.normal(0, 0.2, (B, N))
    ev[0, 3] = ev[0, 7]
    n_pts = rng.integers(2, N + 1, B)
    n_pts[0] = N
    j = j_batch._theil_sen_device_blocks(ev, mod, n_pts)
    t = t_batch._theil_sen_device_blocks(ev, mod, n_pts,
                                         torch.device("cpu"))
    for got, want in zip(t, j):
        assert got.dtype == want.dtype == np.float64
        assert got.shape == (B,)
        np.testing.assert_array_equal(got, want)


def test_device_theil_sen_lane_on_32_reads(monkeypatch):
    """32 reads of 300 bases (the static band) all finish on the Python
    host lane of ``python_device_ts`` (one scaling pass, the Theil-Sen
    cap lowered to 128 points in both packages), whose fit then runs in
    device blocks.  Each call's reads, as they stand, go through
    the JAX package's ``_finalize`` under the same switches as well: both
    take the blocks with the same reads, and the results (segments,
    normalized signal, scale values, score, changed flag) are bitwise the
    JAX lane's."""
    # both packages read the cap at call time: at 128 points a block's
    # pair keys are 8,128 a read, not 499,500, and every read of 295 bases
    # fits on its rng(0) subsample
    monkeypatch.setattr(j_config, "MAX_POINTS_FOR_THEIL_SEN", 128)
    monkeypatch.setattr(t_config, "MAX_POINTS_FOR_THEIL_SEN", 128)
    j_inputs, t_inputs = _dna(32, seed=13, read_len=300)
    model, params, sst, j_maps = j_inputs
    j_br = JBatched(model, params, sst, j_config.OUTLIER_THRESH,
                    dtype=jnp.float32)
    handed = []
    fin = t_batch.BatchedResquiggler._finalize_host

    def fin_rec(br, host):
        jstates = _jax_states(host, j_maps)
        for js in jstates:
            js.dp_segs = js.dp_segs.copy()
        with _env(_switches("python_device_ts")):
            j_br._finalize(jstates, skip_seq_scaling=False)
        out = fin(br, host)
        handed.append((jstates, [s for s, _ in host],
                       [s.scale_values for s, _ in host],
                       {id(r[0]): r for r in out}))
        return out

    monkeypatch.setattr(t_batch.BatchedResquiggler, "_finalize_host",
                        fin_rec)
    calls = {}
    with _host_calls(calls):
        out = _port(t_inputs, "DNA", "float32", lanes=_lanes(
            "python_device_ts")).resquiggle_batch(t_inputs[2],
                                                  max_scaling_iters=1)
    monkeypatch.undo()
    assert all(js.ref_means.shape[0] > 128
               for jstates, *_ in handed for js in jstates)
    assert sum(r is not None for r, _ in out) >= 30
    _same_calls(calls)
    blocks = [keys for k, keys in calls["port"]
              if k == "_theil_sen_device_blocks"]
    assert blocks and len(blocks[0]) >= 32
    n = 0
    for jstates, states, svs, returned in handed:
        for js, s, sv in zip(jstates, states, svs):
            assert (js.error is None) == (id(s) in returned)
            if js.error is not None:
                assert s.error == js.error
                continue
            _, _, segs, norm, score, changed = returned[id(s)]
            want = js.result
            np.testing.assert_array_equal(segs, want.segs)
            np.testing.assert_array_equal(norm, want.raw_signal)
            assert score == want.sig_match_score
            assert changed == want.norm_params_changed
            assert (sv.shift, sv.scale) == (want.scale_values.shift,
                                            want.scale_values.scale)
            n += 1
    assert n >= 32


def test_gate_counters_match_jax():
    """The deletion-rate counters and the gate's decision after each group
    of one ``has_del`` sequence equal the JAX instance's, through the
    cold start, the gate closing and reopening and the halving past 2^16
    reads."""
    rng = np.random.default_rng(3)
    j = object.__new__(JBatched)
    t = object.__new__(t_batch.BatchedResquiggler)
    for x in (j, t):
        x._del_seen = x._del_total = 0
    seq = [rng.random(n) < p for n, p in (
        (10, 0.9), (40, 0.9), (20, 0.9), (30, 0.1), (200, 0.2),
        (40000, 0.7), (30000, 0.7), (5000, 0.1), (512, 0.6))]
    closed = []
    for has_del in seq:
        assert t._fit_mostly_wasted() == j._fit_mostly_wasted()
        closed.append(t._fit_mostly_wasted())
        j._note_del_rate(has_del.astype(np.float32))
        t._note_del_rate(has_del)
        assert (t._del_seen, t._del_total) == (j._del_seen, j._del_total)
    # cold, closed, reopened, closed again; the window halved
    assert closed[:3] == [False] * 3
    assert closed[3] and not closed[5] and closed[6]
    assert t._del_total < sum(len(h) for h in seq)


@pytest.mark.parametrize("lane", ["default"] + list(LANES))
def test_lane_decisions_under_a_closed_gate(lane):
    """With counters that say most reads carry a deletion, each lane's
    (device deletion fix, fit on the adaptive pass) at float32 are the
    JAX lane's ``use_dev_delfix`` and ``use_dev_fit`` under the same
    switches: only the forced fit ignores the gate; at float64 the port
    keeps its own lane whatever the switches."""
    fields = LANES[lane][0] if lane != "default" else {}
    fit_env = {None: "", True: "1", False: "0"}[fields.get("device_fit")]
    jax_delfix = fit_env != "0" and fields.get("device_delfix", True)
    jax_fit = not jax_delfix and fit_env == "1"
    for dtype, want in (("float32", (jax_delfix, jax_fit)),
                        ("float64", (True, False))):
        t = object.__new__(t_batch.BatchedResquiggler)
        t.lanes, t.dtype = _lanes(lane), getattr(torch, dtype)
        t._del_seen, t._del_total = 60, 100
        assert t._fit_mostly_wasted()
        assert t._fit_lanes() == want


def test_closed_gate_skips_the_fit(dna):
    """Counters that say most reads carry a deletion: the gated lane skips
    the fit on the adaptive dispatch in both packages and every read
    finishes on the host, the same reads in the same calls."""
    j_inputs, t_inputs = dna
    fits = {"jax": 0, "port": 0}
    j_fit, t_fit = j_batch._stage_fit, t_batch._stage_fit

    def close(jb, tb):
        for x in (jb, tb):
            x._del_seen, x._del_total = 60, 100

    def count(pkg, fn):
        def rec(*a, **kw):
            fits[pkg] += 1
            return fn(*a, **kw)
        return rec

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_batch, "_stage_fit", count("jax", j_fit))
        mp.setattr(t_batch, "_stage_fit", count("port", t_fit))
        run = _run_both(j_inputs, t_inputs, "fit_gated", before=close)
    _same_calls(run["calls"])
    assert fits == {"jax": 0, "port": 0}
    host = [keys for k, keys in run["calls"]["port"]
            if k == "finalize_batch"]
    assert len(host[0]) == len(run["port"])
    for j, t in zip(run["jax"], run["port"]):
        _assert_f32_close(*j, *t, same_start=True)


def test_mesh_lane_without_device_delfix(dna, dna_f32, monkeypatch):
    """Two CPU shards with ``device_delfix`` False (the JAX mesh lane's
    finalize): within the float32 bars of the JAX mesh lane, bitwise the
    port's one-device lane of the same switches, the fit run on both
    shards."""
    j_inputs, t_inputs = dna
    j_out = _jax(j_inputs, "float32", mesh=j_mesh.make_mesh(
        jax.devices()[:2])).resquiggle_batch(j_inputs[3])
    devs = []
    fit = t_batch._stage_fit

    def rec(norm, *a, **kw):
        devs.append(norm.shape[0])
        return fit(norm, *a, **kw)

    monkeypatch.setattr(t_batch, "_stage_fit", rec)
    out = _port(t_inputs, "DNA", "float32", mesh=t_mesh.make_mesh(
        ["cpu"] * 2), lanes=_lanes("fit_gated")).resquiggle_batch(
            t_inputs[2])
    assert len(devs) >= 2
    for j, t in zip(j_out, out):
        _assert_f32_close(*j, *t, same_start=True)
    _same_results(out, dna_f32["fit_gated"]["port"])


def test_runner_carries_the_lanes_to_the_retry(monkeypatch):
    """``RunConfig.lanes`` reaches the run's resquiggler and the
    save-bandwidth resquiggler of the two reads of tests/test_torch_retry.py
    whose 3,000-sample stall the 300-event band cannot follow."""
    model = TKmerModel.load_default("DNA")
    # tests/test_torch_retry.py's reads (the port's simulator is the JAX
    # package's): the two behind long adapters are drawn, not run
    rng = np.random.default_rng(31)
    fasta = t_testing.random_reference(np.random.default_rng(32), 30000)
    reads = []
    for i in range(4):
        read = t_testing.simulate_read(
            rng, fasta, model, read_len=1000, read_id="retry_%d" % i,
            adapter_len=(5000, 6000) if i < 2 else (50, 300))
        if i >= 2:
            raw = t_testing.insert_stall(rng, read.raw_signal,
                                         int(read.true_segs[500]), 3000)
            reads.append((read.read_id, raw,
                          TSequenceData(read.seq, read.read_id, 12.0)))
    seen = []
    adaptive = t_batch.BatchedResquiggler._adaptive_batch

    def adaptive_rec(self, *a, **kw):
        seen.append((self.params.bandwidth, self.lanes))
        return adaptive(self, *a, **kw)

    monkeypatch.setattr(t_batch.BatchedResquiggler, "_adaptive_batch",
                        adaptive_rec)
    lanes = _lanes("fit_forced")
    rc = t_runner.RunConfig(device="cpu", batch_size=2, num_io_threads=1,
                            lanes=lanes)
    summary, _ = t_runner.resquiggle_all_reads(
        t_runner.MemoryReads(reads), TExactAligner(fasta), model,
        TSeqSampleType("DNA", False), t_config.load_resquiggle_parameters(
            "DNA"), rc)
    assert summary.n_success == 2
    save_bw = t_config.load_resquiggle_parameters(
        "DNA", use_save_bandwidth=True).bandwidth
    assert {bw for bw, _ in seen} == {300, save_bw}
    assert all(x is lanes for _, x in seen)
    assert t_runner.RunConfig().lanes == FinalizeLanes()
