"""The re-squiggle stage profiler of the port (``pipeline/batch.py``:
``StageProfile``, ``print_stage_timings``, ``print_counters``,
``trace_ctx``), through the runner and the command line, on the CPU,
against the JAX package's profiler (``STAGE_TIMINGS``, ``TRANSFER_BYTES``,
``print_stage_timings`` under its environment switch) on
tests/test_batch_parity.py's six reads of 650 bases.  The span log behind
the timings: its tree, its clock against the exported trace's, and the
counters of the work done, retried and routed.

The float32 key set equals the JAX package's, ``finalize_native`` (the
host library's batched finalize) included.  The float64 set differs by
design: the port's float64 lane runs the device deletion fix and fit, so
its float64 set adds ``delfix_plan`` (and ``delfix_apply`` whenever a
read is fit on the device, which no read of these six is at float64:
each has a deletion and finishes on the host, through the host
library's batched deletion fix and Theil-Sen under ``finalize_native``,
as in the JAX float64 lane)."""
import glob
import io
import json
import os
import shutil

import h5py
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tombo_tpu import config as j_config
from tombo_tpu.pipeline import batch as j_batch
from tombo_tpu.testing import make_synthetic_dataset
from tombo_tpu_torch import config as t_config
from tombo_tpu_torch import convert
from tombo_tpu_torch import testing as t_testing
from tombo_tpu_torch.cli import main as t_cli
from tombo_tpu_torch.io.model_io import KmerModel as TKmerModel
from tombo_tpu_torch.pipeline import batch as t_batch
from tombo_tpu_torch.pipeline import runner as t_runner
from tombo_tpu_torch.pipeline.aligner import ExactAligner as TExactAligner
from tombo_tpu_torch.types import SeqSampleType as TSeqSampleType
from tombo_tpu_torch.types import SequenceData as TSequenceData

from test_torch_batch import _convert, _prep_reads
from test_torch_retry import _retry_reads

STAGES = {"segment", "plan", "start", "adaptive", "static", "finalize"}
CG = "RawGenomeCorrected_000/BaseCalled_template"


@pytest.fixture(scope="module")
def inputs():
    model, params, sst, maps = _prep_reads(6, read_len=650)
    t_model = convert.kmer_model(model.means, model.sds, model.central_pos,
                                 model.name, "DNA")
    t_params, t_maps = _convert(params, maps)
    return (model, params, sst, maps), (t_model, t_params, t_maps)


def _port(t_inputs, dtype, **kw):
    t_model, t_params, _ = t_inputs
    return t_batch.BatchedResquiggler(
        t_model, t_params, convert.seq_samp_type("DNA", False),
        j_config.OUTLIER_THRESH, dtype=dtype, device="cpu", **kw)


class _JaxProfile:
    """The JAX package's global profile dicts, emptied for the block and
    restored after it."""

    def __enter__(self):
        self.saved = (dict(j_batch.STAGE_TIMINGS),
                      dict(j_batch.TRANSFER_BYTES))
        j_batch.STAGE_TIMINGS.clear()
        j_batch.TRANSFER_BYTES.clear()
        return self

    def __exit__(self, *exc):
        for d, saved in zip((j_batch.STAGE_TIMINGS, j_batch.TRANSFER_BYTES),
                            self.saved):
            d.clear()
            d.update(saved)
        return False


@pytest.fixture(scope="module")
def jax_profiles(inputs):
    """dtype -> (STAGE_TIMINGS, TRANSFER_BYTES) of the JAX lane's batch."""
    model, params, sst, maps = inputs[0]
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TOMBO_TPU_PROFILE", "1")
        for dtype in ("float32", "float64"):
            with _JaxProfile():
                j_batch.BatchedResquiggler(
                    model, params, sst, j_config.OUTLIER_THRESH,
                    dtype=getattr(jnp, dtype)).resquiggle_batch(maps)
                out[dtype] = (dict(j_batch.STAGE_TIMINGS),
                              dict(j_batch.TRANSFER_BYTES))
    return out


@pytest.fixture(scope="module")
def port_profiles(inputs):
    """dtype -> (StageProfile, results) of the port's profiled batch."""
    out = {}
    for dtype in ("float32", "float64"):
        prof = t_batch.StageProfile()
        res = _port(inputs[1], dtype, profile=prof).resquiggle_batch(
            inputs[1][2])
        out[dtype] = (prof, res)
    return out


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_stage_keys_match_jax(jax_profiles, port_profiles, dtype):
    """(a) The JAX key set, ``finalize_native`` included, plus
    ``delfix_plan`` at float64; each ``_fetch`` key belongs to a stage."""
    want = set(jax_profiles[dtype][0])
    assert "finalize_native" in jax_profiles[dtype][0]
    if dtype == "float64":
        assert not want & {"delfix_plan", "delfix_apply"}
        want |= {"delfix_plan"}
    got = set(port_profiles[dtype][0].timings)
    assert got == want
    assert "finalize_native" in got
    assert STAGES <= got
    for k in got:
        if k.endswith("_fetch"):
            assert k[:-len("_fetch")] in STAGES, k
    assert set(port_profiles[dtype][0].transfer_bytes) == \
        set(jax_profiles[dtype][1]) == {"upload", "fetch"}


def _same_results(a, b):
    assert len(a) == len(b)
    for (ra, ea), (rb, eb) in zip(a, b):
        assert ea == eb
        assert (ra is None) == (rb is None)
        if ra is None:
            continue
        np.testing.assert_array_equal(ra.segs, rb.segs)
        np.testing.assert_array_equal(ra.raw_signal, rb.raw_signal)
        assert ra.read_start_rel_to_raw == rb.read_start_rel_to_raw
        assert ra.scale_values == rb.scale_values
        assert ra.sig_match_score == rb.sig_match_score
        assert ra.norm_params_changed == rb.norm_params_changed
        assert ra.genome_seq == rb.genome_seq


def test_profile_leaves_results_bitwise(inputs, port_profiles, monkeypatch):
    """(b) Without a profile nothing is timed, counted or traced (the
    profile's methods and ``record_function`` would raise), and the
    results are bitwise those of the profiled run, at float64."""
    def refuse(*a, **kw):
        raise AssertionError("timed without a profile")

    for name in ("begin", "end", "count", "add_time", "add_bytes",
                 "add_rows"):
        monkeypatch.setattr(t_batch.StageProfile, name, refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    plain = _port(inputs[1], "float64").resquiggle_batch(inputs[1][2])
    _same_results(plain, port_profiles["float64"][1])
    assert sum(r is not None for r, _ in plain) >= 5


@pytest.mark.parametrize("dtype,itemsize", [("float32", 4),
                                            ("float64", 8)])
def test_transfer_bytes(inputs, port_profiles, dtype, itemsize,
                        monkeypatch):
    """(c) ``upload`` holds at least the reads' raw signals at a byte a
    sample (the int8-delta wire of integral signals) and less than half
    of what the same batch sends with the dense upload (no read's signal
    taken as integral), which holds at least the signals at the lane's
    dtype; at float64, less than the signals alone at the lane's dtype
    (counted on the CPU device too); ``fetch`` is not empty."""
    prof = port_profiles[dtype][0]
    n_samples = sum(m.raw_signal.shape[0] for m in inputs[1][2])
    assert n_samples <= prof.transfer_bytes["upload"]
    if dtype == "float64":
        assert prof.transfer_bytes["upload"] < n_samples * itemsize
    monkeypatch.setattr(t_batch, "_as_int16", lambda signal, raw: None)
    dense = t_batch.StageProfile()
    _port(inputs[1], dtype, profile=dense).resquiggle_batch(inputs[1][2])
    assert dense.transfer_bytes["upload"] >= n_samples * itemsize
    assert 2 * prof.transfer_bytes["upload"] < dense.transfer_bytes["upload"]
    assert prof.transfer_bytes["fetch"] > 0
    # a sub-stage's seconds count in its stage too
    t = prof.timings
    assert t["seg_pack"] + t["seg_upload"] <= t["segment"]
    assert t["segment_fetch"] <= t["segment"]


def test_save_bandwidth_retry_adds_to_the_profile(monkeypatch):
    """(d) The two stalled reads of tests/test_torch_retry.py fail the
    300-event band and go through a save-bandwidth resquiggler, whose
    spans land in the caller's profile under a ``save_bw_retry`` span:
    every adaptive stage of either resquiggler is a span of it; the reads
    it retries are counted as such, the two reads once as the batch's."""
    model, params, sst, maps = _retry_reads()
    t_params, t_maps = _convert(params, maps[2:])
    t_model = convert.kmer_model(model.means, model.sds, model.central_pos,
                                 model.name, "DNA")
    calls = []
    adaptive = t_batch.BatchedResquiggler._adaptive_batch

    def adaptive_rec(self, *a, **kw):
        calls.append((self.params.bandwidth, self.profile))
        return adaptive(self, *a, **kw)

    monkeypatch.setattr(t_batch.BatchedResquiggler, "_adaptive_batch",
                        adaptive_rec)
    sent = []
    reads = t_batch.BatchedResquiggler._resquiggle_reads

    def reads_rec(self, map_results, *a):
        sent.append((self.params.bandwidth, len(map_results)))
        return reads(self, map_results, *a)

    monkeypatch.setattr(t_batch.BatchedResquiggler, "_resquiggle_reads",
                        reads_rec)
    prof = t_batch.StageProfile()
    out = _port((t_model, t_params, t_maps), "float32",
                profile=prof).resquiggle_batch(t_maps)
    save_bw = t_config.load_resquiggle_parameters(
        "DNA", use_save_bandwidth=True).bandwidth
    assert {bw for bw, _ in calls} == {params.bandwidth, save_bw}
    assert all(p is prof for _, p in calls)
    adaptive = [s for s in prof.spans if s.name == "adaptive"]
    assert len(adaptive) == len(calls)
    retry = [i for i, s in enumerate(prof.spans) if s.name == "save_bw_retry"]
    assert len(retry) == 1 and prof.spans[retry[0]].parent == 0
    assert any(_ancestors(prof.spans, s) & set(retry) for s in adaptive)
    c = prof.counters
    assert [n for bw, n in sent] == [2, c["save_bw_retry_reads"]]
    assert sent[1][0] == save_bw
    assert (c["batches"], c["reads"]) == (1, 2)
    assert all(res is not None for res, _ in out)


def _ancestors(spans, span):
    """The indices of the spans open around ``span``."""
    out = set()
    while span.parent >= 0:
        out.add(span.parent)
        span = spans[span.parent]
    return out


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_span_tree(port_profiles, dtype):
    """(i) The profiled batch's span log: one ``batch`` root; every other
    span inside its parent in time and in the parent's pass; the passes
    numbered from 0, each stage a child of one, each ``_fetch`` span
    inside its stage; ``timings`` the log's sums over its keys."""
    prof = port_profiles[dtype][0]
    spans = prof.spans
    assert [s.name for s in spans if s.parent < 0] == ["batch"]
    passes = [s.pass_no for s in spans if s.name == "pass"]
    assert passes == list(range(len(passes))) and len(passes) >= 2
    for i, s in enumerate(spans):
        assert 0 < s.start_ns <= s.end_ns and s.batch == 0
        if s.parent < 0:
            continue
        p = spans[s.parent]
        assert s.parent < i
        assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
        assert p.name == "batch" or s.pass_no == p.pass_no
        if s.name in STAGES:
            assert p.name == "pass", s.name
        if s.name.endswith("_fetch"):
            stage = s.name[:-len("_fetch")]
            assert any(spans[a].name == stage
                       for a in _ancestors(spans, s)), s.name
    sums = {}
    for s in spans:
        sums[s.name] = sums.get(s.name, 0.0) + (s.end_ns - s.start_ns) * 1e-9
    assert set(prof.timings) == {k for k in sums if k in t_batch._TIMED or
                                 k.endswith("_fetch")}
    for k, v in prof.timings.items():
        assert v == pytest.approx(sums[k], rel=1e-9), k


@pytest.fixture(scope="module")
def dwell14():
    """tests/test_torch_lanes.py's DNA batch: 6 reads of 500 bases at a
    mean dwell of 14 samples, two of them with a zero-length segment in
    the first pass."""
    model, params, _, maps = _prep_reads(6, read_len=500, mean_dwell=14.0)
    t_model = convert.kmer_model(model.means, model.sds, model.central_pos,
                                 model.name, "DNA")
    return (t_model,) + _convert(params, maps)


@pytest.mark.parametrize("cap,reason", [("_DELFIX_NB_CAP", "delfix_nb_cap"),
                                        ("_DELFIX_T_CAP", "delfix_t_cap")])
def test_counters(dwell14, cap, reason, monkeypatch):
    """(j) With a device cap of the deletion fix at 0, the two reads with
    a deletion go to the host lane for that cap: the counters of the work
    done (two passes, the second the rescaling of one read), retried
    (none) and routed (each read that reaches finalize on one lane, each
    copy down)."""
    live = []
    run_pass = t_batch.BatchedResquiggler._run_pass

    def run_pass_rec(self, states, *a, **kw):
        live.append(sum(s.error is None for s in states))
        return run_pass(self, states, *a, **kw)

    monkeypatch.setattr(t_batch.BatchedResquiggler, "_run_pass",
                        run_pass_rec)
    monkeypatch.setattr(t_batch, cap, 0)
    prof = t_batch.StageProfile()
    out = _port(dwell14, "float32", profile=prof).resquiggle_batch(
        dwell14[2])
    c = prof.counters
    assert all(res is not None for res, _ in out)
    assert live == [6, 1]
    assert (c["batches"], c["reads"], c["groups"]) == (1, 6, 2)
    assert c["read_passes"] == 7
    assert c["finalize_host_reads"] == c["host_lane." + reason] == 2
    assert c["finalize_device_reads"] == 5
    assert [k for k in c if k.startswith("host_lane.")] == [
        "host_lane." + reason]
    assert not {"start_retry_reads", "save_bw_retry_reads"} & set(c)
    fetch_spans = sum(s.name.endswith("_fetch") for s in prof.spans)
    assert c["fetches"] >= fetch_spans > 0


def test_spans_lie_inside_their_trace_ranges(inputs, tmp_path):
    """(k) With a profile and a trace both, every span of the log lies
    inside the trace's range of its name and rank, on the trace's clock
    (an event's ``ts``, µs, plus the file's ``baseTimeNanoseconds``),
    within 1 ms; and every range has its span."""
    prof = t_batch.StageProfile()
    br = _port(inputs[1], "float32", profile=prof)
    d = str(tmp_path / "trace")
    list(br.resquiggle_batches([inputs[1][2][:2]], max_scaling_iters=1,
                               trace_dir=d))
    (fn,) = _trace_files(d)
    with open(fn) as f:
        trace = json.load(f)
    base = int(trace["baseTimeNanoseconds"])
    ranges = {}
    for e in sorted((e for e in trace["traceEvents"]
                     if e.get("cat") == "user_annotation"),
                    key=lambda e: e["ts"]):
        ranges.setdefault(e["name"], []).append(
            (base + round(e["ts"] * 1e3),
             base + round((e["ts"] + e["dur"]) * 1e3)))
    seen = {}
    for s in prof.spans:
        k = seen[s.name] = seen.get(s.name, 0) + 1
        lo, hi = ranges[s.name][k - 1]
        assert lo - 10 ** 6 <= s.start_ns <= s.end_ns <= hi + 10 ** 6, s.name
    assert {k: len(v) for k, v in ranges.items()} == seen
    assert STAGES | {"batch", "pass", "segment_fetch"} <= set(seen)


def test_span_without_profile_or_trace_is_the_shared_null(inputs):
    """(l) With no profile and no trace, ``_span`` returns one shared null
    context; with a profile, a span."""
    br = _port(inputs[1], "float32")
    assert br._span("segment") is br._span("batch") is t_batch._NULL_SPAN
    br.profile = t_batch.StageProfile()
    assert isinstance(br._span("segment"), t_batch._Span)


def _tie_profile():
    prof = t_batch.StageProfile()
    for name, t in (("segment", 0.25), ("plan", 0.25), ("start", 0.0),
                    ("adaptive", 1.5), ("adaptive_fetch", 1e-4)):
        prof.add_time(name, t)
    prof.add_bytes("upload", 3 * 2 ** 20 + 17)
    prof.add_bytes("fetch", 1)
    return prof


@pytest.mark.parametrize("case", ["float32 run", "ties", "empty"])
def test_print_matches_jax(port_profiles, case):
    """(e) The same two dicts print byte for byte as the JAX function
    prints them: a profiled run's, one with ties and a zero, none."""
    prof = {"float32 run": lambda: port_profiles["float32"][0],
            "ties": _tie_profile, "empty": t_batch.StageProfile}[case]()
    got, want = io.StringIO(), io.StringIO()
    t_batch.print_stage_timings(prof, out=got)
    with _JaxProfile():
        j_batch.STAGE_TIMINGS.update(prof.timings)
        j_batch.TRANSFER_BYTES.update(prof.transfer_bytes)
        j_batch.print_stage_timings(out=want)
    assert got.getvalue() == want.getvalue()
    assert (got.getvalue() == "") == (case == "empty")


def _memory_reads(n, seed=11):
    model = TKmerModel.load_default("DNA")
    fasta = t_testing.random_reference(np.random.default_rng(seed), 8000)
    rng = np.random.default_rng(seed + 1)
    reads = []
    for i in range(n):
        read = t_testing.simulate_read(rng, fasta, model, read_len=500,
                                       read_id="m_%d" % i)
        reads.append((read.read_id, read.raw_signal,
                      TSequenceData(read.seq, read.read_id, 12.0)))
    return model, fasta, reads


def _stage_lines(err):
    return {line.split()[0] for line in err.splitlines()
            if line.startswith("  ") and line.endswith("%)")}


def _counter_lines(err):
    """The counters block after the table: name -> count."""
    lines = err.splitlines()
    block = lines[lines.index("counters") + 1:]
    return {line.split()[0]: int(line.split()[1]) for line in block}


def test_runner_profile(capsys):
    """(f) ``RunConfig(profile=True)``: the run's StageProfile holds the
    stages and ``io_map``, the summary keeps it, the table and then the
    counters go to stderr and nothing to stdout."""
    model, fasta, reads = _memory_reads(4)
    params = t_config.load_resquiggle_parameters("DNA")
    rc = t_runner.RunConfig(profile=True, device="cpu", batch_size=4,
                            num_io_threads=2, max_scaling_iters=1)
    summary, _ = t_runner.resquiggle_all_reads(
        t_runner.MemoryReads(reads), TExactAligner(fasta), model,
        TSeqSampleType("DNA", False), params, rc)
    cap = capsys.readouterr()
    assert summary.n_success == len(reads)
    assert cap.out == ""
    assert STAGES | {"io_map"} <= _stage_lines(cap.err)
    assert set(summary.stage_timings) == _stage_lines(cap.err)
    assert set(summary.transfer_bytes) == {"upload", "fetch"}
    assert {"io_map", "batch_loop", "writeback", "run"} <= \
        set(summary.timings)
    assert _counter_lines(cap.err) == summary.counters
    assert summary.counters["reads"] == len(reads)
    assert summary.counters["batches"] == 1


def _trace_files(d):
    return glob.glob(os.path.join(d, "*.pt.trace.json"))


def _annotations(fn):
    with open(fn) as f:
        events = json.load(f)["traceEvents"]
    return {e["name"] for e in events if e.get("cat") == "user_annotation"}


def test_trace_dir_writes_the_stage_ranges(inputs, tmp_path):
    """(g) ``resquiggle_batches(..., trace_dir=)`` writes one Chrome trace
    whose annotations are the six stages, also when the caller stops after
    the first of two batches; results bitwise the untraced run's."""
    t_maps = inputs[1][2][:2]
    br = _port(inputs[1], "float32")
    d = str(tmp_path / "trace")
    gen = br.resquiggle_batches([t_maps, t_maps], max_scaling_iters=1,
                                trace_dir=d)
    traced = next(gen)
    gen.close()
    assert br._span("segment") is t_batch._NULL_SPAN
    (fn,) = _trace_files(d)
    assert STAGES <= _annotations(fn)
    _same_results(traced, br.resquiggle_batch(t_maps, max_scaling_iters=1))


def _corrected(d):
    out = {}
    for fn in sorted(os.listdir(d)):
        if fn.endswith(".fast5"):
            with h5py.File(os.path.join(d, fn), "r") as f:
                g = f["Analyses/" + CG]
                out[fn] = (dict(g.attrs.items()), g["Events"][:].tobytes()
                           if "Events" in g else None)
    return out


def test_command_line_profile_and_trace(tmp_path, capsys):
    """(h) ``resquiggle --device cpu --profile --trace-dir D`` exits 0,
    prints the table on stderr and writes a trace in D; the corrected
    groups equal those of the same command without the two options."""
    _, _, fast5_dir = make_synthetic_dataset(str(tmp_path), n_reads=3,
                                             seed=9, read_len=500,
                                             ref_len=4000)
    ref = str(tmp_path / "reference.fasta")
    plain_dir = str(tmp_path / "plain")
    shutil.copytree(fast5_dir, plain_dir)
    trace = str(tmp_path / "trace")
    args = ["--device", "cpu", "--quiet", "--processes", "1",
            "--max-scaling-iterations", "1"]
    assert t_cli.main(["resquiggle", plain_dir, ref] + args) == 0
    assert capsys.readouterr().err == ""
    assert t_cli.main(["resquiggle", fast5_dir, ref] + args +
                      ["--profile", "--trace-dir", trace]) == 0
    err = capsys.readouterr().err
    assert STAGES | {"io_map", "writeback"} <= _stage_lines(err)
    assert [line.split()[0] for line in err.splitlines()
            if line.endswith(" MB")] == ["fetch", "upload"]
    assert _counter_lines(err)["reads"] == 3
    (fn,) = _trace_files(trace)
    assert STAGES <= _annotations(fn)
    got, want = _corrected(fast5_dir), _corrected(plain_dir)
    assert got.keys() == want.keys() and len(got) == 3
    assert all(events is not None for _, events in got.values())
    for name in got:
        ga, wa = got[name][0], want[name][0]
        assert ga.keys() == wa.keys()
        for k in ga:
            if k != "time_stamp":
                np.testing.assert_array_equal(ga[k], wa[k], err_msg=k)
        assert got[name][1] == want[name][1]
