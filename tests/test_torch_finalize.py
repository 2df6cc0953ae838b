"""The host lane of the port's batched finalize
(``tombo_tpu_torch/pipeline/batch.py::BatchedResquiggler._finalize``) on the
CPU, against the JAX package's lane.

At float32 every read the device did not fit (here: reads the static band
assigned, ``has_del`` -1, and RNA reads with a deletion) is one job of a
single ``native.finalize_batch`` call a group and pass.  On a DNA batch (6
reads of 650 bases, five on the static band) and on the RNA recipe of
test_torch_rna.py (one read sent to the static band by stall removal),
with and without ``skip_seq_scaling``, each call's reads are handed, as
they stand, to the JAX package's float32 ``_finalize`` as well: its jobs,
its host library's outputs and its assembled results (scale values,
score, segments, normalized signal) equal the port's bit for bit.  End to
end, the JAX float32 lane run on the same DNA reads sends the same reads
through the same number of calls, with jobs and final results within
tests/test_batch_parity.py's float32 bars (the JAX float32 RNA lane sums
squared raw values in float32 and is no reference, test_torch_rna.py).
At float64 the host-lane reads go through one ``native.del_fix_batch``
and one float64 ``native.theil_sen_batch`` call, and the results stay
bitwise the JAX float64 lane's."""
import numpy as np
import pytest
import jax.numpy as jnp

from tombo_tpu import config as j_config
from tombo_tpu import native as j_native
from tombo_tpu import types as j_types
from tombo_tpu.pipeline import batch as j_batch
from tombo_tpu.pipeline.batch import BatchedResquiggler as JBatched
from tombo_tpu_torch import convert, native
from tombo_tpu_torch.pipeline import batch as t_batch

from test_torch_batch import (_JAX_F32_START_TIE, _assert_f32_close,
                              _assert_f64_exact, _convert, _prep_reads)
from test_torch_rna import _rna_reads, _t_model

RNA = j_config.RNA_SAMP_TYPE


def _dna():
    model, params, sst, maps = _prep_reads(6, read_len=650)
    t_model = convert.kmer_model(model.means, model.sds, model.central_pos,
                                 model.name, "DNA")
    return (model, params, sst, maps), (t_model, *_convert(params, maps))


def _rna():
    model, params, sst, maps, _ = _rna_reads()
    return (model, params, sst, maps), (_t_model(model),
                                        *_convert(params, maps))


@pytest.fixture(scope="module")
def inputs():
    return {"DNA": _dna(), RNA: _rna()}


def _port(t_inputs, samp_type, dtype, **kw):
    t_model, t_params, _ = t_inputs
    return t_batch.BatchedResquiggler(
        t_model, t_params, convert.seq_samp_type(samp_type,
                                                 samp_type == RNA),
        j_config.OUTLIER_THRESH, dtype=dtype, device="cpu", **kw)


def _copy(x):
    return x.copy() if isinstance(x, np.ndarray) else x


def _record(monkeypatch, mod, calls):
    """Wraps ``mod.finalize_batch``: each call's jobs and outputs appended
    to ``calls``."""
    fn = mod.finalize_batch

    def rec(jobs, params, ts_mode, *a, **kw):
        out = fn(jobs, params, ts_mode, *a, **kw)
        calls.append({
            "jobs": [tuple(_copy(x) for x in j) for j in jobs],
            "ts_mode": ts_mode,
            "out": tuple([a.copy() for a in o] if isinstance(o, list)
                         else o.copy() for o in out)})
        return out

    monkeypatch.setattr(mod, "finalize_batch", rec)


def _jax_states(host, j_maps):
    """The JAX package's read states for the port's host-lane reads, as
    they stand when the port finishes them."""
    out = []
    for s, _ in host:
        js = j_batch._ReadState(idx=s.idx, map_res=j_maps[s.idx],
                                raw=s.raw, num_events=s.num_events)
        sv = s.scale_values
        js.scale_values = j_types.ScaleValues(
            sv.shift, sv.scale, sv.lower_lim, sv.upper_lim,
            sv.outlier_thresh)
        js.dp_segs, js.dp_rsrtr, js.has_del = s.dp_segs, s.dp_rsrtr, \
            s.has_del
        js.ref_means, js.ref_sds = s.ref_means, s.ref_sds
        js.genome_seq_trim = s.genome_seq_trim
        out.append(js)
    return out


class _Recorder:
    """Wraps the port's ``_finalize_native``: each call's reads go first
    through the JAX package's float32 ``_finalize`` (``j_br``), then
    through the port's; both lanes' ``finalize_batch`` calls are recorded
    with the JAX states and what the port's lane returned for each read."""

    def __init__(self, monkeypatch, j_br, j_maps):
        self.calls, self.j_calls = [], []
        fin = t_batch.BatchedResquiggler._finalize_native

        def fin_rec(br, host):
            jstates = _jax_states(host, j_maps)
            j_br._finalize(jstates, skip_seq_scaling=br.skip_seq_scaling)
            out = fin(br, host)
            self.calls[-1].update(
                j_states=jstates, states=[s for s, _ in host],
                sv_post=[s.scale_values for s, _ in host],
                returned={id(r[0]): r for r in out})
            return out

        monkeypatch.setattr(t_batch.BatchedResquiggler, "_finalize_native",
                            fin_rec)
        _record(monkeypatch, native, self.calls)
        _record(monkeypatch, j_native, self.j_calls)


def _assert_same(got, want):
    assert type(got) is type(want)
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    else:
        assert got == want


@pytest.mark.parametrize("skip", [False, True], ids=["fit", "skip_scaling"])
@pytest.mark.parametrize("samp_type", ["DNA", RNA])
def test_float32_host_lane_is_the_jax_native_finalize(inputs, samp_type,
                                                      skip, monkeypatch):
    """(a) Each ``finalize_batch`` call's jobs and outputs bitwise those
    of the JAX float32 lane's call on the same reads; (b) each read's
    segments, normalized signal, scale values, score and changed flag
    bitwise the JAX lane's results, and a failed job the same error."""
    (model, j_params, sst, j_maps), t_inputs = inputs[samp_type]
    j_br = JBatched(model, j_params, sst, j_config.OUTLIER_THRESH,
                    dtype=jnp.float32, skip_seq_scaling=skip)
    rec = _Recorder(monkeypatch, j_br, j_maps)
    out = _port(t_inputs, samp_type, "float32",
                skip_seq_scaling=skip).resquiggle_batch(t_inputs[2])
    monkeypatch.undo()
    assert sum(r is not None for r, _ in out) >= len(out) - 1
    calls = rec.calls
    assert len(calls) == len(rec.j_calls) >= 1
    assert all("states" in c for c in calls)
    n_reads = sum(len(c["jobs"]) for c in calls)
    assert n_reads >= (5 if samp_type == "DNA" else 1)
    static = {"DNA": None, RNA: "r_005"}[samp_type]
    if static is not None:
        assert any(s.map_res.align_info.read_id == static
                   for c in calls for s in c["states"])
    for c, jc in zip(calls, rec.j_calls):
        assert c["ts_mode"] == jc["ts_mode"] == (-1 if skip else 1)
        # (a) the JAX lane's jobs and its host library's outputs
        assert len(c["jobs"]) == len(jc["jobs"]) == len(c["states"])
        for job, j_job in zip(c["jobs"], jc["jobs"]):
            _assert_same(job[1:5], j_job[1:5])
            for k in (0, 5, 6, 7, 9):
                if j_job[k] is None:
                    assert job[k] is None
                else:
                    np.testing.assert_array_equal(job[k], j_job[k])
            assert job[8] == j_job[8]
        _assert_same(c["out"], jc["out"])
        # (b) the JAX lane's assembled results
        status = c["out"][5]
        for i, (s, js) in enumerate(zip(c["states"], c["j_states"])):
            if status[i] != 0:
                assert id(s) not in c["returned"]
                assert s.error == js.error is not None
                continue
            assert js.error is None
            _, dp_res, segs, norm, score, changed = c["returned"][id(s)]
            want = js.result
            np.testing.assert_array_equal(segs, want.segs)
            np.testing.assert_array_equal(norm, want.raw_signal)
            assert score == want.sig_match_score
            assert changed == want.norm_params_changed
            sv, jsv = c["sv_post"][i], want.scale_values
            assert (sv.shift, sv.scale, sv.lower_lim, sv.upper_lim,
                    sv.outlier_thresh) == (jsv.shift, jsv.scale,
                                           jsv.lower_lim, jsv.upper_lim,
                                           jsv.outlier_thresh)


def _read_of(maps, piece):
    """(index of the read of ``maps`` whose raw signal holds ``piece``,
    where it starts there)."""
    n = piece.shape[0]
    for i, m in enumerate(maps):
        raw = np.asarray(m.raw_signal, np.float64)
        for o in np.flatnonzero(raw[:raw.shape[0] - n + 1] == piece[0]):
            if np.array_equal(raw[o:o + n], piece):
                return i, int(o)
    raise AssertionError("a job's raw slice is in no read")


@pytest.mark.parametrize("skip", [False, True], ids=["fit", "skip_scaling"])
def test_float32_lane_sends_the_jax_lanes_reads(inputs, skip, monkeypatch):
    """The JAX float32 lane and the port's, each run whole on the same DNA
    reads: the same reads in each ``finalize_batch`` call (a read known by
    its reference levels), each job's has_del, Theil-Sen sample,
    reference levels and limits equal, its scale values within 2e-3 of
    the scale and its segment boundaries in the raw signal equal on more
    than 99%; those reads' results within the float32 bar."""
    (model, j_params, sst, j_maps), t_inputs = inputs["DNA"]
    j_calls, t_calls = [], []
    _record(monkeypatch, j_native, j_calls)
    _record(monkeypatch, native, t_calls)
    j_out = JBatched(model, j_params, sst, j_config.OUTLIER_THRESH,
                     dtype=jnp.float32,
                     skip_seq_scaling=skip).resquiggle_batch(j_maps)
    t_out = _port(t_inputs, "DNA", "float32",
                  skip_seq_scaling=skip).resquiggle_batch(t_inputs[2])
    monkeypatch.undo()
    assert len(t_calls) == len(j_calls) >= 1
    native_reads = set()
    for c, jc in zip(t_calls, j_calls):
        by_ref = {j[5].tobytes(): j for j in jc["jobs"]}
        assert len(by_ref) == len(jc["jobs"]) == len(c["jobs"])
        for job in c["jobs"]:
            j_job = by_ref[job[5].tobytes()]
            np.testing.assert_array_equal(job[6], j_job[6])
            assert job[8] == j_job[8]
            if j_job[9] is None:
                assert job[9] is None
            else:
                np.testing.assert_array_equal(job[9], j_job[9])
            assert (job[3], job[4]) == (j_job[3], j_job[4])
            assert abs(job[1] - j_job[1]) / j_job[2] < 2e-3
            assert abs(job[2] - j_job[2]) / j_job[2] < 2e-3
            i, t_off = _read_of(j_maps, job[0])
            _, j_off = _read_of(j_maps[i:i + 1], j_job[0])
            native_reads.add(i)
            t_at, j_at = t_off + job[7], j_off + j_job[7]
            assert t_at.shape == j_at.shape
            assert np.mean(t_at == j_at) > 0.99
    assert len(native_reads) >= 5
    for i in native_reads:
        j_res = j_out[i][0]
        same_start = (j_res is None or
                      j_res.align_info.read_id != _JAX_F32_START_TIE)
        _assert_f32_close(*j_out[i], *t_out[i], same_start=same_start)


@pytest.mark.parametrize("samp_type", ["DNA", RNA])
def test_float64_host_lane_batched_and_bitwise_jax(inputs, samp_type,
                                                   monkeypatch):
    (model, params, sst, maps), t_inputs = inputs[samp_type]
    seen = {"del_fix": 0, "theil_sen": 0}
    for name, key in (("del_fix_batch", "del_fix"),
                      ("theil_sen_batch", "theil_sen")):
        fn = getattr(native, name)

        def counted(*a, _fn=fn, _key=key, **kw):
            seen[_key] += 1
            if _key == "theil_sen":
                assert kw.get("use_f32") is False
            return _fn(*a, **kw)

        monkeypatch.setattr(native, name, counted)
    prof = t_batch.StageProfile()
    t_out = _port(t_inputs, samp_type, "float64",
                  profile=prof).resquiggle_batch(t_inputs[2])
    monkeypatch.undo()
    assert seen["del_fix"] >= 1 and seen["theil_sen"] >= 1
    assert "finalize_native" in prof.timings
    j_out = JBatched(model, params, sst, j_config.OUTLIER_THRESH,
                     dtype=jnp.float64).resquiggle_batch(maps)
    assert _assert_f64_exact(j_out, t_out) >= len(maps) - 1

