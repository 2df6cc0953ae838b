"""The read-sharded lane of the port on the CPU: the sharded DP launcher
(``ops/banded_dp.py`` ``adaptive_banded_dp_tb_sharded``, K3) against the
JAX package's ``shard_map`` of the Pallas DP in interpret mode, and
bitwise against itself unsharded at float64 over 1 to 4 shards;
``BatchedResquiggler(mesh=...)`` over CPU shards against the JAX mesh
lane and the port's own 1-device lane at float64, read for read; the
dry-run functions (``full_sharded_step`` against the JAX one on 1-3
devices, ``sharded_production_step`` against the JAX stage functions,
``dryrun`` and ``psum_collective_dryrun`` on CPU shards); and the mesh
helpers' checks.

Bars: float32 segs and flags exact, final_fwd within atol 1e-4 (the
contract of tests/test_pallas_dp.py); float64 exact."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tombo_tpu import config as j_config
from tombo_tpu.ops import dp as j_dp
from tombo_tpu.ops import pallas_dp as j_pdp
from tombo_tpu.parallel import mesh as j_mesh
from tombo_tpu.pipeline import batch as j_batch
from tombo_tpu.pipeline.batch import BatchedResquiggler as JBatched
from tombo_tpu_torch import config as t_config
from tombo_tpu_torch import convert, kernels, testing
from tombo_tpu_torch.io.model_io import KmerModel
from tombo_tpu_torch.ops import banded_dp as t_bdp
from tombo_tpu_torch.ops import dp as t_dp
from tombo_tpu_torch.parallel import mesh as t_mesh
from tombo_tpu_torch.pipeline import batch as t_batch
from tombo_tpu_torch.pipeline import resquiggle as t_rsq
from tombo_tpu_torch.pipeline.aligner import ExactAligner
from tombo_tpu_torch.types import SeqSampleType, SequenceData

from test_batch_parity import _prep_reads
from test_torch_batch import _assert_f64_exact, _convert
from test_torch_dp import _mk_case, _params


def _jax_mesh_case():
    """tests/test_mesh_production.py's sharded-DP recipe."""
    B, bw, L, P = 8, 16, 64, 4
    E = L * 4
    rng = np.random.default_rng(3)
    em = rng.normal(0, 1, (B, E)).astype(np.float32)
    nev = np.full(B, E, np.int32)
    rm = rng.normal(0, 1, (B, L)).astype(np.float32)
    rs = np.full((B, L), 0.35, np.float32)
    sl = np.full(B, L, np.int32)
    ps = np.tile(np.arange(P, dtype=np.int32) * 2, (B, 1))
    pv = np.zeros(B, np.int32)
    pe = np.full((B, P), 2 ** 31 - 1, np.int64)
    sr = np.full(B, P, np.int32)
    return (em, nev, rm, rs, sl, ps, pv, pe, sr), bw, L, P


@pytest.mark.parametrize("t_layout,j_layout", [
    (("fused",), ("fused", 4)), (("chunked", 16), ("chunked", 4, 16))])
def test_sharded_dp_matches_jax_sharded(t_layout, j_layout):
    dp_args, bw, L, P = _jax_mesh_case()
    j_out = j_pdp.adaptive_banded_dp_tb_sharded(
        j_mesh.make_mesh(jax.devices()[:2]), "reads", dp_args,
        _params(bw, j_dp.DpParams), L, P, -1, j_layout, interpret=True)
    before = dict(kernels.LAUNCHES)
    t_out = t_bdp.adaptive_banded_dp_tb_sharded(
        t_mesh.make_mesh(["cpu"] * 2), dp_args, _params(bw, t_dp.DpParams),
        L, P, -1, t_layout)
    assert kernels.LAUNCHES == before
    segs, band_err, bound_err, ffwd = [x.numpy() for x in t_out]
    np.testing.assert_array_equal(segs, np.asarray(j_out[0]))
    np.testing.assert_array_equal(band_err, np.asarray(j_out[1]))
    np.testing.assert_array_equal(bound_err, np.asarray(j_out[2]))
    np.testing.assert_allclose(ffwd, np.asarray(j_out[3])[:, :bw],
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("layout", [("fused",), ("chunked", 16)])
@pytest.mark.parametrize("B,n_shards", [(10, 1), (10, 2), (10, 3), (10, 4),
                                        (3, 4)])
def test_sharded_dp_shard_count_invariant_f64(layout, B, n_shards):
    """Uneven splits, and 3 reads over 4 shards (one shard empty): bitwise
    the unsharded call, from whole arrays and from ready shards."""
    args, _ = _mk_case(7, B=B)
    args = [torch.tensor(a.astype(np.float64) if a.dtype == np.float32
                         else a) for a in args]
    p, L, P = _params(32, t_dp.DpParams), 128, 64
    plain = (t_bdp.adaptive_banded_dp_tb_plain(*args, p, L, P, 10)
             if layout[0] == "fused" else
             t_bdp.adaptive_banded_dp_tb_chunked_plain(*args, p, L, P, 10,
                                                       chunk_rows=16))
    mesh = t_mesh.make_mesh(["cpu"] * n_shards)
    shards = t_mesh.shard_batch(mesh, *args)
    assert [s[0].shape[0] for s in shards] == t_mesh.shard_sizes(B, mesh)
    for dp_args in (args, shards):
        out = t_bdp.adaptive_banded_dp_tb_sharded(mesh, dp_args, p, L, P, 10,
                                                  layout)
        for a, b in zip(out, plain):
            assert torch.equal(a, b)


def test_mesh_helpers():
    mesh = t_mesh.make_mesh(["cpu"] * 3)
    assert mesh == (torch.device("cpu"),) * 3
    assert t_mesh.shard_sizes(10, mesh) == [4, 3, 3]
    assert t_mesh.shard_sizes(2, mesh) == [1, 1, 0]
    x = torch.arange(20).reshape(10, 2)
    parts = t_mesh.shard_batch(mesh, x, np.arange(10))
    assert [tuple(p[0].shape) for p in parts] == [(4, 2), (3, 2), (3, 2)]
    assert torch.equal(t_mesh.gather(mesh, [p[0] for p in parts]), x)
    assert torch.equal(t_mesh.gather(mesh, [p[1] for p in parts]),
                       torch.arange(10))
    with pytest.raises(ValueError, match="batch size"):
        t_mesh.shard_batch(mesh, x, np.arange(9))


def test_mesh_without_a_card_or_mixed_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_mesh.make_mesh(["cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_mesh.make_mesh()
    with pytest.raises(ValueError, match="mix device types"):
        t_mesh.make_mesh(["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="at least one device"):
        t_mesh.make_mesh([])


def test_sharded_dp_rejects_bad_shards():
    args, _ = _mk_case(3, B=4)
    args = [torch.tensor(a) for a in args]
    p = _params(32, t_dp.DpParams)
    mesh = t_mesh.make_mesh(["cpu"] * 2)
    with pytest.raises(ValueError, match="3 shards for a mesh of 2"):
        t_bdp.adaptive_banded_dp_tb_sharded(mesh, [args] * 3, p, 128, 64,
                                            10, ("fused",))
    with pytest.raises(ValueError, match="unknown layout"):
        t_bdp.adaptive_banded_dp_tb_sharded(mesh, args, p, 128, 64, 10,
                                            ("tiled", 4))
    with pytest.raises(ValueError, match="no read"):
        t_bdp.adaptive_banded_dp_tb_sharded(mesh, [None, None], p, 128, 64,
                                            10, ("fused",))


# ------------------------------------------------------ the mesh lane
@pytest.fixture(scope="module")
def mesh_reads():
    """tests/test_mesh_production.py's fixture: 12 DNA reads of 650
    bases, seed 31; with the port's 1-device float64 run of them."""
    model, params, sst, maps, _ = _prep_reads(12, j_config.DNA_SAMP_TYPE,
                                              seed=31, read_len=650)
    t_model = convert.kmer_model(model.means, model.sds, model.central_pos,
                                 model.name, "DNA")
    t_params, t_maps = _convert(params, maps)
    t_one = _port(t_model, t_params, None).resquiggle_batch(t_maps)
    return (model, params, sst, maps), (t_model, t_params, t_maps), t_one


def _port(t_model, t_params, mesh):
    return t_batch.BatchedResquiggler(
        t_model, t_params, convert.seq_samp_type("DNA", False),
        j_config.OUTLIER_THRESH, dtype="float64", device="cpu", mesh=mesh)


@pytest.mark.parametrize("n", [2, 4])
def test_mesh_lane_matches_jax_mesh_lane(mesh_reads, n):
    (model, params, sst, maps), (t_model, t_params, t_maps), t_one = \
        mesh_reads
    j_out = JBatched(model, params, sst, j_config.OUTLIER_THRESH,
                     dtype=jnp.float64,
                     mesh=j_mesh.make_mesh(jax.devices()[:n])
                     ).resquiggle_batch(maps)
    before = dict(kernels.LAUNCHES)
    t_out = _port(t_model, t_params,
                  t_mesh.make_mesh(["cpu"] * n)).resquiggle_batch(t_maps)
    assert kernels.LAUNCHES == before
    assert _assert_f64_exact(j_out, t_out) == len(maps)
    assert t_mesh.lane_differences(t_out, t_one, exact=True) == []


def test_production_lane_dryrun_cpu():
    assert t_mesh.production_lane_dryrun(["cpu"] * 3, n_reads=5) == []


def test_mixed_mesh_batch_with_chunked_group(monkeypatch):
    """tests/test_torch_mixed.py's recipe, its four reads of 400 to 1,300
    bases, in length groups of two, the longer group routed chunked: over
    3 CPU shards (so each group leaves a shard empty) bitwise the
    1-device run."""
    rng = np.random.default_rng(41)
    model = KmerModel.load_default("DNA")
    fasta = testing.random_reference(np.random.default_rng(42), 30000)
    aligner = ExactAligner(fasta)
    sst = SeqSampleType("DNA", False)
    params = t_config.load_resquiggle_parameters("DNA")
    maps = []
    for i, n in enumerate((400, 520, 1100, 1300)):
        read = testing.simulate_read(rng, fasta, model, read_len=n,
                                     read_id="m_%03d" % i)
        mr = t_rsq.map_read(SequenceData(read.seq, read.read_id, 12.0),
                            aligner, model, sst)
        maps.append(t_rsq.adjust_map_res(
            mr.replace(raw_signal=read.raw_signal), sst, params))
    monkeypatch.setattr(t_batch, "_MIN_GROUP", 2)
    monkeypatch.setattr(t_bdp, "PER_READ_MOVE_CAP", 2048 * 300 - 1)
    chunked = []
    plain = t_bdp.adaptive_banded_dp_tb_chunked_plain

    def chunked_rec(event_means, *a, **kw):
        chunked.append(event_means.shape[0])
        return plain(event_means, *a, **kw)

    monkeypatch.setattr(t_bdp, "adaptive_banded_dp_tb_chunked_plain",
                        chunked_rec)
    outs = {}
    for mesh in (None, ["cpu"] * 3):
        chunked.clear()
        outs[mesh is None] = t_batch.BatchedResquiggler(
            model, params, sst, t_config.OUTLIER_THRESH, dtype="float64",
            device="cpu", mesh=mesh).resquiggle_batch(maps)
        assert chunked, "no group ran the chunked DP"
    assert sum(r is not None for r, _ in outs[True]) == len(maps)
    assert t_mesh.lane_differences(outs[False], outs[True], exact=True) == []


def test_mesh_lane_f32_equals_one_device(mesh_reads, monkeypatch):
    """The float32 lane, whose rescale passes keep the first pass's
    changepoints and whose deletion fix runs on the device: over 3 CPU
    shards bitwise its 1-device run."""
    _, (t_model, t_params, t_maps), _ = mesh_reads
    calls = {"rescale": 0, "windows": 0}
    stage_a_rescale, delfix_fit = (t_batch._stage_a_rescale,
                                   t_batch._stage_delfix_fit)

    def rescale_rec(*a):
        calls["rescale"] += 1
        return stage_a_rescale(*a)

    def delfix_rec(norm, rows, rsrtr, seq_segs, rm, rs, seq_lens, win_i,
                   win_bs, win_nb, *a, **kw):
        calls["windows"] += int((win_nb > 0).sum())
        return delfix_fit(norm, rows, rsrtr, seq_segs, rm, rs, seq_lens,
                          win_i, win_bs, win_nb, *a, **kw)

    monkeypatch.setattr(t_batch, "_stage_a_rescale", rescale_rec)
    monkeypatch.setattr(t_batch, "_stage_delfix_fit", delfix_rec)
    outs = [t_batch.BatchedResquiggler(
        t_model, t_params, convert.seq_samp_type("DNA", False),
        j_config.OUTLIER_THRESH, device="cpu", mesh=mesh
    ).resquiggle_batch(t_maps[:6]) for mesh in (None, ["cpu"] * 3)]
    assert calls["rescale"] > 0 and calls["windows"] > 0, calls
    assert sum(r is not None for r, _ in outs[0]) == 6
    assert t_mesh.lane_differences(outs[1], outs[0], exact=True) == []


# ------------------------------------------------------ the dry runs
def _f64(a):
    return a.astype(np.float64) if a.dtype == np.float32 else a


@pytest.mark.parametrize("n", [1, 2, 3])
def test_full_sharded_step_matches_jax(n):
    """The JAX dry run's inputs at float64 over n CPU shards against the
    JAX ``full_sharded_step`` on n virtual CPU devices: segs and site
    coverage bitwise, scores within 1e-12."""
    arrays, t_params = t_mesh.dryrun_inputs(n)
    arrays = [_f64(a) for a in arrays]
    j_params = j_dp.DpParams(*t_params)
    j_m = j_mesh.make_mesh(jax.devices()[:n])
    j_scores, j_segs, j_cov = j_mesh.full_sharded_step(
        j_m, j_params, 5.0, 5, 32, 4)(*j_mesh.shard_batch(j_m, *arrays))
    before = dict(kernels.LAUNCHES)
    mesh = t_mesh.make_mesh(["cpu"] * n)
    scores, segs, cov = t_mesh.full_sharded_step(
        mesh, t_params, 5.0, 5, 32, 4)(*arrays)
    assert kernels.LAUNCHES == before
    np.testing.assert_array_equal(segs.numpy(), np.asarray(j_segs))
    assert len(cov) == n
    for c in cov:
        np.testing.assert_array_equal(c.numpy(), np.asarray(j_cov))
    assert scores.dtype == torch.float64
    np.testing.assert_allclose(scores.numpy(), np.asarray(j_scores),
                               rtol=0, atol=1e-12)
    # the same batch unsharded: bitwise
    one = t_mesh.full_sharded_step(t_mesh.make_mesh(["cpu"]), t_params,
                                   5.0, 5, 32, 4)(*arrays)
    assert torch.equal(one[0], scores) and torch.equal(one[1], segs)
    assert torch.equal(one[2][0], cov[0])


def test_sharded_production_step_matches_jax_stages():
    """The port's production step over 2 CPU shards at float64 against
    the JAX stage functions (``_stage_a_dna``, then ``adaptive_banded_dp``
    and ``banded_traceback``) on the same inputs: event means within
    1e-12 (XLA contracts multiply-adds in the JAX normalization), segs
    and coverage exact."""
    em, segs, cov = t_mesh.sharded_production_step(["cpu"] * 2)
    B, sig_len, n_rows, bw, nb = 4, 1024, 64, 32, 8
    rng = np.random.default_rng(0)
    raw = rng.normal(450.0, 60.0, (B, sig_len)).astype(np.float32)
    rm_start = rng.normal(0, 1, (B, nb)).astype(np.float32)
    sp = j_dp.StartDpParams(z_shift=5.0, skip_pen=4.2, stay_pen=4.2,
                            max_half_z_score=20.0, num_bases=nb,
                            num_events=bw)
    out = j_batch._stage_a_dna(
        _f64(raw), np.full(B, sig_len, np.int64), np.zeros(B, bool),
        np.zeros(B), np.ones(B), np.full(B, -1e30), np.full(B, 1e30),
        np.full(B, n_rows * 4, np.int64), _f64(rm_start),
        np.full((B, nb), 0.35), 5.0, 5, 3, n_rows * 4 + 1, sp, False)
    j_em = np.asarray(out[1])
    assert em.shape == j_em.shape and em.dtype == torch.float64
    np.testing.assert_allclose(em.numpy(), j_em, rtol=0, atol=1e-12)
    E, L, P = j_em.shape[1], n_rows, 8
    rm = _f64(rng.normal(0, 1, (B, L)).astype(np.float32))
    params = j_dp.DpParams(z_shift=5.0, skip_pen=4.2, stay_pen=4.2,
                           mask_fill_z_score=-15.0, max_half_z_score=20.0,
                           bandwidth=bw)
    sl = np.full(B, L, np.int32)
    tb, starts, ffwd, _ = j_dp.adaptive_banded_dp(
        j_em, np.full(B, E, np.int32), rm, np.full((B, L), 0.35), sl,
        np.tile(np.arange(P, dtype=np.int32) * 2, (B, 1)),
        np.zeros(B, np.int32), np.full((B, P), 2 ** 31 - 1, np.int64),
        np.full(B, P, np.int32), params, L, P)
    top = jnp.argmax(ffwd, axis=1).astype(jnp.int32)
    j_segs, _ = j_dp.banded_traceback(tb, starts, sl, top, -1, bw, L)
    np.testing.assert_array_equal(segs.numpy(), np.asarray(j_segs))
    want = np.bincount(np.clip(np.asarray(j_segs), 0, E).ravel(),
                       minlength=E + 1)
    assert len(cov) == 2
    for c in cov:
        np.testing.assert_array_equal(c.numpy(), want)


def test_dryrun_cpu():
    before = dict(kernels.LAUNCHES)
    out = t_mesh.dryrun(4, ["cpu"] * 4)
    assert kernels.LAUNCHES == before
    scores, segs, cov = out["full_sharded_step"]
    assert segs.shape == (8, 33) and len(cov) == 4
    assert out["production_step"][1].shape == (8, 65)
    assert out["lane_differences"] == [] and out["psum_total"] == 10


def test_psum_collective_dryrun_cpu():
    from tombo_tpu_torch.parallel import distributed as t_dist
    assert t_dist.psum_collective_dryrun(["cpu"] * 3) == 6
    assert t_dist.psum_collective_dryrun(["cpu"]) == 1
