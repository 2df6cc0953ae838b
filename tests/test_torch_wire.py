"""The raw-signal wire of the port's batched lane
(``tombo_tpu_torch/pipeline/batch.py``): integral raw signals go up as int8
deltas with an escape list, one wire a device (a mesh shard's reads on
their own), and are decoded on the device into the padded raw matrix.  On
the CPU: the port's decoder bitwise the JAX package's
``_unflatten_delta_rows`` and the dense matrix on numpy-seeded int16 rows;
on a 1 kb batch, results bitwise those of the dense upload and the upload
bytes (``StageProfile.transfer_bytes``) at least 3x fewer, on one device
and on each shard of a mesh."""
import time

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tombo_tpu import config as j_config
from tombo_tpu.pipeline import batch as j_batch
from tombo_tpu_torch import convert
from tombo_tpu_torch.pipeline import batch as t_batch

from test_torch_batch import _convert, _prep_reads


def _walk(rng, n, step, first=500):
    return np.clip(first + np.cumsum(rng.integers(-step, step + 1, n)),
                   -2 ** 15, 2 ** 15 - 1).astype(np.int16)


def _case_rows(case, rng):
    """int16 rows of one case."""
    if case == "small deltas":
        return [_walk(rng, n, 40) for n in (700, 2, 350, 1024)]
    if case == "escapes":
        rows = []
        for n in (900, 64, 1500):
            r = _walk(rng, n, 60).astype(np.int32)
            jumps = rng.random(n) < 0.1
            r += np.cumsum(np.where(jumps, rng.integers(-3000, 3001, n), 0))
            rows.append(np.clip(r, -2 ** 15, 2 ** 15 - 1).astype(np.int16))
        return rows
    if case == "extreme firsts":
        return [np.array([-2 ** 15, 2 ** 15 - 1, -2 ** 15, 0, 127, -129],
                         np.int16),
                np.array([2 ** 15 - 1, -2 ** 15, 2 ** 15 - 1], np.int16),
                _walk(rng, 300, 30, first=-32000)]
    if case == "no escapes":
        return [_walk(rng, n, 10) for n in (500, 40, 800)]
    if case == "length-1 rows":
        return [np.array([v], np.int16) for v in (-2 ** 15, 0, 77, 2 ** 15 - 1)]
    if case == "pad rows":
        # zero-length rows amid and after real ones
        return [_walk(rng, 600, 200), np.zeros(0, np.int16),
                _walk(rng, 90, 200), np.zeros(0, np.int16)]
    raise ValueError(case)


CASES = ["small deltas", "escapes", "extreme firsts", "no escapes",
         "length-1 rows", "pad rows"]


def _dense(rows, S, dtype=np.int16):
    out = np.zeros((len(rows), S), dtype)
    for i, r in enumerate(rows):
        out[i, :r.shape[0]] = r
    return out


@pytest.mark.parametrize("case", CASES)
def test_delta_wire_bitwise_jax_and_dense(case):
    rng = np.random.default_rng(CASES.index(case) + 5)
    rows = _case_rows(case, rng)
    lens = np.array([r.shape[0] for r in rows], np.int64)
    S = t_batch._sig_bucket(int(lens.max()))
    flat8, offs, firsts, exc_dest, exc_res = t_batch._pack_delta_wire(
        rows, lens, S)
    n_exc = exc_res.shape[0]
    assert np.all(exc_res != 0)
    if case == "no escapes" or case == "length-1 rows":
        assert n_exc == 0
    elif case in ("escapes", "extreme firsts"):
        assert n_exc > 0
    got = t_batch._unflatten_delta_rows(
        *[torch.as_tensor(a) for a in (flat8, offs, firsts, exc_dest,
                                       exc_res, lens)], S)
    assert got.dtype == torch.int16
    dense = _dense(rows, S)
    np.testing.assert_array_equal(got.numpy(), dense)
    # the JAX decoder on the same wire, with the JAX lane's pad rows
    # (copies of row 0 without its escapes) after the real ones
    pad = lambda a: np.concatenate([a, np.repeat(a[:1], 3, 0)])
    want = np.asarray(j_batch._unflatten_delta_rows(
        jnp.asarray(flat8), jnp.asarray(pad(offs)),
        jnp.asarray(pad(lens.astype(np.int32))), jnp.asarray(pad(firsts)),
        jnp.asarray(exc_dest), jnp.asarray(exc_res), S=S))
    np.testing.assert_array_equal(got.numpy(), want[:len(rows)])
    # at the lane's float dtypes the dense matrix's values, bit for bit
    for dt, npdt in ((torch.float32, np.float32), (torch.float64,
                                                   np.float64)):
        np.testing.assert_array_equal(
            got.to(dt).numpy(),
            _dense([r.astype(np.float64) for r in rows], S, npdt))


def test_delta_pack_equals_the_jax_lanes_buffers():
    """The port's packed buffers are the ones the JAX lane builds from the
    same rows (its host library, its offsets and escape destinations),
    less the JAX lane's padding to bucket sizes; escapes compared as a
    set, since the packer's threads append them as they finish."""
    from tombo_tpu import native as j_native
    rng = np.random.default_rng(3)
    rows = _case_rows("escapes", rng) + _case_rows("small deltas", rng)
    lens = np.array([r.shape[0] for r in rows], np.int64)
    S = t_batch._sig_bucket(int(lens.max()))
    flat8, offs, firsts, exc_dest, exc_res = t_batch._pack_delta_wire(
        rows, lens, S)
    j_flat8 = np.zeros(j_batch._geo_bucket(int(lens.sum())), np.int8)
    j_offs = np.zeros(len(rows), np.int64)
    np.cumsum(np.maximum(lens - 1, 0)[:-1], out=j_offs[1:])
    j_firsts, j_rd, j_pos, j_res = j_native.pack_delta8_batch(
        rows, lens, j_flat8, j_offs)
    assert flat8.shape[0] == max(int(np.maximum(lens - 1, 0).sum()), 1)
    np.testing.assert_array_equal(flat8, j_flat8[:flat8.shape[0]])
    assert not j_flat8[flat8.shape[0]:].any()
    np.testing.assert_array_equal(offs, j_offs)
    np.testing.assert_array_equal(firsts, j_firsts)
    assert exc_dest.shape == exc_res.shape == j_rd.shape
    assert sorted(zip(exc_dest.tolist(), exc_res.tolist())) == \
        sorted(zip((j_pos + 1 + j_rd * S).tolist(), j_res.tolist()))


@pytest.fixture(scope="module")
def kb_batch():
    model, params, sst, maps = _prep_reads(12, seed=21, read_len=1000)
    t_model = convert.kmer_model(model.means, model.sds, model.central_pos,
                                 model.name, "DNA")
    t_params, t_maps = _convert(params, maps)
    return t_model, t_params, t_maps


def _run(kb_batch, dense, monkeypatch):
    t_model, t_params, t_maps = kb_batch
    if dense:
        # no read integral: every group takes the dense upload
        monkeypatch.setattr(t_batch, "_as_int16", lambda signal, raw: None)
    prof = t_batch.StageProfile()
    out = t_batch.BatchedResquiggler(
        t_model, t_params, convert.seq_samp_type("DNA", False),
        j_config.OUTLIER_THRESH, dtype="float32", device="cpu",
        profile=prof).resquiggle_batch(t_maps)
    monkeypatch.undo()
    return out, prof


def test_wire_results_bitwise_the_dense_upload(kb_batch, monkeypatch):
    """A 1 kb float32 batch (12 reads, every raw signal integral): the
    same results as with the dense float32 upload, bit for bit, and fewer
    bytes up in all."""
    assert all(np.all(m.raw_signal == np.trunc(m.raw_signal))
               for m in kb_batch[2])
    wire, wire_prof = _run(kb_batch, False, monkeypatch)
    dense, dense_prof = _run(kb_batch, True, monkeypatch)
    assert sum(r is not None for r, _ in wire) >= 10
    for (a, ea), (b, eb) in zip(wire, dense):
        assert ea == eb
        if a is None:
            continue
        np.testing.assert_array_equal(a.segs, b.segs)
        np.testing.assert_array_equal(a.raw_signal, b.raw_signal)
        assert a.scale_values == b.scale_values
        assert a.sig_match_score == b.sig_match_score
    assert wire_prof.transfer_bytes["upload"] < \
        dense_prof.transfer_bytes["upload"]


@pytest.mark.parametrize("n_shards", [1, 2])
def test_raw_upload_bytes_fall_3x(kb_batch, n_shards):
    """The 1 kb batch's raw matrix through ``_upload_raw`` on a 1-device
    lane and on each shard of a 2-shard mesh, int8 deltas and the dense
    upload (the same reads with ``raw_i16`` unset): bitwise the dense
    float32 matrix, and the bytes up (``StageProfile.transfer_bytes``) at
    least 3x fewer than the dense upload's."""
    t_model, t_params, t_maps = kb_batch
    br = t_batch.BatchedResquiggler(
        t_model, t_params, convert.seq_samp_type("DNA", False),
        j_config.OUTLIER_THRESH, dtype="float32",
        mesh=[torch.device("cpu")] * n_shards)
    S = t_batch._sig_bucket(max(m.raw_signal.shape[0] for m in t_maps))
    half = len(t_maps) // n_shards
    for maps in ((t_maps[:half], t_maps[half:]) if n_shards == 2
                 else (t_maps,)):
        got = {}
        for wire in (True, False):
            shard = [t_batch._ReadState(
                idx=i, map_res=m, raw=np.asarray(m.raw_signal, np.float64),
                num_events=0) for i, m in enumerate(maps)]
            for s in shard:
                assert s.raw_i16 is not None
                if not wire:
                    s.raw_i16 = None
            br.profile = t_batch.StageProfile()
            raw_j, lens_j = br._upload_raw(shard, torch.device("cpu"), S)
            got[wire] = (raw_j, br.profile.transfer_bytes["upload"])
        assert got[True][0].dtype == got[False][0].dtype == torch.float32
        np.testing.assert_array_equal(got[True][0].numpy(),
                                      got[False][0].numpy())
        np.testing.assert_array_equal(
            lens_j.numpy(), [m.raw_signal.shape[0] for m in maps])
        assert got[False][1] >= 3 * got[True][1], got


@pytest.mark.parametrize("n_shards", [2, 3])
def test_mesh_lane_wire_bitwise_one_device(kb_batch, n_shards,
                                           monkeypatch):
    """The 1 kb batch over a mesh of CPU shards, each shard's reads on
    their own int8-delta wire: results bitwise the 1-device lane's, and
    fewer bytes up than the same mesh with the dense upload (each shard's
    raw matrix alone: test_raw_upload_bytes_fall_3x)."""
    from tombo_tpu_torch.parallel import mesh as t_mesh
    t_model, t_params, t_maps = kb_batch

    def run(n):
        prof = t_batch.StageProfile()
        return t_batch.BatchedResquiggler(
            t_model, t_params, convert.seq_samp_type("DNA", False),
            j_config.OUTLIER_THRESH, dtype="float32", profile=prof,
            mesh=t_mesh.make_mesh(["cpu"] * n)).resquiggle_batch(t_maps), \
            prof.transfer_bytes["upload"]

    one, _ = run(1)
    mesh, wire_bytes = run(n_shards)
    assert t_mesh.lane_differences(mesh, one, exact=True) == []
    assert sum(r is not None for r, _ in mesh) >= 10
    monkeypatch.setattr(t_batch, "_as_int16", lambda signal, raw: None)
    _, dense_bytes = run(n_shards)
    assert wire_bytes < dense_bytes


def test_each_shard_decides_on_the_wire(kb_batch, monkeypatch):
    """A 1 kb batch with one read's signal off the integers, over two
    shards: the shard of integral reads takes the wire, the other the
    dense matrix, and the results are bitwise the 1-device lane's (which
    sends that group dense)."""
    from tombo_tpu_torch.parallel import mesh as t_mesh
    t_model, t_params, t_maps = kb_batch
    maps = list(t_maps)
    maps[3] = maps[3].replace(raw_signal=maps[3].raw_signal + 0.5)
    packed = []
    pack = t_batch._pack_delta_wire

    def pack_rec(raws, sig_lens, S):
        packed.append(len(raws))
        return pack(raws, sig_lens, S)

    monkeypatch.setattr(t_batch, "_pack_delta_wire", pack_rec)
    out = {}
    for n in (1, 2):
        del packed[:]
        out[n] = t_batch.BatchedResquiggler(
            t_model, t_params, convert.seq_samp_type("DNA", False),
            j_config.OUTLIER_THRESH, dtype="float32",
            mesh=t_mesh.make_mesh(["cpu"] * n)).resquiggle_batch(
                maps, max_scaling_iters=1)
        out[n] = (out[n], list(packed))
    assert out[1][1] == []
    assert out[2][1] == [len(maps) // 2]
    assert t_mesh.lane_differences(out[2][0], out[1][0], exact=True) == []
    assert sum(r is not None for r, _ in out[2][0]) >= 10


def test_integrality_looked_at_once_a_read_in_seg_pack(kb_batch,
                                                       monkeypatch):
    """Each read's signal is looked at for the wire once in a batch of
    two scaling passes, and the time it takes counts in ``seg_pack``."""
    t_model, t_params, t_maps = kb_batch
    seen = []
    as_int16 = t_batch._as_int16

    def slow(signal, raw):
        seen.append(raw.shape[0])
        time.sleep(0.05)
        return as_int16(signal, raw)

    monkeypatch.setattr(t_batch, "_as_int16", slow)
    prof = t_batch.StageProfile()
    out = t_batch.BatchedResquiggler(
        t_model, t_params, convert.seq_samp_type("DNA", False),
        j_config.OUTLIER_THRESH, dtype="float32", device="cpu",
        profile=prof).resquiggle_batch(t_maps, max_scaling_iters=2)
    assert sum(r is not None for r, _ in out) >= 10
    assert sorted(seen) == sorted(m.raw_signal.shape[0] for m in t_maps)
    assert prof.timings["seg_pack"] >= 0.05 * len(t_maps)


@pytest.mark.parametrize("signal,wire", [
    (np.array([3, -2, 2 ** 15 - 1], np.int16), True),
    (np.array([3.0, -2.0, 512.0, -32767.0]), True),
    (np.array([3.0, -2.5, 512.0]), False),
    (np.array([3.0, 2.0 ** 15]), False),
    (np.zeros(0), False)], ids=["int16", "integral", "fraction",
                                "too large", "empty"])
def test_which_signals_take_the_wire(signal, wire):
    """A read's raw signal takes the wire when it is int16, or integral
    and below 2^15 in magnitude (the JAX lane's ``raw_i16``)."""
    raw = np.asarray(signal, np.float64)
    got = t_batch._as_int16(signal, raw)
    assert (got is not None) == wire
    if wire:
        assert got.dtype == np.int16
        np.testing.assert_array_equal(got.astype(np.float64), raw)
