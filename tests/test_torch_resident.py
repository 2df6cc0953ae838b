"""The batched lane's device-resident data flow, against the JAX float32
lane's functions and against the values the host built and sent before:
bases packed two bits apiece and the k-mer codes and levels derived from
them on the device, the raw rows and changepoints a rescale pass gathers
where they stay, the uint8 segment-table wire with its full-row route,
the stacked fetch of per-read scalars, the bytes that cross, and the
mesh lane with rescale passes.  Seeded numpy inputs; the CPU runs every
kernel's plain version."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tombo_tpu import config as j_config
from tombo_tpu.io.model_io import KmerModel as JKmerModel
from tombo_tpu.pipeline import batch as j_batch
from tombo_tpu.seq import encode_seq as j_encode_seq
from tombo_tpu_torch import config as t_config
from tombo_tpu_torch import convert
from tombo_tpu_torch.parallel import mesh as t_mesh
from tombo_tpu_torch.pipeline import batch as t_batch
from tombo_tpu_torch.seq import encode_seq, seq_to_kmer_codes

from test_torch_batch import _convert, _prep_reads
from test_torch_rna import RNA, _rna_reads, _t_model

CPU = torch.device("cpu")
DNA_SST = convert.seq_samp_type("DNA", False)


def _seqs(rng, lens, invalid=None):
    seqs = ["".join(rng.choice(list("ACGT"), n)) for n in lens]
    if invalid is not None:
        i, pos = invalid
        seqs[i] = seqs[i][:pos] + "N" + seqs[i][pos + 1:]
    return seqs


def _dna_model():
    m = JKmerModel.load_default("DNA")
    return convert.kmer_model(m.means, m.sds, m.central_pos, m.name, "DNA")


# ------------------------------------------------- packed bases, codes
@pytest.mark.parametrize("n", [1, 4, 7, 250, 1003])
def test_pack_bases_bitwise_jax(n):
    """One read's base codes packed four to a byte: the JAX package's
    bytes."""
    bc = np.random.default_rng(n).integers(0, 4, n).astype(np.int8)
    np.testing.assert_array_equal(t_batch._pack_bases(bc),
                                  j_batch._pack_bases(bc))


@pytest.mark.parametrize("k", [6, 5], ids=["dna", "rna"])
@pytest.mark.parametrize("clip", [False, True], ids=["full", "clip"])
@pytest.mark.parametrize("width", [250, 1024])
def test_codes_from_packed_bitwise_jax(k, clip, width):
    """The batched planner's packed bases and codes (reads longer and
    shorter than the width, one with an invalid base) against the JAX
    package's ``_pack_bases`` and the host's ``seq_to_kmer_codes``; the
    codes derived from the packed bases on the device against the JAX
    function's exactly, and on the valid reads against the host's."""
    rng = np.random.default_rng(k * 1000 + width)
    lens = [width + k + 40, width + k - 1, width // 2, k, 300, 2 * width]
    seqs = _seqs(rng, lens, invalid=(4, 17))
    n_sent = 4 ** k
    codes, packed, starts, blens, bad = t_batch._kmer_plan(seqs, k)
    assert bad.tolist() == [False, False, False, False, True, False]
    n_codes = blens - k + 1
    PB = (width + k - 1 + 3) // 4
    pk = np.zeros((len(seqs), PB), np.uint8)
    for i, q in enumerate(seqs):
        a = starts[i]
        assert a % 4 == 0
        row = packed[a // 4:(a + len(q) + 3) // 4]
        host = seq_to_kmer_codes(encode_seq(q), k)
        if not bad[i]:
            np.testing.assert_array_equal(
                row, j_batch._pack_bases(j_encode_seq(q).astype(np.int8)))
            np.testing.assert_array_equal(codes[a:a + n_codes[i]], host)
        else:
            assert np.any(host < 0)
        pk[i, :min(PB, row.shape[0])] = row[:PB]
    want = np.asarray(j_batch._codes_from_packed(
        jnp.asarray(pk), jnp.asarray(n_codes.astype(np.int32)), width, k,
        n_sent, clip))
    got = t_batch._codes_from_packed(
        torch.as_tensor(pk), torch.as_tensor(n_codes.astype(np.int32)),
        width, k, n_sent, clip).numpy()
    np.testing.assert_array_equal(got, want)
    for i, q in enumerate(seqs):
        if bad[i]:
            continue
        host = seq_to_kmer_codes(encode_seq(q), k)
        n = host.shape[0]
        if clip:
            row = host[:width] if n >= width else np.full(width, n_sent)
        else:
            row = np.full(width, n_sent)
            row[:min(n, width)] = host[:width]
        np.testing.assert_array_equal(got[i], row)


def test_encode_seq_bitwise_jax():
    """Base codes of every byte value and of both cases: the JAX
    package's ``encode_seq``, in a writable array."""
    seq = "".join(map(chr, range(128))) + "acgtACGTNn-"
    got = encode_seq(seq)
    np.testing.assert_array_equal(got, j_encode_seq(seq))
    assert got.dtype == np.int8 and got.flags.writeable


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_levels_from_codes_bitwise_jax(dtype):
    """Levels gathered from the device table with its sentinel row: the
    JAX function's at float32 and float64."""
    model = _dna_model()
    np_dt = np.dtype(dtype)
    mt = np.append(model.means, 1.0).astype(np_dt)
    st = np.append(model.sds, 1.0).astype(np_dt)
    codes = np.random.default_rng(3).integers(
        0, model.means.shape[0] + 1, (5, 300)).astype(np.int32)
    want = j_batch._levels_from_codes(jnp.asarray(mt), jnp.asarray(st),
                                      jnp.asarray(codes))
    got = t_batch._levels_from_codes(torch.as_tensor(mt),
                                     torch.as_tensor(st),
                                     torch.as_tensor(codes))
    for g, w in zip(got, want):
        assert g.numpy().dtype == np_dt
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.fixture(scope="module")
def kb_reads():
    model, params, sst, maps = _prep_reads(12, seed=31, read_len=1000)
    t_params, t_maps = _convert(params, maps)
    return (model, params, sst, maps), (_dna_model(), t_params, t_maps)


def _states(maps):
    return [t_batch._ReadState(idx=i, map_res=m,
                               raw=np.asarray(m.raw_signal, np.float64),
                               num_events=0) for i, m in enumerate(maps)]


def test_plan_reads_bitwise_jax(kb_reads):
    """The batched planner on 12 reads, one with an invalid base and one
    with a sequence shorter than a k-mer: errors, codes, packed bases,
    levels and trimmed sequences equal the JAX planner's."""
    (model, params, sst, maps), (t_model, t_params, t_maps) = kb_reads
    maps, t_maps = list(maps), list(t_maps)
    for i, seq in ((3, maps[3].genome_seq[:40] + "N" +
                    maps[3].genome_seq[41:]), (7, "ACGT")):
        maps[i] = maps[i].replace(genome_seq=seq)
        t_maps[i] = t_maps[i].replace(genome_seq=seq)
    jbr = j_batch.BatchedResquiggler(model, params, sst,
                                     j_config.OUTLIER_THRESH,
                                     dtype=jnp.float32)
    j_st = [j_batch._ReadState(idx=i, map_res=m, raw=m.raw_signal,
                               num_events=0) for i, m in enumerate(maps)]
    tbr = t_batch.BatchedResquiggler(t_model, t_params, DNA_SST,
                                     dtype="float32", device="cpu")
    t_st = _states(t_maps)
    jbr._plan_reads(j_st)
    tbr._plan_reads(t_st)
    assert [s.error for s in t_st] == [s.error for s in j_st]
    assert t_st[3].error.startswith("Invalid sequence")
    assert t_st[7].error.startswith("Invalid sequence")
    for a, b in zip(t_st, j_st):
        if a.error is not None:
            continue
        for name in ("ref_codes", "packed_bases", "ref_means", "ref_sds"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
        assert a.genome_seq_trim == b.genome_seq_trim
        assert a.use_static == b.use_static


def _host_levels(states, width, clip, np_dt):
    """The level matrices the host built and sent before (ones-padded
    float64 rows cast to the lane's dtype)."""
    rm = np.ones((len(states), width))
    rs = np.ones((len(states), width))
    for i, s in enumerate(states):
        n = s.ref_means.shape[0]
        if clip:
            if n >= width:
                rm[i], rs[i] = s.ref_means[:width], s.ref_sds[:width]
        else:
            m = min(n, width)
            rm[i, :m], rs[i, :m] = s.ref_means[:m], s.ref_sds[:m]
    return rm.astype(np_dt), rs.astype(np_dt)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("route", ["packed", "dense"])
def test_device_levels_bitwise_host_built(kb_reads, dtype, route):
    """``_levels`` at the start prefix (clipped, 250 bases), at a DP
    width past every read and at one shorter than some: bitwise the
    host-built matrices, through the packed bases and, where a read has
    none, through dense code rows; the table goes up once a device and
    each packed call sends under a byte a base."""
    _, (t_model, t_params, t_maps) = kb_reads
    br = t_batch.BatchedResquiggler(t_model, t_params, DNA_SST,
                                    dtype=dtype, device="cpu")
    states = _states(t_maps)
    br._plan_reads(states)
    states = [s for s in states if s.error is None]
    if route == "dense":
        states[2].packed_bases = None
    br.profile = t_batch.StageProfile()
    br._levels_tab(CPU)
    tab_bytes = br.profile.transfer_bytes["upload"]
    for width, clip in ((250, True), (1024, False), (900, False),
                        (1000, True)):
        before = br.profile.transfer_bytes["upload"]
        got = br._levels(states, width, clip=clip, device=CPU)
        sent = br.profile.transfer_bytes["upload"] - before
        want = _host_levels(states, width, clip, np.dtype(dtype))
        for g, w in zip(got, want):
            assert g.dtype == getattr(torch, dtype)
            np.testing.assert_array_equal(g.numpy(), w)
        if route == "packed":
            assert sent <= len(states) * (width // 4 + 8), sent
    assert br.profile.transfer_bytes["upload"] > tab_bytes


# -------------------------------------------------- the stacked fetch
def _fake_states(n, raw_len):
    raw = np.broadcast_to(np.zeros(1), (raw_len,))
    return [t_batch._ReadState(idx=i, map_res=None, raw=raw, num_events=0)
            for i in range(n)]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_stacked_fetch_exact_below_2_24(dtype):
    """Integers below 2^24, flags and float32 values come down in one
    stacked float32 copy on the float32 lane, exactly; past the guard (a
    raw signal of 2^24 samples) or at float64 one copy a vector at its
    own dtype."""
    br = t_batch.BatchedResquiggler(_dna_model(),
                                    t_config.load_resquiggle_parameters(
                                        "DNA"), DNA_SST, dtype=dtype,
                                    device="cpu")
    rng = np.random.default_rng(5)
    ints = torch.as_tensor(np.append(rng.integers(0, 2 ** 24, 7),
                                     [2 ** 24 - 1]))
    flags = torch.as_tensor(rng.random(8) < 0.5)
    vals = torch.as_tensor(rng.normal(0, 1e3, 8).astype(
        np.float32 if dtype == "float32" else np.float64))
    for raw_len, stacked in ((2 ** 24 - 1, dtype == "float32"),
                             (2 ** 24, False)):
        br.profile = t_batch.StageProfile()
        out = br._np_scalars(_fake_states(8, raw_len), ints, flags, vals)
        assert br.profile.transfer_bytes["fetch"] == (
            3 * 8 * 4 if stacked else
            ints.numpy().nbytes + flags.numpy().nbytes + vals.numpy().nbytes)
        assert len(out) == 3
        if stacked:
            assert all(a.dtype == np.float32 for a in out)
        else:
            assert [a.dtype for a in out] == [np.int64, np.bool_,
                                              vals.numpy().dtype]
        np.testing.assert_array_equal(out[0].astype(np.int64), ints.numpy())
        np.testing.assert_array_equal(out[1].astype(bool), flags.numpy())
        np.testing.assert_array_equal(out[2], vals.numpy())


# --------------------------------------- rescale passes on the device
def _force_rescale(monkeypatch):
    """Every fitted read asks for another scaling iteration."""
    monkeypatch.setattr(t_config, "SHIFT_CHANGE_THRESH", -1.0)
    monkeypatch.setattr(t_config, "SCALE_CHANGE_THRESH", -1.0)


class _PassSpy:
    """Records, per scaling pass, the uploads (dtype, shape) and every
    rescale-pass stage A's inputs held against what the host would have
    built: the raw matrix through a fresh ``_upload_raw`` and the
    changepoints from each read's host copy of its first-pass row."""

    def __init__(self, monkeypatch, ref_br, regroup=False):
        cls = t_batch.BatchedResquiggler
        self.passes, self.checked, self.multi_src = [], 0, 0
        self.host_cpts = {}
        self.ref_br = ref_br
        run_pass, up = cls._run_pass, cls._up
        seg_shard, gather = cls._segment_shard, cls._gather_resident
        stage_a_rescale = t_batch._stage_a_rescale
        spy = self

        def run_pass_rec(br, states, *a, **kw):
            if regroup and spy.passes:
                # rescale passes as one length group of reads from both
                # first-pass groups
                monkeypatch.setattr(t_batch, "_MIN_GROUP", 10 ** 6)
            spy.passes.append({"up": [], "upload_raw": 0})
            return run_pass(br, states, *a, **kw)

        def up_rec(br, arr, device=None):
            if spy.passes and br is not spy.ref_br:
                a = np.asarray(arr)
                spy.passes[-1]["up"].append((a.dtype, a.shape))
            return up(br, arr, device)

        def seg_rec(br, live, dev, sig_w, cpts_w, rescale_pass, n_stalls):
            spy.live = (live, dev, sig_w, cpts_w)
            out = seg_shard(br, live, dev, sig_w, cpts_w, rescale_pass,
                            n_stalls)
            if not rescale_pass:
                for s in live:
                    if s.error is None:
                        src, row, n = s.cpts_dev
                        spy.host_cpts[s.idx] = src[row, :n].numpy().copy()
            return out

        def gather_rec(br, refs, dev, width):
            spy.multi_src += len({id(r[0]) for r in refs}) > 1
            return gather(br, refs, dev, width)

        def upload_rec(br, live, dev, sig_w):
            if br is not spy.ref_br:
                spy.passes[-1]["upload_raw"] += 1
            return upload_raw(br, live, dev, sig_w)

        def rescale_rec(raw, sig_lens, sv_shift, sv_scale, sv_lower,
                        sv_upper, cpts, n_cpts, *a):
            live, dev, sig_w, cpts_w = spy.live
            want_raw, want_lens = spy.ref_br._upload_raw(live, dev, sig_w)
            assert raw.dtype == want_raw.dtype
            assert torch.equal(raw, want_raw)
            assert torch.equal(sig_lens, want_lens)
            want = np.zeros((len(live), cpts_w), np.int64)
            for i, s in enumerate(live):
                c = spy.host_cpts[s.idx]
                want[i, :c.shape[0]] = c
            assert cpts.dtype == torch.int64
            np.testing.assert_array_equal(cpts.numpy(), want)
            np.testing.assert_array_equal(
                n_cpts.numpy(), [spy.host_cpts[s.idx].shape[0]
                                 for s in live])
            spy.checked += 1
            return stage_a_rescale(raw, sig_lens, sv_shift, sv_scale,
                                   sv_lower, sv_upper, cpts, n_cpts, *a)

        upload_raw = cls._upload_raw
        monkeypatch.setattr(cls, "_run_pass", run_pass_rec)
        monkeypatch.setattr(cls, "_up", up_rec)
        monkeypatch.setattr(cls, "_segment_shard", seg_rec)
        monkeypatch.setattr(cls, "_gather_resident", gather_rec)
        monkeypatch.setattr(cls, "_upload_raw", upload_rec)
        monkeypatch.setattr(t_batch, "_stage_a_rescale", rescale_rec)


def _mixed_maps(kb_reads):
    """The 1 kb reads and 12 of 400-650 bases, in one batch."""
    model, params, sst, maps = _prep_reads(12, seed=32, read_len=500)
    _, short = _convert(params, maps)
    return list(kb_reads[1][2]) + short


@pytest.mark.parametrize("path", ["1kb", "groups"])
def test_rescale_pass_gathers_on_the_device(kb_reads, path, monkeypatch):
    """A float32 batch with every fitted read rescaled twice (1 kb reads;
    and 24 reads in two length groups in the first pass and one in the
    rescale passes, which gather from both first-pass matrices): each
    rescale pass's raw matrix
    and changepoints bitwise what ``_upload_raw`` and the host
    changepoints give; a rescale pass packs and sends no raw signal, no
    float level row, and fewer bytes than its reads have samples."""
    _, (t_model, t_params, t_maps) = kb_reads
    maps = t_maps if path == "1kb" else _mixed_maps(kb_reads)
    if path == "groups":
        monkeypatch.setattr(t_batch, "_MIN_GROUP", 4)
    _force_rescale(monkeypatch)
    ref_br = t_batch.BatchedResquiggler(t_model, t_params, DNA_SST,
                                        dtype="float32", device="cpu")
    spy = _PassSpy(monkeypatch, ref_br, regroup=path == "groups")
    prof = t_batch.StageProfile()
    out = t_batch.BatchedResquiggler(
        t_model, t_params, DNA_SST, j_config.OUTLIER_THRESH,
        dtype="float32", device="cpu", profile=prof).resquiggle_batch(maps)
    assert sum(r is not None for r, _ in out) >= len(maps) - 2
    assert len(spy.passes) == 3 and spy.checked >= 2
    if path == "groups":
        assert spy.multi_src > 0
    first, rescale = spy.passes[0], spy.passes[1:]
    assert first["upload_raw"] >= 1
    n_samples = sum(m.raw_signal.shape[0] for m in maps)
    for p in rescale:
        assert p["upload_raw"] == 0
        assert not any(dt.kind == "f" and len(shape) == 2
                       for dt, shape in p["up"]), p["up"]
        assert sum(int(np.prod(shape)) * dt.itemsize
                   for dt, shape in p["up"]) < n_samples
    # the first pass's float rows: the k-mer table alone
    assert [shape for dt, shape in first["up"]
            if dt.kind == "f" and len(shape) == 2] == []
    assert "seg_pack" in prof.timings


def test_fetch_bytes_a_quarter_of_the_old_matrices(kb_reads, monkeypatch):
    """The 1 kb float32 batch's fetched bytes, all passes: below a
    quarter of what the (B, cpts_w) changepoint matrices of its selection
    passes and the (B, L + 1) int64 segment tables of its adaptive calls
    alone came to before, from the shapes the stages ran at."""
    _, (t_model, t_params, t_maps) = kb_reads
    old = {"cpts": 0, "segs": 0}
    stage_a, stage_fin = t_batch._stage_a_dna, t_batch._stage_finalize

    def stage_a_rec(*a, **kw):
        out = stage_a(*a, **kw)
        old["cpts"] += out[2].numel() * 8
        return out

    def fin_rec(*a, **kw):
        out = stage_fin(*a, **kw)
        old["segs"] += out[0].numel() * 8
        return out

    monkeypatch.setattr(t_batch, "_stage_a_dna", stage_a_rec)
    monkeypatch.setattr(t_batch, "_stage_finalize", fin_rec)
    prof = t_batch.StageProfile()
    out = t_batch.BatchedResquiggler(
        t_model, t_params, DNA_SST, j_config.OUTLIER_THRESH,
        dtype="float32", device="cpu", profile=prof).resquiggle_batch(t_maps)
    assert sum(r is not None for r, _ in out) >= 10
    assert old["cpts"] and old["segs"]
    assert 4 * prof.transfer_bytes["fetch"] < old["cpts"] + old["segs"], (
        prof.transfer_bytes, old)
    assert prof.row_fetches.get("cpts", 0) == 0


# ---------------------------------------------------- segment tables
@pytest.fixture(scope="module")
def rna_maps():
    model, params, sst, maps, _ = _rna_reads()
    t_params, t_maps = _convert(params, maps)
    return _t_model(model), t_params, t_maps


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_segment_wire_on_an_rna_stall(rna_maps, dtype, monkeypatch):
    """The RNA recipe (two reads with a stall): at least one table comes
    back through the full-row route (a segment over 255 samples); every
    table a read can use equals its full fetch from the device; the
    results are bitwise those of a run that fetches every table in
    full; the static-band read's changepoints are one host row fetch."""
    t_model, t_params, t_maps = rna_maps
    cls = t_batch.BatchedResquiggler
    seg_tables = cls._seg_tables
    seen = {"rows": 0, "over": 0}

    def tables_rec(br, d8, over, seq_segs_j):
        out = seg_tables(br, d8, over, seq_segs_j)
        full = seq_segs_j.numpy()
        for i in range(full.shape[0]):
            d = np.diff(full[i])
            n = np.argmax(d < 0) if np.any(d < 0) else d.shape[0]
            if over[i] or d[:n].max(initial=0) <= 255:
                np.testing.assert_array_equal(out[i, :n + 1],
                                              full[i, :n + 1])
                seen["rows"] += 1
            seen["over"] += int(over[i])
        return out

    def tables_full(br, d8, over, seq_segs_j):
        return br._np(seq_segs_j)[0].astype(np.int64)

    def run(fn):
        monkeypatch.setattr(cls, "_seg_tables", fn)
        prof = t_batch.StageProfile()
        out = t_batch.BatchedResquiggler(
            t_model, t_params, convert.seq_samp_type(RNA, True),
            j_config.OUTLIER_THRESH, dtype=dtype, device="cpu",
            profile=prof).resquiggle_batch(t_maps)
        return out, prof

    wire, prof = run(tables_rec)
    full, _ = run(tables_full)
    assert seen["over"] >= 1 and seen["rows"] >= len(t_maps)
    assert prof.row_fetches["seg_over"] == seen["over"]
    assert prof.row_fetches["cpts"] >= 1
    assert sum(r is not None for r, _ in wire) >= 5
    assert t_mesh.lane_differences(wire, full, exact=True) == []


# ------------------------------------------------------------- mesh
@pytest.mark.parametrize("n_shards", [2, 3])
def test_mesh_rescale_passes_bitwise_one_device(kb_reads, n_shards,
                                                monkeypatch):
    """The 1 kb float32 batch over 2 and 3 CPU shards, the first 8 of its
    12 reads rescaled twice: each rescale pass splits those 8 over the
    shards anew, so a shard gathers rows from two first-pass shards'
    matrices; the results equal the 1-device lane's bit for bit."""
    _, (t_model, t_params, t_maps) = kb_reads
    cls = t_batch.BatchedResquiggler
    gather, finalize = cls._gather_resident, cls._finalize
    srcs = []

    def gather_rec(br, refs, dev, width):
        srcs.append(len({id(r[0]) for r in refs}))
        return gather(br, refs, dev, width)

    def finalize_rec(br, states, *a, **kw):
        finalize(br, states, *a, **kw)
        for s in states:
            if s.result is not None and s.idx >= 8:
                s.result = s.result.replace(norm_params_changed=False)

    _force_rescale(monkeypatch)
    monkeypatch.setattr(cls, "_gather_resident", gather_rec)
    monkeypatch.setattr(cls, "_finalize", finalize_rec)

    def run(mesh):
        return t_batch.BatchedResquiggler(
            t_model, t_params, DNA_SST, j_config.OUTLIER_THRESH,
            dtype="float32", device="cpu", mesh=mesh).resquiggle_batch(
                t_maps)

    one = run(None)
    del srcs[:]
    mesh = run(t_mesh.make_mesh(["cpu"] * n_shards))
    assert srcs and max(srcs) > 1, srcs
    assert sum(r is not None for r, _ in mesh) >= 10
    assert t_mesh.lane_differences(mesh, one, exact=True) == []


def test_matrices_freed_when_the_batch_returns(kb_reads, monkeypatch):
    """No read keeps a device matrix once its scaling passes are done."""
    _, (t_model, t_params, t_maps) = kb_reads
    kept = []
    run_pass = t_batch.BatchedResquiggler._run_pass

    def rec(br, states, *a, **kw):
        kept.extend(states)
        return run_pass(br, states, *a, **kw)

    monkeypatch.setattr(t_batch.BatchedResquiggler, "_run_pass", rec)
    t_batch.BatchedResquiggler(
        t_model, t_params, DNA_SST, j_config.OUTLIER_THRESH,
        dtype="float32", device="cpu").resquiggle_batch(t_maps[:4])
    assert len(kept) >= 4 and all(
        s.raw_dev is None and s.cpts_dev is None for s in kept)
