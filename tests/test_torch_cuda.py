"""The port's CUDA kernels against their plain PyTorch versions on the
card, and the slice on the card against the slice on the CPU.

Every test here needs a CUDA card (marker ``cuda``) and skips without
one.  On a machine with a card and nvcc, run them with

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest`` because the suite's conftest imports jax, which this
file does not need).  Bars: the DP kernel's error flags are identical
and its boundaries equal on at least 99.5% of positions, final_fwd
within 1e-3 (float32 co-optimal ties, as in chip_smoke.py), also on
reads with no row, one row, every row and more rows than the call runs,
and each read of a ragged batch is bitwise what it is alone; the
chunked pair (K2 + K2') is bitwise equal to the fused kernel (K1), whose
row step it shares, and within K1's bars of its plain version; the count
kernel is exact, and so the median slope is bitwise equal.  The sharded
launcher (K3) over shards on one card is bitwise K1 and the chunked pair,
with one launch per non-empty shard.  The DP kernels also run at the
RNA widths (bw 500, 1000, 1500, 3000), and an RNA batch on the card
matches the CPU.  The fit's score of a read is bitwise the same in
batches of any size (the mesh lane's shards are such batches)."""
import numpy as np
import pytest
import torch

from tombo_tpu_torch import config, kernels, testing
from tombo_tpu_torch.io.model_io import KmerModel
from tombo_tpu_torch.ops import banded_dp, dp, rescale
from tombo_tpu_torch.parallel import mesh as pmesh
from tombo_tpu_torch.pipeline import batch as batch_mod
from tombo_tpu_torch.pipeline import resquiggle as rsq
from tombo_tpu_torch.pipeline.aligner import ExactAligner
from tombo_tpu_torch.pipeline.batch import BatchedResquiggler
from tombo_tpu_torch.types import SeqSampleType, SequenceData

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _dp_case(seed, B, L, P, bw, E):
    """Random DP inputs in the layout of the masked-start plan: monotone
    prefix band starts (some negative), prefix end masks."""
    rng = np.random.default_rng(seed)
    em = rng.normal(0, 1, (B, E)).astype(np.float32)
    n_events = rng.integers(E // 2, E, B)
    seq_lens = rng.integers(L // 2, L + 1, B)
    rm = rng.normal(0, 1, (B, L)).astype(np.float32)
    rs = np.abs(rng.normal(1, 0.1, (B, L))).astype(np.float32)
    start_rows = rng.integers(2, P, B)
    pstarts = np.zeros((B, P), np.int64)
    pend = np.full((B, P), 2 ** 31 - 1, np.int64)
    for i in range(B):
        st = np.cumsum(rng.integers(0, 3, start_rows[i])) - 4
        pstarts[i, :start_rows[i]] = st
        pstarts[i, start_rows[i]:] = st[-1]
        pend[i, :start_rows[i]] = st + bw + rng.integers(-3, 3,
                                                          start_rows[i])
    pvalid = rng.integers(0, 4, B)
    return [torch.tensor(a) for a in (em, n_events, rm, rs, seq_lens,
                                      pstarts, pvalid, pend, start_rows)]


@pytest.mark.parametrize("bw,B,L,P,E", [(32, 8, 128, 64, 512),
                                        (300, 16, 256, 64, 1024),
                                        (1100, 4, 128, 64, 2048),
                                        (2500, 4, 64, 32, 4096)])
def test_banded_dp_kernel_matches_plain(card, bw, B, L, P, E):
    args = [a.to(card) for a in _dp_case(bw, B, L, P, bw, E)]
    p = dp.DpParams(z_shift=2.0, skip_pen=4.2, stay_pen=4.2,
                    mask_fill_z_score=-15.0, max_half_z_score=20.0,
                    bandwidth=bw)
    before = dict(kernels.LAUNCHES)
    k = banded_dp.adaptive_banded_dp_tb(*args, p, L, P, 10)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == dict(before,
                                    banded_dp=before["banded_dp"] + 1)
    q = banded_dp.adaptive_banded_dp_tb_plain(*args, p, L, P, 10)
    _assert_dp_close(k, q, args[4], L)


# the RNA widths: main DP 500, start DP 1000, save bandwidth 1500,
# start retry 3000 (MAXI 2, 4, 8 and 16 instances)
@pytest.mark.parametrize("bw,B,L,P,E", [(500, 16, 512, 64, 2048),
                                        (1000, 8, 250, 250, 1250),
                                        (1500, 8, 512, 64, 3072),
                                        (3000, 4, 250, 250, 3250)])
def test_banded_dp_kernel_rna_widths(card, bw, B, L, P, E):
    args = [a.to(card) for a in _dp_case(bw + 1, B, L, P, bw, E)]
    p = dp.DpParams(z_shift=6.8, skip_pen=4.0, stay_pen=6.0,
                    mask_fill_z_score=-15.0, max_half_z_score=20.0,
                    bandwidth=bw)
    k = banded_dp.adaptive_banded_dp_tb(*args, p, L, P, 50)
    q = banded_dp.adaptive_banded_dp_tb_plain(*args, p, L, P, 50)
    torch.cuda.synchronize()
    assert torch.equal(k[1], q[1]) and torch.equal(k[2], q[2])
    mask = (torch.arange(L + 1, device=card)[None, :] <=
            args[4].clamp(max=L)[:, None])
    assert float((k[0].long() == q[0].long())[mask].float().mean()) >= 0.995
    assert float((k[3] - q[3]).abs().max()) <= 1e-3


@pytest.mark.parametrize("bw", [32, 300, 750, 2500])
def test_banded_dp_kernel_edge_seq_lens(card, bw):
    """K1 at B 1 on reads with no row, one row, every row and more rows
    than the call runs, against its plain version."""
    L, P = 256, 32
    base = _dp_case(bw + 7, 1, L, P, bw, 2 * L + bw)
    p = dp.DpParams(z_shift=2.0, skip_pen=4.2, stay_pen=4.2,
                    mask_fill_z_score=-15.0, max_half_z_score=20.0,
                    bandwidth=bw)
    for sl in (0, 1, L, L + 5):
        args = [a.clone() for a in base]
        args[4][0] = sl
        args = [a.to(card) for a in args]
        k = banded_dp.adaptive_banded_dp_tb(*args, p, L, P, 10)
        q = banded_dp.adaptive_banded_dp_tb_plain(*args, p, L, P, 10)
        torch.cuda.synchronize()
        _assert_dp_close(k, q, args[4], L)


def test_banded_dp_kernel_reads_independent(card):
    """Each read of a ragged batch (half of it at most L/2 long) gives,
    bitwise, what it gives alone."""
    bw, B, L, P = 300, 16, 1024, 64
    args = _dp_case(11, B, L, P, bw, 2 * L + bw)
    rng = np.random.default_rng(12)
    args[4][:B // 2] = torch.tensor(rng.integers(1, L // 2 + 1, B // 2))
    args[4][0] = 0
    args = [a.to(card) for a in args]
    p = dp.DpParams(z_shift=2.0, skip_pen=4.2, stay_pen=4.2,
                    mask_fill_z_score=-15.0, max_half_z_score=20.0,
                    bandwidth=bw)
    whole = banded_dp.adaptive_banded_dp_tb(*args, p, L, P, 10)
    for i in range(B):
        alone = banded_dp.adaptive_banded_dp_tb(
            *[a[i:i + 1] for a in args], p, L, P, 10)
        for x, y in zip(whole, alone):
            assert torch.equal(x[i:i + 1], y)


def _assert_dp_close(k, q, seq_lens, L):
    """K1's bars against a plain version: identical flags, >= 99.5% of
    boundaries equal, final_fwd within 1e-3."""
    assert torch.equal(k[1], q[1]) and torch.equal(k[2], q[2])
    mask = (torch.arange(L + 1, device=k[0].device)[None, :] <=
            seq_lens.clamp(max=L)[:, None])
    assert float((k[0].long() == q[0].long())[mask].float().mean()) >= 0.995
    assert float((k[3] - q[3]).abs().max()) <= 1e-3


# (bw, L, Lc, B, edge): the pair's shapes.  Lc is the chunk_rows asked
# for; the kernels chunk at banded_dp.tile_rows(bw, Lc), below it at bw
# 1500 (135) and 4096 (39).  With 8 blocks a cluster: (300, 2048, 512)
# has fewer chunks than a cluster, (300, 2600, 128) up to 21 (no multiple
# of 8), B 1 one cluster; edge sets seq_lens 0, 1, L and L + 5.
PAIR_SHAPES = [(32, 256, 64, 8, False), (300, 2048, 512, 8, False),
               (1500, 1024, 256, 8, False), (2500, 256, 128, 8, False),
               (300, 2600, 128, 8, False), (300, 2048, 512, 1, False),
               (300, 1024, 256, 8, True), (1500, 8192, 512, 8, False),
               (4096, 512, 512, 4, True), (500, 4096, 512, 8, False),
               (1500, 2048, 512, 4, True)]


def _pair_case(bw, L, B, edge):
    P = 64
    args = _dp_case(bw + L, B, L, P, bw, 2 * L + bw)
    if edge:
        args[4][:4] = torch.tensor([0, 1, L, L + 5])
    p = dp.DpParams(z_shift=2.0, skip_pen=4.2, stay_pen=4.2,
                    mask_fill_z_score=-15.0, max_half_z_score=20.0,
                    bandwidth=bw)
    return args, p, P


@pytest.mark.parametrize("bw,L,Lc,B,edge", PAIR_SHAPES)
def test_chunked_kernels_equal_fused_kernel(card, bw, L, Lc, B, edge):
    args, p, P = _pair_case(bw, L, B, edge)
    args = [a.to(card) for a in args]
    before = dict(kernels.LAUNCHES)
    c = banded_dp.adaptive_banded_dp_tb_chunked(*args, p, L, P, 10,
                                                chunk_rows=Lc)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == dict(
        before, banded_dp_chunked_fwd=before["banded_dp_chunked_fwd"] + 1,
        banded_dp_chunked_tb=before["banded_dp_chunked_tb"] + 1)
    f = banded_dp.adaptive_banded_dp_tb(*args, p, L, P, 10)
    torch.cuda.synchronize()
    for a, b in zip(c, f):
        assert torch.equal(a, b)
    q = banded_dp.adaptive_banded_dp_tb_chunked_plain(*args, p, L, P, 10,
                                                      chunk_rows=Lc)
    _assert_dp_close(c, q, args[4], L)


@pytest.mark.parametrize("bw,L,Lc,B,edge", PAIR_SHAPES)
def test_sharded_dp_equals_k1_and_pair(card, bw, L, Lc, B, edge):
    """K3 over two shards on one card, in both layouts, bitwise the
    unsharded K1 and K2/K2' on the same inputs, one launch per non-empty
    shard."""
    args, p, P = _pair_case(bw, L, B, edge)
    args = [a.to(card) for a in args]
    fused = banded_dp.adaptive_banded_dp_tb(*args, p, L, P, 10)
    pair = banded_dp.adaptive_banded_dp_tb_chunked(*args, p, L, P, 10,
                                                   chunk_rows=Lc)
    mesh = pmesh.make_mesh(["cuda", "cuda"])
    n_shards = sum(1 for n in pmesh.shard_sizes(B, mesh) if n)
    for layout, names in ((("fused",), ("banded_dp",)),
                          (("chunked", Lc), ("banded_dp_chunked_fwd",
                                             "banded_dp_chunked_tb"))):
        before = dict(kernels.LAUNCHES)
        out = banded_dp.adaptive_banded_dp_tb_sharded(mesh, args, p, L, P,
                                                      10, layout)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES == dict(
            before, **{n: before[n] + n_shards
                       for n in names + ("banded_dp_sharded",)})
        for a, f, c in zip(out, fused, pair):
            assert a.device == mesh[0]
            assert torch.equal(a, f) and torch.equal(a, c)


def test_sharded_dp_empty_shard_launches_nothing(card):
    """3 reads over 4 shards on one card: 3 launches, bitwise K1."""
    L, P, bw = 256, 64, 300
    args = [a.to(card) for a in _dp_case(5, 3, L, P, bw, 1024)]
    p = dp.DpParams(z_shift=2.0, skip_pen=4.2, stay_pen=4.2,
                    mask_fill_z_score=-15.0, max_half_z_score=20.0,
                    bandwidth=bw)
    fused = banded_dp.adaptive_banded_dp_tb(*args, p, L, P, 10)
    before = dict(kernels.LAUNCHES)
    out = banded_dp.adaptive_banded_dp_tb_sharded(
        pmesh.make_mesh(["cuda"] * 4), args, p, L, P, 10, ("fused",))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == dict(
        before, banded_dp=before["banded_dp"] + 3,
        banded_dp_sharded=before["banded_dp_sharded"] + 3)
    for a, f in zip(out, fused):
        assert torch.equal(a, f)


def test_sharded_dp_shards_on_their_own_cards(card, monkeypatch):
    """Over cuda:0 and cuda:1, called with cuda:0 current: each shard's
    outputs lie on its own card before the gather, and the launch on
    cuda:1 computes what K1 computes there."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    L, P, bw = 256, 64, 300
    args = _dp_case(9, 6, L, P, bw, 1024)
    p = dp.DpParams(z_shift=2.0, skip_pen=4.2, stay_pen=4.2,
                    mask_fill_z_score=-15.0, max_half_z_score=20.0,
                    bandwidth=bw)
    ref = banded_dp.adaptive_banded_dp_tb(*[a.to("cuda:0") for a in args],
                                          p, L, P, 10)
    seen = []
    gather = banded_dp.gather

    def gather_rec(mesh, shards):
        seen.append([t.device for t in shards])
        return gather(mesh, shards)

    monkeypatch.setattr(banded_dp, "gather", gather_rec)
    mesh = pmesh.make_mesh(["cuda:0", "cuda:1"])
    with torch.cuda.device(0):
        out = banded_dp.adaptive_banded_dp_tb_sharded(mesh, args, p, L, P,
                                                      10, ("fused",))
        torch.cuda.synchronize(1)
        assert torch.cuda.current_device() == 0
    assert seen == [list(mesh)] * 4
    for a, r in zip(out, ref):
        assert torch.equal(a, r)


def test_start_dp_kernel_matches_start_band_dp(card):
    rng = np.random.default_rng(4)
    B, nb, ne = 8, 250, 750
    em = torch.tensor(rng.normal(0, 1, (B, nb + ne)), dtype=torch.float32,
                      device=card)
    rm = torch.tensor(rng.normal(0, 1, (B, nb)), dtype=torch.float32,
                      device=card)
    rs = torch.tensor(rng.uniform(0.8, 1.2, (B, nb)), dtype=torch.float32,
                      device=card)
    sp = dp.StartDpParams(z_shift=2.0, skip_pen=4.2, stay_pen=4.2,
                          max_half_z_score=20.0, num_bases=nb,
                          num_events=ne)
    k = banded_dp.start_dp_segs(em, rm, rs, sp)
    q, _, _ = dp.start_band_dp(em, rm, rs, sp)
    assert float((k.long() == q.long()).float().mean()) >= 0.995


@pytest.mark.parametrize("M,P", [(4096, 1), (523776, 8), (1001, 9),
                                 (20000, 20), (777, 32)])
def test_count_le_kernel_exact(card, M, P):
    g = torch.Generator().manual_seed(M + P)
    keys = torch.randint(-2 ** 31, 2 ** 31 - 1, (6, M), generator=g,
                         dtype=torch.int32)
    keys[:, -5:] = 2 ** 31 - 1
    piv = torch.randint(-2 ** 31, 2 ** 31 - 1, (6, P), generator=g,
                        dtype=torch.int32)
    piv[:, 0] = keys[:, 3]
    before = dict(kernels.LAUNCHES)
    out = rescale.count_le(keys.to(card), piv.to(card))
    assert kernels.LAUNCHES == dict(before, count_le=before["count_le"] + 1)
    assert torch.equal(out.cpu(), rescale.count_le_plain(keys, piv))


def test_median_slope_through_kernel_bitwise(card):
    rng = np.random.default_rng(12)
    B, N = 8, 1024
    ev = rng.normal(0, 1, (B, N)).astype(np.float32)
    mod = (ev * 1.1 + 0.2 + rng.normal(0, 0.2, (B, N))).astype(np.float32)
    ev[0, 3] = ev[0, 7]
    ev_t, mod_t = torch.tensor(ev, device=card), torch.tensor(mod,
                                                              device=card)
    n_pts = torch.tensor([N, N - 1, 900, 5, 2, N, 513, 1000], device=card)
    k = rescale.pairwise_slope_median_count(ev_t, mod_t, n_pts, 1000.0)
    q = rescale.pairwise_slope_median_count(
        ev_t, mod_t, n_pts, 1000.0, count_fn=rescale.count_le_plain)
    assert torch.equal(k.view(torch.int32), q.view(torch.int32))


def _card_vs_cpu(read_lens, seed, samp_type="DNA", stalls=None):
    """Simulated mapped reads of the given lengths (RNA: the recipe of
    tests/test_torch_rna.py, with a stall of ``stalls[i]`` samples)
    through the port on the card and on the CPU; returns the launches the
    card run made."""
    rng = np.random.default_rng(seed)
    rna = samp_type == "RNA"
    model = KmerModel.load_default(samp_type)
    fasta = testing.random_reference(np.random.default_rng(seed + 1), 30000)
    aligner = ExactAligner(fasta)
    sst = SeqSampleType(samp_type, rna)
    params = config.load_resquiggle_parameters(samp_type)
    sim = (dict(mean_dwell=12.0, rev_sig=True, adapter_len=(600, 900))
           if rna else {})
    maps = []
    for i, n in enumerate(read_lens):
        read = testing.simulate_read(rng, fasta, model, read_len=n,
                                     read_id="c_%03d" % i, **sim)
        raw = read.raw_signal
        if stalls and stalls[i]:
            raw = testing.insert_stall(
                rng, raw, raw.shape[0] - int(read.true_segs[n // 2]),
                stalls[i])
        mr = rsq.map_read(SequenceData(read.seq, read.read_id, 12.0),
                          aligner, model, sst)
        mr = mr.replace(raw_signal=raw.astype(np.float64))
        maps.append(rsq.adjust_map_res(mr, sst, params))
    before = dict(kernels.LAUNCHES)
    g_out = BatchedResquiggler(model, params, sst, config.OUTLIER_THRESH,
                               device="cuda").resquiggle_batch(maps)
    launches = {n: kernels.LAUNCHES[n] - before[n] for n in before}
    c_out = BatchedResquiggler(model, params, sst, config.OUTLIER_THRESH,
                               device="cpu").resquiggle_batch(maps)
    for (g, ge), (c, ce) in zip(g_out, c_out):
        assert (ge is None) == (ce is None), (ge, ce)
        if g is None:
            continue
        assert g.segs.shape == c.segs.shape
        assert g.read_start_rel_to_raw == c.read_start_rel_to_raw
        assert np.mean(g.segs == c.segs) > 0.99
        sc = c.scale_values.scale
        assert abs(g.scale_values.shift - c.scale_values.shift) / sc < 2e-3
        assert abs(g.scale_values.scale - sc) / sc < 2e-3
        assert abs(g.sig_match_score - c.sig_match_score) < 1e-2
    return launches


def test_slice_on_card_matches_cpu(card):
    launches = _card_vs_cpu([650] * 8, 7)
    assert launches["banded_dp"] > 0 and launches["count_le"] > 0
    assert launches["banded_dp_chunked_fwd"] == 0
    assert launches["banded_dp_chunked_tb"] == 0


def test_mixed_lengths_on_card_match_cpu(card, monkeypatch):
    """Six reads of 400 to 3,000 bases split into length groups; the
    longest group's DP runs chunked (per-read cap lowered below its
    moves) on the card and on the CPU."""
    monkeypatch.setattr(batch_mod, "_MIN_GROUP", 2)
    monkeypatch.setattr(banded_dp, "PER_READ_MOVE_CAP", 4096 * 300 - 1)
    launches = _card_vs_cpu([400, 520, 1100, 1300, 2500, 3000], 41)
    assert all(n > 0 for n in launches.values()), launches
    assert launches["banded_dp_chunked_fwd"] == \
        launches["banded_dp_chunked_tb"]


def test_rna_on_card_matches_cpu(card):
    """Six RNA reads of 1,700 bases, two with a stall, at bw 500 on the
    card against the CPU."""
    launches = _card_vs_cpu([1700] * 6, 7, "RNA",
                            [0, 0, 0, 0, 3000, 2500])
    assert launches["banded_dp"] > 0 and launches["count_le"] > 0


def test_fit_score_same_in_any_batch_size(card):
    """The score that the device fit gives a read is bitwise the same in a
    batch of 64 and in shards of 8 and of 1.  A plain ``sum(1)`` over the
    (B, L) terms fails this on the card: PyTorch's reduction lays out its
    threads by the number of rows, and below 16 rows a row is summed by
    more threads, in another order (``scripts/probe_sum_order.py``)."""
    rng = np.random.default_rng(5)
    B, L, S = 64, 2048, 32768
    seq_lens = rng.integers(1200, L + 1, B)
    segs = np.zeros((B, L + 1), np.int64)
    segs[:, 1:] = np.cumsum(rng.integers(3, 15, (B, L)), 1)
    rsrtr = rng.integers(0, 200, B)
    norm = rng.normal(0, 1, (B, S)).astype(np.float32)
    rm = rng.normal(0, 1, (B, L)).astype(np.float32)
    rs = np.abs(rng.normal(1, 0.1, (B, L))).astype(np.float32)
    tri = rescale.tri_indices(1000, card)
    samp = np.stack([np.sort(rng.choice(n, 1000, replace=False))
                     for n in seq_lens])

    def score(rows):
        t = lambda a: torch.tensor(a[rows], device=card)
        return batch_mod._stage_fit(
            t(norm), torch.arange(len(rows), device=card), t(rsrtr),
            t(segs), t(rm), t(rs), t(seq_lens), t(samp), tri, 0.1,
            0.1)[2].cpu().numpy()

    full = score(np.arange(B))
    parts = [np.arange(k, k + 8) for k in range(0, B, 8)] + [
        np.array([k]) for k in range(16)]
    diff = [int(k) for p in parts for k in p[score(p) != full[p]]]
    assert diff == [], "reads %s score differently" % diff
