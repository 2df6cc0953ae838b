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
batches of any size (the mesh lane's shards are such batches).
Detection (de novo, sample-compare, the alternative-model test with
per-read blocks, a level test) from the card's device means matches
the same code on the CPU, and so do ``alt_llhr`` and the level tests
alone.  The model re-centring fit (DNA and RNA) on the card matches its
float32 run on the CPU, and so does the re-squiggle runner over a memory
source of mapped error-prone reads.  Two processes on the card merge
their detection over gloo into the one-process statistics.  The plot
data (k-mer levels, max-difference regions, clustered traces, accuracy
rates) from the card's device means equal the CPU's bit for bit.  The
one-read API (``resquiggle_read_with_retries``) on the card matches its
float64 run on the CPU and the batched lane's card result within the
batch-parity bars, launching the start DP (K4, through K1), the adaptive
DP (K1; the chunked pair for a read past the fused cap) and the count
kernel (K5).  The row-writing instances of K1 and K2' (the DP debug
dump) give the normal instances' results bitwise, and rows within the DP
bars of the plain version; the dump changes no one-read result."""
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


def _assert_rows_close(k, q, seq_lens, L):
    """The rows of a ``rows=True`` call against the plain version's: band
    starts exact, move codes equal on >= 99.5% of in-band cells, forward
    values within 1e-3 (the DP bars), rows past each read zero in both."""
    live = (torch.arange(L, device=k[4].device)[None, :] <
            seq_lens.clamp(max=L)[:, None])
    assert torch.equal(k[6], q[6])
    assert float((k[5] == q[5])[live].float().mean()) >= 0.995
    assert float((k[4] - q[4]).abs()[live].max()) <= 1e-3
    for t in k[4:]:
        assert not t[~live].any()


@pytest.mark.parametrize("bw,L,Lc,B,edge", [PAIR_SHAPES[i]
                                            for i in (1, 2, 6, 8)])
def test_row_writing_instances_equal_normal(card, bw, L, Lc, B, edge):
    """K1's and K2''s row-writing instances (the DP debug dump): segs,
    flags and final row bitwise the normal instances', the fused and
    chunked rows bitwise each other, and within the DP bars of the plain
    version; each counts under its own name only."""
    args, p, P = _pair_case(bw, L, B, edge)
    args = [a.to(card) for a in args]
    f = banded_dp.adaptive_banded_dp_tb(*args, p, L, P, 10)
    c = banded_dp.adaptive_banded_dp_tb_chunked(*args, p, L, P, 10,
                                                chunk_rows=Lc)
    before = dict(kernels.LAUNCHES)
    fr = banded_dp.adaptive_banded_dp_tb(*args, p, L, P, 10, rows=True)
    cr = banded_dp.adaptive_banded_dp_tb_chunked(*args, p, L, P, 10,
                                                 chunk_rows=Lc, rows=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == dict(
        before, banded_dp_rows=before["banded_dp_rows"] + 1,
        banded_dp_chunked_fwd=before["banded_dp_chunked_fwd"] + 1,
        banded_dp_chunked_tb_rows=before["banded_dp_chunked_tb_rows"] + 1)
    for a, b in zip(fr[:4], f):
        assert torch.equal(a, b)
    for a, b in zip(cr[:4], c):
        assert torch.equal(a, b)
    for a, b in zip(fr, cr):
        assert a.dtype == b.dtype and torch.equal(a, b)
    q = banded_dp.adaptive_banded_dp_tb_plain(*args, p, L, P, 10, rows=True)
    _assert_rows_close(fr, q, args[4], L)


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


def _card_detection_index(card, n_reads=8, ref_len=6000):
    """``n_reads`` 1,000-base reads re-squiggled on the card; their device
    means registered again as CPU copies.  Returns (index, reference,
    model)."""
    from tombo_tpu_torch.io.index import ReadsIndex
    from tombo_tpu_torch.stats import device_levels
    from tombo_tpu_torch.types import ReadData
    rng = np.random.default_rng(9)
    model = KmerModel.load_default("DNA")
    fasta = testing.random_reference(np.random.default_rng(10), ref_len)
    sst = SeqSampleType("DNA", False)
    params = config.load_resquiggle_parameters("DNA")
    maps = []
    for i in range(n_reads):
        read = testing.simulate_read(rng, fasta, model, read_len=1000,
                                     read_id="d_%03d" % i)
        mr = rsq.map_read(SequenceData(read.seq, read.read_id, 12.0),
                          ExactAligner(fasta), model, sst)
        maps.append(rsq.adjust_map_res(
            mr.replace(raw_signal=read.raw_signal.astype(np.float64)), sst,
            params))
    device_levels.clear()
    out = BatchedResquiggler(model, params, sst,
                             device="cuda").resquiggle_batch(maps)
    index, rows, entries = ReadsIndex(), [], []
    for res, err in out:
        assert err is None, err
        gl, n = res.genome_loc, len(res.segs) - 1
        rid = res.align_info.read_id
        src, off = device_levels.lookup(rid, n, card)
        # one merged source, not a new merge at each lookup
        assert src is device_levels.lookup(rid, n, card)[0]
        rows.append(src[off:off + n].cpu())
        entries.append((rid, len(entries), n))
        index.add_read_data(gl.chrom, gl.strand, ReadData(
            gl.start, gl.start + n, False, 0, gl.strand, "", "g", False,
            read_id=rid))
    device_levels.register_batch(torch.stack(rows), entries)
    return index, fasta, model


def test_detection_on_card_matches_cpu(card):
    """Eight 1,000-base reads re-squiggled on the card register their
    device means; de novo and sample-compare detection from them on the
    card equal the same code on CPU copies of the means at float32:
    positions and coverage exact, at most one flipped entry."""
    from tombo_tpu_torch.stats import detect, device_levels
    index, fasta, model = _card_detection_index(card)
    for stat_type, th in (("de_novo", config.DE_NOVO_THRESH["DNA"]),
                          ("sample_compare",
                           config.SAMP_COMP_THRESH["DNA"])):
        p = detect.TestParams(stat_type, single_read_thresh=th[1],
                              lower_thresh=th[0], region_size=2000)
        ctrl = index if stat_type == "sample_compare" else None
        on_card, on_cpu = ([s for _, s, _ in detect.iter_region_stats(
            index, p, fasta, model, ctrl, device=d, core=512)]
            for d in ("cuda", "cpu"))
        assert len(on_card) == len(on_cpu) >= 2
        flips = 0
        for a, b in zip(on_card, on_cpu):
            np.testing.assert_array_equal(a.reg_poss, b.reg_poss)
            np.testing.assert_array_equal(a.reg_cov, b.reg_cov)
            flips += int(np.sum(a.valid_cov != b.valid_cov))
            flips += int(np.sum(~np.isclose(
                a.reg_frac_standard_base, b.reg_frac_standard_base,
                rtol=0, atol=0, equal_nan=True)))
        assert flips <= 1, (stat_type, flips)
    device_levels.clear()


def test_two_process_merge_on_card_matches_one_process(card, tmp_path):
    """chip_smoke.py's multi-host phase at a smaller size: the eight
    reads' device means in two spawned processes on the card that meet
    over gloo; de novo and 5mC with per-read blocks, sample-compare and
    KS (the reads their own control) merged by host 0 equal this
    process's one-host run (model statistics exactly, KS within the
    float32 level bar), and the hosts' per-read blocks are the one-host
    blocks."""
    import chip_smoke
    from tombo_tpu_torch.stats import device_levels
    index, fasta, _ = _card_detection_index(card)
    out = chip_smoke.multihost_phase(
        card, {"1kb": index, "ctrl": index, "samp": index},
        {"1kb": fasta, "level": fasta},
        chip_smoke.multihost_runs(level_min_reads=2, region_size=2000),
        timeout=240)
    assert len(out) == 4 and all(v["sites"] > 0 for v in out.values())
    assert out["1 kb de novo, per-read"]["per_read_entries"] > 1000
    device_levels.clear()


def test_alt_llhr_on_card_matches_cpu(card):
    """The alternative-model ratio of stacked windows, both forms, on the
    card against the CPU at float32 (rtol 1e-5) and float64."""
    from tombo_tpu_torch.stats import device as sdev
    rng = np.random.default_rng(2)
    H, k = 4096, 6
    m = rng.normal(0, 1, (H, k))
    args = [m, m + rng.normal(0, 0.5, (H, k)),
            m + rng.normal(0.3, 0.5, (H, k)), rng.uniform(0.05, 0.5, H)]
    for standard in (False, True):
        c = [torch.tensor(a, dtype=torch.float32) for a in args]
        on_card = sdev.alt_llhr(*(x.to(card) for x in c), standard,
                                config.OCLLHR_SCALE, config.OCLLHR_HEIGHT,
                                config.OCLLHR_POWER).cpu()
        on_cpu = sdev.alt_llhr(*c, standard, config.OCLLHR_SCALE,
                               config.OCLLHR_HEIGHT, config.OCLLHR_POWER)
        f64 = sdev.alt_llhr(*(torch.tensor(a) for a in args), standard,
                            config.OCLLHR_SCALE, config.OCLLHR_HEIGHT,
                            config.OCLLHR_POWER)
        assert on_card.dtype == torch.float32
        np.testing.assert_allclose(on_card.numpy(), on_cpu.numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(on_card.numpy(), f64.numpy(), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("name", ["ks", "u", "t"])
def test_level_tests_on_card_match_cpu(card, name):
    """KS, U and t, both forms, on (sites, coverage) NaN-padded float32
    level matrices on the card against the same call on the CPU: the KS
    statistic and the U statistic exact (sorts and counts), p-values and
    the t statistic within 1e-4 relative."""
    from tombo_tpu_torch.stats import device as sdev
    fn = {"ks": sdev.ks_tests, "u": sdev.u_tests, "t": sdev.t_tests}[name]
    rng = np.random.default_rng(3)
    P, C = 2048, 96
    samp = rng.normal(0, 1, (P, C))
    ctrl = rng.normal(0.2, 1, (P, C))
    for x in (samp, ctrl):
        x[np.arange(C)[None, :] >= rng.integers(1, C, P)[:, None]] = np.nan
    samp[:4] = np.round(samp[:4] * 4) / 4      # ties
    ctrl[:4] = np.round(ctrl[:4] * 4) / 4
    samp[4] = np.nan                           # an empty site
    s32 = torch.tensor(samp, dtype=torch.float32)
    c32 = torch.tensor(ctrl, dtype=torch.float32)
    for return_stat in (False, True):
        on_card = fn(s32.to(card), c32.to(card), return_stat).cpu().numpy()
        on_cpu = fn(s32, c32, return_stat).numpy()
        exact = return_stat and name in ("ks", "u")
        np.testing.assert_allclose(on_card, on_cpu, rtol=0 if exact else 1e-4,
                                   atol=0 if exact else 1e-30,
                                   equal_nan=True)


def test_alt_level_per_read_on_card_match_cpu(card):
    """From the card's device means: the alternative-model test (5mC and
    CpG) with per-read blocks, and a level test with the reads split in
    two, on the card against the same code on CPU copies of the means at
    float32: positions and coverage exact, at most one flipped entry, the
    per-read blocks' keys equal."""
    from tombo_tpu_torch.io.index import ReadsIndex
    from tombo_tpu_torch.io.model_io import load_alt_refs
    from tombo_tpu_torch.stats import detect, device_levels
    index, fasta, model = _card_detection_index(card)
    lo, hi = config.LLR_THRESH["DNA"]
    p = detect.TestParams("model_compare", single_read_thresh=hi,
                          lower_thresh=lo, region_size=2000)
    refs = load_alt_refs(["5mC", "CpG"], "DNA")
    on_card, on_cpu = (list(detect.iter_region_stats(
        index, p, fasta, model, device=d, alt_refs=refs,
        emit_per_read=True)) for d in ("cuda", "cpu"))
    assert len(on_card) == len(on_cpu) >= 2
    flips = 0
    for (na, a, pa), (nb, b, pb) in zip(on_card, on_cpu):
        assert na == nb
        np.testing.assert_array_equal(a.reg_poss, b.reg_poss)
        np.testing.assert_array_equal(a.reg_cov, b.reg_cov)
        flips += int(np.sum(a.valid_cov != b.valid_cov))
        np.testing.assert_array_equal(pa[1]["pos"], pb[1]["pos"])
        np.testing.assert_array_equal(pa[1]["read_id"], pb[1]["read_id"])
    assert flips <= 1
    samp, ctrl = ReadsIndex(), ReadsIndex()
    for (chrm, strand), reads in index.reads_index.items():
        for i, r in enumerate(reads):
            (samp, ctrl)[i % 2].add_read_data(chrm, strand, r)
    lv = detect.TestParams("u", min_test_reads=1, region_size=2000)
    on_card, on_cpu = ([s for _, s, _ in detect.iter_region_stats(
        samp, lv, None, None, ctrl, device=d)] for d in ("cuda", "cpu"))
    assert len(on_card) == len(on_cpu)
    for a, b in zip(on_card, on_cpu):
        np.testing.assert_array_equal(a.reg_poss, b.reg_poss)
        np.testing.assert_array_equal(a.reg_cov, b.reg_cov)
        np.testing.assert_allclose(a.reg_stats, b.reg_stats, rtol=1e-3,
                                   equal_nan=True)
    device_levels.clear()


@pytest.mark.parametrize("samp_type", ["DNA", "RNA"])
def test_recentring_on_card_matches_cpu(card, samp_type):
    """The re-centring fit's corrections of simulated reads (their true
    segments, 1,200 bases: more than the Theil-Sen cap of 1,000 points;
    one RNA read with a stall) on the card, through the count kernel,
    against the same code at float32 on the CPU: the same reads fitted,
    corrections within 1e-5 relative."""
    from tombo_tpu_torch.stats import estimate as est
    rng = np.random.default_rng(61)
    rna = samp_type == "RNA"
    model = KmerModel.load_default(samp_type)
    fasta = testing.random_reference(np.random.default_rng(62), 20000)
    reads = []
    for i in range(12):
        read = testing.simulate_read(
            rng, fasta, model, read_len=1200, read_id="rc_%02d" % i,
            **(dict(mean_dwell=12.0, rev_sig=True) if rna else {}))
        rsrtr = read.read_start_rel_to_raw
        segs = read.true_segs - rsrtr
        raw = read.raw_signal
        if rna and i == 0:
            sig = testing.insert_stall(rng, raw[::-1], rsrtr + segs[600],
                                       3000)
            segs = np.where(np.arange(segs.shape[0]) >= 600, segs + 3000,
                            segs)
            raw = sig[::-1]
        reads.append(est.RecenterRead(raw, segs[:-1], read.seq, rna, rsrtr))
    before = kernels.LAUNCHES["count_le"]
    g_sh, g_sc, g_ok = est.read_corr_factors(reads, model, device=card)
    assert kernels.LAUNCHES["count_le"] > before
    c_sh, c_sc, c_ok = est.read_corr_factors(reads, model, device="cpu")
    np.testing.assert_array_equal(g_ok, c_ok)
    assert g_ok.sum() >= 10
    np.testing.assert_allclose(g_sh[g_ok], c_sh[c_ok], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(g_sc[g_ok], c_sc[c_ok], rtol=1e-5)


def test_memory_runner_on_card_matches_cpu(card):
    """The re-squiggle runner over a memory source of 128 simulated 1 kb
    reads with 8% basecall errors (the native minimizer aligner), on the
    card and on the CPU: the same summary and index, each read within
    the batch-parity bars; the card's run launches K1 and K5."""
    from tombo_tpu_torch.pipeline import runner
    from tombo_tpu_torch.pipeline.aligner import MinimizerAligner
    rng = np.random.default_rng(71)
    model = KmerModel.load_default("DNA")
    fasta = testing.random_reference(np.random.default_rng(72), 60000)
    reads = []
    for i in range(128):
        r = testing.simulate_read(rng, fasta, model, read_len=1000,
                                  read_id="mr_%03d" % i)
        reads.append((r.read_id, r.raw_signal, SequenceData(
            testing.mutate_seq(rng, r.seq, 0.08), r.read_id, 12.0)))
    source = runner.MemoryReads(reads)
    aligner = MinimizerAligner(fasta)
    sst = SeqSampleType("DNA", False)
    params = config.load_resquiggle_parameters("DNA")
    results = {}
    orig = BatchedResquiggler.resquiggle_batches
    out = {}
    for dev in ("cuda", "cpu"):
        got = results.setdefault(dev, {})
        before = dict(kernels.LAUNCHES)

        def rec(self, batches, **kw):
            for res in orig(self, batches, **kw):
                for r, e in res:
                    if r is not None:
                        got[r.align_info.read_id] = r
                yield res
        BatchedResquiggler.resquiggle_batches = rec
        try:
            out[dev] = runner.resquiggle_all_reads(
                source, aligner, model, sst, params,
                runner.RunConfig(device=dev, num_io_threads=4))
        finally:
            BatchedResquiggler.resquiggle_batches = orig
        if dev == "cuda":
            launches = {n: kernels.LAUNCHES[n] - before[n] for n in before}
    assert launches["banded_dp"] > 0 and launches["count_le"] > 0
    (g_sum, g_idx), (c_sum, c_idx) = out["cuda"], out["cpu"]
    assert g_sum.as_dict() == c_sum.as_dict() and g_sum.n_success >= 100
    assert sorted(results["cuda"]) == sorted(results["cpu"])
    for rid, g in results["cuda"].items():
        c = results["cpu"][rid]
        assert g.segs.shape == c.segs.shape
        assert g.read_start_rel_to_raw == c.read_start_rel_to_raw
        assert np.mean(g.segs == c.segs) > 0.99
        sc = c.scale_values.scale
        assert abs(g.scale_values.shift - c.scale_values.shift) / sc < 2e-3
        assert abs(g.scale_values.scale - sc) / sc < 2e-3
        assert abs(g.sig_match_score - c.sig_match_score) < 1e-2
    assert sorted((k, r.read_id, r.start, r.end)
                  for k, v in g_idx.reads_index.items() for r in v) == \
        sorted((k, r.read_id, r.start, r.end)
               for k, v in c_idx.reads_index.items() for r in v)


def test_plot_data_on_card_matches_cpu(card):
    """48 1 kb reads re-squiggled on the card (16 a position): the plot
    data from the card's device means equal the same
    functions on CPU copies of the means: k-mer levels (both forms), the
    max-difference regions, the clustered traces at slide_span 0 and 3
    (split into sample and control halves), and the accuracy rates of
    300,000 pairs with ties, bitwise."""
    from tombo_tpu_torch.io.index import ReadsIndex
    from tombo_tpu_torch.plot import accuracy, signal
    from tombo_tpu_torch.stats import device_levels
    index, fasta, model = _card_detection_index(card, 48, 3000)
    samp, ctrl = ReadsIndex(), ReadsIndex()
    for i, ((chrm, strand), r) in enumerate(
            (cs, r) for cs, rs in index for r in rs):
        (samp if i % 2 else ctrl).add_read_data(chrm, strand, r)
    regions = [("chr_test", s, s + 21, st, "%03d" % i, "r%d" % i)
               for i, (s, st) in enumerate(
                   [(p, st) for p in range(1000, 2000, 200)
                    for st in "+-"])]
    out = {}
    for d in (card, torch.device("cpu")):
        out[d.type] = (
            signal.kmer_levels(index, 3, 8, device=d, fasta=fasta),
            signal.kmer_levels(index, 2, 8, read_mean=True,
                               num_kmer_threshold=2, device=d,
                               fasta=fasta),
            [(r.chrm, r.strand, r.start, r.end) for r in
             signal.max_difference_regions(samp, ctrl, 6, 21, device=d)],
            [signal.cluster_traces(regions, samp, ctrl, span, device=d)
             for span in (0, 3)])
    g, c = out["cuda"], out["cpu"]
    assert g[0] == c[0] and g[1] == c[1] and g[0]
    assert g[2] == c[2] and len(g[2]) == 6
    for a, b in zip(g[3], c[3]):
        assert list(a) == list(b) and a
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    rng = np.random.default_rng(4)
    pairs = (np.round(rng.normal(0, 1, 300000), 2), rng.random(300000) < 0.4)
    on_card, on_cpu = (accuracy.prep_accuracy_rates(
        {"m": pairs}, verbose=False, device=d)["m"] for d in ("cuda", "cpu"))
    for a, b in zip(on_card, on_cpu):
        np.testing.assert_array_equal(a, b)
    device_levels.clear()


def _one_read_maps(read_lens, seed, samp_type="DNA", stalls=None):
    rng = np.random.default_rng(seed)
    rna = samp_type == "RNA"
    model = KmerModel.load_default(samp_type)
    fasta = testing.random_reference(np.random.default_rng(seed + 1),
                                     max(30000, 2 * max(read_lens)))
    sst = SeqSampleType(samp_type, rna)
    params = config.load_resquiggle_parameters(samp_type)
    sim = (dict(mean_dwell=12.0, rev_sig=True, adapter_len=(600, 900))
           if rna else {})
    maps = []
    for i, n in enumerate(read_lens):
        read = testing.simulate_read(rng, fasta, model, read_len=n,
                                     read_id="o_%03d" % i, **sim)
        raw = read.raw_signal
        if stalls and stalls[i]:
            raw = testing.insert_stall(
                rng, raw, raw.shape[0] - int(read.true_segs[n // 2]),
                stalls[i])
        mr = rsq.map_read(SequenceData(read.seq, read.read_id, 12.0),
                          ExactAligner(fasta), model, sst)
        maps.append(rsq.adjust_map_res(
            mr.replace(raw_signal=raw.astype(np.float64)), sst, params))
    return model, params, sst, maps


def _assert_bars(g, c):
    """tests/test_batch_parity.py's bars, the start equal."""
    assert g.segs.shape == c.segs.shape
    assert g.read_start_rel_to_raw == c.read_start_rel_to_raw
    assert np.mean(g.segs == c.segs) > 0.99
    sc = c.scale_values.scale
    assert abs(g.scale_values.shift - c.scale_values.shift) / sc < 2e-3
    assert abs(g.scale_values.scale - sc) / sc < 2e-3
    assert abs(g.sig_match_score - c.sig_match_score) < 1e-2


@pytest.mark.parametrize("samp_type,read_lens,stalls", [
    ("DNA", [1000, 1000, 1500, 400], None),
    ("RNA", [1700, 1700], [0, 3000])])
def test_one_read_on_card_matches_cpu_and_batch(card, samp_type, read_lens,
                                                stalls):
    model, params, sst, maps = _one_read_maps(read_lens, 13, samp_type,
                                              stalls)
    save = config.load_resquiggle_parameters(samp_type,
                                             use_save_bandwidth=True)
    before = dict(kernels.LAUNCHES)
    g_out = []
    for mr in maps:
        g_out.append(rsq.resquiggle_read_with_retries(
            mr, model, params, save, outlier_thresh=config.OUTLIER_THRESH,
            seq_samp_type=sst))
    launches = {n: kernels.LAUNCHES[n] - before[n] for n in before}
    assert launches["banded_dp"] > 0 and launches["count_le"] > 0
    b_out = BatchedResquiggler(model, params, sst, config.OUTLIER_THRESH,
                               device="cuda").resquiggle_batch(maps)
    for mr, g, (b, be) in zip(maps, g_out, b_out):
        c = rsq.resquiggle_read_with_retries(
            mr, model, params, save, outlier_thresh=config.OUTLIER_THRESH,
            seq_samp_type=sst, device="cpu", dtype=torch.float64)
        _assert_bars(g, c)
        assert be is None, be
        _assert_bars(g, b)


def test_one_read_long_read_runs_chunked_on_card(card):
    """A read past the fused cap (its rows rounded up as the batched path
    rounds them) takes the chunked pair (K2, K2') at a batch of one."""
    model, params, sst, maps = _one_read_maps([30000], 17)
    before = dict(kernels.LAUNCHES)
    g = rsq.resquiggle_read(maps[0], model, params,
                            outlier_thresh=config.OUTLIER_THRESH,
                            seq_samp_type=sst)
    launches = {n: kernels.LAUNCHES[n] - before[n] for n in before}
    assert launches["banded_dp_chunked_fwd"] == 1
    assert launches["banded_dp_chunked_tb"] == 1
    assert launches["banded_dp"] >= 1          # the start DP
    assert g.segs.shape[0] == len(g.genome_seq) + 1
    assert np.all(np.diff(g.segs) > 0)


DUMP_KEYS = {"fwd_pass": np.float32, "fwd_pass_tb": np.int8,
             "band_event_starts": np.int64, "read_tb": np.int64,
             "event_means": np.float32, "ref_means": np.float32,
             "ref_sds": np.float32, "events_start_clip": np.int64,
             "lower_margin": np.int64, "upper_margin": np.int64,
             "bandwidth": np.int64}


@pytest.mark.parametrize("samp_type,read_lens", [("DNA", [1000, 1200]),
                                                 ("RNA", [1700])])
def test_one_read_dump_on_card_changes_nothing(card, tmp_path, samp_type,
                                               read_lens):
    """The one-read API with ``debug_dp_dir`` on the card: the results
    bitwise those without it, one launch of K1's row-writing instance a
    pass and none of the normal one's for the adaptive DP, and a file a
    read with the JAX package's entries, dtypes and shapes."""
    model, params, sst, maps = _one_read_maps(read_lens, 19, samp_type)
    for mr in maps:
        kw = dict(outlier_thresh=config.OUTLIER_THRESH, seq_samp_type=sst)
        plain = rsq.resquiggle_read(mr, model, params, **kw)
        before = dict(kernels.LAUNCHES)
        dumped = rsq.resquiggle_read(mr, model, params,
                                     debug_dp_dir=str(tmp_path), **kw)
        launches = {n: kernels.LAUNCHES[n] - before[n] for n in before}
        assert launches["banded_dp_rows"] == 1
        assert launches["banded_dp"] == launches["start_dp"]
        np.testing.assert_array_equal(dumped.segs, plain.segs)
        assert dumped.scale_values == plain.scale_values
        assert dumped.sig_match_score == plain.sig_match_score
        with np.load(tmp_path / ("dp_debug.%s.npz" %
                                 mr.align_info.read_id)) as f:
            assert {k: f[k].dtype for k in f.files} == DUMP_KEYS
            L = f["ref_means"].shape[0]
            assert f["fwd_pass"].shape == f["fwd_pass_tb"].shape == (
                L + 1, int(f["bandwidth"]))
            assert f["band_event_starts"].shape == (L,)
            assert np.isfinite(f["fwd_pass"]).all()
