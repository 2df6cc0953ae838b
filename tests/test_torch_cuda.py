"""The port's CUDA kernels against their plain PyTorch versions on the
card, and the slice on the card against the slice on the CPU.

Every test here needs a CUDA card (marker ``cuda``) and skips without
one.  On a machine with a card and nvcc, run them with

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest`` because the suite's conftest imports jax, which this
file does not need).  Bars: the DP kernel's error flags are identical
and its boundaries equal on at least 99.5% of positions, final_fwd
within 1e-3 (float32 co-optimal ties, as in chip_smoke.py); the count
kernel is exact, and so the median slope is bitwise equal."""
import numpy as np
import pytest
import torch

from tombo_tpu_torch import config, kernels, testing
from tombo_tpu_torch.io.model_io import KmerModel
from tombo_tpu_torch.ops import banded_dp, dp, rescale
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
    before = kernels.LAUNCHES["banded_dp"]
    k = banded_dp.adaptive_banded_dp_tb(*args, p, L, P, 10)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["banded_dp"] == before + 1
    q = banded_dp.adaptive_banded_dp_tb_plain(*args, p, L, P, 10)
    assert torch.equal(k[1], q[1]) and torch.equal(k[2], q[2])
    mask = (torch.arange(L + 1, device=card)[None, :] <=
            args[4].clamp(max=L)[:, None])
    assert float((k[0].long() == q[0].long())[mask].float().mean()) >= 0.995
    assert float((k[3] - q[3]).abs().max()) <= 1e-3


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
    out = rescale.count_le(keys.to(card), piv.to(card))
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


def test_slice_on_card_matches_cpu(card):
    rng = np.random.default_rng(7)
    model = KmerModel.load_default("DNA")
    fasta = testing.random_reference(np.random.default_rng(8), 30000)
    aligner = ExactAligner(fasta)
    sst = SeqSampleType("DNA", False)
    params = config.load_resquiggle_parameters("DNA")
    maps = []
    for i in range(8):
        read = testing.simulate_read(rng, fasta, model, read_len=650,
                                     read_id="c_%03d" % i)
        mr = rsq.map_read(SequenceData(read.seq, read.read_id, 12.0),
                          aligner, model, sst)
        mr = mr.replace(raw_signal=read.raw_signal.astype(np.float64))
        maps.append(rsq.adjust_map_res(mr, sst, params))
    before = dict(kernels.LAUNCHES)
    g_out = BatchedResquiggler(model, params, sst, config.OUTLIER_THRESH,
                               device=card).resquiggle_batch(maps)
    assert all(kernels.LAUNCHES[n] > before[n] for n in before)
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
