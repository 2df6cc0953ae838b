"""The banded DP kernel's plain PyTorch version (ops/banded_dp.py, row
loops of ops/dp.py) against the JAX scan engine and the Pallas kernel in
interpret mode, on the inputs of tests/test_pallas_dp.py.

float32: segs and error flags exact; final_fwd within atol 1e-4 plus
rtol 4e-6.  The relative term is there because the two sides round the
band prefix sums differently: XLA's float32 cumsum on the CPU is a tree
sum, while the port accumulates in float64 and rounds once (so that the
CUDA kernel's block scan reproduces it); over 128 rows of values near 100
the reference's own rounding drifts ~1e-6 relative.  float64: everything
exact."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tombo_tpu.ops import dp as j_dp
from tombo_tpu.ops import pallas_dp as j_pdp
from tombo_tpu_torch import kernels
from tombo_tpu_torch.ops import banded_dp as t_bdp
from tombo_tpu_torch.ops import dp as t_dp


def _mk_case(seed, B=8, L_max=128, P_max=64, bw=32, E_max=512):
    """Same generator as tests/test_pallas_dp.py::_mk_case."""
    rng = np.random.default_rng(seed)
    em = rng.normal(0, 1, (B, E_max)).astype(np.float32)
    n_events = rng.integers(300, E_max, B)
    seq_lens = rng.integers(60, L_max, B)
    rm = rng.normal(0, 1, (B, L_max)).astype(np.float32)
    rs = np.abs(rng.normal(1, 0.1, (B, L_max))).astype(np.float32)
    P_rows = rng.integers(8, P_max, B)
    pstarts = np.zeros((B, P_max), np.int64)
    pend = np.full((B, P_max), 2 ** 31 - 1, np.int64)
    pvalid = rng.integers(0, 4, B)
    for i in range(B):
        st = np.cumsum(rng.integers(0, 3, P_rows[i])) - 4
        pstarts[i, :P_rows[i]] = st
        pstarts[i, P_rows[i]:] = st[-1]
        pend[i, :P_rows[i]] = st + bw + rng.integers(-3, 3, P_rows[i])
    args = (em, n_events, rm, rs, seq_lens, pstarts, pvalid,
            np.clip(pend, 0, 2 ** 31 - 1), P_rows)
    return args, seq_lens


def _params(bw, cls):
    return cls(z_shift=2.0, skip_pen=4.2, stay_pen=4.2,
               mask_fill_z_score=-15.0, max_half_z_score=20.0, bandwidth=bw)


def _run_torch(args, bw, L, P, thresh):
    return t_bdp.adaptive_banded_dp_tb(
        *[torch.tensor(a) for a in args], _params(bw, t_dp.DpParams), L, P,
        thresh)


def _check(t_out, segs_ref, band_ref, bound_ref, ffwd_ref, seq_lens, bw,
           exact=False):
    segs, band_err, bound_err, ffwd = [x.numpy() for x in t_out]
    np.testing.assert_array_equal(band_err, np.asarray(band_ref))
    np.testing.assert_array_equal(bound_err, np.asarray(bound_ref))
    segs_ref = np.asarray(segs_ref)
    for i, n in enumerate(seq_lens):
        np.testing.assert_array_equal(segs[i, :n + 1], segs_ref[i, :n + 1])
    if exact:
        np.testing.assert_array_equal(ffwd, np.asarray(ffwd_ref)[:, :bw])
    else:
        np.testing.assert_allclose(ffwd, np.asarray(ffwd_ref)[:, :bw],
                                   atol=1e-4, rtol=4e-6)


@pytest.mark.parametrize("seed,dtype", [(3, np.float32), (5, np.float32),
                                        (11, np.float32), (3, np.float64),
                                        (5, np.float64)])
def test_plain_dp_matches_scan_engine(seed, dtype):
    args, seq_lens = _mk_case(seed)
    args = tuple(a.astype(dtype) if a.dtype == np.float32 else a
                 for a in args)
    L, P, bw = 128, 64, 32
    p = _params(bw, j_dp.DpParams)
    tb, band_starts, final_fwd, band_err = j_dp.adaptive_banded_dp(
        *map(jnp.asarray, args), p, L, P)
    top = jnp.argmax(final_fwd, axis=1).astype(jnp.int32)
    segs, bound_err = j_dp.banded_traceback(
        tb, band_starts, jnp.asarray(seq_lens), top, 10, bw, L)
    _check(_run_torch(args, bw, L, P, 10), segs, band_err, bound_err,
           final_fwd, seq_lens, bw, exact=dtype == np.float64)


# seq_lens given to the first reads of a batch of L 128: no row, one row,
# every row but one, every row, and more rows than the call runs
EDGE_SEQ_LENS = (0, 1, 127, 128, 133)


@pytest.mark.parametrize("bw,edge", [(32, False), (32, True), (64, True)])
def test_plain_dp_matches_pallas_interpret(bw, edge):
    """The plain version against the JAX kernel in interpret mode, with
    edge seq_lens on some reads.  A read with no last row within L
    (seq_len 0 or > L) differs by design (ROADMAP Queue 3): the port keeps
    a zero final row and starts its walk at the read's first prefix band
    start, as K1 does, where the JAX kernel returns a NEG_LARGE row and,
    at seq_len 0, reads its start from no band start at all.  Its rows
    [0, min(seq_len, L)) and its flags agree."""
    args, seq_lens = _mk_case(3, bw=bw)
    if edge:
        seq_lens = seq_lens.copy()
        seq_lens[:len(EDGE_SEQ_LENS)] = EDGE_SEQ_LENS
        args = args[:4] + (seq_lens,) + args[5:]
    L, P = 128, 64
    j_out = [np.asarray(x) for x in j_pdp.adaptive_banded_dp_tb(
        *map(jnp.asarray, args), _params(bw, j_dp.DpParams), L, P, 10,
        block_reads=4, interpret=True, variant="loop")]
    t_out = _run_torch(args, bw, L, P, 10)
    last = (seq_lens >= 1) & (seq_lens <= L)
    _check([x[torch.from_numpy(last)] for x in t_out],
           *[x[last] for x in j_out], seq_lens[last], bw)
    segs, band_err, bound_err, ffwd = [x.numpy() for x in t_out]
    np.testing.assert_array_equal(band_err, j_out[1])
    np.testing.assert_array_equal(bound_err, j_out[2])
    for i in np.flatnonzero(~last):
        if seq_lens[i] == 0:       # entry 0 is the walk's start + 1
            assert segs[i, 0] == args[5][i, 0] + 1
            np.testing.assert_array_equal(segs[i, 1:], j_out[0][i, 1:])
        else:
            np.testing.assert_array_equal(segs[i], j_out[0][i])
        np.testing.assert_array_equal(ffwd[i], 0)
        np.testing.assert_array_equal(j_out[3][i, :bw],
                                      np.float32(j_dp.NEG_LARGE))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_start_dp_parameterization_matches_start_band_dp(dtype):
    rng = np.random.default_rng(17)
    B, nb, ne = 6, 40, 60
    em = rng.normal(0, 1, (B, nb + ne + 7)).astype(dtype)
    rm = rng.normal(0, 1, (B, nb)).astype(dtype)
    rs = rng.uniform(0.8, 1.2, (B, nb)).astype(dtype)
    sp_kw = dict(z_shift=2.0, skip_pen=4.2, stay_pen=4.2,
                 max_half_z_score=20.0, num_bases=nb, num_events=ne)
    j_segs, _, _ = j_dp.start_band_dp(
        jnp.asarray(em[:, :nb + ne]), jnp.asarray(rm), jnp.asarray(rs),
        j_dp.StartDpParams(**sp_kw))
    t_segs = t_bdp.start_dp_segs(
        torch.tensor(em[:, :nb + ne]), torch.tensor(rm), torch.tensor(rs),
        t_dp.StartDpParams(**sp_kw))
    np.testing.assert_array_equal(t_segs.numpy(), np.asarray(j_segs))
    # the port's own row-loop start DP agrees too
    t_segs2, _, _ = t_dp.start_band_dp(
        torch.tensor(em), torch.tensor(rm), torch.tensor(rs),
        t_dp.StartDpParams(**sp_kw))
    np.testing.assert_array_equal(t_segs2.numpy(), np.asarray(j_segs))


def test_cpu_path_launches_no_kernel():
    before = kernels.LAUNCHES["banded_dp"]
    args, _ = _mk_case(7, B=2, L_max=64, P_max=16, bw=16)
    _run_torch(args, 16, 64, 16, 4)
    assert kernels.LAUNCHES["banded_dp"] == before


def test_move_stride_holds_codes_and_band_start():
    """K1's scratch row: bw move codes and a 4-byte band start, padded to
    16 bytes and no more."""
    for bw in range(1, 4097):
        m = t_bdp.move_stride(bw)
        assert m % 16 == 0 and bw + 4 <= m < bw + 20
