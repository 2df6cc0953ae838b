"""The row-chunked DP pair's plain version
(ops/banded_dp.py ``adaptive_banded_dp_tb_chunked_plain``, the CPU side of
K2 + K2') against the JAX package's chunked Pallas kernels in interpret
mode, the JAX scan engine and the port's fused plain version, on the
inputs of tests/test_pallas_dp.py; and the layout planner that picks
fused or chunked.

Bars as tests/test_torch_dp.py: float32 segs and flags exact, final_fwd
within atol 1e-4 plus rtol 4e-6; float64 exact.  Against the fused plain
version everything is exact at any chunk length: the chunked pair
recomputes the same rows from the same carried state."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tombo_tpu.ops import dp as j_dp
from tombo_tpu.ops import pallas_dp as j_pdp
from tombo_tpu_torch import kernels
from tombo_tpu_torch.ops import banded_dp as t_bdp
from tombo_tpu_torch.ops import dp as t_dp

from test_torch_dp import _check, _mk_case, _params

L, P, BW = 128, 64, 32


def _run_chunked(args, chunk_rows, bw=BW, n_rows=L, prefix_rows=P):
    return t_bdp.adaptive_banded_dp_tb_chunked(
        *[torch.tensor(a) for a in args], _params(bw, t_dp.DpParams),
        n_rows, prefix_rows, 10, chunk_rows=chunk_rows)


@pytest.mark.parametrize("R,Lc", [(4, 32), (8, 64)])
def test_chunked_plain_matches_pallas_chunked_interpret(R, Lc):
    args, seq_lens = _mk_case(5)
    j_out = j_pdp.adaptive_banded_dp_tb_chunked(
        *map(jnp.asarray, args), _params(BW, j_dp.DpParams), L, P, 10,
        block_reads=R, chunk_rows=Lc, interpret=True, variant="loop")
    _check(_run_chunked(args, Lc), *j_out, seq_lens, BW)


@pytest.mark.parametrize("seed,Lc", [(3, 32), (5, 48), (11, 64)])
def test_chunked_plain_matches_scan_engine_f64(seed, Lc):
    args, seq_lens = _mk_case(seed)
    args = tuple(a.astype(np.float64) if a.dtype == np.float32 else a
                 for a in args)
    p = _params(BW, j_dp.DpParams)
    tb, band_starts, final_fwd, band_err = j_dp.adaptive_banded_dp(
        *map(jnp.asarray, args), p, L, P)
    top = jnp.argmax(final_fwd, axis=1).astype(jnp.int32)
    segs, bound_err = j_dp.banded_traceback(
        tb, band_starts, jnp.asarray(seq_lens), top, 10, BW, L)
    _check(_run_chunked(args, Lc), segs, band_err, bound_err, final_fwd,
           seq_lens, BW, exact=True)


@pytest.mark.parametrize("seed,Lc", [(3, 1), (3, 16), (7, 48), (11, 100),
                                     (5, 128), (5, 512)])
def test_chunked_plain_equals_fused_plain(seed, Lc):
    """Any chunk length, including one that does not divide L, L itself
    and one longer than L."""
    args, _ = _mk_case(seed)
    fused = t_bdp.adaptive_banded_dp_tb_plain(
        *[torch.tensor(a) for a in args], _params(BW, t_dp.DpParams), L, P,
        10)
    for a, b in zip(fused, _run_chunked(args, Lc)):
        assert torch.equal(a, b)


def _scratch_bytes(n_rows, bw, Lc):
    """Per-read device scratch of the chunked pair at the chunk rows the
    kernels take for ``Lc``: one forward-row checkpoint (bw floats + band
    start) per chunk; the move tiles stay in shared memory."""
    return t_bdp.chunked_scratch_bytes(n_rows, bw, t_bdp.tile_rows(bw, Lc))


@pytest.mark.parametrize("bw", [1, 32, 300, 750, 1500, 2500, 4096])
def test_tile_rows_fit_the_shared_memory_budget(bw):
    """Lc_k: at least 1, at most chunk_rows, its tile plus the row loop's
    buffers within the block's budget, and the most rows that fit.  Two
    blocks share an SM while a tile there keeps CHUNK_ROWS / 2 rows."""
    budget = t_bdp.tb_smem_budget(bw)
    assert budget in (t_bdp.TB_SMEM_HALF, t_bdp.TB_SMEM_BUDGET)
    assert 2 * (t_bdp.TB_SMEM_HALF + 2048) <= 233472   # one H100 SM
    assert t_bdp.TB_SMEM_BUDGET + 1024 <= 232448       # one H100 block
    for chunk_rows in (1, 48, 512):
        lc = t_bdp.tile_rows(bw, chunk_rows)
        assert 1 <= lc <= chunk_rows
        assert t_bdp.tb_smem_bytes(lc, bw) <= budget
        if lc < chunk_rows:
            assert t_bdp.tb_smem_bytes(lc + 1, bw) > budget
    if budget == t_bdp.TB_SMEM_HALF:
        assert t_bdp.tile_rows(bw) >= t_bdp.CHUNK_ROWS // 2
    expect = {300: 351, 1500: 135, 4096: 39}
    if bw in expect:
        assert t_bdp.tile_rows(bw) == expect[bw]


@pytest.mark.parametrize("bw,L", [(1500, 300), (4096, 100)])
def test_chunked_plain_split_at_tile_rows_equals_fused_f64(bw, L):
    """Split where the kernels split (Lc_k below chunk_rows: 135 rows at
    bw 1500, 39 at 4096), the plain chunked pair is the fused plain
    version bit for bit at float64, directly and through the wrapper."""
    args, _ = _mk_case(bw + L, B=2, L_max=L, P_max=16, bw=bw,
                       E_max=2 * bw + L)
    args = [torch.tensor(a.astype(np.float64) if a.dtype == np.float32
                         else a) for a in args]
    p = _params(bw, t_dp.DpParams)
    lc = t_bdp.tile_rows(bw)
    assert lc < L
    fused = t_bdp.adaptive_banded_dp_tb_plain(*args, p, L, 16, 10)
    split = t_bdp.adaptive_banded_dp_tb_chunked_plain(*args, p, L, 16, 10,
                                                      chunk_rows=lc)
    wrapped = t_bdp.adaptive_banded_dp_tb_chunked(*args, p, L, 16, 10)
    for a, b, c in zip(fused, split, wrapped):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("n_rows,bw,chunk_rows", [
    (32768, 300, 512), (8192, 1500, 512), (4096, 4096, 512), (100, 32, 64),
    (1, 300, 512)])
def test_chunked_scratch_is_checkpoints_only(n_rows, bw, chunk_rows):
    """The wrapper's device scratch is one checkpoint per Lc_k rows,
    ceil(L / Lc_k) * (4 bw + 4) bytes a read, and no (Lc, bw) move tile:
    chunked_scratch allocates exactly what chunked_scratch_bytes states."""
    lc = t_bdp.tile_rows(bw, min(chunk_rows, n_rows))
    per_read = t_bdp.chunked_scratch_bytes(n_rows, bw, lc)
    assert per_read == -(-n_rows // lc) * (4 * bw + 4)
    ckpt, start = t_bdp.chunked_scratch(3, n_rows, bw, lc, "cpu")
    nbytes = ckpt.numel() * ckpt.element_size() + \
        start.numel() * start.element_size()
    assert nbytes == 3 * per_read
    if n_rows == 32768:     # 94 checkpoints; no 512 x 300 move tile
        assert per_read == 94 * 1204


@pytest.mark.parametrize("bw", [300, 500, 750, 1500, 2500])
def test_plan_fused_within_cap_else_chunked(bw):
    for n_rows in (256, 1024, 4096, 16384, 32768, 131072):
        layout = t_bdp.plan_dp_layout(n_rows, bw)
        if layout[0] == "fused":
            assert n_rows * bw <= t_bdp.PER_READ_MOVE_CAP, (bw, n_rows)
        else:
            assert n_rows * bw > t_bdp.PER_READ_MOVE_CAP, (bw, n_rows)
            assert layout == ("chunked", t_bdp.CHUNK_ROWS), layout
            # scratch no longer grows with L the way K1's moves do
            assert _scratch_bytes(n_rows, bw, layout[1]) < n_rows * bw


def test_plan_routes_the_path_shapes():
    plan = t_bdp.plan_dp_layout
    # the chunked tile does not depend on the read's length ...
    assert plan(4096, 2500) == plan(131072, 2500) == ("chunked", 512)
    # ... and at 131,072 rows its scratch, one checkpoint per Lc_k rows
    # (4 bytes a band position per Lc_k rows: 512 rows at bw 300, 75 at
    # 2500), is under 1/15 of K1's moves
    for bw in (300, 1500, 2500):
        Lc = plan(131072, bw)[1]
        assert _scratch_bytes(131072, bw, Lc) * 15 < 131072 * bw
    # a 30 kb read at the save bandwidth, and at the main bandwidth
    assert plan(32768, 1500)[0] == "chunked"
    assert plan(32768, 300)[0] == "chunked"
    # the main 1 kb shape, both start bands, the fused limits
    for n_rows, bw in ((1024, 300), (250, 750), (250, 2500), (16384, 300),
                       (4096, 1500)):
        assert plan(n_rows, bw) == ("fused",), (n_rows, bw)
    assert plan(8192, 1500)[0] == "chunked"


def test_cpu_chunked_launches_no_kernel():
    before = dict(kernels.LAUNCHES)
    args, _ = _mk_case(7, B=2, L_max=64, P_max=16, bw=16)
    _run_chunked(args, 16, bw=16, n_rows=64, prefix_rows=16)
    assert kernels.LAUNCHES == before
