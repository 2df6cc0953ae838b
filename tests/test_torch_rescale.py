"""The exact Theil-Sen fit of the port (ops/rescale.py) against the JAX
package: the count kernel's plain version against the Pallas count in
interpret mode (exact), the float32 median slope against the Pallas
selection (bitwise), and the whole float64 fit (bitwise)."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tombo_tpu.ops import rescale as j_rs
from tombo_tpu_torch import kernels
from tombo_tpu_torch.ops import rescale as t_rs


def _points(seed, B, N, dtype):
    rng = np.random.default_rng(seed)
    ev = rng.normal(0, 1, (B, N)).astype(dtype)
    mod = (ev * 1.1 + 0.2 + rng.normal(0, 0.2, (B, N))).astype(dtype)
    ev[0, 3] = ev[0, 7]          # an equal-event-mean (max_slope) pair
    return ev, mod


def test_count_plain_matches_pallas_interpret():
    rng = np.random.default_rng(2)
    B, M, P = 5, 3000, 8
    keys = rng.integers(-2 ** 31, 2 ** 31 - 1, (B, M)).astype(np.int32)
    keys[:, -100:] = 2 ** 31 - 1                  # sentinel padding
    piv = np.sort(rng.integers(-2 ** 31, 2 ** 31 - 1, (B, P)),
                  axis=1).astype(np.int32)
    piv[:, 0] = keys[:, 17]                       # a pivot equal to a key
    j = np.asarray(j_rs._count_le_pallas(jnp.asarray(keys),
                                         jnp.asarray(piv), interpret=True))
    t = t_rs.count_le(torch.tensor(keys), torch.tensor(piv)).numpy()
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("seed", [21, 22])
def test_f32_median_slope_bitwise_vs_pallas(seed):
    B, N = 5, 64
    ev, mod = _points(seed, B, N, np.float32)
    n_pts = np.array([N, N - 1, 5, 2, N], np.int32)
    j = np.asarray(j_rs.pairwise_slope_median_pallas(
        jnp.asarray(ev), jnp.asarray(mod), jnp.asarray(n_pts), 1000.0,
        interpret=True))
    t = t_rs.pairwise_slope_median_count(
        torch.tensor(ev), torch.tensor(mod), torch.tensor(n_pts).long(),
        1000.0).numpy()
    np.testing.assert_array_equal(t.view(np.int32), j.view(np.int32))
    # the square-matrix dual selection gives the same bits
    t2 = t_rs.pairwise_slope_median(
        torch.tensor(ev), torch.tensor(mod), torch.tensor(n_pts).long(),
        1000.0).numpy()
    np.testing.assert_array_equal(t2.view(np.int32), j.view(np.int32))


def test_f32_theil_sen_device_vs_jax():
    B, N = 4, 96
    ev, mod = _points(9, B, N, np.float32)
    n_pts = np.array([N, 80, 33, 4])
    js, ji = j_rs.theil_sen_device(jnp.asarray(ev), jnp.asarray(mod),
                                   jnp.asarray(n_pts))
    ts, ti = t_rs.theil_sen_device(torch.tensor(ev), torch.tensor(mod),
                                   torch.tensor(n_pts))
    np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))
    np.testing.assert_array_equal(ti.numpy().view(np.int32),
                                  np.asarray(ji).view(np.int32))


def test_f64_theil_sen_device_bitwise():
    rng = np.random.default_rng(5)
    B, N = 4, 120
    ev = rng.normal(0, 1, (B, N))
    mod = 0.8 * ev + 0.1 + rng.normal(0, 0.3, (B, N))
    ev[1, 5] = ev[1, 6]
    n_pts = np.array([N, N, 77, 10])
    js, ji = j_rs.theil_sen_device(jnp.asarray(ev), jnp.asarray(mod),
                                   jnp.asarray(n_pts), max_slope=1000.0)
    ts, ti = t_rs.theil_sen_device(torch.tensor(ev), torch.tensor(mod),
                                   torch.tensor(n_pts), 1000.0)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    for b in range(B):
        s, i = t_rs.theil_sen_host(ev[b, :n_pts[b]], mod[b, :n_pts[b]])
        assert s == ts[b].item() and i == ti[b].item()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_key_roundtrip_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(0, 1e3, 300), [0.0, -0.0, np.inf,
                                                  -np.inf],
                        rng.normal(0, 1e-30, 50)]).astype(dtype)
    t = t_rs.float_to_key(torch.tensor(x))
    j = np.asarray(j_rs._float_to_key(jnp.asarray(x)))
    np.testing.assert_array_equal(t.numpy().astype(j.dtype), j)
    back = t_rs.key_to_float(t, torch.tensor(x).dtype).numpy()
    np.testing.assert_array_equal(back.view(np.uint8), x.view(np.uint8))


def test_cpu_count_launches_no_kernel():
    before = kernels.LAUNCHES["count_le"]
    t_rs.count_le(torch.zeros((2, 8), dtype=torch.int32),
                  torch.zeros((2, 3), dtype=torch.int32))
    assert kernels.LAUNCHES["count_le"] == before
