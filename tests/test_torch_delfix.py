"""The port's batched raw-signal deletion fix (ops/delfix.py) against the
JAX package's numpy oracle (ref_impl.reg_z_scores -> raw_forward_pass ->
raw_traceback) and its device version: exact boundaries at float64 over
200 random windows, the bar of tests/test_delfix_device.py."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tombo_tpu.ops import delfix as j_delfix
from tombo_tpu.ops import ref_impl as j_ref
from tombo_tpu_torch.ops import delfix as t_delfix
from tombo_tpu_torch.ops import ref_impl as t_ref


def _make_window(rng, min_obs):
    NB = int(rng.integers(3, 13))
    T = int(rng.integers(NB * min_obs * 2 + 5, 200))
    mu = rng.normal(0, 1, NB)
    sd = rng.uniform(0.3, 1.5, NB)
    segs = np.sort(rng.choice(np.arange(1, T), NB - 1, replace=False))
    segs = np.concatenate([[0], segs, [T]])
    sig = np.concatenate([
        rng.normal(mu[i], 0.5, segs[i + 1] - segs[i]) for i in range(NB)])
    return sig, mu, sd, T, NB


def _oracle(ref, sig, mu, sd, T, NB, min_obs, mhz):
    pseudo = np.linspace(0, T, NB + 1).astype(np.int64)
    zs = ref.reg_z_scores(sig, mu, sd, pseudo, 0, NB, NB, min_obs,
                          max_half_z_score=mhz)
    return ref.raw_traceback(ref.raw_forward_pass(zs, min_obs), min_obs)


@pytest.mark.parametrize("min_obs", [1, 2])
def test_raw_windows_dp_exact_f64(min_obs):
    rng = np.random.default_rng(3 + min_obs)
    N, T_pad, NB_pad, mhz = 200, 256, 16, 5.0
    cases = [_make_window(rng, min_obs) for _ in range(N)]
    sigp = np.zeros((N, T_pad))
    mup = np.zeros((N, NB_pad))
    sdp = np.ones((N, NB_pad))
    Ts = np.zeros(N, np.int64)
    NBs = np.zeros(N, np.int64)
    for i, (sig, mu, sd, T, NB) in enumerate(cases):
        sigp[i, :T], mup[i, :NB], sdp[i, :NB] = sig, mu, sd
        Ts[i], NBs[i] = T, NB
    b, fail = t_delfix.raw_windows_dp(
        torch.tensor(sigp), torch.tensor(mup), torch.tensor(sdp),
        torch.tensor(Ts), torch.tensor(NBs), mhz, min_obs=min_obs,
        nb_pad=NB_pad, winsorize=True)
    jb, jfail = j_delfix.raw_windows_dp(
        jnp.asarray(sigp), jnp.asarray(mup), jnp.asarray(sdp),
        jnp.asarray(Ts), jnp.asarray(NBs), mhz, min_obs=min_obs,
        nb_pad=NB_pad, winsorize=True)
    b, fail = b.numpy(), fail.numpy()
    np.testing.assert_array_equal(fail, np.asarray(jfail))
    jb = np.asarray(jb)
    for i, (sig, mu, sd, T, NB) in enumerate(cases):
        ref_b = _oracle(j_ref, sig, mu, sd, T, NB, min_obs, mhz)
        assert not fail[i]
        np.testing.assert_array_equal(b[i, :NB - 1], ref_b)
        np.testing.assert_array_equal(b[i, :NB - 1], jb[i, :NB - 1])
        # the port's own numpy copy of the oracle agrees
        np.testing.assert_array_equal(
            _oracle(t_ref, sig, mu, sd, T, NB, min_obs, mhz), ref_b)
