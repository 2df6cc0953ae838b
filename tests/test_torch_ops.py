"""Stage-A building blocks of the PyTorch port against the JAX package at
float64 on the CPU: normalization, changepoint scores, event means and
greedy selection.  The same ops in the same order give bit-equal
results, so every comparison is exact."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tombo_tpu.ops import normalize as j_nrm
from tombo_tpu.ops import precision as j_prec
from tombo_tpu.ops import segment as j_seg
from tombo_tpu.ops import select as j_sel
from tombo_tpu_torch.ops import normalize as t_nrm
from tombo_tpu_torch.ops import precision as t_prec
from tombo_tpu_torch.ops import segment as t_seg
from tombo_tpu_torch.ops import select as t_sel


def _signals(seed, B=5, S=900):
    rng = np.random.default_rng(seed)
    lens = rng.integers(S // 2, S, B)
    lens[0] = S
    raw = np.zeros((B, S))
    for i, n in enumerate(lens):
        lv = np.repeat(rng.normal(0, 1, n // 6 + 1), 6)[:n]
        raw[i, :n] = np.round((lv + rng.normal(0, 0.2, n)) * 60 + 450)
    return raw, lens


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_seq_cumsum_f64_matches_numpy_and_jax():
    x = np.random.default_rng(0).normal(0, 1, (3, 777))
    out = t_prec.seq_cumsum(torch.tensor(x), 1).numpy()
    np.testing.assert_array_equal(out, np.cumsum(x, axis=1))
    np.testing.assert_array_equal(
        out, np.asarray(j_prec.seq_cumsum(jnp.asarray(x), axis=1)))


@pytest.mark.parametrize("thresh", [None, 5.0])
def test_normalize_median_batch_exact(thresh):
    raw, lens = _signals(1)
    t_out = t_nrm.normalize_median_batch(torch.tensor(raw),
                                         torch.tensor(lens), thresh)
    j_out = j_nrm.normalize_median_batch(jnp.asarray(raw), jnp.asarray(lens),
                                         thresh)
    for t, j in zip(t_out, j_out):
        _eq(t, j)


def test_normalize_with_scale_and_base_means_exact():
    raw, lens = _signals(2)
    B = raw.shape[0]
    rng = np.random.default_rng(3)
    shift = rng.normal(450, 5, B)
    scale = rng.uniform(50, 70, B)
    lower = np.where(np.arange(B) % 2 == 0, -4.0, np.nan)
    upper = np.where(np.arange(B) % 2 == 0, 4.0, np.nan)
    args = (raw, lens, shift, scale, lower, upper)
    t_norm = t_nrm.normalize_with_scale_batch(*map(torch.tensor, args))
    j_norm = j_nrm.normalize_with_scale_batch(*map(jnp.asarray, args))
    _eq(t_norm, j_norm)

    n_segs = lens // 7
    segs = np.zeros((B, n_segs.max() + 1), np.int64)
    for i, n in enumerate(n_segs):
        segs[i, :n + 1] = np.sort(rng.choice(lens[i] + 1, n + 1,
                                             replace=False))
    _eq(t_nrm.compute_base_means_batch(t_norm, torch.tensor(segs),
                                       torch.tensor(n_segs)),
        j_nrm.compute_base_means_batch(j_norm, jnp.asarray(segs),
                                       jnp.asarray(n_segs)))


@pytest.mark.parametrize("seed", [4, 5])
def test_cpt_scores_and_greedy_selection_exact(seed):
    raw, lens = _signals(seed)
    norm = j_nrm.normalize_median_batch(jnp.asarray(raw), jnp.asarray(lens),
                                        5.0)[0]
    w, min_obs = 5, 3
    j_scores = j_seg.cpt_scores_diff_batch(norm, jnp.asarray(lens), w)
    t_scores = t_seg.cpt_scores_diff_batch(
        torch.tensor(np.asarray(norm)), torch.tensor(lens), w)
    _eq(t_scores, j_scores)

    num_cpts = lens // 5
    # one read asks for more changepoints than its spacing allows
    num_cpts[-1] = lens[-1] // 2
    max_cpts = 512
    j_cpts, j_status = j_sel.greedy_cpts_device(
        j_scores, jnp.asarray(lens - 2 * w + 1), jnp.asarray(num_cpts),
        min_obs, w, max_cpts)
    t_cpts, t_status = t_sel.greedy_cpts_device(
        t_scores, torch.tensor(lens - 2 * w + 1), torch.tensor(num_cpts),
        min_obs, w, max_cpts)
    _eq(t_cpts, j_cpts)
    _eq(t_status, j_status)
    assert int(t_status[-1]) == 1


def test_greedy_selection_ties_exact():
    """Equal scores rank by the higher index first, as the C++ greedy."""
    rng = np.random.default_rng(6)
    scores = np.round(rng.uniform(0, 4, (4, 300)))
    n = np.array([300, 250, 120, 64])
    num = np.array([60, 50, 30, 30])
    j = j_sel.greedy_cpts_device(jnp.asarray(scores), jnp.asarray(n),
                                 jnp.asarray(num), 3, 5, 256)
    t = t_sel.greedy_cpts_device(torch.tensor(scores), torch.tensor(n),
                                 torch.tensor(num), 3, 5, 256)
    _eq(t[0], j[0])
    _eq(t[1], j[1])
