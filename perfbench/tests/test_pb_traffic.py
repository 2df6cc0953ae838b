"""The generator: deterministic by seed, the same read lengths for every
seed, and each cell's stated lengths and samples a base."""
import os

import numpy as np
import pytest

from perfbench.lib import spec, traffic
from perfbench.reference.resquiggle import KmerModel

S = spec.Spec()
MODELS = os.path.join(S.bench_dir, "reference", "models")


def small(cell, n_batches=2):
    t = S.traffic(cell)
    per = max(4, t["batch"] // 64)
    return dict(t, n_reads=per * n_batches, batch=per,
                ref_len=min(t["ref_len"], 200000))


def model_of(cell):
    return KmerModel(os.path.join(MODELS, S.config(cell)["model_file"]))


@pytest.mark.parametrize("name", sorted(S.cells))
def test_same_seed_same_reads(name):
    cell = S.cell(name)
    t = small(cell)
    a = traffic.make_pool(t, 2 ** 31 + 11, model_of(cell))
    b = traffic.make_pool(t, 2 ** 31 + 11, model_of(cell))
    c = traffic.make_pool(t, 2 ** 31 + 12, model_of(cell))
    assert a.ref == b.ref and a.ref != c.ref
    assert [r.seq for r in a.reads] == [r.seq for r in b.reads]
    assert all(np.array_equal(x.raw, y.raw) for x, y in zip(a.reads, b.reads))
    assert list(a.order) == list(b.order)
    # every seed the same sizes: each batch's reads and raw lengths
    for ba, bc in zip(a.batches, c.batches):
        assert sorted((len(a.reads[i].seq), a.reads[i].raw.shape[0])
                      for i in ba) == \
            sorted((len(c.reads[i].seq), c.reads[i].raw.shape[0])
                   for i in bc)


@pytest.mark.parametrize("name", sorted(S.cells))
def test_lengths_and_samples_a_base(name):
    cell = S.cell(name)
    t = S.traffic(cell)
    lens = traffic.read_lengths(t["lengths"], t["n_reads"])
    assert lens.shape[0] == t["n_reads"] and t["n_reads"] % t["batch"] == 0
    if "fixed" in t["lengths"]:
        assert set(lens.tolist()) == {t["lengths"]["fixed"]}
    else:
        lo, hi = t["lengths"]["clip"]
        assert lens.min() >= lo and lens.max() <= hi
        mean, n50 = t["lengths"]["mean_n50"]
        down = np.sort(lens)[::-1]
        half = np.searchsorted(np.cumsum(down), lens.sum() / 2)
        assert abs(lens.mean() / mean - 1) < 0.02
        assert abs(down[half] / n50 - 1) < 0.02
    tt = small(cell, 1)
    pool = traffic.make_pool(tt, 5, model_of(cell))
    adapters = np.mean(tt["adapter_len"]) * 2
    n_stall = 0
    for r in pool.reads:
        extra = r.raw.shape[0] - adapters - t["mean_dwell"] * len(r.seq)
        if r.stall:
            n_stall += 1
            lo, hi = tt["stall"]["n_obs"]
            assert lo - 800 <= extra <= hi + 800
        else:
            assert abs(extra) < 0.1 * t["mean_dwell"] * len(r.seq)
    assert n_stall == (len(range(0, len(pool.reads), tt["stall"]["every"]))
                       if tt.get("stall") else 0)


def test_batches_take_lengths_evenly():
    t = {"lengths": {"mean_n50": [6433, 10589], "clip": [600, 100000]}}
    lens = traffic.read_lengths(t["lengths"], 64)
    assert np.all(np.diff(lens) >= 0)
    per_batch = traffic.batch_lengths(lens, 4)
    assert sorted(np.concatenate(per_batch)) == sorted(lens)
    means = [x.mean() for x in per_batch]
    assert max(means) / min(means) < 1.3


def test_lognormal_of_mean_and_n50():
    mu, sigma = traffic.lognormal_of(6433, 10589)
    assert np.exp(mu + sigma ** 2 / 2) == pytest.approx(6433)
    assert np.exp(mu + sigma ** 2) == pytest.approx(10589)
    lens = traffic.read_lengths({"mean_n50": [6433, 10589],
                                 "clip": [1, 10 ** 9]}, 20000)
    assert lens.mean() == pytest.approx(6433, rel=0.01)


def test_reservoir_is_seeded_and_uniform_size():
    a = traffic.Reservoir(traffic.seed_rng(3, 2), 5)
    b = traffic.Reservoir(traffic.seed_rng(3, 2), 5)
    for i in range(100):
        a.add(i)
        b.add(i)
    assert a.items == b.items and len(a.items) == 5
    assert len(set(a.items)) == 5
