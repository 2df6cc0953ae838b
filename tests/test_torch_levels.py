"""The group level tests (KS, Mann-Whitney U, t) of the port on the CPU,
held against the JAX package and scipy at float64.

The port's incomplete beta against scipy to 1e-12; the Kolmogorov tail
against scipy's ``kstwobign`` to the JAX bar (1e-9); ``ks_tests``,
``u_tests`` and ``t_tests``, both forms, against the JAX functions and
the JAX host lane's scipy versions at the JAX bars (1e-9, t 1e-8),
ties, one-level sites and empty sites included.  Region blocks of
``compute_group_reg_stats`` / ``compute_group_stats_device_batch``
against the JAX host and device lanes (positions and coverage exact,
statistics to 1e-9), and the ``LevelStats`` files of ``test_significance``
read both ways."""
import dataclasses

import numpy as np
import pytest
import torch
from scipy import special as sps_special
from scipy import stats as sps

import jax.numpy as jnp

from tombo_tpu.io.index import ReadsIndex as JReadsIndex
from tombo_tpu.stats import detect as j_dt
from tombo_tpu.stats import device as j_dev
from tombo_tpu.stats import files as j_files
from tombo_tpu.stats import kernels as j_kernels
from tombo_tpu.stats import region as j_region
from tombo_tpu_torch import types as t_types
from tombo_tpu_torch.io.index import ReadsIndex as TReadsIndex
from tombo_tpu_torch.stats import detect as t_dt
from tombo_tpu_torch.stats import device as t_dev
from tombo_tpu_torch.stats import device_levels as t_dl
from tombo_tpu_torch.stats import files as t_files
from tombo_tpu_torch.stats import kernels as t_kernels
from tombo_tpu_torch.stats import region as t_region
from test_torch_detect import _jax_dataset

F64 = torch.float64
TESTS = {"ks": (t_dev.ks_tests, j_dev.ks_tests, j_kernels.compute_ks_tests),
         "u": (t_dev.u_tests, j_dev.u_tests, j_kernels.compute_u_tests),
         "t": (t_dev.t_tests, j_dev.t_tests, j_kernels.compute_t_tests)}
# the JAX bars (tests/test_stats_device.py:95-122)
RTOL = {"ks": 1e-9, "u": 1e-9, "t": 1e-8}
LEVEL_TYPES = ["ks", "u", "t", "ks_stat", "u_stat", "t_stat"]


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=F64)


# ---------------------------------------------------------------------------
# special functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("df_lo,df_hi", [(2, 60), (60, 600), (600, 5000)])
def test_betainc_matches_scipy(df_lo, df_hi):
    """I_x(df / 2, 1 / 2) at float64, x = df / (df + t^2), t from 0 to
    40, against scipy at the same x to 1e-12 relative (both sides given
    the same rounded x; y = 1 - x is then exact).  Past df 5,000 the
    continued fraction's rounding near its switch point grows (2e-12 at
    df 20,000)."""
    df = np.unique(np.geomspace(df_lo, df_hi, 120).round())
    t = np.concatenate([[0.0], np.geomspace(1e-4, 40.0, 160)])
    D, T = (a.ravel() for a in np.meshgrid(df, t))
    x = D / (D + T * T)
    want = sps_special.betainc(D / 2.0, 0.5, x)
    got = t_dev.betainc(_t(D / 2.0), _t(np.full(D.shape, 0.5)), _t(x),
                        _t(1.0 - x)).numpy()
    ok = want > 1e-300
    assert ok.sum() > 0.9 * ok.size
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-12, atol=0)
    assert np.all(np.abs(got[~ok]) < 1e-290)
    # a and b both large, and b > a: the other branches of log B(a, b)
    a = np.geomspace(0.3, 3e4, 50)
    for b in (0.7, 4.0, 25.0, 900.0):
        xb = np.linspace(0.01, 0.99, 50)
        A, X = (v.ravel() for v in np.meshgrid(a, xb))
        want = sps_special.betainc(A, b, X)
        got = t_dev.betainc(_t(A), _t(np.full(A.shape, b)), _t(X)).numpy()
        # values in the last ~100 decades above underflow are compared
        # absolutely: exp of a log prefactor near -700 keeps fewer digits
        ok = want > 1e-200
        np.testing.assert_allclose(got[ok], want[ok], rtol=1e-11, atol=0)
        np.testing.assert_allclose(got[~ok], want[~ok], rtol=0, atol=1e-200)


def test_betainc_float32_and_t_tail():
    """float32 keeps ~5 digits; the t test's p-value for small t uses the
    exact 1 - x, so it meets scipy's t distribution at float64."""
    df = np.array([4.0, 40.0, 400.0, 4000.0])
    x = df / (df + 2.0 ** 2)
    got = t_dev.betainc(torch.tensor(df / 2, dtype=torch.float32),
                        torch.full((4,), 0.5), torch.tensor(
                            x, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(got, sps_special.betainc(df / 2, 0.5, x),
                               rtol=2e-3)
    t = np.array([1e-6, 1e-3, 0.5, 3.0, 12.0])
    for d in (3.0, 300.0, 3000.0):
        D = np.full(t.shape, d)
        tt = _t(t)
        p = t_dev.betainc(_t(D / 2), _t(np.full(t.shape, 0.5)),
                          _t(D) / (_t(D) + tt * tt),
                          tt * tt / (_t(D) + tt * tt)).numpy()
        np.testing.assert_allclose(p, 2 * sps.t.cdf(-t, d), rtol=1e-12)


def test_kolmogorov_sf_matches_scipy():
    x = np.concatenate([np.linspace(0.05, 0.99, 40),
                        np.linspace(1.0, 3.5, 40)])
    got = t_dev._kolmogorov_sf(_t(x)).numpy()
    np.testing.assert_allclose(got, sps.distributions.kstwobign.sf(x),
                               rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(
        got, np.asarray(j_dev._kolmogorov_sf(jnp.asarray(x))), rtol=1e-13)


# ---------------------------------------------------------------------------
# the level tests on seeded (sites, coverage) pairs
# ---------------------------------------------------------------------------

def _level_pair(rng, P=60, C=24, shift=0.4):
    """tests/test_stats_device.py's pair: ragged NaN-padded coverage, at
    least three reads a site, no cross-sample ties."""
    samp = rng.normal(0, 1, (P, C))
    ctrl = rng.normal(shift, 1, (P, C))
    for x in (samp, ctrl):
        for i in range(P):
            x[i, rng.integers(3, C + 1):] = np.nan
    return samp, ctrl


@pytest.mark.parametrize("return_stat", [False, True], ids=["p", "stat"])
@pytest.mark.parametrize("test", ["ks", "u", "t"])
def test_level_tests_match_jax_and_scipy(test, return_stat):
    rng = np.random.default_rng({"ks": 2, "u": 3, "t": 4}[test])
    samp, ctrl = _level_pair(rng)
    t_fn, j_fn, h_fn = TESTS[test]
    got = t_fn(_t(samp), _t(ctrl), return_stat)
    assert got.dtype == F64
    got = got.numpy()
    want = np.asarray(j_fn(jnp.asarray(samp), jnp.asarray(ctrl),
                           return_stat))
    np.testing.assert_allclose(got, want, rtol=RTOL[test], atol=1e-12)
    np.testing.assert_allclose(got, h_fn(samp, ctrl, return_stat),
                               rtol=RTOL[test], atol=1e-12)


@pytest.mark.parametrize("return_stat", [False, True], ids=["p", "stat"])
@pytest.mark.parametrize("test", ["ks", "u", "t"])
def test_level_tests_edge_sites_match_jax(test, return_stat):
    """Exact ties between sample and control (levels on a grid of
    0.25), a site with one valid level on either side, a site with one
    each, a site with none, a site where one side has none, and constant
    levels: the JAX functions' values, NaN where theirs are NaN; and the
    scipy host lane's at every site with two or more levels a side."""
    rng = np.random.default_rng(11)
    samp = np.round(rng.normal(0, 1, (12, 16)) * 4) / 4
    ctrl = np.round(rng.normal(0.3, 1, (12, 16)) * 4) / 4
    samp[:, 12:] = np.nan
    ctrl[:, 10:] = np.nan
    samp[1, 1:] = np.nan                 # one sample level
    ctrl[2, 1:] = np.nan                 # one control level
    samp[3, 1:] = ctrl[3, 1:] = np.nan   # one each
    samp[4] = ctrl[4] = np.nan           # none
    ctrl[5] = np.nan                     # no control
    samp[6, :12] = ctrl[6, :10] = 0.5    # every level tied
    t_fn, j_fn, h_fn = TESTS[test]
    got = t_fn(_t(samp), _t(ctrl), return_stat).numpy()
    want = np.asarray(j_fn(jnp.asarray(samp), jnp.asarray(ctrl),
                           return_stat))
    np.testing.assert_allclose(got, want, rtol=RTOL[test], atol=1e-12,
                               equal_nan=True)
    rows = [0, 7, 8, 9, 10, 11]
    with np.errstate(all="ignore"):
        host = h_fn(samp[rows], ctrl[rows], return_stat)
    if test != "u":
        # the host U test ranks ties in argsort's order, which is not
        # stable (tests/test_stats_device.py:85-89)
        np.testing.assert_allclose(got[rows], host, rtol=RTOL[test],
                                   atol=1e-12, equal_nan=True)


def test_pad_levels_pair_matches_jax():
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(5, 3)), rng.normal(size=(5, 11))
    for x, y in zip(t_dev.pad_levels_pair(a, b), j_dev.pad_levels_pair(a,
                                                                       b)):
        np.testing.assert_array_equal(x, y)
    assert t_dev.pad_levels_pair(a, b)[0].shape == (5, 16)


def test_window_helpers_match_jax():
    rng = np.random.default_rng(5)
    p = rng.uniform(1e-60, 1, 300)
    p[rng.random(300) < 0.05] = np.nan
    p[:5] = 0.0
    for lag in (1, 2, 5):
        np.testing.assert_allclose(
            t_kernels.calc_window_fishers_method(p, lag),
            j_kernels.calc_window_fishers_method(p, lag), rtol=1e-12,
            atol=1e-300, equal_nan=True)
        np.testing.assert_array_equal(t_kernels.calc_window_means(p, lag),
                                      j_kernels.calc_window_means(p, lag))
    with pytest.raises(t_dt.TomboError):
        t_kernels.calc_window_fishers_method(p[:2], 1)


# ---------------------------------------------------------------------------
# level regions of a JAX runner dataset
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def level_ds(tmp_path_factory):
    """60 reads of 600 bases on a 1,500-base reference (~12 reads a
    strand a site), split into a sample (even reads) and a control (odd
    reads); regions of 1,000."""
    ds = _jax_dataset(str(tmp_path_factory.mktemp("det_level")), 60, 23,
                      600, 1500)
    for pkg, cls in (("j", JReadsIndex), ("t", TReadsIndex)):
        full = cls([ds["fast5_dir"]])
        halves = (cls(), cls())
        for (chrm, strand), reads in full.reads_index.items():
            for i, r in enumerate(sorted(reads, key=lambda r: r.read_id)):
                halves[i % 2].add_read_data(chrm, strand, r)
        ds[pkg + "_samp"], ds[pkg + "_ctrl"] = halves
    return ds


def _level_params(mod, stat_type, min_reads=3):
    return mod.TestParams(stat_type=stat_type, region_size=1000,
                          min_test_reads=min_reads)


def _assert_group_equal(got, want, test):
    assert (got.chrm, got.strand, got.start) == (want.chrm, want.strand,
                                                want.start)
    np.testing.assert_array_equal(got.reg_poss, want.reg_poss)
    np.testing.assert_array_equal(got.reg_cov, want.reg_cov)
    np.testing.assert_array_equal(got.ctrl_cov, want.ctrl_cov)
    np.testing.assert_allclose(got.reg_stats, want.reg_stats,
                               rtol=RTOL[test[0] if test[0] != "k"
                                         else "ks"], atol=1e-12,
                               equal_nan=True)


@pytest.mark.parametrize("stat_type", LEVEL_TYPES)
def test_group_region_stats_match_jax_lanes(level_ds, stat_type,
                                            monkeypatch):
    """Each region's GroupStats: the port's chunk dispatch
    (``compute_group_stats_device_batch``) and its one-region call
    (``compute_group_reg_stats``) against the JAX host lane (scipy) and
    the JAX chunk dispatch, both strands."""
    ds = level_ds
    jp, tp = (_level_params(m, stat_type) for m in (j_dt, t_dt))
    j_host, j_jobs, t_jobs, t_alone = [], [], [], []
    regs = list(ds["j_samp"].iter_cov_regs(1, 1000, ds["j_ctrl"]))
    monkeypatch.setenv("TOMBO_TPU_STATS_DEVICE", "0")
    for chrm, strand, start in regs:
        reg = j_dt.RegionData(chrm, strand, start, start + 1000).add_reads(
            ds["j_samp"])
        ctrl = j_dt.RegionData(chrm, strand, start,
                               start + 1000).add_reads(ds["j_ctrl"])
        j_host.append(j_dt.compute_group_reg_stats(reg, ctrl, jp))
        j_jobs.append((reg,) + j_dt._group_levels_pair(reg, ctrl, 1))
        t_reg = t_dt.RegionData(chrm, strand, start,
                                start + 1000).add_reads(ds["t_samp"])
        t_ctrl = t_dt.RegionData(chrm, strand, start,
                                 start + 1000).add_reads(ds["t_ctrl"])
        t_jobs.append((t_reg,) + t_dt._group_levels_pair(t_reg, t_ctrl, 1))
        t_alone.append(t_dt.compute_group_reg_stats(t_reg, t_ctrl, tp,
                                                    device="cpu",
                                                    dtype=F64))
    j_batch = j_dt.compute_group_stats_device_batch(j_jobs, jp)
    t_batch = t_dt.compute_group_stats_device_batch(t_jobs, tp,
                                                    device="cpu", dtype=F64)
    strands = set()
    n_sites = 0
    for host, jb, tb, ta in zip(j_host, j_batch, t_batch, t_alone):
        assert len(host) == len(jb) == len(tb) == len(ta)
        for (hn, hs), (_, js), (tn, ts), (_, tas) in zip(host, jb, tb, ta):
            assert tn == hn == stat_type
            for want in (hs, js):
                _assert_group_equal(ts, want, stat_type)
            _assert_group_equal(tas, ts, stat_type)
            strands.add(ts.strand)
            n_sites += int(np.isfinite(ts.reg_stats).sum())
    assert strands == {"+", "-"} and n_sites > 1000


def _level_blocks(cls, fn):
    st = cls(fn)
    out = {k[:3]: k[4] for k in st}
    st.close()
    return out


@pytest.mark.parametrize("stat_type", ["ks", "t_stat"])
def test_level_stats_files_read_across_packages(level_ds, tmp_path,
                                                stat_type, monkeypatch):
    """The port's test_significance LevelStats file, read through the JAX
    LevelStats, equals the JAX package's (host lane) file block for
    block, and the JAX file reads the same through the port's; the
    readers' most significant sites agree; a run from the same means
    registered as device-resident gives the same blocks."""
    ds = level_ds
    monkeypatch.setenv("TOMBO_TPU_STATS_DEVICE", "0")
    j_fn, t_fn = str(tmp_path / "j.tombo.stats"), str(tmp_path /
                                                      "t.tombo.stats")
    j_dt.test_significance(ds["j_samp"], _level_params(j_dt, stat_type),
                           j_fn, ctrl_reads_index=ds["j_ctrl"],
                           num_processes=2)
    t_dl.clear()
    t_region.clear_levels_cache()
    t_dt.test_significance(ds["t_samp"], _level_params(t_dt, stat_type),
                           t_fn, ctrl_reads_index=ds["t_ctrl"],
                           num_processes=2, device="cpu", dtype=F64)
    want = _level_blocks(j_files.LevelStats, j_fn)
    assert want
    for got in (_level_blocks(j_files.LevelStats, t_fn),
                _level_blocks(t_files.LevelStats, j_fn)):
        assert set(got) == set(want)
        for key, w in want.items():
            assert got[key].dtype == w.dtype
            for f in w.dtype.names:
                if w[f].dtype.kind == "f":
                    np.testing.assert_allclose(got[key][f], w[f], rtol=1e-9,
                                               atol=1e-12, equal_nan=True)
                else:
                    np.testing.assert_array_equal(got[key][f], w[f])
    ts, js = t_files.LevelStats(t_fn), j_files.LevelStats(t_fn)
    assert ts.stat_type == stat_type
    assert list(ts.iter_most_signif_sites()) == \
        list(js.iter_most_signif_sites())
    assert ts.get_most_signif_regions(11, 4) == \
        js.get_most_signif_regions(11, 4)
    ts.close()
    js.close()
    with pytest.raises(t_dt.TomboError, match="LevelStats"):
        t_files.ModelStats(t_fn)

    # the card's route: the same means device-resident (float64 on the CPU)
    reads = list(ds["t_samp"].iter_reads()) + list(ds["t_ctrl"].iter_reads())
    rows = [torch.tensor(np.array(j_region._load_levels_raw(r)[0],
                                  np.float64)) for r in reads]
    width = max(x.shape[0] for x in rows)
    t_dl.register_batch(
        torch.stack([torch.nn.functional.pad(x, (0, width - x.shape[0]))
                     for x in rows]),
        [(r.read_id, i, r.end - r.start) for i, r in enumerate(reads)])
    dev_out = list(t_dt.iter_region_stats(
        ds["t_samp"], _level_params(t_dt, stat_type), None, None,
        ds["t_ctrl"], device="cpu", dtype=F64))
    t_dl.clear()
    mine = _level_blocks(t_files.LevelStats, t_fn)
    assert len(dev_out) == len(mine)
    for name, gs, payload in dev_out:
        assert name == stat_type and payload is None
        block = mine[(gs.chrm, gs.strand, gs.start)]
        keep = ~np.isnan(gs.reg_stats)
        np.testing.assert_array_equal(gs.reg_poss[keep], block["pos"])
        np.testing.assert_array_equal(gs.reg_stats[keep], block["stat"])


def test_level_run_needs_a_control():
    p = t_dt.TestParams(stat_type="ks", region_size=1000)
    with pytest.raises(t_dt.TomboError, match="control"):
        next(t_dt.iter_region_stats(TReadsIndex(), p, None, None,
                                    device="cpu"))


def test_group_post_skips_short_blocks_and_keeps_windows_inside():
    """A covered block shorter than 2 fm + 1 sites is skipped; the Fisher
    window and the window mean stay inside each block (NaN at its
    edges), as the JAX package's host half does."""
    rng = np.random.default_rng(3)
    P = 40
    samp = rng.normal(0, 1, (P, 6))
    ctrl = rng.normal(0.2, 1, (P, 6))
    samp[10:12, 3:] = np.nan      # a gap below min_test_reads
    samp[13:15, :] = np.nan       # a 1-site block between two gaps
    ctrl[30, :] = np.nan
    for stat_type in ("ks", "u_stat"):
        for fm in (1, 2):
            jp = j_dt.TestParams(stat_type=stat_type, fm_offset=fm,
                                 min_test_reads=4, region_size=P - 2 * fm)
            tp = t_dt.TestParams(**dataclasses.asdict(jp))
            reg_j = j_dt.RegionData("c", "+", fm, fm + P - 2 * fm)
            reg_t = t_dt.RegionData("c", "+", fm, fm + P - 2 * fm)
            fn = TESTS[stat_type[:-5] if stat_type.endswith("_stat")
                       else stat_type][0]
            stats = fn(_t(samp), _t(ctrl), stat_type.endswith("_stat"))
            (_, want), = j_dt._group_post(reg_j, jp, samp, ctrl,
                                          stats.numpy())
            (_, got), = t_dt._group_post(reg_t, tp, samp, ctrl,
                                         stats.numpy())
            np.testing.assert_array_equal(got.reg_poss, want.reg_poss)
            np.testing.assert_allclose(got.reg_stats, want.reg_stats,
                                       rtol=1e-12, equal_nan=True)
            assert 12 not in got.reg_poss and got.reg_poss.size < P
            assert isinstance(got, t_types.GroupStats)
