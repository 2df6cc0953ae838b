"""Per-read statistics of the port on the CPU, held against the JAX
package at float64: the per-read blocks of de novo, sample-compare and
the alternative-model test against the JAX host and device lanes,
keyed by (position, read id) with the statistics to 1e-12; the
``PerReadStats`` files read both ways; ``aggregate_per_read_stats``
equal to the JAX package's block for block, and the file-free
aggregation equal to the region statistics of the same run."""

import jax
import numpy as np
import pytest
import torch

from tombo_tpu import config as j_config
from tombo_tpu.io.index import ReadsIndex as JReadsIndex
from tombo_tpu.io.model_io import load_alt_refs as j_load_alt_refs
from tombo_tpu.stats import aggregate as j_agg
from tombo_tpu.stats import detect as j_dt
from tombo_tpu.stats import files as j_files
from tombo_tpu_torch import config as t_config
from tombo_tpu_torch.io.index import ReadsIndex as TReadsIndex
from tombo_tpu_torch.io.model_io import load_alt_refs as t_load_alt_refs
from tombo_tpu_torch.stats import aggregate as t_agg
from tombo_tpu_torch.stats import detect as t_dt
from tombo_tpu_torch.stats import device as t_dev
from tombo_tpu_torch.stats import device_levels as t_dl
from tombo_tpu_torch.stats import files as t_files
from tombo_tpu_torch.stats import region as t_region
from test_torch_detect import (_assert_stats_equal, _jax_regions, _params,
                               long_ds, short_ds)

F64 = torch.float64
CPU = torch.device("cpu")
STAT_TYPES = ["de_novo", "sample_compare", "model_compare"]
ALTS = ["5mC", "CpG"]

__all__ = ["long_ds", "short_ds"]


def _p(mod, stat_type, region_size):
    if stat_type != "model_compare":
        return _params(mod, stat_type, region_size)
    lo, hi = (j_config if mod is j_dt else t_config).LLR_THRESH["DNA"]
    return mod.TestParams(stat_type=stat_type, single_read_thresh=hi,
                          lower_thresh=lo, region_size=region_size)


def _keyed(block, lookup):
    """(positions, statistics, read ids) of a per-read block in (position,
    read id) order; ``lookup``: read id -> number."""
    inv = {v: k for k, v in lookup.items()}
    ids = np.array([inv[int(i)] for i in block["read_id"]])
    order = np.lexsort((ids, block["pos"]))
    return block["pos"][order], block["stat"][order], ids[order]


def _assert_blocks_equal(got, want, rtol=1e-12):
    """Positions and read ids equal, statistics to ``rtol``; a
    log-likelihood ratio is a difference of sums and may cancel to ~0,
    so it also passes within 1e-14 absolute."""
    gp, gs, gi = got
    wp, ws, wi = want
    np.testing.assert_array_equal(gp, wp)
    np.testing.assert_array_equal(gi, wi)
    atol = 1e-14 if (ws < 0).any() else 1e-300
    np.testing.assert_allclose(gs, ws, rtol=rtol, atol=atol)


def _lanes(ds, stat_type):
    """Per region: the JAX host lane's, the JAX device lane's and the
    port's (name, RegionStats, per-read payload) lists, at float64."""
    t_dl.clear()
    t_region.clear_levels_cache()
    j_index = JReadsIndex([ds["fast5_dir"]])
    t_index = TReadsIndex([ds["fast5_dir"]])
    jp = _p(j_dt, stat_type, ds["region_size"])
    tp = _p(t_dt, stat_type, ds["region_size"])
    alt = stat_type == "model_compare"
    j_items = sorted(j_load_alt_refs(ALTS, "DNA").items()) if alt else None
    t_items = sorted(t_load_alt_refs(ALTS, "DNA").items()) if alt else None
    samp = stat_type == "sample_compare"
    j_host, j_jobs, t_jobs = [], [], []
    for reg in _jax_regions(j_index, jp):
        reg.add_reads(j_index)
        ctrl = (j_dt.RegionData(reg.chrm, reg.strand, reg.start,
                                reg.end).add_reads(j_index) if samp else None)
        try:
            j_host.append(j_dt.compute_reg_stats(
                reg, jp, ctrl, ds["fasta"], ds["model"], j_items,
                emit_per_read=True))
        except j_dt.TomboTpuError:
            j_host.append([])
        t_reg = t_dt.RegionData(reg.chrm, reg.strand, reg.start,
                                reg.end).add_reads(t_index)
        t_ctrl = (t_dt.RegionData(reg.chrm, reg.strand, reg.start,
                                  reg.end).add_reads(t_index)
                  if samp else None)
        try:
            j_jobs.append(
                j_dt._alt_device_region_job(reg, jp, ds["model"], j_items)
                if alt else j_dt._device_region_job(reg, jp, ctrl,
                                                    ds["fasta"], ds["model"]))
        except j_dt.TomboTpuError:
            j_jobs.append(None)
        try:
            t_jobs.append(
                t_dt._alt_device_region_job(t_reg, ds["t_model"], t_items,
                                            ds["t_fasta"])
                if alt else t_dt._device_region_job(
                    t_reg, tp, t_ctrl, ds["t_fasta"], ds["t_model"], CPU))
        except t_dt.TomboError:
            t_jobs.append(None)
    if alt:
        j_dev = j_dt.compute_alt_stats_device_batch(j_jobs, jp, j_items,
                                                    emit_per_read=True)
        t_out = t_dt.compute_alt_stats_device_batch(
            t_jobs, tp, t_items, emit_per_read=True, device="cpu",
            dtype=F64)
    else:
        j_dev = j_dt.compute_reg_stats_device_batch(j_jobs, jp,
                                                    emit_per_read=True)
        t_out = t_dt.compute_reg_stats_device_batch(
            t_jobs, tp, device="cpu", dtype=F64, emit_per_read=True)
    return j_host, j_dev, t_out, tp


@pytest.mark.parametrize("stat_type", STAT_TYPES)
@pytest.mark.parametrize("which", ["short", "long"])
def test_per_read_blocks_match_jax_lanes(request, which, stat_type):
    """Every region's per-read block of the port's device lane against
    the JAX host lane's and the JAX device lane's, and the file-free
    aggregation of the block at the run's thresholds equal to the
    region statistics of the same run."""
    ds = request.getfixturevalue(which + "_ds")
    j_host, j_dev, t_out, tp = _lanes(ds, stat_type)
    n_obs, strands = 0, set()
    for host, jres, tres in zip(j_host, j_dev, t_out):
        assert [n for n, _, _ in tres] == [n for n, _, _ in jres]
        host = {n: pr for n, _, pr in host}
        for (name, t_stats, t_pr), (_, _, j_pr) in zip(tres, jres):
            assert t_pr[0] == name and t_pr[3:] == j_pr[3:]
            got = _keyed(t_pr[1], t_pr[2])
            _assert_blocks_equal(got, _keyed(j_pr[1], j_pr[2]))
            if name in host:
                _assert_blocks_equal(got, _keyed(host[name][1],
                                                 host[name][2]))
            # read ids numbered in first-appearance order
            assert list(t_pr[2].values()) == list(range(len(t_pr[2])))
            assert t_pr[1]["read_id"][0] == 0
            agg = t_agg.aggregate_block(
                t_pr[1], *t_pr[3:], tp.single_read_thresh,
                tp.lower_thresh, stat_type)
            # the region statistics also hold the control's coverage
            _assert_stats_equal(agg, t_stats.__class__(
                **dict(vars(t_stats), ctrl_cov=agg.ctrl_cov)))
            n_obs += got[0].shape[0]
            strands.add(t_stats.strand)
    assert n_obs > 1000 and strands == {"+", "-"}


def test_no_pvals_leave_the_device_without_per_read():
    """Without per-read statistics the packed dispatch returns no
    p-values and the packer fetches none."""
    rng = np.random.default_rng(0)
    B, W = 4, 40
    ivec = torch.zeros((8, B), dtype=torch.int32)
    ivec[1], ivec[2], ivec[4], ivec[6] = 0, W, W, W
    flat = torch.as_tensor(rng.normal(0, 1, B * W))
    ivec[0] = torch.arange(B, dtype=torch.int32) * W
    ref = ("levels", torch.zeros((1, W), dtype=F64),
           torch.ones((1, W), dtype=F64))
    out = t_dev.packed_test_and_accumulate(flat, ivec, [], ref, W, 1, True,
                                           0.5, 0.15, "two_way", F64)
    assert len(out) == 4 and out[3] is None
    out = t_dev.packed_test_and_accumulate(flat, ivec, [], ref, W, 1, True,
                                           0.5, 0.15, "two_way", F64, True)
    assert out[3].shape == (B, W)
    assert int(out[2][0, 1:-1, 0].min()) == B


def _pr_blocks(cls, fn):
    pr = cls(fn)
    out = {(c, s, st): _keyed(b, {v: k for k, v in lk.items()})
           for c, s, st, b, lk in pr.iter_per_read_blocks()}
    meta = (pr.stat_type, pr.region_size, pr.are_pvals)
    pr.close()
    return out, meta


@pytest.mark.parametrize("stat_type", STAT_TYPES)
def test_per_read_files_and_aggregation_match_jax(short_ds, tmp_path,
                                                  stat_type):
    """test_significance with a per-read basename in both packages: the
    per-read files read the same through either package's reader, and
    ``aggregate_per_read_stats`` of each package's file gives the same
    statistics file as the JAX package's aggregation, block by block."""
    ds = short_ds
    t_dl.clear()
    t_region.clear_levels_cache()
    j_index = JReadsIndex([ds["fast5_dir"]])
    t_index = TReadsIndex([ds["fast5_dir"]])
    alt = stat_type == "model_compare"
    samp = stat_type == "sample_compare"
    fns = {}
    for pkg, mod, index, fasta, model, load in (
            ("j", j_dt, j_index, ds["fasta"], ds["model"], j_load_alt_refs),
            ("t", t_dt, t_index, ds["t_fasta"], ds["t_model"],
             t_load_alt_refs)):
        fn = str(tmp_path / (pkg + ".tombo.stats"))
        pr = str(tmp_path / (pkg + ".tombo.per_read_stats"))
        kw = dict(device="cpu", dtype=F64) if pkg == "t" else {}
        mod.test_significance(
            index, _p(mod, stat_type, 1000), fn, fasta=fasta, std_ref=model,
            alt_refs=load(["CpG"], "DNA") if alt else None,
            ctrl_reads_index=index if samp else None, per_read_bn=pr,
            num_processes=2, **kw)
        fns[pkg] = pr
    want, meta = _pr_blocks(j_files.PerReadStats, fns["j"])
    assert want and meta == (stat_type, 1000, not alt)
    for cls, fn in ((j_files.PerReadStats, fns["t"]),
                    (t_files.PerReadStats, fns["j"]),
                    (t_files.PerReadStats, fns["t"])):
        got, m = _pr_blocks(cls, fn)
        assert m == meta and set(got) == set(want)
        for key in want:
            _assert_blocks_equal(got[key], want[key])
    # region queries through both readers
    chrm = ds["t_fasta"].iter_chrms()[0]
    a = t_files.PerReadStats(fns["t"]).get_region_per_read_stats(
        chrm, "+", 300, 900)
    b = j_files.PerReadStats(fns["j"]).get_region_per_read_stats(
        chrm, "+", 300, 900)
    oa, ob = (np.lexsort((x["read_id"].astype(str), x["pos"]))
              for x in (a, b))
    np.testing.assert_array_equal(a["pos"][oa], b["pos"][ob])
    np.testing.assert_array_equal(a["read_id"][oa], b["read_id"][ob])
    np.testing.assert_allclose(a["stat"][oa], b["stat"][ob], rtol=1e-12)

    # aggregation at new thresholds
    thresh = (0.05, 0.3) if not alt else (-1.0, 1.0)
    j_out = str(tmp_path / "j_agg.tombo.stats")
    j_agg.aggregate_per_read_stats(fns["j"], j_out, thresh[1], thresh[0])
    want = {k[:3]: k[4] for k in j_files.ModelStats(j_out)}
    for src in ("j", "t"):
        t_out = str(tmp_path / ("t_agg_%s.tombo.stats" % src))
        t_agg.aggregate_per_read_stats(fns[src], t_out, thresh[1], thresh[0])
        got = {k[:3]: k[4] for k in j_files.ModelStats(t_out)}
        assert set(got) == set(want) and want
        for key, w in want.items():
            for f in w.dtype.names:
                if w[f].dtype.kind == "f":
                    np.testing.assert_allclose(got[key][f], w[f],
                                               rtol=1e-12, equal_nan=True)
                else:
                    np.testing.assert_array_equal(got[key][f], w[f])


def test_per_read_float32_meets_jax_float32_lane(short_ds):
    """The port's float32 per-read p-values against the JAX float32 device
    lane (x64 off for the call): the same (position, read id) keys and at
    most max(1, n/10,000) statistics on the other side of a threshold."""
    ds = short_ds
    t_dl.clear()
    t_region.clear_levels_cache()
    j_index = JReadsIndex([ds["fast5_dir"]])
    t_index = TReadsIndex([ds["fast5_dir"]])
    jp = _p(j_dt, "de_novo", 1000)
    tp = _p(t_dt, "de_novo", 1000)
    j_jobs, t_jobs = [], []
    for reg in _jax_regions(j_index, jp):
        reg.add_reads(j_index)
        j_jobs.append(j_dt._device_region_job(reg, jp, None, ds["fasta"],
                                              ds["model"]))
        t_jobs.append(t_dt._device_region_job(
            t_dt.RegionData(reg.chrm, reg.strand, reg.start,
                            reg.end).add_reads(t_index), tp, None,
            ds["t_fasta"], ds["t_model"], CPU))
    jax.config.update("jax_enable_x64", False)
    try:
        j_out = j_dt.compute_reg_stats_device_batch(j_jobs, jp,
                                                    emit_per_read=True)
    finally:
        jax.config.update("jax_enable_x64", True)
    t_out = t_dt.compute_reg_stats_device_batch(
        t_jobs, tp, device="cpu", dtype=torch.float32, emit_per_read=True)
    n = flips = 0
    for jres, tres in zip(j_out, t_out):
        (_, _, jpr), = jres
        (_, _, tpr), = tres
        gp, gs, gi = _keyed(tpr[1], tpr[2])
        wp, ws, wi = _keyed(jpr[1], jpr[2])
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(gi, wi)
        for th in (tp.lower_thresh, tp.single_read_thresh):
            flips += int(np.sum((gs >= th) != (ws >= th)))
        np.testing.assert_allclose(gs, ws, rtol=1e-3, atol=1e-6)
        n += gs.shape[0]
    assert n > 5000 and flips <= max(1, n // 10000), (flips, n)
