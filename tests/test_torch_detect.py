"""De novo and model-sample-compare detection through the port's packed
lane on the CPU, held against the JAX package on the same inputs.

At float64: the per-read test functions to 1e-12 (p-values) and exactly
(counts); region statistics against the JAX host lane and the JAX packed
lane with positions and coverage exact and fractions to 1e-12, on both
strands, at the default sub-span core (4,096) and at 256; the statistics
file read back through each package's reader.  At float32: the port's
own re-squiggle registers its device means, and detection from them
agrees with detection from the JAX-written FAST5 means within
max(1, n/10,000) differing entries (tests/test_fused_detect.py's bar)."""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from scipy import stats as sps

import jax.numpy as jnp

from tombo_tpu import config as j_config
from tombo_tpu.io import fast5 as j_fast5
from tombo_tpu.io.index import ReadsIndex as JReadsIndex
from tombo_tpu.io.model_io import KmerModel as JKmerModel
from tombo_tpu.pipeline.aligner import ExactAligner as JExactAligner
from tombo_tpu.pipeline.runner import RunConfig, resquiggle_all_reads
from tombo_tpu.stats import detect as j_dt
from tombo_tpu.stats import device as j_dev
from tombo_tpu.stats import files as j_files
from tombo_tpu.stats import levels_cache as j_lc
from tombo_tpu.stats import region as j_region
from tombo_tpu.testing import make_synthetic_dataset
from tombo_tpu.types import AlignInfo as JAlignInfo
from tombo_tpu.types import GenomeLocation as JGenomeLocation
from tombo_tpu.types import ResquiggleResults as JResquiggleResults
from tombo_tpu.types import ScaleValues as JScaleValues
from tombo_tpu.types import SeqSampleType as JSeqSampleType
from tombo_tpu_torch import config as t_config
from tombo_tpu_torch import types as t_types
from tombo_tpu_torch.io.fasta import Fasta as TFasta
from tombo_tpu_torch.io.index import ReadsIndex as TReadsIndex
from tombo_tpu_torch.io.model_io import KmerModel as TKmerModel
from tombo_tpu_torch.pipeline import resquiggle as t_rsq
from tombo_tpu_torch.pipeline.aligner import ExactAligner as TExactAligner
from tombo_tpu_torch.pipeline.batch import BatchedResquiggler as TBatched
from tombo_tpu_torch.stats import detect as t_dt
from tombo_tpu_torch.stats import device as t_dev
from tombo_tpu_torch.stats import device_levels as t_dl
from tombo_tpu_torch.stats import files as t_files
from tombo_tpu_torch.stats import levels_cache as t_lc
from tombo_tpu_torch.stats import region as t_region
from tombo_tpu_torch.types import SeqSampleType as TSeqSampleType
from tombo_tpu_torch.types import SequenceData as TSequenceData

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
F64 = torch.float64


def _t(x, dtype=F64):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _rand_block(rng, B=24, W=160, nan_frac=0.15):
    """tests/test_stats_device.py's block: reads with contiguous extents
    shorter than the span and scattered NaNs."""
    means = rng.normal(0, 1, (B, W))
    valid = rng.random((B, W)) > nan_frac
    for i in range(B):
        valid[i, :rng.integers(0, W // 3)] = False
        valid[i, rng.integers(2 * W // 3, W):] = False
    return np.where(valid, means, np.nan), valid


# ---------------------------------------------------------------------------
# the test functions on seeded blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lag", [1, 2, 4])
def test_window_logp_sum_bitwise_jax(lag):
    rng = np.random.default_rng(lag)
    x = np.log(rng.uniform(1e-8, 1, (12, 90)))
    x[rng.random(x.shape) < 0.1] = np.nan
    np.testing.assert_array_equal(
        t_dev._window_logp_sum(_t(x), lag).numpy(),
        np.asarray(j_dev._window_logp_sum(jnp.asarray(x), lag)))


@pytest.mark.parametrize("fm,clamp", [(1, True), (3, False), (0, False),
                                      (8, True)])
def test_model_test_pvals_match_jax(fm, clamp):
    rng = np.random.default_rng(0)
    means, valid = _rand_block(rng)
    ref_means = rng.normal(0, 1, means.shape[1])
    ref_sds = rng.uniform(0.2, 1.0, means.shape[1])
    p_t = t_dev.model_test_pvals(_t(means), _t(ref_means), _t(ref_sds),
                                 torch.as_tensor(valid), fm, clamp).numpy()
    p_j = np.asarray(j_dev.model_test_pvals(means, ref_means, ref_sds,
                                            valid, fm, clamp))
    assert np.isfinite(p_t).sum() > 100
    np.testing.assert_allclose(p_t, p_j, rtol=1e-12, atol=0,
                               equal_nan=True)


@pytest.mark.parametrize("mode,thresh,lower", [
    ("two_way", 0.5, 0.15), ("alt", 2.5, None), ("plain", 0.4, None)])
def test_site_accumulate_matches_jax(mode, thresh, lower):
    rng = np.random.default_rng(1)
    stats = rng.uniform(-4, 4, (30, 120))
    stats[rng.random(stats.shape) < 0.2] = np.nan
    emit = rng.random(stats.shape) > 0.3
    low = lower if lower is not None else -1e30
    got = t_dev.site_accumulate(_t(stats), torch.as_tensor(emit), thresh,
                                low, mode)
    want = j_dev.site_accumulate(jnp.asarray(stats), jnp.asarray(emit),
                                 thresh, low, mode)
    for a, b in zip(got, want):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_model_test_and_accumulate_matches_jax():
    rng = np.random.default_rng(5)
    means, valid = _rand_block(rng, B=40, W=200)
    ref_means = rng.normal(0, 1, means.shape[1])
    ref_sds = rng.uniform(0.2, 1.0, means.shape[1])
    emit = valid & (rng.random(valid.shape) > 0.2)
    got = t_dev.model_test_and_accumulate(
        _t(means), _t(ref_means), _t(ref_sds), torch.as_tensor(valid),
        torch.as_tensor(emit), 1, True, 0.5, 0.15, "two_way")
    want = j_dev.model_test_and_accumulate(
        means, ref_means, ref_sds, valid, emit, 1, True, 0.5, 0.15,
        "two_way")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_chi2_sf_int_matches_scipy():
    """Q(w, x) in log space against scipy's chi2.sf(2x, 2w) at float64,
    w 3 to 21, x 0 to 2,500.  Results below double's normal range
    (~1e-308) are compared absolutely: both sides round them to
    subnormals."""
    x = np.concatenate([[0.0], np.geomspace(1e-3, 2500.0, 400)])
    for w in range(3, 22, 2):
        got = t_dev._chi2_sf_int(_t(x), w).numpy()
        np.testing.assert_allclose(got, sps.chi2.sf(2 * x, 2 * w),
                                   rtol=1e-12, atol=1e-300)
    inf_nan = t_dev._chi2_sf_int(_t([np.inf, np.nan]), 5).numpy()
    assert inf_nan[0] == 0.0 and np.isnan(inf_nan[1])


def test_chi2_sf_int_float32_wide_window_has_no_nan():
    """fm_offset 8 (a 17-site window), every window at SMALLEST_PVAL: the
    JAX float32 lane's partial sum overflows (inf * 0 = NaN) and drops
    the sites; the port's log-space sum gives 0, clamped to the floor,
    and keeps them."""
    width = 17
    x = np.full(8, -width * np.log(t_config.SMALLEST_PVAL), np.float32)
    got = t_dev._chi2_sf_int(torch.as_tensor(x), width)
    assert got.dtype == torch.float32
    assert not torch.isnan(got).any() and float(got.max()) == 0.0
    assert np.isnan(np.asarray(j_dev._chi2_sf_int(
        jnp.asarray(x, jnp.float32), width))).all()
    # the whole test at float32: p-values that underflow to 0 (z ~ 40)
    means = np.full((3, 60), 40.0, np.float32)
    p = t_dev.model_test_pvals(
        torch.as_tensor(means), torch.zeros(60), torch.ones(60),
        torch.ones((3, 60), dtype=torch.bool), 8, True)
    assert p.dtype == torch.float32
    inner = p[:, 8:-8]
    assert not torch.isnan(inner).any()
    assert bool((inner == torch.clamp_min(torch.zeros(()),
                                          t_config.SMALLEST_PVAL)).all())


# ---------------------------------------------------------------------------
# datasets written by the JAX runner
# ---------------------------------------------------------------------------

def _jax_dataset(tmp, n_reads, seed, read_len, ref_len):
    fasta, reads, fast5_dir = make_synthetic_dataset(
        tmp, n_reads=n_reads, seed=seed, read_len=read_len, ref_len=ref_len)
    model = JKmerModel.load_default(j_config.DNA_SAMP_TYPE)
    summary, _ = resquiggle_all_reads(
        fast5_dir, JExactAligner(fasta), model,
        JSeqSampleType(j_config.DNA_SAMP_TYPE, False),
        j_config.load_resquiggle_parameters(j_config.DNA_SAMP_TYPE),
        RunConfig(overwrite=True, batch_size=8, num_io_threads=2))
    assert summary.n_success == n_reads
    t_fasta = TFasta({c: fasta.get_seq(c) for c in fasta.iter_chrms()})
    return dict(tmp=tmp, fasta=fasta, t_fasta=t_fasta, reads=reads,
                fast5_dir=fast5_dir, model=model,
                t_model=TKmerModel.load_default("DNA"))


@pytest.fixture(scope="module")
def short_ds(tmp_path_factory):
    """tests/test_stats_device.py's recipe: 14 reads of 500 bases on a
    4 kb reference; regions of 1,000."""
    ds = _jax_dataset(str(tmp_path_factory.mktemp("det_short")), 14, 57,
                      500, 4000)
    ds["region_size"] = 1000
    return ds


@pytest.fixture(scope="module")
def long_ds(tmp_path_factory):
    """8 reads of 3,000 bases on a 12 kb reference over both strands;
    regions of 10,000, so a region's span (10,034) is three sub-spans at
    the default core and reads cross sub-span and region boundaries.
    Long enough (>= 1,000 events) for the adaptive lane, which registers
    device means."""
    ds = _jax_dataset(str(tmp_path_factory.mktemp("det_long")), 8, 11,
                      3000, 12000)
    ds["region_size"] = 10000
    assert {r.strand for r in ds["reads"]} == {"+", "-"}
    return ds


def _params(mod, stat_type, region_size):
    cfg = j_config if mod is j_dt else t_config
    th = (cfg.DE_NOVO_THRESH if stat_type == "de_novo"
          else cfg.SAMP_COMP_THRESH)["DNA"]
    return mod.TestParams(stat_type=stat_type, single_read_thresh=th[1],
                          lower_thresh=th[0], region_size=region_size)


def _jax_regions(index, params):
    return [j_dt.RegionData(c, s, st, st + params.region_size)
            for c, s, st in index.iter_cov_regs(1, params.region_size)]


def _assert_stats_equal(got, want):
    np.testing.assert_array_equal(got.reg_poss, want.reg_poss)
    np.testing.assert_array_equal(got.reg_cov, want.reg_cov)
    np.testing.assert_array_equal(got.valid_cov, want.valid_cov)
    np.testing.assert_array_equal(got.ctrl_cov, want.ctrl_cov)
    np.testing.assert_allclose(got.reg_frac_standard_base,
                               want.reg_frac_standard_base, rtol=1e-12,
                               atol=0, equal_nan=True)


@pytest.mark.parametrize("which", ["short", "long"])
@pytest.mark.parametrize("core", [4096, 256])
@pytest.mark.parametrize("stat_type", ["de_novo", "sample_compare"])
def test_region_stats_match_jax_lanes(request, which, core, stat_type,
                                      monkeypatch):
    """The port's packed lane (one pass over every region) against the
    JAX host lane and the JAX packed lane at the same core, region by
    region, at float64."""
    ds = request.getfixturevalue(which + "_ds")
    t_dl.clear()
    t_region.clear_levels_cache()
    j_index = JReadsIndex([ds["fast5_dir"]])
    t_index = TReadsIndex([ds["fast5_dir"]])
    jp = _params(j_dt, stat_type, ds["region_size"])
    tp = _params(t_dt, stat_type, ds["region_size"])
    samp = stat_type == "sample_compare"
    j_host, j_jobs, t_jobs, strands = [], [], [], set()
    for reg in _jax_regions(j_index, jp):
        reg.add_reads(j_index)
        ctrl = (j_dt.RegionData(reg.chrm, reg.strand, reg.start,
                                reg.end).add_reads(j_index) if samp else None)
        try:
            j_host.append(j_dt.compute_reg_stats(
                reg, jp, ctrl, ds["fasta"], ds["model"], None,
                emit_per_read=False))
        except j_dt.TomboTpuError:
            j_host.append(None)
        try:
            j_jobs.append(j_dt._device_region_job(reg, jp, ctrl, ds["fasta"],
                                                  ds["model"]))
        except j_dt.TomboTpuError:
            j_jobs.append(None)
        t_reg = t_dt.RegionData(reg.chrm, reg.strand, reg.start,
                                reg.end).add_reads(t_index)
        t_ctrl = (t_dt.RegionData(reg.chrm, reg.strand, reg.start,
                                  reg.end).add_reads(t_index)
                  if samp else None)
        try:
            t_jobs.append(t_dt._device_region_job(
                t_reg, tp, t_ctrl, ds["t_fasta"], ds["t_model"], CPU))
        except t_dt.TomboError:
            t_jobs.append(None)
    monkeypatch.setenv("TOMBO_TPU_STATS_SUBSPAN", str(core))
    j_packed = j_dt.compute_reg_stats_device_batch(j_jobs, jp)
    t_packed = t_dt.compute_reg_stats_device_batch(t_jobs, tp, core=core,
                                                   device="cpu", dtype=F64)
    # one region alone through compute_reg_stats_device: the same block
    k = next(i for i, r in enumerate(t_packed) if r)
    reg = t_jobs[k]["reg"]
    (_, alone, _), = t_dt.compute_reg_stats_device(
        t_dt.RegionData(reg.chrm, reg.strand, reg.start,
                        reg.end).add_reads(t_index), tp,
        t_dt.RegionData(reg.chrm, reg.strand, reg.start,
                        reg.end).add_reads(t_index) if samp else None,
        ds["t_fasta"], ds["t_model"], core=core, device="cpu", dtype=F64)
    _assert_stats_equal(alone, t_packed[k][0][1])
    n_checked = 0
    for host, jres, tres in zip(j_host, j_packed, t_packed):
        assert bool(tres) == bool(jres)
        if not tres:
            continue
        (_, t_stats, _), = tres
        (_, j_stats, _), = jres
        _assert_stats_equal(t_stats, j_stats)
        if host is not None:
            (_, h_stats, _), = host
            _assert_stats_equal(t_stats, h_stats)
            n_checked += 1
        strands.add(t_stats.strand)
    assert n_checked >= 2 and strands == {"+", "-"}


def test_control_levels_bitwise_jax(short_ds):
    """The control sample's per-site medians, SDs (with the model's
    priors) and coverage equal the JAX package's bit for bit, both
    strands."""
    ds = short_ds
    t_dl.clear()
    j_index = JReadsIndex([ds["fast5_dir"]])
    t_index = TReadsIndex([ds["fast5_dir"]])
    n = 0
    for c, s, st in j_index.iter_cov_regs(1, 1000):
        want = j_dt.get_reads_ref(
            j_dt.RegionData(c, s, st, st + 1000).add_reads(j_index),
            ds["fasta"], 1, 1, ds["model"], (5.0, 40.0))
        got = t_dt.get_reads_ref(
            t_dt.RegionData(c, s, st, st + 1000).add_reads(t_index),
            ds["t_fasta"], 1, 1, ds["t_model"], (5.0, 40.0))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]
        n += int(np.isfinite(got[0]).sum())
    assert n > 5000


def _blocks(stats_file):
    out = {(c, s, st): b for c, s, st, _, b in stats_file}
    stats_file.close()
    return out


@pytest.mark.parametrize("stat_type", ["de_novo", "sample_compare"])
def test_stats_files_read_across_packages(short_ds, tmp_path, stat_type):
    """The port's test_significance file read through the JAX ModelStats
    equals the JAX test_significance file block for block, and the JAX
    file reads the same through the port's ModelStats."""
    ds = short_ds
    t_dl.clear()
    j_index = JReadsIndex([ds["fast5_dir"]])
    t_index = TReadsIndex([ds["fast5_dir"]])
    samp = stat_type == "sample_compare"
    j_fn = str(tmp_path / "jax.tombo.stats")
    t_fn = str(tmp_path / "port.tombo.stats")
    j_dt.test_significance(j_index, _params(j_dt, stat_type, 1000), j_fn,
                           fasta=ds["fasta"], std_ref=ds["model"],
                           ctrl_reads_index=j_index if samp else None,
                           num_processes=2)
    t_dt.test_significance(t_index, _params(t_dt, stat_type, 1000), t_fn,
                           fasta=ds["t_fasta"], std_ref=ds["t_model"],
                           ctrl_reads_index=t_index if samp else None,
                           num_processes=2, device="cpu", dtype=F64)
    j_of_j = _blocks(j_files.ModelStats(j_fn))
    j_of_t = _blocks(j_files.ModelStats(t_fn))
    t_of_j = _blocks(t_files.ModelStats(j_fn))
    assert j_of_j and set(j_of_t) == set(j_of_j) == set(t_of_j)
    for key, want in j_of_j.items():
        for got in (j_of_t[key], t_of_j[key]):
            assert got.dtype == want.dtype
            for name in want.dtype.names:
                if want[name].dtype.kind == "f":
                    np.testing.assert_allclose(got[name], want[name],
                                               rtol=1e-12, equal_nan=True)
                else:
                    np.testing.assert_array_equal(got[name], want[name])
    st = t_files.ModelStats(t_fn)
    assert st.stat_type == stat_type and st.region_size == 1000
    assert json.loads(st.resolved_params)["test_params"]["stat_type"] == \
        stat_type
    st.close()


def test_jax_index_and_sidecar_read_without_the_jax_package(short_ds,
                                                            tmp_path):
    """In a process where importing tombo_tpu raises, the port reads the
    JAX-written index (the same covered regions) and the JAX-written
    levels sidecar (the same means); the JAX package reads a sidecar the
    port wrote."""
    ds = short_ds
    j_index = JReadsIndex([ds["fast5_dir"]])
    # the JAX runner's writeback wrote the sidecar (in writer shards)
    r0 = next(j_index.iter_reads())
    assert j_lc.shard_paths(j_lc.cache_fn(ds["fast5_dir"], r0.corr_group))
    code = textwrap.dedent("""
        import json, os, sys
        sys.modules["tombo_tpu"] = None
        from tombo_tpu_torch.io.index import ReadsIndex
        from tombo_tpu_torch.stats import levels_cache
        idx = ReadsIndex([%r])
        out = {"regs": [list(r) for r in idx.iter_cov_regs(1, 1000)],
               "means": {}}
        for r in idx.iter_reads():
            st = os.stat(r.fn)
            hit = levels_cache.lookup(r.fn, r.corr_group, st.st_mtime_ns,
                                      st.st_size)
            out["means"][r.read_id] = hit[0].tolist()
        print(json.dumps(out))
    """ % ds["fast5_dir"])
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout)
    assert [tuple(r) for r in got["regs"]] == \
        list(j_index.iter_cov_regs(1, 1000))
    assert len(got["means"]) == 14
    for r in j_index.iter_reads():
        means, _, _ = j_region._load_levels_raw(r)
        np.testing.assert_array_equal(got["means"][r.read_id], means)

    # the other way: the port builds a sidecar, the JAX package reads it
    copy = str(tmp_path / "fast5s")
    shutil.copytree(ds["fast5_dir"], copy)
    for fn in os.listdir(copy):
        if ".tombo.levels" in fn:
            os.remove(os.path.join(copy, fn))
    t_index = TReadsIndex([copy])
    t_region.clear_levels_cache()
    with t_lc.building():
        for r in t_index.iter_reads():
            t_region.load_read_levels(r)
    t_region.clear_levels_cache()
    reader = j_lc.LevelsCache(t_lc.cache_fn(copy, r.corr_group))
    assert len(reader) == 14
    for r in t_index.iter_reads():
        st = os.stat(r.fn)
        means, seq, rid = reader.get(r.fn, r.corr_group, st.st_mtime_ns,
                                     st.st_size)
        assert rid == r.read_id
        np.testing.assert_array_equal(means, j_region._load_levels_raw(r)[0])
    reader.close()


def test_fused_lane_matches_fast5_means(long_ds, tmp_path):
    """The port's float32 re-squiggle on the CPU registers its device
    means.  The JAX package's writer puts the same results into copies of
    the reads' FAST5 files; detection from the device means equals
    detection from those FAST5 means within max(1, n/10,000) differing
    entries (the two differ by the float32 rounding of the means)."""
    ds = long_ds
    sst = TSeqSampleType("DNA", False)
    params = t_config.load_resquiggle_parameters("DNA")
    aligner = TExactAligner(ds["t_fasta"])
    maps = []
    for read in ds["reads"]:
        mr = t_rsq.map_read(TSequenceData(read.seq, read.read_id, 12.0),
                            aligner, ds["t_model"], sst)
        maps.append(t_rsq.adjust_map_res(
            mr.replace(raw_signal=read.raw_signal.astype(np.float64)), sst,
            params))
    t_dl.clear()
    out = TBatched(ds["t_model"], params, sst,
                   device="cpu").resquiggle_batch(maps)
    assert all(err is None for _, err in out)
    assert t_dl.stats()["reads"] == len(maps)

    copy = str(tmp_path / "fast5s")
    os.makedirs(copy)
    corr_grp = t_config.DEFAULT_CORRECTED_GROUP
    index = TReadsIndex()
    for res, _ in out:
        rid = res.align_info.read_id
        fn = os.path.join(copy, rid + ".fast5")
        shutil.copy(os.path.join(ds["fast5_dir"], rid + ".fast5"), fn)
        j_fast5.prep_fast5(fn, corr_grp, overwrite=True)
        j_fast5.write_new_fast5_group(fn, corr_grp, JResquiggleResults(
            align_info=JAlignInfo(**dataclasses.asdict(res.align_info)),
            genome_loc=JGenomeLocation(**dataclasses.asdict(
                res.genome_loc)),
            genome_seq=res.genome_seq, raw_signal=res.raw_signal,
            read_start_rel_to_raw=res.read_start_rel_to_raw,
            segs=res.segs, scale_values=JScaleValues(**dataclasses.asdict(
                res.scale_values)),
            sig_match_score=res.sig_match_score), "median", False)
        gl = res.genome_loc
        index.add_read_data(gl.chrom, gl.strand, t_types.ReadData(
            gl.start, gl.start + len(res.segs) - 1, False,
            res.read_start_rel_to_raw, gl.strand, fn,
            corr_grp + "/" + res.align_info.subgroup, False, read_id=rid))
    served = sum(t_dl.lookup(r.read_id, r.end - r.start, CPU) is not None
                 for r in index.iter_reads())
    assert served == len(maps)
    p = _params(t_dt, "de_novo", ds["region_size"])

    def run():
        return [s for _, s, _ in t_dt.iter_region_stats(
            index, p, ds["t_fasta"], ds["t_model"], device="cpu")]
    fused = run()
    t_dl.clear()
    t_region.clear_levels_cache()
    plain = run()
    assert [(s.chrm, s.strand, s.start) for s in fused] == \
        [(s.chrm, s.strand, s.start) for s in plain]
    n_diff = n_tot = 0
    for a, b in zip(fused, plain):
        np.testing.assert_array_equal(a.reg_poss, b.reg_poss)
        np.testing.assert_array_equal(a.reg_cov, b.reg_cov)
        for f in ("valid_cov", "reg_frac_standard_base"):
            x, y = getattr(a, f), getattr(b, f)
            n_diff += int(np.sum(~((x == y) | (np.isnan(x) & np.isnan(y)))))
            n_tot += x.size
    assert n_tot > 10000
    assert n_diff <= max(1, n_tot // 10000), (n_diff, n_tot)


def test_device_levels_cache_cap_mismatch_and_unregister(monkeypatch):
    t_dl.clear()
    a = torch.zeros((4, 8))
    t_dl.register_batch(a, [("r1", 0, 8), ("r2", 1, 6)])
    assert t_dl.lookup("r1", 8, CPU) is not None
    # a span-length mismatch (another re-squiggle's index row) never serves
    assert t_dl.lookup("r1", 7, CPU) is None
    assert t_dl.lookup("r1", 8, torch.device("cuda")) is None
    # the latest registration wins; the served values are the new ones
    t_dl.register_batch(torch.ones((2, 8)), [("r1", 1, 8)])
    src, off = t_dl.lookup("r1", 8, CPU)
    assert float(src[off]) == 1.0
    assert t_dl.lookup("r2", 6, CPU) is not None
    # past the cap the oldest batch goes
    t_dl.clear()
    monkeypatch.setattr(t_dl, "CAP_BYTES", 2 * 4 * 8 * 4)
    t_dl.register_batch(torch.zeros((4, 8)), [("a", 0, 8)])
    t_dl.register_batch(torch.zeros((4, 8)), [("b", 0, 8)])
    assert t_dl.stats()["batches"] == 2
    t_dl.register_batch(torch.zeros((4, 8)), [("c", 0, 8)])
    assert t_dl.lookup("a", 8, CPU) is None
    assert t_dl.lookup("b", 8, CPU) is not None
    assert t_dl.lookup("c", 8, CPU) is not None
    assert t_dl.stats()["bytes"] <= 2 * 4 * 8 * 4
    t_dl.unregister("b", "cpu")
    assert t_dl.lookup("b", 8, CPU) is None
    t_dl.clear()
    assert t_dl.stats() == {"batches": 0, "reads": 0, "bytes": 0}


def test_failed_read_leaves_no_device_means():
    """A read registered by an earlier pass that fails in this batch is
    dropped from the cache; reads that succeed on the device are kept."""
    from tombo_tpu_torch import testing as t_testing
    model = TKmerModel.load_default("DNA")
    fasta = t_testing.random_reference(np.random.default_rng(3), 20000)
    sst = TSeqSampleType("DNA", False)
    params = t_config.load_resquiggle_parameters("DNA")
    rng = np.random.default_rng(4)
    maps = []
    for i in range(3):
        read = t_testing.simulate_read(rng, fasta, model, read_len=900,
                                       read_id="fr_%d" % i)
        mr = t_rsq.map_read(TSequenceData(read.seq, read.read_id, 12.0),
                            TExactAligner(fasta), model, sst)
        raw = read.raw_signal.astype(np.float64)
        if i == 2:
            # too little signal for its bases: the read fails
            raw = raw[:3000]
        maps.append(t_rsq.adjust_map_res(mr.replace(raw_signal=raw), sst,
                                         params))
    t_dl.clear()
    t_dl.register_batch(torch.zeros((1, 900)), [("fr_2", 0, 900)])
    out = TBatched(model, params, sst, device="cpu").resquiggle_batch(maps)
    assert [err for _, err in out] == [
        None, None, "Fewer changepoints found than requested"]
    assert t_dl.lookup("fr_2", 900, CPU) is None
    for i in range(2):
        assert t_dl.lookup("fr_%d" % i, len(out[i][0].genome_seq),
                           CPU) is not None
    t_dl.clear()


@pytest.mark.parametrize("kw,item", [
    (dict(stat_type="bogus"), "unknown statistic type")])
def test_unported_options_raise(kw, item, tmp_path):
    p = t_dt.TestParams(stat_type=kw.pop("stat_type", "de_novo"),
                        single_read_thresh=0.5, lower_thresh=0.15)
    with pytest.raises(t_dt.TomboError, match=item):
        t_dt.test_significance(TReadsIndex(), p, str(tmp_path / "x.stats"),
                               device="cpu", **kw)
