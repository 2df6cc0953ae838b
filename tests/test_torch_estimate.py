"""Model estimation through the port on the CPU, held against the JAX
package on the same inputs.

Datasets: tests/test_estimate.py's (24 reads of 500 bases on 2 kb, with a
24-read alternative sample whose C-containing 6-mers are raised by 1.0)
and tests/test_estimate_device.py's (50 reads of 1,200 bases on 20 kb),
written by the JAX runner; and 10 simulated reads (4 DNA, 6 direct RNA,
one RNA read with a pore stall) written with their true segments by the
JAX writer, for the re-centring fit and the read sources.

Bars, at float64 unless said:
- per-region {key: [(center, sd), ...]} against the JAX host lane
  (``TOMBO_TPU_EST_DEVICE=0``, set for the JAX call alone): keys, list
  lengths and site order equal, centers exact, sds within 1e-12
  relative; canonical, ``est_mean``, three motifs, given positions and
  ``cs_cov_thresh`` with the same seeded generator;
- at float32 against the JAX device lane (``TOMBO_TPU_EST_DEVICE=1``):
  median centers exact, mean centers and sds within 1e-6 relative; and
  against the JAX host lane max |difference| < 5e-3
  (tests/test_estimate_device.py's bar);
- tabulated model means exact, sds within 1e-12, and both error texts;
- ``parse_base_levels`` equal to the JAX function's lists exactly;
- kernel densities within rtol 1e-10, atol 1e-14 of the JAX function
  (scipy); ``isolate_alt_density`` and ``estimate_alt_model`` from the
  same density files bit for bit; each package reads the other's
  density files;
- re-centring: per-read corrections and the centred model within 1e-12
  of the JAX function, DNA and RNA;
- model files: each package reads the other's HDF5 model, canonical and
  alternative, and the port round-trips ``.npz``."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from tombo_tpu import config as j_config
from tombo_tpu.io import fast5 as j_fast5
from tombo_tpu.io.index import ReadsIndex as JReadsIndex
from tombo_tpu.io.model_io import AltModel as JAltModel
from tombo_tpu.io.model_io import KmerModel as JKmerModel
from tombo_tpu.pipeline.aligner import ExactAligner as JExactAligner
from tombo_tpu.pipeline.runner import RunConfig, resquiggle_all_reads
from tombo_tpu.seq import TomboMotif as JTomboMotif
from tombo_tpu.stats import device_levels as j_dl
from tombo_tpu.stats import estimate as j_est
from tombo_tpu.stats import estimate_device as j_estd
from tombo_tpu.stats import region as j_region
from tombo_tpu.stats.region import ReadLevels as JReadLevels
from tombo_tpu.testing import (make_synthetic_dataset, simulate_read,
                               write_synthetic_fast5)
from tombo_tpu.types import AlignInfo as JAlignInfo
from tombo_tpu.types import GenomeLocation as JGenomeLocation
from tombo_tpu.types import ReadData as JReadData
from tombo_tpu.types import ResquiggleResults as JResquiggleResults
from tombo_tpu.types import ScaleValues as JScaleValues
from tombo_tpu.types import SeqSampleType as JSeqSampleType
from tombo_tpu_torch import config as t_config
from tombo_tpu_torch import convert
from tombo_tpu_torch import types as t_types
from tombo_tpu_torch.errors import TomboError
from tombo_tpu_torch.io.bed import parse_locs_file
from tombo_tpu_torch.io.fasta import Fasta as TFasta
from tombo_tpu_torch.io.index import ReadsIndex as TReadsIndex
from tombo_tpu_torch.io.model_io import AltModel as TAltModel
from tombo_tpu_torch.io.model_io import KmerModel as TKmerModel
from tombo_tpu_torch.seq import TomboMotif as TTomboMotif
from tombo_tpu_torch.seq import all_kmers
from tombo_tpu_torch.stats import device_levels as t_dl
from tombo_tpu_torch.stats import estimate as t_est
from tombo_tpu_torch.stats import estimate_device as t_estd
from tombo_tpu_torch.stats import kde as t_kde
from tombo_tpu_torch.stats import region as t_region
from tombo_tpu_torch.testing import insert_stall

F64, F32 = torch.float64, torch.float32
CPU = dict(device="cpu")


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------

def _resquiggle_dir(fast5_dir, fasta, model):
    summary, _ = resquiggle_all_reads(
        fast5_dir, JExactAligner(fasta), model,
        JSeqSampleType(j_config.DNA_SAMP_TYPE, False),
        j_config.load_resquiggle_parameters(j_config.DNA_SAMP_TYPE),
        RunConfig(overwrite=True, batch_size=8, num_io_threads=2))
    return summary


def _jax_dataset(tmp, n_reads, seed, read_len, ref_len):
    fasta, reads, fast5_dir = make_synthetic_dataset(
        tmp, n_reads=n_reads, seed=seed, read_len=read_len, ref_len=ref_len)
    model = JKmerModel.load_default(j_config.DNA_SAMP_TYPE)
    assert _resquiggle_dir(fast5_dir, fasta, model).n_success >= \
        n_reads - 2
    return dict(tmp=tmp, fasta=fasta, reads=reads, fast5_dir=fast5_dir,
                model=model, t_model=TKmerModel.load_default("DNA"),
                t_fasta=TFasta({c: fasta.get_seq(c)
                                for c in fasta.iter_chrms()}))


@pytest.fixture(scope="module")
def small_ds(tmp_path_factory):
    """tests/test_estimate.py's dataset and its alternative sample."""
    ds = _jax_dataset(str(tmp_path_factory.mktemp("est_small")), 24, 5,
                      500, 2000)
    model6 = ds["model"]
    alt_model = JKmerModel(model6.means.copy(), model6.sds.copy(),
                           model6.central_pos)
    for code, km in enumerate(all_kmers(model6.kmer_width)):
        if "C" in km:
            alt_model.means[code] += 1.0
    alt_dir = os.path.join(ds["tmp"], "alt_fast5s")
    os.makedirs(alt_dir)
    rng = np.random.default_rng(6)
    for i in range(24):
        read = simulate_read(rng, ds["fasta"], alt_model, read_len=500,
                             read_id="alt_%04d" % i)
        write_synthetic_fast5(os.path.join(alt_dir, read.read_id + ".fast5"),
                              read)
    assert _resquiggle_dir(alt_dir, ds["fasta"], model6).n_success >= 10
    ds["alt_dir"] = alt_dir
    # a 3-mer model: the 6-mer model marginalized onto its central trimer
    tri = np.zeros(64)
    n = np.zeros(64)
    codes = {km: c for c, km in enumerate(all_kmers(3))}
    for code, km in enumerate(all_kmers(6)):
        c = codes[km[1:4]]
        tri[c] += model6.means[code]
        n[c] += 1
    ds["std3"] = (tri / n, np.full(64, 0.2), 1)
    return ds


@pytest.fixture(scope="module")
def dev_ds(tmp_path_factory):
    """tests/test_estimate_device.py's dataset (both strands)."""
    ds = _jax_dataset(str(tmp_path_factory.mktemp("est_dev")), 50, 13,
                      1200, 20000)
    assert {r.strand for r in ds["reads"]} == {"+", "-"}
    return ds


@pytest.fixture(scope="module")
def truth_ds(tmp_path_factory):
    """4 DNA and 6 direct-RNA simulated reads written with their true
    segments (RNA: the signal stored 3' to 5', segments on the flipped
    signal; RNA read 0 with a pore stall) by the JAX writer, with both
    packages' in-memory indexes, the port's results and the stored raw
    signals."""
    tmp = str(tmp_path_factory.mktemp("est_truth"))
    from tombo_tpu.testing import random_reference
    fasta = random_reference(np.random.default_rng(21), 8000)
    corr = j_config.DEFAULT_CORRECTED_GROUP
    out = {}
    rng = np.random.default_rng(22)
    for kind, n, model, dwell in (
            ("DNA", 4, JKmerModel.load_default("DNA"), 7.0),
            ("RNA", 6, JKmerModel.load_default("RNA"), 12.0)):
        rna = kind == "RNA"
        j_index, t_index, results, raws = JReadsIndex(), TReadsIndex(), [], {}
        for i in range(n):
            rid = "%s_%02d" % (kind.lower(), i)
            read = simulate_read(rng, fasta, model, read_len=600,
                                 mean_dwell=dwell, rev_sig=rna, read_id=rid)
            segs = read.true_segs - read.read_start_rel_to_raw
            rsrtr = read.read_start_rel_to_raw
            sig = read.raw_signal[::-1] if rna else read.raw_signal
            if rna and i == 0:
                pos = rsrtr + int(segs[300])
                sig = insert_stall(rng, sig, pos, 3000)
                segs = np.where(np.arange(segs.shape[0]) >= 300,
                                segs + 3000, segs)
            raw = sig[::-1].copy() if rna else sig
            read = dataclasses.replace(read, raw_signal=raw)
            fn = os.path.join(tmp, rid + ".fast5")
            write_synthetic_fast5(fn, read)
            j_fast5.prep_fast5(fn, corr, overwrite=True)
            norm = (sig[rsrtr:rsrtr + segs[-1]] - 450.0) / 60.0
            j_fast5.write_new_fast5_group(fn, corr, JResquiggleResults(
                align_info=JAlignInfo(read_id=rid),
                genome_loc=JGenomeLocation(read.start, read.strand,
                                           read.chrm),
                genome_seq=read.seq, raw_signal=norm,
                read_start_rel_to_raw=rsrtr, segs=segs,
                scale_values=JScaleValues(450.0, 60.0),
                sig_match_score=0.5), "median", False, rna=rna)
            sub = corr + "/BaseCalled_template"
            j_index.add_read_data(read.chrm, read.strand, JReadData(
                read.start, read.end, False, rsrtr, read.strand, fn, sub,
                rna, read_id=rid))
            t_index.add_read_data(read.chrm, read.strand, t_types.ReadData(
                read.start, read.end, False, rsrtr, read.strand, fn, sub,
                rna, read_id=rid))
            results.append(convert.resquiggle_results(dict(
                align_info=dict(dataclasses.asdict(JAlignInfo(rid))),
                genome_loc=dict(start=read.start, strand=read.strand,
                                chrom=read.chrm),
                genome_seq=read.seq, raw_signal=norm,
                read_start_rel_to_raw=rsrtr, segs=segs)))
            raws[rid] = raw
        out[kind] = dict(j_index=j_index, t_index=t_index, results=results,
                         raws=raws, j_model=model,
                         t_model=TKmerModel.load_default(kind))
    return out


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _clear():
    t_dl.clear()
    t_region.clear_levels_cache()
    j_dl.clear()
    j_region.clear_levels_cache()


def _jax_levels(monkeypatch, lane, ds, **kw):
    """The JAX ``extract_kmer_levels`` on one lane ("0" host, "1"
    device), one region at a time (deterministic generator use)."""
    _clear()
    monkeypatch.setenv("TOMBO_TPU_EST_DEVICE", lane)
    try:
        return j_est.extract_kmer_levels(
            JReadsIndex([ds["fast5_dir"]]), ds["fasta"], num_processes=1,
            **kw)
    finally:
        monkeypatch.delenv("TOMBO_TPU_EST_DEVICE")


def _port_levels(ds, dtype=F64, **kw):
    _clear()
    return t_est.extract_kmer_levels(TReadsIndex([ds["fast5_dir"]]),
                                     ds["t_fasta"], dtype=dtype, **CPU, **kw)


def _assert_levels(got, want, center_rtol=0.0, sd_rtol=1e-12,
                   center_atol=0.0, sd_atol=0.0):
    """Same regions, keys in the same order, same list lengths; values
    within the bars (exact where the tolerances are 0).  Returns the
    number of (center, sd) pairs."""
    assert len(got) == len(want) > 0
    n = 0
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for key in w:
            assert len(g[key]) == len(w[key]), key
            if not w[key]:
                continue
            a, b = np.array(g[key]), np.array(w[key])
            n += a.shape[0]
            np.testing.assert_allclose(a[:, 0], b[:, 0], rtol=center_rtol,
                                       atol=center_atol)
            np.testing.assert_allclose(a[:, 1], b[:, 1], rtol=sd_rtol,
                                       atol=sd_atol)
    return n


def _valid_poss_bed(ds, path):
    """A BED of every 7th CpG C on both strands of the reference."""
    import re as _re
    chrm = ds["fasta"].iter_chrms()[0]
    seq = ds["fasta"].get_seq(chrm)
    lines = []
    for i, m in enumerate(_re.finditer("CG", seq)):
        if i % 7 == 0:
            lines.append("%s\t%d\t%d\t.\t.\t+" % (chrm, m.start(),
                                                 m.start() + 1))
            lines.append("%s\t%d\t%d\t.\t.\t-" % (chrm, m.start() + 1,
                                                 m.start() + 2))
    with open(path, "w") as fp:
        fp.write("\n".join(lines) + "\n")
    return path


# ---------------------------------------------------------------------------
# per-region levels
# ---------------------------------------------------------------------------

LEVEL_CASES = {
    "canonical": dict(cov_thresh=1, cs_cov_thresh=None, est_mean=False),
    "est_mean": dict(cov_thresh=1, cs_cov_thresh=None, est_mean=True),
    "cs_cov_thresh": dict(cov_thresh=0, cs_cov_thresh=2, est_mean=True),
    "motif CG:1": dict(cov_thresh=1, cs_cov_thresh=None, motif="CG:1"),
    "motif CCWGG:2": dict(cov_thresh=1, cs_cov_thresh=None,
                          motif="CCWGG:2"),
    "motif GATC:2": dict(cov_thresh=2, cs_cov_thresh=None, motif="GATC:2"),
    "valid_poss": dict(cov_thresh=1, cs_cov_thresh=None, motif="CG:1",
                       valid_poss=True),
    "valid_poss, no motif": dict(cov_thresh=1, cs_cov_thresh=None,
                                 valid_poss=True),
}


def _case_kwargs(case, ds, tmp_path, motif_cls):
    kw = dict(LEVEL_CASES[case])
    kw.update(region_size=t_config.DEFAULT_REGION_SIZE, upstrm_bases=2,
              dnstrm_bases=3)
    if "motif" in kw:
        raw, pos = kw["motif"].split(":")
        kw["motif"] = motif_cls(raw, int(pos))
    if kw.get("valid_poss"):
        kw["valid_poss"] = parse_locs_file(_valid_poss_bed(
            ds, str(tmp_path / "sites.bed")))
    if kw["cs_cov_thresh"] is not None:
        kw["rng"] = np.random.default_rng(0)
    return kw


@pytest.mark.parametrize("case", list(LEVEL_CASES))
def test_levels_f64_match_jax_host_lane(dev_ds, case, tmp_path,
                                        monkeypatch):
    want = _jax_levels(monkeypatch, "0", dev_ds,
                       **_case_kwargs(case, dev_ds, tmp_path, JTomboMotif))
    got = _port_levels(dev_ds, **_case_kwargs(case, dev_ds, tmp_path,
                                              TTomboMotif))
    n = _assert_levels(got, want)
    if case == "valid_poss, no motif":
        assert n == 0
    else:
        assert n > (100 if "motif" in case or "valid" in case else 3000)


@pytest.mark.parametrize("case", ["canonical", "cs_cov_thresh"])
def test_levels_f32_match_jax_device_lane(dev_ds, case, tmp_path,
                                          monkeypatch):
    """float32 against the JAX device lane (both float32 from the same
    FAST5 means): medians exact; means and sds within 1e-6; and against
    the JAX host lane within 5e-3."""
    kw = lambda cls: _case_kwargs(case, dev_ds, tmp_path, cls)
    want = _jax_levels(monkeypatch, "1", dev_ds, **kw(JTomboMotif))
    host = _jax_levels(monkeypatch, "0", dev_ds, **kw(JTomboMotif))
    got = _port_levels(dev_ds, dtype=F32, **kw(TTomboMotif))
    est_mean = LEVEL_CASES[case]["est_mean"]
    assert _assert_levels(got, want, center_rtol=1e-6 if est_mean else 0,
                          sd_rtol=1e-6) > 1000
    _assert_levels(got, host, center_rtol=0, sd_rtol=0, center_atol=5e-3,
                   sd_atol=5e-3)


def test_np_order_sum_and_site_stats_bitwise_numpy():
    """numpy's pairwise sum order (blocks of 128, eight accumulators, a
    split at a multiple of 8) at every count to 300 and past 1,000; per
    site median, mean and std equal numpy's with NaN gaps."""
    rng = np.random.default_rng(1)
    ns = list(range(301)) + [513, 1029]
    vals = rng.normal(size=(len(ns), 1100)) * 10 ** rng.uniform(
        -3, 3, size=(len(ns), 1100))
    got = t_estd.np_order_sum(torch.as_tensor(vals), torch.tensor(ns))
    for k, m in enumerate(ns):
        assert got[k].item() == np.add.reduce(vals[k, :m]), m
    rm = rng.normal(size=(40, 50))
    rm[rng.random(rm.shape) < 0.4] = np.nan
    r0, r1 = torch.tensor([0, 10, 25]), torch.tensor([10, 25, 40])
    for est_mean in (False, True):
        c, var, cnt = t_estd.site_stats(torch.as_tensor(rm), r0, r1, 16,
                                        est_mean)
        sd = np.sqrt(var.numpy())
        for s in range(3):
            for w in range(50):
                v = rm[int(r0[s]):int(r1[s]), w]
                v = v[~np.isnan(v)]
                assert cnt[s, w] == v.size
                if v.size:
                    assert c[s, w].item() == (np.mean(v) if est_mean
                                              else np.median(v))
                    assert sd[s, w] == np.std(v)


def _host_levels(reg):
    return reg.load_levels_packed(None)


def test_two_source_chunk(dev_ds):
    """One chunk of two regions whose reads' means lie in two registered
    tensors: the port gathers each source on its own and equals the same
    chunk from host means bit for bit; the JAX single-source lane reads
    the first region's rows from the second tensor."""
    _clear()
    t_index = TReadsIndex([dev_ds["fast5_dir"]])
    regs = [t_region.RegionData(c, s, st, st + 10000).add_reads(t_index)
            for c, s, st in t_index.iter_cov_regs(1, 10000)][:2]
    host = [(reg, _host_levels(reg)) for reg in regs]
    dev, jax_regs = [], []
    for reg, levels in host:
        # each region's reads in a tensor of its own, read-centric rows
        L = max(rl.means.shape[0] for rl in levels)
        mat = np.zeros((len(levels), L))
        for i, rl in enumerate(levels):
            mat[i, :rl.means.shape[0]] = rl.means
        flat = torch.as_tensor(mat.reshape(-1))
        dev.append((reg, [t_region.ReadLevels(rl.r_data, None, rl.read_id,
                                              dev=(flat, i * L))
                          for i, rl in enumerate(levels)]))
        jmat = __import__("jax.numpy", fromlist=["asarray"]).asarray(
            mat.astype(np.float32))
        j_levels = [JReadLevels(JReadData(**dataclasses.asdict(rl.r_data)),
                                None, rl.read_id, dev=(jmat, i))
                    for i, rl in enumerate(levels)]
        jax_regs.append(type("Reg", (), dict(
            chrm=reg.chrm, strand=reg.strand, start=reg.start, end=reg.end,
            load_levels_packed=lambda self, lv=j_levels: lv))())
    keys = t_estd._Keys(6, None)
    args = (dev_ds["t_fasta"], 1, 2, 3, False, 10000, keys,
            torch.device("cpu"), F64)
    want = t_estd._chunk_device(host, *args)
    got = t_estd._chunk_device(dev, *args)
    assert _assert_levels(got, want, sd_rtol=0) > 1000
    jax_out = j_estd._chunk_device(
        jax_regs, dev_ds["fasta"], 1, 2, 3, False, 10000, keys.kmers,
        j_dl)
    n_off = 0
    for g, w in zip(jax_out, want):
        for key in w:
            gk = [] if g is None else g[key]
            n_off += (abs(len(gk) - len(w[key])) +
                      sum(abs(a[0] - b[0]) > 1e-3
                          for a, b in zip(gk, w[key])))
    assert n_off > 100


# ---------------------------------------------------------------------------
# tabulation and the canonical and motif models
# ---------------------------------------------------------------------------

def test_tabulate_and_errors(dev_ds, monkeypatch):
    kw = dict(region_size=10000, cov_thresh=1, upstrm_bases=1,
              dnstrm_bases=1, cs_cov_thresh=None)
    levels = _jax_levels(monkeypatch, "0", dev_ds, **kw)
    got = t_est.tabulate_kmer_levels(levels, 1)
    want = j_est.tabulate_kmer_levels(levels, 1)
    assert [g[0] for g in got] == [w[0] for w in want]
    np.testing.assert_array_equal([g[1] for g in got], [w[1] for w in want])
    np.testing.assert_allclose([g[2] for g in got], [w[2] for w in want],
                               rtol=1e-12)
    motif = ("CG", 1)
    mlev = _jax_levels(monkeypatch, "0", dev_ds, motif=JTomboMotif(*motif),
                       **kw)
    got = t_est.tabulate_mod_kmer_levels(mlev, 1, TTomboMotif(*motif))
    want = j_est.tabulate_mod_kmer_levels(mlev, 1, JTomboMotif(*motif))
    assert got == want
    fewest = min(len(np.concatenate([r[k] for r in levels if r[k]]))
                 for k in levels[0])
    for mod in (j_est, t_est):
        err = (TomboError if mod is t_est else
               __import__("tombo_tpu.errors",
                          fromlist=["TomboTpuError"]).TomboTpuError)
        with pytest.raises(err, match="fewer observations than requested"):
            mod.tabulate_kmer_levels(levels, fewest + 1)
        one = [{k: (v if k != "AAA" else []) for k, v in r.items()}
               for r in levels]
        with pytest.raises(err, match="not covered at any positions"):
            mod.tabulate_kmer_levels(one, 1)


def test_estimate_models_match_jax(small_ds):
    """``estimate_kmer_model`` (3-mers, re-centred, constant sd) and
    ``estimate_motif_alt_model`` against the JAX functions on the host
    lane; both models read back through the other package's files."""
    _clear()
    kw = dict(cov_thresh=1, upstrm_bases=1, dnstrm_bases=1, min_kmer_obs=1,
              kmer_specific_sd=False, cs_cov_thresh=None, region_size=1000)
    os.environ["TOMBO_TPU_EST_DEVICE"] = "0"
    try:
        want = j_est.estimate_kmer_model(
            JReadsIndex([small_ds["fast5_dir"]]), small_ds["fasta"],
            num_processes=1, **kw)
        want_alt = j_est.estimate_motif_alt_model(
            JReadsIndex([small_ds["fast5_dir"]]), small_ds["fasta"], "C:1",
            upstrm_bases=1, dnstrm_bases=1, min_kmer_obs=1, cov_thresh=1,
            cs_cov_thresh=None, region_size=1000, num_processes=1)
    finally:
        del os.environ["TOMBO_TPU_EST_DEVICE"]
    _clear()
    t_index = TReadsIndex([small_ds["fast5_dir"]])
    got = t_est.estimate_kmer_model(t_index, small_ds["t_fasta"], dtype=F64,
                                    **CPU, **kw)
    got_alt = t_est.estimate_motif_alt_model(
        t_index, small_ds["t_fasta"], "C:1", upstrm_bases=1, dnstrm_bases=1,
        min_kmer_obs=1, cov_thresh=1, cs_cov_thresh=None, region_size=1000,
        dtype=F64, **CPU)
    assert got.kmer_width == 3 and got.central_pos == 1
    np.testing.assert_allclose(got.means, want.means, rtol=1e-12)
    np.testing.assert_allclose(got.sds, want.sds, rtol=1e-12)
    np.testing.assert_array_equal(got_alt.means, want_alt.means)
    np.testing.assert_array_equal(got_alt.sds, want_alt.sds)
    assert got_alt.motif.raw_motif == "C" and got_alt.alt_base == "C"


# ---------------------------------------------------------------------------
# model files
# ---------------------------------------------------------------------------

def test_model_files_both_ways(tmp_path):
    rng = np.random.default_rng(3)
    means, sds = rng.normal(size=4 ** 5), rng.uniform(0.1, 1, 4 ** 5)
    t_m = TKmerModel(means, sds, 2)
    t_m.write_model(str(tmp_path / "t.model"))
    j_m = JKmerModel.load(str(tmp_path / "t.model"))
    np.testing.assert_array_equal(j_m.means, means)
    np.testing.assert_array_equal(j_m.sds, sds)
    assert j_m.central_pos == 2
    JKmerModel(means[::-1].copy(), sds, 1).write_model(
        str(tmp_path / "j.model"))
    back = TKmerModel.load(str(tmp_path / "j.model"))
    np.testing.assert_array_equal(back.means, means[::-1])
    assert back.central_pos == 1 and back.name == "standard"
    t_m.save_npz(str(tmp_path / "t.npz"))
    rt = TKmerModel.load(str(tmp_path / "t.npz"))
    np.testing.assert_array_equal(rt.means, means)
    # nanopolish-style text
    with open(tmp_path / "m.txt", "w") as fp:
        fp.write("#kmer\tlevel_mean\tlevel_stdv\n")
        for c, km in enumerate(all_kmers(5)):
            fp.write("%s\t%.17g\t%.17g\n" % (km, means[c], sds[c]))
    tt = TKmerModel.load(str(tmp_path / "m.txt"))
    jt = JKmerModel.load(str(tmp_path / "m.txt"))
    np.testing.assert_array_equal(tt.means, jt.means)
    assert tt.central_pos == jt.central_pos == 2
    np.testing.assert_array_equal(t_m.make_constant_sd().sds,
                                  np.full(4 ** 5, np.median(sds)))
    np.testing.assert_array_equal(t_m.center_model(0.5, 2.0).means,
                                  means * 2.0 + 0.5)

    alt_means = np.full((4 ** 3, 3), np.nan)
    alt_means[rng.random(alt_means.shape) < 0.3] = 1.5
    entries = [(km, p, float(alt_means[c, p]) + c, 0.3)
               for c, km in enumerate(all_kmers(3)) for p in range(3)
               if not np.isnan(alt_means[c, p])]
    t_alt = TAltModel.from_kmer_ref(entries, 1, "C", "CpG",
                                    TTomboMotif("CG", 1))
    j_alt = JAltModel.from_kmer_ref(entries, 1, "C", "CpG",
                                    JTomboMotif("CG", 1))
    np.testing.assert_array_equal(t_alt.means, j_alt.means)
    t_alt.write_model(str(tmp_path / "t_alt.model"))
    j_back = JAltModel.load(str(tmp_path / "t_alt.model"))
    j_alt.write_model(str(tmp_path / "j_alt.model"))
    t_back = TAltModel.load(str(tmp_path / "j_alt.model"))
    for m in (j_back, t_back):
        np.testing.assert_array_equal(m.means, t_alt.means)
        np.testing.assert_array_equal(m.sds, t_alt.sds)
        assert (m.alt_base, m.motif.raw_motif, m.motif.mod_pos,
                m.central_pos) == ("C", "CG", 1, 1)
    t_alt.save_npz(str(tmp_path / "t_alt.npz"))
    rt = TAltModel.load(str(tmp_path / "t_alt.npz"))
    np.testing.assert_array_equal(rt.means, t_alt.means)
    assert rt.name == "CpG"
    # the JAX package's estimated models carried into the port's classes
    c_alt = convert.alt_model(j_alt.means, j_alt.sds, j_alt.central_pos,
                              j_alt.alt_base, j_alt.name,
                              j_alt.motif.raw_motif, j_alt.motif.mod_pos)
    np.testing.assert_array_equal(c_alt.means, j_alt.means)
    c_m = convert.kmer_model(j_m.means, j_m.sds, j_m.central_pos, j_m.name)
    np.testing.assert_array_equal(c_m.means, j_m.means)


def test_motif_helpers_match_jax():
    for raw, pos in (("CG", 1), ("CCWGG", 2), ("GATC", 2), ("C", 1),
                     ("RGATCY", 3)):
        tm, jm = TTomboMotif(raw, pos), JTomboMotif(raw, pos)
        for km in all_kmers(4)[::7] + ["CGCG", "GGATC", "CCAGG", "C", "G"]:
            assert tm.find_mod_poss(km) == jm.find_mod_poss(km), (raw, km)
    from tombo_tpu.seq import all_kmers as j_all_kmers
    assert all_kmers(5) == j_all_kmers(5)


# ---------------------------------------------------------------------------
# the density-based alternative model
# ---------------------------------------------------------------------------

def _std3(ds, mod):
    means, sds, cp = ds["std3"]
    return (JKmerModel if mod == "jax" else TKmerModel)(means, sds, cp)


@pytest.mark.parametrize("thresh,max_obs", [(10, 10000), (3, 5),
                                            (1000, 10000)])
def test_parse_base_levels_exact(small_ds, thresh, max_obs):
    _clear()
    j_reads = list(JReadsIndex([small_ds["alt_dir"]]).iter_reads())
    np.random.default_rng(0).shuffle(j_reads)
    want = j_est.parse_base_levels(j_reads, _std3(small_ds, "jax"), thresh,
                                   max_obs, 1)
    t_index = TReadsIndex([small_ds["alt_dir"]])
    got = t_est.parse_base_levels(t_est._index_reads(t_index, None),
                                  _std3(small_ds, "port"), thresh, max_obs,
                                  1, dtype=F64, **CPU)
    assert list(got) == list(want)
    assert got == want
    assert min(len(v) for v in got.values()) > 0
    if max_obs == 5:
        assert max(len(v) for v in got.values()) == 6
    with pytest.raises(TomboError, match="Too few minimal k-mer"):
        t_est.parse_base_levels(t_est._index_reads(t_index, None),
                                _std3(small_ds, "port"), 10 ** 6, max_obs,
                                10 ** 6, dtype=F64, **CPU)


def test_kde_matches_scipy_and_jax(small_ds, tmp_path):
    """The port's densities against the JAX function (scipy) and scipy
    on odd samples; each package parses the other's density file; the
    isolated alternative model from the same files bit for bit."""
    from scipy import stats as sps
    rng = np.random.default_rng(0)
    save_x = np.linspace(-5, 5, 500)
    samples = [rng.normal(rng.uniform(-2, 2), rng.uniform(0.05, 1), n)
               for n in (2, 3, 17, 1001, 10001)]
    got = t_kde.kde_evaluate(torch.as_tensor(np.concatenate(samples)),
                             [s.shape[0] for s in samples], 0.05, save_x,
                             max_bytes=1 << 20, **CPU).numpy()
    for s, g in zip(samples, got):
        with np.errstate(under="ignore"):
            want = sps.gaussian_kde(s, bw_method=0.05 / s.std(ddof=1)
                                    ).evaluate(save_x)
        np.testing.assert_allclose(g, want, rtol=1e-10, atol=1e-14)

    _clear()
    std_j, std_t = _std3(small_ds, "jax"), _std3(small_ds, "port")
    j_bn, t_bn = str(tmp_path / "j"), str(tmp_path / "t")
    dens = {}
    for name, d in (("alternate", small_ds["alt_dir"]),
                    ("control", small_ds["fast5_dir"])):
        want = j_est.est_kernel_density(JReadsIndex([d]), std_j, 10, j_bn,
                                        save_x, 0.05, name)
        got = t_est.est_kernel_density(TReadsIndex([d]), std_t, 10, t_bn,
                                       save_x, 0.05, name, dtype=F64, **CPU)
        assert list(got) == list(want)
        for km in want:
            np.testing.assert_allclose(got[km], want[km], rtol=1e-10,
                                       atol=1e-14)
        fj = j_bn + "." + name + "_density.txt"
        ft = t_bn + "." + name + "_density.txt"
        pj, pt = (t_est.parse_kmer_densities_file(fj),
                  j_est.parse_kmer_densities_file(ft))
        for km in want:
            np.testing.assert_array_equal(pj[km], np.array(
                [float(str(x)) for x in want[km]]))
            np.testing.assert_array_equal(pt[km], np.array(
                [float(str(x)) for x in got[km]]))
        dens[name] = (fj, ft)
    # the isolated alternative base, from the JAX-written files, and from
    # the port-written ones through both packages
    for files in ((dens["alternate"][0], dens["control"][0]),
                  (dens["alternate"][1], dens["control"][1])):
        want = j_est.estimate_alt_model(None, None, std_j, "C", 5, 10,
                                        alt_dens_fn=files[0],
                                        std_dens_fn=files[1])
        got = t_est.estimate_alt_model(None, None, std_t, "C", 5, 10,
                                       alt_dens_fn=files[0],
                                       std_dens_fn=files[1], **CPU)
        np.testing.assert_array_equal(got.means, want.means)
        np.testing.assert_array_equal(got.sds, want.sds)
        a = t_est.parse_kmer_densities_file(files[0])
        s = t_est.parse_kmer_densities_file(files[1])
        np.testing.assert_array_equal(
            t_est.isolate_alt_density(a, s, "C", 5, std_t, save_x).means,
            j_est.isolate_alt_density(a, s, "C", 5, std_j, save_x).means)
    assert np.nanmean(got.means) > np.nanmean(std_t.means) - 5


def test_estimate_alt_model_from_reads(small_ds):
    """``estimate_alt_model`` from the two samples' reads, port against
    JAX: the same model within the densities' bar's effect (the
    isolation's integer density shifts are exact where the densities
    agree to 1e-10)."""
    _clear()
    want = j_est.estimate_alt_model(
        JReadsIndex([small_ds["alt_dir"]]),
        JReadsIndex([small_ds["fast5_dir"]]), _std3(small_ds, "jax"), "C",
        5, 10)
    got = t_est.estimate_alt_model(
        TReadsIndex([small_ds["alt_dir"]]),
        TReadsIndex([small_ds["fast5_dir"]]), _std3(small_ds, "port"), "C",
        5, 10, dtype=F64, **CPU)
    np.testing.assert_allclose(got.means, want.means, rtol=1e-9)
    np.testing.assert_array_equal(np.isnan(got.means), np.isnan(want.means))


# ---------------------------------------------------------------------------
# the re-centring fit
# ---------------------------------------------------------------------------

def _jax_corrections(monkeypatch, index, model, **kw):
    got = []
    orig = j_est.rsq.calc_kmer_fitted_shift_scale

    def capture(*a, **k):
        out = orig(*a, **k)
        got.append((out[2], out[3]))
        return out
    monkeypatch.setattr(j_est.rsq, "calc_kmer_fitted_shift_scale", capture)
    centred = j_est.center_model_to_median_norm(index, model, **kw)
    monkeypatch.setattr(j_est.rsq, "calc_kmer_fitted_shift_scale", orig)
    return got, centred


def _assert_recentring(monkeypatch, j_index, t_index, j_model, t_model,
                       batch_size, max_reads, **kw):
    want, want_m = _jax_corrections(monkeypatch, j_index, j_model,
                                    max_reads=max_reads)
    sh, sc = t_est.read_corrections(t_index, t_model, max_reads,
                                    batch_size=batch_size, dtype=F64, **CPU,
                                    **kw)
    assert len(sh) == len(want) > 0
    np.testing.assert_allclose(sh, [w[0] for w in want], rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(sc, [w[1] for w in want], rtol=1e-12)
    got_m = t_est.center_model_to_median_norm(
        t_index, t_model, max_reads, batch_size=batch_size, dtype=F64,
        **CPU, **kw)
    np.testing.assert_allclose(got_m.means, want_m.means, rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("batch_size,max_reads", [(8, 5000), (5, 7)])
def test_recentring_dna_matches_jax(small_ds, monkeypatch, batch_size,
                                    max_reads):
    """DNA reads of the JAX runner, the 6-mer model; batches of 8, and
    batches of 5 that stop at the seventh read fitted."""
    _assert_recentring(monkeypatch, JReadsIndex([small_ds["fast5_dir"]]),
                       TReadsIndex([small_ds["fast5_dir"]]),
                       small_ds["model"], small_ds["t_model"], batch_size,
                       max_reads)


def test_recentring_rna_matches_jax(truth_ds, monkeypatch):
    """Direct-RNA reads (event-based scale, t-test changepoints, stall
    removal), one with a stall; and the DNA truth reads through the
    in-memory source."""
    ds = truth_ds["RNA"]
    _assert_recentring(monkeypatch, ds["j_index"], ds["t_index"],
                       ds["j_model"], ds["t_model"], 4, 5000)
    ds = truth_ds["DNA"]
    _assert_recentring(monkeypatch, ds["j_index"], ds["t_index"],
                       ds["j_model"], ds["t_model"], 3, 5000,
                       read_source=t_est.MemoryReadSource(ds["results"],
                                                          ds["raws"]))


def test_memory_source_equals_fast5_loader(truth_ds):
    for kind in ("DNA", "RNA"):
        ds = truth_ds[kind]
        mem = t_est.MemoryReadSource(ds["results"], ds["raws"])
        for r in ds["t_index"].iter_reads():
            a, b = mem(r), t_est.load_fast5_read(r)
            np.testing.assert_array_equal(a.raw, b.raw)
            np.testing.assert_array_equal(a.event_starts, b.event_starts)
            assert (a.seq, a.rna, a.rsrtr) == (b.seq, b.rna, b.rsrtr)
            assert a.rna == (kind == "RNA")
        with pytest.raises(KeyError):
            mem(dataclasses.replace(next(ds["t_index"].iter_reads()),
                                    read_id="missing"))


def test_entry_points_need_a_card_unless_cpu(small_ds):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    t_index = TReadsIndex([small_ds["fast5_dir"]])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_est.extract_kmer_levels(t_index, small_ds["t_fasta"], 1000, 1, 1,
                                  1, None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_est.read_corrections(t_index, small_ds["t_model"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_kde.kde_evaluate(torch.zeros(2), [2], 0.05, np.zeros(3))
