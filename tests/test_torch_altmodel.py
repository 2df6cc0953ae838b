"""The alternative-model test of the port on the CPU, held against the
JAX package on the same inputs at float64.

Motifs: every IUPAC code, both strands, the same patterns and hits.  The
six bundled alternative models: the same arrays.  ``alt_llhr`` (scaled
and standard) to 1e-12; each read's motif-hit windows equal; the
sequence the port takes from the reference for a device-resident read
equal to the FAST5 ``base`` column.  Region statistics of the port's
alternative-model lane against the JAX host lane and the JAX device
lane, both strands: positions and coverage exact, fractions to 1e-12.
The statistics files read across packages and are named as the JAX
package names them."""
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tombo_tpu import config as j_config
from tombo_tpu import seq as j_seq
from tombo_tpu.io.index import ReadsIndex as JReadsIndex
from tombo_tpu.io.model_io import load_alt_refs as j_load_alt_refs
from tombo_tpu.stats import detect as j_dt
from tombo_tpu.stats import device as j_dev
from tombo_tpu.stats import files as j_files
from tombo_tpu.stats import region as j_region
from tombo_tpu_torch import config as t_config
from tombo_tpu_torch import convert
from tombo_tpu_torch import seq as t_seq
from tombo_tpu_torch.io.index import ReadsIndex as TReadsIndex
from tombo_tpu_torch.io.model_io import AltModel as TAltModel
from tombo_tpu_torch.io.model_io import load_alt_refs as t_load_alt_refs
from tombo_tpu_torch.stats import detect as t_dt
from tombo_tpu_torch.stats import device as t_dev
from tombo_tpu_torch.stats import device_levels as t_dl
from tombo_tpu_torch.stats import files as t_files
from tombo_tpu_torch.stats import region as t_region
from test_torch_detect import (_assert_stats_equal, _jax_regions, long_ds,
                               short_ds)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64
DNA_ALTS = ["5mC", "6mA", "dcm", "dam", "CpG"]
BUNDLED = [("DNA", a) for a in DNA_ALTS] + [("RNA", "5mC")]

__all__ = ["long_ds", "short_ds"]


# ---------------------------------------------------------------------------
# motifs and models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("code", sorted(j_seq.IUPAC_CODES))
def test_motif_patterns_match_jax(code):
    """A motif holding each IUPAC code: the same forward and
    reverse-complement patterns and the same hits on both strands of a
    random sequence."""
    raw = "G" + code + "AC"
    jm, tm = j_seq.TomboMotif(raw, 2), t_seq.TomboMotif(raw, 2)
    assert tm.motif_pat.pattern == jm.motif_pat.pattern
    assert tm.rev_comp_pat.pattern == jm.rev_comp_pat.pattern
    assert (tm.raw_motif, tm.motif_len, tm.mod_pos, tm.mod_base,
            tm.is_palindrome) == (jm.raw_motif, jm.motif_len, jm.mod_pos,
                                  jm.mod_base, jm.is_palindrome)
    rng = np.random.default_rng(ord(code))
    seq = "".join(rng.choice(list("ACGT"), 4000))
    for strand_seq in (seq, t_seq.rev_comp(seq)):
        for tp, jp in ((tm.motif_pat, jm.motif_pat),
                       (tm.rev_comp_pat, jm.rev_comp_pat)):
            hits = [m.start() for m in tp.finditer(strand_seq)]
            assert hits == [m.start() for m in jp.finditer(strand_seq)]
            assert hits
    with pytest.raises(t_dt.TomboError, match="Invalid IUPAC"):
        t_seq.TomboMotif("GXC", 1)


@pytest.mark.parametrize("samp,alt", BUNDLED,
                         ids=["%s_%s" % b for b in BUNDLED])
def test_bundled_alt_models_equal_jax(samp, alt):
    """The port's copy of each bundled alternative model holds the JAX
    package's arrays and metadata; the file is a byte copy; the levels
    across a tested base (both orientations) and the constant-SD copy
    agree; ``convert.alt_model`` carries a JAX model across."""
    (j,), (t,) = (j_load_alt_refs([alt], samp).values(),
                  t_load_alt_refs([alt], samp).values())
    fn = j_config.ALTERNATE_MODELS[samp + "_" + alt]
    assert fn == t_config.ALTERNATE_MODELS[samp + "_" + alt]
    assert open(os.path.join(ROOT, "tombo_tpu", "models", fn), "rb").read() \
        == open(os.path.join(ROOT, "tombo_tpu_torch", "models", fn),
                "rb").read()
    np.testing.assert_array_equal(t.means, j.means)
    np.testing.assert_array_equal(t.sds, j.sds)
    assert (t.kmer_width, t.central_pos, t.alt_base, t.name,
            t.motif.raw_motif, t.motif.mod_pos) == (
        j.kmer_width, j.central_pos, j.alt_base, j.name, j.motif.raw_motif,
        j.motif.mod_pos)
    codes = np.random.default_rng(1).integers(0, 4 ** t.kmer_width,
                                              (40, t.kmer_width))
    for rev in (False, True):
        for a, b in zip(t.get_exp_levels_from_kmer_codes(codes, rev),
                        j.get_exp_levels_from_kmer_codes(codes, rev)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t.make_constant_sd().sds,
                                  j.make_constant_sd().sds)
    c = convert.alt_model(j.means, j.sds, j.central_pos, j.alt_base, j.name,
                          j.motif.raw_motif, j.motif.mod_pos)
    np.testing.assert_array_equal(c.means, j.means)
    assert c.motif.motif_pat.pattern == j.motif.motif_pat.pattern


def test_alt_model_h5_loads_like_jax(tmp_path):
    """A model in the reference's HDF5 format (written by the JAX
    package) loads to the same arrays in both packages."""
    (j,) = j_load_alt_refs(["dcm"], "DNA").values()
    fn = str(tmp_path / "dcm.model")
    j.write_model(fn)
    t = TAltModel.load(fn)
    j2 = type(j).load(fn)
    np.testing.assert_array_equal(t.means, j2.means)
    np.testing.assert_array_equal(t.sds, j2.sds)
    assert (t.name, t.motif.raw_motif, t.motif.mod_pos) == (
        j2.name, j2.motif.raw_motif, j2.motif.mod_pos)
    assert t_load_alt_refs([], "DNA", [fn])["dcm"].name == "dcm"
    assert t_load_alt_refs(["none"], "DNA") == {}


@pytest.mark.parametrize("standard", [False, True],
                         ids=["scaled", "standard"])
def test_alt_llhr_matches_jax(standard):
    rng = np.random.default_rng(7)
    H, k = 300, 6
    m = rng.normal(0, 1, (H, k))
    ref = m + rng.normal(0, 0.5, (H, k))
    alt = m + rng.normal(0.3, 0.5, (H, k))
    alt[rng.random((H, k)) < 0.05] = np.nan
    cv = rng.uniform(0.05, 0.5, H)
    args = (t_config.OCLLHR_SCALE, t_config.OCLLHR_HEIGHT,
            t_config.OCLLHR_POWER)
    got = t_dev.alt_llhr(*(torch.as_tensor(a, dtype=F64)
                           for a in (m, ref, alt, cv)), standard, *args)
    want = np.asarray(j_dev.alt_llhr(*(jnp.asarray(a)
                                       for a in (m, ref, alt, cv)),
                                     standard, *args))
    assert got.dtype == F64 and np.isnan(want).sum() > 10
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0,
                               equal_nan=True)


# ---------------------------------------------------------------------------
# reads of the JAX runner's datasets
# ---------------------------------------------------------------------------

def _alt_items(pkg):
    load = j_load_alt_refs if pkg == "jax" else t_load_alt_refs
    return sorted(load(DNA_ALTS, "DNA").items())


def _alt_params(mod, region_size, standard=False):
    lo, hi = (j_config if mod is j_dt else t_config).LLR_THRESH["DNA"]
    return mod.TestParams(stat_type="model_compare", single_read_thresh=hi,
                          lower_thresh=lo, region_size=region_size,
                          use_standard_llhr=standard)


def test_sequence_from_reference_equals_fast5_bases(short_ds):
    """A device-resident read has no file: its sequence is the
    reference's bases over its span, reverse complemented on '-'.  For
    every read of the dataset that equals the FAST5 ``base`` column."""
    ds = short_ds
    t_index = TReadsIndex([ds["fast5_dir"]])
    n = set()
    for (chrm, strand), reads in t_index.reads_index.items():
        for r in reads:
            reg = t_region.RegionData(chrm, strand, r.start, r.end)
            _, seq, _ = j_region._load_levels_raw(r)
            assert reg._fasta_seq(r, ds["t_fasta"]) == seq
            n.add(strand)
    assert n == {"+", "-"}


def test_alt_read_windows_equal_jax(short_ds):
    """Each read's trimmed motif-hit windows for the five DNA models,
    region by region: the same positions, means, levels and variances."""
    ds = short_ds
    j_index = JReadsIndex([ds["fast5_dir"]])
    t_index = TReadsIndex([ds["fast5_dir"]])
    j_items, t_items = _alt_items("jax"), _alt_items("port")
    n_hits = 0
    for reg in _jax_regions(j_index, _alt_params(j_dt, 1000)):
        reg.add_reads(j_index)
        t_reg = t_dt.RegionData(reg.chrm, reg.strand, reg.start,
                                reg.end).add_reads(t_index)
        for jl, tl in zip(reg.load_levels(with_seq=True),
                          t_reg.load_levels(with_seq=True)):
            try:
                jw, jid = j_dt.alt_model_read_windows(jl, ds["model"],
                                                      j_items, reg)
            except j_dt.TomboTpuError:
                with pytest.raises(t_dt.TomboError):
                    t_dt.alt_model_read_windows(tl, ds["t_model"], t_items,
                                                t_reg)
                continue
            tw, tid = t_dt.alt_model_read_windows(tl, ds["t_model"],
                                                  t_items, t_reg)
            assert tid == jid and set(tw) == set(jw)
            for name in jw:
                assert (tw[name] is None) == (jw[name] is None)
                if jw[name] is None:
                    continue
                for a, b in zip(tw[name], jw[name]):
                    np.testing.assert_array_equal(a, b)
                n_hits += jw[name][0].shape[0]
    assert n_hits > 2000


@pytest.mark.parametrize("standard", [False, True],
                         ids=["scaled", "standard"])
@pytest.mark.parametrize("which", ["short", "long"])
def test_alt_region_stats_match_jax_lanes(request, which, standard):
    """The port's alternative-model lane over every region (one dispatch a
    model) against the JAX host lane and the JAX device lane, region by
    region and model by model, at float64."""
    ds = request.getfixturevalue(which + "_ds")
    t_dl.clear()
    t_region.clear_levels_cache()
    j_index = JReadsIndex([ds["fast5_dir"]])
    t_index = TReadsIndex([ds["fast5_dir"]])
    jp = _alt_params(j_dt, ds["region_size"], standard)
    tp = _alt_params(t_dt, ds["region_size"], standard)
    j_items, t_items = _alt_items("jax"), _alt_items("port")
    j_host, j_jobs, t_jobs = [], [], []
    for reg in _jax_regions(j_index, jp):
        reg.add_reads(j_index)
        try:
            j_host.append({n: s for n, s, _ in j_dt.compute_reg_stats(
                reg, jp, None, ds["fasta"], ds["model"], j_items,
                emit_per_read=False)})
        except j_dt.TomboTpuError:
            j_host.append({})
        try:
            j_jobs.append(j_dt._alt_device_region_job(reg, jp, ds["model"],
                                                      j_items))
        except j_dt.TomboTpuError:
            j_jobs.append(None)
        t_reg = t_dt.RegionData(reg.chrm, reg.strand, reg.start,
                                reg.end).add_reads(t_index)
        try:
            t_jobs.append(t_dt._alt_device_region_job(
                t_reg, ds["t_model"], t_items, ds["t_fasta"]))
        except t_dt.TomboError:
            t_jobs.append(None)
    j_dev_out = j_dt.compute_alt_stats_device_batch(j_jobs, jp, j_items)
    t_out = t_dt.compute_alt_stats_device_batch(t_jobs, tp, t_items,
                                                device="cpu", dtype=F64)
    n_checked, strands = 0, set()
    for host, jres, tres in zip(j_host, j_dev_out, t_out):
        assert [n for n, _, _ in tres] == [n for n, _, _ in jres]
        for (name, t_stats, _), (_, j_stats, _) in zip(tres, jres):
            _assert_stats_equal(t_stats, j_stats)
            if name in host:
                _assert_stats_equal(t_stats, host[name])
                n_checked += 1
            strands.add(t_stats.strand)
    assert n_checked >= 4 and strands == {"+", "-"}


def test_alt_from_device_means_equals_files(long_ds):
    """The card's route on the CPU: every read's FAST5 means registered as
    device-resident (float64), sequences then from the reference;
    ``iter_region_stats`` gives the same statistics and per-read blocks
    as the run that reads the files."""
    ds = long_ds
    t_index = TReadsIndex([ds["fast5_dir"]])
    tp = _alt_params(t_dt, ds["region_size"])
    refs = dict(_alt_items("port"))

    def run():
        return list(t_dt.iter_region_stats(
            t_index, tp, ds["t_fasta"], ds["t_model"], device="cpu",
            dtype=F64, alt_refs=refs, emit_per_read=True))
    t_dl.clear()
    t_region.clear_levels_cache()
    from_files = run()
    reads = list(t_index.iter_reads())
    rows = [torch.tensor(np.array(j_region._load_levels_raw(r)[0],
                                  np.float64))
            for r in reads]
    width = max(x.shape[0] for x in rows)
    t_dl.register_batch(
        torch.stack([torch.nn.functional.pad(x, (0, width - x.shape[0]))
                     for x in rows]),
        [(r.read_id, i, r.end - r.start) for i, r in enumerate(reads)])
    from_dev = run()
    t_dl.clear()
    assert len(from_dev) == len(from_files) >= 4
    for (na, a, pa), (nb, b, pb) in zip(from_dev, from_files):
        assert na == nb
        _assert_stats_equal(a, b)
        np.testing.assert_array_equal(pa[1], pb[1])
        assert pa[2] == pb[2]


def test_alt_stats_files_named_and_read_across_packages(short_ds, tmp_path):
    """test_significance with two models writes one file a model, named
    as the JAX package names them (one model: the given name); each file,
    read through the JAX ModelStats, equals the JAX package's file block
    for block, and the JAX files read the same through the port."""
    ds = short_ds
    t_dl.clear()
    j_index = JReadsIndex([ds["fast5_dir"]])
    t_index = TReadsIndex([ds["fast5_dir"]])
    names = ["5mC", "CpG"]
    for which, refs_n in (("two", names), ("one", ["CpG"])):
        j_fn = str(tmp_path / ("jax_%s.tombo.stats" % which))
        t_fn = str(tmp_path / ("port_%s.tombo.stats" % which))
        j_dt.test_significance(
            j_index, _alt_params(j_dt, 1000), j_fn, fasta=ds["fasta"],
            std_ref=ds["model"], alt_refs=j_load_alt_refs(refs_n, "DNA"),
            num_processes=2)
        t_dt.test_significance(
            t_index, _alt_params(t_dt, 1000), t_fn, fasta=ds["t_fasta"],
            std_ref=ds["t_model"], alt_refs=t_load_alt_refs(refs_n, "DNA"),
            num_processes=2, device="cpu", dtype=F64)
        for name in refs_n:
            jf = j_fn if len(refs_n) == 1 else \
                j_dt._alt_stats_fn(j_fn, name)
            tf = t_fn if len(refs_n) == 1 else \
                t_dt._alt_stats_fn(t_fn, name)
            assert tf == t_fn.replace(".tombo.stats", "") + (
                "" if len(refs_n) == 1 else "." + name) + ".tombo.stats"
            want = {k[:3]: k[4] for k in j_files.ModelStats(jf)}
            for got in ({k[:3]: k[4] for k in j_files.ModelStats(tf)},
                        {k[:3]: k[4] for k in t_files.ModelStats(jf)}):
                assert set(got) == set(want) and want
                for key, w in want.items():
                    for f in w.dtype.names:
                        if w[f].dtype.kind == "f":
                            np.testing.assert_allclose(
                                got[key][f], w[f], rtol=1e-12,
                                equal_nan=True)
                        else:
                            np.testing.assert_array_equal(got[key][f], w[f])
            # the readers: most significant sites and region queries;
            # the same resolved parameters (use_standard_llhr among them)
            st, js = t_files.ModelStats(tf), j_files.ModelStats(tf)
            assert st.stat_type == "model_compare"
            jf_params = j_files.ModelStats(jf)
            assert json.loads(st.resolved_params) == \
                json.loads(jf_params.resolved_params)
            assert json.loads(st.resolved_params)["test_params"][
                "use_standard_llhr"] is False
            jf_params.close()
            assert list(st.iter_most_signif_sites()) == \
                list(js.iter_most_signif_sites())
            assert st.get_most_signif_regions(20, 5) == \
                js.get_most_signif_regions(20, 5)
            chrm = ds["t_fasta"].iter_chrms()[0]
            for strand in "+-":
                np.testing.assert_array_equal(
                    st.get_reg_stats(chrm, strand, 500, 2500),
                    js.get_reg_stats(chrm, strand, 500, 2500))
            st.close()
            js.close()
