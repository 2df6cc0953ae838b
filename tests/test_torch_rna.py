"""Direct-RNA re-squiggle through the port on the CPU against the JAX
package, fed the same seeded numpy inputs: the RNA model, the t-test
changepoint scores, stall detection and removal, adapter trimming, the
RNA signal adjustments and mapping, and the whole slice on the recipe of
tests/test_batch_parity.py::test_batch_rna (1,700-base reads, mean dwell
12, reversed signal, adapters of 600-900 samples) with two reads that
carry a pore stall and one that stall removal sends to the static band.
Also the constant-scale and skip-sequence-scaling options on DNA and RNA
reads, the RNA batch on the mesh lane, and a read's score against the
size of its batch.

Bars: float64 is the exact-parity mode, where segment tables, starts,
scale values, flags and errors equal the JAX package's float64 lane bit
for bit and scores agree to 1e-12 (the bar of
test_torch_batch.py::_assert_f64_exact: the port does not reproduce the
order of XLA's CPU row sum).  float32 is held to tests/test_batch_parity.py's
bars against the JAX float64 lane and against the port's own float64
lane.  The JAX float32 lane sums squared raw values in float32, so its
changepoints stray further and it is not a reference here (ROADMAP.md,
Queue 3)."""
import dataclasses
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tombo_tpu import config as j_config
from tombo_tpu import testing as j_testing
from tombo_tpu.io.model_io import KmerModel as JKmerModel
from tombo_tpu.ops import segment as j_seg
from tombo_tpu.parallel import mesh as j_mesh
from tombo_tpu.pipeline import resquiggle as j_rsq
from tombo_tpu.pipeline.aligner import ExactAligner as JExactAligner
from tombo_tpu.pipeline.batch import BatchedResquiggler as JBatched
from tombo_tpu.types import SeqSampleType as JSeqSampleType
from tombo_tpu.types import SequenceData as JSequenceData
from tombo_tpu_torch import config as t_config
from tombo_tpu_torch import convert, kernels, testing
from tombo_tpu_torch.io.model_io import KmerModel as TKmerModel
from tombo_tpu_torch.ops import precision, rescale
from tombo_tpu_torch.ops import segment as t_seg
from tombo_tpu_torch.parallel import mesh as t_mesh
from tombo_tpu_torch.pipeline import batch as t_batch
from tombo_tpu_torch.pipeline import resquiggle as t_rsq
from tombo_tpu_torch.pipeline.aligner import ExactAligner as TExactAligner
from tombo_tpu_torch.types import SequenceData as TSequenceData

from test_torch_batch import (_assert_f32_close, _assert_f64_exact,
                              _convert, _prep_reads as _prep_dna)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNA = j_config.RNA_SAMP_TYPE
# (bases, stall samples): the recipe's three reads, two with a stall, and
# a shorter read whose stall costs it the events start discovery needs
RECIPE = [(1700, 0), (1700, 0), (1700, 0), (1700, 3000), (1700, 2500),
          (1140, 3000)]
REROUTED = "r_005"


def _rna_reads(spec=RECIPE, seed=7):
    """Simulated, mapped, adjusted RNA reads, JAX side; a stall goes in at
    the middle base boundary of the reversed signal."""
    rng = np.random.default_rng(seed)
    model = JKmerModel.load_default(RNA)
    fasta = j_testing.random_reference(np.random.default_rng(seed + 1),
                                       30000)
    aligner = JExactAligner(fasta)
    sst = JSeqSampleType(RNA, True)
    params = j_config.load_resquiggle_parameters(RNA)
    maps, raws = [], []
    for i, (n, stall) in enumerate(spec):
        read = j_testing.simulate_read(
            rng, fasta, model, read_id="r_%03d" % i, read_len=n,
            mean_dwell=12.0, rev_sig=True, adapter_len=(600, 900))
        raw = read.raw_signal
        if stall:
            pos = raw.shape[0] - int(read.true_segs[n // 2])
            raw = testing.insert_stall(rng, raw, pos, stall)
        mr = j_rsq.map_read(JSequenceData(read.seq, read.read_id, 12.0),
                            aligner, model, sst)
        mr = mr.replace(raw_signal=raw)
        raws.append(mr)
        maps.append(j_rsq.adjust_map_res(mr, sst, params))
    return model, params, sst, maps, raws


def _t_model(model):
    return convert.kmer_model(model.means, model.sds, model.central_pos,
                              model.name, RNA)


def _port(t_model, t_params, dtype, mesh=None, **kw):
    return t_batch.BatchedResquiggler(
        t_model, t_params, convert.seq_samp_type(RNA, True),
        j_config.OUTLIER_THRESH, dtype=dtype, device="cpu", mesh=mesh, **kw)


@pytest.fixture(scope="module")
def rna_inputs():
    model, params, sst, maps, raws = _rna_reads()
    t_params, t_maps = _convert(params, maps)
    assert t_params == t_config.load_resquiggle_parameters(RNA)
    return (model, params, sst, maps, raws), (_t_model(model), t_params,
                                              t_maps)


@pytest.fixture(scope="module")
def rna_outputs(rna_inputs):
    """The JAX float64 lane, the port's float64 lane (with what stage A
    did to each read) and the port's float32 lane."""
    (model, params, sst, maps, _), (t_model, t_params, t_maps) = rna_inputs
    j64 = JBatched(model, params, sst, j_config.OUTLIER_THRESH,
                   dtype=jnp.float64).resquiggle_batch(maps)
    seen = {}
    seg_rna = t_batch.BatchedResquiggler._segment_rna

    def seg_rec(self, live, *a, **kw):
        out = seg_rna(self, live, *a, **kw)
        for s in live:
            seen.setdefault(s.map_res.align_info.read_id, (
                s.num_events, s.n_ev, s.use_static))
        return out

    launches = dict(kernels.LAUNCHES)
    t_batch.BatchedResquiggler._segment_rna = seg_rec
    try:
        t64 = _port(t_model, t_params, "float64").resquiggle_batch(t_maps)
    finally:
        t_batch.BatchedResquiggler._segment_rna = seg_rna
    t32 = _port(t_model, t_params, "float32").resquiggle_batch(t_maps)
    # the CPU runs every kernel's plain version
    assert kernels.LAUNCHES == launches
    return j64, t64, t32, seen


# ------------------------------------------------------------- pieces
def test_rna_model_is_the_jax_package_copy():
    a = open(os.path.join(ROOT, "tombo_tpu", "models",
                          "tombo.RNA.180mV.model.npz"), "rb").read()
    b = open(os.path.join(ROOT, "tombo_tpu_torch", "models",
                          "tombo.RNA.180mV.model.npz"), "rb").read()
    assert a == b
    jm, tm = JKmerModel.load_default(RNA), TKmerModel.load_default(RNA)
    np.testing.assert_array_equal(jm.means, tm.means)
    np.testing.assert_array_equal(jm.sds, tm.sds)
    assert (tm.kmer_width, tm.central_pos) == (jm.kmer_width,
                                               jm.central_pos) == (5, 1)
    assert tm.seq_samp_type == RNA


def _score_case(seed=3):
    rng = np.random.default_rng(seed)
    lens = np.array([40, 977, 2500, 1600, 25])
    sig = np.zeros((lens.shape[0], 2560))
    for i, n in enumerate(lens):
        sig[i, :n] = np.round(450 + 60 * rng.normal(0, 1, n))
    return sig, lens


def test_t_test_scores_match_host_and_jax_f64():
    """Reads of several lengths padded into one batch, two shorter than
    two windows: each read's float64 scores are bitwise the host
    reference's (numpy), the float32 lane's are the float64 ones rounded
    once, and the JAX float64 lane's agree to 1e-13.  Not bitwise: XLA on
    the CPU contracts the scorer's multiply-subtracts into fused
    multiply-adds and divides by a reciprocal square root, and the
    cancellation in ss1 + ss2 lets those last bits grow (up to ~3,000 ulps
    of a score, 4e-15 absolute, on these reads)."""
    sig, lens = _score_case()
    w = t_config.SEG_PARAMS_TABLE[RNA].running_stat_width
    t64 = t_seg.cpt_scores_t_test_batch(torch.tensor(sig),
                                        torch.tensor(lens), w).numpy()
    for i, n in enumerate(lens):
        host = t_rsq.ref_impl.cpt_scores_t_test(sig[i, :n], w)
        np.testing.assert_array_equal(t64[i, :host.shape[0]], host)
        assert np.all(t64[i, max(n - 2 * w, 0):] == -1.0)
    j = np.asarray(j_seg.cpt_scores_t_test_batch(jnp.asarray(sig),
                                                 jnp.asarray(lens), w))
    np.testing.assert_array_equal(t64 == -1.0, j == -1.0)
    np.testing.assert_allclose(t64, j, rtol=0, atol=1e-13)
    t32 = t_seg.cpt_scores_t_test_batch(
        torch.tensor(sig, dtype=torch.float32), torch.tensor(lens),
        w).numpy()
    np.testing.assert_array_equal(t32, t64.astype(np.float32))


def test_valid_cpts_t_test_matches_jax(rna_inputs):
    (_, params, _, maps, _), _ = rna_inputs
    for mr in maps[:2]:
        raw = np.asarray(mr.raw_signal, np.float64)
        n = raw.shape[0] // params.mean_obs_per_event
        np.testing.assert_array_equal(
            t_rsq.valid_cpts_w_cap_t_test(raw, params.min_obs_per_base,
                                          params.running_stat_width, n),
            j_rsq.valid_cpts_w_cap_t_test(raw, params.min_obs_per_base,
                                          params.running_stat_width, n))


@pytest.mark.parametrize("method", ["mean", "pctl"])
def test_identify_stalls_matches_jax(rna_inputs, method):
    """Both stall methods on the flipped signals, the stall reads
    included: the same intervals (and metric) as the JAX package's."""
    (_, _, _, maps, _), _ = rna_inputs
    j_sp = {"mean": j_config.MEAN_STALL_PARAMS,
            "pctl": j_config.PCTL_STALL_PARAMS}[method]
    t_sp = {"mean": t_config.MEAN_STALL_PARAMS,
            "pctl": t_config.PCTL_STALL_PARAMS}[method]
    assert dataclasses.asdict(j_sp) == dataclasses.asdict(t_sp)
    found = 0
    for mr in maps:
        j_ints, j_met = j_rsq.identify_stalls(mr.raw_signal, j_sp, True)
        t_ints, t_met = t_rsq.identify_stalls(mr.raw_signal, t_sp, True)
        np.testing.assert_array_equal(np.asarray(t_ints), np.asarray(j_ints))
        np.testing.assert_array_equal(t_met, j_met)
        found += len(t_ints)
    assert found > 0


def test_remove_stall_cpts_matches_jax(rna_inputs):
    (_, params, _, maps, _), _ = rna_inputs
    for mr in maps[3:]:
        assert len(mr.stall_ints) >= 2
        raw = np.asarray(mr.raw_signal, np.float64)
        cpts = t_rsq.valid_cpts_w_cap_t_test(
            raw, params.min_obs_per_base, params.running_stat_width,
            raw.shape[0] // params.mean_obs_per_event)
        t_kept = t_rsq.remove_stall_cpts(mr.stall_ints, cpts)
        np.testing.assert_array_equal(
            t_kept, j_rsq.remove_stall_cpts(mr.stall_ints, cpts))
        assert t_kept.shape[0] < cpts.shape[0]
    assert t_rsq.remove_stall_cpts([], cpts) is cpts


def test_scale_values_match_jax(rna_inputs):
    """Median, constant-scale and event-based scale values."""
    (_, params, _, maps, _), _ = rna_inputs
    raw = np.asarray(maps[3].raw_signal, np.float64)
    for kw in (dict(norm_type="median"),
               dict(norm_type="median", outlier_thresh=5.0),
               dict(norm_type="median_const_scale", const_scale=55.0,
                    outlier_thresh=5.0),
               dict(norm_type="median", read_start_rel_to_raw=100,
                    read_obs_len=5000)):
        j_norm, j_sv = j_rsq.normalize_raw_signal(raw, **kw)
        t_norm, t_sv = t_rsq.normalize_raw_signal(raw, **kw)
        np.testing.assert_array_equal(t_norm, j_norm)
        assert dataclasses.asdict(t_sv) == dataclasses.asdict(j_sv)
    cpts = t_rsq.valid_cpts_w_cap_t_test(
        raw, params.min_obs_per_base, params.running_stat_width, 1500)
    for kw in (dict(), dict(num_events=10000, max_frac_events=0.75)):
        j_sv = j_rsq.get_scale_values_from_events(raw, cpts, 5.0, **kw)
        t_sv = t_rsq.get_scale_values_from_events(raw, cpts, 5.0, **kw)
        assert dataclasses.asdict(t_sv) == dataclasses.asdict(j_sv)


def _adapter_read(seed=5):
    """A read whose raw signal (3' end first) starts with 4,000 samples of
    quiet adapter, which trim_rna finds."""
    _, params, sst, _, raws = _rna_reads(RECIPE[:1], seed=seed)
    rng = np.random.default_rng(seed)
    adapter = np.round(520 + rng.normal(0, 2.0, 4000)).astype(np.int16)
    mr = raws[0]
    return params, sst, mr.replace(raw_signal=np.concatenate(
        [adapter, mr.raw_signal])), adapter.shape[0]


@pytest.mark.parametrize("trim", [False, True])
def test_adjust_map_res_rna_matches_jax(trim):
    params, sst, mr, n_adapter = _adapter_read()
    t_params, (t_mr,) = _convert(params, [mr])
    t_sst = convert.seq_samp_type(RNA, True)
    if trim:
        cut = t_rsq.trim_rna(t_mr.raw_signal, t_params)
        assert cut == j_rsq.trim_rna(mr.raw_signal, params)
        assert n_adapter - 50 <= cut <= n_adapter + 200, cut
    j_adj = j_rsq.adjust_map_res(mr, sst, params, trim_rna_adapter=trim)
    t_adj = t_rsq.adjust_map_res(t_mr, t_sst, t_params,
                                 trim_rna_adapter=trim)
    np.testing.assert_array_equal(t_adj.raw_signal, j_adj.raw_signal)
    np.testing.assert_array_equal(np.asarray(t_adj.stall_ints),
                                  np.asarray(j_adj.stall_ints))
    # the 3' -> 5' flip
    np.testing.assert_array_equal(
        t_adj.raw_signal[::-1][:mr.raw_signal.shape[0] - (cut if trim
                                                          else 0)],
        mr.raw_signal[cut if trim else 0:])


def test_map_read_rna_matches_jax():
    """Both strands: the same expanded genome sequence (5-mer model,
    central position 1), location and alignment counts."""
    jm, tm = JKmerModel.load_default(RNA), TKmerModel.load_default(RNA)
    jf = j_testing.random_reference(np.random.default_rng(8), 5000)
    ja = JExactAligner(jf)
    ta = TExactAligner(convert_fasta(jf))
    rng = np.random.default_rng(3)
    sst_j, sst_t = JSeqSampleType(RNA, True), convert.seq_samp_type(RNA,
                                                                    True)
    for i, strand in enumerate("+-+-"):
        read = j_testing.simulate_read(rng, jf, jm, read_len=300,
                                       strand=strand, rev_sig=True)
        jmr = j_rsq.map_read(JSequenceData(read.seq, "r%d" % i, 12.0), ja,
                             jm, sst_j)
        tmr = t_rsq.map_read(TSequenceData(read.seq, "r%d" % i, 12.0), ta,
                             tm, sst_t)
        assert tmr.genome_loc.strand == strand
        assert jmr.genome_seq == tmr.genome_seq
        assert len(tmr.genome_seq) == 300 + tm.kmer_width - 1
        assert dataclasses.asdict(jmr.align_info) == \
            dataclasses.asdict(tmr.align_info)
        assert dataclasses.asdict(jmr.genome_loc) == \
            dataclasses.asdict(tmr.genome_loc)


def convert_fasta(j_fasta):
    from tombo_tpu_torch.io.fasta import Fasta
    return Fasta(seqs={c: j_fasta.get_seq(c) for c in j_fasta.iter_chrms()})


# ----------------------------------------------------------- the slice
def test_rna_slice_f64_bitwise(rna_outputs):
    """Every read of the recipe succeeds, bitwise the JAX float64 lane;
    stall removal dropped changepoints of the stall reads and sent the
    short one to the static band."""
    j64, t64, _, seen = rna_outputs
    assert _assert_f64_exact(j64, t64) == len(RECIPE)
    for (j, _), (t, _) in zip(j64, t64):
        assert (t.scale_values.lower_lim, t.scale_values.upper_lim,
                t.scale_values.outlier_thresh) == (
            j.scale_values.lower_lim, j.scale_values.upper_lim,
            j.scale_values.outlier_thresh)
        assert t.raw_signal.shape[0] == t.segs[-1]
    p = t_config.load_resquiggle_parameters(RNA)
    for i, (n, stall) in enumerate(RECIPE):
        num_events, n_ev, static = seen["r_%03d" % i]
        if stall:
            assert n_ev < num_events - 1
        assert static == ("r_%03d" % i == REROUTED)
    assert seen[REROUTED][0] - 1 >= p.start_bw + p.start_n_bases
    assert seen[REROUTED][1] < p.start_bw + p.start_n_bases


@pytest.mark.parametrize("ref", ["jax_f64", "port_f64"])
@pytest.mark.parametrize("i", range(len(RECIPE)))
def test_rna_slice_f32_close(rna_outputs, i, ref):
    j64, t64, t32, _ = rna_outputs
    r = {"jax_f64": j64, "port_f64": t64}[ref]
    _assert_f32_close(*r[i], *t32[i], same_start=True)


# ------------------------------------------------------------ options
@pytest.fixture(scope="module")
def option_inputs(rna_inputs):
    """Three DNA reads of 650 bases and three RNA reads (one with a
    stall), both packages' inputs."""
    (model, params, sst, maps, _), (t_model, t_params, t_maps) = rna_inputs
    d_model, d_params, d_sst, d_maps = _prep_dna(3, read_len=650)
    d_tparams, d_tmaps = _convert(d_params, d_maps)
    pick = [0, 1, 3]
    return {
        "DNA": ((d_model, d_params, d_sst, d_maps),
                (convert.kmer_model(d_model.means, d_model.sds,
                                    d_model.central_pos, d_model.name,
                                    "DNA"), d_tparams, d_tmaps)),
        RNA: ((model, params, sst, [maps[i] for i in pick]),
              (t_model, t_params, [t_maps[i] for i in pick]))}


@pytest.mark.parametrize("samp_type", ["DNA", RNA])
@pytest.mark.parametrize("option", [dict(const_scale=55.0),
                                    dict(skip_seq_scaling=True)],
                         ids=["const_scale", "skip_seq_scaling"])
def test_option_bitwise_jax_f64(option_inputs, samp_type, option):
    (model, params, sst, maps), (t_model, t_params, t_maps) = \
        option_inputs[samp_type]
    j_out = JBatched(model, params, sst, j_config.OUTLIER_THRESH,
                     dtype=jnp.float64, **option).resquiggle_batch(maps)
    t_out = t_batch.BatchedResquiggler(
        t_model, t_params, convert.seq_samp_type(samp_type,
                                                 samp_type == RNA),
        j_config.OUTLIER_THRESH, dtype="float64", device="cpu",
        **option).resquiggle_batch(t_maps)
    assert _assert_f64_exact(j_out, t_out) == len(maps)
    for (j, _), (t, _) in zip(j_out, t_out):
        assert dataclasses.asdict(t.scale_values) == \
            dataclasses.asdict(j.scale_values)
        if "skip_seq_scaling" in option:
            assert t.norm_params_changed is False
    if "skip_seq_scaling" in option:
        # the first pass's scale values, unfitted
        plain = t_batch.BatchedResquiggler(
            t_model, t_params, convert.seq_samp_type(samp_type,
                                                     samp_type == RNA),
            j_config.OUTLIER_THRESH, dtype="float64",
            device="cpu").resquiggle_batch(t_maps, max_scaling_iters=1)
        assert any(p.scale_values.scale != t.scale_values.scale
                   for (p, _), (t, _) in zip(plain, t_out))


@pytest.mark.parametrize("n", [2, 3])
def test_rna_mesh_lane_bitwise(rna_inputs, rna_outputs, n):
    """The RNA batch over n CPU shards at float64: bitwise the port's
    1-device lane and the JAX package's mesh lane."""
    (model, params, sst, maps, _), (t_model, t_params, t_maps) = rna_inputs
    _, t64, _, _ = rna_outputs
    t_out = _port(t_model, t_params, "float64",
                  mesh=t_mesh.make_mesh(["cpu"] * n)).resquiggle_batch(t_maps)
    assert t_mesh.lane_differences(t_out, t64, exact=True) == []
    j_out = JBatched(model, params, sst, j_config.OUTLIER_THRESH,
                     dtype=jnp.float64,
                     mesh=j_mesh.make_mesh(jax.devices()[:n])
                     ).resquiggle_batch(maps)
    assert _assert_f64_exact(j_out, t_out) == len(maps)


# --------------------------------------------- a read's score, any batch
def test_score_independent_of_batch_size():
    """The fit's score of a read is bitwise the same in a batch of 24,
    of 7 and alone (float32); the fixed-order row sum is the pairwise
    tree over the zero-padded power-of-two width."""
    rng = np.random.default_rng(5)
    B, L, S = 24, 256, 4096
    seq_lens = rng.integers(100, L + 1, B)
    dwell = rng.integers(3, 15, (B, L))
    segs = np.zeros((B, L + 1), np.int64)
    segs[:, 1:] = np.cumsum(dwell, 1)
    rsrtr = rng.integers(0, 200, B)
    norm = rng.normal(0, 1, (B, S)).astype(np.float32)
    rm = rng.normal(0, 1, (B, L)).astype(np.float32)
    rs = np.abs(rng.normal(1, 0.1, (B, L))).astype(np.float32)
    tri = rescale.tri_indices(L, "cpu")

    def score(rows):
        t = lambda a: torch.tensor(a[rows])
        return t_batch._stage_fit(
            torch.tensor(norm[rows]), torch.arange(len(rows)), t(rsrtr),
            t(segs), t(rm), t(rs), t(seq_lens), None, tri, 0.1, 0.1)[2]

    full = score(np.arange(B)).numpy()
    for part in (np.arange(7), np.arange(7, B), np.array([11])):
        np.testing.assert_array_equal(score(part).numpy(), full[part])

    x = rng.normal(0, 1, (5, 1000)).astype(np.float32)
    tree = np.pad(x, ((0, 0), (0, 24)))
    while tree.shape[1] > 1:
        h = tree.shape[1] // 2
        tree = tree[:, :h] + tree[:, h:]
    np.testing.assert_array_equal(precision.row_sums(torch.tensor(x)),
                                  tree[:, 0])
