"""The slice as a whole: batched DNA re-squiggle through the port on the
CPU against the JAX package's BatchedResquiggler.  At float32 with the
tolerances of tests/test_batch_parity.py (co-optimal DP ties flip ~1% of
boundaries; fitted scale parameters agree to 2e-3, scores to 1e-2); at
float64 exactly."""
import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp

from tombo_tpu import config as j_config
from tombo_tpu import testing as j_testing
from tombo_tpu.io.model_io import KmerModel as JKmerModel
from tombo_tpu.pipeline import resquiggle as j_rsq
from tombo_tpu.pipeline.aligner import ExactAligner as JExactAligner
from tombo_tpu.pipeline.batch import BatchedResquiggler as JBatched
from tombo_tpu.types import SeqSampleType as JSeqSampleType
from tombo_tpu.types import SequenceData as JSequenceData
from tombo_tpu_torch import config as t_config
from tombo_tpu_torch import convert, kernels
from tombo_tpu_torch import testing as t_testing
from tombo_tpu_torch.io.model_io import KmerModel as TKmerModel
from tombo_tpu_torch.pipeline import resquiggle as t_rsq
from tombo_tpu_torch.pipeline.aligner import ExactAligner as TExactAligner
from tombo_tpu_torch.pipeline.batch import BatchedResquiggler as TBatched
from tombo_tpu_torch.types import SeqSampleType as TSeqSampleType
from tombo_tpu_torch.types import SequenceData as TSequenceData


def test_model_and_simulation_bitwise_equal():
    jm, tm = JKmerModel.load_default("DNA"), TKmerModel.load_default("DNA")
    np.testing.assert_array_equal(jm.means, tm.means)
    np.testing.assert_array_equal(jm.sds, tm.sds)
    assert (jm.kmer_width, jm.central_pos) == (tm.kmer_width, tm.central_pos)
    jf = j_testing.random_reference(np.random.default_rng(8), 5000)
    tf = t_testing.random_reference(np.random.default_rng(8), 5000)
    assert jf.get_seq("chr_test") == tf.get_seq("chr_test")
    jr, tr = np.random.default_rng(7), np.random.default_rng(7)
    for i in range(4):
        a = j_testing.simulate_read(jr, jf, jm, read_len=300)
        b = t_testing.simulate_read(tr, tf, tm, read_len=300)
        assert (a.seq, a.strand, a.start, a.read_id) == \
            (b.seq, b.strand, b.start, b.read_id)
        np.testing.assert_array_equal(a.raw_signal, b.raw_signal)
        np.testing.assert_array_equal(a.true_segs, b.true_segs)


def test_mapping_matches_jax():
    jm, tm = JKmerModel.load_default("DNA"), TKmerModel.load_default("DNA")
    jf = j_testing.random_reference(np.random.default_rng(8), 5000)
    tf = t_testing.random_reference(np.random.default_rng(8), 5000)
    ja, ta = JExactAligner(jf), TExactAligner(tf)
    rng = np.random.default_rng(3)
    for i in range(4):
        read = j_testing.simulate_read(rng, jf, jm, read_len=300)
        jmr = j_rsq.map_read(JSequenceData(read.seq, "r%d" % i, 12.0), ja,
                             jm, JSeqSampleType("DNA", False))
        tmr = t_rsq.map_read(TSequenceData(read.seq, "r%d" % i, 12.0), ta,
                             tm, TSeqSampleType("DNA", False))
        assert jmr.genome_seq == tmr.genome_seq
        assert dataclasses.asdict(jmr.align_info) == \
            dataclasses.asdict(tmr.align_info)
        assert dataclasses.asdict(jmr.genome_loc) == \
            dataclasses.asdict(tmr.genome_loc)


def _prep_reads(n_reads, seed=7, **sim_kw):
    """tests/test_batch_parity.py's recipe, JAX side."""
    rng = np.random.default_rng(seed)
    model = JKmerModel.load_default("DNA")
    fasta = j_testing.random_reference(np.random.default_rng(seed + 1),
                                       30000)
    aligner = JExactAligner(fasta)
    sst = JSeqSampleType("DNA", False)
    params = j_config.load_resquiggle_parameters("DNA")
    map_results = []
    for i in range(n_reads):
        read = j_testing.simulate_read(rng, fasta, model,
                                       read_id="p_%03d" % i, **sim_kw)
        mr = j_rsq.map_read(JSequenceData(read.seq, read.read_id, 12.0),
                            aligner, model, sst)
        mr = mr.replace(raw_signal=read.raw_signal)
        map_results.append(j_rsq.adjust_map_res(mr, sst, params))
    return model, params, sst, map_results


def _convert(params, map_results):
    return (convert.resquiggle_params(dataclasses.asdict(params)),
            [convert.resquiggle_results(dataclasses.asdict(m))
             for m in map_results])


@pytest.fixture(scope="module")
def slice_inputs():
    model, params, sst, map_results = _prep_reads(6, read_len=650)
    t_model = convert.kmer_model(model.means, model.sds, model.central_pos,
                                 model.name, "DNA")
    t_params, t_maps = _convert(params, map_results)
    assert t_params == t_config.load_resquiggle_parameters("DNA")
    return (model, params, sst, map_results), (t_model, t_params, t_maps)


def _run_both(slice_inputs, j_dtype, t_dtype):
    (model, params, sst, map_results), (t_model, t_params, t_maps) = \
        slice_inputs
    j_out = JBatched(model, params, sst, j_config.OUTLIER_THRESH,
                     dtype=j_dtype).resquiggle_batch(map_results)
    launches = dict(kernels.LAUNCHES)
    t_out = TBatched(t_model, t_params, convert.seq_samp_type("DNA", False),
                     j_config.OUTLIER_THRESH, dtype=t_dtype,
                     device="cpu").resquiggle_batch(t_maps)
    # the CPU runs every kernel's plain version
    assert kernels.LAUNCHES == launches
    return j_out, t_out


@pytest.fixture(scope="module")
def jax_f64_outputs(slice_inputs):
    (model, params, sst, map_results), _ = slice_inputs
    return JBatched(model, params, sst, j_config.OUTLIER_THRESH,
                    dtype=jnp.float64).resquiggle_batch(map_results)


@pytest.fixture(scope="module")
def slice_outputs(slice_inputs, jax_f64_outputs):
    j32, t32 = _run_both(slice_inputs, jnp.float32, "float32")
    return {"f32": j32, "f64": jax_f64_outputs}, t32


def _assert_f32_close(j_res, j_err, t_res, t_err, same_start):
    """The float32 bar: the same error or none, boundaries equal on > 99%
    where they lie in the raw signal (start + segs), signal-match score
    within 1e-2, fitted shift and scale within 2e-3 of the scale."""
    assert (j_err is None) == (t_err is None), (j_err, t_err)
    if j_res is None:
        return
    assert t_res.segs.shape == j_res.segs.shape
    if same_start:
        assert t_res.read_start_rel_to_raw == j_res.read_start_rel_to_raw
    assert np.mean(t_res.read_start_rel_to_raw + t_res.segs ==
                   j_res.read_start_rel_to_raw + j_res.segs) > 0.99
    assert abs(t_res.sig_match_score - j_res.sig_match_score) < 1e-2
    sc = j_res.scale_values.scale
    assert abs(t_res.scale_values.shift - j_res.scale_values.shift) / sc \
        < 2e-3
    assert abs(t_res.scale_values.scale - sc) / sc < 2e-3
    assert t_res.genome_seq == j_res.genome_seq
    assert t_res.raw_signal.shape[0] == t_res.segs[-1]


# the one read whose start the JAX float32 lane moves by a sample
_JAX_F32_START_TIE = "p_005"


@pytest.mark.parametrize("ref", ["f32", "f64"])
@pytest.mark.parametrize("i", range(6))
def test_slice_matches_jax_f32(slice_outputs, i, ref):
    """The port's float32 lane against the JAX package's float32 lane and
    against its float64 lane.  Lanes that round differently break
    co-optimal ties differently, and a tie at the first changepoint moves
    a read's start by a sample; so boundaries are compared where they lie
    in the raw signal.  The JAX float32 lane moves the start of read
    ``_JAX_F32_START_TIE`` so, and no other; the port's float32 start
    equals the exact float64 start on every read."""
    j_outs, t_out = slice_outputs
    j_res = j_outs[ref][i][0]
    same_start = (ref == "f64" or j_res is None or
                  j_res.align_info.read_id != _JAX_F32_START_TIE)
    _assert_f32_close(*j_outs[ref][i], *t_out[i], same_start=same_start)


def test_resquiggle_batches_in_order(slice_inputs, slice_outputs):
    """The batch pipeline yields each batch's results in input order, the
    same as one resquiggle_batch call over all the reads."""
    _, (t_model, t_params, t_maps) = slice_inputs
    _, t_out = slice_outputs
    br = TBatched(t_model, t_params, convert.seq_samp_type("DNA", False),
                  j_config.OUTLIER_THRESH, device="cpu")
    batches = [t_maps[:2], t_maps[2:3], t_maps[3:]]
    outs = list(br.resquiggle_batches(iter(batches), pipeline_depth=2))
    assert [len(o) for o in outs] == [2, 1, 3]
    for (res, err), (ref, ref_err) in zip([r for o in outs for r in o],
                                          t_out):
        assert err == ref_err
        if ref is not None:
            assert res.align_info.read_id == ref.align_info.read_id
            np.testing.assert_array_equal(res.segs, ref.segs)
            assert res.scale_values == ref.scale_values


def _assert_f64_exact(j_out, t_out):
    """float64 is the exact-parity mode: segment tables, starts and fitted
    scale values equal the JAX package's float64 lane bit for bit (the
    bar tests/test_parity_exact.py sets for that lane).  Returns the
    number of reads that succeeded."""
    n_ok = 0
    for (j_res, j_err), (t_res, t_err) in zip(j_out, t_out):
        assert j_err == t_err
        if j_res is None:
            continue
        n_ok += 1
        np.testing.assert_array_equal(t_res.segs, j_res.segs)
        assert t_res.read_start_rel_to_raw == j_res.read_start_rel_to_raw
        assert t_res.scale_values.shift == j_res.scale_values.shift
        assert t_res.scale_values.scale == j_res.scale_values.scale
        assert t_res.norm_params_changed == j_res.norm_params_changed
        assert abs(t_res.sig_match_score - j_res.sig_match_score) < 1e-12
    return n_ok


def test_slice_matches_jax_f64_exactly(slice_inputs, jax_f64_outputs):
    _, (t_model, t_params, t_maps) = slice_inputs
    t_out = TBatched(t_model, t_params, convert.seq_samp_type("DNA", False),
                     j_config.OUTLIER_THRESH, dtype="float64",
                     device="cpu").resquiggle_batch(t_maps)
    assert _assert_f64_exact(jax_f64_outputs, t_out) >= 5


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_long_reads_subsampled_fit(slice_inputs, dtype):
    """Reads longer than MAX_POINTS_FOR_THEIL_SEN bases fit on the seeded
    subsample of their bases (rng(0)), in both packages: exactly at
    float64, within the float32 bar at float32."""
    (model, _, sst, _), (t_model, _, _) = slice_inputs
    _, params, _, map_results = _prep_reads(2, seed=11, read_len=1150)
    assert all(len(m.genome_seq) > j_config.MAX_POINTS_FOR_THEIL_SEN + 10
               for m in map_results)
    t_params, t_maps = _convert(params, map_results)
    j_out = JBatched(model, params, sst, j_config.OUTLIER_THRESH,
                     dtype=getattr(jnp, dtype)).resquiggle_batch(map_results)
    t_out = TBatched(t_model, t_params, convert.seq_samp_type("DNA", False),
                     j_config.OUTLIER_THRESH, dtype=dtype,
                     device="cpu").resquiggle_batch(t_maps)
    if dtype == "float64":
        assert _assert_f64_exact(j_out, t_out) == 2
    else:
        assert all(r is not None for r, _ in t_out)
        for j, t in zip(j_out, t_out):
            _assert_f32_close(*j, *t, same_start=False)
