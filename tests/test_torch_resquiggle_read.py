"""The one-read re-squiggle API of the port
(``tombo_tpu_torch/pipeline/resquiggle.py::resquiggle_read`` and
``resquiggle_read_with_retries``) on the CPU against the JAX package's
(``tombo_tpu/pipeline/resquiggle.py``), on reads made by
tests/test_batch_parity.py's recipe (seeded simulation, exact mapping,
``adjust_map_res``).

At float64 the port equals the JAX package bit for bit: segment table,
start, scale values, score, ``norm_params_changed``, the normalized
signal, and the message of a failed read.  At float32 (the card's DP
inputs, and the Theil-Sen fit through the count kernel's plain version)
the same reads hold tests/test_batch_parity.py's bars: the same error or
none, the same start, boundaries equal on > 99%, score within 1e-2,
fitted shift and scale within 2e-3 of the scale.  Each case also checks
that it takes the path it names (static band, deletion windows, the
Theil-Sen subsample, a stall, the save start band, the save bandwidth).
Also: the masked-start plan equals the JAX package's per-read plan and
the batched path's row for the read,
``compute_base_mean_stds_batch`` equals the JAX function, and the numpy
oracles copied into ``ops/ref_impl.py`` equal the JAX package's."""
import dataclasses
import types

import numpy as np
import pytest
import torch

from tombo_tpu import config as j_config
from tombo_tpu import testing as j_testing
from tombo_tpu.errors import TomboTpuError
from tombo_tpu.io.model_io import KmerModel as JKmerModel
from tombo_tpu.ops import normalize as j_nrm
from tombo_tpu.ops import ref_impl as j_ri
from tombo_tpu.pipeline import resquiggle as j_rsq
from tombo_tpu.pipeline.aligner import ExactAligner as JExactAligner
from tombo_tpu.types import SeqSampleType as JSeqSampleType
from tombo_tpu.types import SequenceData as JSequenceData
from tombo_tpu_torch import convert, kernels, native, testing
from tombo_tpu_torch.errors import TomboError
from tombo_tpu_torch.ops import banded_dp
from tombo_tpu_torch.ops import normalize as t_nrm
from tombo_tpu_torch.ops import ref_impl as t_ri
from tombo_tpu_torch.ops import rescale
from tombo_tpu_torch.pipeline import batch as t_batch
from tombo_tpu_torch.pipeline import resquiggle as t_rsq

from test_torch_batch import _assert_f32_close

# case -> (sample type, simulation, stall samples, options, what the port
# must run on the read: a counter of the spies below and its least value)
CASES = {
    "dna_1kb": ("DNA", dict(read_len=1000), 0, {}, ("k1_300", 1)),
    "static_band": ("DNA", dict(read_len=400), 0, {}, ("static", 1)),
    "deletions": ("DNA", dict(read_len=1000, mean_dwell=4.0), 0, {},
                  ("windows", 10)),
    "theil_sen_subsample": ("DNA", dict(read_len=1500), 0, {},
                            ("subsample", 1)),
    "start_save_band": ("DNA", dict(read_len=1000,
                                    adapter_len=(5000, 6000)), 0, {},
                        ("k4_2500", 1)),
    "save_bandwidth": ("DNA", dict(read_len=1000), 3000, {},
                       ("k1_1500", 1)),
    "rna_stall": ("RNA", dict(read_len=1700, mean_dwell=12.0, rev_sig=True,
                              adapter_len=(600, 900)), 3000, {},
                  ("stall", 1)),
    "const_scale": ("DNA", dict(read_len=1000), 0, dict(const_scale=55.0),
                    ("k1_300", 1)),
    "skip_seq_scaling": ("DNA", dict(read_len=1000), 0,
                         dict(skip_seq_scaling=True), ("k1_300", 1)),
    "failed": ("DNA", dict(read_len=1000), -1, {}, ("k4_750", 0)),
}


def _case_read(name):
    """The JAX-side model, parameters and adjusted mapped read of a case
    (seed 7 of tests/test_batch_parity.py's recipe; a stall goes in at the
    middle base boundary; ``failed`` keeps 45% of the signal, too little
    for the changepoints the sequence needs)."""
    samp, sim, stall, _, _ = CASES[name]
    rng = np.random.default_rng(7)
    model = JKmerModel.load_default(samp)
    fasta = j_testing.random_reference(np.random.default_rng(8), 30000)
    sst = JSeqSampleType(samp, samp == "RNA")
    params = j_config.load_resquiggle_parameters(samp)
    read = j_testing.simulate_read(rng, fasta, model, read_id="p_" + name,
                                   **sim)
    raw = read.raw_signal
    if stall > 0:
        mid = int(read.true_segs[sim["read_len"] // 2])
        pos = raw.shape[0] - mid if sim.get("rev_sig") else mid
        raw = testing.insert_stall(rng, raw, pos, stall)
    elif stall < 0:
        raw = raw[:int(0.45 * raw.shape[0])]
    mr = j_rsq.map_read(JSequenceData(read.seq, read.read_id, 12.0),
                        JExactAligner(fasta), model, sst)
    mr = j_rsq.adjust_map_res(mr.replace(raw_signal=raw), sst, params)
    return model, params, sst, mr


def _jax_run(name, retries=True):
    model, params, sst, mr = _case_read(name)
    opts = CASES[name][3]
    try:
        if retries:
            return j_rsq.resquiggle_read_with_retries(
                mr, model, params, j_config.load_resquiggle_parameters(
                    CASES[name][0], use_save_bandwidth=True),
                outlier_thresh=j_config.OUTLIER_THRESH, seq_samp_type=sst,
                **opts), None
        return j_rsq.resquiggle_read(
            mr, model, params, outlier_thresh=j_config.OUTLIER_THRESH,
            seq_samp_type=sst, **opts), None
    except TomboTpuError as e:
        return None, str(e)


def _port_inputs(name):
    model, params, sst, mr = _case_read(name)
    samp = CASES[name][0]
    return (convert.kmer_model(model.means, model.sds, model.central_pos,
                               model.name, samp),
            convert.resquiggle_params(dataclasses.asdict(params)),
            convert.resquiggle_params(dataclasses.asdict(
                j_config.load_resquiggle_parameters(
                    samp, use_save_bandwidth=True))),
            convert.seq_samp_type(samp, samp == "RNA"),
            convert.resquiggle_results(dataclasses.asdict(mr)))


@pytest.fixture
def spies(monkeypatch):
    """Counts of what the port runs: K1 by bandwidth, K4 by start band,
    the static band, deletion windows, Theil-Sen subsamples and stall
    changepoint removals."""
    seen = {}

    def count(key, n=1):
        seen[key] = seen.get(key, 0) + n

    def wrap(owner, name, key_fn):
        fn = getattr(owner, name)

        def run(*a, **kw):
            count(*key_fn(*a, **kw))
            return fn(*a, **kw)
        monkeypatch.setattr(owner, name, run)

    wrap(banded_dp, "adaptive_banded_dp_tb",
         lambda *a, **kw: ("k1_%d" % a[9].bandwidth,))
    wrap(banded_dp, "start_dp_segs",
         lambda em, rm, rs, sp: ("k4_%d" % sp.num_events,))
    wrap(native, "static_base_assignment", lambda *a, **kw: ("static",))
    wrap(native, "raw_windows_dp_batch",
         lambda wins, *a, **kw: ("windows", len(wins)))
    wrap(t_rsq, "remove_stall_cpts",
         lambda ints, cpts: ("stall", len(ints)))
    wrap(t_rsq, "_theil_sen_points",
         lambda ev, mod, *a: ("subsample", int(mod.shape[0] > 1000)))
    return seen


def _port_run(name, dtype, retries=True):
    t_model, t_params, t_save, t_sst, t_mr = _port_inputs(name)
    opts = CASES[name][3]
    try:
        if retries:
            return t_rsq.resquiggle_read_with_retries(
                t_mr, t_model, t_params, t_save,
                outlier_thresh=j_config.OUTLIER_THRESH, seq_samp_type=t_sst,
                device="cpu", dtype=dtype, **opts), None
        return t_rsq.resquiggle_read(
            t_mr, t_model, t_params, outlier_thresh=j_config.OUTLIER_THRESH,
            seq_samp_type=t_sst, device="cpu", dtype=dtype, **opts), None
    except TomboError as e:
        return None, str(e)


def _assert_bitwise(j, t):
    (j_res, j_err), (t_res, t_err) = j, t
    assert t_err == j_err
    if j_res is None:
        return
    np.testing.assert_array_equal(t_res.segs, j_res.segs)
    assert t_res.segs.dtype == j_res.segs.dtype
    assert t_res.read_start_rel_to_raw == j_res.read_start_rel_to_raw
    assert dataclasses.astuple(t_res.scale_values) == \
        dataclasses.astuple(j_res.scale_values)
    assert t_res.sig_match_score == j_res.sig_match_score
    assert t_res.norm_params_changed == j_res.norm_params_changed
    assert t_res.raw_signal.tobytes() == j_res.raw_signal.tobytes()
    assert t_res.genome_seq == j_res.genome_seq


@pytest.fixture(scope="module")
def jax_results():
    return {}


def _jax_cached(jax_results, name, retries=True):
    key = (name, retries)
    if key not in jax_results:
        jax_results[key] = _jax_run(name, retries)
    return jax_results[key]


@pytest.mark.parametrize("name", list(CASES))
def test_with_retries_f64_bitwise(name, spies, jax_results):
    launches = dict(kernels.LAUNCHES)
    t = _port_run(name, torch.float64)
    _assert_bitwise(_jax_cached(jax_results, name), t)
    # the CPU runs every kernel's plain version
    assert kernels.LAUNCHES == launches
    key, least = CASES[name][4]
    assert spies.get(key, 0) >= least, spies
    assert (t[0] is None) == (name == "failed")


@pytest.mark.parametrize("name", ["dna_1kb", "static_band", "deletions",
                                  "rna_stall", "save_bandwidth", "failed"])
def test_resquiggle_read_f64_bitwise(name, jax_results):
    """One pass, no retry."""
    j = _jax_cached(jax_results, name, retries=False)
    _assert_bitwise(j, _port_run(name, torch.float64, retries=False))
    assert (j[0] is None) == (name == "failed")


@pytest.mark.parametrize("name", list(CASES))
def test_with_retries_f32_within_bars(name, spies, jax_results):
    j_res, j_err = _jax_cached(jax_results, name)
    t_res, t_err = _port_run(name, torch.float32)
    _assert_f32_close(j_res, j_err, t_res, t_err, same_start=True)
    if t_res is not None:
        assert t_res.norm_params_changed == j_res.norm_params_changed
    key, least = CASES[name][4]
    assert spies.get(key, 0) >= least, spies


def test_no_card_raises_without_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    t_model, t_params, t_save, t_sst, t_mr = _port_inputs("dna_1kb")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_rsq.resquiggle_read(t_mr, t_model, t_params, seq_samp_type=t_sst)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_rsq.resquiggle_read_with_retries(t_mr, t_model, t_params, t_save,
                                           seq_samp_type=t_sst)


def test_masked_start_plan_equals_batched_rows(monkeypatch):
    """build_masked_start_plan of each read (those the one-read path plans,
    and random ones) equals the JAX package's per-read ``np.linspace``
    plan in its first P columns, repeats the last band start and ends at
    the last event past them, and equals its row of the batched path's
    ``_build_masked_plans_batch`` over all the reads at once."""
    plans = []
    plan = t_rsq.build_masked_start_plan

    def rec(n_events, mso, params, epb, *a, **kw):
        out = plan(n_events, mso, params, epb, *a, **kw)
        plans.append((n_events, mso, epb, params))
        return out
    monkeypatch.setattr(t_rsq, "build_masked_start_plan", rec)
    for name in ("dna_1kb", "deletions", "rna_stall"):
        _port_run(name, torch.float64, retries=False)
    rng = np.random.default_rng(3)
    p = plans[0][3]
    for _ in range(12):
        mso = int(rng.integers(0, p.bandwidth // 2 + 1))
        plans.append((int(rng.integers(p.bandwidth + mso, 9000)), mso,
                      float(rng.uniform(1.0, 3.0)), p))
    assert len(plans) >= 15
    for params in {pl[3] for pl in plans}:
        group = [pl for pl in plans if pl[3] == params]
        j_params = j_config.ResquiggleParams(
            **dataclasses.asdict(params))
        states = [types.SimpleNamespace(n_ev=n, events_start_clip=0,
                                        mapped_start_offset=mso,
                                        events_per_base=epb)
                  for n, mso, epb, _ in group]
        b_starts, b_valid, b_end, b_rows, _ = \
            t_batch._build_masked_plans_batch(states, params)
        for i, (n, mso, epb, _) in enumerate(group):
            starts, valid, end, rows, P_max = plan(n, mso, params, epb)
            j_starts, j_valid, j_end = j_rsq.build_masked_start_plan(
                n, mso, j_params, epb)
            P = j_starts.shape[0]
            assert rows[0] == P and P_max % 64 == 0 and P <= P_max
            assert starts.shape == end.shape == (1, P_max)
            np.testing.assert_array_equal(starts[0, :P], j_starts)
            np.testing.assert_array_equal(end[0, :P], j_end)
            assert valid[0] == j_valid
            assert (starts[0, P:] == j_starts[-1]).all()
            assert (end[0, P:] == n).all()
            assert b_rows[i] == P and b_valid[i] == j_valid
            np.testing.assert_array_equal(b_starts[i, :P_max], starts[0])
            np.testing.assert_array_equal(b_end[i, :P_max], end[0])
        with pytest.raises(TomboError, match="too far into events"):
            plan(params.bandwidth - 1, 0, params, 2.0)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_compute_base_mean_stds_batch_matches_jax(dtype):
    """Means within 1e-12 at float64 (they are equal), invalid segments
    exactly 0.  An SD is the square root of E[x^2] - mean^2, which cancels
    to rounding noise on a segment of (near) zero variance, as one-sample
    segments are: XLA contracts that subtraction into a fused
    multiply-add, the port does not, so there the variances agree to
    1e-14 (a few ulp of E[x^2]) and the SDs, their square roots, only to
    about 1e-7.  Elsewhere the SDs agree to 1e-12.  float32 (sums in
    float64, each result rounded once) holds means and SDs to 1e-5 and
    the variances to 1e-6."""
    import jax.numpy as jnp
    rng = np.random.default_rng(11)
    B, S, E = 5, 3000, 400
    norm = rng.normal(0, 1, (B, S))
    segs = np.zeros((B, E + 1), np.int64)
    n_segs = rng.integers(100, E + 1, B)
    for b in range(B):
        cuts = np.sort(rng.integers(0, S, n_segs[b] + 1))
        cuts[5] = cuts[6]                  # a zero-length segment
        segs[b, :n_segs[b] + 1] = cuts
    j_means, j_sds = (np.asarray(a) for a in
                      j_nrm.compute_base_mean_stds_batch(
                          jnp.asarray(norm), jnp.asarray(segs),
                          jnp.asarray(n_segs)))
    t_means, t_sds = (a.double().numpy() for a in
                      t_nrm.compute_base_mean_stds_batch(
                          torch.tensor(norm, dtype=getattr(torch, dtype)),
                          torch.tensor(segs), torch.tensor(n_segs)))
    f64 = dtype == "float64"
    tol, var_tol = (1e-12, 1e-14) if f64 else (1e-5, 1e-6)
    np.testing.assert_allclose(t_means, j_means, rtol=0, atol=tol)
    np.testing.assert_allclose(t_sds ** 2, j_sds ** 2, rtol=0, atol=var_tol)
    spread = j_sds > (1e-6 if f64 else 1e-2)
    np.testing.assert_allclose(t_sds[spread], j_sds[spread], rtol=0,
                               atol=tol)
    lens = np.diff(segs, axis=1)
    assert ((lens == 1) & (np.arange(E)[None, :] < n_segs[:, None])).any()
    invalid = (np.arange(E)[None, :] >= n_segs[:, None]) | (lens == 0)
    assert invalid.sum() > 0
    assert (t_means[invalid] == 0).all() and (t_sds[invalid] == 0).all()


def _adaptive_inputs(seed):
    rng = np.random.default_rng(seed)
    n_ev, L, bw = 900, 500, 60
    ev = rng.normal(0, 1, n_ev)
    rm, rs = rng.normal(0, 1, L), rng.uniform(0.3, 0.7, L)
    fwd = np.zeros((L + 1, bw))
    fwd[1] = rng.normal(0, 1, bw)
    tb = np.zeros((L + 1, bw), np.int8)
    starts = np.zeros(L, np.int64)
    return fwd, tb, starts, ev, rm, rs


@pytest.mark.parametrize("fn", ["mean_std", "apply_outlier_thresh",
                                "valid_cpts", "base_z_scores",
                                "adaptive_banded_forward_pass"])
def test_copied_oracles_match_jax(fn):
    rng = np.random.default_rng(19)
    sig = np.repeat(rng.integers(400, 460, 600),
                    rng.integers(3, 9, 600)).astype(np.float64)
    if fn == "adaptive_banded_forward_pass":
        outs = []
        for mod in (j_ri, t_ri):
            fwd, tb, starts, ev, rm, rs = _adaptive_inputs(5)
            z = mod.adaptive_banded_forward_pass(
                fwd, tb, starts, ev, rm, rs, 6.8, 4.0, 6.0, 1, -15.0, True,
                5.0, return_z_scores=True)
            outs.append((fwd, tb, starts, z))
        for a, b in zip(*outs):
            assert a.tobytes() == b.tobytes()
        # a band placed past the last event (row 1's best position at
        # the band's end, 5 events)

        def short(mod):
            fwd, tb, starts = _adaptive_inputs(6)[:3]
            fwd[1, -1] = 100.0
            return mod.adaptive_banded_forward_pass(
                fwd, tb, starts, np.zeros(5), np.zeros(500), np.ones(500),
                6.8, 4.0, 6.0, 1, -15.0, False, 5.0)
        with pytest.raises(TomboTpuError) as j_e:
            short(j_ri)
        with pytest.raises(TomboError) as t_e:
            short(t_ri)
        assert str(t_e.value) == str(j_e.value)
        return
    args = {"mean_std": (sig,), "apply_outlier_thresh": (sig, 410.0, 450.0),
            "valid_cpts": (sig, 3, 5),
            "base_z_scores": (sig, 430.0, 9.0, True, 2.5)}[fn]
    j, t = getattr(j_ri, fn)(*args), getattr(t_ri, fn)(*args)
    if isinstance(j, tuple):
        assert j == t
    else:
        assert j.dtype == t.dtype and j.tobytes() == t.tobytes()


def test_fit_points_are_the_numpy_fit_points():
    """Above 1,000 bases the card's fit draws the points of
    ``calc_kmer_fitted_shift_scale`` (rng(0).choice), not the batched
    path's cached subsample array."""
    rng = np.random.default_rng(2)
    ev, mod = rng.normal(0, 1, 1500), rng.normal(0, 1, 1500)
    pe, pm = t_rsq._theil_sen_points(ev, mod)
    samp = np.random.default_rng(0).choice(1500, 1000, replace=False)
    np.testing.assert_array_equal(pe, ev[samp])
    np.testing.assert_array_equal(pm, mod[samp])
    # the fit through the count kernel's plain version equals the numpy
    # fit at float64 selection precision
    shc, scc = t_rsq._fitted_corrections_device(ev, 0.9 * ev + 0.1 + 0.01 *
                                                mod, torch.device("cpu"),
                                                torch.float64)
    _, _, shc_np, scc_np = t_rsq.calc_kmer_fitted_shift_scale(
        0.0, 1.0, ev, 0.9 * ev + 0.1 + 0.01 * mod)
    assert shc == shc_np and scc == scc_np
    assert rescale.tri_indices(1000, "cpu")[0].shape[0] == 499500
