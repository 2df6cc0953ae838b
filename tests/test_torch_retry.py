"""The two retries of the batched re-squiggle, through the port on the CPU
against the JAX package's BatchedResquiggler.

Two reads sit behind ~5,500 samples of adapter signal, so their start lies
past the 750-event start band: start discovery fails its score check and
retries at the 2,500-event save start band.  Two reads carry a 3,000-sample
single-level stall in the middle, which the 300-event band cannot follow:
the adaptive DP flags them and the batch retries them with the 1,500-event
save bandwidth.  Bars as tests/test_torch_batch.py: float64 exact, float32
within tests/test_batch_parity.py's tolerances with equal starts."""
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
from tombo_tpu_torch import convert
from tombo_tpu_torch.ops import banded_dp as t_bdp
from tombo_tpu_torch.pipeline.batch import BatchedResquiggler as TBatched

from test_torch_batch import _assert_f32_close, _assert_f64_exact, _convert

STALL = 3000


def _retry_reads(seed=31):
    rng = np.random.default_rng(seed)
    model = JKmerModel.load_default("DNA")
    fasta = j_testing.random_reference(np.random.default_rng(seed + 1),
                                       30000)
    aligner = JExactAligner(fasta)
    sst = JSeqSampleType("DNA", False)
    params = j_config.load_resquiggle_parameters("DNA")
    maps = []
    for i in range(4):
        long_adapter = i < 2
        read = j_testing.simulate_read(
            rng, fasta, model, read_len=1000, read_id="retry_%d" % i,
            adapter_len=(5000, 6000) if long_adapter else (50, 300))
        raw = read.raw_signal
        if not long_adapter:
            mid = int(read.true_segs[500])
            stall = np.round(raw[mid] + rng.normal(0, 11, STALL))
            raw = np.concatenate([raw[:mid], stall.astype(np.int16),
                                  raw[mid:]])
        mr = j_rsq.map_read(JSequenceData(read.seq, read.read_id, 12.0),
                            aligner, model, sst)
        maps.append(j_rsq.adjust_map_res(mr.replace(raw_signal=raw), sst,
                                         params))
    return model, params, sst, maps


@pytest.fixture(scope="module")
def retry_inputs():
    return _retry_reads()


def _record_bands(monkeypatch, cls):
    """Record (bandwidth, start band) of every start discovery and the
    bandwidth of every adaptive DP that ``cls`` runs."""
    seen = set()
    start, adaptive = cls._start_discovery, cls._adaptive_device_call

    def start_rec(self, states, ctx, start_bw, *a, **kw):
        seen.add(("start", self.params.bandwidth, start_bw))
        return start(self, states, ctx, start_bw, *a, **kw)

    def adaptive_rec(self, live, *a, **kw):
        seen.add(("adaptive", self.params.bandwidth))
        return adaptive(self, live, *a, **kw)

    monkeypatch.setattr(cls, "_start_discovery", start_rec)
    monkeypatch.setattr(cls, "_adaptive_device_call", adaptive_rec)
    return seen


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_retries_match_jax(retry_inputs, monkeypatch, dtype):
    model, params, sst, maps = retry_inputs
    j_out = JBatched(model, params, sst, j_config.OUTLIER_THRESH,
                     dtype=getattr(jnp, dtype)).resquiggle_batch(maps)
    t_params, t_maps = _convert(params, maps)
    t_model = convert.kmer_model(model.means, model.sds, model.central_pos,
                                 model.name, "DNA")
    seen = _record_bands(monkeypatch, TBatched)
    t_out = TBatched(t_model, t_params, convert.seq_samp_type("DNA", False),
                     j_config.OUTLIER_THRESH, dtype=dtype,
                     device="cpu").resquiggle_batch(t_maps)
    # both retries ran: the start retry at the save start band, and the
    # save-bandwidth batch, which takes its reads through the adaptive DP
    assert ("start", params.bandwidth, params.start_save_bw) in seen
    save_bw = j_config.load_resquiggle_parameters(
        "DNA", use_save_bandwidth=True).bandwidth
    assert ("adaptive", save_bw) in seen
    assert all(res is not None for res, _ in t_out)
    if dtype == "float64":
        assert _assert_f64_exact(j_out, t_out) == len(maps)
    else:
        for j, t in zip(j_out, t_out):
            _assert_f32_close(*j, *t, same_start=True)


def test_save_bandwidth_retry_chunked_matches_jax(retry_inputs, monkeypatch):
    """The save-bandwidth batch through the row-chunked DP: with the
    per-read cap below one read's moves at bw 1500 but above those of the
    main and start bands, only the retry routes chunked, and the result
    stays exact at float64."""
    model, params, sst, maps = retry_inputs
    j_out = JBatched(model, params, sst, j_config.OUTLIER_THRESH,
                     dtype=jnp.float64).resquiggle_batch(maps)
    t_params, t_maps = _convert(params, maps)
    t_model = convert.kmer_model(model.means, model.sds, model.central_pos,
                                 model.name, "DNA")
    save_bw = j_config.load_resquiggle_parameters(
        "DNA", use_save_bandwidth=True).bandwidth
    monkeypatch.setattr(t_bdp, "PER_READ_MOVE_CAP", 1024 * save_bw - 1)
    layouts = set()
    plan = t_bdp.plan_dp_layout

    def plan_rec(n_rows, bw):
        layouts.add((bw, plan(n_rows, bw)[0]))
        return plan(n_rows, bw)

    monkeypatch.setattr(t_bdp, "plan_dp_layout", plan_rec)
    t_out = TBatched(t_model, t_params, convert.seq_samp_type("DNA", False),
                     j_config.OUTLIER_THRESH, dtype="float64",
                     device="cpu").resquiggle_batch(t_maps)
    assert layouts == {(params.bandwidth, "fused"), (save_bw, "chunked")}
    assert _assert_f64_exact(j_out, t_out) == len(maps)
