"""Mixed-length batches through the port on the CPU against the JAX
package: the same signal-length groups, and float64 results bit for bit
(the bar of tests/test_torch_batch.py), with each group's adaptive DP on
the fused layout and again with the longest reads routed through the
chunked pair's plain version."""
import types

import numpy as np
import pytest
import jax.numpy as jnp

from tombo_tpu import config as j_config
from tombo_tpu import testing as j_testing
from tombo_tpu.io.model_io import KmerModel as JKmerModel
from tombo_tpu.pipeline import batch as j_batch
from tombo_tpu.pipeline import resquiggle as j_rsq
from tombo_tpu.pipeline.aligner import ExactAligner as JExactAligner
from tombo_tpu.types import SeqSampleType as JSeqSampleType
from tombo_tpu.types import SequenceData as JSequenceData
from tombo_tpu_torch import convert
from tombo_tpu_torch.ops import banded_dp as t_bdp
from tombo_tpu_torch.pipeline import batch as t_batch

from test_torch_batch import _assert_f64_exact, _convert

# bench.py's mixed-length recipe: log-normal read lengths, median ~2.7 kb
MIXED_MEDIAN_LOG, MIXED_SIGMA_LOG = 7.9, 0.85


@pytest.mark.parametrize("n_reads,seed", [(200, 0), (211, 1), (47, 2),
                                          (48, 3)])
def test_length_groups_match_jax(n_reads, seed):
    rng = np.random.default_rng(seed)
    bases = np.clip(np.exp(rng.normal(MIXED_MEDIAN_LOG, MIXED_SIGMA_LOG,
                                      n_reads)), 600, 30000).astype(int)
    states = [types.SimpleNamespace(raw=np.empty(int(n) * 7, np.int8),
                                    raw_dev=None, i=i)
              for i, n in enumerate(bases)]
    j_groups = [[s.i for s in g] for g in j_batch._length_groups(states)]
    t_groups = [[s.i for s in g] for g in t_batch._length_groups(states)]
    assert t_groups == j_groups
    assert sum(map(len, t_groups)) == n_reads
    if n_reads >= 2 * t_batch._MIN_GROUP:
        assert len(t_groups) > 1


READ_LENS = (400, 520, 1100, 1300, 2500, 3000)


@pytest.fixture(scope="module")
def mixed_inputs():
    """tests/test_torch_batch.py's recipe with one length per read."""
    rng = np.random.default_rng(41)
    model = JKmerModel.load_default("DNA")
    fasta = j_testing.random_reference(np.random.default_rng(42), 30000)
    aligner = JExactAligner(fasta)
    sst = JSeqSampleType("DNA", False)
    params = j_config.load_resquiggle_parameters("DNA")
    maps = []
    for i, n in enumerate(READ_LENS):
        read = j_testing.simulate_read(rng, fasta, model, read_len=n,
                                       read_id="m_%03d" % i)
        mr = j_rsq.map_read(JSequenceData(read.seq, read.read_id, 12.0),
                            aligner, model, sst)
        maps.append(j_rsq.adjust_map_res(
            mr.replace(raw_signal=read.raw_signal), sst, params))
    t_model = convert.kmer_model(model.means, model.sds, model.central_pos,
                                 model.name, "DNA")
    t_params, t_maps = _convert(params, maps)
    return (model, params, sst, maps), (t_model, t_params, t_maps)


def _port(t_model, t_params):
    return t_batch.BatchedResquiggler(
        t_model, t_params, convert.seq_samp_type("DNA", False),
        j_config.OUTLIER_THRESH, dtype="float64", device="cpu")


def test_mixed_batch_f64_exact_fused_and_chunked(mixed_inputs, monkeypatch):
    (model, params, sst, maps), (t_model, t_params, t_maps) = mixed_inputs
    monkeypatch.setattr(j_batch, "_MIN_GROUP", 2)
    monkeypatch.setattr(t_batch, "_MIN_GROUP", 2)
    groups = t_batch._length_groups(
        [types.SimpleNamespace(raw=m.raw_signal) for m in t_maps])
    assert len(groups) >= 3, [len(g) for g in groups]

    j_out = j_batch.BatchedResquiggler(
        model, params, sst, j_config.OUTLIER_THRESH,
        dtype=jnp.float64).resquiggle_batch(maps)

    layouts = []
    plan = t_bdp.plan_dp_layout

    def plan_rec(n_rows, bw):
        layouts.append((n_rows, bw, plan(n_rows, bw)[0]))
        return plan(n_rows, bw)

    monkeypatch.setattr(t_bdp, "plan_dp_layout", plan_rec)
    t_out = _port(t_model, t_params).resquiggle_batch(t_maps)
    assert {lay for _, _, lay in layouts} == {"fused"}
    assert _assert_f64_exact(j_out, t_out) == len(READ_LENS)

    # a per-read cap below the longest group's moves: that group runs the
    # chunked plain version, the others stay fused
    longest = max(n for n, _, _ in layouts)
    monkeypatch.setattr(t_bdp, "PER_READ_MOVE_CAP",
                        longest * t_params.bandwidth - 1)
    layouts.clear()
    t_out_chunked = _port(t_model, t_params).resquiggle_batch(t_maps)
    assert {lay for _, _, lay in layouts} == {"fused", "chunked"}
    assert all(lay == "chunked" for n, _, lay in layouts if n == longest)
    assert _assert_f64_exact(j_out, t_out_chunked) == len(READ_LENS)
