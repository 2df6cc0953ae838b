"""Everything the benchmark takes from the program under test, the
PyTorch and CUDA package ``tombo_tpu_torch``: its aligner and mapping,
its ``BatchedResquiggler`` (the timed path), its stage profile and its
kernel wrappers (wrapped here, during a traced slice, to record each
launch's work)."""
from __future__ import annotations

import contextlib
import dataclasses
from typing import List

import numpy as np

from perfbench.lib import roofline


@dataclasses.dataclass
class Program:
    """The program's objects for one configuration."""
    config: dict
    model: object        # the program's k-mer model
    params: object       # its ResquiggleParams, as the configuration sets
    sst: object          # its sample type


def load(cfg: dict) -> Program:
    from tombo_tpu_torch import config as pconfig
    from tombo_tpu_torch.io.model_io import KmerModel
    from tombo_tpu_torch.types import SeqSampleType
    st = cfg["sample_type"]
    p = cfg["parameters"]
    params = pconfig.load_resquiggle_parameters(st).replace(
        match_evalue=p["match_evalue"], skip_pen=p["skip_pen"],
        bandwidth=p["bandwidth"], max_half_z_score=p["max_half_z_score"],
        running_stat_width=p["running_stat_width"],
        min_obs_per_base=p["min_obs_per_base"],
        raw_min_obs_per_base=p["raw_min_obs_per_base"],
        mean_obs_per_event=p["mean_obs_per_event"],
        z_shift=pconfig.HALF_NORM_EXPECTED_VAL + p["match_evalue"],
        stay_pen=p["match_evalue"], use_t_test_seg=p["use_t_test_seg"],
        band_bound_thresh=p["band_bound_thresh"], start_bw=p["start_bw"],
        start_save_bw=p["start_save_bw"], start_n_bases=p["start_n_bases"])
    return Program(cfg, KmerModel.load_default(st), params,
                   SeqSampleType(st, st == "RNA"))


def map_reads(prog: Program, reads, ref: str) -> list:
    """Each simulated read mapped by the program: its exact aligner over
    the reference, ``map_read`` and ``adjust_map_res`` (RNA: the signal
    turned 5' to 3', stalls found)."""
    from tombo_tpu_torch.io.fasta import Fasta
    from tombo_tpu_torch.pipeline import resquiggle as rsq
    from tombo_tpu_torch.pipeline.aligner import ExactAligner
    from tombo_tpu_torch.types import SequenceData
    aligner = ExactAligner(Fasta(seqs={"ref": ref}))
    out = []
    for r in reads:
        mr = rsq.map_read(SequenceData(r.seq, r.read_id, 12.0), aligner,
                          prog.model, prog.sst)
        mr = mr.replace(raw_signal=r.raw.astype(np.float64))
        out.append(rsq.adjust_map_res(mr, prog.sst, prog.params))
    return out


def resquiggler(prog: Program, device: str, profile=None):
    """The timed path: the batched re-squiggle at float32 with the
    default finalize lanes."""
    import torch
    from tombo_tpu_torch.pipeline.batch import BatchedResquiggler
    return BatchedResquiggler(
        prog.model, prog.params, prog.sst,
        outlier_thresh=prog.config["parameters"]["outlier_thresh"],
        dtype=torch.float32, device=device, profile=profile)


def timed_class():
    """The class whose methods the timed path runs (where the check's
    tests plant their faults)."""
    from tombo_tpu_torch.pipeline.batch import BatchedResquiggler
    return BatchedResquiggler


def new_profile():
    from tombo_tpu_torch.pipeline.batch import StageProfile
    return StageProfile()


def result_fields(res) -> dict:
    """What the check compares of one read's result."""
    return {"start": int(res.read_start_rel_to_raw),
            "segs": np.asarray(res.segs, np.int64),
            "shift": float(res.scale_values.shift),
            "scale": float(res.scale_values.scale),
            "score": float(res.sig_match_score)}


@contextlib.contextmanager
def record_launches(launches: List[dict]):
    """Wrap the kernel wrappers (K1 and the chunked pair in
    ``ops/banded_dp.py``, K5 in ``ops/rescale.py``) so that each call on
    a card appends its shapes to ``launches``; the rows each read needs
    are read after the block, so the wrapping adds no synchronisation."""
    from tombo_tpu_torch.ops import banded_dp, rescale
    fused, chunked = (banded_dp.adaptive_banded_dp_tb,
                      banded_dp.adaptive_banded_dp_tb_chunked)
    count = rescale.count_le
    pending = []

    def wrap_dp(fn, is_chunked):
        def wrapper(*a, **kw):
            if a[0].device.type == "cuda":
                rec = roofline.record_dp(a, is_chunked, lazy=True)
                pending.append(rec)
            return fn(*a, **kw)
        return wrapper

    def wrap_count(keys, pivots):
        if keys.device.type == "cuda":
            launches.append(roofline.record_count_le(keys, pivots))
        return count(keys, pivots)

    banded_dp.adaptive_banded_dp_tb = wrap_dp(fused, False)
    banded_dp.adaptive_banded_dp_tb_chunked = wrap_dp(chunked, True)
    rescale.count_le = wrap_count
    try:
        yield
    finally:
        banded_dp.adaptive_banded_dp_tb = fused
        banded_dp.adaptive_banded_dp_tb_chunked = chunked
        rescale.count_le = count
        for rec in pending:
            if not isinstance(rec["rows"], list):
                rec["rows"] = [int(x) for x in rec["rows"].cpu().tolist()]
            launches.append(rec)
