"""Read-sharded re-squiggle over several devices (counterpart of
``tombo_tpu/parallel/mesh.py``).

The work is data parallel over reads, the reference's read-level process
pool (tombo/resquiggle.py:1859-1948) across cards: a 1-D ``reads`` mesh is
a tuple of devices, and a batch splits into contiguous shards of reads in
read order, one per mesh device.  Unlike the JAX mesh nothing is padded:
the CUDA kernels take any batch size, so shards differ by at most one read
and may be empty.  A device may repeat (two shards on one card, or
``["cpu"] * n`` on the CPU), which is how one card or the CPU exercises
the sharded lane.

The mesh lane's invariant is identity with its own 1-device lane, read
for read and bit for bit, on the card as on the CPU: every stage runs a
shard at the shapes of its whole length group, and no reduction's order
depends on how many reads a shard holds (the fit's score sums in an
order fixed by the read length, ``ops/precision.py::row_sums``).

The JAX package's multi-device dry runs are here too:
:func:`full_sharded_step`, :func:`sharded_production_step` and
:func:`dryrun`, which also runs :func:`production_lane_dryrun` and
``distributed.psum_collective_dryrun``; their per-site sums add the
shards' parts in mesh order (:func:`replicate_sum`).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_mesh

READS_AXIS = "reads"

Mesh = Tuple[torch.device, ...]


def make_mesh(devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """1-D reads mesh over the given devices, or over every visible CUDA
    card; raises without a card unless CPU devices are given."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass CPU devices to run the "
                "sharded lane on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return resolve_mesh(devices)


def shard_sizes(n: int, mesh: Sequence) -> List[int]:
    """Reads per shard for a batch of ``n``: contiguous in read order,
    sizes differing by at most one, the larger shards first."""
    base, extra = divmod(n, len(mesh))
    return [base + (i < extra) for i in range(len(mesh))]


def shard_batch(mesh: Mesh, *arrays) -> List[Tuple[torch.Tensor, ...]]:
    """Split the batch axis of every array over the mesh: one tuple of
    tensors per mesh device, each moved to that device (an empty shard's
    tensors have no rows)."""
    ts = [torch.as_tensor(a) for a in arrays]
    n = ts[0].shape[0]
    if any(t.shape[0] != n for t in ts):
        raise ValueError("shard_batch: arrays differ in batch size")
    out, k = [], 0
    for dev, m in zip(mesh, shard_sizes(n, mesh)):
        out.append(tuple(t[k:k + m].to(dev) for t in ts))
        k += m
    return out


def gather(mesh: Mesh, shards: Sequence[torch.Tensor]) -> torch.Tensor:
    """The shards' tensors concatenated on ``mesh[0]`` in read order."""
    return torch.cat([s.to(mesh[0]) for s in shards])


# float32 lanes that differ only in how they round (the card against the
# CPU): co-optimal DP ties flip up to 1% of boundaries, fitted scale
# values agree to 2e-3 of the scale and scores to 1e-2
# (tests/test_batch_parity.py)
F32_TOLERANCE = {"segs": 0.99, "shift": 2e-3, "scale": 2e-3, "score": 1e-2}


def lane_differences(out_a, out_b, exact: bool):
    """The reads whose results differ between two runs of one batch, as
    (read index, {"segs": fraction equal, "start": samples, "shift",
    "scale": relative to the scale, "score": absolute}).  Raises if a
    read fails in one run and not the other or with another error, and
    if a result differs at all when ``exact``, else beyond
    :data:`F32_TOLERANCE` or in its start or table length."""
    if len(out_a) != len(out_b):
        raise AssertionError("runs differ in length: %d against %d" % (
            len(out_a), len(out_b)))
    diffs = []
    for i, ((a, ea), (b, eb)) in enumerate(zip(out_a, out_b)):
        if ea != eb:
            raise AssertionError("read %d: error %r against %r" % (i, ea, eb))
        if a is None:
            continue
        sc = b.scale_values.scale
        same_len = a.segs.shape == b.segs.shape
        d = {"segs": float(np.mean(a.segs == b.segs)) if same_len else 0.0,
             "start": abs(a.read_start_rel_to_raw - b.read_start_rel_to_raw),
             "shift": abs(a.scale_values.shift - b.scale_values.shift) / sc,
             "scale": abs(a.scale_values.scale - sc) / sc,
             "score": abs(a.sig_match_score - b.sig_match_score)}
        if d == {"segs": 1.0, "start": 0, "shift": 0.0, "scale": 0.0,
                 "score": 0.0}:
            continue
        diffs.append((i, d))
        tol = F32_TOLERANCE
        if exact or not (same_len and d["start"] == 0 and
                         d["segs"] > tol["segs"] and
                         d["shift"] < tol["shift"] and
                         d["scale"] < tol["scale"] and
                         d["score"] < tol["score"]):
            raise AssertionError("read %d differs between the runs: %s" % (
                i, d))
    return diffs


def production_lane_dryrun(mesh: Sequence[DeviceLike], n_reads: int = 0,
                           read_len: int = 650):
    """Run the production lane, ``BatchedResquiggler.resquiggle_batch``,
    over ``mesh`` on simulated DNA reads (the recipe of the JAX package's
    ``production_lane_dryrun``), then the same reads through the 1-device
    lane on ``mesh[0]``.  Every read must succeed in the mesh lane, and
    the two lanes must agree read for read and bit for bit (float64 on
    CPU devices, float32 on the card).  Returns the differing reads
    (:func:`lane_differences`), which is empty or raises."""
    from .. import config
    from ..io.model_io import KmerModel
    from ..pipeline import resquiggle as rsq
    from ..pipeline.aligner import ExactAligner
    from ..pipeline.batch import BatchedResquiggler
    from ..testing import random_reference, simulate_read
    from ..types import SeqSampleType, SequenceData

    mesh = resolve_mesh(mesh)
    n_reads = n_reads or 2 * len(mesh)
    rng = np.random.default_rng(11)
    model = KmerModel.load_default(config.DNA_SAMP_TYPE)
    fasta = random_reference(np.random.default_rng(12), 30000)
    aligner = ExactAligner(fasta)
    sst = SeqSampleType(config.DNA_SAMP_TYPE, False)
    params = config.load_resquiggle_parameters(config.DNA_SAMP_TYPE)
    map_results = []
    for i in range(n_reads):
        read = simulate_read(rng, fasta, model, read_id="dry_%03d" % i,
                             read_len=read_len)
        mr = rsq.map_read(SequenceData(read.seq, read.read_id, 12.0),
                          aligner, model, sst)
        map_results.append(rsq.adjust_map_res(
            mr.replace(raw_signal=read.raw_signal), sst, params))

    dtype = "float64" if mesh[0].type == "cpu" else "float32"
    out = BatchedResquiggler(model, params, sst, config.OUTLIER_THRESH,
                             dtype=dtype, mesh=mesh
                             ).resquiggle_batch(map_results)
    for i, (res, err) in enumerate(out):
        if err is not None:
            raise AssertionError("mesh lane, read %d: %s" % (i, err))
        if res.segs.shape[0] != len(res.genome_seq) + 1:
            raise AssertionError("mesh lane, read %d: malformed segments" %
                                 i)
    out1 = BatchedResquiggler(model, params, sst, config.OUTLIER_THRESH,
                              dtype=dtype, device=mesh[0]
                              ).resquiggle_batch(map_results)
    return lane_differences(out, out1, exact=True)


def replicate_sum(mesh: Mesh, parts: Sequence[torch.Tensor]):
    """The element-wise sum of one tensor per mesh device, added in mesh
    order on ``mesh[0]`` (so float totals do not depend on timing) and
    copied to every mesh device: one replica per device, in mesh order
    (the port's form of a ``psum`` over the reads axis)."""
    total = parts[0].to(mesh[0])
    for p in parts[1:]:
        total = total + p.to(mesh[0])
    return tuple(total.to(d) for d in mesh)


def full_sharded_step(mesh: Sequence[DeviceLike], dp_params,
                      outlier_thresh: float, running_stat_width: int,
                      n_rows: int, prefix_rows: int):
    """One device pass over a read batch sharded on the reads axis
    (counterpart of ``tombo_tpu/parallel/mesh.py::full_sharded_step``):
    per shard, on its device, median/MAD normalization, changepoint
    scores and the event means of the given segments; the adaptive DP
    and traceback of every shard through K3 (band bound threshold -1,
    :func:`ops.banded_dp.plan_dp_layout`'s layout for ``n_rows``); and
    the per-site accumulator merge, the shards' ``site_bins`` column
    sums added in mesh order (:func:`replicate_sum`).

    Returns a function of (raw, sig_lens, segs, n_segs, ref_means,
    ref_sds, seq_lens, prefix_starts, prefix_valid, prefix_end,
    start_rows, site_bins), arrays or tensors on any device, returning
    (scores, segs_tb, site_cov): scores and segs_tb gathered in read
    order on ``mesh[0]``, site_cov one replica per mesh device."""
    from ..ops import banded_dp
    from ..ops import normalize as nrm
    from ..ops import segment as seg
    mesh = resolve_mesh(mesh)
    layout = banded_dp.plan_dp_layout(n_rows, dp_params.bandwidth)

    def step(raw, sig_lens, segs, n_segs, ref_means, ref_sds, seq_lens,
             prefix_starts, prefix_valid, prefix_end, start_rows,
             site_bins):
        scores, dp_args, covs = [], [], []
        for sh in shard_batch(mesh, raw, sig_lens, segs, n_segs, ref_means,
                              ref_sds, seq_lens, prefix_starts, prefix_valid,
                              prefix_end, start_rows, site_bins):
            (raw_s, sl_s, segs_s, ns_s, rm_s, rs_s, seq_s, ps_s, pv_s, pe_s,
             sr_s, bins_s) = sh
            covs.append(bins_s.sum(0))
            if raw_s.shape[0] == 0:
                dp_args.append(None)
                continue
            norm = nrm.normalize_median_batch(raw_s, sl_s, outlier_thresh)[0]
            scores.append(seg.cpt_scores_diff_batch(norm, sl_s,
                                                    running_stat_width))
            em = nrm.compute_base_means_batch(norm, segs_s, ns_s)
            dp_args.append((em, ns_s, rm_s, rs_s, seq_s, ps_s, pv_s, pe_s,
                            sr_s))
        segs_tb = banded_dp.adaptive_banded_dp_tb_sharded(
            mesh, dp_args, dp_params, n_rows, prefix_rows, -1, layout)[0]
        return gather(mesh, scores), segs_tb, replicate_sum(mesh, covs)
    return step


def sharded_production_step(mesh: Sequence[DeviceLike],
                            n_reads_per_device: int = 2,
                            sig_len: int = 1024, n_rows: int = 64,
                            bandwidth: int = 32):
    """The production lane's device stages over a batch sharded on the
    reads axis (the recipe of ``tombo_tpu/parallel/mesh.py``
    ``sharded_production_step``, its random inputs from
    ``np.random.default_rng(0)`` in the same order): per shard, stage A
    (``pipeline/batch.py::_stage_a_dna``: normalize, changepoint scores,
    greedy selection, event means, the start DP through K4), then the
    adaptive DP and traceback of every shard through K3, and the
    coverage of the boundaries over events 0..E, each shard's count
    added in mesh order (:func:`replicate_sum`).  The signal is float32
    on the card, as in the JAX recipe, and float64 on CPU devices (the
    parity mode).  Returns (event means (B, E) and segs (B, n_rows + 1),
    gathered in read order on ``mesh[0]``, coverage (E + 1,) one replica
    per mesh device)."""
    from ..ops import banded_dp
    from ..ops.dp import DpParams, StartDpParams
    from ..pipeline.batch import _stage_a_dna
    mesh = resolve_mesh(mesh)
    dtype = torch.float64 if mesh[0].type == "cpu" else torch.float32
    B = len(mesh) * n_reads_per_device
    rng = np.random.default_rng(0)
    raw = rng.normal(450.0, 60.0, (B, sig_len)).astype(np.float32)
    num_cpts = np.full(B, n_rows * 4, np.int64)
    nb = 8
    rm_start = rng.normal(0, 1, (B, nb)).astype(np.float32)
    rs_start = np.full((B, nb), 0.35, np.float32)
    sp = StartDpParams(z_shift=5.0, skip_pen=4.2, stay_pen=4.2,
                       max_half_z_score=20.0, num_bases=nb,
                       num_events=bandwidth)
    f = lambda a: torch.as_tensor(a).to(dtype)
    a_shards = shard_batch(
        mesh, f(raw), np.full(B, sig_len, np.int64), np.zeros(B, bool),
        f(np.zeros(B, np.float32)), f(np.ones(B, np.float32)),
        f(np.full(B, -1e30, np.float32)), f(np.full(B, 1e30, np.float32)),
        num_cpts, f(rm_start), f(rs_start))
    ems = [_stage_a_dna(*a, 5.0, 5, 3, n_rows * 4 + 1, sp)[1] if
           a[0].shape[0] else None for a in a_shards]

    E = next(em for em in ems if em is not None).shape[1]
    L, P = n_rows, 8
    dpp = DpParams(z_shift=5.0, skip_pen=4.2, stay_pen=4.2,
                   mask_fill_z_score=-15.0, max_half_z_score=20.0,
                   bandwidth=bandwidth)
    rm = rng.normal(0, 1, (B, L)).astype(np.float32)
    rs = np.full((B, L), 0.35, np.float32)
    rest = shard_batch(
        mesh, np.full(B, E, np.int32), f(rm), f(rs), np.full(B, L, np.int32),
        np.tile(np.arange(P, dtype=np.int32) * 2, (B, 1)),
        np.zeros(B, np.int32), np.full((B, P), 2 ** 31 - 1, np.int64),
        np.full(B, P, np.int32))
    dp_args = [None if em is None else (em,) + r for em, r in zip(ems, rest)]
    segs = banded_dp.adaptive_banded_dp_tb_sharded(
        mesh, dp_args, dpp, L, P, -1, banded_dp.plan_dp_layout(L, bandwidth)
    )[0]
    covs, k = [], 0
    for dev, m in zip(mesh, shard_sizes(B, mesh)):
        s = segs[k:k + m].to(dev).long().clamp(0, E)
        covs.append(torch.bincount(s.reshape(-1), minlength=E + 1))
        k += m
    em = gather(mesh, [e for e in ems if e is not None])
    return em, segs, replicate_sum(mesh, covs)


def dryrun_inputs(n_devices: int, bandwidth: int = 16, n_rows: int = 32,
                  prefix_rows: int = 4, sig_len: int = 256):
    """The tiny batch of the JAX package's ``dryrun`` (two reads a device,
    from ``np.random.default_rng(0)``): the twelve arrays that
    :func:`full_sharded_step`'s function takes, numpy, and its DP
    parameters."""
    from ..ops.dp import DpParams
    B = 2 * n_devices
    rng = np.random.default_rng(0)
    E = n_rows * 4
    raw = rng.normal(450.0, 60.0, (B, sig_len)).astype(np.float32)
    arrays = (
        raw, np.full(B, sig_len, np.int32),
        np.tile(np.linspace(0, sig_len, E + 1).astype(np.int32), (B, 1)),
        np.full(B, E, np.int32),
        rng.normal(0, 1, (B, n_rows)).astype(np.float32),
        np.full((B, n_rows), 0.35, np.float32), np.full(B, n_rows, np.int32),
        np.tile(np.arange(prefix_rows, dtype=np.int32) * 2, (B, 1)),
        np.zeros(B, np.int32), np.full((B, prefix_rows), 2 ** 31 - 1,
                                       np.int64),
        np.full(B, prefix_rows, np.int32),
        rng.integers(0, 3, (B, 64)).astype(np.int32))
    params = DpParams(z_shift=5.0, skip_pen=4.2, stay_pen=4.2,
                      mask_fill_z_score=-15.0, max_half_z_score=20.0,
                      bandwidth=bandwidth)
    return arrays, params


def dryrun(n_devices: int, devices: Optional[Sequence[DeviceLike]] = None,
           bandwidth: int = 16, n_rows: int = 32, prefix_rows: int = 4,
           sig_len: int = 256):
    """The JAX package's multi-device dry run (``tombo_tpu/parallel/
    mesh.py::dryrun``) over a reads mesh of ``n_devices`` shards: the
    first ``n_devices`` of ``devices`` (default every visible card),
    repeated in turn where there are fewer (two shards on one card, or
    ``["cpu"]`` for ``n_devices`` CPU shards).  Runs
    :func:`full_sharded_step` on :func:`dryrun_inputs`,
    :func:`sharded_production_step`, :func:`production_lane_dryrun` and
    ``parallel/distributed.py::psum_collective_dryrun``, checking each
    one's shapes.  Returns {"full_sharded_step": (scores, segs_tb,
    site_cov), "production_step": (em, segs, cov), "lane_differences":
    [...], "psum_total": int}."""
    from .distributed import psum_collective_dryrun
    devs = make_mesh(devices)
    mesh = tuple(devs[i % len(devs)] for i in range(n_devices))
    arrays, params = dryrun_inputs(n_devices, bandwidth, n_rows,
                                   prefix_rows, sig_len)
    B = arrays[0].shape[0]
    full = full_sharded_step(mesh, params, 5.0, 5, n_rows, prefix_rows)(
        *arrays)
    if (full[1].shape != (B, n_rows + 1) or
            any(c.shape != (64,) for c in full[2])):
        raise AssertionError("full_sharded_step: segs %s, site_cov %s" % (
            tuple(full[1].shape), [tuple(c.shape) for c in full[2]]))
    prod = sharded_production_step(mesh)
    if prod[1].shape != (2 * n_devices, 65):
        raise AssertionError("sharded_production_step: segs %s" % (
            tuple(prod[1].shape),))
    diffs = production_lane_dryrun(mesh)
    total = psum_collective_dryrun(mesh)
    return {"full_sharded_step": full, "production_step": prod,
            "lane_differences": diffs, "psum_total": total}
