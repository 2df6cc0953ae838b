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
