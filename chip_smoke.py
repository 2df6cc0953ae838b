"""Card smoke run of the PyTorch/CUDA port (tombo_tpu_torch).

    python3 chip_smoke.py
    python3 chip_smoke.py --plain-rows

Needs one CUDA card and nvcc (CUDA_HOME, default /usr/local/cuda).  It
builds the port's kernels from tombo_tpu_torch/csrc/ and drives four paths
of batched re-squiggle through ``BatchedResquiggler.resquiggle_batches``,
the DNA ones at the default DNA configuration (bandwidth 300, start band
750/2500, save bandwidth 1500, 3 scaling iterations), the RNA one at the
default RNA configuration (t-test segmentation, stall removal,
event-based scale; bandwidth 500, start band 1000/3000, save bandwidth
1500, 3 scaling iterations):

  1 kb path     3 x 512 simulated 1000-base reads (fused DP only);
  mixed path    2 x 512 reads of log-normal lengths, 600 to 30,000 bases
                (bench.py's mixed recipe): length groups, long groups on
                the row-chunked DP pair;
  RNA path      2 x 512 simulated direct-RNA reads of 1,700 bases (mean
                dwell 12, reversed signal, adapters of 600-900 samples),
                one in eight with a pore stall of 2,000-4,000 samples;
  level path    3 x 512 1 kb DNA reads on a 3,000-base reference (batch
                1 the control, batches 2-3 the sample), for the level
                tests of detection;
  mesh lane     ``BatchedResquiggler(mesh=...)`` over every visible card
                (two shards on one card when there is one), on one batch
                of each path: every group's adaptive DP through the
                read-sharded launcher (K3), every read bitwise the 1-device
                lane's.

The stage profile phase, after the mixed path, runs one full batch of
the 1 kb and of the mixed path through their warm resquigglers without
and with the package's ``StageProfile`` in turns (off, on, on, off):
every result bitwise the first run's, the keys within the float32 set
(``PROFILE_KEYS_F32``; ``start_fetch`` too where a start retry ran) and
together all of it, the six stages 0.85 to 1.02 of each profiled
batch's wall; it prints the table, the MB each way and the on/off wall
ratio.  One 1 kb batch then runs through ``resquiggle_batches(...,
trace_dir=)`` into a temporary directory: its results bitwise, the
trace's ``banded_dp_kernel`` and ``count_le_kernel`` events as many as
the launches K1 and K5 counted during the call, and the six stage
ranges in it.

The host lane and the raw wire: after each path's breakdown (1 kb, mixed,
RNA), one batch with a ``StageProfile`` prints the reads the float32 host
lane finished in one ``native.finalize_batch`` call a group and pass, the
``finalize_native`` seconds and the MB each way (``host lane`` lines; a
host-lane read without ``finalize_native`` fails, here and in the stage
profile phase); for one 1 kb and one mixed batch, every length group's
raw matrix goes up through the int8-delta wire and dense, and the two
float32 matrices on the card must be bitwise equal (``raw wire`` lines:
MB and seconds of each).

The lanes phase, after the three re-squiggle paths, runs one batch of
each path through each non-default finalize lane
(``pipeline/batch.py::FinalizeLanes``, ``LANES``: the JAX package's
alternative finalize lanes: the fit on the adaptive pass gated by the
deletion rate or forced, no device fit, the host traceback trim, the
Python host lane, and its fit on the card in blocks of 64 reads), each
in a fresh resquiggler with the launch counts zeroed just before it:
its results held to the default lane's (at most ``LANES_OUTSIDE`` of the
reads may differ: another error, start or table length, or outside
tests/test_batch_parity.py's bars; each that does runs again through the
same lane on the CPU, and the card's result must lie within the bars of
that run), the count kernel launched exactly where the lane fits on the
card, one ``lanes`` line a lane.  K5 at the blocks' shape (64 reads of
1,000 points) is held bitwise against its plain version and timed; its
row joins the kernels line.

The one-read phase, after the lanes phase, drives the
one-read API (``pipeline/resquiggle.py::resquiggle_read_with_retries``,
start discovery through K4, the adaptive DP through K1 or the chunked
pair, the fit through K5, each at a batch of one) over 64 reads of the
1 kb path's first batch, 8 of the mixed path (the longest, the shortest
that takes the host library's static band, and reads between) and 16 of
the RNA path's first batch (two with a stall).  Each read is held
against the batched lane's card result, 16 against the same function on
the CPU at float64, and the DNA reads of at most 1,000 bases against the
native single-core baseline (``native.py``), with
tests/test_batch_parity.py's bars: every read succeeds or fails in both,
and the same start and table length.  Against the batched lane at most
ONE_READ_BATCHED_OUTSIDE of the reads may lie outside the bars (the JAX
package's own one-read path falls outside them against the float32
batched lane on a few reads in a hundred), each within the looser
ONE_READ_LOOSE_BARS; the other two comparisons allow none.  It prints the
one-read reads/s of each path and the baseline's, the kernels at their
batch-of-one shapes, ``compute_base_mean_stds_batch`` on the card
against the CPU, and the static band's seconds in the mixed and RNA
breakdowns.  The host library builds with g++ beside the kernels in
phase "build".

The debug_dp phase, after the one-read phase, runs 6 1 kb reads, the
longest mixed read (30,000 bases, the chunked layout) and 2 RNA reads
through ``resquiggle_read_with_retries(..., debug_dp_dir=...)``: each
result bitwise the same read's without the dump, each file with the JAX
package's entries, dtypes and shapes, the dumped rows against the plain
version on CPU copies of the same float32 inputs (forward values within
1e-3, codes on 99.5% of the in-band cells, band starts exact; the long
read's first 2,048 rows), and the row-writing instances of K1 and K2'
timed against the normal ones in turns.  The mesh_dryrun phase, after
the mesh lane, runs ``parallel/mesh.py::dryrun(2)`` (two shards on the
one card), holds ``full_sharded_step`` over the two shards bitwise
against one unsharded call, and runs ``psum_hosts_device`` over a
one-process NCCL group in a spawned process (one card allows no second
rank): the group forms and one all-gather per array goes through on the
card, whose totals at one rank are the inputs.

Detection runs on the card from the device means re-squiggle registered:
de novo (1 kb, mixed, RNA), sample-compare (1 kb), the alternative-model
test (five DNA models and RNA 5mC), per-read statistics (each block
aggregated without a file and held to its region's statistics) and the
level tests (KS, U, t on the level path), each run again on the CPU at
float32 and float64 from the same means.  Model estimation follows from
the same means: the canonical 6-mer DNA model with its re-centring fit
over the 1 kb path's reads (K5), a motif model (the first bundled motif
the coverage allows), the density model of an alternative sample (3 x
512 1 kb reads, C-containing 6-mers raised by 1.0, re-squiggled here)
and the RNA 5-mer model with the RNA re-centring; site statistics,
tabulated means, corrections and densities again on CPU copies.

The multi-host phase, after the detection phases, runs detection over
two hosts: the 1 kb path's and the level path's reads (index records and
float32 device means) go to one .npz, and two processes spawned on the
one card meet over gloo on 127.0.0.1 (NCCL refuses two ranks on one
card).  Each registers every read's means on the card and runs de novo
and the 5mC alternative model with per-read blocks on the 1 kb reads
(each host its own reads, the counts merged by ``psum_hosts``), and
model_sample_compare and KS on the level path (KS: each host its own
regions) through ``iter_region_stats(..., dist=...)``.  Host 0's merged
statistics are held against this process's one-host run on the same
means (positions, coverage and fractions exactly, KS within
``LEVEL_F32_ABS_TOL``), every host's statistics against host 0's, and
the union of the hosts' per-read blocks, by read id, against the
one-host blocks.  It prints each process's wall time, its time in
``psum_hosts`` and the regions (KS) or reads it owned; a host that
fails, outlives ``MULTIHOST_TIMEOUT`` (it is killed) or writes nothing
fails the phase.

Text output, the index filters and preprocess are host work on FAST5
and HDF5 files, which need ``h5py``, which the card machine lacks; they
run no device code, and the CPU tests hold them against the JAX package
(tests/test_torch_text_output.py, test_torch_filters.py,
test_torch_preprocess.py).

The plots phase, after model estimation, computes the plot commands'
data on the card from the device means earlier phases left there and
holds each against the same function on CPU copies of the means (no
renderer runs: the card machine has no matplotlib): the ROC and
precision-recall rates of the C-raised alternative sample's de novo
statistics (labels by ground truth and by CpG motif; tp, fp and
precision arrays equal, AUC and mean AP within 1e-12), the rates of
5,000,000 pairs timed beside the host motif matching, the Ward-ordered
traces at the 1 kb de novo run's most significant regions (sample and
control, slide_span 0 and 3), the k-mer level lists and the
max-difference regions.  One ``plots`` JSON line gives each part's wall
seconds and equality flags, with the card's name and power limit.

The runner phase last drives the command line's path: the 1 kb and
mixed reads, given basecalls with 8% errors, go through
``pipeline/runner.py::resquiggle_all_reads`` over an in-memory read
source (the card machine has no h5py, so no FAST5 is written), mapped by
the native minimizer aligner and batched 64 at a time through the look-
ahead window.  Each read mapped as simulated is held against its direct
result (bitwise count and the batch-parity bars), 32 reads run again
through the runner on the CPU, and de novo detection from the runner's
index of the 1 kb reads is held against the direct path's.

Each path is driven with the launch counts set to 0 just before it and
read just after, and fails if a kernel of that path was not launched (or,
on the 1 kb path, if a chunked kernel was).  Every kernel is then held
against its plain PyTorch version on inputs captured from the paths (K1
at the DNA and the RNA widths), the chunked pair also against the fused
kernel bit for bit (at bw 300, 500 and 1500), K3 against both; some
reads of each path run again on the CPU for comparison, and the mesh
lane's reads against the 1-device lane's.  It prints per-phase wall
times, a per-layer breakdown of one batch of each path, one JSON line of
kernel summaries and a final status line.  Any failed phase exits
non-zero without the status line.

``--plain-rows`` runs none of this: it times, once each (host clock
around a synchronised call, tens of seconds a call), the plain versions
of the DP shapes whose plain time the default run leaves out, beside the
kernels' CUDA-event times on the same synthetic inputs
(:func:`synthetic_dp_args`): the chunked pair (K2 + K2') at the RNA
widths, 4 reads at bw 500 (L 32,768) and at bw 1,500 (L 8,192), the
fewest rows past the fused cap; and K3 over the chunked layout, 16
reads of L 32,768 at bw 300 in two shards on one card, the plain pair
run shard by shard.  One JSON line a shape, after the card line.
"""
import contextlib
import json
import math
import multiprocessing
import os
import pickle
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

# published H100 SXM peaks at the full 700 W limit (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12          # non-tensor float32; used for int32 too
K1_OPS_PER_CELL = 20           # f32 ops per active band cell and row
READ_LEN, BATCH, N_BATCHES, MEAN_DWELL = 1000, 512, 3, 7.0
REF_LEN_1KB = 60000            # the 1 kb path's reference
# bench.py's mixed-length recipe: log-normal read lengths (median ~2.7 kb)
# clipped to 600-30,000 bases, on a 120,000-base reference
MIXED_LOG_MEAN, MIXED_LOG_SD = 7.9, 0.85
MIXED_MIN_LEN, MIXED_MAX_LEN, MIXED_REF_LEN = 600, 30000, 120000
N_MIXED_BATCHES = 2
# tests/test_torch_rna.py's recipe, on a 60,000-base reference
RNA_LEN, RNA_DWELL, RNA_ADAPTER, RNA_REF_LEN = 1700, 12.0, (600, 900), 60000
RNA_STALL, RNA_STALL_EVERY = (2000, 4000), 8
N_RNA_BATCHES = 2
# the level path (level sample-compare): 3 x 512 1 kb DNA reads on a
# 3,000-base reference, batch 1 the control, batches 2-3 the sample
LEVEL_REF_LEN, N_LEVEL_BATCHES = 3000, 3
ALT_DNA = ["5mC", "6mA", "dcm", "dam", "CpG"]
LEVEL_TYPES = ["ks", "u", "t", "ks_stat", "u_stat", "t_stat"]
# level_sample_compare's --minimum-test-reads default
# (tombo_tpu/cli/main.py:620)
LEVEL_MIN_TEST_READS = 50
# the level statistics' bar, float32 (card or CPU) against the CPU's
# float64: four times the largest |float32 - float64| of the JAX
# package's float32 level lane on inputs of the level path's shapes
# (scripts/level_f32_tolerance.py, PERF.md)
LEVEL_F32_ABS_TOL = {"ks": 4e-6, "u": 2.3e-4, "t": 2.7e-3, "ks_stat": 2e-7,
                     "u_stat": 2.2e-4, "t_stat": 9e-6}
# model estimation (build_model) at the JAX CLI's defaults
# (tombo_tpu/cli/main.py:734-735, 774-779): minimum test reads and k-mer
# observations of the canonical and motif models (lowered, and printed,
# where the path's coverage leaves a key uncovered), the density model's
# k-mer observations, percentile and bandwidth; the bundled motifs in the
# order tried; the alternative sample (3 x 512 1 kb reads on the 1 kb
# path's reference, C-containing 6-mers raised by ALT_SHIFT); the reads
# of the float64 CPU re-centring cross-check
EST_MIN_TEST_READS, EST_MIN_KMER_OBS = 10, 5
ALT_KMER_OBS, ALT_PCTL, ALT_BW, ALT_SHIFT = 1000, 5, 0.05, 1.0
EST_MOTIFS = ["CG:1", "CCWGG:2", "GATC:2"]
N_ALT_BATCHES, EST_F64_READS = 3, 32
CHUNKED = ("banded_dp_chunked_fwd", "banded_dp_chunked_tb")
ROWS_INSTANCES = ("banded_dp_rows", "banded_dp_chunked_tb_rows")
CHUNKED_SLICE = 16             # reads of the captured long call held
# the runner phase: the 1 kb and mixed paths' reads with basecalls of 8%
# errors (tombo_tpu/testing.py:118 mutate_seq's mix) through
# resquiggle_all_reads at the command line's batch size
# (tombo_tpu/cli/main.py:269) over a memory source; reads of the CPU
# cross-check; a mapping counts as right within this many bases of the
# simulated start, on the simulated strand
RUNNER_SEED, RUNNER_ERR, RUNNER_BATCH = 97, 0.08, 64
RUNNER_CPU_READS, RUNNER_START_TOL = 32, 10
# the multi-host phase: this many processes on the one card, merged over
# gloo on 127.0.0.1 (NCCL refuses two ranks on one card), each killed
# past this many seconds
MULTIHOST_HOSTS, MULTIHOST_TIMEOUT = 2, 300
# the plots phase's clustering: most significant regions of 21 bases
# (the command's default width); more than its default 10, since most
# of the 1 kb path's most significant sites lie where fewer than three
# reads cover a region whole (2 of 10 clustered on the H100, 700 W)
PLOT_CLUSTER_REGIONS = 50
# the one-read phase: reads of the 1 kb path's first batch, of the mixed
# path (the longest, the shortest that takes the static band and reads
# between) and of the RNA path's first batch (stall reads among them);
# per path, these reads run again on the CPU at float64 (of the mixed
# ones the static-band read and one of a few kb: the longest one's plain
# DP takes minutes); DNA reads of
# at most this many bases are held against the native baseline (above
# it the baseline's Theil-Sen subsample differs by design); the K1 row at
# B 1 is the fused bw-300 call of at most ONE_READ_K1_ROWS rows
ONE_READ_1KB, ONE_READ_MIXED, ONE_READ_RNA = 64, 8, 16
ONE_READ_CPU = (range(10), (0, 3), range(4))
ONE_READ_BASELINE_BASES, ONE_READ_K1_ROWS = 1000, 1100
ONE_READ_BW, ONE_READ_START_BW = 300, 750
# the reads the one-read phase's comparison with the batched lane may find
# outside tests/test_batch_parity.py's bars: a tenth of them, rounded up.
# On the CPU the JAX package's own one-read path (the port's at float64,
# bit for bit) falls outside them against the float32 batched lane on 3
# of 64 1 kb reads, where the rescaling passes re-select changepoints
# whose ties a rounding breaks; on the H100 (700 W) the port's fell
# outside on 5 of 64 1 kb reads, 1 of 8 mixed and 0 of 16 RNA.  The
# comparisons with the CPU at float64 and with the native baseline allow
# none (both read 0 there).  A read outside the bars must still meet
# ONE_READ_LOOSE_BARS (the worst measured: segs 0.983, shift 1.7e-3,
# scale 8.1e-4, score 2.1e-2), and a different start or table length
# always fails.
ONE_READ_BATCHED_OUTSIDE = 0.1
ONE_READ_LOOSE_BARS = {"segs": 0.97, "shift": 5e-3, "scale": 5e-3,
                       "score": 3e-2}
DEVICE = "cuda"


def fail(msg):
    print("FAILED: " + msg, flush=True)
    sys.exit(1)


@contextlib.contextmanager
def phase(name):
    t0 = time.perf_counter()
    yield
    print("phase %s: %.1f s" % (name, time.perf_counter() - t0), flush=True)


def cuda_ms(fn, reps, warm=True):
    """Median milliseconds of ``fn`` over ``reps`` CUDA-event-timed calls
    (after one warm-up call unless ``warm`` is false)."""
    if warm:
        fn()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def pair_split_ms(fn, reps):
    """Median milliseconds of each kernel of the chunked pair (K2, K2')
    over ``reps`` calls of ``fn`` (after one warm-up call), from CUDA
    events recorded before the call, between its two launches and after
    it."""
    from tombo_tpu_torch import kernels
    count, marks = kernels.count_launch, []

    def mark(name):
        count(name)
        if name == CHUNKED[0]:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()

    fn()
    fwd, tb = [], []
    with patched([(kernels, "count_launch", mark)]):
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            fwd.append(a.elapsed_time(marks[-1]))
            tb.append(marks[-1].elapsed_time(b))
    return statistics.median(fwd), statistics.median(tb)


def kernel_device_ms(fn, reps, names):
    """Device milliseconds of each kernel whose name contains one of
    ``names``, from torch.profiler over ``reps`` calls of ``fn`` (after
    one warm-up call): the mean over the kernel events the profiler
    recorded, and how many it recorded against the ``reps`` launched."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {n: [] for n in names}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for n in names:
                if n in e.name:
                    out[n].append((e.time_range.end - e.time_range.start) *
                                  1e-3)
    return {n: {"ms": statistics.mean(v) if v else "not measured",
                "recorded": len(v), "launched": reps}
            for n, v in out.items()}


_PTXAS_ENTRY = re.compile(
    r"Compiling entry function '\w*?\d([a-z_]+_kernel)(I\w*?E)?Ev")
_PTXAS_NUM = re.compile(r"(\d+) (bytes stack frame|bytes spill stores|bytes spill "
                        r"loads|registers|bytes smem)")


def ptxas_summary(log):
    """One line per kernel instance from nvcc -Xptxas -v: the kernel and
    its template arguments, registers, static shared memory, stack frame
    and spill bytes."""
    out, cur = [], None
    for line in log.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            args = [v if t == "i" else ("false", "true")[int(v)]
                    for t, v in re.findall(r"L([ib])(\d+)E",
                                           m.group(2) or "")]
            cur = {"kernel": "%s<%s>" % (m.group(1), ",".join(args))}
            out.append(cur)
        elif cur is not None:
            for n, what in _PTXAS_NUM.findall(line):
                cur[what.replace("bytes ", "")] = int(n)
    return ["%(kernel)s: %(registers)s registers, %(smem)s bytes smem, "
            "%(stack frame)s bytes stack, spills %(spill stores)s stores / "
            "%(spill loads)s loads" % dict(
                {"registers": "?", "smem": 0, "stack frame": "?",
                 "spill stores": "?", "spill loads": "?"}, **e) for e in out]


def build_reads(read_lens, seed, ref_len, prefix, sim_model=None):
    """Simulated, mapped DNA reads of the given lengths (bench.py's
    recipe), named ``prefix`` and a number; also the reference (the same
    for every call with this ``ref_len``).  ``sim_model``: the model the
    signal is simulated from (default the DNA model, which maps them)."""
    from tombo_tpu_torch import config
    from tombo_tpu_torch.io.model_io import KmerModel
    from tombo_tpu_torch.pipeline import resquiggle as rsq
    from tombo_tpu_torch.pipeline.aligner import ExactAligner
    from tombo_tpu_torch.testing import random_reference, simulate_read
    from tombo_tpu_torch.types import SeqSampleType, SequenceData
    rng = np.random.default_rng(seed)
    model = KmerModel.load_default("DNA")
    fasta = random_reference(np.random.default_rng(5), ref_len)
    aligner = ExactAligner(fasta)
    sst = SeqSampleType("DNA", False)
    params = config.load_resquiggle_parameters("DNA")
    maps = []
    for i, n in enumerate(read_lens):
        read = simulate_read(rng, fasta, sim_model or model,
                             read_len=int(n),
                             read_id="%s%05d" % (prefix, i),
                             mean_dwell=MEAN_DWELL)
        mr = rsq.map_read(SequenceData(read.seq, read.read_id, 12.0),
                          aligner, model, sst)
        mr = mr.replace(raw_signal=read.raw_signal.astype(np.float64))
        maps.append(rsq.adjust_map_res(mr, sst, params))
    return model, params, sst, maps, fasta


def build_rna_reads(n_reads, seed, ref_len):
    """Simulated, mapped, adjusted direct-RNA reads; one in
    RNA_STALL_EVERY gets a pore stall at its middle base boundary.
    Returns the model, parameters, sample type, the mapped reads, per
    read the stall's (start, end) in the adjusted (5' to 3') signal or
    None, and the reference."""
    from tombo_tpu_torch import config, testing
    from tombo_tpu_torch.io.model_io import KmerModel
    from tombo_tpu_torch.pipeline import resquiggle as rsq
    from tombo_tpu_torch.pipeline.aligner import ExactAligner
    from tombo_tpu_torch.types import SeqSampleType, SequenceData
    rng = np.random.default_rng(seed)
    model = KmerModel.load_default("RNA")
    fasta = testing.random_reference(np.random.default_rng(seed + 1),
                                     ref_len)
    aligner = ExactAligner(fasta)
    sst = SeqSampleType("RNA", True)
    params = config.load_resquiggle_parameters("RNA")
    maps, stalls = [], []
    for i in range(n_reads):
        read = testing.simulate_read(
            rng, fasta, model, read_len=RNA_LEN, read_id="rna_%05d" % i,
            mean_dwell=RNA_DWELL, rev_sig=True, adapter_len=RNA_ADAPTER)
        raw, stall = read.raw_signal, None
        if i % RNA_STALL_EVERY == 0:
            n = int(rng.integers(RNA_STALL[0], RNA_STALL[1] + 1))
            pos = raw.shape[0] - int(read.true_segs[RNA_LEN // 2])
            raw = testing.insert_stall(rng, raw, pos, n)
            stall = (raw.shape[0] - pos - n, raw.shape[0] - pos)
        mr = rsq.map_read(SequenceData(read.seq, read.read_id, 12.0),
                          aligner, model, sst)
        mr = mr.replace(raw_signal=raw.astype(np.float64))
        maps.append(rsq.adjust_map_res(mr, sst, params))
        stalls.append(stall)
    return model, params, sst, maps, stalls, fasta


def synthetic_dp_args(B, L, bw, seed, dev):
    """DP inputs of B long reads of up to L bases, 1.4 events a base, no
    start mask (scripts/time_chunked_pair.py's synthetic reads)."""
    from tombo_tpu_torch.ops import dp as dp_mod
    rng = np.random.default_rng(seed)
    ratio, P = 1.4, 1
    E = int(L * ratio) + bw
    rm = rng.normal(0, 1, (B, L)).astype(np.float32)
    rs = rng.uniform(0.08, 0.15, (B, L)).astype(np.float32)
    base = np.minimum((np.arange(E) / ratio).astype(np.int64), L - 1)
    em = (rm[:, base] + rng.normal(0, 1, (B, E)).astype(np.float32) *
          rs[:, base]).astype(np.float32)
    seq_lens = rng.integers(int(0.75 * L), L + 1, B)
    n_events = np.minimum((seq_lens * ratio).astype(np.int64) + bw // 2, E)
    t = lambda a: torch.tensor(a, device=dev)
    p = dp_mod.DpParams(z_shift=6.8, skip_pen=4.0, stay_pen=6.0,
                        mask_fill_z_score=-15.0, max_half_z_score=20.0,
                        bandwidth=bw)
    return (t(em), t(n_events), t(rm), t(rs), t(seq_lens),
            t(np.zeros((B, P), np.int64)), t(np.zeros(B, np.int64)),
            t(np.full((B, P), 2 ** 31 - 1, np.int64)),
            t(np.zeros(B, np.int64)), p, L, P, 50)


def mixed_lens(n_reads, seed):
    rng = np.random.default_rng(seed)
    lens = np.exp(rng.normal(MIXED_LOG_MEAN, MIXED_LOG_SD, n_reads))
    return np.clip(lens, MIXED_MIN_LEN, MIXED_MAX_LEN).astype(int)


class Recorder:
    """Wraps a function to keep the inputs of its largest call per shape
    key and count its calls and reads per key; forwards every call
    unchanged."""

    def __init__(self, fn, key_fn):
        self.fn, self.key_fn = fn, key_fn
        self.calls, self.count = {}, {}

    def __call__(self, *args, **kw):
        key, size = self.key_fn(*args)
        if key not in self.calls or self.calls[key][0] < size:
            self.calls[key] = (size, args, kw)
        n, reads = self.count.get(key, (0, 0))
        self.count[key] = (n + 1, reads + size)
        return self.fn(*args, **kw)


@contextlib.contextmanager
def patched(pairs):
    """Set each (owner, name, value) for the duration of the block."""
    old = [(o, n, getattr(o, n)) for o, n, _ in pairs]
    for o, n, v in pairs:
        setattr(o, n, v)
    try:
        yield
    finally:
        for o, n, v in old:
            setattr(o, n, v)


def dp_key(*a):
    """(n_rows, bandwidth), reads of a DP wrapper call."""
    return (a[10], a[9].bandwidth), a[0].shape[0]


# BatchedResquiggler methods -> the layer they make up (PERF.md, Layers)
STAGES = {
    "_plan_reads": "plan (host)",
    "_segment_batch": "stage A: normalize, changepoints, start DP",
    "_start_discovery": "start retry DP",
    "_adaptive_device_call": "adaptive DP + device finalize",
    "_delfix_and_fit": "deletion fix + Theil-Sen fit",
    "_static_reads": "static band (host)",
    "_finalize": "finalize (host)",
}


def stage_breakdown(br, batch):
    """Seconds of one ``resquiggle_batch`` by layer, each layer's own time
    without the layers it calls, with a card synchronise at every layer
    edge so that device work is charged to the layer that queued it;
    also the reads and bases that took the host's static band."""
    from tombo_tpu_torch.pipeline import resquiggle as rsq
    cls = type(br)
    acc = {label: 0.0 for label in STAGES.values()}
    stack, orig = [], {}
    static = {"reads": 0, "bases": 0}
    find_static = rsq.find_static_base_assignment

    def static_counted(em, rm, *a):
        static["reads"] += 1
        static["bases"] += rm.shape[0]
        return find_static(em, rm, *a)

    def timed(name, label):
        fn = getattr(cls, name)
        orig[name] = fn

        def run(self, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stack.append(0.0)
            try:
                return fn(self, *a, **kw)
            finally:
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                acc[label] += dt - stack.pop()
                if stack:
                    stack[-1] += dt
        return run

    for name, label in STAGES.items():
        setattr(cls, name, timed(name, label))
    try:
        with patched([(rsq, "find_static_base_assignment",
                        static_counted)]):
            t0 = time.perf_counter()
            br.resquiggle_batch(batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for name, fn in orig.items():
            setattr(cls, name, fn)
    acc["other (host)"] = wall - sum(acc.values())
    return {"reads": len(batch), "wall_s": wall, "stages_s": acc,
            "static_band": static}


# the stage profile's keys on the float32 lane: the JAX package's float32
# keys (tests/test_torch_profile.py holds the CPU lane's keys to the JAX
# profiler's); the six stages; the coverage of a batch's wall that the six
# must reach
PROFILE_KEYS_F32 = {"segment", "segment_fetch", "seg_pack", "seg_upload",
                    "plan", "start", "adaptive", "adaptive_fetch",
                    "delfix_plan", "delfix_apply", "static", "static_fetch",
                    "finalize", "finalize_native"}
PROFILE_STAGES = ("segment", "plan", "start", "adaptive", "static",
                  "finalize")
PROFILE_COVERAGE = (0.85, 1.02)


@contextlib.contextmanager
def native_lane_counted():
    """Counts the reads the float32 host lane sends through
    ``native.finalize_batch`` in the block: yields a list that holds each
    call's job count."""
    from tombo_tpu_torch import native
    jobs = []
    fn = native.finalize_batch

    def counted(j, *a, **kw):
        jobs.append(len(j))
        return fn(j, *a, **kw)

    with patched([(native, "finalize_batch", counted)]):
        yield jobs


def host_lane_line(label, br, batch):
    """One batch through a warm resquiggler with a ``StageProfile``: the
    reads the float32 host lane finished in the host library, its calls
    and ``finalize_native`` seconds, ``finalize``'s seconds and the MB
    each way."""
    from tombo_tpu_torch.pipeline import batch as batch_mod
    br.profile = prof = batch_mod.StageProfile()
    try:
        with native_lane_counted() as jobs:
            t0 = time.perf_counter()
            br.resquiggle_batch(batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        br.profile = None
    if sum(jobs) and "finalize_native" not in prof.timings:
        fail("host lane %s: %d reads went through the host library but "
             "no finalize_native was timed" % (label, sum(jobs)))
    line = {"path": label, "reads": len(batch), "wall_s": wall,
            "native_lane_reads": sum(jobs), "finalize_batch_calls": len(jobs),
            "finalize_native_s": prof.timings.get("finalize_native", 0.0),
            "finalize_s": prof.timings.get("finalize", 0.0),
            "mb_up": prof.transfer_bytes.get("upload", 0) / 2 ** 20,
            "mb_down": prof.transfer_bytes.get("fetch", 0) / 2 ** 20}
    print("host lane %s" % json.dumps(line))
    return line


def raw_wire_check(label, br, batch, dev):
    """The raw matrix of each length group of ``batch`` through the wire
    (``_upload_raw``: the integrality check, int8 deltas and escapes,
    decoded on the card) and dense (the same reads with ``raw_i16``
    unset) at float32: bitwise equal, else a failure; the MB each sends
    and the seconds of each (host clock, card synchronised)."""
    from tombo_tpu_torch.pipeline import batch as batch_mod
    tot = {True: [0, 0.0], False: [0, 0.0]}
    got = {}
    for wire in (True, False):
        reads = [batch_mod._ReadState(
            idx=i, map_res=m, raw=np.asarray(m.raw_signal, np.float64),
            num_events=0) for i, m in enumerate(batch)]
        if not wire:
            for s in reads:
                s.raw_i16 = None
        got[wire] = []
        for group in batch_mod._length_groups(reads):
            S = batch_mod._sig_bucket(max(s.raw.shape[0] for s in group))
            br.profile = batch_mod.StageProfile()
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got[wire].append(br._upload_raw(group, dev, S)[0])
                torch.cuda.synchronize()
                tot[wire][1] += time.perf_counter() - t0
                tot[wire][0] += br.profile.transfer_bytes["upload"]
            finally:
                br.profile = None
        if wire and any(s.raw_i16 is None for s in reads):
            fail("raw wire %s: a raw signal is not integral" % label)
    for a, b in zip(got[True], got[False]):
        if not (a.dtype == b.dtype == torch.float32 and torch.equal(a, b)):
            fail("raw wire %s: the decoded matrix of a group of %d reads "
                 "differs from the dense one" % (label, a.shape[0]))
    line = {"path": label, "groups": len(got[True]), "bitwise_dense": True,
            "mb_wire": tot[True][0] / 2 ** 20,
            "mb_dense": tot[False][0] / 2 ** 20,
            "ratio": tot[False][0] / tot[True][0],
            "s_wire": tot[True][1], "s_dense": tot[False][1]}
    print("raw wire %s" % json.dumps(line))
    return line


def host_levels(reads, width, clip, np_dt):
    """The (B, width) level matrices the host built and sent before the
    levels were looked up on the card: ones-padded float64 rows cast to
    the lane's dtype; ``clip`` as ``BatchedResquiggler._levels``."""
    rm = np.ones((len(reads), width))
    rs = np.ones((len(reads), width))
    for i, s in enumerate(reads):
        n = s.ref_means.shape[0]
        if clip:
            if n >= width:
                rm[i], rs[i] = s.ref_means[:width], s.ref_sds[:width]
        else:
            m = min(n, width)
            rm[i, :m], rs[i, :m] = s.ref_means[:m], s.ref_sds[:m]
    return rm.astype(np_dt), rs.astype(np_dt)


def resident_check(label, br, batch, dev):
    """One batch through a warm resquiggler with a ``StageProfile``,
    every piece of the device-resident flow held bitwise as it runs:
    each level matrix looked up on the card against the host-built one;
    each rescale pass's gathered raw matrix against a fresh
    ``_upload_raw`` of its reads; each segment table rebuilt from the
    uint8 wire against the full table fetched from the card (every row
    whose table is non-decreasing).  Prints a ``resident`` line: MB up
    and down, the host's changepoint row copies and ``seg_over`` rows,
    and the counts checked.  The checks' own copies are not counted."""
    from tombo_tpu_torch.pipeline import batch as batch_mod
    cls = batch_mod.BatchedResquiggler
    levels, seg_shard, seg_tables = (cls._levels, cls._segment_shard,
                                     cls._seg_tables)
    n = {"levels": 0, "raw_gathers": 0, "tables": 0}

    def levels_rec(self, live, width, clip=False, device=None):
        out = levels(self, live, width, clip, device)
        for g, w in zip(out, host_levels(live, width, clip, self.np_dtype)):
            if not torch.equal(g.cpu(), torch.as_tensor(w)):
                fail("resident %s: a level matrix (%d x %d) differs from "
                     "the host-built one" % (label, len(live), width))
        n["levels"] += 1
        return out

    def seg_shard_rec(self, live, d, sig_w, *a):
        gathered = all(s.raw_dev is not None for s in live)
        out = seg_shard(self, live, d, sig_w, *a)
        if gathered:
            prof, self.profile = self.profile, None
            try:
                want = self._upload_raw(live, d, sig_w)[0]
            finally:
                self.profile = prof
            if not torch.equal(live[0].raw_dev[0], want):
                fail("resident %s: a rescale pass's gathered raw matrix "
                     "differs from _upload_raw's" % label)
            n["raw_gathers"] += 1
        return out

    def seg_tables_rec(self, d8, over, seq_segs_j):
        out = seg_tables(self, d8, over, seq_segs_j)
        # each row up to its first decrease (past a read's own bases the
        # table is not used), where the wire holds it or it came in full
        full = seq_segs_j.cpu().numpy()
        d = np.diff(full, axis=1)
        neg = d < 0
        end = np.where(neg.any(1), neg.argmax(1), d.shape[1])
        col = np.arange(d.shape[1])[None, :]
        ok = over | np.all((d <= 255) | (col >= end[:, None]), axis=1)
        cols = np.arange(full.shape[1])[None, :] <= end[:, None]
        if not np.array_equal(np.where(cols, out, 0)[ok],
                              np.where(cols, full, 0)[ok]):
            fail("resident %s: a table rebuilt from the uint8 wire differs "
                 "from the full one" % label)
        n["tables"] += int(ok.sum())
        return out

    br.profile = prof = batch_mod.StageProfile()
    try:
        with patched([(cls, "_levels", levels_rec),
                      (cls, "_segment_shard", seg_shard_rec),
                      (cls, "_seg_tables", seg_tables_rec)]):
            out = br.resquiggle_batch(batch)
    finally:
        br.profile = None
    if not (n["levels"] and n["raw_gathers"] and n["tables"]):
        fail("resident %s: a piece went unchecked: %s" % (label, n))
    line = {"path": label, "reads": len(batch),
            "ok_reads": sum(r is not None for r, _ in out),
            "mb_up": prof.transfer_bytes.get("upload", 0) / 2 ** 20,
            "mb_down": prof.transfer_bytes.get("fetch", 0) / 2 ** 20,
            "cpts_row_fetches": prof.row_fetches.get("cpts", 0),
            "seg_over_rows": prof.row_fetches.get("seg_over", 0),
            "checked_bitwise": n}
    print("resident %s" % json.dumps(line))
    return line


# the lanes phase: the non-default finalize lanes (pipeline/batch.py
# FinalizeLanes), each held to the default lane on one batch of each path.
# A lane fits on other numbers (float64 host normalization, a float32
# Theil-Sen on the host, unfixed tables), so a read whose correction lies
# near the rescaling threshold may take another scaling pass and end
# elsewhere (one RNA read of 512 at segs 0.921 on the H100, 700 W).  So
# at most LANES_OUTSIDE of a lane's reads may differ from the default
# lane (another error, start or table length, or outside
# tests/test_batch_parity.py's bars), and each that does runs again
# through the same lane on the CPU, where the lane is held to the JAX
# package's: the card's result must be within the bars of that run.
LANES = [
    ("device_delfix=False", {"device_delfix": False}),
    ("device_delfix=False, device_fit=True",
     {"device_delfix": False, "device_fit": True}),
    ("device_fit=False", {"device_fit": False}),
    ("device_finalize=False", {"device_finalize": False}),
    ("native_finalize=False", {"native_finalize": False}),
    ("device_fit=False, native_finalize=False, device_theil_sen=True",
     {"device_fit": False, "native_finalize": False,
      "device_theil_sen": True}),
]
LANES_OUTSIDE = 0.1
# K5 at the device Theil-Sen blocks' shape: 64 reads, 1,000 points
TS_BLOCK_SHAPE = (64, 1000 * 999 // 2)


@contextlib.contextmanager
def lane_counts():
    """Counts, over the block, the reads each finalize lane took: the
    device fit (reads with a device fit at ``_finalize``), the host
    library's ``finalize_batch``, ``del_fix_batch`` and ``theil_sen_batch``
    and the device Theil-Sen blocks; and the reads (with a deletion) that
    the device finalize saw.  Yields the dict it fills."""
    from tombo_tpu_torch import native
    from tombo_tpu_torch.pipeline import batch as batch_mod
    cls = batch_mod.BatchedResquiggler
    n = {"device_fit": 0, "finalize_batch": 0, "del_fix_batch": 0,
         "theil_sen_batch": 0, "ts_blocks": 0, "has_del_seen": 0,
         "has_del": 0}
    fin, note = cls._finalize, cls._note_del_rate

    def count(key, fn, size):
        def run(*a, **kw):
            n[key] += size(*a)
            return fn(*a, **kw)
        return run

    def fin_rec(self, states, *a, **kw):
        n["device_fit"] += sum(1 for s in states if s.error is None and
                               s.result is None and s.dev_fit is not None)
        return fin(self, states, *a, **kw)

    def note_rec(self, has_del):
        n["has_del_seen"] += int(has_del.shape[0])
        n["has_del"] += int(np.count_nonzero(has_del))
        return note(self, has_del)

    with patched([
            (native, "finalize_batch", count(
                "finalize_batch", native.finalize_batch,
                lambda j, *a: len(j))),
            (native, "del_fix_batch", count(
                "del_fix_batch", native.del_fix_batch, lambda j, *a: len(j))),
            (native, "theil_sen_batch", count(
                "theil_sen_batch", native.theil_sen_batch,
                lambda ev, *a: ev.shape[0])),
            (batch_mod, "_theil_sen_device_blocks", count(
                "ts_blocks", batch_mod._theil_sen_device_blocks,
                lambda ev, *a: ev.shape[0])),
            (cls, "_finalize", fin_rec), (cls, "_note_del_rate", note_rec)]):
        yield n


def lanes_phase(smi, paths):
    """Each finalize lane of ``LANES`` on one batch of each path
    (``paths``: (label, (model, params, sst), batch, the default lane's
    results of that batch)), a fresh resquiggler each with the launch
    counts zeroed just before it: its results held to the default lane's
    (:func:`lane_differences`); the kernels the lane must
    and must not launch; one line a lane with reads/s, the
    ``finalize``, ``finalize_native`` and ``adaptive`` seconds of its
    ``StageProfile``, the reads each lane took, the share of reads with a
    deletion and the MB each way.  The default lane runs last on each
    batch, its results bitwise the path's, which leaves the device means
    of the batch's reads as the path registered them.  Returns (the count
    kernel's arguments at the blocks' shape, the arguments of a block's
    fit, the blocks' launches by path)."""
    from tombo_tpu_torch import config
    from tombo_tpu_torch.ops import rescale
    from tombo_tpu_torch.pipeline import batch as batch_mod
    # the count kernel's and the fit's calls of the blocks lane
    rec_k5 = Recorder(rescale.count_le, lambda keys, piv: (
        tuple(keys.shape), 1))
    rec_ts = Recorder(rescale.theil_sen_device, lambda ev, *a, **kw: (
        tuple(ev.shape), 1))
    block_launches = {}
    for label, cfg, batch, default in paths:
        for lane, kw in LANES + [("default", {})]:
            prof = batch_mod.StageProfile()
            br = batch_mod.BatchedResquiggler(
                *cfg, config.OUTLIER_THRESH, device=DEVICE, profile=prof,
                lanes=batch_mod.FinalizeLanes(**kw))
            blocks = kw.get("device_theil_sen", False)
            with lane_counts() as n:
                (out,), wall, launches = run_path(
                    "lanes %s, %s" % (label, lane), br, [batch],
                    [(rescale, "count_le", rec_k5),
                     (rescale, "theil_sen_device", rec_ts)] if blocks
                    else [])
            if lane == "default":
                if not all(same_result(a, b) for a, b in zip(out, default)):
                    fail("lanes %s: the default lane's results differ from "
                         "the path's" % label)
                outside = 0
            else:
                outside = lane_differences("lanes %s, %s" % (label, lane),
                                           cfg, kw, batch, out, default)
            if launches["banded_dp"] <= 0:
                fail("lanes %s, %s: no DP kernel launched" % (label, lane))
            # the count kernel runs for a device fit or the blocks only
            fits = (kw.get("device_finalize", True) and
                    kw.get("device_fit", True) is not False) or blocks
            if (launches["count_le"] > 0) != fits:
                fail("lanes %s, %s: %d count kernel launches" % (
                    label, lane, launches["count_le"]))
            if blocks:
                if n["ts_blocks"] < 32:
                    fail("lanes %s: the device Theil-Sen blocks took %d "
                         "reads" % (label, n["ts_blocks"]))
                block_launches[label] = launches["count_le"]
            n_ok = sum(r is not None for r, _ in out)
            line = {
                "path": label, "lane": lane, "card": smi,
                "reads": len(batch), "reads_ok": n_ok, "wall_s": wall,
                "reads_per_s": n_ok / wall, "outside_bars": outside,
                "s": {k: prof.timings.get(k, 0.0) for k in (
                    "finalize", "finalize_native", "adaptive")},
                "reads_by_lane": {k: v for k, v in n.items()
                                  if not k.startswith("has_del")},
                "has_del_share": (n["has_del"] / n["has_del_seen"]
                                  if n["has_del_seen"] else None),
                "mb_up": prof.transfer_bytes.get("upload", 0) / 2 ** 20,
                "mb_down": prof.transfer_bytes.get("fetch", 0) / 2 ** 20,
                "launches": {k: v for k, v in launches.items() if v}}
            print("lanes " + json.dumps(line))
    if TS_BLOCK_SHAPE not in rec_k5.calls:
        fail("lanes: no count kernel call at the blocks' shape %s (saw %s)"
             % (TS_BLOCK_SHAPE, sorted(rec_k5.calls)))
    return (rec_k5.calls[TS_BLOCK_SHAPE][1],
            rec_ts.calls[(TS_BLOCK_SHAPE[0], 1000)][1], block_launches)


def lane_differences(label, cfg, kw, batch, out, default):
    """The reads of ``batch`` whose lane result ``out`` differs from the
    default lane's (``default``): another error, start or table length,
    or outside :func:`result_bars`.  Fails past LANES_OUTSIDE of the
    batch; runs the differing reads again through the same lane on the
    CPU and holds the card's results to those (:func:`hold_results`, none
    allowed outside).  Prints each difference and the worst within the
    bars; returns the count."""
    from tombo_tpu_torch import config
    from tombo_tpu_torch.pipeline import batch as batch_mod
    diff = []
    worst = {"segs": 1.0, "shift": 0.0, "scale": 0.0, "score": 0.0}
    for i, ((g, ge), (c, ce)) in enumerate(zip(out, default)):
        if g is None or c is None:
            if ge != ce:
                diff.append(i)
                print("  %s %s: error %r, default lane's %r" % (
                    label, batch[i].align_info.read_id, ge, ce))
            continue
        ok, d = result_bars(g, c)
        if not ok:
            diff.append(i)
            print("  %s %s: outside the bars %s" % (
                label, batch[i].align_info.read_id, json.dumps(d)))
            continue
        worst = {"segs": min(worst["segs"], d["segs"]),
                 "shift": max(worst["shift"], d["shift"]),
                 "scale": max(worst["scale"], d["scale"]),
                 "score": max(worst["score"], d["score"])}
    print("%s: %d of %d reads differ from the default lane (%d allowed); "
          "worst within the bars: %s" % (
              label, len(diff), len(batch),
              math.ceil(LANES_OUTSIDE * len(batch)), json.dumps(worst)))
    if len(diff) > math.ceil(LANES_OUTSIDE * len(batch)):
        fail("%s: %d of %d reads differ from the default lane" % (
            label, len(diff), len(batch)))
    if diff:
        reads = [batch[i] for i in diff]
        cpu = batch_mod.BatchedResquiggler(
            *cfg, config.OUTLIER_THRESH, device="cpu",
            lanes=batch_mod.FinalizeLanes(**kw)).resquiggle_batch(reads)
        hold_results("%s: card vs CPU" % label, [out[i] for i in diff], cpu,
                     [m.align_info.read_id for m in reads], allowed=0)
    return len(diff)


def ts_block_row(k5, block_args, ts_args, block_launches):
    """K5 at the device Theil-Sen blocks' shape: counts bitwise its plain
    version on the captured block, CUDA-event ms of it, of the plain
    version and of ``torch.kthvalue`` at the block's first read's upper
    middle rank, and its bound."""
    from tombo_tpu_torch.ops import rescale
    keys, piv = block_args
    c_k = k5(keys, piv)
    c_p = rescale.count_le_plain(keys, piv)
    if not torch.equal(c_k, c_p):
        fail("count_le at the blocks' shape differs from the plain version "
             "by %d" % int((c_k - c_p).abs().max()))
    B, M = keys.shape
    P = piv.shape[1]
    k_rank = int(rescale._pair_ranks(ts_args[2])[2][0]) + 1
    try:
        lib = cuda_ms(lambda: torch.kthvalue(keys, k_rank, dim=1), 5)
    except RuntimeError as e:          # yardstick only, never on the path
        print("torch.kthvalue yardstick unavailable: %s" % e)
        lib = None
    t_b = (B * M * 4 + 3 * B * P * 4) / HBM_BYTES_PER_S
    t_o = 2 * B * M * P / F32_OPS_PER_S
    row = {"B": B, "M": M, "P": P, "launches": block_launches["1 kb"],
           "launches_by_path": block_launches, "max_abs_err": 0,
           "ms": cuda_ms(lambda: k5(keys, piv), 20),
           "plain_ms": cuda_ms(lambda: rescale.count_le_plain(keys, piv), 5),
           "bound_ms": 1e3 * max(t_b, t_o),
           "bound_by": "bytes" if t_b >= t_o else "operations",
           "library_ms": lib}
    print("count_le at the device Theil-Sen blocks' shape: %s" %
          json.dumps(row))
    return row


def trace_counts(trace_dir, names):
    """(kernel events whose name holds each of ``names``, annotation
    names, bytes) of the one Chrome trace in ``trace_dir``."""
    (fn,) = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)
             if f.endswith(".pt.trace.json")]
    with open(fn) as f:
        events = json.load(f)["traceEvents"]
    counts = {n: 0 for n in names}
    notes = set()
    for e in events:
        if e.get("cat") == "kernel":
            for n in names:
                if n in e.get("name", ""):
                    counts[n] += 1
        elif e.get("cat") == "user_annotation":
            notes.add(e.get("name"))
    return counts, notes, os.path.getsize(fn)


def stage_profile_phase(smi, paths):
    """The package's stage profile on one full batch of each path
    (``paths``: (label, warm resquiggler, batch)): the batch without and
    with a ``StageProfile`` in turns (off, on, on, off), every result
    bitwise the first run's; the float32 key set; the six stages' share
    of the profiled batch's wall; the table, the MB each way and the
    on/off wall ratio.  Then one traced batch of the first path: its
    results bitwise, the trace's K1 and K5 kernel events in the numbers
    by which their launch counts grew, and the six stage ranges."""
    from tombo_tpu_torch import kernels
    from tombo_tpu_torch.pipeline import batch as batch_mod
    keys_seen, line = set(), {"card": smi}
    for label, br, batch in paths:
        # the start retry (a start DP that stage A did not precompute,
        # also in the save-bandwidth resquiggler) adds start_fetch
        retried = []
        cls = batch_mod.BatchedResquiggler
        start = cls._start_discovery

        def start_rec(self, states, ctx, start_bw, *a, **kw):
            if not kw.get("precomputed"):
                retried.append(start_bw)
            return start(self, states, ctx, start_bw, *a, **kw)

        runs = {"off": [], "on": []}
        first = None
        with patched([(cls, "_start_discovery", start_rec)]):
            for mode in ("off", "on", "on", "off"):
                prof = batch_mod.StageProfile() if mode == "on" else None
                br.profile = prof
                try:
                    with native_lane_counted() as jobs:
                        t0 = time.perf_counter()
                        out = br.resquiggle_batch(batch)
                        torch.cuda.synchronize()
                        wall = time.perf_counter() - t0
                finally:
                    br.profile = None
                if (prof is not None and sum(jobs) and
                        "finalize_native" not in prof.timings):
                    fail("stage profile %s: %d host-lane reads but no "
                         "finalize_native" % (label, sum(jobs)))
                if first is None:
                    first = out
                if not all(same_result(a, b) for a, b in zip(out, first)):
                    fail("stage profile %s: a %s run's results differ from "
                         "the first run's" % (label, mode))
                runs[mode].append((wall, prof))
        allowed = PROFILE_KEYS_F32 | ({"start_fetch"} if retried else set())
        entry = {"reads": len(batch), "start_retry_calls": len(retried),
                 "wall_off_s": [w for w, _ in runs["off"]],
                 "wall_on_s": [w for w, _ in runs["on"]],
                 "on_off_ratio": (statistics.mean(w for w, _ in runs["on"]) /
                                  statistics.mean(w for w, _ in runs["off"])),
                 "profiles": []}
        for wall, prof in runs["on"]:
            extra = set(prof.timings) - allowed
            if extra:
                fail("stage profile %s: keys %s outside the float32 set" % (
                    label, sorted(extra)))
            keys_seen |= set(prof.timings)
            cover = sum(prof.timings.get(k, 0.0)
                        for k in PROFILE_STAGES) / wall
            if not PROFILE_COVERAGE[0] <= cover <= PROFILE_COVERAGE[1]:
                fail("stage profile %s: the six stages cover %.3f of the "
                     "batch's wall" % (label, cover))
            entry["profiles"].append({
                "wall_s": wall, "stage_coverage": cover,
                "timings_s": dict(prof.timings),
                "mb": {k: v / 2 ** 20
                       for k, v in prof.transfer_bytes.items()}})
        print("stage profile, %s batch (second profiled run; %s):" % (
            label, smi))
        batch_mod.print_stage_timings(runs["on"][1][1], out=sys.stdout)
        line[label] = entry
    missing = PROFILE_KEYS_F32 - keys_seen
    if missing:
        fail("stage profile: keys %s missing from every batch" %
             sorted(missing))

    label, br, batch = paths[0]
    want = br.resquiggle_batch(batch)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        before = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        (traced,) = list(br.resquiggle_batches([batch], trace_dir=tmp))
        wall = time.perf_counter() - t0
        grew = {n: kernels.LAUNCHES[n] - before[n] for n in kernels.LAUNCHES}
        counts, notes, size = trace_counts(
            tmp, ("banded_dp_kernel", "count_le_kernel"))
    if not all(same_result(a, b) for a, b in zip(traced, want)):
        fail("stage profile: the traced batch's results differ")
    for name, n in (("banded_dp_kernel", grew["banded_dp"]),
                    ("count_le_kernel", grew["count_le"])):
        if n <= 0 or counts[name] != n:
            fail("stage profile: the trace holds %d %s events for %d "
                 "launches" % (counts[name], name, n))
    if not set(PROFILE_STAGES) <= notes:
        fail("stage profile: the trace lacks the stage ranges %s" %
             sorted(set(PROFILE_STAGES) - notes))
    line["trace"] = {"path": label, "wall_s": wall, "bytes": size,
                     "kernel_events": counts,
                     "launches": {n: v for n, v in grew.items() if v}}
    print("stage profile " + json.dumps(line))


def device_profile(br, batch):
    """Device busy share and the kernels that take the most device time
    over one ``resquiggle_batch``, from torch.profiler."""
    return profile_call(lambda: br.resquiggle_batch(batch))


def profile_call(fn):
    """Device busy share, the kernels that take the most device time and
    the PyTorch calls the host made over one call of ``fn``, from
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    # device-side events only (kernels, copies, fills); their union is
    # the busy time
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    # PyTorch calls the host made (top-level CPU operator events)
    n_calls = sum(1 for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CPU and
                  e.cpu_parent is None)
    if not spans:
        return {"wall_s": wall, "torch_calls": n_calls,
                "device_busy": "not measured"}
    busy_us, end, by_name = 0.0, float("-inf"), {}
    for s, e, name in spans:
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
        us, n = by_name.get(name, (0.0, 0))
        by_name[name] = (us + e - s, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {"wall_s": wall, "torch_calls": n_calls,
            "device_busy_s": busy_us * 1e-6,
            "device_idle_share": 1.0 - busy_us * 1e-6 / wall,
            "top": [{"name": k[:60], "ms": us * 1e-3, "count": n}
                    for k, (us, n) in top]}


def layer_breakdown(fn, layers):
    """Seconds of one call of ``fn`` by layer: ``layers`` lists (owner,
    attribute, label); each layer's own time without the layers it calls,
    with a card synchronise at every layer edge."""
    acc = {label: 0.0 for _, _, label in layers}
    stack = []

    def timed(f, label):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stack.append(0.0)
            try:
                return f(*a, **kw)
            finally:
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                acc[label] += dt - stack.pop()
                if stack:
                    stack[-1] += dt
        return run

    with patched([(o, n, timed(getattr(o, n), label))
                  for o, n, label in layers]):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    acc["other (host)"] = wall - sum(acc.values())
    return {"wall_s": wall, "layers_s": acc}


def detection_index(results, rna, dev):
    """In-memory reads index of a path's re-squiggle results: the reads
    whose event means are device-resident on the card (there is no FAST5
    here).  Returns (index, reads left out, failed reads)."""
    from tombo_tpu_torch import config
    from tombo_tpu_torch.io.index import ReadsIndex
    from tombo_tpu_torch.stats import device_levels
    from tombo_tpu_torch.types import ReadData
    index, left, failed = ReadsIndex(), 0, 0
    for res, _ in results:
        if res is None:
            failed += 1
            continue
        gl, rid, n = res.genome_loc, res.align_info.read_id, len(res.segs) - 1
        if device_levels.lookup(rid, n, dev) is None:
            left += 1
            continue
        index.add_read_data(gl.chrom, gl.strand, ReadData(
            gl.start, gl.start + n, False, res.read_start_rel_to_raw,
            gl.strand, "", config.DEFAULT_CORRECTED_GROUP + "/" +
            res.align_info.subgroup, rna, res.sig_match_score,
            res.mean_q_score, rid))
    return index, left, failed


def register_cpu_copies(index, dev):
    """Register the card means of every read of ``index`` again as CPU
    tensors (one padded matrix), for the CPU runs of the same code."""
    from tombo_tpu_torch.stats import device_levels
    rows, entries = [], []
    for i, r in enumerate(index.iter_reads()):
        src, off = device_levels.lookup(r.read_id, r.end - r.start, dev)
        rows.append(src[off:off + r.end - r.start])
        entries.append((r.read_id, i, r.end - r.start))
    width = max(x.shape[0] for x in rows)
    mat = torch.stack([torch.nn.functional.pad(x, (0, width - x.shape[0]))
                       for x in rows]).cpu()
    device_levels.register_batch(mat, entries)


def detection_flips(got, want):
    """(sites, coverage mismatches, differing valid-coverage or fraction
    entries) between two lists of RegionStats of the same regions."""
    if [(s.chrm, s.strand, s.start) for s in got] != \
            [(s.chrm, s.strand, s.start) for s in want]:
        return None, None, None
    sites = cov_bad = flips = 0
    for a, b in zip(got, want):
        if not np.array_equal(a.reg_poss, b.reg_poss):
            return None, None, None
        sites += a.reg_poss.shape[0]
        cov_bad += int(np.sum(a.reg_cov != b.reg_cov))
        for f in ("valid_cov", "reg_frac_standard_base"):
            x, y = getattr(a, f), getattr(b, f)
            flips += int(np.sum(~((x == y) | (np.isnan(x) & np.isnan(y)))))
    return sites, cov_bad, flips


def det_dispatch_bound_ms(args, fm, pvals=False):
    """Least time of one packed dispatch: the larger of its bytes (the
    gathered means, ivec, the k-mer codes, the uint8 and int32 counts;
    with ``pvals`` also the real rows' float32 p-values) over the memory
    rate and ``det_ops_per_elem`` operations a (row, column) element of
    its real rows over the float32 rate."""
    flat, ivec, dev_groups, ref, W = args[:5]
    rows = int((ivec[2] > 0).sum())
    obs = int(ivec[2].long().sum())
    S = ref[1].shape[0]
    nbytes = (obs * 4 + ivec.numel() * 4 + ref[1].numel() *
              ref[1].element_size() + S * W * 3 * (4 + 1) +
              (rows * W * 4 if pvals else 0))
    t_b = nbytes / HBM_BYTES_PER_S
    t_o = rows * W * det_ops_per_elem(fm) / F32_OPS_PER_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def det_ops_per_elem(fm):
    """Float32 operations a (row, column) element of a packed dispatch
    needs, each arithmetic operation and each transcendental call counted
    once: z 3 (subtract, divide, abs), the two-sided p-value 3 (scale,
    compare, erf or erfc), clamp and log 2, the window sum 2 fm, Fisher's
    Q in log space with w = 2 fm + 1 terms (log x, w - 1 multiplies and
    subtracts, logsumexp's max, w subtracts, w exps, w - 1 adds and a
    log, minus x, exp, the inf test) 6 w + 2, the clamp 1, the masks 8
    (isnan, emit, two thresholds, or, and, above, and) and the count adds
    3."""
    w = 2 * fm + 1
    return 3 + 3 + 2 + 2 * fm + 6 * w + 2 + 1 + 8 + 3


def detection_run(label, index, params, fasta, model, ctrl, dev):
    """Detection passes on the card through ``iter_region_stats``: a
    first pass (PyTorch loads each CUDA kernel at its first use), the
    timed pass (every packed dispatch checked to run on the card and
    timed with CUDA events), a pass by layer and a profiled pass.
    Returns (summary, RegionStats list, the largest dispatch's
    arguments)."""
    from tombo_tpu_torch.stats import detect
    from tombo_tpu_torch.stats import device as sdev
    body = sdev.packed_test_and_accumulate
    events, biggest = [], [None, -1]

    def dispatch(*args):
        flat, ivec, dev_groups, ref = args[:4]
        tensors = [ivec] + [t for t in ref[1:]] + \
            ([flat] if flat is not None else []) + \
            [t for g in dev_groups for t in g]
        if any(t.device.type != dev.type for t in tensors):
            fail("%s: a packed dispatch got a tensor off the %s" % (
                label, dev.type))
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = body(*args)
        b.record()
        events.append((a, b))
        if ivec.shape[1] > biggest[1]:
            biggest[:] = [args, ivec.shape[1]]
        return out

    def run():
        return [st for _, st, _ in detect.iter_region_stats(
            index, params, fasta, model, ctrl, device=dev)]
    with patched([(sdev, "packed_test_and_accumulate", dispatch)]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        events.clear()
        t0 = time.perf_counter()
        stats = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    disp_ms = [a.elapsed_time(b) for a, b in events]
    obs = sum(int(st.reg_cov.sum()) for st in stats)
    reads = sum(len(v) for v in index.reads_index.values())
    layers = layer_breakdown(run, [
        (detect, "_prep_chunk", "region prep"),
        (sdev.PackedRegionBatch, "add_region", "pack"),
        (sdev.PackedRegionBatch, "dispatch", "dispatch"),
        (sdev.PackedRegionBatch, "unpack_region", "unpack to RegionStats"),
        (detect, "region_stats_from_accumulators", "unpack to RegionStats")])
    prof = profile_call(run)
    summary = {
        "run": label, "reads_in_index": reads,
        "regions": len(stats),
        "sites": sum(st.reg_poss.shape[0] for st in stats),
        "site_obs": obs, "dispatches": len(disp_ms),
        "dispatch_ms_sum": sum(disp_ms),
        "dispatch_ms_max": max(disp_ms) if disp_ms else None,
        "first_pass_s": first, "wall_s": wall,
        "site_obs_per_s": obs / wall,
        "layers": layers, "device_idle_share": prof.get(
            "device_idle_share", "not measured"),
        "torch_calls": prof["torch_calls"], "top": prof.get("top", [])[:4]}
    return summary, stats, biggest[0]


def bound_ms(nbytes, ops):
    """(least milliseconds, what bounds them): the larger of ``nbytes``
    over the memory rate and ``ops`` float32 operations over the float32
    rate."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def alt_llhr_bound_ms(args):
    """``alt_llhr``'s least time: its (H, k) windows, (H,) variances and
    (H,) ratios once each; a (hit, window position) element costs 12
    operations in the scaled form (two differences, squares, divisions,
    negations and exps, a difference and the sum's add) and 6 in the
    standard form (two differences, squares and sum adds), a hit 3 more
    (scale, power, product; standard 2: difference and division)."""
    mw, rw, aw, cv, standard = args[:5]
    H, k = mw.shape
    nbytes = (3 * H * k + 2 * H) * mw.element_size()
    ops = (6 * H * k + 2 * H) if standard else (12 * H * k + 3 * H)
    return bound_ms(nbytes, ops)


def level_test_bound_ms(name, samp, ctrl):
    """A level test's least time on (P, C) sample and control matrices:
    both read once and (P,) statistics written once; operations counted
    as a compare-and-swap per element and sort level (C log2 C a row and
    matrix), log2 C compares a ``searchsorted`` query, and per element:
    KS 10 on the (P, 2C) CDF pair (cap, cast, divide, twice, difference,
    abs, finite test, select, max), U 5 (cap, cast, compare, select,
    add), t 7 on each matrix (NaN test, select, add, difference, square,
    select, add); per site the Kolmogorov sum 225 (45 terms of 5), U's
    normal tail 10, t's incomplete beta 64 iterations x 2 steps x 12."""
    P, C = samp.shape
    lg = max(1.0, math.log2(C))
    if name == "ks":
        ops = 2 * P * C * lg + 2 * P * 2 * C * lg + 10 * P * 2 * C + 225 * P
    elif name == "u":
        ops = 2 * P * C * lg + P * C * lg + 5 * P * C + 10 * P
    else:
        ops = 2 * 7 * P * C + 64 * 2 * 12 * P + 50 * P
    nbytes = 2 * P * C * samp.element_size() + P * samp.element_size()
    return bound_ms(nbytes, ops)


class Probe:
    """Wraps a device-lane function: counts its calls, keeps the inputs
    of its largest call by ``size`` and the CUDA-event time of each call;
    forwards every call unchanged."""

    def __init__(self, fn, size):
        self.fn, self.size = fn, size
        self.calls, self.ms_events, self.big = 0, [], (None, -1, None)

    def __call__(self, *args, **kw):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = self.fn(*args, **kw)
        b.record()
        self.calls += 1
        self.ms_events.append((a, b))
        n = self.size(*args)
        if n > self.big[1]:
            self.big = (args, n, kw)
        return out

    def reset(self):
        self.calls, self.ms_events = 0, []

    def ms_sum(self):
        return sum(a.elapsed_time(b) for a, b in self.ms_events)


def region_key(results):
    return [(n, s.chrm, s.strand, s.start) for n, s, _ in results]


def level_diffs(got, want, tol):
    """(sites, NaN on one side only, largest |difference|) between two
    runs' GroupStats; None where positions or coverage differ."""
    if region_key(got) != region_key(want):
        return None
    sites = nan_diff = 0
    worst = 0.0
    for (_, a, _), (_, b, _) in zip(got, want):
        if not (np.array_equal(a.reg_poss, b.reg_poss) and
                np.array_equal(a.reg_cov, b.reg_cov) and
                np.array_equal(a.ctrl_cov, b.ctrl_cov)):
            return None
        ok = np.isfinite(a.reg_stats) & np.isfinite(b.reg_stats)
        sites += int(ok.sum())
        nan_diff += int(np.sum(np.isnan(a.reg_stats) !=
                               np.isnan(b.reg_stats)))
        if ok.any():
            worst = max(worst, float(np.max(np.abs(
                a.reg_stats[ok] - b.reg_stats[ok]))))
    return {"sites": sites, "nan_differs": nan_diff, "max_abs": worst,
            "bar": tol}


def per_read_aggregates_equal(label, results, params):
    """Each region's per-read block, aggregated without a file at the
    run's thresholds, against the region statistics of the same run:
    positions, coverage and valid coverage exact, fractions equal."""
    from tombo_tpu_torch.stats.aggregate import aggregate_block
    n = 0
    for name, st, pr in results:
        if pr is None:
            fail("%s: region %s:%s:%d has no per-read block" % (
                label, st.chrm, st.strand, st.start))
        agg = aggregate_block(pr[1], *pr[3:], params.single_read_thresh,
                              params.lower_thresh, params.stat_type)
        fa, fb = agg.reg_frac_standard_base, st.reg_frac_standard_base
        if not (np.array_equal(agg.reg_poss, st.reg_poss) and
                np.array_equal(agg.reg_cov, st.reg_cov) and
                np.array_equal(agg.valid_cov, st.valid_cov) and
                np.array_equal(fa, fb, equal_nan=True)):
            fail("%s: the aggregated per-read block of %s:%s:%d differs "
                 "from the region statistics" % (label, st.chrm, st.strand,
                                                  st.start))
        n += pr[1].shape[0]
    return n


def extra_detection_run(label, index, params, fasta, model, ctrl, dev,
                        probes, alt_refs=None, emit_per_read=False,
                        warm=False):
    """One detection run on the card through ``iter_region_stats``: a
    first pass (PyTorch loads its CUDA kernels; left out when ``warm``,
    after a run of the same device functions), the timed pass (the
    device-lane functions' calls counted and timed with CUDA events), a
    pass by layer and a profiled pass.  Returns (summary, results)."""
    from tombo_tpu_torch.stats import detect
    from tombo_tpu_torch.stats import device as sdev

    def run():
        return list(detect.iter_region_stats(
            index, params, fasta, model, ctrl, device=dev,
            alt_refs=alt_refs, emit_per_read=emit_per_read))
    with patched([(sdev, n, pr) for n, pr in probes.items()]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if not warm:
            run()
        torch.cuda.synchronize()
        first = None if warm else time.perf_counter() - t0
        for pr in probes.values():
            pr.reset()
        t0 = time.perf_counter()
        results = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        calls = {n: pr.calls for n, pr in probes.items() if pr.calls}
        dev_ms = {n: probes[n].ms_sum() for n in calls}
    layers = layer_breakdown(run, [
        (detect, "_prep_chunk", "region prep"),
        (sdev.PackedRegionBatch, "add_region", "pack"),
        (sdev.PackedRegionBatch, "dispatch", "dispatch"),
        (sdev.PackedRegionBatch, "read_streams", "per-read blocks"),
        (detect, "per_read_block", "per-read blocks"),
        (sdev, "alt_llhr", "alt_llhr dispatch"),
        (detect, "site_accumulators", "per-site fractions"),
        (detect, "_group_device_tests", "level dispatch"),
        (detect, "_group_post", "windows to GroupStats"),
        (sdev.PackedRegionBatch, "unpack_region", "unpack to RegionStats"),
        (detect, "region_stats_from_accumulators",
         "unpack to RegionStats")])
    layers["layers_s"] = {k: v for k, v in layers["layers_s"].items()
                          if v > 0}
    prof = profile_call(run)
    obs = sum(int(st.reg_cov.sum()) for _, st, _ in results)
    summary = {
        "run": label, "reads_in_index": sum(
            len(v) for v in index.reads_index.values()),
        "regions": len(results), "sites": sum(
            st.reg_poss.shape[0] for _, st, _ in results),
        "site_obs": obs, "device_calls": calls, "device_ms": dev_ms,
        "first_pass_s": first, "wall_s": wall, "site_obs_per_s": obs / wall,
        "layers": layers, "device_idle_share": prof.get(
            "device_idle_share", "not measured"),
        "torch_calls": prof["torch_calls"], "top": prof.get("top", [])[:4]}
    if emit_per_read:
        summary["per_read_entries"] = sum(
            pr[1].shape[0] for _, _, pr in results if pr is not None)
    print("detection %s: %s" % (label, json.dumps(summary)), flush=True)
    if not results:
        fail("detection %s: no region statistics" % label)
    return summary, results


def detection_more_phase(dev, br, outs, outs_r, fasta_1kb, fasta_r, model,
                         model_r):
    """The alternative-model test (five DNA models, scaled and standard,
    on the 1 kb path; RNA 5mC on the RNA path), per-read statistics
    (1 kb de novo and the five models, each region's per-read block
    aggregated without a file and held to the region statistics), and
    the level
    tests (ks, u, t and their _stat forms) on a new level path, at the
    JAX CLI's defaults, from the device means re-squiggle registered;
    every run again on CPU copies of the means at float32 and float64;
    then ``alt_llhr``, the level tests and the packed dispatch with
    per-read p-values, each alone.  Runs after the detection phase (the
    CPU copies of the 1 kb and RNA paths are registered) and before the
    mesh lane.  Returns the level path's (control index, sample index,
    reference)."""
    from tombo_tpu_torch import config, kernels
    from tombo_tpu_torch.io.model_io import load_alt_refs
    from tombo_tpu_torch.stats import detect
    from tombo_tpu_torch.stats import device as sdev
    try:
        import h5py
        print("h5py on the card: yes, %s" % h5py.__version__)
    except ImportError:
        print("h5py on the card: no")

    idx_1kb, _, _ = detection_index([r for o in outs for r in o], False, dev)
    idx_r, _, _ = detection_index([r for o in outs_r for r in o], True, dev)
    dna_alts = load_alt_refs(ALT_DNA, "DNA")
    rna_alts = load_alt_refs(["5mC"], "RNA")
    if sorted(dna_alts) != sorted(ALT_DNA) or not rna_alts:
        fail("the bundled alternative models did not load")

    def tp(stat_type, samp_type, **kw):
        th = {"model_compare": config.LLR_THRESH,
              "de_novo": config.DE_NOVO_THRESH}[stat_type][samp_type]
        return detect.TestParams(
            stat_type=stat_type, single_read_thresh=th[1],
            lower_thresh=th[0], min_test_reads=1,
            fm_offset=config.FM_OFFSET_DEFAULT,
            region_size=config.DEFAULT_REGION_SIZE, **kw)
    probes = {
        "alt_llhr": Probe(sdev.alt_llhr, lambda *a: a[0].shape[0]),
        "ks_tests": Probe(sdev.ks_tests, lambda *a: a[0].numel()),
        "u_tests": Probe(sdev.u_tests, lambda *a: a[0].numel()),
        "t_tests": Probe(sdev.t_tests, lambda *a: a[0].numel()),
        "packed_test_and_accumulate": Probe(
            sdev.packed_test_and_accumulate, lambda *a: a[1].shape[1])}
    # (label, index, params, reference, model, control, models,
    # per-read blocks, warm); the five-model run's per-read blocks hold
    # 5mC's among them
    runs = [
        ("1 kb alt, 5 DNA models, per-read", idx_1kb,
         tp("model_compare", "DNA"), fasta_1kb, model, None, dna_alts, True,
         False),
        ("1 kb alt 5mC, standard LLR", idx_1kb,
         tp("model_compare", "DNA", use_standard_llhr=True), fasta_1kb,
         model, None, {"5mC": dna_alts["5mC"]}, False, False),
        ("RNA alt 5mC", idx_r, tp("model_compare", "RNA"), fasta_r, model_r,
         None, rna_alts, False, True),
        ("1 kb de novo, per-read", idx_1kb, tp("de_novo", "DNA"), fasta_1kb,
         model, None, None, True, True)]
    out, alt_args, pv_args, lane_calls = [], None, None, {}
    for label, ix, p, fa, mo, ctrl, refs, per_read, warm in runs:
        summary, res = extra_detection_run(label, ix, p, fa, mo, ctrl, dev,
                                           probes, refs, per_read, warm)
        if per_read:
            n = per_read_aggregates_equal(label, res, p)
            print("detection %s: %d per-read entries, each region's "
                  "aggregation equal to its statistics" % (label, n))
        if label.startswith("1 kb alt, 5 DNA models"):
            alt_args = probes["alt_llhr"].big
        if label == "1 kb de novo, per-read":
            pv_args = probes["packed_test_and_accumulate"].big
        lane_calls[label] = summary["device_calls"]
        out.append((label, ix, p, fa, mo, ctrl, refs, per_read, res,
                    None))

    # the level path: batch 1 the control, batches 2-3 the sample
    _, _, _, lv_maps, fasta_lv = build_reads(
        [READ_LEN] * (BATCH * N_LEVEL_BATCHES), 4321, LEVEL_REF_LEN,
        "level_")
    lv_batches = [lv_maps[b * BATCH:(b + 1) * BATCH]
                  for b in range(N_LEVEL_BATCHES)]
    outs_lv, _, launches = run_path("level path", br, lv_batches, [])
    for name in ("banded_dp", "count_le"):
        if launches[name] <= 0:
            fail("kernel %s was not launched on the level path" % name)
    idx_ctrl, _, _ = detection_index(outs_lv[0], False, dev)
    idx_samp, _, _ = detection_index(outs_lv[1] + outs_lv[2], False, dev)
    for label, ix in (("control", idx_ctrl), ("sample", idx_samp)):
        per_strand = {s: len(v) for (_, s), v in ix.reads_index.items()}
        print("level path %s: %s reads a strand" % (label, per_strand))
    level_args = {}
    for stat_type in LEVEL_TYPES:
        p = detect.TestParams(stat_type=stat_type, fm_offset=1,
                              min_test_reads=LEVEL_MIN_TEST_READS,
                              region_size=config.DEFAULT_REGION_SIZE)
        label = "level " + stat_type
        summary, res = extra_detection_run(label, idx_samp, p, None, None,
                                           idx_ctrl, dev, probes,
                                           warm=stat_type.endswith("_stat"))
        fn = stat_type.replace("_stat", "") + "_tests"
        if not stat_type.endswith("_stat"):
            level_args[fn] = probes[fn].big
        lane_calls[label] = summary["device_calls"]
        for _, gs, _ in res:
            if not (gs.reg_poss.shape == gs.reg_cov.shape ==
                    gs.reg_stats.shape and
                    np.all(gs.reg_cov >= LEVEL_MIN_TEST_READS) and
                    np.all(gs.ctrl_cov >= LEVEL_MIN_TEST_READS)):
                fail("%s: malformed region %s:%s:%d" % (
                    label, gs.chrm, gs.strand, gs.start))
        out.append((label, idx_samp, p, None, None, idx_ctrl, None, False,
                    res, stat_type))

    # the same means as CPU tensors through the same code, float32 and
    # float64
    register_cpu_copies(idx_ctrl, dev)
    register_cpu_copies(idx_samp, dev)
    for label, ix, p, fa, mo, ctrl, refs, per_read, res, lv in out:
        t0 = time.perf_counter()
        cpu = {dt: list(detect.iter_region_stats(
            ix, p, fa, mo, ctrl, device="cpu", dtype=dt, alt_refs=refs,
            emit_per_read=per_read))
            for dt in (torch.float32, torch.float64)}
        check = {"cpu_s": time.perf_counter() - t0}
        for name, got, ref in (
                ("card_vs_cpu_f32", res, cpu[torch.float32]),
                ("card_vs_cpu_f64", res, cpu[torch.float64]),
                ("cpu_f32_vs_f64", cpu[torch.float32], cpu[torch.float64])):
            if lv is not None:
                d = level_diffs(got, ref, LEVEL_F32_ABS_TOL[lv])
                check[name] = d
                if d is None:
                    fail("%s, %s: positions or coverage differ" % (label,
                                                                  name))
                if d["nan_differs"] or d["max_abs"] > d["bar"]:
                    fail("%s, %s: statistics differ beyond the float32 "
                         "bar: %s" % (label, name, d))
                continue
            if region_key(got) != region_key(ref):
                fail("%s, %s: the regions differ" % (label, name))
            sites, cov_bad, flips = detection_flips(
                [s for _, s, _ in got], [s for _, s, _ in ref])
            check[name] = {"sites": sites, "coverage_differs": cov_bad,
                           "flips": flips}
            if sites is None or cov_bad:
                fail("%s, %s: positions or coverage differ" % (label, name))
            if flips > max(1, 2 * sites // 10000):
                fail("%s, %s: %d of %d entries flip" % (label, name, flips,
                                                        2 * sites))
            if per_read and not all(
                    np.array_equal(pa[1]["pos"], pb[1]["pos"]) and
                    np.array_equal(pa[1]["read_id"], pb[1]["read_id"]) and
                    pa[2] == pb[2]
                    for (_, _, pa), (_, _, pb) in zip(got, ref)):
                fail("%s, %s: per-read positions or reads differ" % (
                    label, name))
        print("detection %s, CPU cross-check: %s" % (label,
                                                      json.dumps(check)),
              flush=True)

    # each function alone: CUDA-event ms over 20 calls, its bound, its
    # PyTorch calls and its dispatches a run
    lines = []
    a = alt_args[0]
    b_ms, b_by = alt_llhr_bound_ms(a)
    lines.append({
        "function": "tombo_tpu_torch/stats/device.py::alt_llhr",
        "replaces": "tombo_tpu/stats/device.py:673 alt_llhr",
        "shape": {"H": a[0].shape[0], "k": a[0].shape[1],
                  "standard": bool(a[4])},
        "ms": cuda_ms(lambda: sdev.alt_llhr(*a), 20),
        "bound_ms": b_ms, "bound_by": b_by,
        "torch_calls": profile_call(lambda: sdev.alt_llhr(*a))[
            "torch_calls"],
        "dispatches": {k: v.get("alt_llhr", 0)
                       for k, v in lane_calls.items()},
        "library_ms": None})
    for fn in ("ks_tests", "u_tests", "t_tests"):
        a = level_args[fn][0]
        call = getattr(sdev, fn)
        b_ms, b_by = level_test_bound_ms(fn[0], a[0], a[1])
        lines.append({
            "function": "tombo_tpu_torch/stats/device.py::" + fn,
            "replaces": "tombo_tpu/stats/device.py:%d %s" % (
                {"ks_tests": 729, "u_tests": 754, "t_tests": 777}[fn], fn),
            "shape": {"P": a[0].shape[0], "C": a[0].shape[1],
                      "return_stat": bool(a[2])},
            "ms": cuda_ms(lambda: call(*a), 20),
            "bound_ms": b_ms, "bound_by": b_by,
            "torch_calls": profile_call(lambda: call(*a))["torch_calls"],
            "dispatches": {k: v.get(fn, 0) for k, v in lane_calls.items()
                           if v.get(fn)},
            "library_ms": None})
    # the packed dispatch of the per-read run: without p-values, and with
    # them fetched to the host as ``dispatch`` does
    a = pv_args[0][:11]
    body = sdev.packed_test_and_accumulate
    real = int((a[1][2] > 0).sum())
    p_ms, p_by = det_dispatch_bound_ms(a, config.FM_OFFSET_DEFAULT, True)
    lines.append({
        "function": "tombo_tpu_torch/stats/device.py::"
                    "packed_test_and_accumulate, want_pvals",
        "replaces": "tombo_tpu/stats/device.py:210 _packed_body "
                    "(want_pvals, fetched as :620)",
        "shape": {"rows": a[1].shape[1], "real_rows": real, "W": a[4],
                  "site_obs": int(a[1][2].long().sum())},
        "ms": cuda_ms(lambda: body(*a, True)[3][:real].cpu(), 20),
        "ms_without_pvals": cuda_ms(lambda: body(*a), 20),
        "bound_ms": p_ms, "bound_by": p_by,
        "pvals_bytes": real * a[4] * 4,
        "torch_calls": profile_call(
            lambda: body(*a, True)[3][:real].cpu())["torch_calls"],
        "torch_calls_without_pvals": profile_call(
            lambda: body(*a))["torch_calls"],
        "dispatches": {k: v.get("packed_test_and_accumulate", 0)
                       for k, v in lane_calls.items()
                       if v.get("packed_test_and_accumulate")},
        "library_ms": None})
    for line in lines:
        print("detection function: %s" % json.dumps(line), flush=True)
    return idx_ctrl, idx_samp, fasta_lv


def est_thresholds(label, idx, fasta, up, dn, dev, motif=None):
    """The CLI's minimum test reads and k-mer observations, each lowered
    to the largest value that covers every key of the model at this
    path's coverage; (min test reads, min k-mer observations)."""
    from tombo_tpu_torch import config
    from tombo_tpu_torch.errors import TomboError
    from tombo_tpu_torch.stats import estimate as est
    for cov in range(EST_MIN_TEST_READS, -1, -1):
        levels = est.extract_kmer_levels(
            idx, fasta, config.DEFAULT_REGION_SIZE, cov, up, dn, None,
            motif=motif, device=dev)
        for min_obs in range(EST_MIN_KMER_OBS, 0, -1):
            try:
                if motif is None:
                    est.tabulate_kmer_levels(levels, min_obs)
                else:
                    est.tabulate_mod_kmer_levels(levels, min_obs, motif)
            except TomboError as e:
                if "fewer observations" in str(e):
                    continue
                break
            if (cov, min_obs) != (EST_MIN_TEST_READS, EST_MIN_KMER_OBS):
                print("%s: minimum test reads %d, minimum k-mer "
                      "observations %d (the CLI's %d and %d leave a key "
                      "uncovered)" % (label, cov, min_obs,
                                      EST_MIN_TEST_READS, EST_MIN_KMER_OBS))
            return cov, min_obs
    return None


def levels_card_vs_cpu(got, want, sd_rtol):
    """Same regions, keys, list lengths (per-site counts) and centers;
    sds within ``sd_rtol``.  Returns the number of (center, sd) pairs, or
    None on any difference past the bar."""
    if len(got) != len(want):
        return None
    n = 0
    for g, w in zip(got, want):
        if list(g) != list(w):
            return None
        for key in w:
            if len(g[key]) != len(w[key]):
                return None
            if not w[key]:
                continue
            a, b = np.array(g[key]), np.array(w[key])
            if not (np.array_equal(a[:, 0], b[:, 0]) and np.allclose(
                    a[:, 1], b[:, 1], rtol=sd_rtol, atol=0)):
                return None
            n += a.shape[0]
    return n


def timed_command(label, fn, layers):
    """One command's wall time and launches, then its layer breakdown
    and its card idle share (each from a run of its own); returns the
    first run's result and a summary."""
    from tombo_tpu_torch import kernels
    for name in kernels.LAUNCHES:
        kernels.LAUNCHES[name] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    br = layer_breakdown(fn, layers)
    prof = profile_call(fn)
    summary = {"wall_s": wall, "launches": launches,
               "breakdown_s": br["layers_s"],
               "breakdown_wall_s": br["wall_s"],
               "device_idle_share": prof.get("device_idle_share",
                                             "not measured"),
               "torch_calls": prof["torch_calls"]}
    print("estimation %s: %s" % (label, json.dumps(summary)))
    return out, summary


def result_bars(g, c):
    """tests/test_batch_parity.py's bars between two results of one read:
    (within, the measured differences): start equal, same table length,
    boundaries equal on > 99%, shift and scale within 2e-3 of ``c``'s
    scale, score within 1e-2."""
    if (g.segs.shape != c.segs.shape or
            g.read_start_rel_to_raw != c.read_start_rel_to_raw):
        return False, {"start": [g.read_start_rel_to_raw,
                                 c.read_start_rel_to_raw],
                       "bases": [g.segs.shape[0], c.segs.shape[0]]}
    sc = c.scale_values.scale
    d = {"segs": float(np.mean(g.segs == c.segs)),
         "shift": abs(g.scale_values.shift - c.scale_values.shift) / sc,
         "scale": abs(g.scale_values.scale - sc) / sc,
         "score": abs(g.sig_match_score - c.sig_match_score)}
    return (d["segs"] > 0.99 and d["shift"] < 2e-3 and d["scale"] < 2e-3
            and d["score"] < 1e-2), d


def hold_results(label, got, want, names, allowed=0):
    """Each read's result against another run's: the same reads succeed,
    and those within :func:`result_bars`.  Prints every read that
    differs (both errors, or the differences) and the worst differences
    within the bars.  Fails when a read succeeds in one run only, when
    its start or table length differs, when more than ``allowed`` reads
    lie outside the bars, or when one of those misses
    ONE_READ_LOOSE_BARS."""
    worst = {"segs": 1.0, "shift": 0.0, "scale": 0.0, "score": 0.0}
    outside = 0
    for name, (g, ge), (c, ce) in zip(names, got, want):
        if (ge is None) != (ce is None):
            fail("%s %s: error %r, other run's error %r" % (
                label, name, ge, ce))
        if g is None:
            continue
        ok, d = result_bars(g, c)
        if "start" in d:
            fail("%s %s: start or table length differs %s" % (
                label, name, json.dumps(d)))
        if not ok:
            print("  %s %s: outside the bars %s" % (label, name,
                                                     json.dumps(d)))
            lb = ONE_READ_LOOSE_BARS
            if not (d["segs"] >= lb["segs"] and d["shift"] < lb["shift"]
                    and d["scale"] < lb["scale"]
                    and d["score"] < lb["score"]):
                fail("%s %s: outside the looser bars %s" % (
                    label, name, json.dumps(lb)))
            outside += 1
            continue
        worst = {"segs": min(worst["segs"], d["segs"]),
                 "shift": max(worst["shift"], d["shift"]),
                 "scale": max(worst["scale"], d["scale"]),
                 "score": max(worst["score"], d["score"])}
    print("%s: %d of %d reads outside the bars (%d allowed); worst within "
          "them: %s" % (label, outside, len(got), allowed,
                        json.dumps(worst)))
    if outside > allowed:
        fail("%s: %d of %d reads outside the bars" % (label, outside,
                                                       len(got)))
    return outside


def one_read_calls(model, params, save, sst, maps, device, dtype=None):
    """Each read through ``resquiggle_read_with_retries``: (result, error)
    per read and the wall seconds of the whole run."""
    from tombo_tpu_torch import config
    from tombo_tpu_torch.errors import TomboError
    from tombo_tpu_torch.pipeline import resquiggle as rsq
    out = []
    t0 = time.perf_counter()
    for mr in maps:
        try:
            out.append((rsq.resquiggle_read_with_retries(
                mr, model, params, save,
                outlier_thresh=config.OUTLIER_THRESH, seq_samp_type=sst,
                device=device, dtype=dtype), None))
        except TomboError as e:
            out.append((None, str(e)))
    if device != "cpu":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def one_read_picks(model, maps, results):
    """The mixed path's reads for the one-read phase: the longest, the
    shortest that takes the static band (fewer events than start
    discovery needs, ``find_adaptive_base_assignment``) and the reads at
    evenly spaced ranks of length between them, ``ONE_READ_MIXED`` in
    all."""
    from tombo_tpu_torch import config
    from tombo_tpu_torch.pipeline import resquiggle as rsq
    p = config.load_resquiggle_parameters("DNA")
    n_bases = np.array([len(m.genome_seq) for m in maps])
    n_ev = np.array([rsq.compute_num_events(
        m.raw_signal.shape[0], n - model.kmer_width + 1,
        p.mean_obs_per_event) - 1 for m, n in zip(maps, n_bases)])
    order = np.argsort(n_bases, kind="stable")
    static = [i for i in order if n_ev[i] < p.start_bw + p.start_n_bases]
    if not static:
        fail("one_read: no mixed read takes the static band")
    rest = [i for i in order if i != static[0] and i != order[-1] and
            results[i][0] is not None]
    mid = [rest[int(k)] for k in np.linspace(0, len(rest) - 1,
                                            ONE_READ_MIXED - 2)]
    pick = [int(static[0])] + [int(i) for i in mid] + [int(order[-1])]
    return pick


def b1_rows(rec, launches, n_calls):
    """The one-read phase's kernels at a batch of one, timed on the inputs
    the phase gave them: K1 (the longest fused bw-300 call of at most
    ONE_READ_K1_ROWS rows, a 1 kb read's), K4 (the
    start DP's K1 launch at start_bw), the chunked pair (the longest
    read's call, if it ran chunked) and K5 (the count at the fit's
    largest shape).  Each row: CUDA-event ms, launches a one-read call,
    the bound as ``k1_bound_ms``/``bound_ms`` compute it, the plain
    version's ms and the library call's."""
    from tombo_tpu_torch.ops import banded_dp, rescale
    k1, k2, k5 = (banded_dp.adaptive_banded_dp_tb,
                  banded_dp.adaptive_banded_dp_tb_chunked, rescale.count_le)
    rows = {}
    per_call = lambda n: n / n_calls
    fused = [k for k in rec["k1"].calls
             if k[1] == ONE_READ_BW and k[0] <= ONE_READ_K1_ROWS]
    start = [k for k in rec["k1"].calls if k[1] == ONE_READ_START_BW]
    for name, key, launch_name in (("banded_dp", max(fused), "banded_dp"),
                                   ("start_dp", max(start), "start_dp")):
        _, args, _ = rec["k1"].calls[key]
        ko, po = k1(*args), banded_dp.adaptive_banded_dp_tb_plain(*args)
        torch.cuda.synchronize()
        same_flags, frac, ferr = dp_compare(ko, po, args[4], args[10])
        check_dp_bars("%s at B 1" % name, same_flags, frac, ferr)
        bound, by = k1_bound_ms(args, args[9].bandwidth)
        rows[name] = {
            "B": 1, "L": args[10], "bw": args[9].bandwidth,
            "launches_per_read": per_call(launches[launch_name]),
            "max_abs_err": ferr, "segs_equal_frac": frac,
            "ms": cuda_ms(lambda: k1(*args), 20),
            "plain_ms": cuda_ms(
                lambda: banded_dp.adaptive_banded_dp_tb_plain(*args), 2),
            "bound_ms": bound, "bound_by": by, "library_ms": None}
    if rec["k2"].calls:
        _, args, kw = max(rec["k2"].calls.values(),
                          key=lambda v: v[1][10])
        co, ko = k2(*args, **kw), k1(*args)
        torch.cuda.synchronize()
        assert_bitwise("one-read chunked pair at B 1", co, ko)
        # K1's plain version (the pair is bitwise K1) on CPU copies of
        # the same inputs: at B 1 a plain row costs ~2 ms on the card and
        # less on the host; the chunked plain, which recomputes every
        # chunk, took 41.3 s there at L 30,000 (H100 80GB HBM3 host,
        # PERF.md)
        cpu_args = [a.cpu() if torch.is_tensor(a) else a for a in args]
        t0 = time.perf_counter()
        po = banded_dp.adaptive_banded_dp_tb_plain(*cpu_args)
        plain_cpu_ms = 1e3 * (time.perf_counter() - t0)
        same_flags, frac, ferr = dp_compare(
            co, [t.to(co[0].device) for t in po], args[4], args[10])
        check_dp_bars("one-read chunked pair at B 1", same_flags, frac, ferr)
        fwd_ms, tb_ms = pair_split_ms(lambda: k2(*args, **kw), 5)
        bound, by = k1_bound_ms(args, args[9].bandwidth)
        for name, ms in (("banded_dp_chunked_fwd", fwd_ms),
                         ("banded_dp_chunked_tb", tb_ms)):
            rows[name] = {
                "B": 1, "L": args[10], "bw": args[9].bandwidth,
                "Lc": kw["chunk_rows"], "bitwise_k1": True,
                "launches_per_read": per_call(launches[name]),
                "max_abs_err": ferr, "segs_equal_frac": frac, "ms": ms,
                "plain_ms": "not measured on the card (the plain row "
                            "loop there takes about a minute)",
                "plain_cpu_ms": plain_cpu_ms, "plain": "K1's, on the CPU",
                "bound_ms": bound, "bound_by": by, "library_ms": None}
    keys, piv = max(rec["k5"].calls.values(), key=lambda v: v[0])[1]
    cerr = int((k5(keys, piv) - rescale.count_le_plain(keys, piv)).abs()
               .max())
    if cerr != 0:
        fail("count_le at B 1 differs from the plain version by %d" % cerr)
    B5, M5 = keys.shape
    P5 = piv.shape[1]
    ev, mod, n_pts = max(rec["ts"].calls.values(), key=lambda v: v[0])[1][:3]
    k_rank = int(rescale._pair_ranks(n_pts)[2][0]) + 1
    t_b = (B5 * M5 * 4 + 3 * B5 * P5 * 4) / HBM_BYTES_PER_S
    t_o = 2 * B5 * M5 * P5 / F32_OPS_PER_S
    rows["count_le"] = {
        "B": B5, "M": M5, "P": P5, "points": int(n_pts[0]),
        "launches_per_read": per_call(launches["count_le"]),
        "max_abs_err": cerr, "ms": cuda_ms(lambda: k5(keys, piv), 20),
        "plain_ms": cuda_ms(lambda: rescale.count_le_plain(keys, piv), 5),
        "bound_ms": 1e3 * max(t_b, t_o),
        "bound_by": "bytes" if t_b >= t_o else "operations",
        "library_ms": cuda_ms(lambda: torch.kthvalue(keys, k_rank, dim=1),
                              5)}
    return rows


def one_read_phase(dev, smi, paths, stages):
    """The one-read API (``resquiggle_read_with_retries``) on the card:
    ONE_READ_1KB reads of the 1 kb path's first batch, ONE_READ_MIXED of
    the mixed path (:func:`one_read_picks`) and ONE_READ_RNA of the RNA
    path (stall reads among them), each held against the batched lane's
    card result for the same read; ONE_READ_CPU of them again on the CPU
    at float64; the DNA reads of at most 1,000 bases against the native
    single-core baseline; K1, K4 and K5 launched; then the kernels at
    their B 1 shapes (:func:`b1_rows`), ``compute_base_mean_stds_batch``
    on the card against the CPU, and the static band's seconds in the
    mixed and RNA breakdowns.  ``paths``: (label, model, params, sst,
    maps, batch results) per path.  Returns (launches, B 1 rows)."""
    from tombo_tpu_torch import config, kernels, native
    from tombo_tpu_torch.errors import TomboError
    from tombo_tpu_torch.ops import banded_dp, rescale
    from tombo_tpu_torch.ops import normalize as nrm
    from tombo_tpu_torch.pipeline import resquiggle as rsq
    from tombo_tpu_torch.types import ScaleValues
    rec = {"k1": Recorder(banded_dp.adaptive_banded_dp_tb, dp_key),
           "k2": Recorder(banded_dp.adaptive_banded_dp_tb_chunked, dp_key),
           "k5": Recorder(rescale.count_le,
                          lambda keys, piv: (piv.shape[1], keys.shape[1])),
           "ts": Recorder(rescale.theil_sen_device,
                          lambda ev, *a, **kw: (ev.shape[1], ev.shape[1]))}
    static = {"calls": 0}
    static_fn = native.static_base_assignment

    def static_rec(*a, **kw):
        static["calls"] += 1
        return static_fn(*a, **kw)
    runs = []
    with patched([(banded_dp, "adaptive_banded_dp_tb", rec["k1"]),
                  (banded_dp, "adaptive_banded_dp_tb_chunked", rec["k2"]),
                  (rescale, "count_le", rec["k5"]),
                  (rescale, "theil_sen_device", rec["ts"]),
                  (native, "static_base_assignment", static_rec)]):
        for name in kernels.LAUNCHES:
            kernels.LAUNCHES[name] = 0
        for label, model, params, sst, maps, batch_res in paths:
            save = config.load_resquiggle_parameters(
                sst.name, use_save_bandwidth=True)
            got, wall = one_read_calls(model, params, save, sst, maps,
                                       DEVICE)
            n_ok = sum(1 for r, _ in got if r is not None)
            lens = [len(m.genome_seq) - model.kmer_width + 1 for m in maps]
            print("one-read %s: %d/%d reads ok in %.2f s = %.1f reads/s on "
                  "the card (%s); bases %d to %d%s" % (
                      label, n_ok, len(got), wall, n_ok / wall, smi,
                      min(lens), max(lens),
                      " (%s)" % lens if len(lens) <= ONE_READ_MIXED else ""))
            runs.append((label, model, params, sst, maps, batch_res, got))
        launches = dict(kernels.LAUNCHES)
    n_calls = sum(len(r[4]) for r in runs)
    print("one-read launches (%d reads): %s; static band calls %d" % (
        n_calls, json.dumps(launches), static["calls"]))
    for name in ("banded_dp", "start_dp", "count_le"):
        if launches[name] <= 0:
            fail("one_read: kernel %s was not launched" % name)
    if static["calls"] <= 0:
        fail("one_read: no read took the static band")
    from tombo_tpu_torch.pipeline.batch import _pow2_bucket
    model_m, maps_m = runs[1][1], runs[1][4]
    long_L = max(len(m.genome_seq) for m in maps_m) - model_m.kmer_width + 1
    if banded_dp.plan_dp_layout(_pow2_bucket(long_L, 256),
                                ONE_READ_BW)[0] == "chunked" and not (
            launches["banded_dp_chunked_fwd"] and
            launches["banded_dp_chunked_tb"]):
        fail("one_read: the longest mixed read did not run chunked")

    for label, model, params, sst, maps, batch_res, got in runs:
        names = [m.align_info.read_id for m in maps]
        hold_results("one-read %s vs the batched lane" % label, got,
                     batch_res, names, allowed=math.ceil(
                         ONE_READ_BATCHED_OUTSIDE * len(got)))
    # the CPU at float64 from CPU copies (ONE_READ_CPU)
    cpu_in, cpu_got, cpu_names = [], [], []
    for (label, model, params, sst, maps, _, got), idx in zip(
            runs, ONE_READ_CPU):
        save = config.load_resquiggle_parameters(sst.name,
                                                 use_save_bandwidth=True)
        sub = [maps[i] for i in idx]
        out, wall = one_read_calls(model, params, save, sst, sub, "cpu",
                                   torch.float64)
        print("one-read %s: %d reads (bases %s) on the CPU at float64 in "
              "%.1f s" % (label, len(sub), [
                  len(m.genome_seq) - model.kmer_width + 1 for m in sub],
                  wall))
        cpu_in += out
        cpu_got += [got[i] for i in idx]
        cpu_names += [m.align_info.read_id for m in sub]
    hold_results("one-read card vs CPU float64", cpu_got, cpu_in, cpu_names)

    # the native baseline on the DNA reads of at most 1,000 bases that
    # have the events start discovery needs (the baseline has no static
    # band: it fails those reads)
    smt = config.SIG_MATCH_THRESH["DNA"]
    base_got, base_want, base_names = [], [], []
    t_base, n_static = 0.0, 0
    for label, model, params, sst, maps, _, got in runs[:2]:
        save = config.load_resquiggle_parameters("DNA",
                                                 use_save_bandwidth=True)
        for mr, g in zip(maps, got):
            rm, rs = model.get_exp_levels_from_seq(mr.genome_seq)
            if rm.shape[0] > ONE_READ_BASELINE_BASES:
                continue
            if rsq.compute_num_events(
                    mr.raw_signal.shape[0], rm.shape[0],
                    params.mean_obs_per_event) - 1 < \
                    params.start_bw + params.start_n_bases:
                n_static += 1
                continue
            t0 = time.perf_counter()
            try:
                segs, rsrtr, sc, score = \
                    native.resquiggle_read_baseline_with_retries(
                        mr.raw_signal, rm, rs, params, save,
                        config.OUTLIER_THRESH, smt)
                want = (mr.replace(
                    segs=segs, read_start_rel_to_raw=rsrtr,
                    scale_values=ScaleValues(sc[0], sc[1], sc[2], sc[3],
                                             config.OUTLIER_THRESH),
                    sig_match_score=score), None)
            except TomboError as e:
                want = (None, str(e))
            t_base += time.perf_counter() - t0
            base_got.append(g)
            base_want.append(want)
            base_names.append(mr.align_info.read_id)
    print("native baseline: %d DNA reads in %.3f s = %.1f reads/s on one "
          "CPU core (%d static-band reads left out)" % (
              len(base_got), t_base, len(base_got) / t_base, n_static))
    hold_results("one-read card vs native baseline", base_got, base_want,
                 base_names)

    rows = b1_rows(rec, launches, n_calls)
    print("one-read kernels at B 1 (%s): %s" % (smi, json.dumps(rows)))

    # compute_base_mean_stds_batch on the 1 kb batch's normalized signal
    ok = [r for r, _ in paths[0][5] if r is not None]
    S = max(r.raw_signal.shape[0] for r in ok)
    L = max(r.segs.shape[0] for r in ok)
    norm = np.zeros((len(ok), S), np.float32)
    segs = np.zeros((len(ok), L), np.int64)
    for i, r in enumerate(ok):
        norm[i, :r.raw_signal.shape[0]] = r.raw_signal
        segs[i, :r.segs.shape[0]] = r.segs
    n_segs = np.array([r.segs.shape[0] - 1 for r in ok])
    args = [torch.tensor(a) for a in (norm, segs, n_segs)]
    cpu_ms = nrm.compute_base_mean_stds_batch(*args)
    card_ms = nrm.compute_base_mean_stds_batch(*[a.to(dev) for a in args])
    err = max(float((c.cpu() - g).abs().max())
              for c, g in zip(card_ms, cpu_ms))
    bitwise = all(torch.equal(c.cpu(), g) for c, g in zip(card_ms, cpu_ms))
    print("compute_base_mean_stds_batch (B %d, S %d, L %d): card vs CPU "
          "max |diff| %g, bitwise %s, card %.3f ms" % (
              len(ok), S, L - 1, err, bitwise, cuda_ms(
                  lambda: nrm.compute_base_mean_stds_batch(
                      *[a.to(dev) for a in args]), 5)))
    if not err <= 1e-5:
        fail("compute_base_mean_stds_batch: card vs CPU differ by %g" % err)
    for label, st in stages:
        print("static band (host), %s batch of %d reads: %.4f s of %.3f s "
              "(%d reads, %d bases; native static band; %s)" % (
                  label, st["reads"], st["stages_s"]["static band (host)"],
                  st["wall_s"], st["static_band"]["reads"],
                  st["static_band"]["bases"], smi))
    return launches, rows


def estimation_phase(dev, br, outs, outs_r, batches, rna, fasta_1kb,
                     fasta_r, model, model_r):
    """Model estimation (build_model) from the device means the paths
    registered: the canonical 6-mer DNA model with the re-centring fit
    over the 1 kb path's reads (K5), the first bundled motif model the
    coverage allows, the density model of an alternative sample
    re-squiggled here, and the RNA canonical 5-mer model with the RNA
    re-centring; each cross-checked on CPU copies of the same means.
    Returns K5's summary at the re-centring shape and the alternative
    sample's index."""
    from tombo_tpu_torch import config, kernels
    from tombo_tpu_torch.errors import TomboError
    from tombo_tpu_torch.io.model_io import KmerModel
    from tombo_tpu_torch.ops import normalize as nrm
    from tombo_tpu_torch.ops import rescale
    from tombo_tpu_torch.seq import TomboMotif, all_kmers
    from tombo_tpu_torch.stats import estimate as est
    from tombo_tpu_torch.stats import estimate_device as estd
    k5 = rescale.count_le
    res_1kb = [r for o in outs for r in o]
    res_r = [r for o in outs_r for r in o]
    idx, _, _ = detection_index(res_1kb, False, dev)
    idx_r, _, _ = detection_index(res_r, True, dev)
    # the raw signals as a FAST5 file would store them (RNA unflipped)
    src = est.MemoryReadSource(res_1kb, {
        m.align_info.read_id: m.raw_signal for b in batches for m in b})
    src_r = est.MemoryReadSource(res_r, {
        m.align_info.read_id: m.raw_signal[::-1] for b in rna for m in b})
    rs = config.DEFAULT_REGION_SIZE
    canon_layers = [
        (estd, "site_stats", "site statistics"),
        (estd, "_bucket_region", "k-mer bucketing (host)"),
        (estd, "_chunk_device", "site stacking and dispatch"),
        (est, "tabulate_kmer_levels", "tabulation"),
        (nrm, "normalize_median_batch", "normalize"),
        (est, "_rna_norm", "RNA changepoints, stalls and scale"),
        (nrm, "compute_base_means_batch", "event means"),
        (rescale, "count_le", "K5"),
        (rescale, "masked_median_sorted", "medians"),
        (rescale, "theil_sen_device", "Theil-Sen keys and selection"),
        (est, "read_corr_factors", "re-centring host preparation")]

    # -- the canonical DNA model: 6-mers, re-centred over every read
    th = est_thresholds("canonical DNA", idx, fasta_1kb, 2, 3, dev)
    if th is None:
        fail("estimation: no threshold covers every 6-mer")
    cov, min_obs = th
    rec5 = Recorder(k5, lambda keys, piv: (piv.shape[1], keys.shape[0] *
                                           keys.shape[1]))
    with patched([(rescale, "count_le", rec5)]):
        std6, canon = timed_command(
            "canonical DNA 6-mer model", lambda: est.estimate_kmer_model(
                idx, fasta_1kb, cov, 2, 3, min_obs, False, None,
                region_size=rs, read_source=src, device=dev),
            canon_layers)
    if canon["launches"].get("count_le", 0) <= 0:
        fail("estimation: the re-centring fit launched no count_le")
    r = float(np.corrcoef(std6.means, model.means)[0, 1])
    print("canonical DNA model: %d reads, min test reads %d, min k-mer "
          "observations %d; correlation of the estimated means with the "
          "generating model %.4f" % (sum(len(v) for v in
                                         idx.reads_index.values()), cov,
                                     min_obs, r))
    if not (np.isfinite(std6.means).all() and r > 0.9):
        fail("estimation: canonical model means not finite or "
             "uncorrelated (r %.4f)" % r)

    # K5 at the re-centring shape, against its plain version
    keys, piv = max(rec5.calls.values(), key=lambda v: v[0])[1]
    cerr = int((k5(keys, piv) - rescale.count_le_plain(keys, piv)).abs()
               .max())
    if cerr != 0:
        fail("count_le at the re-centring shape differs from the plain "
             "version by %d" % cerr)
    B5, M5 = keys.shape
    P5 = piv.shape[1]
    t_b = (B5 * M5 * 4 + 3 * B5 * P5 * 4) / HBM_BYTES_PER_S
    t_o = 2 * B5 * M5 * P5 / F32_OPS_PER_S
    n_valid = int((keys != 2 ** 31 - 1).sum(1).max())
    k_rank = max(1, (n_valid + 1) // 2)
    try:
        lib5 = cuda_ms(lambda: torch.kthvalue(keys, k_rank, dim=1), 5)
    except RuntimeError as e:          # yardstick only, never on the path
        print("torch.kthvalue yardstick unavailable: %s" % e)
        lib5 = None
    k5_est = {"B": B5, "M": M5, "P": P5, "max_abs_err": cerr,
              "launches": canon["launches"]["count_le"],
              "ms": cuda_ms(lambda: k5(keys, piv), 10),
              "plain_ms": cuda_ms(lambda: rescale.count_le_plain(keys, piv),
                                  3),
              "bound_ms": 1e3 * max(t_b, t_o),
              "bound_by": "bytes" if t_b >= t_o else "operations",
              "library_ms": lib5}
    print("count_le at the re-centring shape: %s" % json.dumps(k5_est))

    # -- the motif model: the first bundled motif covering every key
    motif_used = None
    for desc in EST_MOTIFS:
        raw, pos = desc.split(":")
        th_m = est_thresholds("motif %s" % desc, idx, fasta_1kb, 2, 3, dev,
                              TomboMotif(raw, int(pos)))
        if th_m is not None:
            motif_used = desc
            break
        print("motif %s: a (k-mer, offset) key is not covered at this "
              "coverage" % desc)
    if motif_used is None:
        fail("estimation: no bundled motif is covered")
    alt_m, motif_sum = timed_command(
        "motif %s model" % motif_used, lambda: est.estimate_motif_alt_model(
            idx, fasta_1kb, motif_used, 2, 3, th_m[1], th_m[0], None,
            region_size=rs, device=dev),
        canon_layers[:3] + [(est, "tabulate_mod_kmer_levels",
                             "tabulation")])
    n_def = int(np.isfinite(alt_m.means).sum())
    print("motif model %s: %d defined (k-mer, offset) levels, min test "
          "reads %d, min k-mer observations %d" % (
              motif_used, n_def, th_m[0], th_m[1]))
    if n_def == 0 or not np.isfinite(alt_m.sds[np.isfinite(
            alt_m.means)]).all():
        fail("estimation: malformed motif model")

    # -- the density model: an alternative sample re-squiggled here
    sim = KmerModel(model.means.copy(), model.sds.copy(), model.central_pos)
    for code, km in enumerate(all_kmers(model.kmer_width)):
        if "C" in km:
            sim.means[code] += ALT_SHIFT
    t0 = time.perf_counter()
    _, _, _, alt_maps, _ = build_reads(
        [READ_LEN] * (BATCH * N_ALT_BATCHES), 8642, REF_LEN_1KB, "alt_",
        sim_model=sim)
    print("alternative sample: %d reads simulated in %.1f s" % (
        len(alt_maps), time.perf_counter() - t0))
    outs_alt, _, launches = run_path("alternative sample", br, [
        alt_maps[b * BATCH:(b + 1) * BATCH] for b in range(N_ALT_BATCHES)],
        [])
    for name in ("banded_dp", "count_le"):
        if launches[name] <= 0:
            fail("kernel %s was not launched on the alternative sample" %
                 name)
    idx_alt, _, _ = detection_index([x for o in outs_alt for x in o], False,
                                    dev)
    save_x = np.linspace(config.KERNEL_DENSITY_RANGE[0],
                         config.KERNEL_DENSITY_RANGE[1],
                         config.NUM_DENS_POINTS)
    dens = {}

    def kde_rec(flat, counts, *a, **kw):
        out = est_kde(flat, counts, *a, **kw)
        dens.setdefault(flat.device.type, []).append(out)
        return out
    est_kde = est.kde_evaluate
    with patched([(est, "kde_evaluate", kde_rec)]):
        alt_c, alt_sum = timed_command(
            "density model (C)", lambda: est.estimate_alt_model(
                idx_alt, idx, model, "C", ALT_PCTL, ALT_KMER_OBS,
                kernel_dens_bw=ALT_BW, fasta=fasta_1kb, device=dev),
            [(est, "parse_base_levels_flat", "base-level parsing"),
             (est, "kde_evaluate", "KDE"),
             (est, "isolate_alt_density", "isolation")])
    single = [c for c, km in enumerate(all_kmers(model.kmer_width))
              if km.count("C") == 1]
    shift = [alt_c.means[c, all_kmers(model.kmer_width)[c].index("C")] -
             model.means[c] for c in single]
    print("density model: %d defined levels; mean level shift at single-C "
          "6-mers %.4f (simulated %+.1f)" % (
              int(np.isfinite(alt_c.means).sum()), float(np.mean(shift)),
              ALT_SHIFT))
    if not np.isfinite(shift).all():
        fail("estimation: density model has undefined single-C levels")

    # -- the RNA canonical model: 5-mers, the RNA re-centring
    th_r = est_thresholds("canonical RNA", idx_r, fasta_r, 1, 3, dev)
    if th_r is None:
        fail("estimation: no threshold covers every RNA 5-mer")
    rna5, rna_sum = timed_command(
        "canonical RNA 5-mer model", lambda: est.estimate_kmer_model(
            idx_r, fasta_r, th_r[0], 1, 3, th_r[1], False, None,
            region_size=rs, read_source=src_r, device=dev), canon_layers)
    if rna_sum["launches"].get("count_le", 0) <= 0:
        fail("estimation: the RNA re-centring fit launched no count_le")
    r_r = float(np.corrcoef(rna5.means, model_r.means)[0, 1])
    print("canonical RNA model: min test reads %d, min k-mer observations "
          "%d; correlation with the generating model %.4f" % (
              th_r[0], th_r[1], r_r))
    if not np.isfinite(rna5.means).all():
        fail("estimation: RNA model means not finite")

    # -- the same means as CPU tensors through the same code
    t0 = time.perf_counter()
    for ix in (idx, idx_r, idx_alt):
        register_cpu_copies(ix, dev)
    check = {}
    for label, ix, fa, up, dn, c in (("DNA", idx, fasta_1kb, 2, 3, cov),
                                     ("RNA", idx_r, fasta_r, 1, 3,
                                      th_r[0])):
        card = est.extract_kmer_levels(ix, fa, rs, c, up, dn, None,
                                       device=dev)
        cpu32 = est.extract_kmer_levels(ix, fa, rs, c, up, dn, None,
                                        device="cpu")
        n = levels_card_vs_cpu(card, cpu32, 1e-5)
        if n is None:
            fail("estimation %s: card and CPU float32 site statistics "
                 "differ (counts, centers or sds past 1e-5)" % label)
        cpu64 = est.extract_kmer_levels(ix, fa, rs, c, up, dn, None,
                                        device="cpu", dtype=torch.float64)
        d = max(abs(a[1] - b[1]) for a, b in zip(
            est.tabulate_kmer_levels(card, 1),
            est.tabulate_kmer_levels(cpu64, 1)))
        check[label] = {"site_pairs": n, "tabulated_mean_max_abs_f64": d}
        if d > 5e-3:
            fail("estimation %s: tabulated means card vs CPU float64 %g" %
                 (label, d))
    # re-centring corrections, float64 on the CPU over the first reads
    c_sh, c_sc = est.read_corrections(idx, std6, EST_F64_READS,
                                      read_source=src, device=dev)
    f_sh, f_sc = est.read_corrections(idx, std6, EST_F64_READS,
                                      read_source=src, device="cpu",
                                      dtype=torch.float64)
    dsh = float(np.max(np.abs(np.subtract(c_sh, f_sh))))
    dsc = float(np.max(np.abs(np.subtract(c_sc, f_sc))))
    check["corrections_f64"] = {"reads": len(f_sh), "shift_max_abs": dsh,
                                "scale_max_abs": dsc}
    if len(c_sh) != len(f_sh) or dsh > 2e-3 or dsc > 2e-3:
        fail("estimation: re-centring corrections card vs CPU float64 %s" %
             check["corrections_f64"])
    # densities, float64 on both from the same float32 observations
    cpu_dens = [est.est_kernel_density(ix, model, ALT_KMER_OBS, None,
                                       save_x, ALT_BW, fasta=fasta_1kb,
                                       device="cpu")
                for ix in (idx_alt, idx)]
    worst = 0.0
    for card_d, cpu_d in zip(dens[dev.type][:2], cpu_dens):
        cpu_m = np.stack([cpu_d[km] for km in all_kmers(model.kmer_width)])
        a = card_d.cpu().numpy()
        worst = max(worst, float(np.max(np.abs(a - cpu_m) /
                                        np.maximum(np.abs(cpu_m), 1e-300)
                                        * (np.abs(cpu_m) > 1e-14))))
        if not np.allclose(a, cpu_m, rtol=1e-10, atol=1e-14):
            fail("estimation: densities card vs CPU past 1e-10")
    check["kde_f64_max_rel"] = worst
    check["cpu_s"] = time.perf_counter() - t0
    print("estimation CPU cross-check: %s" % json.dumps(check))
    return k5_est, idx_alt


def stat_blocks(stats):
    """The JAX-protocol block iterable of in-memory RegionStats: (chrm,
    strand, start, end, records with ``pos`` and ``stat``, the fraction
    of the standard base), sites without a fraction left out as a
    statistics file leaves them out."""
    from tombo_tpu_torch import config
    out = []
    for st in stats:
        keep = ~np.isnan(st.reg_frac_standard_base)
        rec = np.empty(int(keep.sum()), [("pos", "u4"), ("stat", "f8")])
        rec["pos"] = st.reg_poss[keep]
        rec["stat"] = st.reg_frac_standard_base[keep]
        out.append((st.chrm, st.strand, st.start,
                    st.start + config.DEFAULT_REGION_SIZE, rec))
    return out


def most_signif_regions(stats, num_bases, num_regions):
    """``get_most_signif_regions``' regions of in-memory RegionStats:
    ``num_bases`` around the sites of least damped fraction (the
    statistics file's order), each site's window used once."""
    from tombo_tpu_torch import config
    from tombo_tpu_torch.stats.kernels import calc_damp_fraction
    sites = []
    for st in stats:
        damp = calc_damp_fraction(config.COV_DAMP_COUNTS,
                                  st.reg_frac_standard_base, st.valid_cov)
        sites += [(float(d), st.chrm, st.strand, int(p))
                  for d, p in zip(damp, st.reg_poss) if not np.isnan(d)]
    sites.sort()
    used, out = set(), []
    for i, (d, chrm, strand, pos) in enumerate(sites):
        if (chrm, strand, pos) in used:
            continue
        start = max(0, pos - num_bases // 2)
        used.update((chrm, strand, p) for p in range(start,
                                                     start + num_bases))
        out.append((chrm, start, start + num_bases, strand, "%03d" % i,
                    "Est. Frac. Alternate: %.2g" % (1 - d)))
        if len(out) >= num_regions:
            break
    return out


def plots_phase(dev, smi, outs, idx_alt, fasta_1kb, model):
    """The data of the plot commands on the card, from the device means
    earlier phases left there, each held against the same function on
    CPU copies of the means; no renderer runs (the card machine has no
    matplotlib).  ROC: de novo on the C-raised alternative sample, its
    (statistic, label) pairs by ground truth (C sites modified, A and T
    sites not) and by CpG motif, through ``prep_accuracy_rates``; then
    the rates of 5,000,000 pairs (the --total-statistics-limit default).
    Clustering: the ``PLOT_CLUSTER_REGIONS`` most significant regions
    of 1 kb de novo, the sample's (batches 2-3) and control's (batch 1)
    traces at slide_span 0 and 3.  k-mer levels and the max-difference regions of the 1 kb
    sample against its control.  Returns the ``plots`` line."""
    from tombo_tpu_torch import config
    from tombo_tpu_torch.plot import accuracy, signal
    from tombo_tpu_torch.seq import TomboMotif
    from tombo_tpu_torch.stats import detect
    cpu = torch.device("cpu")
    idx_1kb, _, _ = detection_index([r for o in outs for r in o], False,
                                    dev)
    idx_ctrl, _, _ = detection_index(outs[0], False, dev)
    idx_samp, _, _ = detection_index(outs[1] + outs[2], False, dev)
    for ix in (idx_1kb, idx_alt):
        register_cpu_copies(ix, dev)
    th = config.DE_NOVO_THRESH["DNA"]
    params = detect.TestParams(
        stat_type="de_novo", single_read_thresh=th[1], lower_thresh=th[0],
        min_test_reads=1, fm_offset=config.FM_OFFSET_DEFAULT,
        region_size=config.DEFAULT_REGION_SIZE)

    def de_novo(ix):
        return [st for _, st, _ in detect.iter_region_stats(
            ix, params, fasta_1kb, model, None, device=dev)]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0
    line = {"card": smi}

    # -- ROC of the C-raised sample
    blocks, det_s = timed(lambda: stat_blocks(de_novo(idx_alt)))
    seq = fasta_1kb.get_seq(fasta_1kb.iter_chrms()[0])
    chrm = fasta_1kb.iter_chrms()[0]
    base = np.frombuffer(seq.encode(), np.uint8)
    locs = {name: {(chrm, "+"): np.flatnonzero(np.isin(base, fwd)),
                   (chrm, "-"): np.flatnonzero(np.isin(base, rev))}
            for name, fwd, rev in (("mod", [ord("C")], [ord("G")]),
                                   ("unmod", [ord("A"), ord("T")],
                                    [ord("A"), ord("T")]))}
    t0 = time.perf_counter()
    pairs = accuracy.compute_ground_truth_stats(
        blocks, (locs["mod"], locs["unmod"], "C (ground truth)"))
    pairs.update(accuracy.compute_motif_stats(
        blocks, [(TomboMotif("CG", 1), "CpG")], fasta_1kb))
    match_s = time.perf_counter() - t0
    curves, roc_s = timed(lambda: accuracy.prep_accuracy_rates(
        pairs, verbose=False, device=dev))
    cpu_curves = accuracy.prep_accuracy_rates(pairs, verbose=False,
                                              device=cpu)
    roc_same = list(curves) == list(cpu_curves) and all(
        all(np.array_equal(a, b) for a, b in zip(curves[k][:3],
                                                 cpu_curves[k][:3]))
        for k in curves)
    mean_ap = {k: (accuracy.compute_mean_avg_precision(c[0], c[2]),
                   accuracy.compute_mean_avg_precision(
                       cpu_curves[k][0], cpu_curves[k][2]))
               for k, c in curves.items()}
    auc_diff = max(abs(curves[k][3] - cpu_curves[k][3]) for k in curves)
    ap_diff = max(abs(a - b) for a, b in mean_ap.values())
    line["roc"] = {
        "pairs": {k: len(v) for k, v in pairs.items()},
        "auc": {k: float(c[3]) for k, c in curves.items()},
        "mean_ap": {k: float(v[0]) for k, v in mean_ap.items()},
        "de_novo_s": det_s, "host_motif_matching_s": match_s,
        "rates_s": roc_s, "rates_equal": roc_same,
        "auc_max_abs_diff": auc_diff, "mean_ap_max_abs_diff": ap_diff}
    if not roc_same or auc_diff > 1e-12 or ap_diff > 1e-12:
        fail("plots: ROC rates card vs CPU differ: %s" % line["roc"])
    g = torch.Generator(device=dev).manual_seed(5)
    n_big = 5000000
    big = (torch.rand(n_big, generator=g, device=dev,
                      dtype=torch.float64).mul(100).round(),
           torch.rand(n_big, generator=g, device=dev) < 0.3)
    accuracy.prep_accuracy_rates({"m": big}, verbose=False, device=dev)
    big_s = []
    for _ in range(3):
        big_curves, s_ = timed(lambda: accuracy.prep_accuracy_rates(
            {"m": big}, verbose=False, device=dev))
        big_s.append(s_)
    big_cpu, big_cpu_s = timed(lambda: accuracy.prep_accuracy_rates(
        {"m": (big[0].cpu(), big[1].cpu())}, verbose=False, device=cpu))
    big_same = all(np.array_equal(a, b) for a, b in zip(
        big_curves["m"], big_cpu["m"]))
    line["roc_5e6"] = {"pairs": n_big, "rates_s": big_s,
                       "rates_median_s": statistics.median(big_s),
                       "cpu_rates_s": big_cpu_s, "equal_cpu": big_same}
    if not big_same:
        fail("plots: 5,000,000-pair rates card vs CPU differ")

    # -- clustering at the 1 kb de novo run's most significant regions
    regions, reg_s = timed(lambda: most_signif_regions(
        de_novo(idx_1kb), 21, PLOT_CLUSTER_REGIONS))
    line["cluster"] = {"regions": len(regions), "de_novo_and_pick_s": reg_s}
    for span in (0, 3):
        got, c_s = timed(lambda: signal.cluster_traces(
            regions, idx_samp, idx_ctrl, span, device=dev))
        want = signal.cluster_traces(regions, idx_samp, idx_ctrl, span,
                                     device=cpu)
        same = list(got) == list(want) and all(
            np.array_equal(got[k], want[k]) for k in want)
        line["cluster"]["slide_span_%d" % span] = {
            "clustered": len(got), "traces": [int(m.shape[0])
                                              for m in got.values()],
            "s": c_s, "equal_cpu": same}
        if not same or not got:
            fail("plots: clustered traces card vs CPU differ (slide_span "
                 "%d)" % span)

    # -- k-mer levels and the max-difference regions
    kmer = {}
    for label, kw in (("levels", {}), ("read_mean", dict(
            read_mean=True, num_kmer_threshold=2))):
        got, k_s = timed(lambda: signal.kmer_levels(
            idx_1kb, 2, 100, device=dev, fasta=fasta_1kb, **kw))
        want = signal.kmer_levels(idx_1kb, 2, 100, device=cpu,
                                  fasta=fasta_1kb, **kw)
        kmer[label] = {"kmers": len(got), "levels": sum(
            len(v) for v in got.values()), "s": k_s,
            "equal_cpu": got == want}
        if got != want or len(got) != 16:
            fail("plots: k-mer levels card vs CPU differ (%s)" % label)
    line["kmer"] = kmer
    got, md_s = timed(lambda: signal.max_difference_regions(
        idx_samp, idx_ctrl, 10, 21, device=dev))
    want = signal.max_difference_regions(idx_samp, idx_ctrl, 10, 21,
                                         device=cpu)
    same = [(r.chrm, r.strand, r.start, r.end) for r in got] == \
        [(r.chrm, r.strand, r.start, r.end) for r in want]
    line["max_difference"] = {"regions": len(got), "s": md_s,
                              "equal_cpu": same}
    if not same or len(got) != 10:
        fail("plots: max-difference regions card vs CPU differ")
    return line


def k1_bound_ms(args, bw, io_bytes=False):
    """K1's least time: the larger of its input and output bytes over the
    memory rate and its operations over the float32 rate; with io_bytes,
    the bytes alone."""
    em, nev, rm, rs, sl, ps, pv, pe, sr = args[:9]
    B, E = em.shape
    L = args[10]
    nbytes = (B * E * 4 + 4 * B * 4 + 2 * rm.numel() * 4 + 2 * ps.numel() * 4
              + B * (L + 1) * 4 + 2 * B + B * bw * 4)
    if io_bytes:
        return nbytes
    cells = int(torch.clamp(sl.long(), max=L).sum()) * bw
    ops = cells * K1_OPS_PER_CELL
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def dp_compare(ko, po, seq_lens, L):
    """K1's bars against a plain version: (flags identical, fraction of
    boundaries equal up to each read's length, max |final_fwd| diff)."""
    mask = (torch.arange(L + 1, device=ko[0].device)[None, :] <=
            torch.clamp(seq_lens.long(), max=L)[:, None])
    frac = float((ko[0].long() == po[0].long())[mask].float().mean())
    same_flags = torch.equal(ko[1], po[1]) and torch.equal(ko[2], po[2])
    return same_flags, frac, float((ko[3] - po[3]).abs().max())


def check_dp_bars(label, same_flags, frac, ferr):
    if not same_flags:
        fail("%s: error flags differ from the plain version" % label)
    if frac < 0.995:
        fail("%s: only %.4f of boundaries equal" % (label, frac))
    if not ferr <= 1e-3:
        fail("%s: final_fwd differs by %g" % (label, ferr))


def assert_bitwise(label, a, b):
    for x, y in zip(a, b):
        if not torch.equal(x, y):
            fail("%s: chunked pair and fused kernel differ" % label)


def peak_bytes(fn):
    """Device memory a call allocates at its peak, above what was held
    before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def run_path(label, br, batches, patches):
    """Drive ``batches`` through ``resquiggle_batches`` with the launch
    counts at 0 just before and read just after.  Returns (results,
    wall seconds, launches)."""
    from tombo_tpu_torch import kernels
    with patched(patches):
        for name in kernels.LAUNCHES:
            kernels.LAUNCHES[name] = 0
        t0 = time.perf_counter()
        outs = list(br.resquiggle_batches(batches, pipeline_depth=3))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
    results = [r for o in outs for r in o]
    n_ok = sum(1 for r, e in results if r is not None)
    print("%s: %d/%d reads ok in %.2f s = %.1f reads/s on the card "
          "(launches %s)" % (label, n_ok, len(results), wall, n_ok / wall,
                             launches))
    errs = {}
    for r, e in results:
        if e is not None:
            errs[e] = errs.get(e, 0) + 1
    if errs:
        print("  errors: %s" % errs)
    if n_ok < 0.9 * len(results):
        fail("%s: fewer than 90%% of reads succeeded (%d/%d)" % (
            label, n_ok, len(results)))
    for res, _ in results:
        if res is not None and not (
                np.isfinite(res.sig_match_score) and
                res.segs.shape[0] == len(res.genome_seq) + 1 and
                np.all(np.diff(res.segs) > 0)):
            fail("%s: malformed result for %s" % (label,
                                                  res.align_info.read_id))
    return outs, wall, launches


def cpu_crosscheck(label, model, params, sst, reads, card_results):
    """The reads again through the port on the CPU, each held to the card
    result: same error or none, same start and table length, segs equal
    on > 99%, shift and scale within 2e-3 of the scale, score within
    1e-2."""
    from tombo_tpu_torch import config
    from tombo_tpu_torch.pipeline.batch import BatchedResquiggler
    cpu = BatchedResquiggler(model, params, sst, config.OUTLIER_THRESH,
                             device="cpu")
    t0 = time.perf_counter()
    cpu_out = cpu.resquiggle_batch(reads)
    print("%s: %d reads on the CPU in %.1f s" % (
        label, len(reads), time.perf_counter() - t0))
    hold_results("%s: card vs CPU" % label, card_results, cpu_out,
                 [m.align_info.read_id for m in reads], allowed=0)


def detection_phase(dev, outs, outs_m, outs_r, fasta_1kb, fasta_m,
                    fasta_r, model, model_r):
    """De novo on the 1 kb, mixed and RNA paths' reads and sample-compare
    on the 1 kb path (batch 1 the control, batches 2-3 the sample), at
    the JAX CLI's defaults, from the device means their re-squiggle
    registered; each run again on the CPU at float32 and float64 from
    the same means; the packed dispatch alone at the 1 kb de novo run's
    largest group.  Each path names its reads with its own prefix, so one
    path's cached means never serve another's read; the phase runs
    before the mesh lane re-registers the first batch of each path."""
    from tombo_tpu_torch import config
    from tombo_tpu_torch.stats import detect
    from tombo_tpu_torch.stats import device as sdev
    idx_1kb, left_1kb, fail_1kb = detection_index(
        [r for o in outs for r in o], False, dev)
    idx_ctrl, _, _ = detection_index(outs[0], False, dev)
    idx_samp, _, _ = detection_index(outs[1] + outs[2], False, dev)
    idx_m, left_m, fail_m = detection_index(
        [r for o in outs_m for r in o], False, dev)
    idx_r, left_r, fail_r = detection_index(
        [r for o in outs_r for r in o], True, dev)
    for label, left, failed, ix in (
            ("1 kb", left_1kb, fail_1kb, idx_1kb),
            ("mixed", left_m, fail_m, idx_m),
            ("RNA", left_r, fail_r, idx_r)):
        print("detection index, %s path: %d reads, %d left out (no "
              "device means: host lane or static band), %d failed" % (
                  label, sum(len(v) for v in ix.reads_index.values()),
                  left, failed))

    def det_params(stat_type, samp_type):
        th = (config.DE_NOVO_THRESH if stat_type == "de_novo"
              else config.SAMP_COMP_THRESH)[samp_type]
        return detect.TestParams(
            stat_type=stat_type, single_read_thresh=th[1],
            lower_thresh=th[0], min_test_reads=1,
            fm_offset=config.FM_OFFSET_DEFAULT,
            region_size=config.DEFAULT_REGION_SIZE)
    det_cases = [
        ("1 kb de novo", idx_1kb, det_params("de_novo", "DNA"),
         fasta_1kb, model, None),
        ("1 kb sample_compare", idx_samp,
         det_params("sample_compare", "DNA"), fasta_1kb, model,
         idx_ctrl),
        ("mixed de novo", idx_m, det_params("de_novo", "DNA"), fasta_m,
         model, None),
        ("RNA de novo", idx_r, det_params("de_novo", "RNA"), fasta_r,
         model_r, None)]
    det_out, det_args = [], None
    for label, ix, p, fa, mo, ctrl in det_cases:
        summary, stats, big = detection_run(label, ix, p, fa, mo, ctrl,
                                            dev)
        if not stats or summary["dispatches"] == 0:
            fail("detection %s: no region statistics" % label)
        for st in stats:
            fr = st.reg_frac_standard_base
            if not (st.reg_poss.shape == st.reg_cov.shape == fr.shape and
                    np.all(st.reg_cov > 0) and
                    np.all(st.valid_cov <= st.reg_cov) and
                    np.all((fr >= 0) & (fr <= 1) | np.isnan(fr))):
                fail("detection %s: malformed region %s:%s:%d" % (
                    label, st.chrm, st.strand, st.start))
        print("detection %s: %s" % (label, json.dumps(summary)))
        det_out.append((label, ix, p, fa, mo, ctrl, stats, summary))
        if det_args is None:
            det_args = big

    # the same means as CPU tensors through the same code, float32
    # and float64: coverage equal, threshold flips within
    # max(1, n/10,000) entries (tests/test_fused_detect.py's bar)
    for ix in (idx_1kb, idx_m, idx_r):
        register_cpu_copies(ix, dev)
    for label, ix, p, fa, mo, ctrl, stats, summary in det_out:
        t0 = time.perf_counter()
        cpu = {dt: [st for _, st, _ in detect.iter_region_stats(
            ix, p, fa, mo, ctrl, device="cpu", dtype=dt)]
            for dt in (torch.float32, torch.float64)}
        check = {"cpu_s": time.perf_counter() - t0}
        for name, ref in (("card_vs_cpu_f32", cpu[torch.float32]),
                          ("card_vs_cpu_f64", cpu[torch.float64]),
                          ("cpu_f32_vs_f64", None)):
            got = stats if ref is not None else cpu[torch.float32]
            ref = ref if ref is not None else cpu[torch.float64]
            sites, cov_bad, flips = detection_flips(got, ref)
            check[name] = {"sites": sites, "coverage_differs": cov_bad,
                           "flips": flips}
            if sites is None or cov_bad:
                fail("detection %s, %s: positions or coverage differ" % (
                    label, name))
            if flips > max(1, 2 * sites // 10000):
                fail("detection %s, %s: %d of %d entries flip" % (
                    label, name, flips, 2 * sites))
        print("detection %s, CPU cross-check: %s" % (label,
                                                      json.dumps(check)))

    # the packed dispatch alone, at the 1 kb de novo run's largest
    # group: CUDA-event time against its bound, PyTorch calls
    fm = config.FM_OFFSET_DEFAULT
    d_bound, d_by = det_dispatch_bound_ms(det_args, fm)
    body = sdev.packed_test_and_accumulate
    lane = {
        "function": "tombo_tpu_torch/stats/device.py::"
                    "packed_test_and_accumulate",
        "replaces": "tombo_tpu/stats/device.py:210 _packed_body "
                    "(fused gather :167)",
        "rows": det_args[1].shape[1],
        "real_rows": int((det_args[1][2] > 0).sum()),
        "W": det_args[4], "S": det_args[3][1].shape[0],
        "site_obs": int(det_args[1][2].long().sum()),
        "ms": cuda_ms(lambda: body(*det_args), 20),
        "bound_ms": d_bound, "bound_by": d_by,
        "ops_per_element": det_ops_per_elem(fm),
        "torch_calls": profile_call(
            lambda: body(*det_args))["torch_calls"],
        "dispatches": {label: summary["dispatches"]
                       for label, *_, summary in det_out},
        "library_ms": None}
    print("detection lane: %s" % json.dumps(lane))
    return lane


def basecalls(maps, model, rng):
    """Each simulated read's basecalls with errors: its read-oriented
    sequence (the mapped sequence less the k-mer context) mutated at
    RUNNER_ERR; (name, raw signal, SequenceData) for a memory source."""
    from tombo_tpu_torch.testing import mutate_seq
    from tombo_tpu_torch.types import SequenceData
    k, cp = model.kmer_width, model.central_pos
    out = []
    for mr in maps:
        seq = mr.genome_seq[cp:len(mr.genome_seq) - (k - cp - 1)]
        rid = mr.align_info.read_id
        out.append((rid, mr.raw_signal, SequenceData(
            mutate_seq(rng, seq, RUNNER_ERR), rid, 12.0)))
    return out


def run_runner(source, aligner, model, params, sst, device):
    """``resquiggle_all_reads`` over a memory source; returns (summary,
    index, each read's result by read id, wall seconds)."""
    from tombo_tpu_torch.pipeline import runner
    from tombo_tpu_torch.pipeline.batch import BatchedResquiggler
    got = {}
    orig = BatchedResquiggler.resquiggle_batches

    def keep(self, batches, **kw):
        for res in orig(self, batches, **kw):
            for r, _ in res:
                if r is not None:
                    got[r.align_info.read_id] = r
            yield res
    with patched([(BatchedResquiggler, "resquiggle_batches", keep)]):
        t0 = time.perf_counter()
        summary, index = runner.resquiggle_all_reads(
            source, aligner, model, sst, params,
            runner.RunConfig(device=device, batch_size=RUNNER_BATCH))
        if device != "cpu":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return summary, index, got, wall


def result_diffs(a, b):
    """(bitwise equal, within the batch-parity bars) of two results of
    one read: segs, start, shift, scale and score."""
    same_shape = (a.segs.shape == b.segs.shape and
                  a.read_start_rel_to_raw == b.read_start_rel_to_raw)
    bitwise = (same_shape and np.array_equal(a.segs, b.segs) and
               a.scale_values.shift == b.scale_values.shift and
               a.scale_values.scale == b.scale_values.scale and
               a.sig_match_score == b.sig_match_score)
    sc = b.scale_values.scale
    close = (same_shape and np.mean(a.segs == b.segs) > 0.99 and
             abs(a.scale_values.shift - b.scale_values.shift) / sc < 2e-3
             and abs(a.scale_values.scale - sc) / sc < 2e-3 and
             abs(a.sig_match_score - b.sig_match_score) < 1e-2)
    return bitwise, close


def runner_phase(dev, model, params, sst, paths):
    """The re-squiggle runner on the card: each path's reads (``paths``:
    (label, batches of mapped reads, their direct results, reference)),
    with basecalls of 8% errors, mapped by the native minimizer aligner
    and re-squiggled by ``resquiggle_all_reads`` at the command line's
    batch size over a memory source, the launch counts zeroed just
    before and read just after each path's run.  Each read whose mapping
    equals the simulated one is held against its direct result (bitwise
    count, batch-parity bars); 32 reads run again through the runner on
    the CPU; de novo detection from the runner's index of the 1 kb reads
    is held against the direct path's de novo pass on the same reads.
    Returns the launches of both runs, summed."""
    from tombo_tpu_torch import config, kernels
    from tombo_tpu_torch.errors import TomboError
    from tombo_tpu_torch.pipeline import resquiggle as rsq
    from tombo_tpu_torch.pipeline import runner
    from tombo_tpu_torch.pipeline.aligner import MinimizerAligner
    from tombo_tpu_torch.stats import detect, device_levels
    rng = np.random.default_rng(RUNNER_SEED)
    total = {n: 0 for n in kernels.LAUNCHES}
    de_novo = detect.TestParams(
        stat_type="de_novo", single_read_thresh=config.DE_NOVO_THRESH[
            "DNA"][1], lower_thresh=config.DE_NOVO_THRESH["DNA"][0],
        min_test_reads=1, fm_offset=config.FM_OFFSET_DEFAULT,
        region_size=config.DEFAULT_REGION_SIZE)
    for label, batches, outs, fasta in paths:
        maps = [m for b in batches for m in b]
        direct = {m.align_info.read_id: r for m, (r, _) in
                  zip(maps, [x for o in outs for x in o])}
        truth = {m.align_info.read_id: m for m in maps}
        reads = basecalls(maps, model, rng)
        source = runner.MemoryReads(reads)
        t0 = time.perf_counter()
        aligner = MinimizerAligner(fasta)
        index_s = time.perf_counter() - t0
        # the reads whose basecalls map where they were simulated, to the
        # base: their re-squiggle inputs equal the direct path's
        same, mapped, right = set(), 0, 0
        for name, _, seq in reads:
            try:
                mr = rsq.map_read(seq, aligner, model, sst)
            except TomboError:
                continue
            tm = truth[name]
            mapped += 1
            right += (mr.genome_loc.strand == tm.genome_loc.strand and
                      abs(mr.genome_loc.start - tm.genome_loc.start) <=
                      RUNNER_START_TOL)
            if (mr.genome_loc.start, mr.genome_loc.strand, mr.genome_seq) == \
                    (tm.genome_loc.start, tm.genome_loc.strand,
                     tm.genome_seq):
                same.add(name)
        if label == "1 kb":
            ix_direct, _, _ = detection_index(
                [(direct[n], None) for n in sorted(same)
                 if direct[n] is not None], False, dev)
            want = [st for _, st, _ in detect.iter_region_stats(
                ix_direct, de_novo, fasta, model, None, device=dev)]
        for name in kernels.LAUNCHES:
            kernels.LAUNCHES[name] = 0
        summary, index, got, wall = run_runner(source, aligner, model,
                                               params, sst, DEVICE)
        launches = dict(kernels.LAUNCHES)
        for name, n in launches.items():
            total[name] += n
        want_k = ["banded_dp", "count_le", "banded_dp_sharded"] + (
            list(CHUNKED) if label == "mixed" else [])
        for name in want_k:
            if launches[name] <= 0:
                fail("runner, %s: kernel %s was not launched" % (label,
                                                                 name))
        # the runner's results against the direct path's, same mappings
        n_cmp = n_bit = n_close = n_err = 0
        for name in sorted(same):
            a, b = got.get(name), direct[name]
            if (a is None) != (b is None):
                n_err += 1
                continue
            if a is None:
                continue
            n_cmp += 1
            bit, close = result_diffs(a, b)
            n_bit += bit
            n_close += close
        line = {
            "path": label, "reads": len(reads),
            "mapped": mapped, "right_start_strand": right,
            "right_share": right / len(reads),
            "same_mapping_as_simulated": len(same),
            "succeeded": summary.n_success, "failed": summary.n_failed,
            "failure_modes": dict(summary.failure_modes),
            "wall_s": wall, "reads_per_s": summary.n_success / wall,
            "aligner_index_s": index_s,
            "mapping_thread_s": summary.timings["io_map"],
            "batch_loop_s": summary.timings["batch_loop"],
            "launches": launches,
            "vs_direct": {"compared": n_cmp, "bitwise": n_bit,
                          "within_bars": n_close,
                          "error_differs": n_err}}
        print("runner, %s path: %s" % (label, json.dumps(line)))
        if n_err or n_close < n_cmp or n_cmp < 0.5 * len(reads):
            fail("runner, %s: %d of %d same-mapped reads outside the "
                 "batch-parity bars of the direct path, %d with another "
                 "error" % (label, n_cmp - n_close, n_cmp, n_err))
        if summary.n_success < 0.85 * len(reads):
            fail("runner, %s: only %d of %d reads succeeded" % (
                label, summary.n_success, len(reads)))
        if label != "1 kb":
            continue

        # 32 of the reads through the runner on the CPU
        cpu_reads = [r for r in reads if r[0] in got][:RUNNER_CPU_READS]
        c_sum, _, c_got, c_wall = run_runner(
            runner.MemoryReads(cpu_reads), aligner, model, params, sst,
            "cpu")
        worst_ok = 0
        for name, _, _ in cpu_reads:
            c = c_got.get(name)
            if c is None:
                fail("runner CPU cross-check: %s failed on the CPU" % name)
            worst_ok += result_diffs(got[name], c)[1]
        print("runner CPU cross-check: %d reads in %.1f s, %d within the "
              "bars of the card's" % (len(cpu_reads), c_wall, worst_ok))
        if worst_ok < len(cpu_reads):
            fail("runner CPU cross-check: %d reads outside the bars" % (
                len(cpu_reads) - worst_ok))

        # de novo from the runner's index: the reads with device means
        index_dev = type(index)()
        left = 0
        for (chrm, strand), v in index.reads_index.items():
            for r in v:
                if device_levels.lookup(r.read_id, r.end - r.start,
                                        dev) is None:
                    left += 1
                else:
                    index_dev.add_read_data(chrm, strand, r)
        t0 = time.perf_counter()
        full = [st for _, st, _ in detect.iter_region_stats(
            index_dev, de_novo, fasta, model, None, device=dev)]
        torch.cuda.synchronize()
        full_s = time.perf_counter() - t0
        same_ix = type(index)()
        for (chrm, strand), v in index_dev.reads_index.items():
            for r in v:
                if r.read_id in same:
                    same_ix.add_read_data(chrm, strand, r)
        got_st = [st for _, st, _ in detect.iter_region_stats(
            same_ix, de_novo, fasta, model, None, device=dev)]
        # regions in (chrm, strand, start) order: an index lists its
        # strands in the order its reads arrived
        key = lambda st: (st.chrm, st.strand, st.start)
        sites, cov_bad, flips = detection_flips(sorted(got_st, key=key),
                                                sorted(want, key=key))
        det = {"reads_in_index": sum(len(v) for v in
                                     index_dev.reads_index.values()),
               "left_out_no_device_means": left,
               "sites": sum(st.reg_poss.shape[0] for st in full),
               "wall_s": full_s,
               "same_mapping_reads": sum(len(v) for v in
                                         same_ix.reads_index.values()),
               "direct_reads": sum(len(v) for v in
                                   ix_direct.reads_index.values()),
               "compared_sites": sites, "coverage_differs": cov_bad,
               "flips": flips}
        print("runner, de novo from its index: %s" % json.dumps(det))
        if sites is None or cov_bad:
            fail("runner de novo: positions or coverage differ from the "
                 "direct path's")
        if flips > max(1, 2 * sites // 10000):
            fail("runner de novo: %d of %d entries flip" % (flips,
                                                            2 * sites))
    return total

# ---------------------------------------------------------------------------
# multi-host detection: processes on the one card, merged over gloo
# ---------------------------------------------------------------------------

def multihost_save(fn, groups, fastas, dev):
    """One .npz of each group's reads (index record and float32 device
    means, in the index's order) and each reference."""
    from tombo_tpu_torch.stats import device_levels
    arrs = {}
    for g, idx in groups.items():
        recs = [(c, s, r) for (c, s), reads in idx for r in reads]
        means = []
        for _, _, r in recs:
            src, off = device_levels.lookup(r.read_id, r.end - r.start, dev)
            means.append(src[off:off + r.end - r.start].float().cpu()
                         .numpy())
        arrs[g + "__chrm"] = np.array([c for c, _, _ in recs])
        arrs[g + "__strand"] = np.array([s for _, s, _ in recs])
        arrs[g + "__start"] = np.array([r.start for _, _, r in recs],
                                       np.int64)
        arrs[g + "__end"] = np.array([r.end for _, _, r in recs], np.int64)
        arrs[g + "__read_id"] = np.array([r.read_id for _, _, r in recs])
        arrs[g + "__means"] = np.concatenate(means)
    for name, fa in fastas.items():
        for i, chrm in enumerate(fa.iter_chrms()):
            arrs["fasta__%s__%d" % (name, i)] = np.array([chrm,
                                                          fa.get_seq(chrm)])
    np.savez(fn, **arrs)


def multihost_load(fn, dev, register):
    """The groups' in-memory indexes and the references of
    :func:`multihost_save`'s file; with ``register`` every read's means
    registered on ``dev`` (one padded matrix a group)."""
    from tombo_tpu_torch import config
    from tombo_tpu_torch.io.fasta import Fasta
    from tombo_tpu_torch.io.index import ReadsIndex
    from tombo_tpu_torch.stats import device_levels
    from tombo_tpu_torch.types import ReadData
    data = np.load(fn)
    groups, seqs = {}, {}
    for key in data.files:
        if key.startswith("fasta__"):
            chrm, seq = data[key]
            seqs.setdefault(key.split("__")[1], {})[str(chrm)] = str(seq)
    for g in sorted({k.split("__")[0] for k in data.files
                     if k.endswith("__means")}):
        idx, entries, rows, off = ReadsIndex(), [], [], 0
        means = data[g + "__means"]
        for chrm, strand, start, end, rid in zip(
                data[g + "__chrm"], data[g + "__strand"],
                data[g + "__start"], data[g + "__end"],
                data[g + "__read_id"]):
            n = int(end - start)
            idx.add_read_data(str(chrm), str(strand), ReadData(
                int(start), int(end), False, 0, str(strand), "",
                config.DEFAULT_CORRECTED_GROUP + "/" +
                config.DEFAULT_BASECALL_SUBGROUP, False, read_id=str(rid)))
            rows.append(means[off:off + n])
            entries.append((str(rid), len(entries), n))
            off += n
        if register:
            width = max(r.shape[0] for r in rows)
            mat = np.zeros((len(rows), width), np.float32)
            for i, r in enumerate(rows):
                mat[i, :r.shape[0]] = r
            device_levels.register_batch(torch.from_numpy(mat).to(dev),
                                         entries)
        groups[g] = idx
    return groups, {k: Fasta(v) for k, v in seqs.items()}


def multihost_models(runs):
    """{run label: (canonical model or None, alternative models or None)}
    of :func:`multihost_phase`'s table, loaded once before any timed
    run."""
    from tombo_tpu_torch.io.model_io import KmerModel, load_alt_refs
    std_ref = KmerModel.load_default("DNA")
    return {label: (std_ref if spec["fasta"] is not None else None,
                    load_alt_refs(spec["alts"], "DNA") if spec["alts"]
                    else None) for label, spec in runs}


def multihost_run(spec, models, groups, fastas, dev, dist):
    """One detection run of :func:`multihost_phase`'s table through
    ``iter_region_stats`` with its preloaded ``models``; a list of its
    (name, statistics, per-read block) tuples."""
    from tombo_tpu_torch.stats import detect
    std_ref, alt_refs = models
    return list(detect.iter_region_stats(
        groups[spec["samp"]], detect.TestParams(**spec["params"]),
        fastas.get(spec["fasta"]), std_ref, groups.get(spec["ctrl"]),
        device=dev, alt_refs=alt_refs, emit_per_read=spec["per_read"],
        dist=dist))


def timed_passes(fn, dev):
    """``fn`` twice (the first pass warms the process's first calls):
    the second pass's result and both passes' wall seconds."""
    walls = []
    for _ in range(2):
        t = time.perf_counter()
        res = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    return res, walls


def multihost_worker(rank, n_hosts, port, fn, runs, device, out_fn):
    """One host of the phase (a spawned process): joins the gloo group,
    registers the file's means on ``device``, loads the models, runs
    every detection of ``runs`` with its ``DistContext`` twice
    (:func:`timed_passes`) and pickles the second pass's results, each
    pass's wall time and time in ``psum_hosts``, and the reads or
    regions it owned to ``out_fn``."""
    from tombo_tpu_torch.parallel import distributed
    dev = torch.device(device)
    t0 = time.perf_counter()
    ctx = distributed.init_distributed("127.0.0.1:%d" % port, n_hosts,
                                       rank, device=dev)
    groups, fastas = multihost_load(fn, dev, register=True)
    models = multihost_models(runs)
    out = {"rank": rank, "setup_s": time.perf_counter() - t0, "runs": {},
           "route": ctx.route}
    psum = {"s": [], "calls": []}
    real_psum = distributed.psum_hosts

    def timed_psum(*args):
        t = time.perf_counter()
        try:
            return real_psum(*args)
        finally:
            psum["s"][-1] += time.perf_counter() - t
            psum["calls"][-1] += 1
    distributed.psum_hosts = timed_psum
    for label, spec in runs:
        psum["s"], psum["calls"] = [], []

        def one_pass():
            psum["s"].append(0.0)
            psum["calls"].append(0)
            return multihost_run(spec, models[label], groups, fastas, dev,
                                 ctx)
        res, walls = timed_passes(one_pass, dev)
        run = out["runs"][label] = {
            "res": res, "wall_s": walls, "psum_s": psum["s"],
            "psum_calls": psum["calls"]}
        if spec["level"]:
            # level statistics shard regions, the others reads
            n_regs = sum(1 for _ in groups[spec["samp"]].iter_cov_regs(
                1, spec["params"]["region_size"], groups[spec["ctrl"]]))
            run.update(regions=n_regs, regions_owned=sum(
                ctx.owns_region(i) for i in range(n_regs)))
        else:
            reads = list(groups[spec["samp"]].iter_reads())
            run.update(reads=len(reads), reads_owned=sum(
                ctx.owns_read(distributed.read_key(r)) for r in reads))
    out["last_psum_path"] = distributed.LAST_PSUM_PATH["path"]
    torch.distributed.destroy_process_group()
    with open(out_fn, "wb") as fp:
        pickle.dump(out, fp)


def multihost_detection(fn, runs, device, n_hosts, tmp, timeout):
    """:func:`multihost_worker` in ``n_hosts`` spawned processes; their
    outputs in rank order.  A process that fails, outlives ``timeout``
    seconds (it is killed) or writes nothing fails the phase; no process
    outlives the call."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    out_fns = [os.path.join(tmp, "host%d.pkl" % r) for r in range(n_hosts)]
    procs = [ctx.Process(target=multihost_worker, args=(
        r, n_hosts, port, fn, runs, device, out_fns[r]))
        for r in range(n_hosts)]
    for p in procs:
        p.start()
    deadline = time.perf_counter() + timeout
    try:
        for r, p in enumerate(procs):
            p.join(max(deadline - time.perf_counter(), 0))
            if p.is_alive():
                raise RuntimeError("multi-host: host %d ran past %d s"
                                   % (r, timeout))
            if p.exitcode != 0 or not os.path.exists(out_fns[r]):
                raise RuntimeError("multi-host: host %d failed (exit code "
                                   "%s)" % (r, p.exitcode))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    outs = []
    for fn_r in out_fns:
        with open(fn_r, "rb") as fp:
            outs.append(pickle.load(fp))
    return outs


def _same(x, y) -> bool:
    """Equal arrays, NaN equal to NaN."""
    x, y = np.asarray(x), np.asarray(y)
    if x.shape != y.shape:
        return False
    eq = x == y
    if x.dtype.kind == "f":
        eq |= np.isnan(x) & np.isnan(y)
    return bool(eq.all())


def _per_read_records(results):
    """{(name, chrm, strand, start): sorted (pos, read id, stat)} of the
    per-read blocks of a run's results."""
    out = {}
    for name, _, payload in results:
        if payload is None:
            continue
        _, block, lookup, chrm, strand, start = payload
        names = {v: k for k, v in lookup.items()}
        out.setdefault((name, chrm, strand, start), []).extend(
            (int(p), names[int(r)], float(st)) for p, st, r in zip(
                block["pos"], block["stat"], block["read_id"]))
    return {k: sorted(v) for k, v in out.items()}


def multihost_compare(hosts, single, level_tol):
    """Host 0's merged statistics against the one-process run: regions,
    positions and coverage exact; model fractions exact (they come from
    the merged integer counts); level statistics within ``level_tol``
    (and whether bitwise); every host's statistics bitwise host 0's; the
    union of the hosts' per-read blocks, by read id, equal to the
    one-process blocks.  Returns a summary, or raises."""
    def key(results):
        return [(n, s.chrm, s.strand, s.start) for n, s, _ in results]
    merged = hosts[0]
    if key(merged) != key(single):
        raise RuntimeError("multi-host: the regions differ")
    sites, max_abs, bitwise = 0, 0.0, True
    for (_, a, _), (_, b, _) in zip(merged, single):
        sites += a.reg_poss.shape[0]
        ints = ["reg_poss", "reg_cov", "ctrl_cov"]
        if hasattr(a, "valid_cov"):
            ints.append("valid_cov")
        for f in ints:
            if not _same(getattr(a, f), getattr(b, f)):
                raise RuntimeError("multi-host: %s differs in %s:%s:%d" % (
                    f, a.chrm, a.strand, a.start))
        x, y = ((a.reg_frac_standard_base, b.reg_frac_standard_base)
                if hasattr(a, "valid_cov") else (a.reg_stats, b.reg_stats))
        bitwise &= _same(x, y)
        if not np.array_equal(np.isnan(x), np.isnan(y)):
            raise RuntimeError("multi-host: NaN statistics differ")
        d = np.abs(x - y)[~np.isnan(x)]
        max_abs = max(max_abs, float(d.max()) if d.shape[0] else 0.0)
    if max_abs > (level_tol if level_tol is not None else 0.0):
        raise RuntimeError("multi-host: statistics differ by %g" % max_abs)
    for h, res in enumerate(hosts[1:], 1):
        if key(res) != key(merged) or not all(
                _same(getattr(a, f), getattr(b, f))
                for (_, a, _), (_, b, _) in zip(res, merged)
                for f in vars(a) if isinstance(getattr(a, f), np.ndarray)):
            raise RuntimeError("multi-host: host %d's statistics differ "
                               "from host 0's" % h)
    want = _per_read_records(single)
    union = {}
    for res in hosts:
        for k, recs in _per_read_records(res).items():
            union.setdefault(k, []).extend(recs)
    if {k: sorted(v) for k, v in union.items()} != want:
        raise RuntimeError("multi-host: the hosts' per-read blocks differ "
                           "from the one-process blocks")
    return {"regions": len(merged), "sites": sites,
            "stats_bitwise": bitwise, "max_abs_diff": max_abs,
            "per_read_entries": sum(len(v) for v in want.values())}


def multihost_phase(dev, groups, fastas, runs, n_hosts=MULTIHOST_HOSTS,
                    timeout=MULTIHOST_TIMEOUT):
    """Multi-host detection on the card: the groups' reads and device
    means written to one .npz, ``n_hosts`` spawned processes that each
    register them on the card and run every detection of ``runs`` with
    their ``DistContext`` (gloo on 127.0.0.1), against this process's
    one-host run of the same means; every side loads its models before
    any timed run and runs each detection twice (:func:`timed_passes`),
    so both the hosts' and the one-process walls are warm second passes
    without model loads.  ``runs``: (label, spec: params,
    samp / ctrl / fasta group names, alternative models, per-read,
    level statistic type or None).  Prints one line a run; returns the
    summaries."""
    from tombo_tpu_torch.stats import device_levels
    summaries = {}
    with tempfile.TemporaryDirectory() as tmp:
        fn = os.path.join(tmp, "reads.npz")
        multihost_save(fn, groups, fastas, dev)
        own, own_fastas = multihost_load(fn, dev, register=False)
        for g, idx in own.items():
            if any(device_levels.lookup(r.read_id, r.end - r.start, dev)
                   is None for r in idx.iter_reads()):
                fail("multi-host: group %s has reads without means" % g)
        t0 = time.perf_counter()
        hosts = multihost_detection(fn, runs, dev.type, n_hosts, tmp,
                                    timeout)
        hosts_s = time.perf_counter() - t0
        models = multihost_models(runs)
        for label, spec in runs:
            single, single_s = timed_passes(lambda: multihost_run(
                spec, models[label], own, own_fastas, dev, None), dev)
            lv = spec["level"]
            try:
                check = multihost_compare(
                    [h["runs"][label]["res"] for h in hosts], single,
                    LEVEL_F32_ABS_TOL[lv] if lv else None)
            except RuntimeError as e:
                fail("%s: %s" % (label, e))
            check.update({
                "one_process_s": single_s,
                "hosts": [{k: v for k, v in h["runs"][label].items()
                           if k != "res"} for h in hosts]})
            summaries[label] = check
            print("multi-host %s: %s" % (label, json.dumps(check)),
                  flush=True)
    print("multi-host: %d processes, %.1f s from spawn to the last result "
          "(setup %s s); merge route %s, last psum_hosts path %s" % (
              n_hosts, hosts_s, ", ".join(
                  "%.1f" % h["setup_s"] for h in hosts),
              [h["route"] for h in hosts],
              [h["last_psum_path"] for h in hosts]), flush=True)
    # the processes share one card, which NCCL refuses: the host route
    if any(h["route"] != "host" or h["last_psum_path"] != "host"
           for h in hosts):
        fail("multi-host: processes sharing one card left the host route")
    return summaries


def multihost_runs(level_min_reads=LEVEL_MIN_TEST_READS,
                   region_size=None):
    """The phase's table: de novo and the 5mC alternative model with
    per-read blocks on the "1kb" group, model_sample_compare and KS
    ("samp" against "ctrl", on the "level" reference)."""
    from tombo_tpu_torch import config
    rs = region_size or config.DEFAULT_REGION_SIZE

    def spec(stat_type, thresh, samp, ctrl, fasta, alts, per_read,
             min_reads=1):
        th = thresh["DNA"] if thresh else (None, None)
        return {"params": dict(
            stat_type=stat_type, single_read_thresh=th[1],
            lower_thresh=th[0], min_test_reads=min_reads,
            fm_offset=config.FM_OFFSET_DEFAULT, region_size=rs),
            "samp": samp, "ctrl": ctrl, "fasta": fasta, "alts": alts,
            "per_read": per_read,
            "level": stat_type if thresh is None else None}
    return [
        ("1 kb de novo, per-read", spec(
            "de_novo", config.DE_NOVO_THRESH, "1kb", None, "1kb", None,
            True)),
        ("1 kb alt 5mC, per-read", spec(
            "model_compare", config.LLR_THRESH, "1kb", None, "1kb",
            ["5mC"], True)),
        ("level model_sample_compare", spec(
            "sample_compare", config.SAMP_COMP_THRESH, "samp", "ctrl",
            "level", None, False)),
        ("level ks", spec("ks", None, "samp", "ctrl", None, None, False,
                          level_min_reads))]


# the debug_dp phase: reads of the one-read phase's recipes dumped, and
# the long read's rows held to the plain version over its first rows
DEBUG_DP_1KB, DEBUG_DP_RNA, DEBUG_DP_LONG_ROWS = 6, 2, 2048
DEBUG_DP_KEYS = {"fwd_pass": np.float32, "fwd_pass_tb": np.int8,
                 "band_event_starts": np.int64, "read_tb": np.int64,
                 "event_means": np.float32, "ref_means": np.float32,
                 "ref_sds": np.float32, "events_start_clip": np.int64,
                 "lower_margin": np.int64, "upper_margin": np.int64,
                 "bandwidth": np.int64}


def same_result(a, b):
    """Two one-read outcomes (result, error) bitwise the same: error,
    segs, start, scale values, score, norm_params_changed."""
    (ra, ea), (rb, eb) = a, b
    if ea != eb or (ra is None) != (rb is None):
        return False
    return ra is None or (
        np.array_equal(ra.segs, rb.segs) and
        ra.read_start_rel_to_raw == rb.read_start_rel_to_raw and
        ra.scale_values == rb.scale_values and
        ra.sig_match_score == rb.sig_match_score and
        ra.norm_params_changed == rb.norm_params_changed)


def rows_bars(label, got, want, seq_lens, n_rows):
    """The dumped rows (forward values, codes, band starts; (B, >= n_rows,
    ...)) against the plain version's over rows [0, n_rows): band starts
    exact, codes equal on >= 99.5% of the in-band cells, forward values
    within 1e-3, the rows past each read zero.  Returns (max |value
    diff|, fraction of codes equal)."""
    live = (torch.arange(n_rows)[None, :] <
            torch.clamp(seq_lens.long().cpu(), max=n_rows)[:, None])
    g = [t[:, :n_rows].cpu() for t in got]
    w = [t[:, :n_rows].cpu() for t in want]
    if not torch.equal(g[2], w[2]):
        fail("%s: band starts differ from the plain version" % label)
    frac = float((g[1] == w[1])[live].float().mean())
    err = float((g[0].double() - w[0].double()).abs()[live].max())
    if frac < 0.995:
        fail("%s: only %.4f of move codes equal" % (label, frac))
    if not err <= 1e-3:
        fail("%s: forward rows differ by %g" % (label, err))
    if any(t[~live].any() for t in g):
        fail("%s: rows past a read are not zero" % label)
    return err, frac


def debug_dp_phase(dev, smi, paths):
    """The one-read path's DP debug dump on the card: each read of
    ``paths`` ((label, model, params, sst, maps)) through
    ``resquiggle_read_with_retries`` with and without ``debug_dp_dir``,
    the results bitwise equal (every pass dumps; the file holds the
    last); each file with the JAX package's entries, dtypes and
    shapes, its rows bitwise those the row-writing instance returned; the
    rows held against the plain version on CPU copies of the same float32
    inputs (:func:`rows_bars`; the chunked read over its first
    DEBUG_DP_LONG_ROWS rows, which are causal).  The launch counts are
    zeroed before the dumped runs and read after.  Then each row-writing
    instance timed against its normal instance, in turns, at a 1 kb
    read's fused call and the long read's chunked call.  Returns one
    kernels-line row each."""
    from tombo_tpu_torch import config, kernels
    from tombo_tpu_torch.errors import TomboError
    from tombo_tpu_torch.ops import banded_dp
    from tombo_tpu_torch.ops import dp as dp_mod
    from tombo_tpu_torch.pipeline import resquiggle as rsq
    k1, k2 = (banded_dp.adaptive_banded_dp_tb,
              banded_dp.adaptive_banded_dp_tb_chunked)
    seen = []

    def keep(fn, name):
        def run(*a, **kw):
            out = fn(*a, **kw)
            if kw.get("rows"):
                seen.append((name, a, kw, out))
            return out
        return run

    def one(mr, model, params, sst, **kw):
        save = config.load_resquiggle_parameters(sst.name,
                                                 use_save_bandwidth=True)
        try:
            return rsq.resquiggle_read_with_retries(
                mr, model, params, save,
                outlier_thresh=config.OUTLIER_THRESH, seq_samp_type=sst,
                device=DEVICE, **kw), None
        except TomboError as e:
            return None, str(e)

    checks, calls = [], {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        for name in kernels.LAUNCHES:
            kernels.LAUNCHES[name] = 0
        outs = []
        with patched([(banded_dp, "adaptive_banded_dp_tb", keep(k1, "k1")),
                      (banded_dp, "adaptive_banded_dp_tb_chunked",
                       keep(k2, "k2"))]):
            for label, model, params, sst, maps in paths:
                for mr in maps:
                    n0 = len(seen)
                    got = one(mr, model, params, sst, debug_dp_dir=tmp)
                    # every pass dumps: the file holds the last pass's DP
                    outs.append((label, mr, got, len(seen) - n0,
                                 seen[-1] if len(seen) > n0 else
                                 (None,) * 4))
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        dump_s = time.perf_counter() - t0
        plain_s = 0.0
        for label, mr, got, n_pass, (name, args, kw, kout) in outs:
            model, params, sst = next((m, p, s) for lb, m, p, s, _ in paths
                                      if lb == label)
            rid = mr.align_info.read_id
            fn = os.path.join(tmp, "dp_debug.%s.npz" % rid)
            if not same_result(got, one(mr, model, params, sst)):
                fail("debug_dp %s: the dump changed the result" % rid)
            if got[0] is None:
                fail("debug_dp %s: the read failed (%s)" % (rid, got[1]))
            if n_pass == 0:         # the static band: no DP, no dump
                if os.path.exists(fn):
                    fail("debug_dp %s: a static-band read dumped" % rid)
                checks.append({"read": rid, "path": label,
                               "instance": None})
                continue
            with np.load(fn) as f:
                if {k: f[k].dtype for k in f.files} != DEBUG_DP_KEYS:
                    fail("debug_dp %s: entries %s" % (rid, {
                        k: str(f[k].dtype) for k in f.files}))
                L, bw = f["ref_means"].shape[0], int(f["bandwidth"])
                if (f["fwd_pass"].shape != (L + 1, bw) or
                        f["fwd_pass_tb"].shape != (L + 1, bw) or
                        f["band_event_starts"].shape != (L,) or
                        f["read_tb"].shape != (L + 1,)):
                    fail("debug_dp %s: shapes" % rid)
                if not (np.array_equal(f["fwd_pass"][1:],
                                       kout[4][0].cpu().numpy()) and
                        np.array_equal(f["fwd_pass_tb"][1:],
                                       kout[5][0].cpu().numpy())):
                    fail("debug_dp %s: file rows are not the kernel's" % rid)
            cpu_args = [a.cpu() if torch.is_tensor(a) else a for a in args]
            t1 = time.perf_counter()
            if name == "k1":
                n_rows = args[10]
                po = banded_dp.adaptive_banded_dp_tb_plain(*cpu_args,
                                                           rows=True)[4:]
            else:
                n_rows = min(DEBUG_DP_LONG_ROWS, args[10])
                x = dp_mod.dp_inputs(*cpu_args[:12])
                _, tb, st, fw = dp_mod.adaptive_dp_rows(
                    x, dp_mod.init_fwd_state(x, args[9].bandwidth), 0,
                    n_rows, args[9], keep_rows=True)
                po = banded_dp._dump_rows(fw, tb, st, x.seq_lens)
            t_plain = time.perf_counter() - t1
            plain_s += t_plain
            err, frac = rows_bars("debug_dp %s (%s)" % (rid, name), kout[4:],
                                  po, args[4], n_rows)
            checks.append({"read": rid, "path": label, "instance": name,
                           "passes": n_pass, "L": args[10],
                           "bw": args[9].bandwidth,
                           "rows_compared": n_rows, "max_abs_err": err,
                           "codes_equal_frac": frac, "plain_cpu_s": t_plain})
            calls.setdefault(name, (args, kw))
    for need, inst in (("banded_dp_rows", "k1"),
                       ("banded_dp_chunked_tb_rows", "k2")):
        n = sum(1 for c in seen if c[0] == inst)
        if launches[need] != n or not any(c["instance"] == inst
                                          for c in checks):
            fail("debug_dp: %s launched %d times for %d calls" % (
                need, launches[need], n))
    if launches["banded_dp_chunked_tb"] or launches["banded_dp_sharded"]:
        fail("debug_dp: a normal K2' or K3 launch: %s" % launches)
    print("debug_dp reads (%s): %s" % (smi, json.dumps(checks)))
    print("debug_dp: %d reads dumped (%d passes) in %.2f s; plain rows on "
          "CPU copies %.2f s; launches %s" % (
              len(outs), len(seen), dump_s, plain_s, json.dumps(
                  {k: v for k, v in launches.items() if v})))

    # each row-writing instance against its normal instance, in turns
    rows = {}
    args, _ = calls["k1"]
    B, L, bw = args[0].shape[0], args[10], args[9].bandwidth
    ms = {"normal": [], "rows": []}
    for which in ("normal", "rows", "rows", "normal"):
        ms[which].append(cuda_ms(lambda: k1(*args, rows=which == "rows"),
                                 10))
    nbytes = k1_bound_ms(args, bw, io_bytes=True) + B * L * (5 * bw + 4)
    ops = int(torch.clamp(args[4].long(), max=L).sum()) * bw * \
        K1_OPS_PER_CELL
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    po_ms = cuda_ms(lambda: banded_dp.adaptive_banded_dp_tb_plain(
        *args, rows=True), 1, warm=False)
    rows["banded_dp_rows"] = {
        "B": B, "L": L, "bw": bw, "ms": statistics.mean(ms["rows"]),
        "normal_ms": statistics.mean(ms["normal"]), "turns_ms": ms,
        "plain_ms": po_ms, "bound_ms": 1e3 * max(t_b, t_o),
        "bound_by": "bytes" if t_b >= t_o else "operations",
        "max_abs_err": max(c["max_abs_err"] for c in checks
                           if c["instance"] == "k1"),
        "codes_equal_frac": min(c["codes_equal_frac"] for c in checks
                                if c["instance"] == "k1")}
    args, kw = calls["k2"]
    B, L, bw, Lc = (args[0].shape[0], args[10], args[9].bandwidth,
                    kw["chunk_rows"])
    kw = {"chunk_rows": Lc}
    split = {"normal": [], "rows": []}
    for which in ("normal", "rows", "rows", "normal"):
        split[which].append(pair_split_ms(
            lambda: k2(*args, rows=which == "rows", **kw), 3))
    lc_k = banded_dp.tile_rows(bw, min(Lc, L))
    sl_sum = int(torch.clamp(args[4].long(), max=L).sum())
    nbytes = (k1_bound_ms(args, bw, io_bytes=True) +
              B * -(-L // lc_k) * (bw * 4 + 4) + B * 4 + B * L * (5 * bw + 4))
    t_b = nbytes / HBM_BYTES_PER_S
    t_o = sl_sum * bw * K1_OPS_PER_CELL / F32_OPS_PER_S
    long = [c for c in checks if c["instance"] == "k2"]
    rows["banded_dp_chunked_tb_rows"] = {
        "B": B, "L": L, "bw": bw, "Lc": Lc, "Lc_k": lc_k,
        "ms": statistics.mean(t for _, t in split["rows"]),
        "normal_ms": statistics.mean(t for _, t in split["normal"]),
        "k2_ms": statistics.mean(f for f, _ in split["normal"] +
                                 split["rows"]),
        "turns_ms": split,
        # the plain pair over every row would take minutes (~2 ms a row
        # on the card, two passes): its row loop over the rows compared,
        # on the CPU copies
        "plain_ms": 1e3 * long[0]["plain_cpu_s"],
        "plain_ms_rows": long[0]["rows_compared"],
        "plain_on": "CPU copies, forward rows only",
        "bound_ms": 1e3 * max(t_b, t_o),
        "bound_by": "bytes" if t_b >= t_o else "operations",
        "max_abs_err": max(c["max_abs_err"] for c in long),
        "codes_equal_frac": min(c["codes_equal_frac"] for c in long),
        "rows_compared": long[0]["rows_compared"]}
    print("debug_dp instances (%s): %s" % (smi, json.dumps(rows)))
    return launches, rows


def nccl_merge_worker(port, out_fn):
    """A one-process NCCL group on the card (a spawned process; one card
    allows no second rank): ``psum_hosts_device`` over it on an int32
    and a float32 array.  Pickles the inputs, the totals and the group's
    backend and size to ``out_fn``."""
    import torch.distributed as tdist
    from tombo_tpu_torch.parallel import distributed
    torch.cuda.set_device(0)
    tdist.init_process_group("nccl", init_method="tcp://127.0.0.1:%d" %
                             port, world_size=1, rank=0)
    rng = np.random.default_rng(5)
    ints = rng.integers(0, 10 ** 6, 100000).astype(np.int32)
    f32 = rng.normal(0, 1, 100000).astype(np.float32)
    ctx = distributed.DistContext(device=torch.device("cuda", 0))
    t0 = time.perf_counter()
    nccl = distributed.psum_hosts_device(ctx, ints, f32)
    torch.cuda.synchronize()
    nccl_s = time.perf_counter() - t0
    out = {"nccl": nccl, "inputs": (ints, f32),
           "backend": tdist.get_backend(), "nccl_s": nccl_s,
           "world": tdist.get_world_size()}
    tdist.destroy_process_group()
    with open(out_fn, "wb") as fp:
        pickle.dump(out, fp)


def mesh_dryrun_phase(smi):
    """The multi-device dry runs on the card: ``parallel/mesh.py::dryrun
    (2)`` (two shards on the one card: ``full_sharded_step``,
    ``sharded_production_step``, ``production_lane_dryrun``,
    ``psum_collective_dryrun``) with the launch counts zeroed before it
    and read after; ``full_sharded_step`` over the two shards bitwise one
    unsharded call; and ``psum_hosts_device`` over a one-process NCCL
    group in a spawned process (:func:`nccl_merge_worker`): the group
    forms and its all-gathers go through on the card; at one rank the
    totals are the inputs, so this shows the route runs, not that a
    merge of two cards is right."""
    from tombo_tpu_torch import kernels
    from tombo_tpu_torch.parallel import mesh as pmesh
    for name in kernels.LAUNCHES:
        kernels.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    out = pmesh.dryrun(2)
    torch.cuda.synchronize()
    dry_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    for name in ("banded_dp", "start_dp", "banded_dp_sharded"):
        if launches[name] <= 0:
            fail("mesh_dryrun: kernel %s was not launched" % name)
    cards = pmesh.make_mesh()
    mesh = (cards * 2)[:2]
    arrays, params = pmesh.dryrun_inputs(2)
    sh = pmesh.full_sharded_step(mesh, params, 5.0, 5, 32, 4)(*arrays)
    one = pmesh.full_sharded_step(mesh[:1], params, 5.0, 5, 32, 4)(*arrays)
    dry = out["full_sharded_step"]
    for got in (sh, dry):
        if not (torch.equal(got[0], one[0]) and torch.equal(got[1], one[1])
                and all(torch.equal(c.to(one[2][0].device), one[2][0])
                        for c in got[2])):
            fail("mesh_dryrun: full_sharded_step over 2 shards differs from "
                 "one unsharded call")
    em, segs, cov = out["production_step"]
    summary = {
        "shards": len(mesh), "cards": len(cards), "dryrun_s": dry_s,
        "launches": {k: v for k, v in launches.items() if v},
        "full_sharded_step": {"scores": list(sh[0].shape),
                              "segs": list(sh[1].shape),
                              "site_cov_sum": int(sh[2][0].sum()),
                              "bitwise_unsharded": True},
        "production_step": {"em": list(em.shape), "segs": list(segs.shape),
                            "cov_sum": int(cov[0].sum())},
        "lane_differences": len(out["lane_differences"]),
        "psum_collective_total": out["psum_total"]}

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        out_fn = os.path.join(tmp, "nccl.pkl")
        proc = multiprocessing.get_context("spawn").Process(
            target=nccl_merge_worker, args=(port, out_fn))
        proc.start()
        proc.join(180)
        if proc.is_alive():
            proc.kill()
            proc.join()
            fail("mesh_dryrun: the NCCL process ran past 180 s")
        if proc.exitcode != 0 or not os.path.exists(out_fn):
            fail("mesh_dryrun: the NCCL process failed (exit code %s)" %
                 proc.exitcode)
        with open(out_fn, "rb") as fp:
            nc = pickle.load(fp)
    (ints, f32), (ni, nf) = nc["inputs"], nc["nccl"]
    if nc["backend"] != "nccl" or nc["world"] != 1:
        fail("mesh_dryrun: NCCL group %s of %d" % (nc["backend"],
                                                   nc["world"]))
    if not (ni.dtype == np.int64 and np.array_equal(ni, ints) and
            nf.dtype == np.float32 and nf.tobytes() == f32.tobytes()):
        fail("mesh_dryrun: psum_hosts_device over NCCL did not return its "
             "inputs at one rank")
    summary["nccl_merge"] = {"world_size": 1, "group_formed": True,
                             "totals_are_inputs_at_one_rank": True,
                             "nccl_s": nc["nccl_s"],
                             "elements": [int(ints.size), int(f32.size)]}
    print("mesh_dryrun (%s): %s" % (smi, json.dumps(summary)))
    return launches


def host_ms(fn):
    """Host-clock ms of one synchronised call."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def plain_rows(smi, seed=0):
    """``--plain-rows`` (see the module's docstring)."""
    from tombo_tpu_torch import kernels
    from tombo_tpu_torch.ops import banded_dp
    from tombo_tpu_torch.parallel import mesh as pmesh
    from tombo_tpu_torch.pipeline import batch as batch_mod
    print("card: " + smi, flush=True)
    kernels.build()
    dev = torch.device(DEVICE)
    pch = banded_dp.adaptive_banded_dp_tb_chunked_plain
    k2 = banded_dp.adaptive_banded_dp_tb_chunked
    for bw in (500, 1500):
        L = batch_mod._pow2_bucket(banded_dp.PER_READ_MOVE_CAP // bw + 1, 256)
        Lc = banded_dp.plan_dp_layout(L, bw)[1]
        a = synthetic_dp_args(4, L, bw, seed + bw, dev)
        print(json.dumps({
            "shape": "chunked pair at an RNA width", "B": 4, "L": L,
            "bw": bw, "Lc": Lc,
            "plain_ms": host_ms(lambda: pch(*a, chunk_rows=Lc)),
            "pair_ms": cuda_ms(lambda: k2(*a, chunk_rows=Lc), 3)}),
            flush=True)
    cards = pmesh.make_mesh()
    mesh = cards if len(cards) > 1 else cards * 2
    L, bw = 32768, 300
    layout = banded_dp.plan_dp_layout(L, bw)
    a = synthetic_dp_args(16, L, bw, seed, dev)
    print(json.dumps({
        "shape": "K3, chunked layout", "B": 16, "L": L, "bw": bw,
        "Lc": layout[1], "shards": len(mesh),
        "plain_ms": host_ms(lambda: [
            pch(*sh, *a[9:], chunk_rows=layout[1])
            for sh in pmesh.shard_batch(mesh, *a[:9])]),
        "k3_ms": cuda_ms(lambda: banded_dp.adaptive_banded_dp_tb_sharded(
            mesh, a[:9], *a[9:], layout), 3)}), flush=True)


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device")
    if sys.argv[1:] not in ([], ["--plain-rows"]):
        fail("usage: chip_smoke.py [--plain-rows]")
    from tombo_tpu_torch import config, kernels, native
    from tombo_tpu_torch.ops import banded_dp, rescale
    from tombo_tpu_torch.pipeline import batch as batch_mod
    from tombo_tpu_torch.pipeline import resquiggle as rsq
    from tombo_tpu_torch.pipeline.batch import BatchedResquiggler

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    if sys.argv[1:]:
        return plain_rows(smi)
    print("card: " + smi)
    print("torch %s, CUDA %s, python %s" % (
        torch.__version__, torch.version.cuda, sys.version.split()[0]))
    dev = torch.device(DEVICE)
    k1, k2, k5 = (banded_dp.adaptive_banded_dp_tb,
                  banded_dp.adaptive_banded_dp_tb_chunked, rescale.count_le)
    pdp, pch = (banded_dp.adaptive_banded_dp_tb_plain,
                banded_dp.adaptive_banded_dp_tb_chunked_plain)
    t_start = time.perf_counter()

    # ---- phase 1: build every kernel from the checkout's sources
    with phase("build"):
        # the host library (g++) builds beside the kernels (nvcc)
        host = {}

        def build_host():
            t0 = time.perf_counter()
            try:
                native.get_native_lib()
            except Exception as e:        # reported after the join
                host["error"] = e
            host["s"] = time.perf_counter() - t0
        th = threading.Thread(target=build_host)
        th.start()
        kernels.build()
        th.join()
        if "error" in host:
            fail("host library build: %s" % host["error"])
        print("kernel build (%s); host library %.1f s" % (", ".join(
            "%s %.1f s" % kv for kv in kernels.BUILD_SECONDS.items()),
            host["s"]))
        for name, log in kernels.BUILD_LOG.items():
            for line in ptxas_summary(log):
                print("  ptxas %s: %s" % (name, line))
        for bw in (300, 500, 750, 1000, 1500, 2500, 3000):
            threads, smem, blocks = banded_dp.banded_dp_occupancy(bw)
            print("  K1 at bw %d: %d threads, %d bytes dynamic shared "
                  "memory, %d blocks an SM (cudaOccupancyMaxActiveBlocks"
                  "PerMultiprocessor)" % (bw, threads, smem, blocks))

    # ---- phase 2: the 1 kb path on the card
    with phase("1 kb path"):
        model, params, sst, maps, fasta_1kb = build_reads(
            [READ_LEN] * (BATCH * (N_BATCHES + 1)), 1234, REF_LEN_1KB,
            "smoke_")
        warm, maps = maps[:BATCH], maps[BATCH:]
        batches = [maps[b * BATCH:(b + 1) * BATCH]
                   for b in range(N_BATCHES)]
        br = BatchedResquiggler(model, params, sst, config.OUTLIER_THRESH,
                                device=DEVICE)
        # one full batch first: CUDA context, lazily loaded kernels, the
        # caching allocator's pools at the batch's sizes
        t0 = time.perf_counter()
        br.resquiggle_batch(warm)
        torch.cuda.synchronize()
        print("warm-up batch of %d reads: %.2f s" % (
            len(warm), time.perf_counter() - t0))
        rec_k1 = Recorder(k1, dp_key)
        rec_k5 = Recorder(k5, lambda keys, piv: (piv.shape[1],
                                                 keys.shape[0]))
        rec_ts = Recorder(rescale.theil_sen_device,
                          lambda ev, *a, **kw: ("ts", ev.shape[0]))
        outs, wall, launches = run_path(
            "1 kb path", br, batches,
            [(banded_dp, "adaptive_banded_dp_tb", rec_k1),
             (rescale, "count_le", rec_k5),
             (rescale, "theil_sen_device", rec_ts)])
        for name in ("banded_dp", "count_le"):
            if launches[name] <= 0:
                fail("kernel %s was not launched on the 1 kb path" % name)
        for name in CHUNKED:
            if launches[name] != 0:
                fail("the 1 kb path launched %s" % name)
        launches_1kb = launches
        br_1kb = br

    # ---- phase 3: kernels against their plain versions, on the card
    entries = []
    with phase("kernels vs plain, 1 kb shapes"):
        main_key = (1024, params.bandwidth)
        start_key = (params.start_n_bases, params.start_bw)
        if main_key not in rec_k1.calls or start_key not in rec_k1.calls:
            fail("1 kb path did not reach the DP shapes %s, %s (saw %s)" % (
                main_key, start_key, sorted(rec_k1.calls)))
        main_args = rec_k1.calls[main_key][1]
        start_args = rec_k1.calls[start_key][1]
        nb = params.start_n_bases
        # start retry shape: spliced captured event rows, start_save_bw band
        ne = params.start_save_bw
        em_s = start_args[0]
        n_cat = -(-(nb + ne) // em_s.shape[1])
        em_r = torch.cat([em_s[i * 16:(i + 1) * 16] for i in range(n_cat)],
                         dim=1)[:, :nb + ne].contiguous()
        full = lambda v: torch.full((16,), v, dtype=torch.int32, device=dev)
        retry_args = (em_r, full(nb + ne), start_args[2][:16],
                      start_args[3][:16], full(nb),
                      torch.arange(nb, dtype=torch.int32, device=dev)[
                          None].expand(16, nb).contiguous(),
                      full(0), torch.full((16, nb), 2 ** 31 - 1,
                                          dtype=torch.int32, device=dev),
                      full(nb), start_args[9]._replace(bandwidth=ne), nb, nb,
                      -1)
        save_args = tuple(a[:16] if torch.is_tensor(a) else a
                          for a in main_args[:9]) + (
            main_args[9]._replace(bandwidth=config.ALGN_PARAMS_TABLE[
                "DNA"].save_bandwidth),) + tuple(main_args[10:])
        k1_shapes = []
        for label, args in (("main DP", main_args), ("start DP", start_args),
                            ("start retry", retry_args),
                            ("save-bandwidth DP", save_args)):
            bw = args[9].bandwidth
            B, L = args[0].shape[0], args[10]
            ko = k1(*args)
            po = pdp(*args)
            torch.cuda.synchronize()
            same_flags, frac, ferr = dp_compare(ko, po, args[4], L)
            ms = cuda_ms(lambda: k1(*args), 20)
            plain_ms = cuda_ms(lambda: pdp(*args), 3)
            bound, by = k1_bound_ms(args, bw)
            shape = {"label": label, "B": B, "L": L, "bw": bw,
                     "segs_equal_frac": frac, "flags_equal": same_flags,
                     "max_abs_err": ferr, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound, "bound_by": by}
            print("banded_dp %s: %s" % (label, json.dumps(shape)))
            check_dp_bars("banded_dp " + label, same_flags, frac, ferr)
            k1_shapes.append(shape)

        # K5 at the fit's shape: counts exact, median slope bitwise
        keys, piv = max(rec_k5.calls.values(), key=lambda v: v[0])[1]
        c_k = k5(keys, piv)
        c_p = rescale.count_le_plain(keys, piv)
        cerr = int((c_k - c_p).abs().max())
        if cerr != 0:
            fail("count_le counts differ from the plain version by %d" %
                 cerr)
        ev, mod, n_pts = rec_ts.calls["ts"][1][:3]
        tri = rescale.tri_indices(ev.shape[1], dev)
        med_k = rescale.pairwise_slope_median_count(ev, mod, n_pts, 1000.0,
                                                    tri=tri)
        med_p = rescale.pairwise_slope_median_count(
            ev, mod, n_pts, 1000.0, tri=tri,
            count_fn=rescale.count_le_plain)
        if not torch.equal(med_k.view(torch.int32), med_p.view(torch.int32)):
            fail("median slope through count_le differs from the plain "
                 "count")
        B5, M5 = keys.shape
        P5 = piv.shape[1]
        ms5 = cuda_ms(lambda: k5(keys, piv), 20)
        plain5 = cuda_ms(lambda: rescale.count_le_plain(keys, piv), 5)
        k_rank = int(rescale._pair_ranks(n_pts)[2][0]) + 1
        try:
            lib5 = cuda_ms(lambda: torch.kthvalue(keys, k_rank, dim=1), 5)
        except RuntimeError as e:      # yardstick only, never on the path
            print("torch.kthvalue yardstick unavailable: %s" % e)
            lib5 = None
        t_b = (B5 * M5 * 4 + 3 * B5 * P5 * 4) / HBM_BYTES_PER_S
        t_o = 2 * B5 * M5 * P5 / F32_OPS_PER_S
        k5_entry = {
            "name": "count_le", "route": "cuda",
            "source": "tombo_tpu_torch/csrc/count_le.cu",
            "replaces": "tombo_tpu/ops/rescale.py:176",
            "launches": launches_1kb["count_le"], "max_abs_err": cerr,
            "ms": ms5, "plain_ms": plain5, "bound_ms": 1e3 * max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "library_ms": lib5, "shape": {"B": B5, "M": M5, "P": P5},
            "median_slope_bitwise": True}
        print("count_le: %s" % json.dumps(k5_entry))

        # the chunked pair forced onto the 1 kb main shape: bitwise K1
        Lc_1kb = 256
        ko = k1(*main_args)
        co = k2(*main_args, chunk_rows=Lc_1kb)
        torch.cuda.synchronize()
        assert_bitwise("1 kb main shape, Lc %d" % Lc_1kb, co, ko)
        forced = {
            "B": main_args[0].shape[0], "L": main_args[10],
            "bw": main_args[9].bandwidth, "Lc": Lc_1kb, "bitwise_k1": True,
            "k1_ms": k1_shapes[0]["ms"],
            "pair_ms": cuda_ms(lambda: k2(*main_args, chunk_rows=Lc_1kb),
                               10),
            "fwd_tb_ms": pair_split_ms(
                lambda: k2(*main_args, chunk_rows=Lc_1kb), 10),
            "k1_peak_bytes": peak_bytes(lambda: k1(*main_args)),
            "pair_peak_bytes": peak_bytes(
                lambda: k2(*main_args, chunk_rows=Lc_1kb))}
        forced["profiler_ms"] = kernel_device_ms(
            lambda: k2(*main_args, chunk_rows=Lc_1kb), 5,
            ("chunked_fwd_kernel", "chunked_tb_kernel"))
        print("chunked pair forced at the 1 kb shape: %s" % json.dumps(
            forced))

    # ---- phase 4: 32 of the 1 kb reads again on the CPU
    with phase("1 kb CPU cross-check"):
        cpu_crosscheck("1 kb CPU cross-check", model, params, sst,
                       batches[0][:32], outs[0][:32])

    # ---- phase 5: where the time goes on the 1 kb path
    with phase("1 kb breakdown"):
        print("stages: %s" % json.dumps(stage_breakdown(br, batches[1])))
        print("device: %s" % json.dumps(device_profile(br, batches[2])))
        host_lane_line("1 kb", br, batches[1])
        raw_wire_check("1 kb", br, batches[1], dev)
        resident_check("1 kb", br, batches[1], dev)

    # ---- phase 6: the mixed-length path on the card
    with phase("mixed path"):
        lens = mixed_lens(BATCH * (N_MIXED_BATCHES + 1), 4321)
        model, params, sst, maps, fasta_m = build_reads(
            lens, 4321, MIXED_REF_LEN, "mixed_")
        print("mixed reads: %d, bases median %d, mean %.0f, max %d; "
              "%d over 16,384 bases" % (
                  len(lens), int(np.median(lens)), lens.mean(), lens.max(),
                  int((lens > 16384).sum())))
        warm, maps = maps[:BATCH], maps[BATCH:]
        mixed = [maps[b * BATCH:(b + 1) * BATCH]
                 for b in range(N_MIXED_BATCHES)]
        br = BatchedResquiggler(model, params, sst, config.OUTLIER_THRESH,
                                device=DEVICE)
        t0 = time.perf_counter()
        br.resquiggle_batch(warm)
        torch.cuda.synchronize()
        print("warm-up batch of %d reads: %.2f s" % (
            len(warm), time.perf_counter() - t0))
        groups = []
        length_groups = batch_mod._length_groups

        def groups_rec(live):
            out = length_groups(live)
            groups.append([(len(g), min(s.raw.shape[0] for s in g),
                            max(s.raw.shape[0] for s in g)) for g in out])
            return out

        rec_k1m = Recorder(k1, dp_key)
        rec_ch = Recorder(k2, dp_key)
        outs_m, wall_m, launches_m = run_path(
            "mixed path", br, mixed,
            [(banded_dp, "adaptive_banded_dp_tb", rec_k1m),
             (banded_dp, "adaptive_banded_dp_tb_chunked", rec_ch),
             (batch_mod, "_length_groups", groups_rec)])
        for name, n in launches_m.items():
            # the row-writing instances run only for the DP debug dump
            if (n > 0) == (name in ROWS_INSTANCES):
                fail("kernel %s launched %d times on the mixed path" % (
                    name, n))
        print("mixed path length groups (reads, min, max signal) of each "
              "pass: %s" % json.dumps(groups))
        for rec, layout in ((rec_k1m, "fused"), (rec_ch, "chunked")):
            for (L, bw), (n, reads) in sorted(rec.count.items()):
                print("  DP L %d bw %d: %s, %d calls, %d reads" % (
                    L, bw, layout, n, reads))
        stages_m = stage_breakdown(br, mixed[0])
        print("stages (mixed): %s" % json.dumps(stages_m))
        host_lane_line("mixed", br, mixed[0])
        raw_wire_check("mixed", br, mixed[0], dev)
        resident_check("mixed", br, mixed[0], dev)
        print("device (mixed): %s" % json.dumps(
            device_profile(br, mixed[1])))

    # ---- phase 6b: K1 at the mixed path's longest fused call
    with phase("K1 vs plain, longest mixed fused shape"):
        fused_keys = [k for k in rec_k1m.calls if k[1] == params.bandwidth]
        if not fused_keys:
            fail("the mixed path ran no fused DP at bw %d" %
                 params.bandwidth)
        margs = rec_k1m.calls[max(fused_keys)][1]
        L = margs[10]
        ko = k1(*margs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        po = pdp(*margs)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        same_flags, frac, ferr = dp_compare(ko, po, margs[4], L)
        bound, by = k1_bound_ms(margs, params.bandwidth)
        shape = {"label": "mixed longest fused", "B": margs[0].shape[0],
                 "L": L, "bw": params.bandwidth, "segs_equal_frac": frac,
                 "flags_equal": same_flags, "max_abs_err": ferr,
                 "ms": cuda_ms(lambda: k1(*margs), 5),
                 "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                 "peak_bytes": peak_bytes(lambda: k1(*margs))}
        print("banded_dp %s: %s" % (shape["label"], json.dumps(shape)))
        check_dp_bars("banded_dp mixed longest fused", same_flags, frac,
                      ferr)
        k1_shapes.append(shape)

    # ---- phase 7: the chunked pair at the captured long shape
    with phase("chunked pair vs K1 and plain, long shape"):
        size, all_args, kw = max(
            rec_ch.calls.values(),
            key=lambda v: v[0] * v[1][10] * v[1][9].bandwidth)
        args = tuple(a[:CHUNKED_SLICE] if torch.is_tensor(a) else a
                     for a in all_args)
        Lc = kw["chunk_rows"]
        B, L, bw = args[0].shape[0], args[10], args[9].bandwidth
        co = k2(*args, **kw)
        ko = k1(*args)
        torch.cuda.synchronize()
        assert_bitwise("captured L %d bw %d" % (L, bw), co, ko)
        t0 = time.perf_counter()
        po = pch(*args, **kw)
        torch.cuda.synchronize()
        plain_pair_ms = 1e3 * (time.perf_counter() - t0)
        same_flags, frac, ferr = dp_compare(co, po, args[4], L)
        check_dp_bars("chunked pair, captured L %d bw %d" % (L, bw),
                      same_flags, frac, ferr)
        seg_err = int((co[0].long() - po[0].long()).abs().max())

        # the plain forward alone (the plain pair less it is K2''s part)
        from tombo_tpu_torch.ops import dp as dp_mod

        def plain_fwd():
            x = dp_mod.dp_inputs(*args[:12])
            st = dp_mod.init_fwd_state(x, bw)
            for r0 in range(0, L, Lc):
                st = dp_mod.adaptive_dp_rows(x, st, r0, min(r0 + Lc, L),
                                             args[9])[0]
            return st
        plain_fwd_ms = cuda_ms(plain_fwd, 1, warm=False)
        dev_ms = kernel_device_ms(lambda: k2(*args, **kw), 3,
                                  ("chunked_fwd_kernel",
                                   "chunked_tb_kernel"))
        pair_ms = cuda_ms(lambda: k2(*args, **kw), 5)
        fwd_ms, tb_ms = pair_split_ms(lambda: k2(*args, **kw), 5)
        # the whole captured call, every read of it
        all_fwd_ms, all_tb_ms = pair_split_ms(lambda: k2(*all_args, **kw), 3)
        k1_ms = cuda_ms(lambda: k1(*args), 5)
        sl_sum = int(torch.clamp(args[4].long(), max=L).sum())
        k2_bound, k2_by = k1_bound_ms(args, bw)
        # K2' moves no move code through device memory: it reads the DP
        # inputs, K2's checkpoints, final row and band starts and writes
        # segs and the bound flags; its recompute repeats K2's operations
        lc_k = banded_dp.tile_rows(bw, min(Lc, L))
        n_ck = -(-L // lc_k)
        tb_bytes = (k1_bound_ms(args, bw, io_bytes=True) +
                    B * n_ck * (bw * 4 + 4) + B * 4)
        tb_bytes_ms = 1e3 * tb_bytes / HBM_BYTES_PER_S
        recompute_ms = 1e3 * sl_sum * bw * K1_OPS_PER_CELL / F32_OPS_PER_S
        tb_bound = max(tb_bytes_ms, recompute_ms)
        tb_by = "operations" if recompute_ms >= tb_bytes_ms else "bytes"
        tb_smem, clusters = banded_dp.chunked_tb_occupancy(bw, lc_k)
        long_shape = {
            "B": B, "L": L, "bw": bw, "Lc": Lc, "Lc_k": lc_k,
            "cluster_blocks": banded_dp.CLUSTER_BLOCKS,
            "active_clusters": clusters, "tb_smem_bytes": tb_smem,
            "reads_in_call": size,
            "bitwise_k1": True, "segs_equal_frac_plain": frac,
            "flags_equal_plain": same_flags, "final_fwd_err_plain": ferr,
            "pair_ms": pair_ms, "k1_ms": k1_ms, "fwd_ms": fwd_ms,
            "tb_ms": tb_ms, "profiler_ms": dev_ms,
            "all_reads": {"B": size, "fwd_ms": all_fwd_ms,
                          "tb_ms": all_tb_ms},
            "plain_pair_ms": plain_pair_ms, "plain_fwd_ms": plain_fwd_ms,
            "k1_peak_bytes": peak_bytes(lambda: k1(*args)),
            "pair_peak_bytes": peak_bytes(lambda: k2(*args, **kw)),
            "k1_move_bytes": B * L * banded_dp.move_stride(bw),
            "pair_scratch_bytes": B * banded_dp.chunked_scratch_bytes(
                L, bw, lc_k),
            "tb_bound_ms": tb_bound, "tb_bytes_bound_ms": tb_bytes_ms,
            "recompute_ops_bound_ms": recompute_ms}
        print("chunked pair at the captured long shape: %s" % json.dumps(
            long_shape))

    # ---- phase 8: 4 mixed reads on the CPU, one of them routed chunked
    with phase("mixed CPU cross-check"):
        res0 = outs_m[0]
        n_bases = [len(m.genome_seq) for m in mixed[0]]
        long_i = [i for i in np.argsort(n_bases)
                  if banded_dp.plan_dp_layout(
                      batch_mod._pow2_bucket(n_bases[i], 256),
                      params.bandwidth)[0] == "chunked"]
        if not long_i:
            fail("no read of the first mixed batch routes chunked")
        pick = [i for i in range(len(n_bases)) if n_bases[i] < 3000][:3]
        pick.append(int(long_i[0]))
        rec_cpu = Recorder(k2, dp_key)
        with patched([(banded_dp, "adaptive_banded_dp_tb_chunked",
                       rec_cpu)]):
            cpu_crosscheck("mixed CPU cross-check (bases %s)" % [
                n_bases[i] for i in pick], model, params, sst,
                [mixed[0][i] for i in pick], [res0[i] for i in pick])
        if not rec_cpu.count:
            fail("the mixed CPU cross-check ran no chunked DP")

    # ---- phase 9: the package's stage profile on the 1 kb and mixed paths
    with phase("stage profile"):
        stage_profile_phase(smi, [("1 kb", br_1kb, batches[1]),
                                  ("mixed", br, mixed[0])])

    # ---- phase 10: the direct-RNA path on the card
    with phase("RNA path"):
        (model_r, params_r, sst_r, maps_r, stalls_r,
         fasta_r) = build_rna_reads(BATCH * (N_RNA_BATCHES + 1), 2468,
                                    RNA_REF_LEN)
        warm, maps_r = maps_r[:BATCH], maps_r[BATCH:]
        stalls_r = stalls_r[BATCH:]
        rna = [maps_r[b * BATCH:(b + 1) * BATCH]
               for b in range(N_RNA_BATCHES)]
        br_r = BatchedResquiggler(model_r, params_r, sst_r,
                                  config.OUTLIER_THRESH, device=DEVICE)
        t0 = time.perf_counter()
        br_r.resquiggle_batch(warm)
        torch.cuda.synchronize()
        print("warm-up batch of %d reads: %.2f s" % (
            len(warm), time.perf_counter() - t0))
        # stall intervals found, and whether each injected stall is in one
        found = [(m.stall_ints or []) for m in maps_r]
        hit = sum(1 for f, st in zip(found, stalls_r) if st is not None and
                  any(a <= (st[0] + st[1]) // 2 <= b for a, b in f))
        n_inj = sum(st is not None for st in stalls_r)
        print("RNA reads: %d, stall intervals on %d reads (%d intervals); "
              "%d injected stalls, %d of them found" % (
                  len(maps_r), sum(1 for f in found if f),
                  sum(len(f) for f in found), n_inj, hit))
        if hit < n_inj:
            fail("RNA path: stall detection missed %d injected stalls" % (
                n_inj - hit))
        seg_rna = batch_mod.BatchedResquiggler._segment_rna
        per_batch = []

        def seg_rna_rec(self, live, *a, **kw):
            out = seg_rna(self, live, *a, **kw)
            per_batch[-1]["stage A reads"] += len(live)
            per_batch[-1]["cpts dropped in stalls"] += sum(
                1 for s in live if s.error is None and
                s.n_ev < s.num_events - 1)
            per_batch[-1]["static after stage A"] += sum(
                1 for s in live if s.use_static)
            return out
        find_static = rsq.find_static_base_assignment

        def static_rec(*a, **kw):
            per_batch[-1]["static band"] += 1
            return find_static(*a, **kw)
        one_batch = br_r.resquiggle_batch

        def batch_rec(batch, **kw):
            per_batch.append({"stage A reads": 0, "cpts dropped in stalls": 0,
                              "static after stage A": 0, "static band": 0})
            return one_batch(batch, **kw)
        rec_k1r = Recorder(k1, dp_key)
        rec_k5r = Recorder(k5, lambda keys, piv: (piv.shape[1],
                                                  keys.shape[0]))
        rec_tsr = Recorder(rescale.theil_sen_device,
                           lambda ev, *a, **kw: ("ts", ev.shape[0]))
        outs_r, wall_r, launches_r = run_path(
            "RNA path", br_r, rna,
            [(banded_dp, "adaptive_banded_dp_tb", rec_k1r),
             (rescale, "count_le", rec_k5r),
             (rescale, "theil_sen_device", rec_tsr),
             (batch_mod.BatchedResquiggler, "_segment_rna", seg_rna_rec),
             (rsq, "find_static_base_assignment", static_rec),
             (br_r, "resquiggle_batch", batch_rec)])
        for name in ("banded_dp", "count_le"):
            if launches_r[name] <= 0:
                fail("kernel %s was not launched on the RNA path" % name)
        print("RNA path per batch (reads through stage A over all passes, "
              "of them reads that lost changepoints inside a stall and reads "
              "routed to the static band, static-band assignments): %s" %
              json.dumps(per_batch))
        for (kl, kbw), (n, reads) in sorted(rec_k1r.count.items()):
            print("  K1 L %d bw %d: %d calls, %d reads" % (kl, kbw, n,
                                                          reads))

    # ---- phase 11: K1, K2/K2' and K5 at the RNA shapes
    with phase("kernels vs plain, RNA shapes"):
        nb = params_r.start_n_bases
        rna_keys = {"main DP": None, "start DP": (nb, params_r.start_bw),
                    "start retry": (nb, params_r.start_save_bw),
                    "save-bandwidth DP": None}
        main_keys = [k for k in rec_k1r.calls if k[1] == params_r.bandwidth]
        if not main_keys or rna_keys["start DP"] not in rec_k1r.calls:
            fail("RNA path did not reach the DP shapes bw %d and %s (saw "
                 "%s)" % (params_r.bandwidth, rna_keys["start DP"],
                          sorted(rec_k1r.calls)))
        main_r = rec_k1r.calls[max(main_keys)][1]
        start_r = rec_k1r.calls[rna_keys["start DP"]][1]
        save_bw = config.ALGN_PARAMS_TABLE["RNA"].save_bandwidth
        cases = [("main DP", main_r, "path"), ("start DP", start_r, "path")]
        if rna_keys["start retry"] in rec_k1r.calls:
            cases.append(("start retry",
                          rec_k1r.calls[rna_keys["start retry"]][1], "path"))
        else:
            # spliced captured event rows at the start_save_bw band
            ne = params_r.start_save_bw
            em_s = start_r[0]
            n_cat = -(-(nb + ne) // em_s.shape[1])
            em_rr = torch.cat([em_s[i * 16:(i + 1) * 16]
                               for i in range(n_cat)],
                              dim=1)[:, :nb + ne].contiguous()
            full = lambda v: torch.full((16,), v, dtype=torch.int32,
                                        device=dev)
            cases.append(("start retry", (
                em_rr, full(nb + ne), start_r[2][:16], start_r[3][:16],
                full(nb), torch.arange(nb, dtype=torch.int32, device=dev)[
                    None].expand(16, nb).contiguous(), full(0),
                torch.full((16, nb), 2 ** 31 - 1, dtype=torch.int32,
                           device=dev), full(nb),
                start_r[9]._replace(bandwidth=ne), nb, nb, -1),
                "spliced"))
        save_keys = [k for k in rec_k1r.calls if k[1] == save_bw]
        if save_keys:
            cases.append(("save-bandwidth DP",
                          rec_k1r.calls[max(save_keys)][1], "path"))
        else:
            cases.append(("save-bandwidth DP", tuple(
                a[:16] if torch.is_tensor(a) else a for a in main_r[:9]) + (
                main_r[9]._replace(bandwidth=save_bw),) + tuple(
                    main_r[10:]), "main DP inputs"))
        ptx = [ln for log in kernels.BUILD_LOG.values()
               for ln in ptxas_summary(log) if ln.startswith("banded_dp_")]
        k1_rna = []
        for label, ra, origin in cases:
            rbw = ra[9].bandwidth
            rB, rL = ra[0].shape[0], ra[10]
            ko = k1(*ra)
            po = pdp(*ra)
            torch.cuda.synchronize()
            r_flags, r_frac, r_ferr = dp_compare(ko, po, ra[4], rL)
            bound, by = k1_bound_ms(ra, rbw)
            threads, smem, blocks = banded_dp.banded_dp_occupancy(rbw)
            maxi = next(m for m in (2, 4, 8, 16) if -(-rbw // 256) <= m)
            shape = {"label": "RNA " + label, "inputs": origin, "B": rB,
                     "L": rL, "bw": rbw, "segs_equal_frac": r_frac,
                     "flags_equal": r_flags, "max_abs_err": r_ferr,
                     "ms": cuda_ms(lambda: k1(*ra), 10),
                     "plain_ms": cuda_ms(lambda: pdp(*ra), 2),
                     "bound_ms": bound, "bound_by": by,
                     "threads": threads, "dyn_smem_bytes": smem,
                     "blocks_per_sm": blocks, "maxi": maxi,
                     "ptxas": [ln for ln in ptx
                               if ln.startswith("banded_dp_kernel<%d>" %
                                                maxi)]}
            print("banded_dp %s: %s" % (shape["label"], json.dumps(shape)))
            check_dp_bars("banded_dp RNA " + label, r_flags, r_frac, r_ferr)
            k1_rna.append(shape)

        # the chunked pair at RNA widths, on reads long enough to route
        # chunked: bitwise K1
        pair_rna = []
        for pbw in (params_r.bandwidth, save_bw):
            # the fewest rows (a power of two) past the fused cap
            pL = batch_mod._pow2_bucket(
                banded_dp.PER_READ_MOVE_CAP // pbw + 1, 256)
            playout = banded_dp.plan_dp_layout(pL, pbw)
            if playout[0] != "chunked":
                fail("L %d at bw %d does not route chunked" % (pL, pbw))
            sargs = synthetic_dp_args(4, pL, pbw, pbw, dev)
            co = k2(*sargs, chunk_rows=playout[1])
            ko = k1(*sargs)
            torch.cuda.synchronize()
            assert_bitwise("RNA width bw %d L %d" % (pbw, pL), co, ko)
            p_fwd, p_tb = pair_split_ms(
                lambda: k2(*sargs, chunk_rows=playout[1]), 3)
            ps = {"B": 4, "L": pL, "bw": pbw,
                  "Lc_k": banded_dp.tile_rows(pbw, playout[1]),
                  "bitwise_k1": True, "fwd_ms": p_fwd, "tb_ms": p_tb,
                  "k1_ms": cuda_ms(lambda: k1(*sargs), 3),
                  "bound_ms": k1_bound_ms(sargs, pbw)[0]}
            print("chunked pair at RNA width: %s" % json.dumps(ps))
            pair_rna.append(ps)

        # K5 at the RNA fit's shape
        keys_r, piv_r = max(rec_k5r.calls.values(), key=lambda v: v[0])[1]
        cerr_r = int((k5(keys_r, piv_r) -
                      rescale.count_le_plain(keys_r, piv_r)).abs().max())
        if cerr_r != 0:
            fail("count_le at the RNA shape differs from the plain version "
                 "by %d" % cerr_r)
        Br, Mr = keys_r.shape
        Pr = piv_r.shape[1]
        t_b = (Br * Mr * 4 + 3 * Br * Pr * 4) / HBM_BYTES_PER_S
        t_o = 2 * Br * Mr * Pr / F32_OPS_PER_S
        k_rank_r = int(rescale._pair_ranks(
            rec_tsr.calls["ts"][1][2])[2][0]) + 1
        try:
            lib5_r = cuda_ms(lambda: torch.kthvalue(keys_r, k_rank_r, dim=1),
                             5)
        except RuntimeError as e:      # yardstick only, never on the path
            print("torch.kthvalue yardstick unavailable: %s" % e)
            lib5_r = None
        k5_rna = {"B": Br, "M": Mr, "P": Pr, "max_abs_err": cerr_r,
                  "ms": cuda_ms(lambda: k5(keys_r, piv_r), 10),
                  "plain_ms": cuda_ms(
                      lambda: rescale.count_le_plain(keys_r, piv_r), 3),
                  "bound_ms": 1e3 * max(t_b, t_o),
                  "bound_by": "bytes" if t_b >= t_o else "operations",
                  "library_ms": lib5_r}
        print("count_le at the RNA shape: %s" % json.dumps(k5_rna))

    # ---- phase 12: 16 of the RNA reads again on the CPU
    with phase("RNA CPU cross-check"):
        cpu_crosscheck("RNA CPU cross-check", model_r, params_r, sst_r,
                       rna[0][:16], outs_r[0][:16])

    # ---- phase 13: where the time goes on the RNA path
    with phase("RNA breakdown"):
        stages_r = stage_breakdown(br_r, rna[1])
        print("stages (RNA): %s" % json.dumps(stages_r))
        host_lane_line("RNA", br_r, rna[1])
        resident_check("RNA", br_r, rna[1], dev)
        print("device (RNA): %s" % json.dumps(device_profile(br_r, rna[0])))

    # ---- phase 13a0: the finalize lanes on a batch of each path
    with phase("lanes"):
        t_ln = time.perf_counter()
        block_args, block_ts, block_launches = lanes_phase(smi, [
            ("1 kb", (model, params, sst), batches[0], outs[0]),
            ("mixed", (model, params, sst), mixed[0], outs_m[0]),
            ("RNA", (model_r, params_r, sst_r), rna[0], outs_r[0])])
        k5_blocks = ts_block_row(k5, block_args, block_ts, block_launches)
        print("lanes phase: %.1f s" % (time.perf_counter() - t_ln))

    # ---- phase 13a: the one-read API on reads of the three paths
    with phase("one_read"):
        t_or = time.perf_counter()
        mixed_all = [m for b in mixed for m in b]
        mixed_res = [r for o in outs_m for r in o]
        pick = one_read_picks(model, mixed_all, mixed_res)
        launches_or, rows_or = one_read_phase(dev, smi, [
            ("1 kb", model, params, sst, batches[0][:ONE_READ_1KB],
             outs[0][:ONE_READ_1KB]),
            ("mixed", model, params, sst, [mixed_all[i] for i in pick],
             [mixed_res[i] for i in pick]),
            ("RNA", model_r, params_r, sst_r, rna[0][:ONE_READ_RNA],
             outs_r[0][:ONE_READ_RNA])],
            [("mixed", stages_m), ("RNA", stages_r)])
        print("one_read phase: %.1f s" % (time.perf_counter() - t_or))

    # ---- phase 13a2: the one-read path's DP debug dump
    with phase("debug_dp"):
        launches_dbg, rows_dbg = debug_dp_phase(dev, smi, [
            ("1 kb", model, params, sst, batches[0][:DEBUG_DP_1KB]),
            ("mixed", model, params, sst, [mixed_all[pick[-1]]]),
            ("RNA", model_r, params_r, sst_r, rna[0][:DEBUG_DP_RNA])])

    # ---- phase 13b: detection on the card from the paths' device means
    with phase("detection"):
        t_det = time.perf_counter()
        detection_phase(dev, outs, outs_m, outs_r, fasta_1kb, fasta_m,
                        fasta_r, model, model_r)
        print("detection phase: %.1f s" % (time.perf_counter() - t_det))

    # ---- phase 13c: the rest of detection, and the level path
    with phase("detection: alt, level, per-read"):
        t_det = time.perf_counter()
        idx_lv_ctrl, idx_lv_samp, fasta_lv = detection_more_phase(
            dev, br, outs, outs_r, fasta_1kb, fasta_r, model, model_r)
        print("detection: alt, level, per-read phase: %.1f s" % (
            time.perf_counter() - t_det))

    # ---- phase 13c2: multi-host detection, two processes on the card
    with phase("multi-host detection"):
        t_mh = time.perf_counter()
        print("card for the multi-host phase: " + smi)
        idx_mh, _, _ = detection_index([r for o in outs for r in o], False,
                                       dev)
        multihost_phase(dev, {"1kb": idx_mh, "ctrl": idx_lv_ctrl,
                              "samp": idx_lv_samp},
                        {"1kb": fasta_1kb, "level": fasta_lv},
                        multihost_runs())
        print("multi-host detection phase: %.1f s" % (
            time.perf_counter() - t_mh))

    # ---- phase 13d: model estimation from the paths' device means
    with phase("model estimation"):
        t_est = time.perf_counter()
        k5_est, idx_alt = estimation_phase(dev, br, outs, outs_r, batches,
                                           rna, fasta_1kb, fasta_r, model,
                                           model_r)
        print("model estimation phase: %.1f s" % (time.perf_counter() -
                                                  t_est))

    # ---- phase 13e: the plot commands' data from the device means
    with phase("plots"):
        t_pl = time.perf_counter()
        line = plots_phase(dev, smi, outs, idx_alt, fasta_1kb, model)
        line["phase_s"] = time.perf_counter() - t_pl
        print("plots " + json.dumps(line))

    # ---- phase 14: the read-sharded lane (K3) over the cards' mesh
    with phase("mesh lane"):
        from tombo_tpu_torch.parallel import mesh as pmesh
        cards = pmesh.make_mesh()
        mesh = cards if len(cards) > 1 else cards * 2
        idx = sorted({d.index for d in mesh})
        print("mesh: %d shards over %d cards (%s)" % (
            len(mesh), len(idx), ", ".join(
                torch.cuda.get_device_name(i) for i in idx)))
        if len(idx) == 1:
            print("  shards share one card: this shows the sharded lane "
                  "exact, not multi-card speed")
        k3 = banded_dp.adaptive_banded_dp_tb_sharded
        k3_shapes = []
        for label, a, layout, unsharded in (
                ("1 kb main shape", main_args, ("fused",), k1),
                ("captured long shape", args, ("chunked", Lc),
                 lambda *x: k2(*x, chunk_rows=Lc))):
            call = lambda: k3(mesh, a[:9], a[9], a[10], a[11], a[12],
                              layout)
            before = dict(kernels.LAUNCHES)
            so = call()
            torch.cuda.synchronize()
            per_call = {n: kernels.LAUNCHES[n] - before[n]
                        for n in kernels.LAUNCHES
                        if kernels.LAUNCHES[n] != before[n]}
            n_shards = sum(1 for n in pmesh.shard_sizes(a[0].shape[0], mesh)
                           if n)
            want = ("banded_dp",) if layout[0] == "fused" else CHUNKED
            if per_call != {n: n_shards for n in want +
                            ("banded_dp_sharded",)}:
                fail("K3 %s: launches %s for %d shards" % (label, per_call,
                                                          n_shards))
            ko, co = k1(*a), k2(*a, chunk_rows=Lc)
            assert_bitwise("K3 vs K1, " + label, so, ko)
            assert_bitwise("K3 vs K2/K2', " + label, so, co)
            shape = {"label": label, "B": a[0].shape[0], "L": a[10],
                     "bw": a[9].bandwidth, "layout": list(layout),
                     "shards": len(mesh), "launches_per_call": per_call,
                     "bitwise_k1": True, "bitwise_pair": True,
                     "max_abs_err": float((so[3] - ko[3]).abs().max()),
                     "ms": cuda_ms(call, 10),
                     "unsharded_ms": cuda_ms(lambda: unsharded(*a), 10)}
            print("K3 %s: %s" % (label, json.dumps(shape)))
            k3_shapes.append(shape)
        # K3's plain version: the plain DP shard by shard, 1 kb shape
        k3_plain_ms = cuda_ms(lambda: [
            pdp(*sh, *main_args[9:]) for sh in
            pmesh.shard_batch(mesh, *main_args[:9])], 1, warm=False)
        k3_bound, k3_by = k1_bound_ms(main_args, main_args[9].bandwidth)

        diffs = pmesh.production_lane_dryrun(mesh, n_reads=4 * len(mesh))
        print("production_lane_dryrun over %d shards: %d reads differ "
              "from the 1-device lane %s" % (len(mesh), len(diffs), diffs))

        # one batch of each path through the mesh lane, its own
        # configuration each; every read bitwise the 1-device lane's
        mesh_batches = [("1 kb", (model, params, sst), batches[0],
                         outs[0]),
                        ("mixed", (model, params, sst), mixed[0], outs_m[0]),
                        ("RNA", (model_r, params_r, sst_r), rna[0],
                         outs_r[0])]
        launches_k3 = {}
        for label, cfg, batch, one_out in mesh_batches:
            brm = BatchedResquiggler(*cfg, config.OUTLIER_THRESH, mesh=mesh)
            (mesh_out,), _, launches = run_path(
                "mesh lane (%s batch)" % label, brm, [batch], [])
            for name in ("banded_dp", "count_le", "banded_dp_sharded"):
                if launches[name] <= 0:
                    fail("kernel %s was not launched on the mesh lane (%s "
                         "batch)" % (name, label))
            for name, n in launches.items():
                launches_k3[name] = launches_k3.get(name, 0) + n
            diffs = pmesh.lane_differences(mesh_out, one_out, exact=True)
            print("mesh lane %s batch: %d of %d reads differ from the "
                  "1-device lane (bitwise compared)" % (label, len(diffs),
                                                        len(batch)))
            if label == "RNA":
                # host-bound at ~40 s a batch: the lane exact is what the
                # RNA batch shows here, not its speed
                continue
            # the two lanes in turns: 1-device, mesh, mesh, 1-device
            one = BatchedResquiggler(*cfg, config.OUTLIER_THRESH,
                                     device=DEVICE)
            walls = {"1-device": [], "mesh": []}
            for lane in ("1-device", "mesh", "mesh", "1-device"):
                t0 = time.perf_counter()
                (one if lane == "1-device" else brm).resquiggle_batch(batch)
                torch.cuda.synchronize()
                walls[lane].append(time.perf_counter() - t0)
            n_ok = sum(1 for r, _ in mesh_out if r is not None)
            print("mesh lane %s batch: %s" % (label, json.dumps({
                "reads_ok": n_ok, "wall_s": walls,
                "reads_per_s": {k: n_ok / statistics.mean(v)
                                for k, v in walls.items()}})))
        for name in CHUNKED:
            if launches_k3.get(name, 0) <= 0:
                fail("kernel %s was not launched on the mesh lane" % name)

    # ---- phase 14b: the multi-device dry runs and the NCCL merge
    with phase("mesh_dryrun"):
        launches_dry = mesh_dryrun_phase(smi)

    # ---- phase 15: the re-squiggle runner over the 1 kb and mixed reads
    with phase("runner"):
        t_rn = time.perf_counter()
        launches_rn = runner_phase(dev, model, params, sst, [
            ("1 kb", batches, outs, fasta_1kb),
            ("mixed", mixed, outs_m, fasta_m)])
        print("runner phase: %.1f s" % (time.perf_counter() - t_rn))

    # ---- the kernels line
    m = k1_shapes[0]
    entries.append({
        "name": "banded_dp", "route": "cuda",
        "source": "tombo_tpu_torch/csrc/banded_dp.cu",
        "replaces": "tombo_tpu/ops/pallas_dp.py:1052",
        "launches": launches_1kb["banded_dp"],
        "launches_mixed": launches_m["banded_dp"],
        "launches_rna": launches_r["banded_dp"],
        "launches_runner": launches_rn["banded_dp"],
        "launches_one_read": launches_or["banded_dp"],
        "max_abs_err": m["max_abs_err"], "ms": m["ms"],
        "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
        "bound_by": m["bound_by"], "library_ms": None,
        "shape_one_read": rows_or["banded_dp"],
        "shapes": k1_shapes + k1_rna})
    sd = k1_shapes[1]
    entries.append({
        "name": "start_dp", "route": "cuda",
        "source": "tombo_tpu_torch/ops/banded_dp.py",
        "kernel_sources": ["tombo_tpu_torch/csrc/banded_dp.cu"],
        "replaces": "tombo_tpu/pipeline/batch.py:819",
        "launches": launches_1kb["start_dp"],
        "launches_mixed": launches_m["start_dp"],
        "launches_rna": launches_r["start_dp"],
        "launches_runner": launches_rn["start_dp"],
        "launches_one_read": launches_or["start_dp"],
        "max_abs_err": sd["max_abs_err"], "ms": sd["ms"],
        "plain_ms": sd["plain_ms"], "bound_ms": sd["bound_ms"],
        "bound_by": sd["bound_by"], "library_ms": None,
        "shape": {k: sd[k] for k in ("B", "L", "bw")},
        "shape_one_read": rows_or["start_dp"]})
    ch_shape = {"B": B, "L": L, "bw": bw, "Lc": Lc, "Lc_k": lc_k,
                "cluster_blocks": banded_dp.CLUSTER_BLOCKS}
    entries.append({
        "name": "banded_dp_chunked_fwd", "route": "cuda",
        "source": "tombo_tpu_torch/csrc/banded_dp_chunked.cu",
        "replaces": "tombo_tpu/ops/pallas_dp.py:798",
        "launches": launches_m["banded_dp_chunked_fwd"],
        "launches_runner": launches_rn["banded_dp_chunked_fwd"],
        "launches_one_read": launches_or["banded_dp_chunked_fwd"],
        "shape_one_read": rows_or.get("banded_dp_chunked_fwd"),
        "max_abs_err": ferr, "ms": fwd_ms,
        "plain_ms": plain_fwd_ms, "bound_ms": k2_bound, "bound_by": k2_by,
        "library_ms": None, "shape": ch_shape,
        "rna_width_shapes": [{k: v for k, v in ps.items() if k != "tb_ms"}
                             for ps in pair_rna]})
    entries.append({
        "name": "banded_dp_chunked_tb", "route": "cuda",
        "source": "tombo_tpu_torch/csrc/banded_dp_chunked.cu",
        "replaces": "tombo_tpu/ops/pallas_dp.py:842",
        "launches": launches_m["banded_dp_chunked_tb"],
        "launches_runner": launches_rn["banded_dp_chunked_tb"],
        "launches_one_read": launches_or["banded_dp_chunked_tb"],
        "shape_one_read": rows_or.get("banded_dp_chunked_tb"),
        "max_abs_err": seg_err, "ms": tb_ms,
        "plain_ms": plain_pair_ms - plain_fwd_ms, "bound_ms": tb_bound,
        "bound_by": tb_by,
        "bound_note": "recompute operations or own input and output "
                      "bytes, the larger; move codes stay in shared memory",
        "library_ms": None, "shape": ch_shape,
        "recompute_ops_bound_ms": recompute_ms,
        "bytes_bound_ms": tb_bytes_ms,
        "rna_width_shapes": [{k: v for k, v in ps.items() if k != "fwd_ms"}
                             for ps in pair_rna]})
    k5_entry["launches_mixed"] = launches_m["count_le"]
    k5_entry["launches_rna"] = launches_r["count_le"]
    k5_entry["launches_runner"] = launches_rn["count_le"]
    k5_entry["launches_one_read"] = launches_or["count_le"]
    k5_entry["shape_one_read"] = rows_or["count_le"]
    k5_entry["shape_rna"] = k5_rna
    k5_entry["launches_estimation"] = k5_est.pop("launches")
    k5_entry["shape_recentring"] = k5_est
    k5_entry["shape_ts_blocks"] = k5_blocks
    entries.append(k5_entry)
    k3m = k3_shapes[0]
    entries.append({
        "name": "banded_dp_sharded", "route": "cuda",
        "source": "tombo_tpu_torch/ops/banded_dp.py",
        "kernel_sources": ["tombo_tpu_torch/csrc/banded_dp.cu",
                           "tombo_tpu_torch/csrc/banded_dp_chunked.cu"],
        "replaces": "tombo_tpu/ops/pallas_dp.py:957",
        "launches": launches_k3["banded_dp_sharded"],
        "launches_runner": launches_rn["banded_dp_sharded"],
        "max_abs_err": max(x["max_abs_err"] for x in k3_shapes),
        "ms": k3m["ms"], "plain_ms": k3_plain_ms, "bound_ms": k3_bound,
        "bound_by": k3_by, "library_ms": None, "shards": len(mesh),
        "launches_mesh_dryrun": launches_dry["banded_dp_sharded"],
        "cards": len(idx), "unsharded_ms": k3m["unsharded_ms"],
        "shapes": k3_shapes})
    for name, k in (("banded_dp_rows", "banded_dp"),
                    ("banded_dp_chunked_tb_rows", "banded_dp_chunked_tb")):
        r = rows_dbg[name]
        entries.append({
            "name": name, "route": "cuda",
            "source": "tombo_tpu_torch/csrc/" + (
                "banded_dp.cu" if k == "banded_dp" else
                "banded_dp_chunked.cu"),
            "replaces": ("tombo_tpu/pipeline/resquiggle.py:536 (the DP "
                         "debug dump's forward pass, on the path of %s)" %
                         ("tombo_tpu/ops/pallas_dp.py:1052" if k ==
                          "banded_dp" else
                          "tombo_tpu/ops/pallas_dp.py:842")),
            "launches": launches_dbg[name],
            "launches_main_paths": sum(
                lc.get(name, 0) for lc in (launches_1kb, launches_m,
                                           launches_r, launches_rn,
                                           launches_or, launches_dry)),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "normal_instance_ms": r["normal_ms"], "shape": r})
    print("total wall %.1f s" % (time.perf_counter() - t_start))
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except SystemExit:
        raise
    except BaseException as e:          # any failed phase: no result line
        import traceback
        traceback.print_exc()
        fail("%s: %s" % (type(e).__name__, e))
