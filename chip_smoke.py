"""Card smoke run of the PyTorch/CUDA port (tombo_tpu_torch).

    python3 chip_smoke.py

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
  mesh lane     ``BatchedResquiggler(mesh=...)`` over every visible card
                (two shards on one card when there is one), on one batch
                of each path: every group's adaptive DP through the
                read-sharded launcher (K3), every read bitwise the 1-device
                lane's.

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
"""
import contextlib
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# published H100 SXM peaks at the full 700 W limit (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12          # non-tensor float32; used for int32 too
K1_OPS_PER_CELL = 20           # f32 ops per active band cell and row
READ_LEN, BATCH, N_BATCHES, MEAN_DWELL = 1000, 512, 3, 7.0
# bench.py's mixed-length recipe: log-normal read lengths (median ~2.7 kb)
# clipped to 600-30,000 bases, on a 120,000-base reference
MIXED_LOG_MEAN, MIXED_LOG_SD = 7.9, 0.85
MIXED_MIN_LEN, MIXED_MAX_LEN, MIXED_REF_LEN = 600, 30000, 120000
N_MIXED_BATCHES = 2
# tests/test_torch_rna.py's recipe, on a 60,000-base reference
RNA_LEN, RNA_DWELL, RNA_ADAPTER, RNA_REF_LEN = 1700, 12.0, (600, 900), 60000
RNA_STALL, RNA_STALL_EVERY = (2000, 4000), 8
N_RNA_BATCHES = 2
CHUNKED = ("banded_dp_chunked_fwd", "banded_dp_chunked_tb")
CHUNKED_SLICE = 16             # reads of the captured long call held
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
            args = re.findall(r"Li(\d+)E", m.group(2) or "")
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


def build_reads(read_lens, seed, ref_len):
    """Simulated, mapped DNA reads of the given lengths (bench.py's
    recipe)."""
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
        read = simulate_read(rng, fasta, model, read_len=int(n),
                             read_id="smoke_%05d" % i, mean_dwell=MEAN_DWELL)
        mr = rsq.map_read(SequenceData(read.seq, read.read_id, 12.0),
                          aligner, model, sst)
        mr = mr.replace(raw_signal=read.raw_signal.astype(np.float64))
        maps.append(rsq.adjust_map_res(mr, sst, params))
    return model, params, sst, maps


def build_rna_reads(n_reads, seed, ref_len):
    """Simulated, mapped, adjusted direct-RNA reads; one in
    RNA_STALL_EVERY gets a pore stall at its middle base boundary.
    Returns the model, parameters, sample type, the mapped reads and, per
    read, the stall's (start, end) in the adjusted (5' to 3') signal or
    None."""
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
    return model, params, sst, maps, stalls


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


def device_profile(br, batch):
    """Device busy share and the kernels that take the most device time
    over one ``resquiggle_batch``, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        br.resquiggle_batch(batch)
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
    worst = {"segs": 1.0, "shift": 0.0, "scale": 0.0, "score": 0.0}
    for i, ((g, ge), (c, ce)) in enumerate(zip(card_results, cpu_out)):
        if (ge is None) != (ce is None):
            fail("%s read %d: card error %r vs CPU error %r" % (label, i, ge,
                                                                ce))
        if g is None:
            continue
        if g.segs.shape != c.segs.shape or \
                g.read_start_rel_to_raw != c.read_start_rel_to_raw:
            fail("%s read %d: segment table or start differs" % (label, i))
        sc = c.scale_values.scale
        d = {"segs": float(np.mean(g.segs == c.segs)),
             "shift": abs(g.scale_values.shift - c.scale_values.shift) / sc,
             "scale": abs(g.scale_values.scale - sc) / sc,
             "score": abs(g.sig_match_score - c.sig_match_score)}
        worst = {"segs": min(worst["segs"], d["segs"]),
                 "shift": max(worst["shift"], d["shift"]),
                 "scale": max(worst["scale"], d["scale"]),
                 "score": max(worst["score"], d["score"])}
        if not (d["segs"] > 0.99 and d["shift"] < 2e-3 and
                d["scale"] < 2e-3 and d["score"] < 1e-2):
            fail("%s read %d: card vs CPU outside tolerance %s" % (label, i,
                                                                  d))
    print("%s: card vs CPU, worst: %s" % (label, json.dumps(worst)))


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device")
    from tombo_tpu_torch import config, kernels
    from tombo_tpu_torch.ops import banded_dp, rescale
    from tombo_tpu_torch.pipeline import batch as batch_mod
    from tombo_tpu_torch.pipeline import resquiggle as rsq
    from tombo_tpu_torch.pipeline.batch import BatchedResquiggler

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
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
        kernels.build()
        print("kernel build (%s)" % ", ".join(
            "%s %.1f s" % kv for kv in kernels.BUILD_SECONDS.items()))
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
        model, params, sst, maps = build_reads(
            [READ_LEN] * (BATCH * (N_BATCHES + 1)), 1234, 60000)
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

    # ---- phase 6: the mixed-length path on the card
    with phase("mixed path"):
        lens = mixed_lens(BATCH * (N_MIXED_BATCHES + 1), 4321)
        model, params, sst, maps = build_reads(lens, 4321, MIXED_REF_LEN)
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
            if n <= 0:
                fail("kernel %s was not launched on the mixed path" % name)
        print("mixed path length groups (reads, min, max signal) of each "
              "pass: %s" % json.dumps(groups))
        for rec, layout in ((rec_k1m, "fused"), (rec_ch, "chunked")):
            for (L, bw), (n, reads) in sorted(rec.count.items()):
                print("  DP L %d bw %d: %s, %d calls, %d reads" % (
                    L, bw, layout, n, reads))
        print("stages (mixed): %s" % json.dumps(
            stage_breakdown(br, mixed[0])))
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

    # ---- phase 10: the direct-RNA path on the card
    with phase("RNA path"):
        model_r, params_r, sst_r, maps_r, stalls_r = build_rna_reads(
            BATCH * (N_RNA_BATCHES + 1), 2468, RNA_REF_LEN)
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
        for (L, bw), (n, reads) in sorted(rec_k1r.count.items()):
            print("  K1 L %d bw %d: %d calls, %d reads" % (L, bw, n, reads))

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
        print("stages (RNA): %s" % json.dumps(stage_breakdown(br_r, rna[1])))
        print("device (RNA): %s" % json.dumps(device_profile(br_r, rna[0])))

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

    # ---- the kernels line
    m = k1_shapes[0]
    entries.append({
        "name": "banded_dp", "route": "cuda",
        "source": "tombo_tpu_torch/csrc/banded_dp.cu",
        "replaces": "tombo_tpu/ops/pallas_dp.py:1052",
        "launches": launches_1kb["banded_dp"],
        "launches_mixed": launches_m["banded_dp"],
        "launches_rna": launches_r["banded_dp"],
        "max_abs_err": m["max_abs_err"], "ms": m["ms"],
        "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
        "bound_by": m["bound_by"], "library_ms": None,
        "shapes": k1_shapes + k1_rna})
    ch_shape = {"B": B, "L": L, "bw": bw, "Lc": Lc, "Lc_k": lc_k,
                "cluster_blocks": banded_dp.CLUSTER_BLOCKS}
    entries.append({
        "name": "banded_dp_chunked_fwd", "route": "cuda",
        "source": "tombo_tpu_torch/csrc/banded_dp_chunked.cu",
        "replaces": "tombo_tpu/ops/pallas_dp.py:798",
        "launches": launches_m["banded_dp_chunked_fwd"],
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
    k5_entry["shape_rna"] = k5_rna
    entries.append(k5_entry)
    k3m = k3_shapes[0]
    entries.append({
        "name": "banded_dp_sharded", "route": "cuda",
        "source": "tombo_tpu_torch/ops/banded_dp.py",
        "kernel_sources": ["tombo_tpu_torch/csrc/banded_dp.cu",
                           "tombo_tpu_torch/csrc/banded_dp_chunked.cu"],
        "replaces": "tombo_tpu/ops/pallas_dp.py:957",
        "launches": launches_k3["banded_dp_sharded"],
        "max_abs_err": max(x["max_abs_err"] for x in k3_shapes),
        "ms": k3m["ms"], "plain_ms": k3_plain_ms, "bound_ms": k3_bound,
        "bound_by": k3_by, "library_ms": None, "shards": len(mesh),
        "cards": len(idx), "unsharded_ms": k3m["unsharded_ms"],
        "shapes": k3_shapes})
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
