"""Card smoke run of the PyTorch/CUDA port (tombo_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and nvcc (CUDA_HOME, default /usr/local/cuda).  It
builds the port's kernels from tombo_tpu_torch/csrc/, drives the main
path -- batched DNA re-squiggle of 3 x 512 simulated 1000-base reads
through ``BatchedResquiggler.resquiggle_batches`` at the default DNA
configuration (bandwidth 300, start band 750/2500, save bandwidth 1500,
3 scaling iterations) -- checks that the path launched every kernel,
holds each kernel against its plain PyTorch version on inputs captured
from that run, re-runs 32 of the reads on the CPU and compares, and
prints one JSON line per kernel summary plus a final status line.  Any
failed phase exits non-zero without the status line.
"""
import json
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


def fail(msg):
    print("FAILED: " + msg, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps):
    """Median milliseconds of ``fn`` over ``reps`` CUDA-event-timed calls
    (after one warm-up call)."""
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


def build_reads(n_reads, seed):
    """Simulated, mapped 1 kb DNA reads (bench.py's recipe)."""
    from tombo_tpu_torch import config
    from tombo_tpu_torch.io.model_io import KmerModel
    from tombo_tpu_torch.pipeline import resquiggle as rsq
    from tombo_tpu_torch.pipeline.aligner import ExactAligner
    from tombo_tpu_torch.testing import random_reference, simulate_read
    from tombo_tpu_torch.types import SeqSampleType, SequenceData
    rng = np.random.default_rng(seed)
    model = KmerModel.load_default("DNA")
    fasta = random_reference(np.random.default_rng(5), 60000)
    aligner = ExactAligner(fasta)
    sst = SeqSampleType("DNA", False)
    params = config.load_resquiggle_parameters("DNA")
    maps = []
    for i in range(n_reads):
        read = simulate_read(rng, fasta, model, read_len=READ_LEN,
                             read_id="smoke_%05d" % i, mean_dwell=MEAN_DWELL)
        mr = rsq.map_read(SequenceData(read.seq, read.read_id, 12.0),
                          aligner, model, sst)
        mr = mr.replace(raw_signal=read.raw_signal.astype(np.float64))
        maps.append(rsq.adjust_map_res(mr, sst, params))
    return model, params, sst, maps


class Recorder:
    """Wraps a kernel wrapper to keep the inputs of its largest call per
    shape key; forwards every call unchanged."""

    def __init__(self, fn, key_fn):
        self.fn, self.key_fn, self.calls = fn, key_fn, {}

    def __call__(self, *args, **kw):
        key, size = self.key_fn(*args)
        if key not in self.calls or self.calls[key][0] < size:
            self.calls[key] = (size, args)
        return self.fn(*args, **kw)


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
    edge so that device work is charged to the layer that queued it."""
    cls = type(br)
    acc = {label: 0.0 for label in STAGES.values()}
    stack, orig = [], {}

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
        t0 = time.perf_counter()
        br.resquiggle_batch(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for name, fn in orig.items():
            setattr(cls, name, fn)
    acc["other (host)"] = wall - sum(acc.values())
    return {"reads": len(batch), "wall_s": wall, "stages_s": acc}


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


def k1_bound_ms(args, bw):
    em, nev, rm, rs, sl, ps, pv, pe, sr = args[:9]
    B, E = em.shape
    L = args[10]
    nbytes = (B * E * 4 + 4 * B * 4 + 2 * rm.numel() * 4 + 2 * ps.numel() * 4
              + B * (L + 1) * 4 + 2 * B + B * bw * 4)
    cells = int(torch.clamp(sl.long(), max=L).sum()) * bw
    ops = cells * K1_OPS_PER_CELL
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device")
    from tombo_tpu_torch import config, kernels
    from tombo_tpu_torch.ops import banded_dp, rescale
    from tombo_tpu_torch.pipeline.batch import BatchedResquiggler

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print("card: " + smi)
    print("torch %s, CUDA %s, python %s" % (
        torch.__version__, torch.version.cuda, sys.version.split()[0]))
    dev = torch.device("cuda")

    # ---- phase 1: build every kernel from the checkout's sources
    t0 = time.perf_counter()
    kernels.build()
    print("kernel build %.1f s (%s)" % (
        time.perf_counter() - t0, ", ".join(
            "%s %.1f s" % kv for kv in kernels.BUILD_SECONDS.items())))
    for name, log in kernels.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas %s: %s" % (name, line.strip()))

    # ---- phase 2: the main path on the card
    model, params, sst, maps = build_reads(BATCH * (N_BATCHES + 1), 1234)
    warm, maps = maps[:BATCH], maps[BATCH:]
    batches = [maps[b * BATCH:(b + 1) * BATCH] for b in range(N_BATCHES)]
    br = BatchedResquiggler(model, params, sst, config.OUTLIER_THRESH,
                            device="cuda")
    # one full batch first: CUDA context, lazily loaded kernels, the
    # caching allocator's pools at the batch's sizes
    t0 = time.perf_counter()
    br.resquiggle_batch(warm)
    torch.cuda.synchronize()
    print("warm-up batch of %d reads: %.2f s" % (len(warm),
                                                time.perf_counter() - t0))

    k1, k5 = banded_dp.adaptive_banded_dp_tb, rescale.count_le
    rec_k1 = Recorder(k1, lambda *a: ((a[10], a[9].bandwidth), a[0].shape[0]))
    rec_k5 = Recorder(k5, lambda keys, piv: (piv.shape[1], keys.shape[0]))
    rec_ts = Recorder(rescale.theil_sen_device,
                      lambda ev, *a, **kw: ("ts", ev.shape[0]))
    banded_dp.adaptive_banded_dp_tb = rec_k1
    rescale.count_le = rec_k5
    rescale.theil_sen_device = rec_ts
    for name in kernels.LAUNCHES:
        kernels.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    outs = []
    for out in br.resquiggle_batches(batches, pipeline_depth=3):
        outs.append(out)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    banded_dp.adaptive_banded_dp_tb = k1
    rescale.count_le = k5
    rescale.theil_sen_device = rec_ts.fn
    results = [r for o in outs for r in o]
    n_ok = sum(1 for r, e in results if r is not None)
    print("main path: %d/%d reads ok in %.2f s = %.1f reads/s on the card "
          "(launches %s)" % (n_ok, len(results), wall, n_ok / wall,
                             launches))
    errs = {}
    for r, e in results:
        if e is not None:
            errs[e] = errs.get(e, 0) + 1
    if errs:
        print("  errors: %s" % errs)
    if n_ok < 0.9 * len(results):
        fail("fewer than 90%% of reads succeeded (%d/%d)" % (
            n_ok, len(results)))
    for name, n in launches.items():
        if n <= 0:
            fail("kernel %s was not launched on the main path" % name)
    for res, _ in results:
        if res is not None and not (
                np.isfinite(res.sig_match_score) and
                res.segs.shape[0] == len(res.genome_seq) + 1 and
                np.all(np.diff(res.segs) > 0)):
            fail("malformed result for %s" % res.align_info.read_id)

    # ---- phase 3: kernels against their plain versions, on the card
    entries = []
    pdp = banded_dp.adaptive_banded_dp_tb_plain
    main_key = (1024, params.bandwidth)
    start_key = (params.start_n_bases, params.start_bw)
    if main_key not in rec_k1.calls or start_key not in rec_k1.calls:
        fail("main path did not reach the DP shapes %s, %s (saw %s)" % (
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
                  torch.arange(nb, dtype=torch.int32,
                               device=dev)[None].expand(16, nb).contiguous(),
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
        seg_k, seg_p = ko[0].long(), po[0].long()
        sl = args[4].long()
        mask = (torch.arange(L + 1, device=dev)[None, :] <=
                torch.clamp(sl, max=L)[:, None])
        frac = float((seg_k == seg_p)[mask].float().mean())
        same_flags = (torch.equal(ko[1], po[1]) and
                      torch.equal(ko[2], po[2]))
        ferr = float((ko[3] - po[3]).abs().max())
        ms = cuda_ms(lambda: k1(*args), 20)
        plain_ms = cuda_ms(lambda: pdp(*args), 3)
        bound, by = k1_bound_ms(args, bw)
        shape = {"label": label, "B": B, "L": L, "bw": bw,
                 "segs_equal_frac": frac, "flags_equal": same_flags,
                 "max_abs_err": ferr, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": bound, "bound_by": by}
        print("banded_dp %s: %s" % (label, json.dumps(shape)))
        if not same_flags:
            fail("banded_dp %s: error flags differ from the plain "
                 "version" % label)
        if frac < 0.995:
            fail("banded_dp %s: only %.4f of boundaries equal" % (label,
                                                                  frac))
        if not ferr <= 1e-3:
            fail("banded_dp %s: final_fwd differs by %g" % (label, ferr))
        k1_shapes.append(shape)
    m = k1_shapes[0]
    entries.append({
        "name": "banded_dp", "route": "cuda",
        "source": "tombo_tpu_torch/csrc/banded_dp.cu",
        "replaces": "tombo_tpu/ops/pallas_dp.py:1052",
        "launches": launches["banded_dp"], "max_abs_err": m["max_abs_err"],
        "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
        "bound_by": m["bound_by"], "library_ms": None,
        "shapes": k1_shapes})

    # K5 at the fit's shape: counts exact, median slope bitwise
    kb = max(rec_k5.calls.values(), key=lambda v: v[0])[1]
    keys, piv = kb
    c_k = k5(keys, piv)
    c_p = rescale.count_le_plain(keys, piv)
    cerr = int((c_k - c_p).abs().max())
    if cerr != 0:
        fail("count_le counts differ from the plain version by %d" % cerr)
    ev, mod, n_pts = rec_ts.calls["ts"][1][:3]
    tri = rescale.tri_indices(ev.shape[1], dev)
    med_k = rescale.pairwise_slope_median_count(ev, mod, n_pts, 1000.0,
                                                tri=tri)
    med_p = rescale.pairwise_slope_median_count(
        ev, mod, n_pts, 1000.0, tri=tri, count_fn=rescale.count_le_plain)
    if not torch.equal(med_k.view(torch.int32), med_p.view(torch.int32)):
        fail("median slope through count_le differs from the plain count")
    B5, M5 = keys.shape
    P5 = piv.shape[1]
    ms5 = cuda_ms(lambda: k5(keys, piv), 20)
    plain5 = cuda_ms(lambda: rescale.count_le_plain(keys, piv), 5)
    k_rank = int(rescale._pair_ranks(n_pts)[2][0]) + 1
    try:
        lib5 = cuda_ms(lambda: torch.kthvalue(keys, k_rank, dim=1), 5)
    except RuntimeError as e:          # yardstick only, never on the path
        print("torch.kthvalue yardstick unavailable: %s" % e)
        lib5 = None
    t_b = (B5 * M5 * 4 + 3 * B5 * P5 * 4) / HBM_BYTES_PER_S
    t_o = 2 * B5 * M5 * P5 / F32_OPS_PER_S
    k5_entry = {
        "name": "count_le", "route": "cuda",
        "source": "tombo_tpu_torch/csrc/count_le.cu",
        "replaces": "tombo_tpu/ops/rescale.py:176",
        "launches": launches["count_le"], "max_abs_err": cerr,
        "ms": ms5, "plain_ms": plain5, "bound_ms": 1e3 * max(t_b, t_o),
        "bound_by": "bytes" if t_b >= t_o else "operations",
        "library_ms": lib5, "shape": {"B": B5, "M": M5, "P": P5},
        "median_slope_bitwise": True}
    print("count_le: %s" % json.dumps(k5_entry))
    entries.append(k5_entry)

    # ---- phase 4: 32 of the reads again on the CPU
    sub = batches[0][:32]
    cpu = BatchedResquiggler(model, params, sst, config.OUTLIER_THRESH,
                             device="cpu")
    t0 = time.perf_counter()
    cpu_out = cpu.resquiggle_batch(sub)
    print("CPU subset: %d reads in %.1f s" % (len(sub),
                                               time.perf_counter() - t0))
    worst = {"segs": 1.0, "shift": 0.0, "scale": 0.0, "score": 0.0}
    for i, ((g, ge), (c, ce)) in enumerate(zip(outs[0][:32], cpu_out)):
        if (ge is None) != (ce is None):
            fail("read %d: card error %r vs CPU error %r" % (i, ge, ce))
        if g is None:
            continue
        if g.segs.shape != c.segs.shape or \
                g.read_start_rel_to_raw != c.read_start_rel_to_raw:
            fail("read %d: segment table or start differs" % i)
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
            fail("read %d: card vs CPU outside tolerance %s" % (i, d))
    print("card vs CPU on 32 reads, worst: %s" % json.dumps(worst))

    # ---- phase 5: where the time goes
    print("stages: %s" % json.dumps(stage_breakdown(br, batches[1])))
    print("device: %s" % json.dumps(device_profile(br, batches[2])))

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
