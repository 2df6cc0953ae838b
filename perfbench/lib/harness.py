"""One run of one cell: set-up (the pool of reads made from the seed and
mapped by the program, warm-up batches), the timed window over the
program's ``BatchedResquiggler.resquiggle_batches``, an optional traced
slice, then the check against the plain reference.  Returns the result
line's object."""
from __future__ import annotations

import dataclasses
import gc
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

import numpy as np

from perfbench.lib import check, host, program, spec as spec_mod, traffic
from perfbench.lib.trace import Slice

GIB = 2.0 ** 30
# batches of the traced slice, taken from the middle of the window
SLICE_BATCHES = 3


@dataclasses.dataclass
class Ctx:
    """What a per-layer metric's reader reads: the stage profile of the
    window (less the traced slice) and the reads it covers, the traced
    slice and the kernel launches recorded in it."""
    timings: dict
    transfer_bytes: dict
    reads: int
    slice: Optional[Slice]
    slice_wall_s: float
    launches: List[dict]
    device_name: str


def smi() -> Optional[dict]:
    """The card's name, power limit, SM clock and power draw, from
    nvidia-smi; None where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "power.draw", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    first = out.strip().splitlines()[0].split(",")
    return {"name": first[0].strip(), "power_limit_w": first[1].strip(),
            "sm_clock_mhz": first[2].strip(), "power_draw_w": first[3].strip()}


def log(msg: str):
    sys.stderr.write(msg + "\n")
    sys.stderr.flush()


def run_cell(spec: spec_mod.Spec, cell_name: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t_start: Optional[float] = None,
             ref_workers: Optional[int] = None,
             control: Optional[str] = None, detail: bool = False) -> dict:
    """``control``: a precision (``bfloat16``) at which the reference is
    also run on the sampled reads, in the program's place; its numbers
    against the float64 reference go under ``control`` in the result.
    ``detail``: each sampled read's gaps go under ``read_gaps``.  The
    benchmark's own runs leave both unset."""
    import torch
    from perfbench.reference.resquiggle import KmerModel
    t_start = time.perf_counter() if t_start is None else t_start
    on_card = device != "cpu"
    cell = spec.cell(cell_name)
    cfg, tr = spec.config(cell), spec.traffic(cell)
    prog = program.load(cfg)

    sim_model = KmerModel(os.path.join(spec.bench_dir, "reference", "models",
                                       cfg["model_file"]))
    pool = traffic.make_pool(tr, seed, sim_model)
    maps = program.map_reads(prog, pool.reads, pool.ref)
    batches = [[maps[i] for i in b] for b in pool.batches]
    t_pool = time.perf_counter()
    br = program.resquiggler(prog, device)
    order = [int(b) for b in pool.order]
    for k in range(int(tr["warmup_batches"])):
        br.resquiggle_batch(batches[order[k % len(order)]])
    if on_card:
        torch.cuda.synchronize()
    card_before = smi() if on_card else None
    setup_s = time.perf_counter() - t_start
    log("set-up %.3f s (pool and mapping %.3f s, %d reads)" % (
        setup_s, t_pool - t_start, len(pool.reads)))

    sample = traffic.Reservoir(traffic.seed_rng(seed, 2),
                               int(tr["check_reads"]))
    attempted = failed = bases = 0
    profile = program.new_profile() if trace else None
    br.profile = profile
    prof_reads = 0
    launches: List[dict] = []
    trace_dir = None
    slice_obj, slice_wall = None, 0.0

    def take(b: int, out, profiled: bool):
        nonlocal attempted, failed, bases, prof_reads
        for j, (res, _err) in enumerate(out):
            attempted += 1
            if res is None:
                failed += 1
                fields = None
            else:
                bases += len(res.genome_seq)
                fields = program.result_fields(res)
            sample.add((pool.batches[b][j], fields))
        if profiled:
            prof_reads += len(out)

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    watch = host.Watch()
    t0 = time.perf_counter()
    k = 0

    def feed(until: float, log_to: list):
        nonlocal k
        while time.perf_counter() - t0 < until:
            b = order[k % len(order)]
            k += 1
            log_to.append(b)
            yield batches[b]

    batch_s: List[float] = []

    def drive(until: float, profiled: bool):
        fed: list = []
        tb = time.perf_counter()
        for n, out in enumerate(br.resquiggle_batches(feed(until, fed))):
            take(fed[n], out, profiled)
            now = time.perf_counter()
            batch_s.append(now - tb)
            tb = now

    if trace:
        drive(seconds / 2.0, True)
        br.profile = None
        trace_dir = tempfile.mkdtemp(prefix="perfbench_trace_")
        fed = [order[(k + i) % len(order)] for i in range(SLICE_BATCHES)]
        k += SLICE_BATCHES
        with program.record_launches(launches):
            outs = list(br.resquiggle_batches([batches[b] for b in fed],
                                              trace_dir=trace_dir))
        for b, out in zip(fed, outs):
            take(b, out, False)
        br.profile = profile
        drive(seconds, True)
    else:
        drive(seconds, False)
    if on_card:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    host_use = watch.read()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    card_after = smi() if on_card else None
    log("window %.3f s, %d batches, %d reads, %d failed" % (
        window_s, k, attempted, failed))
    if batch_s:
        q = np.percentile(batch_s, [0, 25, 50, 75, 100])
        log("batch s: first %.4f min %.4f q1 %.4f median %.4f q3 %.4f "
            "max %.4f" % ((batch_s[0],) + tuple(q)))
    log("host: %r" % host_use)

    if trace_dir is not None:
        files = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)
                 if f.endswith(".json")]
        if files:
            slice_obj = Slice.load(files[0])
            # the traced stages' span: the wall time of the slice less the
            # profiler's start and the writing of its trace
            lo, hi = slice_obj.span()
            slice_wall = (hi - lo) * 1e-6
        shutil.rmtree(trace_dir, ignore_errors=True)

    # the program's state goes before the reference runs
    del br, batches, maps
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    picks = [idx for idx, _ in sample.items]
    got = [fields for _, fields in sample.items]
    t_ref = time.perf_counter()
    want = check.reference_fields(check.run_reference(
        check.reference_jobs(pool, picks, cfg, cfg["sample_type"] == "RNA",
                             "float64"), ref_workers))
    numbers = check.compare(got, want)
    control_numbers = None
    gaps = {"program": check.read_gaps(got, want)} if detail else None
    if control is not None:
        ctl = check.reference_fields(check.run_reference(
            check.reference_jobs(pool, picks, cfg,
                                 cfg["sample_type"] == "RNA", control),
            ref_workers))
        control_numbers = check.compare(ctl, want)
        if detail:
            gaps["control"] = check.read_gaps(ctl, want)
    correct, checks = check.judge(numbers, spec.limits(cell))
    log("reference %.3f s over %d reads" % (time.perf_counter() - t_ref,
                                            len(picks)))

    name = torch.cuda.get_device_name(0) if on_card else "cpu"
    dev = {"platform": "gpu" if on_card else "cpu", "kind": name,
           "count": 1, "memory_peak_bytes": int(peak)}
    if card_before is not None:
        dev["power_limit_w"] = card_before["power_limit_w"]
        dev["nvidia_smi"] = [card_before, card_after]
    line = {"correct": bool(correct), "attempted": attempted,
            "failed": failed}
    metrics = {}
    if not trace:
        # a name's part before the first dot is the quantity: one entry of
        # BENCHMARK.json holds one bound, so a quantity whose cells need
        # bounds apart has an entry, suffixed, for each group of cells
        value = {"bases_per_s": bases / window_s,
                 "device_peak_gib": peak / GIB, "setup_s": setup_s}
        for m in spec.end_to_end(cell):
            metrics[m["name"]] = {"value": value[m["name"].split(".")[0]],
                                  "unit": m["unit"]}
    else:
        ctx = Ctx(dict(profile.timings), dict(profile.transfer_bytes),
                  prof_reads, slice_obj, slice_wall, launches, name)
        for m in spec.per_layer(cell):
            v = spec_mod.read_metric(spec.reader(m["name"]), ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if slice_obj is not None:
            dev["busy_s"] = slice_obj.busy_s()
            dev["window_s"] = slice_wall
            line["breakdown"] = {"device_ops": slice_obj.device_ops(),
                                 "idle_gaps": slice_obj.idle_by_stage()}
    line["metrics"] = metrics
    line["device"] = dev
    line["host"] = host_use
    if control_numbers is not None:
        line["control"] = control_numbers
    if gaps is not None:
        line["read_gaps"] = gaps
    line["checks"] = checks
    return line
