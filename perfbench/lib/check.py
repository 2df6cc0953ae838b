"""The check that decides ``correct``: a sample of the reads the window
finished, drawn from the seed, re-squiggled again by the plain reference
(``perfbench/reference``) from the same inputs, and two numbers that
compare the two, each held to its limit in ``perfbench/limits/<cell>.json``.

The numbers, over the sampled reads that either side re-squiggled (a
read both sides fail agrees and is left out):
  ``boundary_mismatch``: the share of base boundaries (raw-signal
  positions) that differ; a read whose table length differs, or that
  one side fails, counts all of its boundaries;
  ``reads_off``: the share of reads held apart, each on its own: one
  side fails it, or its scale gap (the larger of the shift's and the
  scale's gap, over the reference's scale) passes ``SCALE_BAR``, or its
  signal matching score's gap passes ``SCORE_BAR``.
A fault on a part of the reads moves ``reads_off`` by that part.  A
sample with no read re-squiggled on either side reads 1 on each.
"""
from __future__ import annotations

import concurrent.futures
import multiprocessing
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

NUMBERS = ("boundary_mismatch", "reads_off")
# a gap no read counts above, and the gap of a read one side fails
MAX_GAP = 1.0
# a read's gaps past which it is off, set from the gaps of each sampled
# read of the program (at most 0.0015 and 0.022 over 2,304 reads) and of
# the reads whose rescaling was left unchanged (at least 0.028): PERF.md
SCALE_BAR = 0.01
SCORE_BAR = 0.05


def reference_jobs(pool, picks, cfg: dict, rna: bool, precision: str):
    """One reference job a sampled read: its raw signal as the sequencer
    gave it, its simulated span on the reference, the model file and the
    configuration's parameters."""
    out = []
    for i in picks:
        r = pool.reads[i]
        out.append((r.raw, pool.ref, r.strand, r.start, r.end,
                    cfg["model_file"], cfg["parameters"], rna, precision))
    return out


def run_reference(jobs, workers: Optional[int] = None):
    """Each job through ``reference.resquiggle.resquiggle_job`` in spawned
    worker processes (numpy only: they import no torch and no program),
    all of which have ended when this returns."""
    from perfbench.reference.resquiggle import resquiggle_job
    if workers is None:
        workers = max(1, min(6, (os.cpu_count() or 2) - 2, len(jobs)))
    if workers <= 1 or len(jobs) <= 1:
        return [resquiggle_job(j) for j in jobs]
    order = sorted(range(len(jobs)), key=lambda k: -jobs[k][0].shape[0])
    out = [None] * len(jobs)
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(workers, mp_context=ctx) as ex:
        futs = {ex.submit(resquiggle_job, jobs[k]): k for k in order}
        for f in concurrent.futures.as_completed(futs):
            out[futs[f]] = f.result()
    return out


def _ref_fields(res) -> Optional[dict]:
    if res is None:
        return None
    return {"start": res.start, "segs": np.asarray(res.segs, np.int64),
            "shift": res.shift, "scale": res.scale, "score": res.score}


def read_gaps(got: List[Optional[dict]], want: List[Optional[dict]]
              ) -> List[Tuple[int, int, float, float]]:
    """Each sampled read that either side re-squiggled: its boundaries,
    how many of them differ, its scale gap and its score gap."""
    out = []
    for g, w in zip(got, want):
        if g is None and w is None:
            continue
        if g is None or w is None:
            n = (g or w)["segs"].shape[0]
            out.append((n, n, MAX_GAP, MAX_GAP))
            continue
        gp, wp = g["start"] + g["segs"], w["start"] + w["segs"]
        if gp.shape != wp.shape:
            n = max(gp.shape[0], wp.shape[0])
            n_diff = n
        else:
            n = gp.shape[0]
            n_diff = int(np.count_nonzero(gp != wp))
        sc = abs(w["scale"])
        out.append((n, n_diff,
                    min(MAX_GAP, max(abs(g["shift"] - w["shift"]),
                                     abs(g["scale"] - w["scale"])) / sc),
                    min(MAX_GAP, abs(g["score"] - w["score"]))))
    return out


def compare(got: List[Optional[dict]], want: List[Optional[dict]]
            ) -> Dict[str, float]:
    """The numbers of ``got`` (the program's fields, or None for a read
    without a result) against ``want`` (the reference's)."""
    gaps = read_gaps(got, want)
    if not gaps:
        # nothing re-squiggled on either side: nothing shown correct
        return {k: MAX_GAP for k in NUMBERS}
    n_off = sum(1 for _, _, sg, cg in gaps
                if sg > SCALE_BAR or cg > SCORE_BAR)
    return {"boundary_mismatch": (sum(g[1] for g in gaps) /
                                  sum(g[0] for g in gaps)),
            "reads_off": n_off / len(gaps)}


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, dict]]:
    """Each number beside its limit; correct only where every number is at
    or under its limit (a number without a limit fails)."""
    checks, ok = {}, True
    for k in NUMBERS:
        lim = limits.get(k)
        checks[k] = {"value": numbers[k], "limit": lim}
        if lim is None or not numbers[k] <= lim:
            ok = False
    return ok, checks


def reference_fields(results) -> List[Optional[dict]]:
    return [_ref_fields(res) for res, _err in results]
