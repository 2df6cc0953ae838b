"""Time the port's batched re-squiggle on the 1 kb, mixed and RNA paths of
``chip_smoke.py`` on one CUDA card, for this checkout or another one.

    python3 scripts/time_paths.py [--tree DIR] [--paths 1kb,mixed,rna]
        [--batches 2] [--reads-cache DIR] [--save FILE] [--against FILE]
        [--lanes]

The reads are ``chip_smoke.py``'s recipes and seeds (``build_reads``,
``mixed_lens``, ``build_rna_reads``): a warm-up batch of 512 and
``--batches`` timed batches a path.  Per path it prints one JSON line:
the card's name and power limit, the tree, reads/s of the timed batches
through ``resquiggle_batches`` (pipeline depth 3, as ``chip_smoke.py``'s
``run_path``) and of one batch after them with a ``StageProfile``, whose
seconds by key, six stages' share of that batch's wall and MB up and down
it also prints, with a SHA-256 digest of every timed and profiled
read's outcome (error, segment table, start, scale values, score and
whether the scale changed).  ``--tree DIR`` imports ``tombo_tpu_torch``
from another checkout (the parent commit unpacked under ``build/``), so
two versions run in turns on one card in one chip call, one process
each; ``--save FILE`` writes the lines to FILE and ``--against FILE``
adds to each line whether its digest equals the one FILE holds for the
path (bitwise the same results).
``--reads-cache DIR`` keeps the mapped reads of each path in DIR as
pickles, so later processes load the same reads instead of mapping them
again (the package's types pickle by module name, which both trees
share).

``--lanes`` times the finalize lanes instead (``chip_smoke.py``'s
``LANES``, ``pipeline/batch.py::FinalizeLanes``): after the warm-up
batch, the first timed batch of a path runs through the default lane and
each other lane, each time in a fresh resquiggler with a ``StageProfile``,
in turns (default, the lanes, then the same in reverse order).  One JSON
line a path gives each lane's reads/s of both runs and their ratio to the
default lane's, its seconds by key (the mean of the two runs), the reads
each lane took (read-passes: a read counts once a scaling pass), the
share of reads with a deletion that the device finalize saw, MB up and
down, and a SHA-256 digest of its results, whether the two runs'
digests are equal and, with ``--against``, whether it equals the one
FILE holds for the same path and lane.
"""
import argparse
import hashlib
import importlib.util
import json
import os
import pickle
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEVICE = "cuda"
STAGES = ("segment", "plan", "start", "adaptive", "static", "finalize")


def recipes():
    """``chip_smoke.py`` of this checkout, loaded by file (its package
    imports are inside its functions, so they see ``--tree``'s)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_recipes", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def path_reads(cs, name, n_batches, cache):
    """(model, params, sst, maps) of one path, 512 * (n_batches + 1)
    reads, the first 512 the warm-up batch."""
    fn = (os.path.join(cache, "%s_%d.pkl" % (name, n_batches))
          if cache else None)
    if fn and os.path.exists(fn):
        with open(fn, "rb") as f:
            return pickle.load(f)
    n = cs.BATCH * (n_batches + 1)
    if name == "1kb":
        out = cs.build_reads([cs.READ_LEN] * n, 1234, cs.REF_LEN_1KB,
                             "smoke_")[:4]
    elif name == "mixed":
        out = cs.build_reads(cs.mixed_lens(n, 4321), 4321,
                             cs.MIXED_REF_LEN, "mixed_")[:4]
    elif name == "rna":
        out = cs.build_rna_reads(n, 2468, cs.RNA_REF_LEN)[:4]
    else:
        raise SystemExit("unknown path %r" % name)
    if fn:
        os.makedirs(cache, exist_ok=True)
        with open(fn, "wb") as f:
            pickle.dump(out, f)
    return out


def digest(outs):
    """SHA-256 of the outcomes of batches of (result, error) pairs."""
    import numpy as np
    h = hashlib.sha256()
    for out in outs:
        for res, err in out:
            h.update(repr(err).encode())
            if res is None:
                continue
            sv = res.scale_values
            h.update(np.ascontiguousarray(res.segs, np.int64).tobytes())
            h.update(repr((res.read_start_rel_to_raw, sv.shift, sv.scale,
                           sv.lower_lim, sv.upper_lim, res.sig_match_score,
                           res.norm_params_changed)).encode())
    return h.hexdigest()


def time_path(cs, name, n_batches, cache, smi, tree):
    import torch
    from tombo_tpu_torch import config
    from tombo_tpu_torch.pipeline import batch as batch_mod
    model, params, sst, maps = path_reads(cs, name, n_batches, cache)
    B = cs.BATCH
    warm, batches = maps[:B], [maps[(b + 1) * B:(b + 2) * B]
                               for b in range(n_batches)]
    br = batch_mod.BatchedResquiggler(model, params, sst,
                                      config.OUTLIER_THRESH, device=DEVICE)
    br.resquiggle_batch(warm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = list(br.resquiggle_batches(batches, pipeline_depth=3))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_ok = sum(r is not None for o in outs for r, _ in o)
    prof = batch_mod.StageProfile()
    br.profile = prof
    t0 = time.perf_counter()
    one = br.resquiggle_batch(batches[0])
    torch.cuda.synchronize()
    one_wall = time.perf_counter() - t0
    br.profile = None
    line = {
        "path": name, "tree": tree, "card": smi, "reads": n_ok,
        "results_sha256": digest(outs + [one]),
        "reads_per_s": n_ok / wall,
        "profiled_batch": {
            "wall_s": one_wall,
            "reads_per_s": sum(r is not None for r, _ in one) / one_wall,
            "six_stages_share": sum(prof.timings.get(k, 0.0)
                                    for k in STAGES) / one_wall,
            "s": dict(sorted(prof.timings.items())),
            "stage_keys": sorted(prof.timings),
            "mb_up": prof.transfer_bytes.get("upload", 0) / 2 ** 20,
            "mb_down": prof.transfer_bytes.get("fetch", 0) / 2 ** 20}}
    return line


def time_lanes(cs, name, n_batches, cache, smi, tree):
    import statistics
    import torch
    from tombo_tpu_torch import config
    from tombo_tpu_torch.pipeline import batch as batch_mod
    model, params, sst, maps = path_reads(cs, name, n_batches, cache)
    B = cs.BATCH
    warm, batch = maps[:B], maps[B:2 * B]
    batch_mod.BatchedResquiggler(model, params, sst, config.OUTLIER_THRESH,
                                 device=DEVICE).resquiggle_batch(warm)
    torch.cuda.synchronize()
    lanes = [("default", {})] + cs.LANES
    runs = {lane: [] for lane, _ in lanes}
    for lane, kw in lanes + lanes[::-1]:
        prof = batch_mod.StageProfile()
        br = batch_mod.BatchedResquiggler(
            model, params, sst, config.OUTLIER_THRESH, device=DEVICE,
            profile=prof, lanes=batch_mod.FinalizeLanes(**kw))
        with cs.lane_counts() as n:
            t0 = time.perf_counter()
            out = br.resquiggle_batch(batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        runs[lane].append((wall, out, prof, dict(n)))
    base = statistics.mean(
        sum(r is not None for r, _ in out) / w for w, out, _, _ in
        runs["default"])
    entries = []
    for lane, _ in lanes:
        rps = [sum(r is not None for r, _ in out) / w
               for w, out, _, _ in runs[lane]]
        profs = [p for _, _, p, _ in runs[lane]]
        n = runs[lane][0][3]
        keys = sorted(set().union(*(p.timings for p in profs)))
        digests = [digest([out]) for _, out, _, _ in runs[lane]]
        entries.append({
            "lane": lane, "reads_per_s": rps,
            "ratio_to_default": statistics.mean(rps) / base,
            "s": {k: statistics.mean(p.timings.get(k, 0.0) for p in profs)
                  for k in keys},
            "reads_by_lane": {k: v for k, v in n.items()
                              if not k.startswith("has_del")},
            "has_del_share": (n["has_del"] / n["has_del_seen"]
                              if n["has_del_seen"] else None),
            "mb_up": profs[0].transfer_bytes.get("upload", 0) / 2 ** 20,
            "mb_down": profs[0].transfer_bytes.get("fetch", 0) / 2 ** 20,
            "results_sha256": digests[0],
            "repeat_bitwise": digests[0] == digests[1]})
    return {"path": name, "tree": tree, "card": smi, "batch_reads": B,
            "lanes": entries}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--paths", default="1kb,mixed,rna")
    ap.add_argument("--batches", type=int, default=2)
    ap.add_argument("--reads-cache", default=None)
    ap.add_argument("--save", default=None)
    ap.add_argument("--against", default=None)
    ap.add_argument("--lanes", action="store_true")
    a = ap.parse_args()
    tree = os.path.abspath(a.tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    import tombo_tpu_torch
    if os.path.dirname(os.path.dirname(
            os.path.abspath(tombo_tpu_torch.__file__))) != tree:
        raise SystemExit("tombo_tpu_torch not imported from %s" % tree)
    from tombo_tpu_torch import kernels, native
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    kernels.build()
    native.get_native_lib()
    cs = recipes()
    against = {}
    if a.against:
        with open(a.against) as f:
            against = {ln["path"]: ln for ln in json.load(f)}
    lines = []
    for name in a.paths.split(","):
        if a.lanes:
            line = time_lanes(cs, name, a.batches, a.reads_cache, smi,
                              os.path.relpath(tree, ROOT))
            if name in against:
                want = {e["lane"]: e["results_sha256"]
                        for e in against[name].get("lanes", [])}
                for e in line["lanes"]:
                    if e["lane"] in want:
                        e["bitwise_against"] = (e["results_sha256"] ==
                                                want[e["lane"]])
            print(json.dumps(line), flush=True)
            lines.append(line)
            continue
        line = time_path(cs, name, a.batches, a.reads_cache, smi,
                         os.path.relpath(tree, ROOT))
        if name in against:
            line["against"] = against[name]["tree"]
            line["bitwise_against"] = (line["results_sha256"] ==
                                       against[name]["results_sha256"])
        print(json.dumps(line), flush=True)
        lines.append(line)
    if a.save:
        with open(a.save, "w") as f:
            json.dump(lines, f)


if __name__ == "__main__":
    main()
