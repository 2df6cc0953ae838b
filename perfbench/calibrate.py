"""The readings that a cell's limits of the check are set from.

    python3 perfbench/calibrate.py --workload <cell> --seeds s1,s2,... \
        --seconds <s> [--control-seeds k] [--fault-seeds f] [--gaps FILE]

runs the cell on each seed in one process (a short window at the cell's
own load) and holds the window's sampled reads against the float64
reference.  On the first ``k`` seeds it also runs the reference in
bfloat16 in the program's place (the control), and on the first ``f``
seeds the cell again with the rescaling left unchanged on a third of
each batch (``perfbench/lib/faults.py``).  Prints one JSON line a seed,
then the largest program reading and the smallest control and fault
readings of each number; ``--gaps`` appends each sampled read's gaps, a
JSON line a seed.  Needs the card(s) the cell asks for."""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAULT = "rescaling_unchanged_on_a_third"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--fault-seeds", type=int, default=0)
    ap.add_argument("--gaps")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from perfbench.lib import check, faults, harness, spec
    if not torch.cuda.is_available():
        sys.stderr.write("no CUDA card\n")
        return 2
    s = spec.Spec(ROOT)
    limits = s.limits(s.cell(args.workload))
    seen = {"program": {}, "control": {}, "fault": {}}
    for i, seed in enumerate(int(x) for x in args.seeds.split(",")):
        line = harness.run_cell(
            s, args.workload, seed, args.seconds, False, "cuda",
            control="bfloat16" if i < args.control_seeds else None,
            detail=True)
        out = {"seed": seed, "correct": line["correct"],
               "program": {k: v["value"] for k, v in line["checks"].items()},
               "attempted": line["attempted"], "failed": line["failed"]}
        gaps = dict(line["read_gaps"], seed=seed)
        if line.get("control"):
            out["control"] = line["control"]
            out["control_correct"] = check.judge(line["control"], limits)[0]
        if i < args.fault_seeds:
            undo = faults.plant(FAULT)
            try:
                bad = harness.run_cell(s, args.workload, seed, args.seconds,
                                       False, "cuda", detail=True)
            finally:
                undo()
            out["fault"] = {k: v["value"] for k, v in bad["checks"].items()}
            out["fault_correct"] = bad["correct"]
            gaps["fault"] = bad["read_gaps"]["program"]
        print(json.dumps(out), flush=True)
        if args.gaps:
            with open(args.gaps, "a") as f:
                f.write(json.dumps(gaps) + "\n")
        for kind in seen:
            for k, v in out.get(kind, {}).items():
                seen[kind].setdefault(k, []).append(v)
    print(json.dumps({"program_max": {k: max(v) for k, v in
                                      seen["program"].items()},
                      "control_min": {k: min(v) for k, v in
                                      seen["control"].items()},
                      "fault_min": {k: min(v) for k, v in
                                    seen["fault"].items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
