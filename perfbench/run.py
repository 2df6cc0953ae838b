"""Run one cell of the benchmark of the PyTorch and CUDA port once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with the card(s) the cell asks
for.  Prints progress and, as its last lines on standard error, each
number of the correctness check beside its limit; prints the result as
one JSON object, the last line of standard output.  Exits non-zero, with
no result, where no card is there, where the program cannot be imported,
or where a module of JAX or of the JAX package is loaded."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "tombo_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (``tombo_tpu_torch`` is not ``tombo_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch
    from perfbench.lib import harness, spec
    import perfbench.reference.resquiggle  # noqa: F401
    s = spec.Spec(ROOT)
    cell = s.cell(args.workload)
    found = forbidden_modules()
    if found:
        sys.stderr.write("loaded at start: %s\n" % ", ".join(found))
        return 3
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        sys.stderr.write("the cell needs %d CUDA card(s); %d found\n" % (
            int(cell["chips"]), torch.cuda.device_count()
            if torch.cuda.is_available() else 0))
        return 2
    line = harness.run_cell(s, args.workload, args.seed, args.seconds,
                            bool(args.trace), "cuda", T_START)
    found = forbidden_modules()
    if found:
        sys.stderr.write("loaded after the window: %s\n" % ", ".join(found))
        return 3
    for k, c in line["checks"].items():
        sys.stderr.write("check %s %r limit %r\n" % (k, c["value"],
                                                    c["limit"]))
    sys.stdout.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
