"""A copy of the benchmark in a temporary directory whose cells run at a
size a CPU test can hold: each named cell keeps its configuration and
limits, its traffic file is cut to a few short reads."""
import json
import os
import shutil

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

TINY = {"n_reads": 8, "batch": 4, "ref_len": 8000, "warmup_batches": 1,
        "check_reads": 6}
TINY_LEN = {"amplicon-1kb": 400, "ivt-1700": 500, "genomic-mixed": 500}


def tiny_copy(tmp: str) -> str:
    root = os.path.join(tmp, "checkout")
    os.makedirs(root)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "perfbench"),
                    os.path.join(root, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    tdir = os.path.join(root, "perfbench", "traffic")
    for fn in os.listdir(tdir):
        name = fn[:-len(".json")]
        with open(os.path.join(tdir, fn)) as f:
            t = json.load(f)
        t.update(TINY, lengths={"fixed": TINY_LEN.get(name, 400)})
        with open(os.path.join(tdir, fn), "w") as f:
            json.dump(t, f)
    return root
