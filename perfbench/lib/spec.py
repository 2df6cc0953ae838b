"""``BENCHMARK.json`` and the files its names lead to.

Everything that belongs to one configuration, one traffic mix, one cell's
limits or one per-layer metric is a file of its own, found by name:
  a configuration: the ``file`` its entry names (``perfbench/configs/``);
  a traffic mix: ``perfbench/traffic/<traffic>.json``;
  a cell's limits of the check: ``perfbench/limits/<cell>.json``;
  a per-layer metric: ``perfbench/metrics/<metric>.py``, whose
  ``read(ctx)`` returns the number or None.
A new configuration, mix, cell or metric is new files and new entries;
no file that is there needs an edit."""
from __future__ import annotations

import importlib.util
import json
import os
import re
from typing import Callable, Dict, Optional

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


class Spec:
    def __init__(self, root: str = ROOT):
        self.root = root
        self.bench_dir = os.path.join(root, "perfbench")
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.data = json.load(f)
        self.configs = {c["name"]: c for c in self.data["configs"]}
        self.cells = {w["name"]: w for w in self.data["workloads"]}

    def cell(self, name: str) -> dict:
        if name not in self.cells:
            raise KeyError("no workload %r in BENCHMARK.json" % name)
        return self.cells[name]

    def config(self, cell: dict) -> dict:
        entry = self.configs[cell["config"]]
        with open(os.path.join(self.root, entry["file"])) as f:
            return json.load(f)

    def traffic(self, cell: dict) -> dict:
        with open(os.path.join(self.bench_dir, "traffic",
                               cell["traffic"] + ".json")) as f:
            return json.load(f)

    def limits(self, cell: dict) -> Dict[str, float]:
        path = os.path.join(self.bench_dir, "limits", cell["name"] + ".json")
        if not os.path.exists(path):
            return {}
        with open(path) as f:
            return json.load(f)["limits"]

    def end_to_end(self, cell: dict) -> list:
        return [m for m in self.data["end_to_end"]
                if cell["name"] in m.get("workloads", [cell["name"]])]

    def per_layer(self, cell: dict) -> list:
        """The per-layer metrics this cell reports: those that list it, and
        those without a list whose end-to-end metric it reports."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.data["per_layer"]
                if (cell["name"] in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]

    def reader(self, metric: str) -> Callable:
        path = os.path.join(self.bench_dir, "metrics", metric + ".py")
        spec = importlib.util.spec_from_file_location(
            "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def read_metric(fn: Callable, ctx) -> Optional[float]:
    v = fn(ctx)
    return None if v is None else float(v)
