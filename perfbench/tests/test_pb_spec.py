"""BENCHMARK.json against the contract's shape, every name resolving to
its file, and new cells, configurations, traffic and metrics added as
files alone."""
import json
import os
import shutil

import pytest

from perfbench.lib import spec

S = spec.Spec()
D = S.data
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_limits():
    assert set(D) == KEYS
    assert D["command"] == ["python3", "perfbench/run.py"]
    assert D["paths"] == ["perfbench"]
    assert isinstance(D["run_seconds"], int) and 1 <= D["run_seconds"] <= 51
    assert 1 <= len(D["configs"]) <= 24 and 1 <= len(D["workloads"]) <= 24
    assert 1 <= len(D["end_to_end"]) <= 16 and 1 <= len(D["per_layer"]) <= 128
    assert len(json.dumps(D)) < 64 * 1024


def test_names_units_and_keys():
    names = set()
    for c in D["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert spec.NAME.match(c["name"]) and c["file"].startswith(
            "perfbench/")
    for w in D["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert spec.NAME.match(w["name"]) and spec.NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for m in D["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in D["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in {e["name"] for e in D["end_to_end"]}
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    for m in D["end_to_end"] + D["per_layer"]:
        assert spec.NAME.match(m["name"]) and spec.UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    assert "setup_s" in {m["name"] for m in D["end_to_end"]}


@pytest.mark.parametrize("name", sorted(S.cells))
def test_every_name_resolves(name):
    cell = S.cell(name)
    cfg = S.config(cell)
    assert cfg["name"] == cell["config"]
    assert os.path.exists(os.path.join(S.bench_dir, "reference", "models",
                                       cfg["model_file"]))
    assert S.traffic(cell)["batch"] > 0
    assert set(S.limits(cell)) == {"boundary_mismatch", "reads_off"}
    assert S.per_layer(cell)
    for m in S.per_layer(cell):
        assert callable(S.reader(m["name"]))


def test_every_config_is_used_and_reduced_is_listed():
    used = {w["config"] for w in D["workloads"]}
    for c in D["configs"]:
        assert c["name"] in used
        with open(os.path.join(S.root, c["file"])) as f:
            body = json.load(f)
        assert body["reduced"] == c["reduced"]


def test_new_cell_config_traffic_metric_are_files_alone(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(os.path.join(S.root, "BENCHMARK.json"), root)
    shutil.copytree(S.bench_dir, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    pb = root / "perfbench"
    cfg = json.loads((pb / "configs" / "dna-r9.4.1.json").read_text())
    cfg["name"] = "dna-r9.4.1-wide"
    cfg["parameters"]["bandwidth"] = 500
    (pb / "configs" / "dna-r9.4.1-wide.json").write_text(json.dumps(cfg))
    tr = json.loads((pb / "traffic" / "amplicon-1kb.json").read_text())
    tr["lengths"] = {"fixed": 2000}
    (pb / "traffic" / "amplicon-2kb.json").write_text(json.dumps(tr))
    (pb / "limits" / "dna-wide-amplicon-2kb.json").write_text(json.dumps(
        {"limits": {"boundary_mismatch": 0, "reads_off": 0}}))
    (pb / "metrics" / "reads_seen.py").write_text(
        "def read(ctx):\n    return ctx.reads or None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dna-r9.4.1-wide", "source": "x",
                             "file": "perfbench/configs/dna-r9.4.1-wide.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "dna-wide-amplicon-2kb",
                               "config": "dna-r9.4.1-wide",
                               "traffic": "amplicon-2kb", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "reads_seen", "unit": "reads",
                               "better": "higher", "source": "program_span",
                               "layer": "x", "moves": "bases_per_s",
                               "workloads": ["dna-wide-amplicon-2kb"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for p, b in before.items():
        if p.name != "BENCHMARK.json":
            assert p.read_bytes() == b
    s = spec.Spec(str(root))
    cell = s.cell("dna-wide-amplicon-2kb")
    assert s.config(cell)["parameters"]["bandwidth"] == 500
    assert s.traffic(cell)["lengths"] == {"fixed": 2000}
    assert s.limits(cell)["reads_off"] == 0
    names = [m["name"] for m in s.per_layer(cell)]
    assert names == ["reads_seen"]

    class Ctx:
        reads = 7
    assert s.reader("reads_seen")(Ctx()) == 7


@pytest.mark.parametrize("name", sorted(S.cells))
def test_every_cell_reports_setup_and_what_its_layers_move(name):
    cell = S.cell(name)
    names = [m["name"] for m in S.end_to_end(cell)]
    assert "setup_s" in names and len(names) >= 2
    assert {n.split(".")[0] for n in names} <= {"bases_per_s",
                                                "device_peak_gib", "setup_s"}
    assert all(m["moves"] in names for m in S.per_layer(cell))
