"""No JAX and no JAX package in a run's process, compared by whole
top-level names; the reference imports nothing of the program."""
import ast
import os
import subprocess
import sys
import types

from perfbench import run
from perfbench.lib import spec

BENCH = spec.Spec().bench_dir


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "tombo_tpu_torch_x", types.ModuleType(
        "tombo_tpu_torch_x"))
    assert "tombo_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tombo_tpu.io", types.ModuleType("x"))
    assert run.forbidden_modules() == ["tombo_tpu"]


def test_a_run_loads_no_jax_and_no_jax_package(tmp_path):
    from tiny import tiny_copy
    root = tiny_copy(str(tmp_path))
    code = (
        "import sys; sys.path.insert(0, %r); sys.path.insert(1, %r)\n"
        "from perfbench import run\n"
        "from perfbench.lib import harness, spec\n"
        "import perfbench.reference.resquiggle\n"
        "assert run.forbidden_modules() == [], run.forbidden_modules()\n"
        "line = harness.run_cell(spec.Spec(%r), 'dna-amplicon-1kb', 5, 0.05,"
        " False, 'cpu', ref_workers=1)\n"
        "assert 'tombo_tpu_torch' in sys.modules\n"
        "print(run.forbidden_modules())\n") % (root, spec.ROOT, root)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _py_files(d):
    for dp, _, fns in os.walk(d):
        for fn in fns:
            if fn.endswith(".py"):
                yield os.path.join(dp, fn)


def test_reference_imports_numpy_and_the_standard_library_only():
    for path in _py_files(os.path.join(BENCH, "reference")):
        for name in _imports(path):
            assert name in ("numpy", "__future__", "dataclasses", "os",
                            "typing"), (path, name)


def test_only_the_program_module_imports_the_program():
    for path in _py_files(BENCH):
        names = set(_imports(path))
        assert not names & {"jax", "jaxlib", "flax", "tombo_tpu"}, path
        if "tombo_tpu_torch" in names:
            assert path.endswith(os.path.join("lib", "program.py")) or \
                "tests" in path, path
