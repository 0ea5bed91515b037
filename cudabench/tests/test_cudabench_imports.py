"""No module that a run loads is JAX or the JAX package, compared by whole top-level names, and
the reference imports nothing of the program."""

import ast
import json
import subprocess
import sys

from cudabench import harness

PROBE = r"""
import json, sys, runpy
sys.argv = ["run.py"]
sys.path.insert(0, ROOT)
from cudabench import harness
from conftest import tiny_spec
spec = tiny_spec()
harness.run_cell(spec, 5, 0.1, True, "cpu")
for name in json.loads(open(ROOT + "/BENCHMARK.json").read())["per_layer"]:
    harness.load_module("metrics", name["name"])
print(json.dumps(sorted(sys.modules)))
"""


def test_a_run_loads_no_jax():
    code = PROBE.replace("ROOT", repr(str(harness.ROOT)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(harness.HERE / "tests"), timeout=600,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(harness.ROOT),
                              "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-3000:]
    modules = json.loads(out.stdout.strip().splitlines()[-1])
    tops = {m.split(".")[0] for m in modules}
    assert not tops & set(harness.FORBIDDEN)
    assert harness.PORT in tops  # the program ran: the check is no empty pass
    assert "optimalstrategiesagainstgenerativeattacks_tpu" not in tops


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_like_name", sys)
    assert "jaxtyping_like_name" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax.numpy" in harness.forbidden_modules()


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_reference_imports_nothing_of_the_program():
    files = list((harness.HERE / "reference").glob("*.py"))
    assert files
    for path in files:
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & {harness.PORT, *harness.FORBIDDEN}, path


def test_harness_sources_import_no_jax():
    for path in harness.HERE.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & set(harness.FORBIDDEN), path
