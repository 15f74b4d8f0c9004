"""Import guard: no module of the benchmark imports jax or the JAX
package, and the reference imports nothing of the system under test
(top-level names compared whole)."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "interpolate_unstructured_tpu"}
PORT = "interpolate_unstructured_tpu_torch"


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


MODULES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(
    BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


# the yardstick's references and the meshes both sides are handed
YARDSTICK = sorted([*(BENCH / "reference").rglob("*.py"),
                    *(BENCH / "meshes").glob("*.py"), BENCH / "mesh.py"])


@pytest.mark.parametrize("path", YARDSTICK, ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert PORT not in top_level_imports(path)
    assert not top_level_imports(path) & FORBIDDEN


def test_guard_compares_whole_names():
    from iubench import harness

    assert "interpolate_unstructured_tpu" in harness.FORBIDDEN
    assert PORT not in harness.FORBIDDEN
    assert PORT.startswith("interpolate_unstructured_tpu")


def test_a_run_loads_no_jax():
    """A small run on the CPU leaves neither jax nor the JAX package in
    ``sys.modules`` (in a fresh process: the test process itself may
    have them)."""
    import subprocess
    import sys

    code = (
        "import sys, time; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "from conftest import shrink\n"
        "from iubench import harness\n"
        "import interpolate_unstructured_tpu_torch as tiu\n"
        "spec = shrink(harness.find_spec('tet998k_f32.cold'))\n"
        "out = harness.run_cell(spec, 3, 0.2, False, 'cpu', "
        "time.perf_counter(), tiu)\n"
        "assert out['correct'], out['checks']\n"
        "print(harness.forbidden_modules())\n"
    ) % (str(BENCH.parent), str(BENCH / "tests"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"
