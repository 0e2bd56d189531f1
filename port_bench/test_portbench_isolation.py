"""Nothing the benchmark runs loads ``jax``, ``jaxlib``, ``flax``, the
JAX package ``repro``, ``benchmarks`` or ``chip_smoke`` (compared by the
first dotted component of a module's name, whole: the port's
``repro_torch`` begins with ``repro``), and the references import
nothing of the program."""
import ast
import subprocess
import sys

import pytest

from port_bench import harness

FILES = sorted(p for p in harness.BENCH_DIR.rglob("*.py")
               if "__pycache__" not in p.parts)
REFS = [p for p in FILES if p.parent.name == "refs"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_no_forbidden_import(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & set(harness.FORBIDDEN), (path, tops)


@pytest.mark.parametrize("path", REFS, ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert tops <= {"__future__", "math", "typing", "numpy", "torch"}, tops


def test_a_run_loads_no_forbidden_module():
    code = (
        "import sys; sys.path[:0] = ['src', '.']\n"
        "from port_bench import harness, tiny\n"
        "ref = harness.load_module('refs/dense_lm.py')\n"
        "harness.load_module('refs/cg.py')\n"
        "assert not [m for m in sys.modules if m.split('.')[0] == "
        "'repro_torch'], 'a reference loaded the program'\n"
        "for c in ('granite-3-2b.train-elastic', 'cg-32768.static'):\n"
        "    out = tiny.cpu_run(tiny.tiny_cell(c), 5, seconds=0.05)\n"
        "print(harness.forbidden_modules())\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_compare_whole():
    assert harness.forbidden_modules(
        ["repro_torch", "repro_torch.dmr", "jaxtyping", "benchmarks_x"]) == []
    assert harness.forbidden_modules(
        ["repro.dmr", "jax.numpy", "chip_smoke"]) == ["chip_smoke", "jax",
                                                      "repro"]
