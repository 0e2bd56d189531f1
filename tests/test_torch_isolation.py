"""The PyTorch port stands alone: importing every ``repro_torch`` module
loads neither JAX nor any module of the JAX package, needs no CUDA, nvcc or
triton, and builds no kernel; ``chip_smoke.py`` imports neither either, and
fails without a card."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "triton"))
assert not bad, bad
from repro_torch.kernels import _build
assert not _build._LIBS, "importing the port loaded a kernel library"
print("MODULES", " ".join(names))
print("ISOLATED", len(names))
"""

#: modules the walk must reach (the examples and the linter are imported
#: like every other module: importing one runs no example)
MUST_IMPORT = ["repro_torch.examples", "repro_torch.examples.quickstart",
               "repro_torch.examples.cg_solver", "repro_torch.examples.jacobi",
               "repro_torch.examples.nbody",
               "repro_torch.examples.aligner_pipeline",
               "repro_torch.analysis.lint", "repro_torch.analysis.__main__"]


def test_port_imports_no_jax_and_no_repro():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["PATH"] = "/usr/bin:/bin"          # no nvcc on the path either
    proc = subprocess.run([sys.executable, "-c", SCRIPT], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    n = int(proc.stdout.split("ISOLATED")[1])
    assert n >= 89, proc.stdout                  # every module was imported
    walked = proc.stdout.split("MODULES")[1].split("\n")[0].split()
    assert not set(MUST_IMPORT) - set(walked), walked


def test_chip_smoke_imports_no_jax_and_no_repro():
    """``chip_smoke.py`` drives the port alone: none of its imports names
    JAX or the JAX package."""
    import ast
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    bad = [m for m in names if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
    assert "repro_torch.kernels" in names


def test_chip_smoke_fails_without_a_card_or_a_checkout(tmp_path):
    """Without a CUDA card, and alone in a directory, the script exits
    non-zero and prints no result line."""
    import shutil
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    for script in (os.path.join(REPO, "chip_smoke.py"), str(alone)):
        proc = subprocess.run([sys.executable, script], env=env,
                              cwd=os.path.dirname(script),
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout, proc.stdout[-2000:]
