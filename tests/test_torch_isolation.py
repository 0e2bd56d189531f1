"""The PyTorch port stands alone: importing every ``repro_torch`` module
loads neither JAX nor any module of the JAX package, needs no CUDA, nvcc or
triton, and builds no kernel."""
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
print("ISOLATED", len(names))
"""


def test_port_imports_no_jax_and_no_repro():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["PATH"] = "/usr/bin:/bin"          # no nvcc on the path either
    proc = subprocess.run([sys.executable, "-c", SCRIPT], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    n = int(proc.stdout.split("ISOLATED")[1])
    assert n >= 25, proc.stdout                  # every module was imported
