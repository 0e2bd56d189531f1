"""Build and load the port's CUDA kernels (nvcc + ctypes).

Each source in ``kernels/csrc/`` is compiled on first use into its own
shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/lib<name>-<hash>.so <name>.cu

All sources compile in parallel (one ``nvcc`` each).  Libraries land in
``build/kernels/`` at the root of the checkout, named by a hash of their
source and of the headers under ``csrc/`` (``*.cuh``) that the sources
share, so an edited source or header is rebuilt and an unchanged one is
reused.
``ptxas``'s register and shared-memory report is kept beside each library
(``<lib>.log``).  Importing this module builds nothing; CPU-only machines
never call :func:`load`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_p, _i, _ll, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

#: source name -> {C function: argtypes}; each returns a cudaError_t unless
#: RESTYPES names it
SIGNATURES = {
    "flash_attention": {
        "flash_attention_fwd": [_p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i,
                                _i, _i, _ll, _ll, _ll, _ll, _ll, _ll, _ll,
                                _ll, _ll, _ll, _ll, _ll, _i, _i, _i, _f, _p,
                                _p, _i, _p, _p],
    },
    # its own source, so that it builds in parallel with K1's 25 kernels
    "flash_attention_bwd": {
        "flash_attention_bwd": [_p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _i,
                                _i, _i, _i, _i, _i, _i, _i,
                                ctypes.POINTER(_ll), _i, _i, _f, _p],
    },
    "blockcyclic": {
        "blockcyclic_repack": [_p, _p, _p, _ll, _ll, _i, _p],
    },
    "ssd_scan": {
        "ssd_scan_fwd": [_p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i,
                         _i, _ll, _ll, _ll, _ll, _ll, _ll, _ll, _ll, _ll,
                         _ll, _ll, _ll, _ll, _p],
    },
    "ssd_scan_bwd": {
        "ssd_scan_bwd": [_p] * 10 + [_ll] + [_i] * 8 + [_ll] * 13 + [_p],
        "ssd_scan_bwd_workspace_floats": [_i] * 7,
    },
}
#: the functions that return something else than a cudaError_t
RESTYPES = {"ssd_scan_bwd_workspace_floats": _ll}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: seconds the last :func:`load` that compiled anything spent in nvcc
last_build_s = 0.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels (set PATH to include its bin/)")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + headers +
                          " ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _bind(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = RESTYPES.get(fn, ctypes.c_int)
    return lib


def load() -> Dict[str, ctypes.CDLL]:
    """Compile (in parallel) whatever is not built yet and load every
    kernel library.  Raises with nvcc's output if a build fails."""
    global last_build_s
    with _LOCK:
        if len(_LIBS) == len(SIGNATURES):
            return _LIBS
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        todo = {n: _lib_path(n) for n in SIGNATURES if n not in _LIBS}
        t0 = time.perf_counter()
        procs = {}
        for name, path in todo.items():
            if path.exists():
                continue
            tmp = path.with_suffix(f".tmp{os.getpid()}.so")
            cmd = [_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, path)
        failed = []
        for name, (proc, tmp, path) in procs.items():
            out, _ = proc.communicate()
            path.with_suffix(".log").write_text(out)
            if proc.returncode != 0:
                failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{out}")
            else:
                os.replace(tmp, path)
        if procs:
            last_build_s = time.perf_counter() - t0
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        for name, path in todo.items():
            _LIBS[name] = _bind(name, path)
        return _LIBS


def build_log(name: str) -> str:
    """ptxas's report (registers, shared memory, spills) for one source."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
