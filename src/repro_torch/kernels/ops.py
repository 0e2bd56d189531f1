"""Public kernel surface of the port: dispatch, build and launch counts.

``flash_attention`` and ``repack`` run their plain PyTorch version on CPU
tensors and their CUDA kernel on tensors on a card; a build or launch
failure raises.  ``launch_counts`` / ``reset_counts`` read and zero the
per-wrapper counters that show a run really went through the kernels.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels import _build
from repro_torch.kernels.blockcyclic import repack
from repro_torch.kernels.flash_attention import flash_attention

KERNELS = {"flash_attention": flash_attention, "repack": repack}


def build():
    """Compile and load every kernel now (otherwise: at first launch)."""
    return _build.load()


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = ["flash_attention", "repack", "build", "launch_counts",
           "reset_counts", "KERNELS"]
