"""Public kernel surface of the port: dispatch, build and launch counts.

``flash_attention`` (with its backward, ``flash_attention_bwd``),
``repack`` and ``ssd_scan`` (with its backward, ``ssd_scan_bwd``) run
their plain PyTorch version on CPU tensors
and their CUDA kernel on tensors on a card; a build or launch failure
raises.  ``launch_counts`` / ``reset_counts`` read and
zero the per-wrapper counters that show a run really went through the
kernels (and each one's ``path_launches``, by path); ``reset_counts``
also zeroes K1's count of its mma kernels
(``flash_attention.mma_kernel_launches``).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels.blockcyclic import repack
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd)
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd

KERNELS = {"flash_attention": flash_attention,
           "flash_attention_bwd": flash_attention_bwd, "repack": repack,
           "ssd_scan": ssd_scan, "ssd_scan_bwd": ssd_scan_bwd}


def build():
    """Compile and load every kernel now (otherwise: at first launch)."""
    return _build.load()


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
        fn.path_launches = dict.fromkeys(fn.path_launches, 0)
    _fa.mma_kernel_launches(reset=True)


__all__ = ["flash_attention", "flash_attention_bwd", "repack", "ssd_scan",
           "ssd_scan_bwd", "build", "launch_counts", "reset_counts",
           "KERNELS"]
