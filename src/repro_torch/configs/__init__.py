"""Config registry of the port: the architectures it runs so far (the
dense family's granite, phi4-mini, qwen2.5 and internlm2, the SSM and the
hybrid families), plus their reduced ``-smoke`` variants."""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import (SHAPES_BY_NAME, SMOKE_DECODE,
                                     SMOKE_PREFILL, SMOKE_SHAPE, ArchConfig,
                                     ShapeConfig, phys_vocab, reduced)

_ARCH_MODULES = {
    "granite-3-2b": "granite_3_2b",
    "mamba2-370m": "mamba2_370m",
    "zamba2-2.7b": "zamba2_2_7b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "qwen2.5-32b": "qwen2_5_32b",
    "internlm2-20b": "internlm2_20b",
}


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def get_config(name: str) -> ArchConfig:
    """Look up an architecture config by id; ``<id>-smoke`` gives the reduced one."""
    if name.endswith("-smoke"):
        return reduced(get_config(name[: -len("-smoke")]))
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.CONFIG


def get_shape(name: str) -> ShapeConfig:
    """A named input shape (``train_4k``, ..., or a smoke shape)."""
    if name in SHAPES_BY_NAME:
        return SHAPES_BY_NAME[name]
    for s in (SMOKE_SHAPE, SMOKE_PREFILL, SMOKE_DECODE):
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}")


__all__ = ["ArchConfig", "ShapeConfig", "phys_vocab", "reduced",
           "list_archs", "get_config", "get_shape"]
