"""Config registry of the port: the dense architectures it runs so far,
plus their reduced ``-smoke`` variants."""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import ArchConfig, ShapeConfig, phys_vocab, reduced

_ARCH_MODULES = {
    "granite-3-2b": "granite_3_2b",
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


__all__ = ["ArchConfig", "ShapeConfig", "phys_vocab", "reduced",
           "list_archs", "get_config"]
