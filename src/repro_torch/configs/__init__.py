"""Config registry of the port: every architecture of the JAX package (the
dense family's granite, phi4-mini, qwen2.5 and internlm2, the MoE family's
mixtral and qwen3-moe, the SSM and the hybrid families, the
encoder-decoder seamless-m4t and the vision-prefix pixtral), plus their
reduced ``-smoke`` variants."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (SHAPES, SHAPES_BY_NAME, SMOKE_DECODE,
                                     SMOKE_PREFILL, SMOKE_SHAPE, ArchConfig,
                                     ShapeConfig, phys_vocab, reduced,
                                     shape_applicable)

_ARCH_MODULES = {
    "granite-3-2b": "granite_3_2b",
    "mamba2-370m": "mamba2_370m",
    "zamba2-2.7b": "zamba2_2_7b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "qwen2.5-32b": "qwen2_5_32b",
    "internlm2-20b": "internlm2_20b",
    "mixtral-8x7b": "mixtral_8x7b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "pixtral-12b": "pixtral_12b",
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


def all_configs() -> Dict[str, ArchConfig]:
    """Every architecture's full config, by name."""
    return {n: get_config(n) for n in _ARCH_MODULES}


def get_shape(name: str) -> ShapeConfig:
    """A named input shape (``train_4k``, ..., or a smoke shape)."""
    if name in SHAPES_BY_NAME:
        return SHAPES_BY_NAME[name]
    for s in (SMOKE_SHAPE, SMOKE_PREFILL, SMOKE_DECODE):
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}")


def live_cells():
    """All (arch, shape) dry-run cells with applicability verdicts."""
    out = []
    for an, cfg in all_configs().items():
        for shp in SHAPES:
            ok, why = shape_applicable(cfg, shp)
            out.append((an, shp.name, ok, why))
    return out


__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "phys_vocab", "reduced",
           "shape_applicable", "list_archs", "get_config", "all_configs",
           "get_shape", "live_cells"]
