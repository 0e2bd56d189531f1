"""Parameter schemas (port of ``repro/models/params.py``).

A model is a nested dict of ``ParamDef`` leaves (the *schema*).  From it the
port derives the concrete parameter tree (``init``, from an explicit
``torch.Generator`` on an explicit device) and its size (``param_count`` /
``param_bytes``).  Layer stacks are ``stack(schema, n)``: a leading
"layers" axis that the model indexes per layer.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

from repro_torch import tree as T

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "int32": torch.int32}


def torch_dtype(name) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (dtype objects pass through)."""
    return name if isinstance(name, torch.dtype) else DTYPES[str(name)]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Any, ...]          # logical axis names (None => unsharded axis)
    dtype: str = "float32"
    init: str = "normal"           # normal | zeros | ones | scaled_normal | small_a_log
    scale: float = 0.02

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def _init_leaf(d: ParamDef, gen: torch.Generator, device) -> torch.Tensor:
    dt = torch_dtype(d.dtype)
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dt, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dt, device=device)
    if d.init == "small_a_log":    # mamba2 A_log in [log 1, log 16]
        u = torch.rand(d.shape, generator=gen, dtype=torch.float32,
                       device=device) * 15.0 + 1.0
        return torch.log(u).to(dt)
    x = torch.randn(d.shape, generator=gen, dtype=torch.float32, device=device)
    return (x * d.scale).to(dt)


def init(schema, gen: torch.Generator, device="cpu"):
    """Concrete parameters, leaf by leaf in flatten order from one generator
    (the generator must live on ``device``).  Follows the schema's shapes,
    dtypes, init kinds and scales; the numbers differ from ``jax.random``'s,
    so parity tests load JAX-initialised weights instead (``interop``)."""
    flat = T.flatten(schema)
    return T.unflatten(schema, [_init_leaf(d, gen, device) for _, d in flat])


def stack(schema, n: int, axis_name: Any = "layers"):
    """Prepend a layer axis of size ``n`` to every leaf."""
    return T.tree_map(
        lambda d: dataclasses.replace(d, shape=(n,) + d.shape,
                                      axes=(axis_name,) + d.axes), schema)


def param_count(schema) -> int:
    return int(sum(np.prod(d.shape) for d in T.leaves(schema)))


def param_bytes(schema) -> int:
    return int(sum(np.prod(d.shape) * torch_dtype(d.dtype).itemsize
                   for d in T.leaves(schema)))
