"""One step's operations and HBM bytes, counted on meta tensors: the port's
counterpart of the JAX package's ``launch/hloanalysis.py``.

The JAX package reads the three roofline terms from the optimized HLO of
a compiled step.  A PyTorch step has no HLO to read; it runs the step once
on ``torch.device("meta")`` (nothing allocated, nothing computed) and
counts what it dispatches:

  * products -- ``torch.utils.flop_counter.FlopCounterMode`` over every
    matmul-like operator, forward and backward (a checkpointed layer's
    recomputation included: it runs again);
  * kernels -- K1 and K3 by the work their kernels do
    (``kernels/meta.py``): K1 over the causal or windowed pairs each head
    visits, forward and backward, K3 over its chunk products.  Their
    plain versions' dense products never run here (K1's plain version
    does twice the causal work);
  * HBM bytes -- as ``hloanalysis`` counts top-level operators: the bytes
    of every tensor in and out of each operator that moves data (views
    and allocations move none), and each kernel's own bytes.

The optimizer's update is elementwise: it adds bytes, not products.  On one
card there are no collectives; the dry run's logical meshes run no
collective either, so their wire bytes are not counted (the roofline's
collective term is 0).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import meta as kmeta

#: operators that allocate or describe storage and move no bytes
_NO_BYTES = ("empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "detach", "alias", "lift_fresh",
             "_local_scalar_dense", "resize_", "set_")


@dataclasses.dataclass
class FlopCount:
    """One step's counts (the whole step, every worker's share together)."""
    flops: float                 # products + kernels
    hbm_bytes: float             # operators' and kernels' bytes
    product_flops: float         # FlopCounterMode's
    kernel_flops: Dict[str, float]
    kernel_bytes: Dict[str, float]
    kernel_calls: Dict[str, int]
    n_ops: int                   # operators that moved bytes

    def as_dict(self):
        return dataclasses.asdict(self)


class _ByteCounter(TorchDispatchMode):
    """Bytes in and out of every operator that moves data."""

    def __init__(self):
        super().__init__()
        self.nbytes = 0
        self.n_ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if not func.is_view and name not in _NO_BYTES:
            flat = tree_flatten((args, kwargs or {}))[0] + \
                tree_flatten(out)[0]
            self.nbytes += sum(t.numel() * t.element_size() for t in flat
                               if isinstance(t, torch.Tensor))
            self.n_ops += 1
        return out


def count(fn, *args, **kwargs) -> FlopCount:
    """Run ``fn(*args, **kwargs)`` (on meta tensors) and count it."""
    with kmeta.recording() as calls, \
            FlopCounterMode(display=False) as fc, _ByteCounter() as bc:
        fn(*args, **kwargs)
    k_flops, k_bytes, k_calls = (defaultdict(float), defaultdict(float),
                                 defaultdict(int))
    for c in calls:
        k_flops[c.kernel] += c.flops
        k_bytes[c.kernel] += c.nbytes
        k_calls[c.kernel] += 1
    products = float(fc.get_total_flops())
    return FlopCount(
        flops=products + sum(k_flops.values()),
        hbm_bytes=float(bc.nbytes) + sum(k_bytes.values()),
        product_flops=products, kernel_flops=dict(k_flops),
        kernel_bytes=dict(k_bytes), kernel_calls=dict(k_calls),
        n_ops=bc.n_ops)
