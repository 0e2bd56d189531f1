"""Worker pools and job meshes of the port (port of
``repro/parallel/mesh.py``).

On one card a job's workers are **logical**: ids on one ``torch.device``.
A job mesh arranges a worker set as ``(data, model)`` exactly as the JAX
package's ``make_job_mesh`` arranges devices, and a :class:`Placement` says
how one state leaf is laid out over it (replicated, or split along one
axis).  A resize changes placements and moves bytes through the
redistribution patterns; the arithmetic of a step does not depend on the
worker count (each operation runs once over the whole batch).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Worker:
    """One logical worker: an id on a device."""
    id: int
    device: torch.device


def default_device(device=None) -> torch.device:
    """``cuda`` unless the caller names another device; raises when a CUDA
    device is asked for and none is present (no silent CPU fallback)."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is present; pass device='cpu' "
                           "to run on the CPU")
    return dev


def logical_workers(n: int, device=None) -> List[Worker]:
    """``n`` logical workers on one device (``default_device`` rules)."""
    dev = default_device(device)
    return [Worker(i, dev) for i in range(n)]


def factor_mesh(n: int, max_model: int = 16) -> Tuple[int, int]:
    """Pick a (data, model) factorization for an n-worker elastic job."""
    model = 1
    for m in range(min(max_model, n), 0, -1):
        if n % m == 0:
            model = m
            break
    return n // model, model


@dataclasses.dataclass(frozen=True, eq=False)
class JobMesh:
    """A job's workers as a ``(data, model)`` grid on one device."""
    devices: np.ndarray                      # (data, model) of Worker

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device(self) -> torch.device:
        return self.devices.flat[0].device


def make_job_mesh(workers: Sequence[Worker], *, max_model: int = 16) -> JobMesh:
    """Mesh over an explicit worker set (an elastic job's allocation)."""
    if not workers:
        raise ValueError("a job mesh needs at least one worker")
    if len({w.device for w in workers}) != 1:
        raise ValueError("one job mesh spans one device in this port")
    data, model = factor_mesh(len(workers), max_model)
    dev = np.empty(len(workers), dtype=object)
    dev[:] = list(workers)
    return JobMesh(dev.reshape(data, model))


@dataclasses.dataclass(frozen=True)
class Placement:
    """How one leaf lies on a mesh: replicated (``axis=None``) or split in
    equal contiguous parts along ``axis`` over every worker."""
    mesh: JobMesh
    axis: Optional[int] = None
