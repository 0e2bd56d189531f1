"""Worker pools and job meshes of the port (port of
``repro/parallel/mesh.py``).

On one card a job's workers are **logical**: ids on one ``torch.device``.
A job mesh arranges a worker set as ``(data, model)`` exactly as the JAX
package's ``make_job_mesh`` arranges devices, and a :class:`Placement` says
how one state leaf is laid out over it: for each dimension, the mesh axes
it is split over (a ``PartitionSpec``'s entries).  A resize changes
placements and moves bytes through the redistribution patterns; the
arithmetic of a step does not depend on the worker count (each operation
runs once over the whole batch).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple, Union

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

    #: the mesh axes, as the JAX package's job meshes name them
    axis_names = ("data", "model")

    @property
    def shape(self) -> Dict[str, int]:
        """Mesh-axis sizes by name (a ``jax.sharding.Mesh``'s ``shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

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


#: one dimension's entry of a placement: not split (None), or split over
#: one mesh axis (its name) or several (a tuple of names, major first)
SpecEntry = Union[None, str, Tuple[str, ...]]


def _entry(e) -> SpecEntry:
    if e is None or isinstance(e, str):
        return e
    e = tuple(e)
    if not e:
        return None
    return e[0] if len(e) == 1 else e


@dataclasses.dataclass(frozen=True)
class Placement:
    """How one leaf lies on a mesh: per dimension, the mesh axes it is
    split over (a ``PartitionSpec``'s entries, as
    ``repro_torch.parallel.sharding.spec_for_axes`` produces them).

    ``spec`` is kept in one canonical form: a one-axis tuple becomes the
    axis name and trailing unsplit dimensions are dropped, so ``()`` is
    replicated.  An int ``axis`` is shorthand for splitting that dimension
    over every mesh axis, equal contiguous parts over every worker:
    ``Placement(mesh, 1) == Placement(mesh, (None, ("data", "model")))``;
    ``Placement(mesh)`` and ``Placement(mesh, None)`` are replicated."""
    mesh: JobMesh
    spec: Tuple[SpecEntry, ...] = ()

    def __post_init__(self):
        spec = self.spec
        if spec is None:
            spec = ()
        elif isinstance(spec, int):
            spec = (None,) * spec + (tuple(self.mesh.axis_names),)
        spec = [_entry(e) for e in spec]
        while spec and spec[-1] is None:
            spec.pop()
        object.__setattr__(self, "spec", tuple(spec))
