"""Worker pools and job meshes of the port (port of
``repro/parallel/mesh.py``).

On one card a job's workers are **logical**: ids on one ``torch.device``.
A job mesh arranges a worker set as ``(data, model)`` exactly as the JAX
package's ``make_job_mesh`` arranges devices, and a :class:`Placement` says
how one state leaf is laid out over it: for each dimension, the mesh axes
it is split over (a ``PartitionSpec``'s entries).  A resize changes
placements and moves bytes through the redistribution patterns.  The
worker count changes a step's arithmetic only where the reference's does:
under a training job's sharding context (``parallel/context.py``) the
attention and MoE layers run ``shard_map`` bodies over the mesh's workers
in lockstep (``parallel/spmd.py``: per-worker values on the one device,
collectives built from ``cat`` and ``sum``); every other operation runs
once over the whole batch.

The production meshes of the JAX package's dry run, ``(16, 16)`` and
``(2, 16, 16)`` (a ``pod`` axis first), are job meshes of 256 and 512
logical workers, on ``meta`` by default: nothing is allocated, and a
placement on them gives the shape and bytes each worker would hold
(:meth:`Placement.local_shape`, :meth:`Placement.local_bytes`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

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
    """A job's workers as a ``(data, model)`` grid on one device (or a
    ``(pod, data, model)`` one: the multi-pod production mesh)."""
    devices: np.ndarray                      # (data, model) of Worker
    #: the mesh axes, as the JAX package's meshes name them
    axis_names: Tuple[str, ...] = ("data", "model")

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a {self.devices.shape} grid of workers for "
                             f"the axes {self.axis_names}")

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


def make_production_mesh(*, multi_pod: bool = False,
                         device="meta") -> JobMesh:
    """The dry run's logical production mesh: ``(16, 16)`` over ``("data",
    "model")``, or ``(2, 16, 16)`` over ``("pod", "data", "model")``, of
    logical workers on ``device`` (``meta``: nothing is allocated)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    dev = torch.device(device)
    workers = np.empty(math.prod(shape), dtype=object)
    workers[:] = [Worker(i, dev) for i in range(workers.size)]
    return JobMesh(workers.reshape(shape), axes)


def host_devices(n: Optional[int] = None) -> List[torch.device]:
    """This host's cards (``cuda:i``), the first ``n`` of them; raises
    when there are fewer (the JAX package's asks for host devices)."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < (1 if n is None else n):
        raise RuntimeError(f"need {n or 1} CUDA device(s), have {have}")
    return [torch.device("cuda", i) for i in range(have if n is None else n)]


def mesh_device_set(mesh: JobMesh):
    """The ids of a mesh's workers."""
    return set(w.id for w in mesh.devices.flat)


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

    def local_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The shape of the part of a ``shape`` leaf each worker holds: a
        split dimension cut into as many equal parts as its mesh axes'
        sizes multiply to (the placement rules keep only exact
        divisions)."""
        shape, sizes = tuple(shape), self.mesh.shape
        for i, e in enumerate(self.spec):
            n = math.prod(sizes[a] for a in ((e,) if isinstance(e, str)
                                             else e or ()))
            if shape[i] % n:
                raise ValueError(f"dim {i} of {shape} does not split into "
                                 f"{n} parts")
            shape = shape[:i] + (shape[i] // n,) + shape[i + 1:]
        return shape

    def local_bytes(self, leaf: torch.Tensor) -> int:
        """Bytes of ``leaf`` (a tensor, meta or not) each worker holds."""
        return math.prod(self.local_shape(leaf.shape)) * leaf.element_size()
