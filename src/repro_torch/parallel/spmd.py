"""Lockstep SPMD over the logical workers of a job mesh: the port's
``shard_map`` and its collectives (what the JAX package reaches as
``jax.shard_map`` through ``repro/parallel/compat.py``).

The JAX package is one controller over several devices; the port's
workers are logical workers on one ``torch.device``
(``parallel/mesh.py``).  So a ``shard_map`` here is one controller over a
list: :func:`shard_map` splits each input by its placement spec over the
mesh's workers, calls the body ONCE with, for each input, the list of the
workers' parts (flat worker order: the mesh's devices in row-major
order), and assembles the body's per-worker outputs by their specs.
Inside the body every step runs for all workers before the next one
(lockstep): :func:`each` applies a function to each worker's values, and
the collectives take and return per-worker lists, with the reference's
semantics for named mesh axes:

  * :func:`axis_index`, :func:`axis_size`;
  * :func:`all_gather` (``tiled``: concatenated, else stacked), :func:`psum`,
    :func:`pmean`, :func:`all_to_all` (``split_axis``, ``concat_axis``,
    ``tiled``), over one axis name or a tuple of them; :func:`gather_split`
    gathers every dimension a spec splits over one axis.

They are built from ``cat``, ``stack``, ``split`` and ``sum``, so autograd
flows through them (a gathered value's gradient is split back to its
parts).  A value that every worker of a group holds after a collective
(a gathered K/V, a gathered weight, a reduced sum) is one tensor shared by
reference, and :func:`each` calls its function once for workers whose
arguments are the same objects: a replicated input, split from one
tensor, is one view for all workers that hold it, and the work on it is
done once.  ``psum`` keeps the reference's meaning for such a value: the
sum over the group of its members, the same tensor counted once for each
worker that holds it.

Specs are tuples with one entry per leading dimension, as
``parallel/sharding.py::spec_for_axes`` gives them: ``None`` (not split),
an axis name, or a tuple of axis names (major first); ``()`` is
replicated.  A body with several outputs returns a tuple of per-worker
lists and is given a list of specs.
"""
from __future__ import annotations

import functools
import math
import threading
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

_state = threading.local()           # the mesh of the body running now


def _mesh():
    mesh = getattr(_state, "mesh", None)
    if mesh is None:
        raise RuntimeError("spmd: a collective outside a shard_map body")
    return mesh


def entry_axes(entry) -> Tuple[str, ...]:
    """A spec entry or an axis-name argument as a tuple of axis names."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


@functools.lru_cache(maxsize=64)
def _coords(mesh) -> Tuple[dict, ...]:
    """Each worker's index on every mesh axis, in flat worker order."""
    return tuple(dict(zip(mesh.axis_names, idx))
                 for idx in np.ndindex(*mesh.devices.shape))


def _ravel(coord: dict, names: Tuple[str, ...], mesh) -> int:
    """The index over ``names`` (major first) of a worker at ``coord``."""
    i = 0
    for a in names:
        i = i * mesh.shape[a] + coord[a]
    return i


def _size(mesh, names: Tuple[str, ...]) -> int:
    for a in names:
        if a not in mesh.axis_names:
            raise ValueError(f"spmd: no mesh axis {a!r} in {mesh.axis_names}")
    return math.prod(mesh.shape[a] for a in names)


@functools.lru_cache(maxsize=256)
def _groups(mesh, names: Tuple[str, ...]) -> Tuple[Tuple[int, ...], ...]:
    """The worker groups along ``names``: workers that share their index on
    every other axis, each group in its index order over ``names``."""
    _size(mesh, names)
    groups = {}
    for w, c in enumerate(_coords(mesh)):
        key = tuple(c[a] for a in mesh.axis_names if a not in names)
        groups.setdefault(key, []).append((_ravel(c, names, mesh), w))
    return tuple(tuple(w for _, w in sorted(g)) for g in groups.values())


def _spec(spec, ndim: int) -> Tuple[Tuple[str, ...], ...]:
    spec = tuple(spec or ())
    if len(spec) > ndim:
        raise ValueError(f"spmd: a spec of {len(spec)} entries for a "
                         f"{ndim}-d value")
    return tuple(entry_axes(e) for e in spec) + ((),) * (ndim - len(spec))


def split(x: torch.Tensor, spec, mesh) -> List[torch.Tensor]:
    """Each worker's part of ``x`` under ``spec``: views, one per distinct
    part (workers that hold the same part share it).  Each split dimension
    is cut by one ``torch.chunk``, so the parts' gradients come back
    through one concatenation, not one whole-size tensor a part."""
    names = _spec(spec, x.dim())
    parts = {(): x}
    for d, n in enumerate(names):
        k = _size(mesh, n)
        if k > 1 and x.shape[d] % k:
            raise ValueError(f"spmd: dim {d} of {tuple(x.shape)} does not "
                             f"split into {k} parts")
        parts = {key + (i,): c for key, t in parts.items()
                 for i, c in enumerate(torch.chunk(t, k, dim=d)
                                       if k > 1 else (t,))}
    return [parts[tuple(_ravel(c, n, mesh) for n in names)]
            for c in _coords(mesh)]


def assemble(vals: Sequence, spec, mesh):
    """The whole value from the workers' parts under ``spec``: parts
    concatenated along their split dimensions; along an axis that the spec
    does not name, the parts of index 0 (the reference's reading of an
    unchecked replicated output)."""
    v0 = vals[0]
    if not isinstance(v0, torch.Tensor):
        return v0
    names = _spec(spec, v0.dim())
    used = {a for n in names for a in n}
    blocks = {}
    for w, c in enumerate(_coords(mesh)):
        if any(c[a] for a in mesh.axis_names if a not in used):
            continue
        blocks[tuple(_ravel(c, n, mesh) for n in names)] = vals[w]

    def build(prefix, d):
        if d == len(names):
            return blocks[prefix]
        parts = [build(prefix + (i,), d + 1)
                 for i in range(_size(mesh, names[d]))]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=d)

    return build((), 0)


def shard_map(body: Callable, mesh, in_specs: Sequence, out_specs):
    """``body`` over the workers of ``mesh``: returns ``run(*args)``, which
    splits ``args[i]`` by ``in_specs[i]``, calls ``body`` once with the
    per-worker lists and assembles its output by ``out_specs`` (one spec,
    or a list of specs for a tuple of outputs)."""
    def run(*args):
        if len(args) != len(in_specs):
            raise ValueError(f"spmd: {len(args)} inputs, {len(in_specs)} "
                             "specs")
        local = [split(a, s, mesh) for a, s in zip(args, in_specs)]
        prev = getattr(_state, "mesh", None)
        _state.mesh = mesh
        try:
            out = body(*local)
        finally:
            _state.mesh = prev
        if isinstance(out_specs, list):
            if len(out) != len(out_specs):
                raise ValueError(f"spmd: {len(out)} outputs, "
                                 f"{len(out_specs)} specs")
            return tuple(assemble(o, s, mesh) for o, s in zip(out, out_specs))
        return assemble(out, out_specs, mesh)

    return run


def _key(v):
    return ("=", v) if isinstance(v, (int, float, str, bool, type(None))) \
        else id(v)


def each(fn: Callable, *args):
    """``fn`` on each worker's values: a list argument is per worker, any
    other is given to every worker.  Workers whose arguments are the same
    objects share one call's result.  When ``fn`` returns a tuple, a tuple
    of per-worker lists."""
    n = _mesh().size
    memo, out = {}, []
    for w in range(n):
        a = [x[w] if isinstance(x, list) else x for x in args]
        key = tuple(_key(v) for v in a)
        if key not in memo:
            memo[key] = fn(*a)
        out.append(memo[key])
    if out and isinstance(out[0], tuple):
        return tuple(list(col) for col in zip(*out))
    return out


def axis_index(axis_name) -> List[int]:
    """Each worker's index along ``axis_name`` (a tuple: major first)."""
    mesh = _mesh()
    names = entry_axes(axis_name)
    _size(mesh, names)
    return [_ravel(c, names, mesh) for c in _coords(mesh)]


def axis_size(axis_name) -> int:
    return _size(_mesh(), entry_axes(axis_name))


def _collective(xs: Sequence, axis_name, combine) -> list:
    """``combine(members' values) -> members' results`` for each group
    along ``axis_name``; groups whose members hold the same objects share
    the results."""
    mesh = _mesh()
    if len(xs) != mesh.size:
        raise ValueError(f"spmd: {len(xs)} values for {mesh.size} workers")
    out, memo = [None] * mesh.size, {}
    for g in _groups(mesh, entry_axes(axis_name)):
        vals = [xs[w] for w in g]
        key = tuple(_key(v) for v in vals)
        if key not in memo:
            memo[key] = combine(vals)
        for w, r in zip(g, memo[key]):
            out[w] = r
    return out


def psum(xs: Sequence, axis_name) -> list:
    """The sum over each group along ``axis_name``, in index order."""
    def combine(vals):
        s = vals[0]
        for v in vals[1:]:
            s = s + v
        return [s] * len(vals)
    return _collective(xs, axis_name, combine)


def pmean(xs: Sequence, axis_name) -> list:
    n = axis_size(axis_name)
    return [s / n for s in psum(xs, axis_name)] if n > 1 else list(xs)


def all_gather(xs: Sequence, axis_name, axis: int = 0,
               tiled: bool = False) -> list:
    """The group's values concatenated along ``axis`` (``tiled``) or
    stacked on a new ``axis``, in index order: one tensor per group."""
    def combine(vals):
        g = torch.cat(vals, dim=axis) if tiled else torch.stack(vals, dim=axis)
        return [g] * len(vals)
    return _collective(xs, axis_name, combine)


def gather_split(xs: Sequence, spec, axis_name) -> list:
    """The values made whole again along each dimension that ``spec``
    splits over ``axis_name`` (a weight kept in parts over ``data`` at
    rest, gathered where it is used)."""
    for d, e in enumerate(spec or ()):
        if axis_name in entry_axes(e):
            xs = all_gather(xs, axis_name, axis=d, tiled=True)
    return list(xs)


def all_to_all(xs: Sequence, axis_name, split_axis: int, concat_axis: int,
               tiled: bool = False) -> list:
    """Member ``i`` cuts its value into n parts along ``split_axis``;
    member ``j`` gets part ``j`` of every member, concatenated along
    ``concat_axis`` in index order (``tiled``).  Untiled, ``split_axis``
    has size n and is removed, and the parts are stacked on a new
    ``concat_axis``."""
    def combine(vals):
        n = len(vals)
        if vals[0].shape[split_axis] % n or \
                (not tiled and vals[0].shape[split_axis] != n):
            raise ValueError(f"spmd: all_to_all of a dim of "
                             f"{vals[0].shape[split_axis]} over {n} workers")
        parts = [torch.chunk(v, n, dim=split_axis) for v in vals]
        if tiled:
            return [torch.cat([p[j] for p in parts], dim=concat_axis)
                    for j in range(n)]
        return [torch.stack([p[j].squeeze(split_axis) for p in parts],
                            dim=concat_axis) for j in range(n)]
    return _collective(xs, axis_name, combine)
