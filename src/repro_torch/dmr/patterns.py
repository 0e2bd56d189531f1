"""Named redistribution patterns — the paper's Table-1 family as a registry
(port of ``repro/dmr/patterns.py``, with the same byte accounting).

A pattern works at two levels that share one accounting model:

* **device level** (the runner's resize path): ``apply(leaves, placements,
  ctx)`` moves a group of state leaves onto their new placements;
* **host level** (Table-1 semantics): ``host_redistribute(parts,
  new_nprocs)`` maps per-rank blocks (numpy arrays or tensors) from the old
  worker count to the new one.

Accounting: ``default`` reports the full resident bytes of what it moved;
``blockcyclic`` the communication volume of the layout change (bytes in
blocks whose owner rank changes); ``replicate`` the broadcast payload
(bytes x new worker count).  On one card the patterns move as follows:
``default`` rebuilds each leaf in fresh storage for its new layout (one
device copy); ``replicate`` keeps the one copy a device holds (eight
replicas of a 10 GB parameter set would not fit), so its bytes are the
model's broadcast volume, not a copy.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.core.redistribute import (TransferStats,
                                           blockcyclic_redistribute,
                                           default_redistribution)

PatternSpec = Union[str, "Pattern"]


@dataclasses.dataclass(frozen=True)
class ResizeContext:
    """What a pattern may know about the resize it is serving."""
    from_procs: int
    to_procs: int


def _leaf_nbytes(leaf) -> int:
    return int(leaf.nbytes)


def _row_bytes(part) -> int:
    return int(part.itemsize * int(np.prod(tuple(part.shape[1:]),
                                           dtype=np.int64)))


def _sync(leaves) -> None:
    """Wait for the device work that moved ``leaves`` (block_until_ready)."""
    for d in {l.device for l in leaves if isinstance(l, torch.Tensor)
              and l.device.type == "cuda"}:
        torch.cuda.synchronize(d)


class Pattern:
    """One named redistribution pattern (device + host level)."""

    name = "pattern"

    def spec(self) -> str:
        """The registry string that reproduces this pattern."""
        return self.name

    # -- device level (the runner's resize path) -----------------------
    def leaf_bytes(self, leaf, ctx: ResizeContext) -> int:
        """Accounted bytes for moving one leaf (pattern-specific model)."""
        return _leaf_nbytes(leaf)

    def move(self, leaf, placement, ctx: ResizeContext):
        """One leaf onto its new placement: a copy into fresh storage."""
        return leaf.clone()

    def apply(self, leaves: List, placements: List,
              ctx: ResizeContext) -> Tuple[List, TransferStats]:
        """Move a group of leaves onto their new placements."""
        t0 = time.perf_counter()
        moved = [self.move(l, p, ctx) for l, p in zip(leaves, placements)]
        _sync(moved)
        dt = time.perf_counter() - t0
        nbytes = sum(self.leaf_bytes(l, ctx) for l in moved)
        return moved, TransferStats(bytes_moved=int(nbytes), seconds=dt,
                                    n_leaves=len(moved))

    # -- host level (Table-1 per-rank semantics) -----------------------
    def host_redistribute(self, parts: List, new_nprocs: int
                          ) -> Tuple[List, TransferStats]:
        raise NotImplementedError(
            f"pattern {self.spec()!r} has no host-level redistribution")

    def __repr__(self):
        return f"{type(self).__name__}({self.spec()!r})"


class DefaultPattern(Pattern):
    """Default Redistribution (paper Fig. 2): 1-D uniform contiguous blocks.

    Device level: each leaf is copied into fresh storage for its new
    placement and the full resident bytes are accounted.  Host level:
    ``default_redistribution`` with communication-volume accounting (rows
    whose owner rank changes).
    """

    name = "default"

    def host_redistribute(self, parts, new_nprocs):
        t0 = time.perf_counter()
        out = default_redistribution(list(parts), new_nprocs)
        dt = time.perf_counter() - t0
        old_sizes = [p.shape[0] for p in parts]
        new_sizes = [p.shape[0] for p in out]
        old_owner = np.repeat(np.arange(len(parts)), old_sizes)
        new_owner = np.repeat(np.arange(new_nprocs), new_sizes)
        row_bytes = _row_bytes(parts[0]) if parts else 0
        moved = int(np.count_nonzero(old_owner != new_owner)) * row_bytes
        return out, TransferStats(bytes_moved=moved, seconds=dt,
                                  n_leaves=len(out))


class BlockCyclicPattern(Pattern):
    """Block-Cyclic Redistribution (paper Table 1, second group).

    ``blockcyclic:<block>`` repartitions at ``block``-row granularity with
    owners assigned round-robin.  Accounting (both levels) is the layout
    change's communication volume: bytes in blocks whose owner rank changes
    between the old and new round-robin maps — zero when the worker count
    is unchanged.  The host level runs the block-cyclic repack kernel on
    tensors on a card.
    """

    name = "blockcyclic"

    def __init__(self, block: int = 1):
        if block < 1:
            raise ValueError(f"block must be >= 1, got {block}")
        self.block = int(block)

    def spec(self) -> str:
        return f"{self.name}:{self.block}"

    def _moved_rows(self, n_rows: int, ctx: ResizeContext) -> int:
        if ctx.from_procs == ctx.to_procs or n_rows == 0 or \
                not ctx.from_procs or not ctx.to_procs:
            return 0
        blocks = np.arange((n_rows + self.block - 1) // self.block)
        changed = (blocks % ctx.from_procs) != (blocks % ctx.to_procs)
        rows = np.full(blocks.shape, self.block, dtype=np.int64)
        rem = n_rows - (len(blocks) - 1) * self.block
        rows[-1] = rem                         # trailing partial block
        return int(rows[changed].sum())

    def leaf_bytes(self, leaf, ctx: ResizeContext) -> int:
        if leaf.dim() == 0:
            return 0
        n_rows = leaf.shape[0]
        row_bytes = _leaf_nbytes(leaf) // max(n_rows, 1)
        return self._moved_rows(n_rows, ctx) * row_bytes

    def host_redistribute(self, parts, new_nprocs):
        t0 = time.perf_counter()
        out = blockcyclic_redistribute(list(parts), new_nprocs, self.block)
        _sync(out)
        dt = time.perf_counter() - t0
        n_rows = sum(p.shape[0] for p in parts)
        row_bytes = _row_bytes(parts[0]) if parts else 0
        ctx = ResizeContext(len(parts), new_nprocs)
        moved = self._moved_rows(n_rows, ctx) * row_bytes
        return out, TransferStats(bytes_moved=moved, seconds=dt,
                                  n_leaves=len(out))


class ReplicatePattern(Pattern):
    """Re-replication (the HPG-aligner reference table): every worker in the
    new allocation holds a full copy; accounted as the broadcast payload
    (leaf bytes x new worker count).  Workers sharing a device share its
    one copy, so the device level moves nothing."""

    name = "replicate"

    def leaf_bytes(self, leaf, ctx: ResizeContext) -> int:
        return _leaf_nbytes(leaf) * max(ctx.to_procs, 1)

    def move(self, leaf, placement, ctx):
        return leaf

    def host_redistribute(self, parts, new_nprocs):
        t0 = time.perf_counter()
        src = parts[0]
        out = [src.clone() if isinstance(src, torch.Tensor) else src.copy()
               for _ in range(new_nprocs)]
        dt = time.perf_counter() - t0
        return out, TransferStats(bytes_moved=int(src.nbytes) * new_nprocs,
                                  seconds=dt, n_leaves=new_nprocs)


# ----------------------------------------------------------------------
# Registry
# ----------------------------------------------------------------------

#: name -> factory(arg: str|None) -> Pattern
PATTERNS: Dict[str, Callable[[Optional[str]], Pattern]] = {
    "default": lambda arg: DefaultPattern(),
    "replicate": lambda arg: ReplicatePattern(),
    "blockcyclic": lambda arg: BlockCyclicPattern(int(arg or 1)),
}


def get_pattern(spec: PatternSpec) -> Pattern:
    """Resolve a pattern spec: a Pattern instance or a registry name such
    as ``"default"`` / ``"blockcyclic:4"`` / ``"replicate"``."""
    if isinstance(spec, Pattern):
        return spec
    name, _, arg = str(spec).partition(":")
    try:
        factory = PATTERNS[name]
    except KeyError:
        raise KeyError(f"unknown redistribution pattern {spec!r}; "
                       f"known: {sorted(PATTERNS)}") from None
    return factory(arg or None)


# ----------------------------------------------------------------------
# Per-subtree composition over a state tree
# ----------------------------------------------------------------------

def _match_spec(path: str, patterns: Dict[str, PatternSpec],
                default: PatternSpec) -> PatternSpec:
    """Longest path-prefix match; ``"*"`` overrides the default."""
    best, best_len = None, -1
    for key, spec in patterns.items():
        if key == "*":
            continue
        if (path == key or path.startswith(key + "/")) and len(key) > best_len:
            best, best_len = spec, len(key)
    if best_len >= 0:
        return best
    return patterns.get("*", default)


def redistribute_tree(state, new_placements, *,
                      patterns: Optional[Dict[str, PatternSpec]] = None,
                      default: PatternSpec = "default",
                      from_procs: int = 0, to_procs: int = 0
                      ) -> Tuple[Any, TransferStats,
                                 Dict[str, TransferStats]]:
    """Move a state tree onto new placements, pattern-by-pattern.

    ``patterns`` maps path prefixes (``"table"``, ``"opt/mu"``, ``"*"``) to
    pattern specs; unmatched subtrees use ``default``.  Returns
    ``(new_state, aggregate_stats, per_pattern_stats)`` where the breakdown
    is keyed by each pattern's ``spec()`` string.
    """
    ctx = ResizeContext(from_procs=from_procs, to_procs=to_procs)
    paths_leaves = T.flatten(state)
    place_leaves = T.leaves(new_placements)
    if len(place_leaves) != len(paths_leaves):
        raise ValueError("placements are not congruent with the state")
    patterns = patterns or {}

    resolved: Dict[Any, Pattern] = {}      # spec value/id -> Pattern (dedup)
    groups: Dict[int, List[int]] = {}      # id(pattern) -> leaf indices
    by_id: Dict[int, Pattern] = {}
    for i, (path, _leaf) in enumerate(paths_leaves):
        spec = _match_spec(path, patterns, default)
        key = spec if isinstance(spec, str) else id(spec)
        pat = resolved.get(key)
        if pat is None:
            pat = resolved[key] = get_pattern(spec)
        by_id[id(pat)] = pat
        groups.setdefault(id(pat), []).append(i)

    out_leaves: List = [None] * len(paths_leaves)
    per_pattern: Dict[str, TransferStats] = {}
    for pat_id, idxs in groups.items():
        pat = by_id[pat_id]
        moved, stats = pat.apply([paths_leaves[i][1] for i in idxs],
                                 [place_leaves[i] for i in idxs], ctx)
        for i, leaf in zip(idxs, moved):
            out_leaves[i] = leaf
        key, n = pat.spec(), 2
        while key in per_pattern:          # spec-string collision: suffix
            key, n = f"{pat.spec()}#{n}", n + 1
        per_pattern[key] = stats

    total = TransferStats(
        bytes_moved=sum(s.bytes_moved for s in per_pattern.values()),
        seconds=sum(s.seconds for s in per_pattern.values()),
        n_leaves=sum(s.n_leaves for s in per_pattern.values()))
    return T.unflatten(state, out_leaves), total, per_pattern
