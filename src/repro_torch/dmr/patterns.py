"""Named redistribution patterns — the paper's Table-1 family as a registry
(port of ``repro/dmr/patterns.py``, with the same byte accounting).

A pattern works at two levels that share one accounting model:

* **device level** (the runner's resize path): ``apply(leaves, placements,
  ctx)`` moves a group of state leaves onto their new placements;
* **host level** (Table-1 semantics): ``host_redistribute(parts,
  new_nprocs)`` maps per-rank blocks (numpy arrays or tensors) from the old
  worker count to the new one.

Specs are registry names (``"default"``, ``"blockcyclic:4"``,
``"replicate"``, or a family added with ``register_pattern``), Pattern
instances, or a user function ``fn(leaf, placement, ctx) -> leaf`` (the
paper's user send/recv functions, Table 1's custom row).

Accounting: ``default`` reports the full resident bytes of what it moved;
``blockcyclic`` the communication volume of the layout change (bytes in
blocks whose owner rank changes); ``replicate`` the broadcast payload
(bytes x new worker count).  On one card the patterns move as follows:
``default`` rebuilds each leaf in fresh storage for its new layout (one
device copy); ``replicate`` keeps the one copy a device holds (eight
replicas of a 10 GB parameter set would not fit), so its bytes are the
model's broadcast volume, not a copy.

Donation (``donate=True``, the default, as in the reference): a resize
gives the old state up as it moves it.  Each source leaf is swapped for a
``meta`` tensor of its shape and dtype once every leaf of the state that
views its storage has moved, so a read of the donated state raises and
the storage goes back to the allocator when nothing else holds it: a
resize holds the state plus about one leaf, not two states.  A source
whose storage a moved leaf still uses (``replicate``, an identity
function, a view) is kept.  The
storage is not shrunk in place (``untyped_storage().resize_(0)``): torch
reads a tensor over a zero-size storage unchecked, so a stale read would
crash instead of raising.  A view of the state held outside it keeps that
storage alive, and the memory of a tensor made by ``torch.from_numpy`` is
its numpy array's: the tensor is given up, the buffer stays with numpy.
``donate=False`` copies and leaves the source as it was.
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
from repro_torch.spans import span

PatternSpec = Union[str, "Pattern", Callable]

#: profiler spans (``repro_torch.spans``): a whole state tree's
#: redistribution (pattern grouping, every move, the donor's last
#: give-ups), and inside it each pattern's moves, named by the pattern's
#: ``per_pattern`` key (``dmr.pattern.default``, ...)
REDISTRIBUTE_SPAN = "dmr.redistribute"
PATTERN_SPAN_PREFIX = "dmr.pattern."


@dataclasses.dataclass(frozen=True)
class ResizeContext:
    """What a pattern may know about the resize it is serving.  ``donor``
    gives the sources up under ``donate`` (``redistribute_tree`` sets one
    for the whole state; a pattern applied on its own makes its own)."""
    from_procs: int
    to_procs: int
    donate: bool = True
    donor: Optional["Donor"] = dataclasses.field(default=None, repr=False,
                                                 compare=False)


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


class _MoveClock:
    """The time of a group of moves.  On a card: two events on the
    current stream around the moves, read after ``_sync`` (work queued
    before the moves is not counted, and no sync is added); on the CPU,
    the host clock."""

    def __init__(self, leaves):
        dev = next((l.device for l in leaves if isinstance(l, torch.Tensor)
                    and l.device.type == "cuda"), None)
        self.stream = None if dev is None else torch.cuda.current_stream(dev)
        self.start = self._mark()

    def _mark(self):
        if self.stream is None:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self.stream)
        return ev

    def stop(self) -> None:
        self.end = self._mark()

    def seconds(self) -> float:
        """After ``stop`` and the sync of the moved leaves."""
        if self.stream is None:
            return self.end - self.start
        return self.start.elapsed_time(self.end) / 1e3


def _storage_key(t: torch.Tensor) -> Tuple[str, int]:
    return str(t.device), t.untyped_storage().data_ptr()


class Donor:
    """The source leaves of one donating resize, grouped by storage.

    ``moved(src, out)`` after each leaf's move: once every source that
    views ``src``'s storage has moved, and unless a moved leaf uses that
    storage (``replicate``, an identity function, a view), each of them
    is swapped for a ``meta`` tensor (views before their bases, which
    the views hold), so reading it raises and the storage is freed when
    nothing else holds it.  ``finish`` gives up what a pattern with its
    own ``apply`` did not report."""

    def __init__(self, leaves: List):
        self.sources: Dict[Tuple[str, int], List[torch.Tensor]] = {}
        for l in leaves:
            if isinstance(l, torch.Tensor):
                self.sources.setdefault(_storage_key(l), []).append(l)
        self.pending = {k: len(v) for k, v in self.sources.items()}
        self.kept: set = set()           # storages the moved leaves use

    def moved(self, src, out) -> None:
        if isinstance(out, torch.Tensor):
            self.kept.add(_storage_key(out))
        if isinstance(src, torch.Tensor):
            key = _storage_key(src)
            self.pending[key] -= 1
            if self.pending[key] == 0:
                self._give_up(key)

    def finish(self, moved: List) -> None:
        self.kept.update(_storage_key(m) for m in moved
                         if isinstance(m, torch.Tensor))
        for key in list(self.sources):
            self._give_up(key)

    def _give_up(self, key) -> None:
        sources = self.sources.pop(key)
        if key in self.kept:
            return
        done = set()
        for t in sorted(sources, key=lambda t: t._base is None):
            if id(t) in done or t.is_meta:
                continue
            done.add(id(t))
            try:
                torch.utils.swap_tensors(
                    t, torch.empty_like(t, device="meta"))
            except RuntimeError as e:
                raise RuntimeError(
                    f"cannot donate a {tuple(t.shape)} {t.dtype} leaf "
                    f"(something outside the state holds it; resize with "
                    f"donate=False): {e}") from e


def _detached(out, src):
    """``out`` with no autograd history, requiring grad as ``src`` did: a
    moved leaf whose graph reached the source would keep it alive."""
    if not isinstance(src, torch.Tensor):
        return out
    if not isinstance(out, torch.Tensor):
        raise TypeError(f"a pattern moved a {tuple(src.shape)} tensor to a "
                        f"{type(out).__name__}")
    if out.grad_fn is not None:
        out = out.detach()
    if out.requires_grad != src.requires_grad:
        out.requires_grad_(src.requires_grad)
    return out


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
        """Move a group of leaves onto their new placements, giving each
        source up as it moves under ``ctx.donate``.  ``seconds`` is the
        moves' time (see ``_MoveClock``)."""
        clock = _MoveClock(leaves)
        donor = ctx.donor or (Donor(leaves) if ctx.donate else None)
        moved = []
        with torch.no_grad():
            for l, p in zip(leaves, placements):
                moved.append(_detached(self.move(l, p, ctx), l))
                if donor is not None:
                    donor.moved(l, moved[-1])
        clock.stop()
        _sync(moved)
        nbytes = sum(self.leaf_bytes(l, ctx) for l in moved)
        return moved, TransferStats(bytes_moved=int(nbytes),
                                    seconds=clock.seconds(),
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


class CallablePattern(Pattern):
    """Adapter for a user function ``fn(leaf, placement, ctx) -> leaf``
    (the paper's user-supplied send/recv functions, leaf at a time); its
    bytes are the resident bytes of what ``fn`` returned.  ``fn`` runs
    under ``torch.no_grad``; under ``ctx.donate`` it may return its leaf,
    a view of it, or new storage, and must not keep the leaf otherwise."""

    name = "custom"

    def __init__(self, fn: Callable, name: Optional[str] = None):
        self.fn = fn
        if name:
            self.name = name
        elif getattr(fn, "__name__", None) not in (None, "<lambda>"):
            self.name = f"custom:{fn.__name__}"

    def move(self, leaf, placement, ctx):
        return self.fn(leaf, placement, ctx)


# ----------------------------------------------------------------------
# Registry
# ----------------------------------------------------------------------

#: name -> factory(arg: str|None) -> Pattern
PATTERNS: Dict[str, Callable[[Optional[str]], Pattern]] = {
    "default": lambda arg: DefaultPattern(),
    "replicate": lambda arg: ReplicatePattern(),
    "blockcyclic": lambda arg: BlockCyclicPattern(int(arg or 1)),
}


def register_pattern(name: str,
                     factory: Callable[[Optional[str]], Pattern]) -> None:
    """Register a custom pattern family under ``name`` (``factory`` receives
    the text after ``name:`` in the spec, or ``None``)."""
    if ":" in name:
        raise ValueError(f"pattern name must not contain ':': {name!r}")
    PATTERNS[name] = factory


def get_pattern(spec: PatternSpec) -> Pattern:
    """Resolve a pattern spec: a Pattern instance, a registry name such as
    ``"default"`` / ``"blockcyclic:4"`` / ``"replicate"``, or a callable
    ``fn(leaf, placement, ctx) -> leaf``."""
    if isinstance(spec, Pattern):
        return spec
    if callable(spec):
        return CallablePattern(spec)
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
                      from_procs: int = 0, to_procs: int = 0,
                      donate: bool = True
                      ) -> Tuple[Any, TransferStats,
                                 Dict[str, TransferStats]]:
    """Move a state tree onto new placements, pattern-by-pattern.

    ``patterns`` maps path prefixes (``"table"``, ``"opt/mu"``, ``"*"``) to
    pattern specs; unmatched subtrees use ``default``.  Returns
    ``(new_state, aggregate_stats, per_pattern_stats)`` where the breakdown
    is keyed by each pattern's ``spec()`` string.  Under ``donate`` the
    old state is given up as it moves (see the module's docstring): the
    caller must not read it again.
    """
    with span(REDISTRIBUTE_SPAN):
        paths_leaves = T.flatten(state)
        sources = [leaf for _, leaf in paths_leaves]
        donor = Donor(sources) if donate else None
        ctx = ResizeContext(from_procs=from_procs, to_procs=to_procs,
                            donate=donate, donor=donor)
        place_leaves = T.leaves(new_placements)
        if len(place_leaves) != len(paths_leaves):
            raise ValueError("placements are not congruent with the state")
        patterns = patterns or {}

        resolved: Dict[Any, Pattern] = {}  # spec value/id -> Pattern (dedup)
        groups: Dict[int, List[int]] = {}  # id(pattern) -> leaf indices
        by_id: Dict[int, Pattern] = {}
        for i, (path, _leaf) in enumerate(paths_leaves):
            spec = _match_spec(path, patterns, default)
            # dedup string specs by value, everything else (callables,
            # Pattern instances) by identity; group by *pattern* identity
            # so two distinct callables stay distinct even if their spec()
            # strings collide (e.g. two lambdas, both "custom")
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
            key, n = pat.spec(), 2
            while key in per_pattern:      # spec-string collision: suffix
                key, n = f"{pat.spec()}#{n}", n + 1
            with span(PATTERN_SPAN_PREFIX + key):
                moved, stats = pat.apply(
                    [paths_leaves[i][1] for i in idxs],
                    [place_leaves[i] for i in idxs], ctx)
            for i, leaf in zip(idxs, moved):
                out_leaves[i] = leaf
            per_pattern[key] = stats
        if donor is not None:
            donor.finish(out_leaves)

        total = TransferStats(
            bytes_moved=sum(s.bytes_moved for s in per_pattern.values()),
            seconds=sum(s.seconds for s in per_pattern.values()),
            n_leaves=sum(s.n_leaves for s in per_pattern.values()))
        return T.unflatten(state, out_leaves), total, per_pattern
