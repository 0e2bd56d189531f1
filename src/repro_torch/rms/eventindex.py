"""Event-index utilities shared by the O(events) scheduling engines (port
of ``repro/rms/eventindex.py``).

Both fast engines — ``repro_torch.rms.scheduler.Simulator``
(discrete-event simulator) and ``repro_torch.dmr.cluster.Cluster`` (live
tick-clock runtime) — index their pending queue the same way: jobs are
bucketed by minimum request size, each bucket carrying a lazily-deleted priority heap and a
lazily-deleted arrival heap.  A backfill scan peeks only bucket heads
that fit in the free pool, so its cost is proportional to the number of
jobs *started*, not the queue length; the post-shrink boost ("earliest
pending job that now fits") reads the arrival heads the same way.

``MinRequestIndex`` owns that machinery — membership, per-item sequence
and version bookkeeping, incremental bucket counts, and the collapsed
``PendingMins`` multiset view handed to ``decide_stateless`` policies.
The engines own everything semantic (when to scan, what key to use, what
"fits" means); the index never looks inside the items it stores beyond
the identity key the engine chose.
"""
from __future__ import annotations

import heapq
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple


class PendingMins:
    """Multiset summary of the pending jobs' minimum requests.

    Duck-types the ``ClusterView.pending_min_sizes`` sequence without
    materializing one int per queued job: ``len``/``bool`` reflect the true
    queue size, iteration yields the *distinct* minimum sizes in ascending
    order.  Every aggregate the built-in policies compute (`truthiness,
    ``min(...)``, ``any(x >= m for m in ...)``) is unchanged by collapsing
    duplicates.  Only ``decide_stateless`` policies see this view — for
    anything else the fast engines materialize the reference engines'
    literal per-job list.
    """

    __slots__ = ("_counts", "_n")

    def __init__(self, counts: Dict[int, int], n: int):
        self._counts = counts
        self._n = n

    def __bool__(self) -> bool:
        return self._n > 0

    def __len__(self) -> int:
        return self._n

    def __iter__(self):
        return iter(sorted(self._counts))


class MinRequestIndex:
    """Pending-queue index: lazy-deleted heaps bucketed by minimum request.

    Items are stored under an engine-chosen hashable identity (a jid).
    All heap entries are lazily deleted — stale entries (items removed or
    re-keyed since the entry was pushed) are discarded on pop against
    per-item version counters, never searched for.

    * priority heaps: per-bucket ``(priority_key, arrival_seq, ver, id)``
      — ``best()`` returns the globally best head among fitting buckets.
    * arrival heaps: per-bucket ``(arrival_seq, id)`` —
      ``earliest_fitting()`` serves the post-shrink boost.
    * ``counts`` / ``min_lo`` / ``min_sizes()``: incremental bucket sizes
      and the collapsed ``PendingMins`` view.

    Insertion order is preserved (dict-backed), so iterating the index
    yields items in arrival order — the exact order the reference engines
    see their pending lists in.
    """

    __slots__ = ("_items", "_counts", "_min_lo", "_prio", "_arrival",
                 "_lo", "_seq", "_ver", "_next_seq")

    def __init__(self) -> None:
        self._items: Dict[Hashable, Any] = {}        # id -> item (arrival order)
        self._counts: Dict[int, int] = {}            # min request -> count
        self._min_lo: float = float("inf")           # min over counts' keys
        self._prio: Dict[int, List[Tuple]] = {}      # lo -> [(key, seq, ver, id)]
        self._arrival: Dict[int, List[Tuple[int, Hashable]]] = {}
        self._lo: Dict[Hashable, int] = {}
        self._seq: Dict[Hashable, int] = {}
        self._ver: Dict[Hashable, int] = {}
        self._next_seq = 0

    # -- membership -----------------------------------------------------
    def __len__(self) -> int:
        return len(self._items)

    def __bool__(self) -> bool:
        return bool(self._items)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._items

    def __iter__(self):
        return iter(self._items.values())

    def __getitem__(self, key: Hashable) -> Any:
        return self._items[key]

    @property
    def min_lo(self) -> float:
        return self._min_lo

    @property
    def counts(self) -> Dict[int, int]:
        return self._counts

    # -- mutation -------------------------------------------------------
    def push(self, key: Hashable, item: Any, lo: int,
             prio_key: Optional[Tuple] = None) -> None:
        """Add an item under identity ``key`` with minimum request ``lo``.
        ``prio_key=None`` (dynamic-priority mode) skips the priority entry
        — the engine rebuilds heaps at each pass instead."""
        seq = self._next_seq
        self._next_seq += 1
        self._items[key] = item
        self._lo[key] = lo
        self._seq[key] = seq
        self._ver[key] = 0
        self._counts[lo] = self._counts.get(lo, 0) + 1
        if lo < self._min_lo:
            self._min_lo = lo
        if prio_key is not None:
            heapq.heappush(self._prio.setdefault(lo, []),
                           (prio_key, seq, 0, key))
        heapq.heappush(self._arrival.setdefault(lo, []), (seq, key))

    def discard(self, key: Hashable) -> None:
        """Remove an item; its heap entries go stale and are lazily
        dropped on a later pop."""
        del self._items[key]
        lo = self._lo.pop(key)
        del self._seq[key]
        del self._ver[key]
        n = self._counts[lo] - 1
        if n:
            self._counts[lo] = n
        else:
            del self._counts[lo]
            self._min_lo = min(self._counts) if self._counts \
                else float("inf")

    def rekey(self, key: Hashable, prio_key: Optional[Tuple] = None) -> None:
        """Invalidate the item's existing priority entries (version bump);
        push a fresh one when ``prio_key`` is given (static-key mode)."""
        self._ver[key] += 1
        if prio_key is not None:
            heapq.heappush(self._prio.setdefault(self._lo[key], []),
                           (prio_key, self._seq[key], self._ver[key], key))

    def rebuild(self, keyfn: Callable[[Any], Tuple]) -> None:
        """dynamic_priority fallback: keys age with time, so re-key the
        whole queue at each scheduling pass (reference-engine cost)."""
        self._prio = heaps = {}
        for key, item in self._items.items():
            self._ver[key] += 1
            heapq.heappush(heaps.setdefault(self._lo[key], []),
                           (keyfn(item), self._seq[key], self._ver[key], key))

    # -- queries --------------------------------------------------------
    def best(self, free: int, backfill: bool) -> Optional[Any]:
        """The item with the smallest ``(priority_key, arrival_seq)``
        among bucket heads — restricted to buckets that fit in ``free``
        when backfilling (a backfill scan skips blocked sizes for free; a
        strict-FCFS caller checks the returned head's own fit and stops).
        Lazily deletes stale entries on the way; None when nothing
        qualifies."""
        items, ver = self._items, self._ver
        best = None
        for lo in list(self._prio):
            h = self._prio[lo]
            while h:
                head = h[0]
                k = head[3]
                if k in items and ver[k] == head[2]:
                    break
                heapq.heappop(h)       # lazy-deleted (removed / re-keyed)
            if not h:
                del self._prio[lo]
                continue
            if backfill and lo > free:
                continue               # backfill scans past, for free
            if best is None or h[0][:2] < best[:2]:
                best = h[0]
        return items[best[3]] if best is not None else None

    def earliest_fitting(self, free: int) -> Optional[Any]:
        """Earliest-arrived item among buckets whose minimum fits ``free``
        (the post-shrink boost target), or None."""
        items = self._items
        best = None
        for lo in list(self._arrival):
            if lo > free:
                continue
            h = self._arrival[lo]
            while h and h[0][1] not in items:
                heapq.heappop(h)
            if not h:
                del self._arrival[lo]
                continue
            if best is None or h[0] < best:
                best = h[0]
        return items[best[1]] if best is not None else None

    def min_sizes(self, collapse: bool):
        """The pending-minimums view: the duplicate-collapsed
        ``PendingMins`` multiset when ``collapse`` (decide_stateless
        policies), else the literal per-item list in arrival order."""
        if collapse:
            return PendingMins(self._counts, len(self._items))
        return [self._lo[k] for k in self._items]
