"""RMS connectors — one protocol between a running job and its RMS (port
of ``repro/dmr/connectors.py``).

The paper's Fig. 1 link between DMRlib and Slurm, generalized: every way a
runner can receive resize decisions implements :class:`RMSConnector` —

  * :class:`ScriptedRMS`  — deterministic ``{step: target}`` schedule
    (tests, examples, benchmark replays);
  * :class:`PolicyRMS`    — a pluggable ``repro_torch.core.policy.Policy``
    evaluated against a live cluster view (the standalone/Algorithm-2 case);
  * :class:`FileRMS`      — operator-issued resize commands via a watched
    JSON file (the single-host stand-in for the Slurm RPC socket);
  * ``repro_torch.dmr.cosim.SimRMS`` — co-simulation: decisions come from
    a job embedded in the discrete-event cluster simulator.

``connect`` is the convenience factory the examples use: a dict becomes a
``ScriptedRMS``, ``"file:<path>"`` a ``FileRMS``, and any RMSConnector
passes through.  For policy-driven resizes pass ``rms=None`` plus
``policy="<name>"`` to the runner — it builds the ``PolicyRMS`` itself
(it owns the cluster view).
"""
from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional, Protocol, Union, runtime_checkable

from repro_torch.core.params import MalleabilityParams
from repro_torch.core.policy import Action, ClusterView, Policy, get_policy


@runtime_checkable
class RMSConnector(Protocol):
    """The runner <-> RMS channel: one query per DMR_RECONFIG point."""

    def query(self, *, step: int, current: int,
              params: MalleabilityParams) -> Action: ...


class ScriptedRMS:
    """Fixed ``{step: target_size}`` schedule.

    Entries are consumed *in step order*, each firing at the first query
    with ``step >=`` its key: a resize whose exact step lands inside the
    runner's ``sched_iterations`` / ``sched_period_s`` inhibitor window
    (``maybe_reconfig`` never issues a query there) is deferred to the
    next query instead of silently dropped.  At most one entry fires per
    query — one decision per DMR_RECONFIG point — so several overdue
    entries drain across consecutive queries, still in order.
    """

    def __init__(self, schedule: Dict[int, int]):
        self.schedule = dict(schedule)
        self._consumed: set = set()

    def query(self, *, step: int, current: int,
              params: MalleabilityParams) -> Action:
        # ``schedule`` stays the live lookup table (it may be mutated
        # after construction); consumed keys are tracked separately
        due = [k for k in self.schedule
               if k not in self._consumed and k <= step]
        if not due:
            return Action.none(current)
        key = min(due)
        self._consumed.add(key)
        tgt = params.clamp(self.schedule[key])
        if tgt == current:
            return Action.none(current)
        return Action("expand" if tgt > current else "shrink", tgt)


class PolicyRMS:
    """A malleability policy against a caller-supplied cluster view.

    ``policy`` is any ``repro_torch.core.policy.Policy`` instance or registry name
    ("algorithm2" — the default — "energy", "throughput", ...)."""

    def __init__(self, view_fn: Callable[[], ClusterView], policy=None):
        self.view_fn = view_fn
        self.policy: Policy = get_policy(policy)

    def query(self, *, step: int, current: int,
              params: MalleabilityParams) -> Action:
        return self.policy.decide(current, params, self.view_fn())


class FileRMS:
    """Reads ``{"target": N}`` from a JSON file when its content changes.

    Malformed or mid-write files are treated as "no decision yet"
    (``Action.none``): the watermark only advances once a file parses, so
    a command written non-atomically is picked up on a later query
    instead of crashing the training loop.

    The watermark is the triple ``(st_mtime_ns, st_size, payload)`` — a
    bare ``st_mtime`` watermark drops the second of two decisions written
    within one mtime granularity tick (whole seconds on coarse
    filesystems), and even ``st_mtime_ns`` can collide across a fast
    overwrite, so the payload itself is the tie-breaker.
    """

    def __init__(self, path: str):
        self.path = path
        self._seen: Optional[tuple] = None     # (mtime_ns, size, payload)

    def query(self, *, step: int, current: int,
              params: MalleabilityParams) -> Action:
        try:
            st = os.stat(self.path)
            with open(self.path) as f:
                payload = f.read()
        except OSError:
            return Action.none(current)
        sig = (st.st_mtime_ns, st.st_size, payload)
        if sig == self._seen:
            return Action.none(current)        # already applied
        try:
            cmd = json.loads(payload)
            tgt = params.clamp(int(cmd.get("target", current)))
        except (ValueError, TypeError, AttributeError):
            return Action.none(current)        # malformed / mid-write: retry
        self._seen = sig
        if tgt == current:
            return Action.none(current)
        return Action("expand" if tgt > current else "shrink", tgt)


def connect(spec: Union[RMSConnector, Dict[int, int], str, None],
            ) -> Optional[RMSConnector]:
    """Resolve an RMS spec to a connector.

    ``None`` means "let the runner evaluate a policy locally"; a dict is a
    scripted schedule; ``"file:<path>"`` watches a command file; anything
    with a ``query`` method passes through unchanged.
    """
    if spec is None:
        return None
    if isinstance(spec, dict):
        return ScriptedRMS(spec)
    if isinstance(spec, str):
        kind, _, arg = spec.partition(":")
        if kind == "file" and arg:
            return FileRMS(arg)
        raise ValueError(f"unknown RMS spec {spec!r}; expected 'file:<path>',"
                         " a {{step: target}} dict, or an RMSConnector")
    if isinstance(spec, RMSConnector):
        return spec
    raise TypeError(f"{spec!r} does not implement RMSConnector.query")
