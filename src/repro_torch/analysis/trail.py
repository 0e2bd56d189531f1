"""Schedule-trail race detector (port of ``repro/analysis/trail.py``, the
dynamic half of ``repro_torch.analysis``; ``lint.py`` is the static half).

The cluster's correctness-critical core is resource accounting: devices
move between the shared idle pool and tenants only through grants and
releases, resizes must agree with the devices a job actually holds, and
the §3.2 inhibitor windows bound how often a job may be resized.  The
historical bugs this subsystem guards against were all silent contract
violations — the undersized-mesh class (a resize target larger
than the job's live pool) and dropped-decision class among them.

A **trail** is the flat event stream a ``dmr.Cluster`` records while
``audit`` / ``sanitize`` / ``record_trail`` is on (both engines record
identical trails — the differential harness asserts it)::

    ("start",   jid, procs,                               tick)
    ("grant",   jid, (device ids...),                     tick)
    ("release", jid, (device ids...),                     tick)
    ("resize",  jid, (step, kind, from_procs, to_procs),  tick)
    ("finish",  jid, final_procs,                         tick)

The serving fleet (``repro_torch.serve.replica.ReplicaSet``) records the
same stream with replica-lifecycle kinds — a replica is a job whose
grant/release happens atomically with its up/down — plus the in-place
mesh-resize event::

    ("replica-up",   rid, (device ids...),                tick)
    ("replica-down", rid, (device ids...),                tick)
    ("request-drop", rid, (request id, wait_s, deadline_s), tick)
    ("replica-resize", rid, (step, kind, from_devs, to_devs,
                             active_seqs, slots_per_device), tick)

**Delegation namespacing** — when a whole fleet runs as one composite
tenant inside a ``dmr.Cluster`` (``repro_torch/serve/tenant.py``), its
internal events land in the *cluster's* trail with replica ids namespaced as
``(parent_jid + 1) * SUB_JID_BASE + rid``.  The auditor recognizes the
namespace (:func:`parent_of`) and tracks those grants in a *delegation
ledger*: a delegated device must be owner-held by the parent tenant and
not already delegated, top-level ownership is untouched (conservation
still balances), and a parent releasing a still-delegated device to the
cluster pool is flagged.

:class:`TrailAuditor` consumes a trail one event at a time and checks
the happens-before / interval contract:

==================== ==================================================
violation kind       meaning
==================== ==================================================
``double-grant``     a device granted while another job (or the same
                     job) still holds it
``unknown-device``   a granted id that is not in the cluster pool
``bad-release``      a release of a device the job does not hold —
                     covers release-before-grant, non-owner release
                     and double-release (use-after-release)
``leaked-devices``   a job finished (or the trail ended) with devices
                     never returned to the pool
``pool-conservation`` free + held diverged from the pool (live mode)
``double-start``     a jid started twice without finishing
``rigid-start-size`` a non-moldable job started below ``max_procs``
``start-out-of-range`` a start size outside ``[min_procs, max_procs]``
``rigid-resize``     a resize event for a ``malleable=False`` job
``resize-out-of-range`` a resize target outside the job's legal sizes
``undersized-mesh``  ``to_procs`` exceeds the devices the job holds
                     (a mesh bigger than its pool)
``chain-continuity`` ``from_procs`` disagrees with the job's tracked
                     size (a dropped or reordered resize)
``inhibitor-violation`` consecutive resizes closer than the job's
                     ``sched_iterations`` window (policy mode only —
                     cosim boundary drain legitimately compresses
                     events onto one step, so spacing is not checked
                     when ``decisions="cosim"``)
``resize-before-start`` / ``resize-after-finish`` / ``finish-before-
start`` / ``double-finish`` / ``final-procs-mismatch``
                     lifecycle ordering violations
``replica-already-up`` a serving replica brought up twice without an
                     intervening ``replica-down``
``replica-not-up``   a ``replica-down`` (or a drop attributed to a
                     replica) for a replica that is not up
``premature-drop``   a request dropped before its deadline elapsed —
                     goodput thrown away that the queue still owed
``replica-resize-not-up`` an in-place mesh resize on a replica that is
                     not live (never up, or already torn down)
``grow-exceeds-grant`` an in-place grow to more devices than the
                     replica actually holds — the fleet resized a mesh
                     past its (delegated) grant
``shrink-below-active`` an in-place shrink whose surviving slot count
                     (``to_devs x slots_per_device``) is smaller than
                     the replica's active batch — admitted sequences
                     would be evicted mid-decode
``delegation-outside-grant`` a composite fleet delegated a device its
                     parent tenant does not hold
==================== ==================================================

Offline use (trace scale — the checker is O(events), never O(pool x
ticks), so a 100k–1M-job ``Cluster.sched_only`` replay audits in
seconds)::

    violations = audit_trail(cluster.trail, cluster._pool_ids,
                             jobs=job_metadata(cluster))
    assert violations == []

Live use — ``Cluster(sanitize=True)`` feeds the same auditor as events
happen and it raises :class:`TrailViolation` at the first bad event,
turning a silent accounting bug into an immediate, located failure.

:func:`audit_grant_log` is the promoted pool-accounting invariant the
differential tests used to hand-roll; :func:`audit_resize_log` is the
same contract for the discrete-event simulator's ``resize_log``
(``SimResult.audit()``).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Violation", "TrailViolation", "JobMeta", "TrailAuditor",
    "audit_trail", "audit_grant_log", "audit_resize_log",
    "job_metadata", "dump_trail", "load_trail", "audit_trail_file",
    "SUB_JID_BASE", "parent_of",
]

#: Namespace stride for composite-tenant child events: replica ``rid``
#: of parent tenant ``jid`` appears in the cluster trail as
#: ``(jid + 1) * SUB_JID_BASE + rid``.
SUB_JID_BASE = 1_000_000


def parent_of(jid: int) -> Optional[int]:
    """Parent tenant of a namespaced child jid, or ``None`` for a
    top-level jid."""
    return jid // SUB_JID_BASE - 1 if jid >= SUB_JID_BASE else None


@dataclasses.dataclass(frozen=True)
class Violation:
    """One detected contract violation, locatable in the trail."""
    kind: str
    jid: int
    tick: float
    detail: str

    def __str__(self) -> str:
        return f"[{self.kind}] jid={self.jid} tick={self.tick}: {self.detail}"


class TrailViolation(RuntimeError):
    """Raised by a live (``sanitize=True``) auditor at the first bad
    event; carries the :class:`Violation`."""

    def __init__(self, violation: Violation):
        super().__init__(str(violation))
        self.violation = violation


@dataclasses.dataclass(frozen=True)
class JobMeta:
    """What the auditor needs to know about a job to check its events.

    Everything defaults to maximally permissive, so a trail can be
    audited with partial (or no) job metadata — detectors that need a
    field simply do not fire for jobs that lack it."""
    malleable: bool = True
    moldable: bool = True
    min_procs: int = 1
    max_procs: int = 1 << 30
    sched_iterations: int = 0


class TrailAuditor:
    """Incremental happens-before checker over a cluster trail.

    ``live=True`` raises :class:`TrailViolation` at the first violation
    (the ``Cluster(sanitize=True)`` mode); ``live=False`` collects every
    violation into ``self.violations`` for offline reporting.

    ``check_spacing=False`` disables the inhibitor-window detector —
    required for ``decisions="cosim"`` trails, where the completion
    boundary drain replays multiple simulator decisions at one step.
    """

    def __init__(self, pool_ids: Iterable[int], *,
                 jobs: Optional[Dict[int, JobMeta]] = None,
                 check_spacing: bool = True, live: bool = False):
        self.pool = frozenset(pool_ids)
        self.jobs = dict(jobs) if jobs else {}
        self.check_spacing = check_spacing
        self.live = live
        self.owner: Dict[int, int] = {}           # device id -> holder jid
        self.held: Dict[int, set] = {}            # jid -> device id set
        #: delegation ledger: device id -> namespaced child jid holding
        #: it *within* its parent tenant's grant (composite fleets)
        self.sub_owner: Dict[int, int] = {}
        self.current: Dict[int, int] = {}         # jid -> tracked size
        self.started: set = set()
        self.finished: set = set()
        self.last_resize_step: Dict[int, int] = {}
        self.n_events = 0
        self.violations: List[Violation] = []

    # ------------------------------------------------------------------
    def _flag(self, kind: str, jid: int, tick, detail: str) -> None:
        v = Violation(kind, jid, tick, detail)
        if self.live:
            raise TrailViolation(v)
        self.violations.append(v)

    def _meta(self, jid: int) -> JobMeta:
        return self.jobs.get(jid, _DEFAULT_META)

    # ------------------------------------------------------------------
    def feed(self, event: Tuple) -> None:
        """Consume one ``(kind, jid, payload, tick)`` trail event."""
        kind, jid, payload, tick = event
        self.n_events += 1
        if kind == "grant":
            self.on_grant(jid, payload, tick)
        elif kind == "release":
            self.on_release(jid, payload, tick)
        elif kind == "resize":
            self.on_resize(jid, *payload, tick=tick)
        elif kind == "start":
            self.on_start(jid, payload, tick)
        elif kind == "finish":
            self.on_finish(jid, payload, tick)
        elif kind == "replica-up":
            self.on_replica_up(jid, payload, tick)
        elif kind == "replica-down":
            self.on_replica_down(jid, payload, tick)
        elif kind == "request-drop":
            self.on_request_drop(jid, payload, tick)
        elif kind == "replica-resize":
            self.on_replica_resize(jid, *payload, tick=tick)
        else:
            self._flag("unknown-event", jid, tick,
                       f"unrecognized trail event kind {kind!r}")

    # ------------------------------------------------------------------
    def on_start(self, jid: int, procs: int, tick) -> None:
        if jid in self.started and jid not in self.finished:
            self._flag("double-start", jid, tick,
                       f"started again at {procs} workers while running")
        meta = self._meta(jid)
        if not meta.moldable and procs != meta.max_procs:
            self._flag("rigid-start-size", jid, tick,
                       f"rigid job started at {procs} != "
                       f"max_procs={meta.max_procs}")
        elif not meta.min_procs <= procs <= meta.max_procs:
            self._flag("start-out-of-range", jid, tick,
                       f"start size {procs} outside "
                       f"[{meta.min_procs}, {meta.max_procs}]")
        self.started.add(jid)
        self.finished.discard(jid)
        self.current[jid] = procs
        self.last_resize_step.pop(jid, None)

    def on_grant(self, jid: int, ids: Sequence[int], tick) -> None:
        parent = parent_of(jid)
        if parent is not None:
            self._delegated_grant(jid, parent, ids, tick)
            return
        mine = self.held.setdefault(jid, set())
        seen = set()
        for d in ids:
            if d in seen:
                self._flag("double-grant", jid, tick,
                           f"device {d} appears twice in one grant")
                continue
            seen.add(d)
            if d not in self.pool:
                self._flag("unknown-device", jid, tick,
                           f"granted device {d} is not in the cluster pool")
                continue
            holder = self.owner.get(d)
            if holder is not None:
                self._flag("double-grant", jid, tick,
                           f"device {d} granted while held by jid {holder}")
                continue
            self.owner[d] = jid
            mine.add(d)

    def on_release(self, jid: int, ids: Sequence[int], tick) -> None:
        if parent_of(jid) is not None:
            self._delegated_release(jid, ids, tick)
            return
        mine = self.held.get(jid, set())
        for d in ids:
            if self.owner.get(d) != jid:
                holder = self.owner.get(d)
                what = (f"held by jid {holder}" if holder is not None
                        else "not held by anyone")
                self._flag("bad-release", jid, tick,
                           f"released device {d} it does not hold ({what})")
                continue
            sub = self.sub_owner.get(d)
            if sub is not None:
                self._flag("bad-release", jid, tick,
                           f"released device {d} while replica {sub} "
                           f"still runs on it (delegation not withdrawn)")
                continue
            del self.owner[d]
            mine.discard(d)

    # -- the delegation ledger (composite fleets inside a cluster) ------
    def _delegated_grant(self, jid: int, parent: int,
                         ids: Sequence[int], tick) -> None:
        """A namespaced grant hands a slice of the *parent tenant's*
        grant to one of its replicas: top-level ownership is untouched,
        the delegation ledger tracks the inner assignment."""
        mine = self.held.setdefault(jid, set())
        seen = set()
        for d in ids:
            if d in seen:
                self._flag("double-grant", jid, tick,
                           f"device {d} appears twice in one grant")
                continue
            seen.add(d)
            if d not in self.pool:
                self._flag("unknown-device", jid, tick,
                           f"granted device {d} is not in the cluster pool")
                continue
            if self.owner.get(d) != parent:
                holder = self.owner.get(d)
                what = (f"held by jid {holder}" if holder is not None
                        else "idle")
                self._flag("delegation-outside-grant", jid, tick,
                           f"fleet {parent} delegated device {d} it does "
                           f"not hold ({what})")
                continue
            sub = self.sub_owner.get(d)
            if sub is not None:
                self._flag("double-grant", jid, tick,
                           f"device {d} already delegated to replica "
                           f"{sub}")
                continue
            self.sub_owner[d] = jid
            mine.add(d)

    def _delegated_release(self, jid: int, ids: Sequence[int],
                           tick) -> None:
        mine = self.held.get(jid, set())
        for d in ids:
            if self.sub_owner.get(d) != jid:
                sub = self.sub_owner.get(d)
                what = (f"delegated to replica {sub}" if sub is not None
                        else "not delegated to anyone")
                self._flag("bad-release", jid, tick,
                           f"released device {d} it does not hold ({what})")
                continue
            del self.sub_owner[d]
            mine.discard(d)

    def on_resize(self, jid: int, step: int, kind: str,
                  from_procs: int, to_procs: int, *, tick) -> None:
        if jid not in self.started:
            self._flag("resize-before-start", jid, tick,
                       f"resize at step {step} before any start")
        elif jid in self.finished:
            self._flag("resize-after-finish", jid, tick,
                       f"resize at step {step} after completion")
        meta = self._meta(jid)
        if not meta.malleable:
            self._flag("rigid-resize", jid, tick,
                       f"{kind} {from_procs}->{to_procs} on a "
                       f"malleable=False job")
        if not meta.min_procs <= to_procs <= meta.max_procs:
            self._flag("resize-out-of-range", jid, tick,
                       f"target {to_procs} outside "
                       f"[{meta.min_procs}, {meta.max_procs}]")
        tracked = self.current.get(jid)
        if tracked is not None and from_procs != tracked:
            self._flag("chain-continuity", jid, tick,
                       f"resize claims from_procs={from_procs} but the "
                       f"job's tracked size is {tracked} (dropped or "
                       f"reordered event?)")
        # the undersized-mesh class: a mesh larger than the devices the job
        # actually holds.  Grants precede the expand event in a valid
        # trail, so to_procs must already fit the held set.
        if jid in self.held and to_procs > len(self.held[jid]):
            self._flag("undersized-mesh", jid, tick,
                       f"resize to {to_procs} workers but the job holds "
                       f"only {len(self.held[jid])} devices")
        if self.check_spacing and meta.sched_iterations:
            window = max(meta.sched_iterations, 1)
            last = self.last_resize_step.get(jid)
            if last is not None and step - last < window:
                self._flag("inhibitor-violation", jid, tick,
                           f"resizes at steps {last} and {step} are "
                           f"closer than the sched_iterations="
                           f"{meta.sched_iterations} window")
        self.last_resize_step[jid] = step
        self.current[jid] = to_procs

    def on_finish(self, jid: int, final_procs: int, tick) -> None:
        if jid not in self.started:
            self._flag("finish-before-start", jid, tick,
                       "finish event for a job that never started")
            return
        if jid in self.finished:
            self._flag("double-finish", jid, tick, "finished twice")
            return
        leftover = self.held.get(jid)
        if leftover:
            self._flag("leaked-devices", jid, tick,
                       f"finished still holding devices "
                       f"{sorted(leftover)}")
        tracked = self.current.get(jid)
        if tracked is not None and tracked != final_procs:
            self._flag("final-procs-mismatch", jid, tick,
                       f"final_procs={final_procs} but the resize chain "
                       f"ends at {tracked}")
        self.finished.add(jid)

    # -- serving-fleet replica lifecycle -----------------------
    def on_replica_up(self, rid: int, ids: Sequence[int], tick) -> None:
        """A replica coming live is a start + grant in one event: the
        device handoff is atomic with the lifecycle transition."""
        if rid in self.started and rid not in self.finished:
            self._flag("replica-already-up", rid, tick,
                       f"replica brought up again with devices "
                       f"{sorted(ids)} while already up")
        meta = self._meta(rid)
        n = len(ids)
        if not meta.min_procs <= n <= meta.max_procs:
            self._flag("start-out-of-range", rid, tick,
                       f"replica size {n} outside "
                       f"[{meta.min_procs}, {meta.max_procs}]")
        self.started.add(rid)
        self.finished.discard(rid)
        self.current[rid] = n
        self.on_grant(rid, ids, tick)

    def on_replica_down(self, rid: int, ids: Sequence[int], tick) -> None:
        if rid not in self.started or rid in self.finished:
            self._flag("replica-not-up", rid, tick,
                       "replica-down for a replica that is not up")
        self.on_release(rid, ids, tick)
        leftover = self.held.get(rid)
        if leftover:
            self._flag("leaked-devices", rid, tick,
                       f"replica went down still holding devices "
                       f"{sorted(leftover)}")
        self.finished.add(rid)

    def on_replica_resize(self, rid: int, step: int, kind: str,
                          from_devs: int, to_devs: int, active_seqs: int,
                          slots_per_device: int, *, tick) -> None:
        """An in-place mesh resize of a live serving replica —
        the serving fleet's ``dmr.reconfig`` path.  Grants precede grows
        and releases follow shrinks, so the held set brackets
        ``to_devs`` on both sides of the event."""
        if rid not in self.started or rid in self.finished:
            self._flag("replica-resize-not-up", rid, tick,
                       f"{kind} {from_devs}->{to_devs} on a replica that "
                       f"is not live")
        meta = self._meta(rid)
        if not meta.min_procs <= to_devs <= meta.max_procs:
            self._flag("resize-out-of-range", rid, tick,
                       f"target {to_devs} outside "
                       f"[{meta.min_procs}, {meta.max_procs}]")
        tracked = self.current.get(rid)
        if tracked is not None and from_devs != tracked:
            self._flag("chain-continuity", rid, tick,
                       f"resize claims from_devs={from_devs} but the "
                       f"replica's tracked size is {tracked}")
        if rid in self.held and to_devs > len(self.held[rid]):
            self._flag("grow-exceeds-grant", rid, tick,
                       f"in-place grow to {to_devs} devices but the "
                       f"replica holds only {len(self.held[rid])}")
        if kind == "shrink" and active_seqs > to_devs * slots_per_device:
            self._flag("shrink-below-active", rid, tick,
                       f"shrink to {to_devs} devices leaves "
                       f"{to_devs * slots_per_device} slots for "
                       f"{active_seqs} active sequences")
        self.current[rid] = to_devs

    def on_request_drop(self, rid: int, payload: Sequence, tick) -> None:
        """``payload = (request id, wait_s, deadline_s)``; ``rid`` is the
        holding replica, or -1 for a drop out of the waiting queue."""
        req_id, wait_s, deadline_s = payload
        if rid >= 0 and (rid not in self.started or rid in self.finished):
            self._flag("replica-not-up", rid, tick,
                       f"request {req_id} dropped by a replica that is "
                       f"not up")
        if deadline_s > 0 and wait_s + 1e-9 < deadline_s:
            self._flag("premature-drop", rid, tick,
                       f"request {req_id} dropped after waiting "
                       f"{wait_s:.3f}s, before its {deadline_s:.3f}s "
                       f"deadline")

    # ------------------------------------------------------------------
    def check_conservation(self, n_free: int, tick) -> None:
        """Live-mode conservation: free + held must equal the pool."""
        n_held = len(self.owner)
        if n_free + n_held != len(self.pool):
            self._flag("pool-conservation", -1, tick,
                       f"free={n_free} + held={n_held} != "
                       f"pool={len(self.pool)}")

    def finalize(self, expect_complete: bool = True) -> List[Violation]:
        """End-of-trail checks; returns the collected violations."""
        if expect_complete:
            if self.owner:
                by_jid: Dict[int, List[int]] = {}
                for d, jid in self.owner.items():
                    by_jid.setdefault(jid, []).append(d)
                for jid, ds in sorted(by_jid.items()):
                    self._flag("leaked-devices", jid, -1,
                               f"trail ended with devices {sorted(ds)} "
                               f"never released")
            if self.sub_owner:
                by_sub: Dict[int, List[int]] = {}
                for d, jid in self.sub_owner.items():
                    by_sub.setdefault(jid, []).append(d)
                for jid, ds in sorted(by_sub.items()):
                    self._flag("leaked-devices", jid, -1,
                               f"trail ended with devices {sorted(ds)} "
                               f"still delegated")
            for jid in sorted(self.started - self.finished):
                self._flag("unfinished-job", jid, -1,
                           "trail ended before the job finished")
        return self.violations


_DEFAULT_META = JobMeta()


# ----------------------------------------------------------------------
# offline entry points
# ----------------------------------------------------------------------

def audit_trail(trail: Iterable[Tuple], pool_ids: Iterable[int], *,
                jobs: Optional[Dict[int, JobMeta]] = None,
                check_spacing: bool = True,
                expect_complete: bool = True) -> List[Violation]:
    """Audit a recorded cluster trail offline; returns all violations
    (empty list == clean).  O(events) — trace-scale replays audit in
    seconds."""
    auditor = TrailAuditor(pool_ids, jobs=jobs,
                           check_spacing=check_spacing, live=False)
    for ev in trail:
        auditor.feed(ev)
    return auditor.finalize(expect_complete)


def audit_grant_log(grant_log: Iterable[Tuple], pool_ids: Iterable[int],
                    ) -> List[Violation]:
    """The pool-accounting invariant over a bare ``grant_log`` —
    ``("grant" | "release", jid, (device ids...))`` triples: no
    double-grants, no unknown devices, releases only by the owner, and
    every granted device returned by the end.  This is the checker the
    differential tests used to hand-roll."""
    auditor = TrailAuditor(pool_ids, live=False)
    for kind, jid, ids in grant_log:
        if kind == "grant":
            auditor.on_grant(jid, ids, -1)
        elif kind == "release":
            auditor.on_release(jid, ids, -1)
        else:
            auditor._flag("unknown-event", jid, -1,
                          f"unrecognized grant-log kind {kind!r}")
    if auditor.owner:
        by_jid: Dict[int, List[int]] = {}
        for d, jid in auditor.owner.items():
            by_jid.setdefault(jid, []).append(d)
        for jid, ds in sorted(by_jid.items()):
            auditor._flag("leaked-devices", jid, -1,
                          f"devices {sorted(ds)} granted but never "
                          f"released")
    return auditor.violations


def audit_resize_log(records: Iterable, jobs: Iterable = ()) -> List[Violation]:
    """The same contract for the discrete-event simulator's
    ``resize_log`` (``ResizeRecord(t, jid, kind, from_procs,
    to_procs)``): rigid jobs are never resized, per-job chains are
    continuous, timestamps are non-decreasing.  ``jobs`` supplies
    ``.jid`` / ``.malleable`` (a ``SimResult.jobs`` list works as-is)."""
    malleable = {j.jid: bool(j.malleable) for j in jobs}
    violations: List[Violation] = []
    last_t: Dict[int, float] = {}
    size: Dict[int, int] = {}
    for r in records:
        if malleable and not malleable.get(r.jid, True):
            violations.append(Violation(
                "rigid-resize", r.jid, r.t,
                f"{r.kind} {r.from_procs}->{r.to_procs} on a "
                f"malleable=False job"))
        if r.jid in last_t and r.t < last_t[r.jid]:
            violations.append(Violation(
                "non-monotonic-time", r.jid, r.t,
                f"record at t={r.t} after one at t={last_t[r.jid]}"))
        if r.jid in size and r.from_procs != size[r.jid]:
            violations.append(Violation(
                "chain-continuity", r.jid, r.t,
                f"record claims from_procs={r.from_procs} but the "
                f"chain ends at {size[r.jid]}"))
        last_t[r.jid] = r.t
        size[r.jid] = r.to_procs
    return violations


# ----------------------------------------------------------------------
# trail (de)serialization — the CI artifact format
# ----------------------------------------------------------------------

def job_metadata(cluster) -> Dict[int, JobMeta]:
    """Extract per-job :class:`JobMeta` from a ``dmr.Cluster``."""
    return {t.jid: JobMeta(malleable=t.malleable, moldable=t.moldable,
                           min_procs=t.params.min_procs,
                           max_procs=t.params.max_procs,
                           sched_iterations=t.params.sched_iterations)
            for t in cluster.tenants}


def dump_trail(cluster, path: str) -> Dict:
    """Serialize a cluster's recorded trail (plus the pool and job
    metadata the auditor needs) to JSON — the replay-smoke CI artifact.
    Returns the written payload."""
    if cluster.trail is None:
        raise ValueError("no trail recorded — run the cluster with "
                         "audit=True, sanitize=True or record_trail=True")
    payload = {
        "pool_ids": list(cluster._pool_ids),
        "decisions": cluster.decisions,
        "jobs": {str(jid): dataclasses.asdict(meta)
                 for jid, meta in job_metadata(cluster).items()},
        "trail": [[kind, jid, list(p) if isinstance(p, tuple) else p, tick]
                  for kind, jid, p, tick in cluster.trail],
    }
    with open(path, "w") as fh:
        json.dump(payload, fh)
    return payload


def load_trail(path: str) -> Dict:
    """Load a :func:`dump_trail` artifact back into auditor inputs:
    ``{"pool_ids", "decisions", "jobs": {int: JobMeta}, "trail"}``."""
    with open(path) as fh:
        payload = json.load(fh)
    jobs = {int(jid): JobMeta(**meta)
            for jid, meta in payload.get("jobs", {}).items()}
    trail = [(kind, jid, tuple(p) if isinstance(p, list) else p, tick)
             for kind, jid, p, tick in payload.get("trail", [])]
    return {"pool_ids": payload["pool_ids"],
            "decisions": payload.get("decisions", "policy"),
            "jobs": jobs, "trail": trail}


def audit_trail_file(path: str) -> List[Violation]:
    """Audit a serialized trail artifact (the CI gate entry point)."""
    data = load_trail(path)
    return audit_trail(data["trail"], data["pool_ids"], jobs=data["jobs"],
                       check_spacing=data["decisions"] != "cosim")
