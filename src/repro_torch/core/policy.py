"""Malleability policies — Algorithm 2 (paper §5.1) plus a pluggable framework
(port of ``repro/core/policy.py``).

The module has two layers:

* ``decide`` — the paper's Algorithm-2 resize policy, verbatim.  A policy
  sees a *cluster view* (available workers, pending queue) and a *job view*
  (current / preferred / limits) and returns one of {expand, shrink, none}.
  It is deliberately identical in structure to the paper's pseudo-code so
  the workload studies reproduce its decisions:

    1: if current < preferred then
    2:     if avail_resources then return expand
    3: else
    4:     if pending_jobs then
    5:         if current > preferred then
    6:             if an additional job can be initiated then return shrink
    7:         else
    8:             if avail_resources then return expand
    9:     else
   10:         if avail_resources then return expand

* ``Policy`` — the protocol the discrete-event scheduler
  (``rms/scheduler.py``) and the runner-side ``PolicyRMS`` program against.  A policy owns three
  decisions: how to *order the pending queue* (``priority_key``), whether to
  *backfill* past a blocked queue head (``backfill``), and when a running
  malleable job should *grow or shrink* (``decide``).  Three built-ins ship
  with the repo (see ``POLICIES``): the paper's age-based multifactor
  Algorithm 2, an energy-aware shrink-first policy built on the Appendix-B
  idle/loaded wattage model, and a throughput-greedy SJF/backfill-aggressive
  policy.  The JAX package's ``docs/policies.md`` documents the framework.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Protocol, Sequence, Tuple, Union

from repro_torch.core.params import MalleabilityParams, expansion_target


@dataclasses.dataclass(frozen=True)
class Action:
    kind: str                 # "expand" | "shrink" | "none"
    target: int               # worker count after the action

    @staticmethod
    def none(current: int) -> "Action":
        return Action("none", current)


@dataclasses.dataclass(frozen=True)
class ClusterView:
    available: int                       # idle workers
    pending_min_sizes: Sequence[int]     # min worker count of each queued job
    # workers other running malleable jobs could release by shrinking to
    # their preferred sizes. Line 6's "an additional job can be initiated"
    # is evaluated cluster-wide: each job's shrink is admissible when the
    # POOLED prospective releases unblock a pending job (otherwise no job
    # ever moves first on a saturated cluster — see DESIGN.md §9).
    reclaimable_others: int = 0


def reclaimable_workers(tenants, exclude=None) -> int:
    """Workers the *other* running malleable jobs could release by
    shrinking to their preferred sizes — ``ClusterView.reclaimable_others``
    as both the simulator engines and the live ``dmr.Cluster`` define it.

    ``tenants`` yields duck-typed running jobs exposing ``nprocs``,
    ``malleable`` and malleability params at ``.app.params``.  Tenants
    flagged ``reclaim_opaque`` (composite serving fleets, whose internal
    occupancy the cluster cannot see and whose shrinks may land partial)
    are excluded — their excess must never enter another job's line-6
    shrink arithmetic."""
    return sum(max(0, t.nprocs - t.app.params.preferred)
               for t in tenants
               if t is not exclude and getattr(t, "malleable", False)
               and not getattr(t, "reclaim_opaque", False))


def live_view(*, available: int, pending_min_sizes: Sequence[int],
              tenants, exclude=None) -> ClusterView:
    """The ClusterView one running job sees, built from live co-tenants:
    idle workers, the pending queue's minimum requests, and the pooled
    reclaimable workers of every *other* running malleable job.  One
    definition serves the reference simulator engine and ``dmr.Cluster``
    (the fast engine maintains the same quantities incrementally)."""
    return ClusterView(available=available,
                       pending_min_sizes=list(pending_min_sizes),
                       reclaimable_others=reclaimable_workers(tenants,
                                                              exclude))


def decide(current: int, params: MalleabilityParams,
           cluster: ClusterView) -> Action:
    """Algorithm 2."""
    def try_expand(cap: Optional[int] = None) -> Optional[Action]:
        if cluster.available > 0:
            tgt = expansion_target(current, params, cluster.available)
            if cap is not None:
                tgt = min(tgt, max(cap, current))
            if tgt > current:
                return Action("expand", tgt)
        return None

    # line 1-2: running below preferred (moldable under-allocation) — grow
    # toward preferred; growth beyond it is line 10's business (empty queue).
    if current < params.preferred:
        act = try_expand(cap=params.preferred)
        return act or Action.none(current)

    # line 4: pending jobs exist
    if cluster.pending_min_sizes:
        if current > params.preferred:
            # line 6: shrink if the released workers let a pending job start.
            # Any legal size in [preferred, current) is admissible (divisors
            # of the parent count, §6); pick the LARGEST one that unblocks a
            # pending job — least disruption that still serves the queue.
            pool = cluster.available + cluster.reclaimable_others
            candidates = sorted(
                (s for s in params.legal_sizes()
                 if params.preferred <= s < current), reverse=True)
            for tgt in candidates:
                released = current - tgt
                if any(released + pool >= m
                       for m in cluster.pending_min_sizes):
                    return Action("shrink", tgt)
        else:
            # line 8: grow toward (not past) preferred while others queue —
            # expanding past preferred here would fight line 6 forever.
            act = try_expand(cap=params.preferred)
            if act:
                return act
        return Action.none(current)

    # line 10: idle resources, empty queue -> grow toward the upper limit
    act = try_expand()
    return act or Action.none(current)


# ======================================================================
# Pluggable policy framework
# ======================================================================

class Policy(Protocol):
    """What the scheduler / PolicyRMS need from a malleability policy.

    ``job`` arguments are duck-typed: any object exposing the simulator's
    ``Job`` surface (``submit_time``, ``boosted``, ``remaining_work`` and an
    ``app`` with ``exec_time(p)`` / ``params``).  Runner-side callers that
    have no Job pass ``job=None`` and policies must degrade gracefully.
    """

    name: str
    backfill: bool                    # scan past a blocked queue head?
    #: True -> ``priority_key`` depends on ``now`` (queue priorities age);
    #: the fast engine then re-keys its queue index at every scheduling
    #: pass instead of indexing keys once at enqueue time.
    dynamic_priority: bool
    #: True -> ``decide`` is a pure function of (current, params, cluster
    #: view) plus *static* job attributes (``app``, ``params``); it must not
    #: read mutable job state (``remaining_work``, ``boosted``) or retain
    #: state across calls.  It additionally licenses the fast engine to
    #: (1) memoize no-op decisions until the cluster state changes and
    #: (2) present ``cluster.pending_min_sizes`` as a duplicate-collapsed
    #: multiset summary (``len``/``bool`` are the true queue size;
    #: iteration yields distinct sizes ascending).  A policy whose decision
    #: depends on duplicate multiplicities or per-job queue entries must
    #: set this False — it then always sees the literal per-job list.
    decide_stateless: bool

    def configure(self, cfg) -> None:
        """Bind cluster constants (node count, wattage) from a SimConfig-like
        object before a run.  Must be idempotent."""
        ...

    def priority_key(self, job, now: float) -> Tuple:
        """Sort key for the pending queue (smaller = scheduled first)."""
        ...

    def decide(self, current: int, params: MalleabilityParams,
               cluster: ClusterView, job=None) -> Action:
        """Grow/shrink decision for one running malleable job."""
        ...


class BasePolicy:
    """Default behaviors shared by the built-ins: age-based multifactor
    priority (post-shrink beneficiaries first, then FCFS age) and backfill
    enabled, matching the paper's sched/backfill Slurm setup."""

    name = "base"
    backfill = True
    dynamic_priority = False          # keys below don't age with `now`
    decide_stateless = True           # decide() is pure in its arguments

    def configure(self, cfg) -> None:        # pragma: no cover - trivial
        pass

    def priority_key(self, job, now: float) -> Tuple:
        return (not getattr(job, "boosted", False), job.submit_time)

    def decide(self, current: int, params: MalleabilityParams,
               cluster: ClusterView, job=None) -> Action:
        raise NotImplementedError

    def choose_scale_path(self, job) -> str:
        """How a serving fleet should realize an expand this policy just
        decided: ``"in-place"`` grows a live replica's mesh through
        ``dmr.reconfig`` (warm — ready after ``grow_ticks``),
        ``"replica"`` cold-starts a new replica (``cold_start_ticks`` of
        no service).  Batch policies default to whole replicas; the
        latency policies of the serving fleet
        (``repro_torch/serve/slo.py``) override this."""
        return "replica"

    def __repr__(self):
        return f"{type(self).__name__}(name={self.name!r})"


class Algorithm2Policy(BasePolicy):
    """The paper's §5.1 policy: age-based multifactor priority + the
    Algorithm-2 expand/shrink rules (never shrinks below preferred)."""

    name = "algorithm2"

    def decide(self, current: int, params: MalleabilityParams,
               cluster: ClusterView, job=None) -> Action:
        return decide(current, params, cluster)


class EnergyAwarePolicy(BasePolicy):
    """Energy-aware shrink-first policy (Appendix-B wattage model).

    Each legal size ``p`` is scored by the job's incremental energy to
    completion::

        E(p) = t(p) * [ p * (loaded_w - idle_w)  (+ nodes * idle_w if the
                        queue is empty, i.e. the job drives the makespan) ]

    With pending jobs the idle term is dropped (freed nodes are immediately
    re-allocated, not idled), which pushes the optimum toward ``min_procs``:
    the policy sheds workers eagerly — below *preferred*, unlike Algorithm 2
    — releasing them both to the queue and to the power budget.  On an idle
    cluster the ``nodes * idle_w`` makespan term rewards finishing sooner,
    so well-scaling apps grow while poorly-scaling ones (n-body) hold small.
    """

    name = "energy"

    def __init__(self, idle_w: float = 100.0, loaded_w: float = 340.0,
                 nodes: int = 128,
                 cost_fn: Optional[Callable[[int], float]] = None):
        self.idle_w = idle_w
        self.loaded_w = loaded_w
        self.nodes = nodes
        self.cost_fn = cost_fn           # runner-side fallback, see _exec_time

    def configure(self, cfg) -> None:
        self.idle_w = getattr(cfg, "idle_w", self.idle_w)
        self.loaded_w = getattr(cfg, "loaded_w", self.loaded_w)
        self.nodes = getattr(cfg, "nodes", self.nodes)

    def _exec_time(self, p: int, job) -> float:
        if job is not None:
            return job.app.exec_time(p)
        if self.cost_fn is not None:
            return self.cost_fn(p)
        return 1.0 / p ** 0.5            # generic sublinear-scaling proxy

    def job_energy(self, p: int, job, queue_empty: bool) -> float:
        watts = p * (self.loaded_w - self.idle_w)
        if queue_empty:
            watts += self.nodes * self.idle_w
        return self._exec_time(p, job) * watts

    def decide(self, current: int, params: MalleabilityParams,
               cluster: ClusterView, job=None) -> Action:
        queue_empty = not cluster.pending_min_sizes
        best = min(params.legal_sizes(),
                   key=lambda p: self.job_energy(p, job, queue_empty))
        if best > current:
            tgt = min(best, expansion_target(current, params,
                                             cluster.available))
            if tgt > current:
                return Action("expand", tgt)
        elif best < current:
            return Action("shrink", best)
        return Action.none(current)


class ThroughputGreedyPolicy(BasePolicy):
    """Throughput-greedy: SJF queue ordering + backfill-aggressive resizes.

    Pending queue is ordered by estimated remaining service time at the
    preferred size (shortest-job-first maximizes completed jobs/s).  Running
    jobs shrink as deep as ``min_procs`` — not just to preferred — whenever
    the release would let the cheapest pending job start; with an empty
    queue they grab every idle worker up to ``max_procs``.
    """

    name = "throughput"

    def priority_key(self, job, now: float) -> Tuple:
        service = job.app.exec_time(job.app.params.preferred) \
            * getattr(job, "remaining_work", 1.0)
        return (not getattr(job, "boosted", False), service, job.submit_time)

    def decide(self, current: int, params: MalleabilityParams,
               cluster: ClusterView, job=None) -> Action:
        if cluster.pending_min_sizes:
            need = min(cluster.pending_min_sizes)
            # largest shrink target whose release unblocks the cheapest
            # pending job — least self-harm that still serves the queue
            for tgt in sorted((s for s in params.legal_sizes()
                               if s < current), reverse=True):
                if current - tgt + cluster.available >= need:
                    return Action("shrink", tgt)
            return Action.none(current)
        tgt = expansion_target(current, params, cluster.available)
        if tgt > current:
            return Action("expand", tgt)
        return Action.none(current)


POLICIES = {
    Algorithm2Policy.name: Algorithm2Policy,
    EnergyAwarePolicy.name: EnergyAwarePolicy,
    ThroughputGreedyPolicy.name: ThroughputGreedyPolicy,
    # common aliases used by benchmarks / CLI flags
    "energy-aware": EnergyAwarePolicy,
    "throughput-greedy": ThroughputGreedyPolicy,
}


def validate_policy(policy: Policy) -> Policy:
    """Check a policy instance implements the callable core of the
    :class:`Policy` protocol (``decide`` + ``priority_key``) before the
    engines start consulting it — a missing method would otherwise
    surface as an ``AttributeError`` deep inside a scheduling loop.
    The deeper contract (``decide_stateless`` honesty, no hidden state)
    is checked statically by the JAX package's ``repro.analysis`` lint
    (rule DMR102), which the port does not have yet."""
    for attr in ("decide", "priority_key"):
        if not callable(getattr(policy, attr, None)):
            raise TypeError(
                f"policy {policy!r} has no callable {attr}(); see "
                f"repro_torch.core.policy.Policy (or subclass BasePolicy)")
    return policy


def get_policy(policy: Union[str, Policy, None]) -> Policy:
    """Resolve a policy name / instance / None (-> Algorithm 2)."""
    if policy is None:
        return Algorithm2Policy()
    if isinstance(policy, str):
        try:
            return POLICIES[policy]()
        except KeyError:
            raise KeyError(
                f"unknown policy {policy!r}; known: {sorted(POLICIES)}")
    return validate_policy(policy)
