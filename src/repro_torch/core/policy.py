"""Malleability policies — Algorithm 2 (paper §5.1) plus a pluggable framework.

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

* ``Policy`` — the protocol the runner-side ``PolicyRMS`` programs
  against: when a running malleable job should *grow or shrink*
  (``decide``).  Three built-ins (see ``POLICIES``): the paper's
  Algorithm 2, an energy-aware shrink-first policy built on the Appendix-B
  idle/loaded wattage model, and a throughput-greedy policy.  The JAX
  package's policies also order a scheduler's queue; the port has no
  scheduler yet, so its policies only decide resizes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Protocol, Sequence, Union

from repro_torch.core.params import (MalleabilityParams, expansion_target,
                               shrink_target)


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
    """What ``PolicyRMS`` needs from a malleability policy."""

    name: str

    def decide(self, current: int, params: MalleabilityParams,
               cluster: ClusterView) -> Action:
        """Grow/shrink decision for one running malleable job."""
        ...


class BasePolicy:
    name = "base"

    def decide(self, current: int, params: MalleabilityParams,
               cluster: ClusterView) -> Action:
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}(name={self.name!r})"


class Algorithm2Policy(BasePolicy):
    """The paper's §5.1 policy: the Algorithm-2 expand/shrink rules (never
    shrinks below preferred)."""

    name = "algorithm2"

    def decide(self, current: int, params: MalleabilityParams,
               cluster: ClusterView) -> Action:
        return decide(current, params, cluster)


class EnergyAwarePolicy(BasePolicy):
    """Energy-aware shrink-first policy (Appendix-B wattage model).

    Each legal size ``p`` is scored by the job's incremental energy to
    completion, with ``t(p) = p ** -0.5`` (a generic sublinear-scaling
    proxy: the runner knows no per-job cost model)::

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
                 nodes: int = 128):
        self.idle_w = idle_w
        self.loaded_w = loaded_w
        self.nodes = nodes

    def job_energy(self, p: int, queue_empty: bool) -> float:
        watts = p * (self.loaded_w - self.idle_w)
        if queue_empty:
            watts += self.nodes * self.idle_w
        return 1.0 / p ** 0.5 * watts

    def decide(self, current: int, params: MalleabilityParams,
               cluster: ClusterView) -> Action:
        queue_empty = not cluster.pending_min_sizes
        best = min(params.legal_sizes(),
                   key=lambda p: self.job_energy(p, queue_empty))
        if best > current:
            tgt = min(best, expansion_target(current, params,
                                             cluster.available))
            if tgt > current:
                return Action("expand", tgt)
        elif best < current:
            return Action("shrink", best)
        return Action.none(current)


class ThroughputGreedyPolicy(BasePolicy):
    """Throughput-greedy: backfill-aggressive resizes.

    Running jobs shrink as deep as ``min_procs`` — not just to preferred —
    whenever the release would let the cheapest pending job start; with an
    empty queue they grab every idle worker up to ``max_procs``.
    """

    name = "throughput"

    def decide(self, current: int, params: MalleabilityParams,
               cluster: ClusterView) -> Action:
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
    # the aliases the JAX package's benchmarks and CLI flags use
    "energy-aware": EnergyAwarePolicy,
    "throughput-greedy": ThroughputGreedyPolicy,
}


def validate_policy(policy: Policy) -> Policy:
    """Check a policy instance has a callable ``decide`` before the runner
    consults it, so a missing method fails here and not at a resize."""
    if not callable(getattr(policy, "decide", None)):
        raise TypeError(
            f"policy {policy!r} has no callable decide(); see "
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
