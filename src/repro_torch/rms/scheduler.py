"""Slurm-analog discrete-event cluster simulator — two engines, one semantics
(port of ``repro/rms/scheduler.py``; plain Python and numpy, bit-identical
to the JAX package's on the same jobs).

Models the paper's §5 testbed: 128 compute nodes (1 controller excluded),
sched/backfill with a 10-second interval, age-based multifactor priority
without walltime requests, whole-node select/linear allocation, and a
malleability policy evaluated at scheduler ticks for every running
malleable job (honoring per-app inhibitor periods).

Two engines share one semantics (the JAX package's ``docs/simulator.md``):

* ``Simulator`` — the production engine.  Event-indexed throughout: the
  pending queue is a set of lazy-deleted heaps bucketed by minimum request
  (scan cost is proportional to jobs *started*, not queue length), running
  membership is an insertion-ordered dict, allocation / reclaimable-worker
  totals are maintained incrementally, and no-op policy decisions are
  memoized against a cluster-state epoch counter.  Replays 100k-job SWF
  traces in well under a minute.
* ``ReferenceSimulator`` — the original list-based engine: full queue
  re-sort per tick, ``list.remove`` membership, per-job view construction.
  O(n²)-ish but obviously correct; kept as the golden model.  The two
  engines produce bit-identical ``SimResult`` metrics and ``resize_log``
  (``tests/test_torch_rms.py`` holds both against the JAX package's).

The scheduling engine is policy-driven: ``Simulator(jobs, cfg, policy=...)``
accepts any ``repro_torch.core.policy.Policy`` (or registry name).  The policy
owns queue ordering (``priority_key``), backfill behavior (``backfill``),
and the grow/shrink decision (``decide``); the engine owns event handling,
resource accounting and the §3.2 inhibitor periods.  Policies additionally
declare ``dynamic_priority`` (queue keys age with time → the fast engine
rebuilds its heaps instead of indexing them) and ``decide_stateless``
(``decide`` is a pure function of its arguments → no-op decisions may be
memoized).  Default policy is the paper's Algorithm 2.

Resize overhead is charged per the paper's §3.2 findings: dominated by the
data size over the interconnect bandwidth, plus a spawn term growing with the
worker count.  Every resize — policy-driven *and* straggler-mitigation —
goes through one accounting path: a ``ResizeRecord``, the ``n_resizes``
counter, the ``resize_overhead_s`` charge, and a fresh inhibitor window.
"""
from __future__ import annotations

import dataclasses
import heapq
from itertools import islice
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch.core.policy import ClusterView, Policy, get_policy, live_view
from repro_torch.rms.eventindex import MinRequestIndex
from repro_torch.rms.workload import Job


@dataclasses.dataclass
class SimConfig:
    nodes: int = 128
    backfill_interval_s: float = 10.0
    bandwidth_gbps: float = 100.0          # Omni-Path (paper §5)
    spawn_base_s: float = 0.2
    spawn_per_proc_s: float = 0.002
    idle_w: float = 100.0                  # Appendix B
    loaded_w: float = 340.0
    record_timeline: bool = True
    # beyond-paper: straggler model — a slow node throttles its whole job
    # (synchronous iterations); malleable jobs shrink the slow node away.
    straggler_mtbf_s: float = 0.0          # 0 = disabled
    straggler_slowdown: float = 0.6
    straggler_seed: int = 0


@dataclasses.dataclass
class Timeline:
    t: List[float] = dataclasses.field(default_factory=list)
    allocated: List[int] = dataclasses.field(default_factory=list)
    running: List[int] = dataclasses.field(default_factory=list)
    completed: List[int] = dataclasses.field(default_factory=list)

    def as_arrays(self) -> "Timeline":
        """Freeze the per-tick samples into numpy arrays (vectorized form)."""
        return Timeline(t=np.asarray(self.t, dtype=np.float64),
                        allocated=np.asarray(self.allocated, dtype=np.int64),
                        running=np.asarray(self.running, dtype=np.int64),
                        completed=np.asarray(self.completed, dtype=np.int64))


@dataclasses.dataclass(frozen=True)
class ResizeRecord:
    """One resize (policy-driven or straggler mitigation), for audit."""
    t: float
    jid: int
    kind: str                              # "expand" | "shrink"
    from_procs: int
    to_procs: int


@dataclasses.dataclass
class SimResult:
    jobs: List[Job]
    makespan: float
    alloc_rate: float                      # time-averaged allocated fraction
    energy_kwh: float
    n_resizes: int
    resize_overhead_s: float
    timeline: Timeline
    n_stragglers: int = 0
    n_straggler_mitigations: int = 0
    resize_log: List[ResizeRecord] = dataclasses.field(default_factory=list)

    def mean(self, fn) -> float:
        if not self.jobs:                  # np.mean([]) warns and returns NaN
            return 0.0
        return float(np.mean([fn(j) for j in self.jobs]))

    def audit(self) -> List:
        """Offline resize-log audit (``repro_torch.analysis``): rigid jobs are
        never resized, per-job from/to chains are continuous, record
        timestamps are non-decreasing.  Returns the violations (empty
        list == clean)."""
        from repro_torch.analysis import audit_resize_log
        return audit_resize_log(self.resize_log, self.jobs)

    def summary(self) -> Dict[str, float]:
        # degenerate workloads (empty, or all jobs at t=0 with no runtime)
        # yield well-defined zeros instead of NaN / ZeroDivision warnings
        throughput = len(self.jobs) / self.makespan if self.makespan > 0 \
            else 0.0
        return {
            "makespan_s": self.makespan,
            "mean_wait_s": self.mean(Job.waiting),
            "mean_exec_s": self.mean(Job.execution),
            "mean_completion_s": self.mean(Job.completion),
            "alloc_rate": self.alloc_rate,
            "energy_kwh": self.energy_kwh,
            "throughput_jps": throughput,
            "n_resizes": self.n_resizes,
        }


class _SimulatorBase:
    """Shared semantics: event loop, work accounting, resize accounting.

    Work progress is accounted *lazily*: a job's ``remaining_work`` is only
    brought up to date (``_sync``) when the job itself is touched — at
    (re)scheduling, resize, straggle, and completion points.  Both engines
    sync at exactly the same points, so their floating-point results are
    bit-identical.
    """

    def __init__(self, jobs: List[Job], config: Optional[SimConfig] = None,
                 policy: Union[str, Policy, None] = None, *,
                 resize_listener=None):
        self.cfg = config or SimConfig()
        #: optional pure observer ``fn(record, job)`` invoked at every
        #: resize, right after the job's work was synced to the resize
        #: instant and the ``ResizeRecord`` was logged.  The co-simulation
        #: adapter (``repro_torch.dmr.cosim.SimRMS``) hooks here;
        #: listeners must not mutate simulator state.
        self.resize_listener = resize_listener
        self.policy = get_policy(policy)
        self.policy.configure(self.cfg)
        self.jobs = sorted(jobs, key=lambda j: j.submit_time)
        for j in self.jobs:                     # reset runtime state
            j.start_time = j.end_time = -1.0
            j.nprocs = 0
            j.remaining_work = 1.0
            j.last_update = 0.0
            j.work_synced_t = 0.0
            j.boosted = False
            j.next_reconfig_ok = 0.0
            j.straggling = False

    # -- shared accounting ---------------------------------------------
    def _resize_overhead(self, job: Job, new_p: int) -> float:
        xfer = job.app.state_mb / (self.cfg.bandwidth_gbps * 125.0)
        return xfer + self.cfg.spawn_base_s + self.cfg.spawn_per_proc_s * new_p

    def _rate(self, j: Job) -> float:
        r = j.rate(j.nprocs)
        return r * self.cfg.straggler_slowdown if j.straggling else r

    def _sync(self, j: Job, t: float) -> None:
        """Bring j.remaining_work up to time t (work pauses until
        j.last_update while a resize's overhead is being paid)."""
        eff = j.last_update if j.last_update > j.work_synced_t \
            else j.work_synced_t
        if t > eff:
            j.remaining_work -= (t - eff) * self._rate(j)
        if t > j.work_synced_t:
            j.work_synced_t = t

    def _schedule_completion(self, j: Job) -> None:
        self._sync(j, self.now)
        self.version[j.jid] = ver = self.version.get(j.jid, 0) + 1
        pause = max(0.0, j.last_update - self.now)
        t_done = self.now + pause + max(j.remaining_work, 0.0) / self._rate(j)
        heapq.heappush(self.comp_heap, (t_done, ver, j.jid))

    def _start(self, j: Job, p: int) -> None:
        j.nprocs = p
        j.start_time = self.now
        j.last_update = self.now
        j.work_synced_t = self.now
        j.next_reconfig_ok = self.now + j.app.params.sched_period_s
        self._on_start(j)
        self._schedule_completion(j)

    def _apply_resize(self, j: Job, target: int, kind: str,
                      clear_straggle: bool = False) -> None:
        """The single resize-accounting path (policy and straggler alike):
        sync work at the old rate, move the workers, charge the overhead,
        log the record, and re-arm the §3.2 inhibitor window."""
        self._sync(j, self.now)
        if clear_straggle:
            j.straggling = False
        ovh = self._resize_overhead(j, target)
        self._on_resize(j, target)
        old = j.nprocs
        j.nprocs = target
        j.last_update = self.now + ovh
        j.next_reconfig_ok = self.now + max(
            j.app.params.sched_period_s, j.app.step_time(target),
            self.cfg.backfill_interval_s)
        rec = ResizeRecord(t=self.now, jid=j.jid, kind=kind,
                           from_procs=old, to_procs=target)
        self.resize_log.append(rec)
        if self.resize_listener is not None:
            self.resize_listener(rec, j)
        self.n_resizes += 1
        self.resize_overhead_s += ovh
        self._post_resize(j)
        self._schedule_completion(j)

    def _consider(self, j: Job, view: ClusterView) -> bool:
        """Evaluate the policy for one running malleable job; True iff the
        job was resized (identical decision path in both engines)."""
        act = self.policy.decide(j.nprocs, j.app.params, view, job=j)
        if act.kind == "none" or act.target == j.nprocs:
            return False
        # engine-side safety: never outside [min, max] regardless of what
        # the policy asked for
        target = j.app.params.clamp(act.target)
        if target == j.nprocs:
            return False
        if act.kind == "expand":
            if target - j.nprocs > self.free:
                return False
            self._apply_resize(j, target, "expand")
        else:
            self._apply_resize(j, target, "shrink")
            # paper: the enabled pending job gets the highest priority
            self._boost_pending()
        return True

    def _straggler_pass(self) -> None:
        cfg = self.cfg
        n_run = self._n_running()
        if not cfg.straggler_mtbf_s or not n_run:
            return
        # Poisson arrivals of slow nodes across the allocated fleet
        p = cfg.backfill_interval_s * n_run / cfg.straggler_mtbf_s
        if self.strag_rng.random() < min(p, 1.0):
            victim = self._running_at(int(self.strag_rng.integers(n_run)))
            if not victim.straggling:
                self._sync(victim, self.now)   # past work at the full rate
                victim.straggling = True
                self.n_stragglers += 1
                self._schedule_completion(victim)
        # mitigation: malleable jobs shrink the slow node away — through
        # the same accounting path as any other resize, honoring the same
        # §3.2 inhibitor window (a straggling job whose window is still
        # open waits it out and is re-checked at the next tick)
        for j in self._running_iter():
            if j.straggling and j.malleable and \
                    self.now >= j.next_reconfig_ok and \
                    j.nprocs > j.app.params.min_procs:
                sizes = [s for s in j.app.params.legal_sizes()
                         if s < j.nprocs]
                if not sizes:
                    continue
                self._apply_resize(j, max(sizes), "shrink",
                                   clear_straggle=True)
                self.n_mitigations += 1

    def _advance(self, to: float) -> None:
        dt = to - self.now
        if dt <= 0:
            self.now = max(self.now, to)
            return
        self.node_sec_alloc += self._alloc_now() * dt
        self.now = to

    def _pop_completions(self) -> bool:
        progressed = False
        heap = self.comp_heap
        while heap and heap[0][0] <= self.now + 1e-9:
            _, ver, jid = heapq.heappop(heap)
            j = self.by_id[jid]
            if self.version.get(jid) != ver or j.end_time >= 0:
                continue
            self._sync(j, self.now)
            if j.remaining_work > 1e-9:      # stale (resized): reschedule
                self._schedule_completion(j)
                continue
            j.end_time = self.now
            self._finish(j)
            progressed = True
        return progressed

    # -- main loop ------------------------------------------------------
    def run(self) -> SimResult:
        cfg = self.cfg
        self.now = 0.0
        self.free = cfg.nodes
        self.arr_i = 0
        self.version: Dict[int, int] = {}
        self.comp_heap: List[Tuple[float, int, int]] = []  # (time, ver, jid)
        self.by_id = {j.jid: j for j in self.jobs}
        self.node_sec_alloc = 0.0
        self.n_resizes = 0
        self.resize_overhead_s = 0.0
        self.n_stragglers = 0
        self.n_mitigations = 0
        self.strag_rng = np.random.default_rng(cfg.straggler_seed)
        self.timeline = Timeline()
        self.resize_log: List[ResizeRecord] = []
        self._setup()

        next_tick = 0.0
        total_jobs = len(self.jobs)
        while self._n_completed() < total_jobs:
            # next event time
            t_arr = self.jobs[self.arr_i].submit_time \
                if self.arr_i < total_jobs else np.inf
            t_comp = self.comp_heap[0][0] if self.comp_heap else np.inf
            t_next = min(t_arr, t_comp, next_tick)
            self._advance(t_next)

            progressed = False
            if self.arr_i < total_jobs and self.now >= t_arr - 1e-9:
                self._enqueue(self.jobs[self.arr_i])
                self.arr_i += 1
                progressed = True
            if self._pop_completions():
                progressed = True
            if self.now >= next_tick - 1e-9:
                self._try_schedule()
                self._straggler_pass()
                self._malleability_pass()
                if cfg.record_timeline:
                    self.timeline.t.append(self.now)
                    self.timeline.allocated.append(cfg.nodes - self.free)
                    self.timeline.running.append(self._n_running())
                    self.timeline.completed.append(self._n_completed())
                next_tick = self.now + cfg.backfill_interval_s
            elif progressed:
                self._try_schedule()

        makespan = self.now
        alloc_rate = self.node_sec_alloc / (cfg.nodes * makespan) \
            if makespan else 0.0
        energy_kwh = (self.node_sec_alloc * cfg.loaded_w +
                      (cfg.nodes * makespan - self.node_sec_alloc) *
                      cfg.idle_w) / 3600.0 / 1000.0
        return SimResult(jobs=self.jobs, makespan=makespan,
                         alloc_rate=alloc_rate, energy_kwh=energy_kwh,
                         n_resizes=self.n_resizes,
                         resize_overhead_s=self.resize_overhead_s,
                         timeline=self.timeline.as_arrays(),
                         n_stragglers=self.n_stragglers,
                         n_straggler_mitigations=self.n_mitigations,
                         resize_log=self.resize_log)

    # -- engine hooks ---------------------------------------------------
    def _setup(self) -> None: ...
    def _n_running(self) -> int: ...
    def _n_completed(self) -> int: ...
    def _running_iter(self): ...
    def _running_at(self, i: int) -> Job: ...
    def _alloc_now(self) -> int: ...
    def _enqueue(self, j: Job) -> None: ...
    def _on_start(self, j: Job) -> None: ...
    def _finish(self, j: Job) -> None: ...
    def _on_resize(self, j: Job, target: int) -> None: ...
    def _post_resize(self, j: Job) -> None: ...
    def _boost_pending(self) -> None: ...
    def _try_schedule(self) -> None: ...
    def _malleability_pass(self) -> None: ...


class ReferenceSimulator(_SimulatorBase):
    """The original list-based engine — full pending re-sort per tick,
    O(n) ``list.remove``, per-job cluster-view construction.  Slow on big
    workloads but structurally identical to the paper's description; the
    fast engine is validated against it bit-for-bit."""

    def _setup(self) -> None:
        self.pending: List[Job] = []
        self.running: List[Job] = []
        self.completed: List[Job] = []

    def _n_running(self) -> int:
        return len(self.running)

    def _n_completed(self) -> int:
        return len(self.completed)

    def _running_iter(self):
        return self.running

    def _running_at(self, i: int) -> Job:
        return self.running[i]

    def _alloc_now(self) -> int:
        return sum(j.nprocs for j in self.running)

    def _enqueue(self, j: Job) -> None:
        self.pending.append(j)

    def _on_start(self, j: Job) -> None:
        self.free -= j.nprocs
        self.running.append(j)

    def _finish(self, j: Job) -> None:
        self.running.remove(j)
        self.free += j.nprocs
        self.completed.append(j)

    def _on_resize(self, j: Job, target: int) -> None:
        self.free += j.nprocs - target     # negative delta on expand

    def _post_resize(self, j: Job) -> None:
        pass

    def _boost_pending(self) -> None:
        for p in sorted(self.pending, key=lambda x: x.submit_time):
            if p.request()[0] <= self.free:
                p.boosted = True
                break

    def _try_schedule(self) -> None:
        # queue order is policy-owned; default (Algorithm 2) is the
        # multifactor: boosted (post-shrink beneficiaries) first, then age
        order = sorted(self.pending,
                       key=lambda j: self.policy.priority_key(j, self.now))
        for j in order:
            lo, hi = j.request()
            if j.moldable:
                if self.free >= lo:
                    self._start(j, min(self.free, hi))
                    self.pending.remove(j)
                    continue
            else:
                if self.free >= hi:
                    self._start(j, hi)
                    self.pending.remove(j)
                    continue
            # blocked: backfill policies keep scanning later jobs,
            # strict-FCFS policies stop at the queue head
            if not self.policy.backfill:
                break

    def _malleability_pass(self) -> None:
        for j in sorted(self.running, key=lambda x: x.next_reconfig_ok):
            if not j.malleable or self.now < j.next_reconfig_ok:
                continue
            # one live-view definition shared with dmr.Cluster
            view = live_view(
                available=self.free,
                pending_min_sizes=[p.request()[0] for p in self.pending],
                tenants=self.running, exclude=j)
            self._consider(j, view)


class Simulator(_SimulatorBase):
    """High-throughput event-indexed engine (the default).

    Index structures (all lazily deleted — stale entries are discarded on
    pop against per-job version counters):

    * ``_pq``: a ``repro_torch.rms.eventindex.MinRequestIndex`` — pending
      jobs bucketed by minimum request size, each bucket a lazy-deleted
      heap on
      ``(priority_key, arrival_seq)`` plus an arrival heap for the
      post-shrink boost.  A backfill scan peeks only bucket heads that fit
      in ``free``, so its cost is proportional to the number of jobs
      *started*, not the queue length.  (Shared with the event-driven
      ``dmr.Cluster`` engine.)
    * ``_reconfig_heap``: running malleable jobs keyed by the end of their
      inhibitor window; the malleability pass touches only jobs whose
      window has expired.
    * ``_eligible``: the expired-window jobs in the reference engine's
      evaluation order ``(next_reconfig_ok, start order)``.

    Scalars ``free`` / ``_alloc`` / ``_reclaim_total`` and the pending
    min-size multiset are maintained incrementally; ``_epoch`` counts
    cluster-state changes so no-op ``decide`` calls of a
    ``decide_stateless`` policy are skipped until the state they saw
    changes.  Policies with ``dynamic_priority`` get their queue heaps
    rebuilt at every scheduling pass instead (aged keys).
    """

    def _setup(self) -> None:
        self._pq = MinRequestIndex()               # pending, arrival order
        self._running: Dict[int, Job] = {}         # jid -> Job, start order
        self._n_done = 0
        self._alloc = 0
        self._reconfig_heap: List[Tuple[float, int, int]] = []
        self._eligible: List[Tuple[float, int, int]] = []
        self._reclaim_total = 0
        self._epoch = 0
        self._pass_epoch = -1
        self._decide_memo: Dict[int, Tuple[int, int]] = {}
        self._start_seq = 0
        self._dynamic = getattr(self.policy, "dynamic_priority", True)
        self._stateless = getattr(self.policy, "decide_stateless", False)

    # -- membership -----------------------------------------------------
    def _n_running(self) -> int:
        return len(self._running)

    def _n_completed(self) -> int:
        return self._n_done

    def _running_iter(self):
        return self._running.values()

    def _running_at(self, i: int) -> Job:
        return next(islice(self._running.values(), i, None))

    def _alloc_now(self) -> int:
        return self._alloc

    # -- pending queue --------------------------------------------------
    def _enqueue(self, j: Job) -> None:
        key = None if self._dynamic else self.policy.priority_key(j, self.now)
        self._pq.push(j.jid, j, j.request()[0], key)
        self._epoch += 1

    def _unqueue(self, j: Job) -> None:
        self._pq.discard(j.jid)
        self._epoch += 1

    def _try_schedule(self) -> None:
        pq = self._pq
        if not pq or self.free < pq.min_lo:
            return
        if self._dynamic:
            now = self.now
            pq.rebuild(lambda j: self.policy.priority_key(j, now))
        backfill = self.policy.backfill
        while pq:
            j = pq.best(self.free, backfill)
            if j is None:
                break
            lo, hi = j.request()
            if lo > self.free:             # strict FCFS: blocked queue head
                break
            self._unqueue(j)
            self._start(j, min(self.free, hi) if j.moldable else hi)

    def _boost_pending(self) -> None:
        p = self._pq.earliest_fitting(self.free)
        if p is not None and not p.boosted:
            p.boosted = True
            self._pq.rekey(p.jid, None if self._dynamic
                           else self.policy.priority_key(p, self.now))

    # -- running set ----------------------------------------------------
    def _on_start(self, j: Job) -> None:
        self.free -= j.nprocs
        self._alloc += j.nprocs
        j._start_seq = self._start_seq
        self._start_seq += 1
        self._running[j.jid] = j
        if j.malleable:
            self._reclaim_total += max(
                0, j.nprocs - j.app.params.preferred)
            heapq.heappush(self._reconfig_heap,
                           (j.next_reconfig_ok, j._start_seq, j.jid))
        self._epoch += 1

    def _finish(self, j: Job) -> None:
        del self._running[j.jid]
        self.free += j.nprocs
        self._alloc -= j.nprocs
        if j.malleable:
            self._reclaim_total -= max(
                0, j.nprocs - j.app.params.preferred)
        self._n_done += 1
        self._epoch += 1

    def _on_resize(self, j: Job, target: int) -> None:
        delta = j.nprocs - target          # negative on expand
        self.free += delta
        self._alloc -= delta
        if j.malleable:
            pref = j.app.params.preferred
            self._reclaim_total += max(0, target - pref) \
                - max(0, j.nprocs - pref)
        self._epoch += 1

    def _post_resize(self, j: Job) -> None:
        if j.malleable:
            heapq.heappush(self._reconfig_heap,
                           (j.next_reconfig_ok, j._start_seq, j.jid))

    # -- malleability pass ----------------------------------------------
    def _malleability_pass(self) -> None:
        now = self.now
        rh = self._reconfig_heap
        newly = False
        while rh and rh[0][0] <= now:
            entry = heapq.heappop(rh)
            j = self._running.get(entry[2])
            if j is None or j.next_reconfig_ok != entry[0]:
                continue                   # completed or re-armed since
            self._eligible.append(entry)
            newly = True
        if not self._eligible:
            return
        if self._stateless and not newly and self._pass_epoch == self._epoch:
            return                         # nothing a pure policy could see
        start_epoch = self._epoch
        keep = []
        memo = self._decide_memo
        stateless = self._stateless
        # stateless policies get the compact multiset summary; anything else
        # gets the reference engine's literal per-job list (arrival order)
        pend_view = self._pq.min_sizes(stateless)
        for entry in self._eligible:
            t_ok, _, jid = entry
            j = self._running.get(jid)
            if j is None or j.next_reconfig_ok != t_ok:
                continue                   # completed / resized: drop entry
            hit = memo.get(jid)
            if stateless and hit is not None and hit[0] == self._epoch \
                    and hit[1] == j.nprocs:
                keep.append(entry)
                continue
            recl = self._reclaim_total - max(
                0, j.nprocs - j.app.params.preferred)
            view = ClusterView(
                available=self.free,
                pending_min_sizes=pend_view,
                reclaimable_others=recl)
            if self._consider(j, view):
                continue                   # re-armed; entry now stale
            memo[jid] = (self._epoch, j.nprocs)
            keep.append(entry)
        self._eligible = keep
        # arm the whole-pass skip only after a *clean* pass: if a resize
        # changed the cluster state mid-pass, earlier jobs decided against
        # stale state and must be re-evaluated next tick
        self._pass_epoch = self._epoch if self._epoch == start_epoch else -1
