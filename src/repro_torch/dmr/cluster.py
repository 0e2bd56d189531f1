"""``dmr.Cluster`` — a live multi-tenant elastic runtime on one device pool
(port of ``repro/dmr/cluster.py``; the pool is a list of logical workers,
``repro_torch.parallel.mesh.logical_workers``, eight on the card by
default).

The paper's headline claim (§5: >3x global throughput from malleability)
is a *cluster-level* result; this module exercises it live instead of
only in the discrete-event simulator: many real ``MalleableRunner`` jobs
share one device pool, a named ``Policy`` arbitrates their expand/shrink
through per-tenant :class:`ClusterRMS` connectors, and the scheduler loop
mirrors the simulator's semantics — priority-ordered pending queue
(``Policy.priority_key``), rigid jobs start at their upper limit and
moldable jobs at whatever fits, backfill, post-shrink boost — on a
discrete *cluster-tick* clock where every running tenant advances one
iteration per tick.

Because each tenant's RMS query is answered from the **live** cluster
view (idle devices, pending queue minimum requests, reclaimable workers
of the co-tenants — ``repro_torch.core.policy.live_view``, the same
definition the simulator engines use), the existing policies (``algorithm2``,
``energy``, ``throughput``) drive real multi-job elasticity unmodified.

Two engines share one semantics (the JAX package's ``docs/cluster.md``),
the same split the
simulator got in ``repro_torch.rms.scheduler``:

* ``Cluster`` — the production engine.  Event-indexed scheduling on the
  tick clock: the pending queue is a ``MinRequestIndex`` (lazy-deleted
  heaps bucketed by minimum request, shared with the simulator), running
  membership is an insertion-ordered dict, free/allocated/reclaimable
  counters are maintained incrementally, §3.2 inhibitor windows are
  tracked in a due-tick heap so quiescent tenants never construct a
  cluster view, and idle gaps between arrivals are skipped.  Stepping the
  running tenants stays one-iteration-per-tick (real apps execute); the
  win is that *scheduling* costs O(events), not O(ticks × queue).
* ``ReferenceCluster`` — the original tick-polled loop: full pending
  re-sort per tick, per-query list-built cluster views, ``list.remove``
  membership.  Obviously correct; kept as the golden model.  The two
  engines produce bit-identical ``ClusterResult`` summaries, per-job
  resize trails, and cosim crosscheck records (the JAX package's
  ``tests/test_cluster_equivalence.py``; ``tests/test_torch_cluster.py``
  holds the port's engines against each other and against the JAX
  package's).

Semantics live in ``_ClusterBase`` only — to change scheduling behavior,
change the base (or a hook's contract) so both engines move together; an
engine-specific "fix" that the other engine doesn't mirror is a bug by
definition and the differential harness will flag it.

Time: one tick = one scheduler round = one iteration of every running
job.  ``tick_s`` (default 1.0) converts ticks to the nominal seconds all
rate metrics are reported in (``summary()`` mirrors ``SimResult``);
``wall_s`` is the actual execution time, reported separately.

Decision modes:

* ``decisions="policy"`` (default) — the live elastic cluster above.
* ``decisions="cosim"`` — the whole workload is first run through the
  discrete-event ``Simulator`` and the live cluster *replays* its
  decisions (start order/sizes, per-job resize schedules via
  ``dmr.SimWorkload``); ``Cluster.crosscheck(result)`` then verifies
  every runner's resize trail against the simulator's ``resize_log``
  record-for-record.  This is the workload-wide generalization of the
  single-job ``SimRMS`` co-simulation.

    specs = materialize_live("steady", n_jobs=8, device_count=8)
    cluster = dmr.Cluster(specs, policy="algorithm2")
    result = cluster.run()
    print(result.summary())

For scheduling-only studies at trace scale (100k–1M SWF jobs) use
:meth:`Cluster.sched_only`: a synthetic device pool, host-state apps and
a null redistribute remove every device cost from the loop while the
scheduling path stays byte-for-byte the production one.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.params import MalleabilityParams
from repro_torch.core.policy import Action, ClusterView, get_policy, live_view
from repro_torch.core.redistribute import TransferStats
from repro_torch.dmr.app import App, MalleableApp, ensure_app
from repro_torch.dmr.cosim import SimWorkload
from repro_torch.dmr.runner import MalleableRunner, ResizeEvent
from repro_torch.parallel.mesh import Placement, logical_workers
from repro_torch.rms.eventindex import MinRequestIndex
from repro_torch.rms.workload import (MOLDABLE, RIGID, AppProfile, Job,
                                LiveJobSpec)


def default_app_factory(spec: LiveJobSpec) -> App:
    """A tiny real app for profile-only live jobs: one f32 vector split over
    the tenant's workers plus a step counter, on its workers' device.
    Small enough that an 8-worker pool runs whole workloads in seconds;
    real enough that every resize moves actual device buffers through the
    redistribution patterns."""
    length = 840                    # lcm(1..8): shardable at any live size

    def shardings(mesh):
        return {"x": Placement(mesh, 0), "i": Placement(mesh)}

    def init(mesh):
        return {"x": torch.arange(length, dtype=torch.float32,
                                  device=mesh.device),
                "i": torch.zeros((), dtype=torch.int32, device=mesh.device)}

    def step(mesh):
        def f(state, i, *a):
            return {"x": state["x"] * 1.000001 + 1e-3,
                    "i": state["i"] + 1}, {}
        return f

    return App(init=init, shardings=shardings, step=step,
               name=f"live-{spec.app.name}")


# ----------------------------------------------------------------------
# scheduling-only mode: trace-scale replays without device work in the loop
# ----------------------------------------------------------------------

class SchedOnlyApp:
    """Host-state stand-in executable for scheduling-only studies: state
    is one Python int, meshes are synthetic, redistribution moves nothing.
    Every *scheduling* code path (grants, queries, resizes, release,
    audit) runs exactly as in production — only the device work is gone,
    which is what lets a 1M-job SWF replay finish in minutes."""

    def init_state(self, mesh):
        return {"i": 0}

    def state_shardings(self, mesh):
        return {"i": None}

    def make_step(self, mesh):
        def step(state, i, *args):
            return {"i": state["i"] + 1}, {}
        return step


class _PoolDevice:
    """A synthetic pool slot (scheduling-only mode): just an ``.id``."""
    __slots__ = ("id",)

    def __init__(self, i: int):
        self.id = i

    def __repr__(self) -> str:           # pragma: no cover - debug aid
        return f"_PoolDevice({self.id})"


def synthetic_pool(n: int) -> List[_PoolDevice]:
    """``n`` synthetic devices for ``Cluster.sched_only`` pools."""
    return [_PoolDevice(i) for i in range(n)]


def _sched_only_mesh(devices, max_model: int = 16):
    return ("sched-mesh", len(devices))


_NULL_STATS = TransferStats(bytes_moved=0, seconds=0.0, n_leaves=0)


def _null_redistribute(state, new_shardings):
    return state, _NULL_STATS


class _WithDemand:
    """``pending_min_sizes`` plus published composite-tenant shortfalls,
    without materializing the (possibly duplicate-collapsed) base
    summary into a list.  Policies only need truthiness, iteration and
    ``len`` from the view — exactly what this forwards."""
    __slots__ = ("base", "extra")

    def __init__(self, base, extra):
        self.base = base
        self.extra = extra

    def __bool__(self):
        return bool(self.base) or bool(self.extra)

    def __len__(self):
        return len(self.base) + len(self.extra)

    def __iter__(self):
        yield from self.base
        yield from self.extra


class ClusterRMS:
    """The :class:`RMSConnector` a ``dmr.Cluster`` hands each tenant: a
    query evaluates the cluster's shared policy against the *live*
    cluster view (or, in cosim mode, replays the simulator's schedule for
    this tenant), and an expand decision carries its device grant — the
    runner's pool is extended before it builds the larger mesh."""

    def __init__(self, cluster: "_ClusterBase", tenant: "_Tenant"):
        self.cluster = cluster
        self.tenant = tenant

    def query(self, *, step: int, current: int,
              params: MalleabilityParams) -> Action:
        return self.cluster._decide(self.tenant, step, current, params)


class _Tenant:
    """One job of the live cluster: the runner + scheduling bookkeeping.

    Duck-types the simulator's ``Job`` surface (``submit_time``,
    ``boosted``, ``remaining_work``, ``nprocs``, ``malleable``, ``app``
    with ``exec_time``/``params``) so ``Policy.priority_key`` /
    ``Policy.decide`` see the same shape live as simulated."""

    def __init__(self, spec: LiveJobSpec, exec_app: MalleableApp):
        self.spec = spec
        self.jid = spec.jid
        # the live profile: original cost model, pool-clamped params and
        # scaled step count — identical to the Job handed to the cosim
        # Simulator, so both sides see one cost/param surface
        self.app = dataclasses.replace(spec.app, params=spec.params,
                                       iterations=spec.steps)
        self.params = spec.params
        self.exec_app = exec_app
        self.moldable = spec.moldable
        self.malleable = spec.malleable
        self.submit_step = spec.submit_step
        self.submit_s = getattr(spec, "submit_s", 0.0)
        self.steps = spec.steps
        self.runner: Optional[MalleableRunner] = None
        self.rms: Optional[ClusterRMS] = None
        self.state = None
        self.step = 0
        self.boosted = False
        self.start_tick = -1
        self.end_tick = -1
        self.start_procs = 0
        self.final_procs = 0
        self.events: List[ResizeEvent] = []

    # -- duck-typed Job surface for the policies ------------------------
    @property
    def submit_time(self) -> float:
        return float(self.submit_step)

    @property
    def remaining_work(self) -> float:
        return max(0.0, 1.0 - self.step / self.steps)

    @property
    def nprocs(self) -> int:
        return self.runner.current if self.runner is not None else 0

    def request(self) -> Tuple[int, int]:
        p = self.params
        if self.moldable:
            return (p.min_procs, p.max_procs)
        return (p.max_procs, p.max_procs)

    def quantize(self, n: int) -> int:
        """Round a prospective start size onto the tenant's allocation
        quantum (identity for ordinary jobs; composite serving tenants
        round down to whole replicas)."""
        return n

    # -- the MalleableTenant contract (repro_torch.dmr.tenant) ----------
    # The cluster moves devices through the *tenant*, not the runner:
    # an ordinary job delegates straight to its MalleableRunner, while a
    # composite tenant (a serving fleet) routes the same four members
    # through its adapter — one contract from ReplicaSet down to a mesh.
    @property
    def current_size(self) -> int:
        return self.runner.current if self.runner is not None else 0

    def grant_devices(self, new_devices: List) -> None:
        self.runner.grant_devices(new_devices)

    def release_devices(self) -> List:
        return self.runner.release_devices()

    def shutdown(self) -> List:
        return self.runner.shutdown()

    def make_runner(self, cluster: "_ClusterBase", grant: List, p: int,
                    listener: Optional[Callable]) -> MalleableRunner:
        """Build this tenant's runner on its start grant — the hook a
        composite tenant overrides to wire a fleet adapter instead."""
        return MalleableRunner(self.exec_app, self.params, self.rms,
                               devices=grant, initial_procs=p,
                               allow_partial=True,
                               mesh_factory=cluster.mesh_factory,
                               redistribute=cluster.redistribute,
                               event_listener=listener)


class _CompositeTenant(_Tenant):
    """A whole serving fleet as ONE tenant of the cluster.

    Built from any spec object exposing the composite-tenant surface
    (``repro_torch.serve.tenant.ServeTenantSpec``): ``jid`` /
    ``submit_step``, ``device_params()`` (the fleet's device budget as
    ``MalleabilityParams``), ``profile()`` (an ``AppProfile`` for the
    records/priority surface), ``quantum`` (devices per replica) and
    ``build_runner(...)`` (the ``ReplicaSetRunner`` adapter satisfying
    the runner's pool/step surface).  Three flags shape how the cluster
    treats it:

    * ``reclaim_opaque`` — its internal occupancy is invisible and its
      shrinks may land partial, so its excess never enters co-tenants'
      line-6 shrink arithmetic (``reclaimable_workers``).
    * ``publishes_demand`` — a blocked expand publishes its device
      shortfall into co-tenants' ``pending_min_sizes`` view, which is
      what makes training jobs shrink at the serving peak.
    * ``local_policy`` — its resize queries are answered by its own
      serving policy (SLO-aware et al.) over the fleet's latency
      surface, not the cluster-wide batch policy.
    """

    composite = True
    reclaim_opaque = True
    publishes_demand = True

    def __init__(self, spec):
        self.spec = spec
        self.jid = spec.jid
        self.params = spec.device_params()
        self.app = spec.profile()
        self.exec_app = None
        self.moldable = True
        self.malleable = True
        self.submit_step = spec.submit_step
        self.submit_s = getattr(spec, "submit_s", 0.0)
        self.steps = 1 << 30             # open-ended: finishes when drained
        self.runner = None
        self.rms = None
        self.state = None
        self.step = 0
        self.boosted = False
        self.start_tick = -1
        self.end_tick = -1
        self.start_procs = 0
        self.final_procs = 0
        self.events: List[ResizeEvent] = []
        self.local_policy = None
        #: the fleet's ServingResult, captured at shutdown (the adapter
        #: writes it here because the runner itself is dropped on finish)
        self.result = None

    def request(self) -> Tuple[int, int]:
        p = self.params
        return (p.min_procs, p.preferred)   # start at the planned fleet

    def quantize(self, n: int) -> int:
        q = self.spec.quantum
        return max(self.params.min_procs, (n // q) * q)

    def make_runner(self, cluster: "_ClusterBase", grant: List, p: int,
                    listener: Optional[Callable]):
        sink = None
        if cluster.trail is not None:
            sink = (lambda kind, jid, payload:
                    cluster._trail_event(kind, jid, payload))
        runner, self.local_policy = self.spec.build_runner(
            self, grant, p, listener=listener, trail_sink=sink)
        return runner


@dataclasses.dataclass
class JobRecord:
    """Per-job outcome of a live cluster run (tick units)."""
    jid: int
    name: str
    submit_step: int
    start_tick: int
    end_tick: int
    start_procs: int
    final_procs: int
    resizes: List[Tuple[str, int, int]]

    def waiting(self) -> float:
        return float(self.start_tick - self.submit_step)

    def execution(self) -> float:
        return float(self.end_tick - self.start_tick)

    def completion(self) -> float:
        return float(self.end_tick - self.submit_step)


@dataclasses.dataclass
class ClusterResult:
    """Workload-level outcome; ``summary()`` mirrors ``SimResult`` (rates
    on the nominal ``tick_s`` clock, real execution time in ``wall_s``)."""
    records: List[JobRecord]
    makespan_ticks: int
    alloc_rate: float
    energy_kwh: float
    n_resizes: int
    tick_s: float
    wall_s: float
    events_by_jid: Dict[int, List[ResizeEvent]]
    timeline: Dict[str, List]

    def mean(self, fn) -> float:
        if not self.records:
            return 0.0
        return sum(fn(r) for r in self.records) / len(self.records)

    def summary(self) -> Dict[str, float]:
        makespan_s = self.makespan_ticks * self.tick_s
        return {
            "makespan_s": makespan_s,
            "mean_wait_s": self.mean(JobRecord.waiting) * self.tick_s,
            "mean_exec_s": self.mean(JobRecord.execution) * self.tick_s,
            "mean_completion_s": self.mean(JobRecord.completion) * self.tick_s,
            "alloc_rate": self.alloc_rate,
            "energy_kwh": self.energy_kwh,
            "throughput_jps": len(self.records) / makespan_s
                if makespan_s > 0 else 0.0,
            "n_resizes": self.n_resizes,
            "wall_s": self.wall_s,
        }


class _ClusterBase:
    """Shared semantics of the live cluster's two engines.

    Everything observable — tenant construction, start sizes, the
    per-query decision path, resize/release/boost mechanics, accounting
    (integer ``alloc_ticks`` with closed-form energy), tick stepping and
    completion — lives here.  Engines supply only *mechanism* through the
    hooks at the bottom: how the pending queue is stored and scanned, how
    running membership is kept, how the cluster view's aggregates are
    obtained, whether quiescent inhibitor windows are skipped, and
    whether dead ticks between arrivals are fast-forwarded.  Both engines
    must produce bit-identical results; change semantics only here.

    ``workload`` is a list of :class:`repro_torch.rms.workload.LiveJobSpec`
    (see ``materialize_live``) and/or explicit ``(app, params,
    submit_step[, mode[, malleable]])`` tuples (``dmr.App``,
    ``MalleabilityParams``, arrival tick; default flexible —
    ``mode="rigid"`` / ``malleable=False`` opt out).  ``app_factory``
    builds the executable for profile-only specs (default:
    :func:`default_app_factory`, a tiny real app).

    ``devices`` defaults to ``logical_workers(8)``: eight workers on the
    card (raising when there is none — pass CPU workers explicitly to run
    on the CPU); every tenant's mesh is
    built from an explicit — possibly non-contiguous — slice of this one
    pool, and devices move between tenants only through the cluster
    (grant on start/expand, reclaim on shrink/completion), audited every
    tick against double-grants and leaks (``audit=False`` drops the
    per-tick sweep for trace-scale replays; a final audit always runs).
    ``sanitize=True`` attaches the live ``repro_torch.analysis`` trail
    auditor
    — every grant/release/resize/start/finish is contract-checked as it
    happens (``TrailViolation`` on the first bad event) — and
    ``record_trail=True`` records the schedule trail without either
    sweep, for offline ``repro_torch.analysis.audit_trail``.
    ``record_timeline=False`` skips the per-tick timeline samples (again
    for scale); ``mesh_factory``/``redistribute`` are forwarded to every
    tenant's ``MalleableRunner`` (see :meth:`sched_only`).
    """

    def __init__(self, workload: Sequence, devices: Optional[List] = None, *,
                 policy=None, decisions: str = "policy",
                 app_factory: Optional[Callable[[LiveJobSpec], App]] = None,
                 engine=None, default_steps: int = 16,
                 tick_s: float = 1.0, idle_w: float = 100.0,
                 loaded_w: float = 340.0, max_ticks: int = 100_000,
                 record_timeline: bool = True, audit: bool = True,
                 sanitize: bool = False, record_trail: bool = False,
                 mesh_factory: Optional[Callable] = None,
                 redistribute: Optional[Callable] = None):
        if decisions not in ("policy", "cosim"):
            raise ValueError(f"decisions={decisions!r}: expected 'policy' "
                             f"or 'cosim'")
        if devices is None:
            devices = logical_workers(8)
        self.devices = list(devices)
        self.idle_w = idle_w
        self.loaded_w = loaded_w
        self.policy = get_policy(policy)
        # the same SimConfig the cosim Simulator gets: live and simulated
        # policy configuration can never drift apart
        self.policy.configure(self._sim_config())
        self.decisions = decisions
        self.engine = engine
        self.app_factory = app_factory or default_app_factory
        self.default_steps = default_steps
        self.tick_s = tick_s
        self.max_ticks = max_ticks
        self.record_timeline = record_timeline
        self.audit = audit
        #: ``sanitize=True`` attaches a live ``repro_torch.analysis``
        #: ``TrailAuditor`` to the run: every grant/release/resize/
        #: start/finish event is checked as it happens and the first
        #: contract violation raises ``TrailViolation`` (plus the
        #: per-tick pool-conservation sweep, even with ``audit=False``).
        self.sanitize = sanitize
        self.record_trail = record_trail
        self.mesh_factory = mesh_factory
        self.redistribute = redistribute
        #: the schedule trail: ("start" | "grant" | "release" | "resize"
        #: | "finish", jid, payload, tick) in event order, recorded while
        #: ``audit`` / ``sanitize`` / ``record_trail`` is on — the
        #: differential harness asserts both engines record identical
        #: trails; ``repro_torch.analysis.audit_trail`` checks the contract.
        self.trail: Optional[List[Tuple[str, int, object, int]]] = None
        self._sanitizer = None

        self.tenants = [self._as_tenant(entry, i)
                        for i, entry in enumerate(workload)]
        jids = [t.jid for t in self.tenants]
        if len(set(jids)) != len(jids):
            raise ValueError(f"duplicate jids in the workload: {jids}")
        pool = len(self.devices)
        for t in self.tenants:
            lo, hi = t.request()
            if lo > pool:
                raise ValueError(
                    f"job {t.jid} can never start: requests >= {lo} workers "
                    f"on a {pool}-device pool")
        self._pool_ids = sorted(d.id for d in self.devices)
        if len(set(self._pool_ids)) != len(self._pool_ids):
            raise ValueError("duplicate device ids in the pool")
        self.simwl: Optional[SimWorkload] = None
        if decisions == "cosim" and any(getattr(t, "composite", False)
                                        for t in self.tenants):
            raise ValueError(
                "decisions='cosim' cannot replay a composite serving "
                "tenant: the discrete-event simulator has no model of a "
                "fleet's internal request dynamics")
        if decisions == "cosim":
            self.simwl = SimWorkload(
                self._sim_jobs(),
                total_steps={t.jid: t.steps for t in self.tenants},
                config=self._sim_config(), policy=self.policy, engine=engine)

    @classmethod
    def sched_only(cls, workload: Sequence, n_devices: int = 128, **kw):
        """A cluster wired for scheduling-only studies at trace scale:
        synthetic ``n_devices``-slot pool, :class:`SchedOnlyApp`
        executables, synthetic meshes and a null redistribute — no device
        work anywhere in the loop.  All other keywords pass through, so
        ``Cluster.sched_only(specs, 128, policy="algorithm2",
        record_timeline=False, audit=False)`` replays million-job SWF
        materializations; the differential tests use the same wiring at
        small sizes."""
        kw.setdefault("app_factory", lambda spec: SchedOnlyApp())
        kw.setdefault("mesh_factory", _sched_only_mesh)
        kw.setdefault("redistribute", _null_redistribute)
        return cls(workload, devices=synthetic_pool(n_devices), **kw)

    # -- construction helpers -------------------------------------------
    def _as_tenant(self, entry, i: int) -> _Tenant:
        if isinstance(entry, LiveJobSpec):
            return _Tenant(entry, ensure_app(self.app_factory(entry)))
        if hasattr(entry, "build_runner"):
            # a composite serving-fleet spec
            # (repro_torch.serve.tenant.ServeTenantSpec) — duck-typed so
            # dmr never imports serve
            return _CompositeTenant(entry)
        if isinstance(entry, tuple) and 3 <= len(entry) <= 5:
            # (app, params, submit_step[, mode[, malleable]]) — flexible
            # (moldable + malleable) unless the optional flags say not
            app, params, submit_step = entry[:3]
            mode = entry[3] if len(entry) > 3 else MOLDABLE
            if mode not in (RIGID, MOLDABLE):
                raise ValueError(f"workload entry {i}: mode {mode!r} is "
                                 f"not 'rigid'/'moldable'")
            profile = AppProfile(
                name=getattr(app, "name", f"job{i}"), t1=600.0, f=1.0,
                alpha=0.5, c=0.0, min_start=params.min_procs, params=params,
                state_mb=1.0, iterations=self.default_steps)
            spec = LiveJobSpec(jid=i, app=profile, params=params,
                               submit_step=int(submit_step),
                               steps=self.default_steps,
                               moldable=mode == MOLDABLE,
                               malleable=bool(entry[4])
                               if len(entry) > 4 else True)
            return _Tenant(spec, ensure_app(app))
        raise TypeError(
            f"workload entry {entry!r}: expected a LiveJobSpec or an "
            f"(app, MalleabilityParams, submit_step[, mode[, malleable]]) "
            f"tuple")

    def _arrival_order(self) -> List[_Tenant]:
        """Deterministic arrival order: (tick, original submit, jid) —
        the tick mapping can collide, so the original submit second
        breaks ties identically in the live engines *and* in the cosim
        simulator's stable submit-time sort."""
        return sorted(self.tenants,
                      key=lambda t: (t.submit_step, t.submit_s, t.jid))

    def _sim_jobs(self) -> List[Job]:
        """The cosim Simulator's input: fresh Jobs over the tenants' live
        profiles (pool-clamped params, scaled step counts), arriving at
        their cluster ticks — the simulated and live clusters see exactly
        the same workload, in the same deterministic arrival order."""
        return [Job(jid=t.jid, app=t.app, submit_time=float(t.submit_step),
                    moldable=t.moldable, malleable=t.malleable)
                for t in self._arrival_order()]

    def _sim_config(self):
        from repro_torch.rms.scheduler import SimConfig
        return SimConfig(nodes=len(self.devices), idle_w=self.idle_w,
                         loaded_w=self.loaded_w, record_timeline=False)

    # -- device pool -----------------------------------------------------
    def _take(self, n: int) -> List:
        grant, self._idle = self._idle[:n], self._idle[n:]
        return grant

    def check_pool_invariants(self, tick: int = 0) -> None:
        """The pool-accounting invariant both engines must uphold after
        every event: the idle pool plus the running tenants' pools is
        exactly the cluster pool — free + granted conserved, no device in
        two tenants' grants, released slices returned.  Runs every tick
        while ``audit`` is on (and once at end-of-run regardless);
        raises ``RuntimeError`` on any violation."""
        held = [d.id for d in self._idle]
        running = self._running
        tenants = running.values() if isinstance(running, dict) else running
        for t in tenants:
            held.extend(d.id for d in t.runner.devices)
        if sorted(held) != self._pool_ids:
            raise RuntimeError(
                f"device accounting violated at tick {tick}: pool "
                f"{self._pool_ids} vs held {sorted(held)}")

    _audit = check_pool_invariants

    @property
    def grant_log(self) -> Optional[List[Tuple[str, int, Tuple]]]:
        """Grant/release device provenance — the trail filtered down to
        ("grant" | "release", jid, (device ids...)) triples, in event
        order; ``None`` when no trail was recorded (``audit=False`` and
        neither ``sanitize`` nor ``record_trail``)."""
        if self.trail is None:
            return None
        return [(k, jid, p) for k, jid, p, _tick in self.trail
                if k in ("grant", "release")]

    def _trail_event(self, kind: str, jid: int, payload) -> None:
        event = (kind, jid, payload, self._tick)
        self.trail.append(event)
        if self._sanitizer is not None:
            self._sanitizer.feed(event)          # raises TrailViolation

    def _grant(self, t: _Tenant, need: int) -> None:
        # through the MalleableTenant contract, never the raw device list
        grant = self._take(need)
        t.grant_devices(grant)
        if self.trail is not None:
            self._trail_event("grant", t.jid, tuple(d.id for d in grant))

    def _reclaim(self, t: _Tenant, released: List) -> None:
        self._idle.extend(released)
        if self.trail is not None:
            self._trail_event("release", t.jid,
                              tuple(d.id for d in released))

    # -- scheduling ------------------------------------------------------
    def _start(self, t: _Tenant, p: int, tick: int) -> None:
        t.rms = ClusterRMS(self, t)
        grant = self._take(p)
        listener = None
        if self.trail is not None:
            self._trail_event("start", t.jid, p)
            # the grant event must precede runner construction: a
            # composite tenant's init() delegates pieces of this grant
            # to its replicas through the trail sink, and the auditor
            # only accepts delegations of devices the parent holds
            self._trail_event("grant", t.jid, tuple(d.id for d in grant))
            # feed the trail from the runner's own event log: the
            # listener sees the resize that *actually* applied (after
            # pool clamping / cosim boundary drains), not the decision
            # the scheduler thought it made
            listener = (lambda e, jid=t.jid: self._trail_event(
                "resize", jid, (e.step, e.action, e.from_procs,
                                e.to_procs)))
        t.runner = t.make_runner(self, grant, p, listener)
        t.state = t.runner.init()
        t.start_tick = tick
        t.start_procs = p
        self._dequeue(t)
        self._running_add(t)
        self._note_start(t, tick)

    # -- the per-query decision (ClusterRMS calls back here) ------------
    def _decide(self, t: _Tenant, step: int, current: int,
                params: MalleabilityParams) -> Action:
        if self.simwl is not None:
            act = self.simwl.pending_action(t.jid, step)
            if act is None:
                return Action.none(current)
            if act.target > current:
                need = act.target - current
                if need > len(self._idle):
                    return Action.none(current)     # defer until devices free
                self._grant(t, need)
            self.simwl.consume(t.jid)
            self._note_resize(t, current, act.target)
            return act
        # a composite tenant's queries are answered by its OWN serving
        # policy over the fleet's latency surface (the adapter's .fleet);
        # ordinary tenants keep the cluster-wide policy and pass
        # themselves as the job handle
        pol = getattr(t, "local_policy", None) or self.policy
        act = pol.decide(current, params, self._live_view(t),
                         job=getattr(t.runner, "fleet", t))
        if act.kind == "none":
            self._demand.pop(t.jid, None)
            return Action.none(current)
        target = params.clamp(act.target)
        if target == current:
            self._demand.pop(t.jid, None)
            return Action.none(current)
        if target > current:
            need = target - current
            if need > len(self._idle):
                # view raced (or a serving burst outran the pool): a
                # demand-publishing tenant posts its shortfall so
                # co-tenants' line-6 shrinks can serve it next window
                if getattr(t, "publishes_demand", False):
                    self._demand[t.jid] = need
                return Action.none(current)
            self._demand.pop(t.jid, None)
            self._grant(t, need)
            self._note_resize(t, current, target)
            return Action("expand", target)
        self._demand.pop(t.jid, None)
        self._note_resize(t, current, target)
        return Action("shrink", target)

    # -- main loop -------------------------------------------------------
    def _tick_tenant(self, t: _Tenant, tick: int) -> bool:
        """Advance one tenant by one tick; True iff it completed."""
        r = t.runner
        simwl = self.simwl
        if t.malleable:
            if t.step < t.steps:
                if self._query_gate(t, tick):
                    t.state = r.maybe_reconfig(t.state, t.step)
            elif simwl is not None and simwl.unconsumed(t.jid):
                # completion boundary with an unreplayed trail: drive the
                # connector directly (the runner's per-step query guard
                # would suppress a repeat query at the same iteration)
                act = t.rms.query(step=t.step, current=r.current,
                                  params=t.params)
                if act.kind != "none":
                    t.state = r.apply_resize(t.state, t.steps - 1, act)
            if r.current < len(r.devices):          # shrink: reclaim the tail
                self._reclaim(t, t.release_devices())
                self._boost_pending()
        if t.step < t.steps:
            t.state, _ = r.step(t.state, t.step)
            t.step += 1
        if (t.step >= t.steps or getattr(r, "complete", False)) \
                and not (simwl is not None and simwl.unconsumed(t.jid)):
            t.end_tick = tick + 1
            t.final_procs = r.current
            t.events = r.events
            self._reclaim(t, t.shutdown())
            if self.trail is not None:
                self._trail_event("finish", t.jid, t.final_procs)
            self._demand.pop(t.jid, None)
            self._note_finish(t)
            # drop the runner/state so a million completed tenants don't
            # pin device lists and app state; records read the captured
            # final_procs/events
            t.runner = None
            t.rms = None
            t.state = None
            return True
        return False

    def run(self) -> ClusterResult:
        t0 = time.perf_counter()
        for t in self.tenants:                   # re-runnable: fresh state
            t.runner = None
            t.rms = None
            t.state = None
            t.step = 0
            t.boosted = False
            t.start_tick = -1
            t.end_tick = -1
            t.start_procs = 0
            t.final_procs = 0
            t.events = []
        if self.simwl is not None:
            self.simwl.reset()
        self._idle: List = list(self.devices)
        #: jid -> published device shortfall of a blocked composite
        #: expand; co-tenants see these in their pending_min_sizes view
        self._demand: Dict[int, int] = {}
        self.trail = [] if (self.audit or self.sanitize
                            or self.record_trail) else None
        self._sanitizer = None
        if self.sanitize:
            from repro_torch.analysis.trail import TrailAuditor, job_metadata
            # cosim completion drains replay several simulator decisions
            # at one boundary step, so resize *spacing* is only a
            # violation in live-policy mode
            self._sanitizer = TrailAuditor(
                self._pool_ids, jobs=job_metadata(self),
                check_spacing=self.decisions != "cosim", live=True)
        self._setup_queues()
        done: List[_Tenant] = []
        arrivals = self._arrival_order()
        ai = 0
        # the clock starts at the first arrival (makespan is "first
        # arrival -> last completion", matching SimResult — ticks before
        # any job exists are dead time, not schedule quality)
        start = arrivals[0].submit_step if arrivals else 0
        self._t0_tick = start
        tick = start
        pool = len(self.devices)
        alloc_ticks = 0                          # integer device-ticks
        timeline: Dict[str, List] = {"tick": [], "allocated": [],
                                     "running": [], "completed": []}
        n_total = len(self.tenants)
        while len(done) < n_total:
            if tick - start >= self.max_ticks:
                raise RuntimeError(
                    f"cluster stalled: {len(done)}/{n_total} jobs "
                    f"after {tick - start} ticks (deferred cosim expands, "
                    f"or a pending job that never fits?)")
            self._tick = tick
            while ai < len(arrivals) and arrivals[ai].submit_step <= tick:
                self._enqueue(arrivals[ai], tick)
                ai += 1
            self._try_schedule(tick)
            for t in self._running_order():
                if self._tick_tenant(t, tick):
                    self._running_remove(t)
                    done.append(t)
            allocated = pool - len(self._idle)
            alloc_ticks += allocated
            if self.record_timeline:
                timeline["tick"].append(tick)
                timeline["allocated"].append(allocated)
                timeline["running"].append(self._n_running())
                timeline["completed"].append(len(done))
            if self.audit or self.sanitize:
                self.check_pool_invariants(tick)
            tick = self._next_tick(tick, ai, arrivals, timeline, len(done))
        self.check_pool_invariants(tick)         # end-of-run: always

        events_by_jid = {t.jid: t.events for t in done}
        n_resizes = sum(len(ev) for ev in events_by_jid.values())
        records = [JobRecord(
            jid=t.jid, name=t.app.name, submit_step=t.submit_step,
            start_tick=t.start_tick, end_tick=t.end_tick,
            start_procs=t.start_procs, final_procs=t.final_procs,
            resizes=[(e.action, e.from_procs, e.to_procs)
                     for e in t.events])
            for t in sorted(done, key=lambda x: x.jid)]
        makespan = tick - start
        # closed-form energy from the integer device-tick total: both
        # engines compute the identical float expression, independent of
        # how many ticks each engine actually iterated (gap skipping)
        idle_ticks = pool * makespan - alloc_ticks
        energy_kwh = ((alloc_ticks * self.loaded_w +
                       idle_ticks * self.idle_w) * self.tick_s) / 3.6e6
        return ClusterResult(
            records=records, makespan_ticks=makespan,
            alloc_rate=alloc_ticks / (pool * makespan) if makespan else 0.0,
            energy_kwh=energy_kwh,
            n_resizes=n_resizes, tick_s=self.tick_s,
            wall_s=time.perf_counter() - t0,
            events_by_jid=events_by_jid, timeline=timeline)

    def _demand_sizes(self, t: _Tenant) -> List[int]:
        """Published shortfalls of the *other* demand-publishing tenants
        (sorted for determinism) — appended to a tenant's
        ``pending_min_sizes`` view so Algorithm 2's line-6 shrink treats
        a starved serving fleet exactly like a queued batch job."""
        if not self._demand:
            return []
        return sorted(n for j, n in self._demand.items() if j != t.jid)

    def crosscheck(self, result: ClusterResult) -> Dict[int, List]:
        """cosim mode: verify every runner's resize trail against the
        simulator's ``resize_log`` (raises ``ValueError`` on divergence)."""
        if self.simwl is None:
            raise ValueError("crosscheck needs decisions='cosim'")
        return self.simwl.crosscheck(result.events_by_jid)

    # -- engine hooks ---------------------------------------------------
    def _setup_queues(self) -> None: ...
    def _n_running(self) -> int: ...
    def _running_order(self) -> List[_Tenant]: ...
    def _running_add(self, t: _Tenant) -> None: ...
    def _running_remove(self, t: _Tenant) -> None: ...
    def _has_pending(self) -> bool: ...
    def _enqueue(self, t: _Tenant, tick: int) -> None: ...
    def _dequeue(self, t: _Tenant) -> None: ...
    def _boost_pending(self) -> None: ...
    def _try_schedule(self, tick: int) -> None: ...
    def _live_view(self, t: _Tenant) -> ClusterView: ...
    def _query_gate(self, t: _Tenant, tick: int) -> bool: ...
    def _note_start(self, t: _Tenant, tick: int) -> None: ...
    def _note_finish(self, t: _Tenant) -> None: ...
    def _note_resize(self, t: _Tenant, old: int, new: int) -> None: ...
    def _next_tick(self, tick: int, ai: int, arrivals, timeline,
                   n_done: int) -> int: ...


class ReferenceCluster(_ClusterBase):
    """The original tick-polled engine — full pending re-sort per tick,
    per-query list-built cluster views, ``list.remove`` membership.  Slow
    at trace scale but obviously correct; the event engine is validated
    against it bit-for-bit (``tests/test_torch_cluster.py``)."""

    def _setup_queues(self) -> None:
        self._pending: List[_Tenant] = []
        self._running: List[_Tenant] = []

    def _n_running(self) -> int:
        return len(self._running)

    def _running_order(self) -> List[_Tenant]:
        return list(self._running)

    def _running_add(self, t: _Tenant) -> None:
        self._running.append(t)

    def _running_remove(self, t: _Tenant) -> None:
        self._running.remove(t)

    def _has_pending(self) -> bool:
        return bool(self._pending)

    def _enqueue(self, t: _Tenant, tick: int) -> None:
        self._pending.append(t)

    def _dequeue(self, t: _Tenant) -> None:
        self._pending.remove(t)

    def _boost_pending(self) -> None:
        """Paper: the pending job a shrink enables gets top priority."""
        free = len(self._idle)
        fitting = [t for t in self._pending if t.request()[0] <= free]
        if fitting:
            min(fitting, key=lambda t: (t.submit_step, t.submit_s,
                                        t.jid)).boosted = True

    def _try_schedule(self, tick: int) -> None:
        if not self._pending:
            return
        if self.simwl is not None:
            # replay: the simulated scheduler's start order and sizes,
            # strictly — backfilling past a blocked head would deviate
            order = sorted(self._pending,
                           key=lambda t: self.simwl.start_order.get(
                               t.jid, 1 << 30))
            for t in order:
                p = self.simwl.start_procs.get(t.jid, t.params.preferred)
                if p > len(self._idle):
                    break
                self._start(t, p, tick)
            return
        order = sorted(self._pending,
                       key=lambda t: self.policy.priority_key(t, float(tick)))
        for t in order:
            lo, hi = t.request()
            free = len(self._idle)
            if t.moldable and free >= lo:
                self._start(t, t.quantize(min(free, hi)), tick)
            elif not t.moldable and free >= hi:
                self._start(t, hi, tick)
            elif not self.policy.backfill:
                break

    def _live_view(self, t: _Tenant) -> ClusterView:
        return live_view(
            available=len(self._idle),
            pending_min_sizes=[p.request()[0] for p in self._pending]
            + self._demand_sizes(t),
            tenants=self._running, exclude=t)

    def _query_gate(self, t: _Tenant, tick: int) -> bool:
        return True                     # the runner's own guards decide

    def _note_start(self, t: _Tenant, tick: int) -> None:
        pass

    def _note_finish(self, t: _Tenant) -> None:
        pass

    def _note_resize(self, t: _Tenant, old: int, new: int) -> None:
        pass

    def _next_tick(self, tick: int, ai: int, arrivals, timeline,
                   n_done: int) -> int:
        return tick + 1


class Cluster(_ClusterBase):
    """High-throughput event-indexed engine (the default).

    Index structures, mirroring the simulator's fast engine:

    * ``_pq``: a ``repro_torch.rms.eventindex.MinRequestIndex`` over the
      pending tenants — the scheduling scan touches bucket heads that
      fit, not the whole queue, and the post-shrink boost reads the
      arrival heads.  (Cosim replay keeps a start-order heap instead:
      the simulated scheduler already fixed the order.)
    * ``_running``: insertion-ordered dict — start order, O(1) removal.
    * ``_reclaim_total``: the running malleable tenants' pooled
      reclaimable workers, maintained at start/resize/finish, so a
      cluster view is O(1) aggregates instead of an O(running) sweep.
    * ``_due_heap``: §3.2 inhibitor windows as due ticks — a tenant
      whose window is closed is skipped without even calling into its
      runner.  Tenants with *wall-clock* inhibitors (``sched_period_s``)
      fall back to per-tick runner checks, exactly like the reference.
    * dead ticks (nothing running or pending, next arrival in the
      future) are fast-forwarded; the timeline records the skipped
      samples when enabled, and the integer tick arithmetic keeps every
      reported metric bit-identical to the reference engine's.
    """

    def _setup_queues(self) -> None:
        self._dynamic = getattr(self.policy, "dynamic_priority", True)
        self._stateless = getattr(self.policy, "decide_stateless", False)
        self._pending_map: Dict[int, _Tenant] = {}
        self._cosim_heap: List[Tuple[int, int, int]] = []
        self._arr_seq = 0
        self._pq = MinRequestIndex()
        self._running: Dict[int, _Tenant] = {}
        self._reclaim_total = 0
        self._due_heap: List[Tuple[int, int]] = []
        self._due_now: set = set()

    def _n_running(self) -> int:
        return len(self._running)

    def _running_order(self) -> List[_Tenant]:
        return list(self._running.values())

    def _running_add(self, t: _Tenant) -> None:
        self._running[t.jid] = t

    def _running_remove(self, t: _Tenant) -> None:
        del self._running[t.jid]

    def _has_pending(self) -> bool:
        if self.simwl is not None:
            return bool(self._pending_map)
        return bool(self._pq)

    # -- pending queue --------------------------------------------------
    def _enqueue(self, t: _Tenant, tick: int) -> None:
        if self.simwl is not None:
            self._pending_map[t.jid] = t
            heapq.heappush(self._cosim_heap,
                           (self.simwl.start_order.get(t.jid, 1 << 30),
                            self._arr_seq, t.jid))
            self._arr_seq += 1
            return
        key = None if self._dynamic \
            else self.policy.priority_key(t, float(tick))
        self._pq.push(t.jid, t, t.request()[0], key)

    def _dequeue(self, t: _Tenant) -> None:
        if self.simwl is not None:
            del self._pending_map[t.jid]
            return
        self._pq.discard(t.jid)

    def _boost_pending(self) -> None:
        if self.simwl is not None:
            return           # replay order is fixed; the flag is unread
        p = self._pq.earliest_fitting(len(self._idle))
        if p is not None and not p.boosted:
            p.boosted = True
            self._pq.rekey(p.jid, None if self._dynamic
                           else self.policy.priority_key(
                               p, float(self._tick)))

    def _try_schedule(self, tick: int) -> None:
        if self.simwl is not None:
            idx = self._cosim_heap
            pend = self._pending_map
            while idx:
                _so, _seq, jid = idx[0]
                t = pend.get(jid)
                if t is None:
                    heapq.heappop(idx)         # started earlier: stale
                    continue
                p = self.simwl.start_procs.get(jid, t.params.preferred)
                if p > len(self._idle):
                    break                      # strict replay order
                self._start(t, p, tick)
            return
        pq = self._pq
        if not pq or len(self._idle) < pq.min_lo:
            return
        if self._dynamic:
            pq.rebuild(lambda t: self.policy.priority_key(t, float(tick)))
        backfill = self.policy.backfill
        while pq:
            free = len(self._idle)
            t = pq.best(free, backfill)
            if t is None:
                break
            lo, hi = t.request()
            if lo > free:
                break                          # strict FCFS: blocked head
            self._start(t, t.quantize(min(free, hi)) if t.moldable else hi,
                        tick)

    # -- cluster view (O(1) aggregates) ---------------------------------
    def _live_view(self, t: _Tenant) -> ClusterView:
        own = max(0, t.nprocs - t.params.preferred) \
            if t.malleable and not getattr(t, "reclaim_opaque", False) else 0
        pend = self._pq.min_sizes(self._stateless)
        demand = self._demand_sizes(t)
        if demand:
            pend = _WithDemand(pend, demand)
        return ClusterView(
            available=len(self._idle),
            pending_min_sizes=pend,
            reclaimable_others=self._reclaim_total - own)

    # -- inhibitor windows ----------------------------------------------
    def _query_gate(self, t: _Tenant, tick: int) -> bool:
        if t.params.sched_period_s:
            return True                 # wall-clock window: runner decides
        dh = self._due_heap
        dn = self._due_now
        while dh and dh[0][0] <= tick:
            jid = heapq.heappop(dh)[1]
            if jid in self._running:
                dn.add(jid)
        if t.jid in dn:
            dn.discard(t.jid)
            heapq.heappush(dh, (tick + max(t.params.sched_iterations, 1),
                                t.jid))
            return True
        return False

    # -- incremental counters -------------------------------------------
    # reclaim_opaque tenants never enter _reclaim_total: a composite's
    # actual size can drift from the decided target (partial absorbs /
    # immediate-only shrinks), which would silently corrupt the
    # incremental sum — and reclaimable_workers() excludes them on the
    # reference path for the same reason, keeping the engines aligned.
    def _note_start(self, t: _Tenant, tick: int) -> None:
        if t.malleable:
            if not getattr(t, "reclaim_opaque", False):
                self._reclaim_total += max(
                    0, t.runner.current - t.params.preferred)
            if not t.params.sched_period_s:
                heapq.heappush(self._due_heap, (tick, t.jid))

    def _note_finish(self, t: _Tenant) -> None:
        if t.malleable and not getattr(t, "reclaim_opaque", False):
            self._reclaim_total -= max(
                0, t.final_procs - t.params.preferred)

    def _note_resize(self, t: _Tenant, old: int, new: int) -> None:
        if t.malleable and not getattr(t, "reclaim_opaque", False):
            pref = t.params.preferred
            self._reclaim_total += max(0, new - pref) - max(0, old - pref)

    # -- dead-tick fast-forward -----------------------------------------
    def _next_tick(self, tick: int, ai: int, arrivals, timeline,
                   n_done: int) -> int:
        if self._running or ai >= len(arrivals) or self._has_pending():
            return tick + 1
        nxt = min(arrivals[ai].submit_step, self._t0_tick + self.max_ticks)
        if nxt <= tick + 1:
            return tick + 1
        if self.record_timeline:       # the reference samples every tick
            for g in range(tick + 1, nxt):
                timeline["tick"].append(g)
                timeline["allocated"].append(0)
                timeline["running"].append(0)
                timeline["completed"].append(n_done)
        return nxt
