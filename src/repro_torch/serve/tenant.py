"""A whole serving fleet as one ``dmr.Cluster`` tenant (port of
``repro/serve/tenant.py``).

This is tentpole glue for mixed pools — diurnal serving and batch
training co-scheduled on one device pool under one resource manager:

* :class:`ServeTenantSpec` is the workload entry (submit it alongside
  ``LiveJobSpec``s): fleet shape (a ``ServeConfig``), serving policy
  name, and request-*stream parameters*.  It carries parameters rather
  than ``Request`` objects because requests are mutable (the engine
  writes start/finish marks into them); every ``build_runner`` call
  materializes a fresh stream, so the differential harness's
  ``dataclasses.replace`` copies of a spec stay independent across
  engines.
* :class:`ReplicaSetRunner` adapts a :class:`~repro_torch.serve.replica.
  ReplicaSet` to the runner surface ``dmr.Cluster`` drives (``init`` /
  ``step`` / ``maybe_reconfig`` / ``query_due`` / ``events`` /
  ``complete``) *and* the ``MalleableTenant`` pool contract
  (``repro_torch.dmr.tenant``).  One cluster tick steps the fleet one
  serving tick; a cluster expand is absorbed as whole replicas plus in-place
  mesh grows, a cluster shrink lands as replica teardowns and in-place
  mesh shrinks — partial results are fine, the ``ResizeEvent`` records
  what was actually achieved and the unabsorbed remainder sits in the
  fleet's idle list, which is exactly the ``devices[current:]`` tail
  the cluster's ordinary reclaim sweep takes back.

Device accounting invariant: ``devices`` is everything the cluster
granted, ``current`` is what replicas hold, and the difference is the
fleet's idle list — so ``release_devices`` needs no special case and
the schedule-trail auditor balances grants against releases the same
way it does for a training job.

Trail namespacing: the fleet's internal events are forwarded through
``trail_sink`` with replica ``rid`` mapped to ``(parent_jid + 1) *
SUB_JID_BASE + rid`` so the cluster's auditor can track them as
*delegations* of the parent tenant's grant (``repro_torch.analysis.trail``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Tuple

from repro_torch.analysis.trail import SUB_JID_BASE
from repro_torch.core.params import MalleabilityParams
from repro_torch.core.policy import get_policy
from repro_torch.core.redistribute import TransferStats
from repro_torch.dmr.runner import ResizeEvent
from repro_torch.rms.workload import AppProfile
from repro_torch.serve.replica import ReplicaSet, ServeConfig

__all__ = ["ServeTenantSpec", "ReplicaSetRunner"]

_NULL_TRANSFER = TransferStats(bytes_moved=0, seconds=0.0, n_leaves=0)


@dataclasses.dataclass(frozen=True)
class ServeTenantSpec:
    """One serving fleet as a submittable cluster-workload entry.

    Mix freely with ``LiveJobSpec``s in a ``dmr.Cluster`` workload; the
    cluster wraps it in a composite tenant whose resize queries are
    answered by this spec's own serving ``policy`` over the fleet's
    latency surface, while the cluster arbitrates the shared pool
    (blocked serving expands publish their shortfall into the batch
    policy's pending view, so training jobs shrink at the serving
    peak).
    """
    jid: int
    submit_step: int = 0
    config: ServeConfig = dataclasses.field(default_factory=ServeConfig)
    policy: str = "slo-aware"
    scenario: str = "diurnal"
    n_requests: int = 400
    horizon_s: float = 60.0
    mean_prompt: int = 96
    mean_decode: int = 48
    deadline_s: float = 8.0
    seed: int = 0
    submit_s: float = 0.0
    name: str = "serve-fleet"

    @property
    def quantum(self) -> int:
        """The fleet's allocation quantum: devices per replica."""
        return self.config.devices_per_replica

    def device_params(self) -> MalleabilityParams:
        """The fleet's device budget in ``MalleabilityParams`` terms.
        ``sched_iterations=resize_every`` makes the cluster's query
        inhibitor coincide with the fleet's own consult cadence."""
        cfg = self.config
        dpr = cfg.devices_per_replica
        initial = max(cfg.min_replicas,
                      min(cfg.initial_replicas, cfg.max_replicas))
        return MalleabilityParams(
            dpr * cfg.min_replicas, dpr * cfg.max_replicas, dpr * initial,
            sched_iterations=cfg.resize_every)

    def profile(self) -> AppProfile:
        """Cost/priority surface for the cluster's records and policy
        (a serving fleet has no Amdahl curve; flat t(p))."""
        p = self.device_params()
        return AppProfile(name=self.name, t1=600.0, f=1.0, alpha=0.5,
                          c=0.0, min_start=p.min_procs, params=p,
                          state_mb=1.0, iterations=1 << 30)

    def make_requests(self):
        from repro_torch.serve.traffic import make_request_stream
        return make_request_stream(
            self.scenario, self.n_requests, horizon_s=self.horizon_s,
            mean_prompt=self.mean_prompt, mean_decode=self.mean_decode,
            deadline_s=self.deadline_s, seed=self.seed)

    def build_runner(self, tenant, grant: List, p: int, *,
                     listener: Optional[Callable] = None,
                     trail_sink: Optional[Callable] = None
                     ) -> Tuple["ReplicaSetRunner", object]:
        """The ``_CompositeTenant.make_runner`` hook: a fresh fleet over
        the start grant plus its configured serving policy instance."""
        pol = get_policy(self.policy)
        pol.configure(self.config)
        sink = None
        if trail_sink is not None:
            base = (tenant.jid + 1) * SUB_JID_BASE
            sink = (lambda kind, rid, payload:
                    trail_sink(kind, base + rid if rid >= 0 else rid,
                               payload))
        fleet = ReplicaSet(
            self.make_requests(), devices=list(grant), config=self.config,
            external_pool=True, trail_sink=sink, record_trail=False)
        runner = ReplicaSetRunner(tenant, fleet, self.device_params(),
                                  event_listener=listener)
        return runner, pol


class ReplicaSetRunner:
    """The fleet half of the composite tenant: a ``MalleableRunner``-
    shaped adapter over a :class:`ReplicaSet` (see module docstring for
    the device-accounting invariant)."""

    def __init__(self, tenant, fleet: ReplicaSet,
                 params: MalleabilityParams,
                 event_listener: Optional[Callable] = None):
        self.tenant = tenant
        self.fleet = fleet
        self.params = params
        self.rms = tenant.rms            # the cluster's per-tenant RMS
        self.event_listener = event_listener
        self.devices: List = list(fleet._idle)   # everything granted
        self.events: List[ResizeEvent] = []
        self.mesh = None
        self._last_query_step = -10 ** 9
        self._last_query_time = 0.0
        self._done = False

    # -- the MalleableTenant pool contract ------------------------------
    @property
    def current(self) -> int:
        return len(self.devices) - len(self.fleet._idle)

    @property
    def current_size(self) -> int:
        return self.current

    def grant_devices(self, new_devices: List) -> None:
        ids = {d.id for d in self.devices}
        dup = [d.id for d in new_devices if d.id in ids]
        if dup:
            raise ValueError(f"devices {dup} already granted to fleet "
                             f"tenant {self.tenant.jid}")
        self.devices.extend(new_devices)
        self.fleet._idle.extend(new_devices)

    def release_devices(self) -> List:
        released = list(self.fleet._idle)
        del self.fleet._idle[:]
        if released:
            gone = {d.id for d in released}
            self.devices = [d for d in self.devices if d.id not in gone]
        return released

    def shutdown(self) -> List:
        f = self.fleet
        f.finish_fleet()                 # replica-downs flow via the sink
        self.tenant.result = f.build_result()
        del f._idle[:]
        released, self.devices = self.devices, []
        return released

    # -- the runner step/query surface the cluster drives ---------------
    def init(self):
        if self.fleet.absorb_idle() == 0:
            raise RuntimeError("composite start grant below one replica "
                               "quantum")
        return {"i": 0}

    def prewarm(self, sizes=None) -> float:
        return 0.0

    def step(self, state, i: int, *args):
        f = self.fleet
        if not self._done:
            f.tick_once()
            if f.finished:
                self._done = True
            else:
                f._tick += 1
        return state, {}

    @property
    def complete(self) -> bool:
        return self._done

    def query_due(self, step: int) -> bool:
        p = self.params
        if step - self._last_query_step < max(p.sched_iterations, 1):
            return False
        if p.sched_period_s and \
                time.monotonic() - self._last_query_time < p.sched_period_s:
            return False
        return True

    def maybe_reconfig(self, state, step: int):
        if not self.query_due(step):
            return state
        self._last_query_step = step
        self._last_query_time = time.monotonic()
        frm = self.current               # before the grant lands in _idle
        action = self.rms.query(step=step, current=frm, params=self.params)
        f = self.fleet
        if action.kind == "expand":
            # the grant sits in the fleet's idle list: prefer warm
            # in-place mesh grows, then cold-start whole replicas; any
            # unabsorbed remainder is reclaimed by the cluster's sweep
            f._grow_live_replicas(len(f._idle))
            f._add_replicas(len(f._idle) // f.config.devices_per_replica)
        elif action.kind == "shrink":
            self._shrink_toward(action.target)
        to = self.current
        if to != frm:
            ev = ResizeEvent(step=step,
                             action="expand" if to > frm else "shrink",
                             from_procs=frm, to_procs=to,
                             transfer=_NULL_TRANSFER, recompile_s=0.0)
            self.events.append(ev)
            if self.event_listener is not None:
                self.event_listener(ev)
        return state

    def _shrink_toward(self, target: int) -> None:
        """Immediate-only shrink: tear down *empty* replicas, then
        shrink loaded replicas' meshes in place where the active batch
        still fits.  Never drains — a partial shrink just yields less
        than asked, and the achieved size is what the ResizeEvent (and
        the cluster's accounting) records."""
        f = self.fleet
        cfg = f.config
        target = max(target, self.params.min_procs)
        for rep in sorted(f._live(), key=lambda r: (len(r.active), -r.rid)):
            if self.current <= target:
                return
            if rep.active:
                break                    # sorted: no empties remain
            if len(f._live()) <= cfg.min_replicas or \
                    self.current - rep.current_size < target:
                continue
            f._replica_down(rep)
            f.n_scale_downs += 1
        for rep in sorted(f._live(), key=lambda r: (len(r.active), -r.rid)):
            while self.current > target:
                cur = rep.current_size
                cand = [s for s in rep.params.legal_sizes()
                        if s < cur and len(rep.active) <= s *
                        cfg.slots_per_device
                        and self.current - (cur - s) >= target]
                if not cand:
                    break
                f._shrink_in_place(rep, max(cand))
            if self.current <= target:
                return
