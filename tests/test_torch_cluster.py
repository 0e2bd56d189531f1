"""The port's live multi-tenant cluster against the JAX package's, on the CPU.

* The paper's live grid (``benchmarks/live_cluster.py``'s: the ``steady``
  scenario, six jobs of ten steps, limits scaled to half of an eight-worker
  pool, a compressed arrival span; static/rigid, then ``algorithm2`` and
  ``throughput-greedy`` each rigid and moldable, then a ``decisions="cosim"``
  replay): both port engines on eight CPU workers, sanitized, against the
  JAX ``Cluster`` on eight host devices (a subprocess).  ``summary()``
  (all but ``wall_s``), every job's record, its resize events (with the
  bytes each moved) and the schedule trail must be identical, and every
  tenant's final state must be its initial vector after each of its steps.
* A composite tenant beside training jobs in ``sched_only``, as a stand-in
  serving fleet (written once over either package's types) and as each
  package's own ``ServeTenantSpec``: both port engines against the JAX
  package's, its published demand, its reclaim-opaque excess, its replicas
  (and the real fleet's in-place grows and shrinks) as delegations in the
  trail, and the faults the delegation ledger catches.
* ``Cluster.sched_only`` replays of a 2,000-job synthetic SWF trace, both
  engines against the JAX package's, and the co-simulation crosscheck.
* The slice as a whole: three ``mamba2-370m-smoke`` training tenants
  (``lm_train_app``, fp32) under ``Cluster`` against the same JAX run;
  equal summary and trail, every tenant's losses within 1e-4.
* The runner's pool surface and the ``MalleableTenant`` contract.
"""
import dataclasses
import json
import pickle

import numpy as np
import pytest
import torch

from repro.dmr import Cluster as JCluster
from repro.rms import workload as jwl
from repro_torch import dmr
from repro_torch.analysis import (TrailViolation, audit_trail,
                                  audit_trail_file, dump_trail, job_metadata)
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.lm_app import lm_train_app
from repro_torch.core.params import MalleabilityParams
from repro_torch.dmr.cluster import _null_redistribute, _sched_only_mesh
from repro_torch.interop import train_state_from_numpy
from repro_torch.optim import AdamW
from repro_torch.parallel.mesh import Worker, logical_workers
from repro_torch.rms import materialize_live
from repro_torch.rms import workload as twl
from tests.util import run_devices

#: (label, policy, mode, malleable, decisions): the live benchmark's grid
GRID = [("static/rigid", "algorithm2", "rigid", False, "policy"),
        ("algorithm2/rigid", "algorithm2", "rigid", True, "policy"),
        ("algorithm2/moldable", "algorithm2", "moldable", True, "policy"),
        ("throughput-greedy/rigid", "throughput-greedy", "rigid", True,
         "policy"),
        ("throughput-greedy/moldable", "throughput-greedy", "moldable", True,
         "policy"),
        ("cosim/algorithm2", "algorithm2", "moldable", True, "cosim")]
N_JOBS, MAX_STEPS = 6, 10
LOSS_TOL = 1e-4                 # tests/test_elastic.py's bound

GRID_SCRIPT = r"""
import dataclasses, pickle
import jax
import repro.dmr as dmr
from repro.rms import materialize_live
GRID = %r
out = {}
for label, policy, mode, malleable, decisions in GRID:
    specs = materialize_live("steady", n_jobs=%d, max_steps=%d,
                             device_count=4, mode=mode,
                             malleable=malleable, seed=0, arrival_span=10)
    cl = dmr.Cluster(specs, jax.devices()[:8], policy=policy,
                     decisions=decisions, sanitize=True)
    res = cl.run()
    xc = cl.crosscheck(res) if decisions == "cosim" else None
    out[label] = dict(
        summary=res.summary(), trail=cl.trail,
        records=[dataclasses.astuple(r) for r in res.records],
        events={j: [(e.step, e.action, e.from_procs, e.to_procs,
                     e.transfer.bytes_moved, e.transfer.n_leaves)
                    for e in ev] for j, ev in res.events_by_jid.items()},
        timeline=res.timeline, crosscheck=xc)
with open(%r, "wb") as f:
    pickle.dump(out, f)
"""


def _grid_specs(mode, malleable, mod=twl):
    return mod.materialize_live("steady", n_jobs=N_JOBS, max_steps=MAX_STEPS,
                                device_count=4, mode=mode,
                                malleable=malleable, seed=0, arrival_span=10)


def _observed(cl, res):
    """Everything the two packages must agree on (``wall_s`` is real
    time and left out, as the reference's equivalence tests do)."""
    s = dict(res.summary())
    s.pop("wall_s")
    return dict(
        summary=s, trail=cl.trail,
        records=[dataclasses.astuple(r) for r in res.records],
        events={j: [(e.step, e.action, e.from_procs, e.to_procs,
                     e.transfer.bytes_moved, e.transfer.n_leaves)
                    for e in ev] for j, ev in res.events_by_jid.items()},
        timeline=res.timeline)


@pytest.fixture(scope="module")
def jax_grid(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jgrid") / "grid.pkl")
    run_devices(GRID_SCRIPT % (GRID, N_JOBS, MAX_STEPS, path), timeout=600)
    with open(path, "rb") as f:
        out = pickle.load(f)
    for v in out.values():
        v["summary"].pop("wall_s")
    return out


def _recording_factory(finals):
    """``default_app_factory`` whose step also keeps each tenant's latest
    state in ``finals`` (jid -> state): the cluster drops a finished
    tenant's state, so this is how a test reads it."""
    def factory(spec):
        app = dmr.default_app_factory(spec)

        def step(mesh):
            f = app.make_step(mesh)

            def g(state, i, *a):
                state, metrics = f(state, i, *a)
                finals[spec.jid] = state
                return state, metrics
            return g
        return dmr.App(init=app.init_state, shardings=app.state_shardings,
                       step=step, name=app.name)
    return factory


def run_grid_entry(engine, label, devices, finals=None):
    _, policy, mode, malleable, decisions = next(g for g in GRID
                                                 if g[0] == label)
    kw = {} if finals is None else {"app_factory": _recording_factory(finals)}
    cl = engine(_grid_specs(mode, malleable), devices, policy=policy,
                decisions=decisions, sanitize=True, **kw)
    res = cl.run()
    return cl, res


@pytest.mark.parametrize("engine", [dmr.Cluster, dmr.ReferenceCluster])
@pytest.mark.parametrize("label", [g[0] for g in GRID])
def test_live_grid_matches_jax(jax_grid, label, engine):
    finals = {}
    cl, res = run_grid_entry(engine, label, logical_workers(8, "cpu"),
                             finals)
    got = _observed(cl, res)
    want = jax_grid[label]
    for key in ("summary", "records", "events", "trail", "timeline"):
        assert got[key] == want[key], key
    # every tenant's state took each of its steps, through every resize:
    # the same ops applied steps times to the initial vector
    for t in cl.tenants:
        x = torch.arange(840, dtype=torch.float32)
        for _ in range(t.steps):
            x = x * 1.000001 + 1e-3
        assert int(finals[t.jid]["i"]) == t.steps
        assert torch.equal(finals[t.jid]["x"], x), t.jid
    assert cl._sanitizer.violations == []
    assert cl._sanitizer.n_events == len(cl.trail)
    if label.startswith("cosim"):
        assert cl.crosscheck(res) == want["crosscheck"]
        assert res.n_resizes == len(cl.simwl.resize_log) > 0


def test_live_grid_malleable_beats_static(jax_grid):
    """The live benchmark's assertion: every malleable configuration
    completes more jobs per (tick) second than the rigid-static one."""
    jps = {}
    for label, *_ in GRID[:5]:
        _, res = run_grid_entry(dmr.Cluster, label,
                                logical_workers(8, "cpu"))
        jps[label] = res.summary()["throughput_jps"]
    for label, v in jps.items():
        if label != "static/rigid":
            assert v > jps["static/rigid"], (label, jps)


def test_default_app_moves_its_state_on_every_resize():
    """The toy tenants' vector really moves: a tenant's state after its
    steps equals the same number of steps without a resize."""
    seen = {}

    def factory(spec):
        app = dmr.default_app_factory(spec)
        inner = app.make_step

        def step(mesh):
            f = inner(mesh)

            def run(state, i, *a):
                out = f(state, i, *a)
                seen.setdefault(spec.jid, []).append(out[0]["x"].clone())
                return out
            return run
        return dmr.App(init=app.init_state, shardings=app.state_shardings,
                       step=step, name=app.name)
    specs = _grid_specs("moldable", True)
    res = dmr.Cluster(specs, logical_workers(8, "cpu"), policy="algorithm2",
                      app_factory=factory).run()
    assert res.n_resizes > 0
    x = torch.arange(840, dtype=torch.float32)
    for spec in specs:
        want = x
        for got in seen[spec.jid]:
            want = want * 1.000001 + 1e-3
            assert torch.equal(got, want)
        assert len(seen[spec.jid]) == spec.steps
    moved = [e.transfer.bytes_moved for ev in res.events_by_jid.values()
             for e in ev]
    assert set(moved) == {840 * 4 + 4}


# -- scheduling-only replays at trace scale -----------------------------------

def _swf_specs(mod, n=2000):
    jobs, ov = mod.parse_swf(mod.generate_synthetic_swf(n, seed=0),
                             max_jobs=n)
    specs = mod.materialize_live(jobs, device_count=ov["nodes"],
                                 max_steps=4,
                                 arrival_span=max(1, len(jobs) * 4 // 12))
    return specs, ov["nodes"]


@pytest.mark.parametrize("decisions", ["policy", "cosim"])
def test_sched_only_swf_replay_matches_jax(decisions):
    """~2,000 synthetic SWF jobs through ``sched_only``: both port engines
    and the JAX event engine give one summary, one set of records and one
    schedule trail; the trail audits clean; cosim crosschecks."""
    kw = dict(policy="algorithm2", record_timeline=False, audit=False,
              record_trail=True, decisions=decisions)
    jspecs, nodes = _swf_specs(jwl)
    jcl = JCluster.sched_only(jspecs, n_devices=nodes, **kw)
    want = _observed(jcl, jcl.run())
    specs, _ = _swf_specs(twl)
    assert len(specs) == 2000
    for engine in (dmr.Cluster, dmr.ReferenceCluster):
        cl = engine.sched_only([dataclasses.replace(s) for s in specs],
                               n_devices=nodes, **kw)
        res = cl.run()
        assert _observed(cl, res) == want, engine.__name__
        assert audit_trail(cl.trail, cl._pool_ids,
                           jobs=job_metadata(cl),
                           check_spacing=decisions != "cosim") == []
        if decisions == "cosim":
            assert cl.crosscheck(res) == jcl.crosscheck(jcl.run())
        else:
            assert res.n_resizes > 1000


def test_trail_artifact_crosses_packages(tmp_path):
    """A trail the port dumps audits clean in both packages' file audit,
    and a corrupted one fails in both."""
    from repro.analysis import audit_trail_file as j_audit_trail_file
    specs = materialize_live("bursty", n_jobs=12, device_count=16, seed=9)
    cl = dmr.Cluster.sched_only(specs, n_devices=16, policy="algorithm2",
                                record_trail=True)
    cl.run()
    path = str(tmp_path / "trail.json")
    dump_trail(cl, path)
    assert audit_trail_file(path) == [] and j_audit_trail_file(path) == []
    raw = json.load(open(path))
    g = next(i for i, e in enumerate(raw["trail"]) if e[0] == "grant")
    raw["trail"].insert(g + 1, raw["trail"][g])
    json.dump(raw, open(path, "w"))
    for fn in (audit_trail_file, j_audit_trail_file):
        assert any(v.kind == "double-grant" for v in fn(path))


@pytest.mark.parametrize("engine", [dmr.Cluster, dmr.ReferenceCluster])
def test_sanitizer_catches_live_corruption(engine):
    """A scheduler bug (a device vanishing on release) trips the live
    sanitizer at once, with the per-tick sweep off."""
    specs = materialize_live("bursty", n_jobs=10, device_count=16, seed=4)

    class Leaky(engine):
        def _reclaim(self, t, released):
            super()._reclaim(t, released[:-1])

    cl = Leaky.sched_only(specs, n_devices=16, policy="algorithm2",
                          audit=False, sanitize=True)
    with pytest.raises((TrailViolation, RuntimeError)):
        cl.run()


# ----------------------------------------------------------------------
# composite tenants: a stand-in fleet written once over either package
# ----------------------------------------------------------------------

def _package(torch_side):
    """The types a composite spec needs, from the port or the JAX
    package."""
    if torch_side:
        from repro_torch.analysis.trail import SUB_JID_BASE
        from repro_torch.core.policy import Action
        from repro_torch.core.redistribute import TransferStats
        from repro_torch.dmr.runner import ResizeEvent
        from repro_torch.rms.workload import AppProfile
        params = MalleabilityParams
    else:
        from repro.analysis.trail import SUB_JID_BASE
        from repro.core.params import MalleabilityParams as params
        from repro.core.policy import Action
        from repro.core.redistribute import TransferStats
        from repro.dmr.runner import ResizeEvent
        from repro.rms.workload import AppProfile
    return dict(SUB_JID_BASE=SUB_JID_BASE, Action=Action,
                TransferStats=TransferStats, ResizeEvent=ResizeEvent,
                AppProfile=AppProfile, MalleabilityParams=params)


#: the stand-in fleet's replica demand by its own tick: it starts at two
#: replicas, asks for a third at the peak (when the training co-tenants
#: hold the rest of the pool), then falls back to one
FLEET_DEMAND = [2] * 3 + [3] * 14 + [1] * 8


class _FleetPolicy:
    """The fleet's own resize policy: follow ``FLEET_DEMAND``."""

    def __init__(self, ns, quantum):
        self.ns, self.quantum = ns, quantum

    def decide(self, current, params, view, job=None):
        want = FLEET_DEMAND[min(job.tick, len(FLEET_DEMAND) - 1)] * \
            self.quantum
        Action = self.ns["Action"]
        if want > current:
            return Action("expand", want)
        if want < current:
            return Action("shrink", want)
        return Action.none(current)


class _FleetRunner:
    """The runner half of the stand-in fleet, shaped as the JAX package's
    ``ReplicaSetRunner``: ``devices`` is everything granted, whole
    replicas of ``quantum`` devices hold ``current`` of them, the rest is
    idle and is what the cluster's reclaim sweep takes back.  Replica
    lifecycles go to the cluster's trail as delegations of the grant."""

    def __init__(self, ns, tenant, grant, params, quantum, lifetime,
                 listener, sink):
        self.ns, self.tenant, self.params = ns, tenant, params
        self.quantum, self.lifetime = quantum, lifetime
        self.rms = tenant.rms
        self.event_listener, self.sink = listener, sink
        self.devices = list(grant)
        self.idle = list(grant)
        self.replicas = {}
        self.next_rid = 0
        self.tick = 0
        self.events = []
        self.mesh = None
        self._last_query_step = -10 ** 9
        self.complete = False

    @property
    def fleet(self):
        return self

    @property
    def current(self):
        return len(self.devices) - len(self.idle)

    current_size = current

    def _emit(self, kind, rid, ids):
        if self.sink is not None:
            self.sink(kind, rid, tuple(d.id for d in ids))

    def _add_replicas(self, n):
        for _ in range(n):
            devs, self.idle = (self.idle[:self.quantum],
                               self.idle[self.quantum:])
            self.replicas[self.next_rid] = devs
            self._emit("replica-up", self.next_rid, devs)
            self.next_rid += 1

    def _replica_down(self, rid):
        devs = self.replicas.pop(rid)
        self._emit("replica-down", rid, devs)
        self.idle.extend(devs)

    def grant_devices(self, new_devices):
        self.devices.extend(new_devices)
        self.idle.extend(new_devices)

    def release_devices(self):
        released, self.idle = self.idle, []
        gone = {d.id for d in released}
        self.devices = [d for d in self.devices if d.id not in gone]
        return released

    def shutdown(self):
        for rid in list(self.replicas):
            self._replica_down(rid)
        self.tenant.result = {"ticks": self.tick,
                              "replicas": self.next_rid}
        released, self.devices, self.idle = self.devices, [], []
        return released

    def init(self):
        self._add_replicas(len(self.idle) // self.quantum)
        if not self.replicas:
            raise RuntimeError("start grant below one replica")
        return {"i": 0}

    def step(self, state, i, *args):
        self.tick += 1
        self.complete = self.tick >= self.lifetime
        return state, {}

    def query_due(self, step):
        return step - self._last_query_step >= \
            max(self.params.sched_iterations, 1)

    def maybe_reconfig(self, state, step):
        if not self.query_due(step):
            return state
        self._last_query_step = step
        frm = self.current
        act = self.rms.query(step=step, current=frm, params=self.params)
        if act.kind == "expand":
            self._add_replicas(len(self.idle) // self.quantum)
        elif act.kind == "shrink":
            target = max(act.target, self.params.min_procs)
            for rid in sorted(self.replicas, reverse=True):
                if self.current - self.quantum < target:
                    break
                self._replica_down(rid)
        to = self.current
        if to != frm:
            ev = self.ns["ResizeEvent"](
                step=step, action="expand" if to > frm else "shrink",
                from_procs=frm, to_procs=to,
                transfer=self.ns["TransferStats"](bytes_moved=0,
                                                  seconds=0.0, n_leaves=0),
                recompile_s=0.0)
            self.events.append(ev)
            if self.event_listener is not None:
                self.event_listener(ev)
        return state


@dataclasses.dataclass(frozen=True)
class _FleetSpec:
    """A stand-in serving fleet as one composite cluster tenant (the
    surface of the JAX package's ``ServeTenantSpec``): whole replicas of
    ``quantum`` workers, between one and four of them."""
    ns: dict
    jid: int = 100
    submit_step: int = 0
    quantum: int = 2
    initial: int = 2
    lifetime: int = len(FLEET_DEMAND)

    def device_params(self):
        q = self.quantum
        return self.ns["MalleabilityParams"](q, 4 * q, self.initial * q,
                                             sched_iterations=2)

    def profile(self):
        p = self.device_params()
        return self.ns["AppProfile"](
            name="fleet", t1=600.0, f=1.0, alpha=0.5, c=0.0,
            min_start=p.min_procs, params=p, state_mb=1.0,
            iterations=1 << 30)

    def build_runner(self, tenant, grant, p, *, listener=None,
                     trail_sink=None):
        sink = None
        if trail_sink is not None:
            base = (tenant.jid + 1) * self.ns["SUB_JID_BASE"]
            sink = (lambda kind, rid, payload:
                    trail_sink(kind, base + rid, payload))
        runner = _FleetRunner(self.ns, tenant, grant, self.device_params(),
                              self.quantum, self.lifetime, listener, sink)
        return runner, _FleetPolicy(self.ns, self.quantum)


#: case -> (workload seed, fleet's preferred replicas, the fleet's resizes).
#: "demand": the peak expand is blocked while training holds the pool, is
#: published as demand, and lands once co-tenants shrink.  "opaque": the
#: fleet stands two replicas above its preferred one while co-tenants'
#: line-6 shrinks are decided, which its excess must not enter.
COMPOSITE_CASES = {
    "demand": (1, 2, [("expand", 4, 6), ("shrink", 6, 2)]),
    "opaque": (4, 1, [("expand", 2, 4), ("expand", 4, 6), ("shrink", 6, 2)]),
}


#: the real fleet (``ServeTenantSpec``) in the same two cases: case ->
#: (preferred replicas, horizon of its 100-request diurnal stream, the
#: fleet's resizes).  Replicas of two workers that may grow in place to
#: four, at most four replicas, consulted every second tick.  "demand":
#: its expands block while training holds the pool and are published;
#: "opaque": it grows from one replica to the whole pool and back with
#: nothing published
SERVE_CASES = {
    "demand": (2, 2.0, [("expand", 4, 6), ("shrink", 6, 4), ("expand", 4, 6),
                        ("expand", 6, 8), ("shrink", 8, 6), ("shrink", 6, 4),
                        ("shrink", 4, 2)]),
    "opaque": (1, 0.5, [("expand", 2, 4), ("expand", 4, 6), ("expand", 6, 8),
                        ("shrink", 8, 6), ("shrink", 6, 4), ("shrink", 4, 2)]),
}
FLEETS = ["stand-in", "serve"]


def _serve_spec(torch_side, case):
    if torch_side:
        from repro_torch import serve as pkg
    else:
        from repro import serve as pkg
    initial, horizon, _ = SERVE_CASES[case]
    cfg = pkg.ServeConfig(devices_per_replica=2, min_replicas=1,
                          max_replicas=4, initial_replicas=initial,
                          max_devices_per_replica=4, cold_start_ticks=4,
                          grow_ticks=1, resize_every=2)
    return pkg.ServeTenantSpec(jid=100, config=cfg, scenario="diurnal",
                               n_requests=100, horizon_s=horizon,
                               seed=COMPOSITE_CASES[case][0])


def _mixed_pool(cluster_cls, torch_side, case="demand", fleet="stand-in",
                **kw):
    """Six steady training jobs beside a serving fleet (the stand-in, or
    the package's own ``ServeTenantSpec``), on eight synthetic workers,
    sanitized."""
    seed, initial, _ = COMPOSITE_CASES[case]
    mod = twl if torch_side else jwl
    specs = mod.materialize_live("steady", n_jobs=6, max_steps=16,
                                 device_count=8, seed=seed)
    spec = _FleetSpec(_package(torch_side), initial=initial) \
        if fleet == "stand-in" else _serve_spec(torch_side, case)
    return cluster_cls.sched_only(list(specs) + [spec], n_devices=8,
                                  policy="algorithm2", sanitize=True, **kw)


@pytest.mark.parametrize("fleet", FLEETS)
@pytest.mark.parametrize("case", list(COMPOSITE_CASES))
@pytest.mark.parametrize("engine", [dmr.Cluster, dmr.ReferenceCluster])
def test_composite_tenant_matches_jax(engine, case, fleet):
    """A composite tenant through both port engines and the JAX package's
    event engine: equal summary, records, resize events and trail; the
    fleet's replicas show in the trail as delegations of its grant and
    audit clean in both packages.  The real fleet also grows and shrinks
    its replicas in place inside the grant, and its serving result equals
    the JAX fleet's."""
    from repro.analysis import audit_trail as j_audit_trail
    from repro.analysis import job_metadata as j_job_metadata
    jcl = _mixed_pool(JCluster, False, case, fleet)
    want = _observed(jcl, jcl.run())
    cl = _mixed_pool(engine, True, case, fleet)
    published = []
    decide = cl._decide

    def spy(t, step, current, params):
        act = decide(t, step, current, params)
        published.append(dict(cl._demand))
        return act
    cl._decide = spy
    res = cl.run()
    assert _observed(cl, res) == want
    assert cl._sanitizer.violations == []
    tenant = next(t for t in cl.tenants if getattr(t, "composite", False))
    base = (tenant.jid + 1) * 1_000_000
    kinds = {k for k, jid, _, _ in cl.trail if jid >= base}
    assert audit_trail(cl.trail, cl._pool_ids, jobs=job_metadata(cl)) == []
    assert j_audit_trail(cl.trail, cl._pool_ids,
                         jobs=j_job_metadata(jcl)) == []
    if fleet == "stand-in":
        assert tenant.result["replicas"] == 3
        assert kinds == {"replica-up", "replica-down"}
        expect = COMPOSITE_CASES[case][2]
    else:
        jtenant = next(t for t in jcl.tenants
                       if getattr(t, "composite", False))
        got, ref = tenant.result, jtenant.result
        assert got.summary() == ref.summary()
        assert (got.timeline, got.scale_events, got.metrics.cdf()) == \
            (ref.timeline, ref.scale_events, ref.metrics.cdf())
        assert got.summary()["n_completed"] == 100
        assert kinds == {"replica-up", "replica-down", "grant", "release",
                         "replica-resize"}
        expect = SERVE_CASES[case][2]
    assert [(e.action, e.from_procs, e.to_procs)
            for e in res.events_by_jid[tenant.jid]] == expect
    assert any(e.action == "shrink" for j, ev in res.events_by_jid.items()
               if j != tenant.jid for e in ev)
    # only a blocked expand publishes demand
    assert any(tenant.jid in d for d in published) == (case == "demand")


@pytest.mark.parametrize("fleet", FLEETS)
def test_composite_tenant_delegation_faults_are_caught(fleet):
    """The delegation ledger: a replica given a device outside its fleet's
    grant, and a fleet releasing a device a live replica still runs on,
    are each the first fault both packages' audit finds."""
    from repro.analysis import audit_trail as j_audit_trail
    cl = _mixed_pool(dmr.Cluster, True, fleet=fleet)
    cl.run()
    jid = 100
    base = (jid + 1) * 1_000_000
    trail = list(cl.trail)
    up = next(i for i, e in enumerate(trail)
              if e[0] == "replica-up" and e[1] >= base)
    held = next(e[2] for e in trail[:up]
                if e[0] == "grant" and e[1] == jid)
    kind, rid, ids, tick = trail[up]
    foreign = next(d for d in cl._pool_ids if d not in held)
    outside = trail[:up] + [(kind, rid, (foreign,) + ids[1:], tick)] + \
        trail[up + 1:]
    down = next(i for i, e in enumerate(trail)
                if e[0] == "replica-down" and e[1] >= base)
    early = trail[:down] + trail[down + 1:]
    meta = job_metadata(cl)
    for audit in (audit_trail, j_audit_trail):
        first = audit(outside, cl._pool_ids, jobs=meta)[0]
        assert (first.kind, first.jid) == ("delegation-outside-grant",
                                            trail[up][1])
        first = audit(early, cl._pool_ids, jobs=meta)[0]
        assert first.kind == "bad-release" and first.jid == jid
        assert "delegation not withdrawn" in first.detail


@pytest.mark.parametrize("fleet", FLEETS)
def test_composite_tenant_refuses_cosim(fleet):
    with pytest.raises(ValueError, match="composite"):
        _mixed_pool(dmr.Cluster, True, fleet=fleet, decisions="cosim")


def test_cluster_is_reentrant_and_validates():
    cl = dmr.Cluster(_grid_specs("moldable", True),
                     logical_workers(8, "cpu"), policy="algorithm2")
    a, b = cl.run().summary(), cl.run().summary()
    a.pop("wall_s"), b.pop("wall_s")
    assert a == b
    app = dmr.SchedOnlyApp()
    pool = logical_workers(8, "cpu")
    with pytest.raises(ValueError, match="can never start"):
        dmr.Cluster([(app, MalleabilityParams(16, 32, 16), 0)], pool)
    with pytest.raises(ValueError, match="decisions="):
        dmr.Cluster(_grid_specs("moldable", True), pool, decisions="bogus")
    with pytest.raises(TypeError, match="workload entry"):
        dmr.Cluster([42], pool)
    dup = _grid_specs("moldable", True)[:2]
    with pytest.raises(ValueError, match="duplicate jids"):
        dmr.Cluster(dup + dup, pool)
    with pytest.raises(ValueError, match="duplicate device ids"):
        dmr.Cluster(dup, pool + pool[:1])
    with pytest.raises(ValueError, match="crosscheck needs"):
        cl.crosscheck(None)


def test_explicit_app_spec_tuples():
    """``(app, params, submit_step[, mode[, malleable]])`` entries, with
    real state on CPU workers."""
    app = dmr.default_app_factory(_grid_specs("moldable", True)[0])
    params = MalleabilityParams(2, 8, 4)
    res = dmr.Cluster([(app, params, 0, "rigid"),
                       (app, params, 0, "moldable", False)],
                      logical_workers(8, "cpu"), default_steps=6).run()
    assert res.records[0].start_procs == 8
    assert res.records[1].resizes == []
    assert [r.end_tick - r.start_tick for r in res.records] == [6, 6]


# -- no pool, no card ---------------------------------------------------------

def test_no_pool_and_no_card_raises(monkeypatch):
    """A cluster or runner given no pool builds eight workers (the runner:
    ``max_procs``) on the card, and raises where there is none: there is
    no quiet CPU pool."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dmr.Cluster(_grid_specs("moldable", True))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dmr.MalleableRunner(dmr.SchedOnlyApp(), MalleabilityParams(2, 8, 4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        logical_workers(8)


# -- the runner's pool surface ------------------------------------------------

def _runner(n=8, params=None, rms=None, **kw):
    return dmr.MalleableRunner(
        dmr.default_app_factory(_grid_specs("moldable", True)[0]),
        params or MalleabilityParams(2, 8, 4),
        rms if rms is not None or "policy" in kw else dmr.ScriptedRMS({}),
        devices=logical_workers(n, "cpu"), **kw)


def test_grant_devices_rejects_duplicates_and_extends():
    r = _runner(4, allow_partial=True)
    r.grant_devices([Worker(100, torch.device("cpu")),
                     Worker(101, torch.device("cpu"))])
    assert len(r.devices) == 6
    with pytest.raises(ValueError, match="already in this runner's pool"):
        r.grant_devices([Worker(100, torch.device("cpu"))])


def test_release_devices_trims_to_current_and_drops_stale_closures():
    r = _runner(8, initial_procs=8)
    assert r.current_size == 8
    r.prewarm()
    assert set(r._step_cache) == {2, 4, 8}
    r.current = 4                                  # as if shrunk
    released = r.release_devices()
    assert [w.id for w in released] == [4, 5, 6, 7]
    assert set(r._step_cache) == {2, 4}
    assert r.release_devices() == []               # idempotent
    assert len(r.shutdown()) == 4
    assert r.devices == [] and r._step_cache == {}


def test_partial_pool_runner_start():
    with pytest.raises(ValueError, match="allow_partial"):
        _runner(4, initial_procs=4)
    r = _runner(4, initial_procs=4, allow_partial=True)
    assert r.current == 4
    with pytest.raises(ValueError, match="to start"):
        _runner(2, initial_procs=4, allow_partial=True)
    assert _runner(8, initial_procs=99).current == 8   # clamped


def test_runner_hooks_and_query_due():
    """``event_listener`` sees each applied resize, a custom
    ``redistribute`` replaces the patterns, ``mesh_factory`` the job
    meshes, and ``query_due`` honours the inhibitor window."""
    seen, calls = [], []

    def redist(state, shardings):
        calls.append(len(shardings))
        return state, dmr.TransferStats(bytes_moved=7, seconds=0.0,
                                        n_leaves=1)
    r = dmr.MalleableRunner(
        dmr.SchedOnlyApp(), MalleabilityParams(1, 8, 2,
                                               sched_iterations=2),
        dmr.ScriptedRMS({2: 8}), devices=logical_workers(8, "cpu"),
        mesh_factory=_sched_only_mesh, redistribute=redist,
        event_listener=seen.append)
    assert r.mesh == ("sched-mesh", 2)
    state = r.init()
    for i in range(4):
        assert r.query_due(i) == (i % 2 == 0)
        state = dmr.reconfig(r, state, i)
        state, _ = r.step(state, i)
    assert [(e.action, e.from_procs, e.to_procs) for e in seen] == \
        [("expand", 2, 8)]
    assert seen[0].transfer.bytes_moved == 7 and seen[0].per_pattern == {}
    assert calls == [1] and state == {"i": 4}
    with pytest.raises(ValueError, match="not both"):
        dmr.MalleableRunner(dmr.SchedOnlyApp(), MalleabilityParams(1, 8, 2),
                            dmr.ScriptedRMS({}), policy="energy",
                            devices=logical_workers(8, "cpu"))


def test_cluster_view_keyword_drives_the_policy():
    r = _runner(8, policy="algorithm2",
                cluster_view=lambda: dmr.ClusterView(
                    available=0, pending_min_sizes=[4],
                    reclaimable_others=0))
    r.current = 8
    state = r.maybe_reconfig(r.app.init_state(r._mesh_for(8)), 0)
    assert [(e.action, e.from_procs, e.to_procs) for e in r.events] == \
        [("shrink", 8, 4)]
    assert state["x"].shape == (840,)


def test_tenant_contract():
    """Runner and cluster tenant both satisfy ``MalleableTenant`` and
    move workers through it identically."""
    from repro_torch.dmr.cluster import _Tenant
    pool = logical_workers(8, "cpu")

    def runner(devs):
        return dmr.MalleableRunner(
            dmr.SchedOnlyApp(), MalleabilityParams(2, 8, 2),
            devices=list(devs), initial_procs=2, allow_partial=True,
            mesh_factory=_sched_only_mesh, redistribute=_null_redistribute)
    t = _Tenant(materialize_live("steady", 1, device_count=8, max_steps=4,
                                 seed=0)[0], dmr.SchedOnlyApp())
    t.runner = runner(pool[:2])
    for holder in (runner(pool[:2]), t):
        assert isinstance(holder, dmr.MalleableTenant)
        assert holder.current_size == 2
        holder.grant_devices(pool[2:5])
        assert holder.release_devices() == pool[2:5]
        assert holder.shutdown() == pool[:2]


# -- the slice as a whole: real training tenants ------------------------------

LM_ARCH = "mamba2-370m-smoke"
LM_SHAPE = ShapeConfig("t", "train", 64, 8)
LM_POLICY, LM_JOBS, LM_STEPS = "throughput-greedy", 3, 4

LM_SCRIPT = r"""
import pickle, sys
import jax, numpy as np
import repro.dmr as dmr
from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.core.lm_app import lm_train_app
from repro.optim import AdamW
from repro.rms import materialize_live
cfg = get_config(%r)
shape = ShapeConfig("t", "train", 64, 8)
losses, init = {}, {}

def factory(spec):
    app = lm_train_app(cfg, shape, AdamW(learning_rate=1e-3), seed=spec.jid)
    def init_fn(mesh):
        st = app.init_state(mesh)
        init[spec.jid] = jax.tree.map(np.asarray, st)
        return st
    def step(mesh):
        fn = app.make_step(mesh)
        def run(state, i, *a):
            state, m = fn(state, i, *a)
            losses.setdefault(spec.jid, []).append(float(m["loss"]))
            return state, m
        return run
    return dmr.App(init=init_fn, shardings=app.state_shardings, step=step,
                   name=app.name)

specs = materialize_live("steady", n_jobs=%d, device_count=8,
                         max_steps=%d, seed=0)
cl = dmr.Cluster(specs, jax.devices()[:8], policy=%r, app_factory=factory,
                 sanitize=True)
res = cl.run()
s = res.summary()
s.pop("wall_s")
with open(%r, "wb") as f:
    pickle.dump(dict(summary=s, trail=cl.trail, losses=losses, init=init,
                     records=[(r.jid, r.start_tick, r.end_tick,
                               r.start_procs, r.final_procs,
                               tuple(r.resizes)) for r in res.records],
                     bytes={j: [e.transfer.bytes_moved for e in ev]
                            for j, ev in res.events_by_jid.items()}), f)
"""


def test_mamba2_smoke_tenants_match_jax(tmp_path):
    """Three ``mamba2-370m-smoke`` training tenants (fp32, global batch 8
    of 64 tokens, AdamW 1e-3, seeded by jid) under ``throughput-greedy``
    on eight workers: the tenants run at 8, 4, 2 and 6 workers (6 does not
    divide the batch, so its placement falls back to fewer mesh axes).
    Each port tenant starts from its JAX twin's initial state.  Summary,
    records and trail equal the JAX run's; every tenant's losses are
    within 1e-4 of its JAX twin's; each resize moves the whole state."""
    path = str(tmp_path / "lm.pkl")
    run_devices(LM_SCRIPT % (LM_ARCH, LM_JOBS, LM_STEPS, LM_POLICY, path),
                timeout=600)
    with open(path, "rb") as f:
        want = pickle.load(f)
    cfg = get_config(LM_ARCH)
    losses = {}

    def factory(spec):
        app = lm_train_app(cfg, LM_SHAPE, AdamW(learning_rate=1e-3),
                           seed=spec.jid)

        def init(mesh):
            return train_state_from_numpy(want["init"][spec.jid],
                                          mesh.device)

        def step(mesh):
            fn = app.make_step(mesh)

            def run(state, i, *a):
                state, m = fn(state, i, *a)
                losses.setdefault(spec.jid, []).append(float(m["loss"]))
                return state, m
            return run
        return dmr.App(init=init, shardings=app.state_shardings, step=step,
                       name=app.name)
    specs = materialize_live("steady", n_jobs=LM_JOBS, device_count=8,
                             max_steps=LM_STEPS, seed=0)
    cl = dmr.Cluster(specs, logical_workers(8, "cpu"), policy=LM_POLICY,
                     app_factory=factory, sanitize=True)
    res = cl.run()
    s = res.summary()
    s.pop("wall_s")
    assert s == want["summary"]
    assert cl.trail == want["trail"]
    assert [(r.jid, r.start_tick, r.end_tick, r.start_procs, r.final_procs,
             tuple(r.resizes)) for r in res.records] == want["records"]
    sizes = {e[2][3] for e in cl.trail if e[0] == "resize"} | \
        {e[2] for e in cl.trail if e[0] == "start"}
    assert 6 in sizes
    assert {j: [e.transfer.bytes_moved for e in ev]
            for j, ev in res.events_by_jid.items()} == want["bytes"]
    assert sorted(losses) == sorted(want["losses"]) == [0, 1, 2]
    for jid, jl in want["losses"].items():
        assert len(losses[jid]) == len(jl) == LM_STEPS
        np.testing.assert_allclose(losses[jid], jl, atol=LOSS_TOL, rtol=0)
        assert all(np.isfinite(losses[jid]))


def test_cluster_tenant_losses_equal_a_static_run():
    """The resized tenant's losses under the cluster equal those of the
    same job run alone at one size (the arithmetic of a step does not
    depend on the worker count; on the CPU, up to the embedding
    gradient's summation order, hence tests/test_elastic.py's bound)."""
    cfg = get_config(LM_ARCH)
    losses = {}

    def factory(spec):
        app = lm_train_app(cfg, LM_SHAPE, AdamW(learning_rate=1e-3),
                           seed=spec.jid)

        def step(mesh):
            fn = app.make_step(mesh)

            def run(state, i, *a):
                state, m = fn(state, i, *a)
                losses.setdefault(spec.jid, []).append(float(m["loss"]))
                return state, m
            return run
        return dmr.App(init=app.init_state, shardings=app.state_shardings,
                       step=step, name=app.name)
    specs = materialize_live("steady", n_jobs=LM_JOBS, device_count=8,
                             max_steps=LM_STEPS, seed=0)
    res = dmr.Cluster(specs, logical_workers(8, "cpu"), policy=LM_POLICY,
                      app_factory=factory).run()
    jid = max(res.events_by_jid, key=lambda j: len(res.events_by_jid[j]))
    assert res.events_by_jid[jid]
    app = lm_train_app(cfg, LM_SHAPE, AdamW(learning_rate=1e-3), seed=jid)
    runner = dmr.MalleableRunner(app, MalleabilityParams(1, 8, 4),
                                 dmr.ScriptedRMS({}),
                                 devices=logical_workers(8, "cpu"))
    state, static = runner.init(), []
    for i in range(LM_STEPS):
        state, m = runner.step(state, i)
        static.append(float(m["loss"]))
    np.testing.assert_allclose(losses[jid], static, atol=LOSS_TOL, rtol=0)
