"""The port's serving fleet (``repro_torch.serve``) against the JAX
package's ``repro.serve``, on the CPU, in one process.

The fleet's host model is plain Python and numpy in both packages, so the
port must be bit-identical to the reference on the same seeds: every
request stream field by field, every estimator value and policy decision,
and for whole runs ``summary()``, the latency CDF, the timeline, the scale
events and the schedule trail.  ``benchmarks/serving.py``'s smoke grid and
``benchmarks/mixed_pool.py``'s shared and partitioned pools must also give
the committed ``BENCH_serving.json`` rows to the last digit.

Live mode steps a real ``MalleableRunner`` per replica (CPU workers here;
logical workers of the card in ``chip_smoke.py``): it must not change the
schedule, in-place grows and shrinks must leave the decode tokens and the
KV cache bit-identical, and the tokens must equal the JAX serve step's from
the same parameters.
"""
import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.analysis import trail as jtrail
from repro.configs import get_config as jget_config
from repro.core import policy as jpolicy
from repro.core.params import MalleabilityParams as JParams
from repro.dmr import Cluster as JCluster
from repro.models import model as JM
from repro.models.train import make_serve_step as j_make_serve_step
from repro.rms import workload as jwl
from repro_torch import dmr
from repro_torch import serve as tserve
from repro_torch import tree as T
from repro_torch.analysis import (audit_trail, audit_trail_file, dump_trail,
                                  job_metadata)
from repro_torch.configs import get_config
from repro_torch.core.params import MalleabilityParams
from repro_torch.core.policy import POLICIES, ClusterView, get_policy
from repro_torch.interop import params_from_numpy
from repro_torch.parallel.mesh import logical_workers
from repro_torch.rms import workload as twl
from repro_torch.serve import (LeastLoadedBalancer, P2Estimator,
                               QueueDepthPolicy, ReplicaSet, Request,
                               RequestQueue, ServeConfig, ServeTenantSpec,
                               SLOAwarePolicy, SLOTracker,
                               WindowedPercentile, make_decode_app,
                               make_request_stream)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(REPO, "BENCH_serving.json")) as f:
    BENCH = json.load(f)

# -- request streams ------------------------------------------------------

STREAM_SCENARIOS = sorted(twl.SCENARIOS) + ["trace:synthetic"]
STREAM_KW = [dict(),
             dict(mean_prompt=32, mean_decode=8, max_decode_factor=2.0,
                  deadline_s=1.5)]


def _fields(reqs):
    return [dataclasses.astuple(r) for r in reqs]


@pytest.mark.parametrize("kw", STREAM_KW, ids=["default", "short"])
@pytest.mark.parametrize("scenario", STREAM_SCENARIOS)
def test_request_stream_matches_jax(scenario, kw):
    """Every scenario gives the JAX stream's requests, field by field, with
    the JAX test's shape: sorted arrivals inside the horizon, rids in
    arrival order."""
    reqs = make_request_stream(scenario, 300, horizon_s=60.0, seed=3, **kw)
    assert _fields(reqs) == _fields(jserve.make_request_stream(
        scenario, 300, horizon_s=60.0, seed=3, **kw))
    arr = np.array([r.arrival_s for r in reqs])
    assert (np.diff(arr) >= 0).all()
    assert arr[0] >= 0.0 and arr[-1] < 60.0
    assert [r.rid for r in reqs] == list(range(300))
    assert all(r.prompt_len >= 1 and r.decode_len >= 1 for r in reqs)
    assert all(r.deadline_s == kw.get("deadline_s", 8.0) for r in reqs)


def test_request_stream_decode_cap():
    reqs = make_request_stream("steady", 2000, horizon_s=100.0,
                               mean_decode=48, max_decode_factor=3.0, seed=0)
    assert max(r.decode_len for r in reqs) <= 3 * 48
    reqs = make_request_stream("bimodal", 2000, horizon_s=100.0,
                               mean_decode=48, max_decode_factor=3.0, seed=0)
    assert 3 * 48 < max(r.decode_len for r in reqs) <= 8 * 3 * 48


def test_request_stream_unknown_scenario():
    with pytest.raises(twl.UnknownScenarioError) as ei:
        make_request_stream("nope", 10)
    assert "diurnal" in str(ei.value) and "trace:" in str(ei.value)
    assert isinstance(ei.value, KeyError)
    with pytest.raises(ValueError):
        make_request_stream("steady", 0)


def _req(rid, arrival, deadline=8.0):
    return Request(rid=rid, arrival_s=arrival, prompt_len=16, decode_len=4,
                   deadline_s=deadline)


def test_request_queue_fifo_and_expiry():
    q = RequestQueue()
    assert q.pop() is None and q.head_wait_s(0.0) == 0.0
    q.push(_req(0, 0.0))
    q.push(_req(1, 1.0))
    q.push(_req(2, 2.0, deadline=100.0))
    assert q.head_wait_s(5.0) == 5.0
    assert [r.rid for r in q.expire(9.0)] == [0, 1]
    assert len(q) == 1 and q.pop().rid == 2
    assert math.isnan(_req(3, 1.0).latency_s())


class _FakeReplica:
    def __init__(self, rid, free):
        self.rid = rid
        self.free_slots = free


def test_least_loaded_balancer():
    lb = LeastLoadedBalancer()
    assert lb.pick([]) is None
    reps = [_FakeReplica(0, 2), _FakeReplica(1, 5), _FakeReplica(2, 5)]
    assert lb.pick(reps).rid == 1
    assert lb.pick([_FakeReplica(0, 0)]) is None


# -- streaming estimators -------------------------------------------------

P2_STREAMS = [
    ("uniform", lambda rng, n: rng.uniform(0.0, 10.0, n)),
    ("exponential", lambda rng, n: rng.exponential(2.0, n)),
    ("normal", lambda rng, n: rng.normal(5.0, 2.0, n)),
    ("lognormal", lambda rng, n: rng.lognormal(0.0, 0.75, n)),
    ("bimodal", lambda rng, n: np.where(rng.random(n) < 0.8,
                                        rng.exponential(0.5, n),
                                        5.0 + rng.exponential(2.0, n))),
]


@pytest.mark.parametrize("q", [0.5, 0.9, 0.95, 0.99])
@pytest.mark.parametrize("name,gen", P2_STREAMS,
                         ids=[s[0] for s in P2_STREAMS])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_p2_matches_jax_and_tracks_np_percentile(name, gen, q, seed):
    """The port's P² estimate equals the JAX package's bit for bit after
    every observation, and tracks ``np.percentile`` within the JAX test's
    bound (0.12 of the sample's 95% spread)."""
    xs = gen(np.random.default_rng(seed), 4000)
    est, ref = P2Estimator(q), jserve.P2Estimator(q)
    for i, x in enumerate(xs):
        est.observe(float(x))
        ref.observe(float(x))
        if i % 97 == 0 or i < 8:
            assert est.quantile() == ref.quantile()
    assert est.quantile() == ref.quantile()
    true = float(np.percentile(xs, q * 100.0))
    spread = float(np.percentile(xs, 97.5) - np.percentile(xs, 2.5))
    assert abs(est.quantile() - true) <= 0.12 * spread + 1e-9


def test_p2_exact_when_few_samples_and_bounded():
    est = P2Estimator(0.9)
    assert math.isnan(est.quantile())
    for x in [3.0, 1.0, 2.0]:
        est.observe(x)
    assert est.quantile() == pytest.approx(np.percentile([3.0, 1.0, 2.0], 90))
    xs = np.random.default_rng(7).exponential(1.0, 1000)
    est = P2Estimator(0.99)
    for x in xs:
        est.observe(float(x))
    assert xs.min() <= est.quantile() <= xs.max()
    for bad in (0.0, 1.0):
        with pytest.raises(ValueError):
            P2Estimator(bad)


@pytest.mark.parametrize("n,window", [(100, 32), (500, 128), (50, 128)])
def test_windowed_percentile_exact_over_window(n, window):
    xs = np.random.default_rng(3).lognormal(0.0, 1.0, n)
    w, ref = WindowedPercentile(window), jserve.WindowedPercentile(window)
    for x in xs:
        w.observe(float(x))
        ref.observe(float(x))
    tail = xs[-min(n, window):]
    for q in (0.5, 0.95, 0.99):
        assert w.quantile(q) == ref.quantile(q)
        assert w.quantile(q) == pytest.approx(np.percentile(tail, q * 100))


def test_windowed_percentile_forgets_old_regime():
    w = WindowedPercentile(64)
    for x in [100.0] * 64 + [1.0] * 64:
        w.observe(x)
    assert w.quantile(0.99) == pytest.approx(1.0)
    with pytest.raises(ValueError):
        WindowedPercentile(0)


@pytest.mark.parametrize("estimator", ["window", "p2"])
def test_slo_tracker_breach(estimator):
    tr, ref = SLOTracker(2.0, estimator=estimator), \
        jserve.SLOTracker(2.0, estimator=estimator)
    assert not tr.breach()
    for lat in [1.0] * 50 + [5.0] * 200:
        tr.observe(lat)
        ref.observe(lat)
        assert tr.breach() == ref.breach()
    assert tr.breach() and tr.n == 250
    for q in SLOTracker.QUANTILES:
        assert tr.quantile(q) == ref.quantile(q)
    with pytest.raises(ValueError):
        SLOTracker(1.0, estimator="magic")
    if estimator == "p2":
        with pytest.raises(KeyError):
            tr.quantile(0.7)


# -- the latency policies -------------------------------------------------

class _Surface:
    """Duck-typed serving surface (what ReplicaSet exposes as ``job``)."""

    def __init__(self, slo, queue_len=0, head_wait_s=0.0, utilization=0.5,
                 quantum=2, in_flight=0, slots_per_replica=8):
        self.slo = slo
        self.queue_len = queue_len
        self.head_wait_s = head_wait_s
        self.utilization = utilization
        self.resize_quantum = quantum
        self.in_flight = in_flight
        self.slots_per_replica = slots_per_replica


def _params():
    return MalleabilityParams(2, 16, 4)


def _warm_tracker(latency, n=50, slo=4.0):
    tr = SLOTracker(slo)
    for _ in range(n):
        tr.observe(latency)
    return tr


VIEW = ClusterView(available=8, pending_min_sizes=[])
EMPTY = ClusterView(available=0, pending_min_sizes=[])


def test_latency_policies_registered():
    assert isinstance(get_policy("slo-aware"), SLOAwarePolicy)
    assert isinstance(get_policy("queue-depth"), QueueDepthPolicy)
    assert POLICIES["slo-aware"] is SLOAwarePolicy
    assert POLICIES["queue-depth"] is QueueDepthPolicy


def test_slo_aware_grows_on_breach_wait_and_cold_queue():
    pol = SLOAwarePolicy()
    act = pol.decide(4, _params(), VIEW, _Surface(_warm_tracker(6.0)))
    assert (act.kind, act.target) == ("expand", 6)
    job = _Surface(_warm_tracker(1.0), queue_len=3, head_wait_s=2.5)
    assert pol.decide(4, _params(), VIEW, job).kind == "expand"
    assert pol.choose_scale_path(job) == "in-place"
    cold = _Surface(SLOTracker(4.0), queue_len=5)
    assert pol.decide(4, _params(), VIEW, cold).kind == "expand"
    assert pol.choose_scale_path(cold) == "replica"
    assert pol.choose_scale_path(None) == "replica"


def test_slo_aware_bounds_patience_and_min():
    pol = SLOAwarePolicy()
    job = _Surface(_warm_tracker(6.0))
    act = pol.decide(4, _params(), EMPTY, job)     # blocked: still returned
    assert (act.kind, act.target) == ("expand", 6)
    assert pol.decide(16, _params(), VIEW, job).kind == "none"
    pol = SLOAwarePolicy(shrink_patience=3)
    healthy = _Surface(_warm_tracker(0.5), utilization=0.2)
    acts = [pol.decide(8, _params(), EMPTY, healthy).kind for _ in range(4)]
    assert acts[:2] == ["none", "none"] and "shrink" in acts[2:]
    pol2 = SLOAwarePolicy(shrink_patience=2)
    assert pol2.decide(8, _params(), EMPTY, healthy).kind == "none"
    pol2.decide(8, _params(), EMPTY, _Surface(_warm_tracker(6.0)))
    assert pol2.decide(8, _params(), EMPTY, healthy).kind == "none"
    pol3 = SLOAwarePolicy(shrink_patience=1)
    idle = _Surface(_warm_tracker(0.5), utilization=0.0)
    assert pol3.decide(2, _params(), EMPTY, idle).kind == "none"
    assert SLOAwarePolicy().decide(4, _params(), VIEW, None).kind == "none"


def test_queue_depth_policy_decisions():
    pol = QueueDepthPolicy(grow_depth=4.0, shrink_fill=0.6)
    assert pol.decide(4, _params(), VIEW, _Surface(None, queue_len=20)
                      ).kind == "expand"
    idle = _Surface(None, queue_len=0, in_flight=2)
    act = pol.decide(8, _params(), VIEW, idle)
    assert (act.kind, act.target) == ("shrink", 6)
    assert pol.decide(2, _params(), VIEW, idle).kind == "none"
    assert pol.decide(4, _params(), VIEW, None).kind == "none"
    assert pol.choose_scale_path(_Surface(None, queue_len=9)) == "in-place"


def _decisions(spkg, ppkg, params_cls, name):
    """``name``'s decisions and scale paths over a seeded walk of 400
    serving surfaces (warm and cold trackers at latencies around the SLO,
    queues, head waits, utilizations, fleet sizes, free pools), in one
    order: the slo-aware policy keeps a patience counter."""
    rng = np.random.default_rng(11)
    pol = ppkg.get_policy(name)
    pol.configure(spkg.ServeConfig())
    tr = spkg.SLOTracker(4.0, window=16)
    out = []
    for i in range(400):
        calm = (i // 25) % 2           # stretches of calm let shrinks happen
        lats = [0.3, 1.0, 3.9, 4.0] if calm else [0.3, 4.0, 4.1, 9.0]
        lats = lats[:2] if calm and i % 25 > 10 else lats
        for _ in range(int(rng.integers(0, 4))):
            tr.observe(float(rng.choice(lats)))
        job = _Surface(tr if i % 7 else None,
                       queue_len=0 if calm else
                       int(rng.choice([0, 1, 5, 9, 40])),
                       head_wait_s=0.0 if calm else
                       float(rng.choice([0.0, 1.0, 2.0, 2.5])),
                       utilization=float(rng.choice(
                           [0.0, 0.2, 0.5] if calm else [0.51, 1.0])),
                       in_flight=int(rng.integers(0, 30)))
        current = int(rng.choice([2, 4, 6, 8, 16]))
        view = ppkg.ClusterView(available=int(rng.choice([0, 8])),
                                pending_min_sizes=[])
        act = pol.decide(current, params_cls(2, 16, 4), view, job)
        out.append((act.kind, act.target, pol.choose_scale_path(job)))
    return out


@pytest.mark.parametrize("name", ["slo-aware", "queue-depth"])
def test_decide_matches_jax_on_a_grid_of_surfaces(name):
    """Both policies' decisions and scale paths equal the JAX package's
    over the same sequence of serving surfaces."""
    from repro_torch.core import policy as tpolicy
    got = _decisions(tserve, tpolicy, MalleabilityParams, name)
    assert got == _decisions(jserve, jpolicy, JParams, name)
    assert {k for k, _, _ in got} == {"expand", "shrink", "none"}
    assert {p for _, _, p in got} == {"in-place", "replica"}


# -- the fleet engine, host model ----------------------------------------

def test_static_fleet_completes_everything():
    reqs = make_request_stream("steady", 120, horizon_s=20.0, seed=0)
    rs = ReplicaSet(reqs, devices=16, static_replicas=4)
    res = rs.run()
    s = res.summary()
    assert s["n_dropped"] == 0 and s["n_completed"] == 120
    assert s["slo_attainment"] > 0.9
    assert res.n_scale_ups == 0 and res.n_scale_downs == 0
    assert res.mean_devices == pytest.approx(8.0) and res.peak_devices == 8
    assert rs.decisions == "static"
    for r in res.requests:
        assert r.start_s >= r.arrival_s and r.finish_s > r.start_s


@pytest.mark.parametrize("deadline", [2.0, 0.0])
def test_overload_drops_honor_deadlines(deadline):
    """One tiny replica against a flood sheds by deadline; a zero deadline
    never drops."""
    reqs = make_request_stream("steady", 400 if deadline else 200,
                               horizon_s=4.0 if deadline else 2.0,
                               deadline_s=deadline, seed=0)
    cfg = ServeConfig(devices_per_replica=1, slots_per_device=2,
                      max_replicas=1)
    res = ReplicaSet(reqs, devices=1, static_replicas=1, config=cfg).run()
    s = res.summary()
    drops = [ev for ev in res.trail if ev[0] == "request-drop"]
    assert len(drops) == s["n_dropped"]
    if not deadline:
        assert s["n_dropped"] == 0 and s["n_completed"] == 200
        return
    assert s["n_dropped"] > 0
    assert all(r.start_s < 0 for r in res.requests if r.dropped)
    for _, _, (rid, wait, dl), _ in drops:
        assert wait >= dl - 1e-9


def _diurnal_run(pkg, policy="slo-aware", **kw):
    reqs = pkg.make_request_stream("diurnal", 1500, horizon_s=60.0, seed=2)
    rs = pkg.ReplicaSet(reqs, devices=16, policy=policy, **kw)
    return rs, rs.run()


def _observed(res):
    """What both packages must agree on for one run."""
    return (res.summary(), res.metrics.cdf(), res.timeline,
            res.scale_events, res.trail, res.ticks, res.device_ticks)


def _same(a, b):
    """Equal observations; ``nan`` (an empty percentile) equals itself."""
    def norm(x):
        if isinstance(x, float) and math.isnan(x):
            return "nan"
        if isinstance(x, dict):
            return {k: norm(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [norm(v) for v in x]
        return x
    return norm(a) == norm(b)


@pytest.mark.parametrize("policy", ["slo-aware", "queue-depth",
                                    "throughput-greedy", "algorithm2"])
def test_elastic_fleet_matches_jax(policy):
    """A diurnal day on 16 devices under each policy: bit-identical to the
    JAX run, and its trail audits clean live and offline."""
    rs, res = _diurnal_run(tserve, policy,
                           sanitize=True)
    _, ref = _diurnal_run(jserve, policy)
    assert _same(_observed(res), _observed(ref))
    assert audit_trail(res.trail, rs._pool_ids, jobs=job_metadata(rs),
                       check_spacing=False) == []
    s = res.summary()
    assert s["n_completed"] + s["n_dropped"] == 1500
    if policy == "slo-aware":
        assert res.n_scale_ups > 0 and res.n_scale_downs > 0
        assert res.peak_devices > rs.params.preferred
        assert s["slo_attainment"] > 0.9
        assert len({devs for _, _, devs in res.timeline}) > 1
    if policy == "throughput-greedy":
        assert res.peak_devices == 16 and res.n_scale_downs == 0


def test_fleet_trail_dump_roundtrip(tmp_path):
    rs, res = _diurnal_run(tserve)
    path = os.path.join(tmp_path, "serving_trail.json")
    dump_trail(rs, path)
    assert audit_trail_file(path) == []
    assert jtrail.audit_trail_file(path) == []


def test_pool_must_fit_max_replicas():
    reqs = make_request_stream("steady", 10, horizon_s=1.0)
    with pytest.raises(ValueError):
        ReplicaSet(reqs, devices=4)
    with pytest.raises(ValueError):
        ReplicaSet(reqs, devices=4, static_replicas=3)


#: benchmarks/serving.py: pool, scenario, smoke stream, the static ladder
SERVING_SMOKE = BENCH["stream"]
SERVING_CONFIGS = [(row["config"], row["policy"], row["mode"])
                   for row in BENCH["configs"]]


def _bench_run(pkg, label, policy, mode):
    reqs = pkg.make_request_stream(
        BENCH["scenario"], SERVING_SMOKE["n_requests"],
        horizon_s=SERVING_SMOKE["horizon_s"], seed=SERVING_SMOKE["seed"])
    static = int(label.split("/")[1].rstrip("r")) if mode == "static" \
        else None
    rs = pkg.ReplicaSet(list(reqs), devices=BENCH["pool_devices"],
                        policy=policy if mode == "elastic" else "slo-aware",
                        static_replicas=static,
                        config=pkg.ServeConfig(initial_replicas=4),
                        record_trail=True)
    return rs, rs.run()


@pytest.mark.parametrize("label,policy,mode", SERVING_CONFIGS,
                         ids=[c[0] for c in SERVING_CONFIGS])
def test_serving_benchmark_rows_match_committed_and_jax(label, policy, mode):
    """``benchmarks/serving.py``'s smoke grid through the port: each row of
    ``BENCH_serving.json`` (and its latency CDF) to the last digit, and the
    JAX run's summary, CDF, timeline, scale events and trail; every trail
    audits clean under the port's auditor."""
    rs, res = _bench_run(tserve, label,
                         policy, mode)
    _, ref = _bench_run(jserve, label, policy, mode)
    assert _same(_observed(res), _observed(ref))
    row = next(r for r in BENCH["configs"] if r["config"] == label)
    s = res.summary()
    assert {k: s[k] for k in row if k in s} == \
        {k: v for k, v in row.items() if k in s}
    assert [list(p) for p in res.metrics.cdf()] == BENCH["latency_cdfs"][label]
    assert audit_trail(res.trail, rs._pool_ids, jobs=job_metadata(rs),
                       check_spacing=False) == []
    assert len(res.trail) == BENCH["trail_audit"][label]["events"]


INPLACE = dict(max_devices_per_replica=4, cold_start_ticks=4, grow_ticks=1)


@pytest.mark.parametrize("policy,estimator", [("slo-aware", "window"),
                                              ("slo-aware", "p2"),
                                              ("queue-depth", "window")])
def test_in_place_fleet_matches_jax(policy, estimator):
    """Scale-ups grow live replicas in place before cold starts: equal to
    the JAX run under the live sanitizer, with both scale paths taken."""
    runs = []
    for pkg in (tserve, jserve):
        cfg = pkg.ServeConfig(estimator=estimator, **INPLACE)
        runs.append(_diurnal_run(pkg, policy, config=cfg, sanitize=True))
    (rs, res), (_, ref) = runs
    assert _same(_observed(res), _observed(ref))
    kinds = {e["kind"] for e in res.scale_events}
    assert {"grow-in-place", "replica-add"} <= kinds
    assert any(e[0] == "replica-resize" for e in res.trail)


# -- mixed train + serve pools (benchmarks/mixed_pool.py, part 2) ---------

MIXED = BENCH["mixed_pool"]


def _mixed_config(pkg, max_replicas):
    return pkg.ServeConfig(devices_per_replica=2, min_replicas=1,
                           max_replicas=max_replicas, initial_replicas=2,
                           max_devices_per_replica=4, cold_start_ticks=4,
                           grow_ticks=1)


def _mixed_pool(wl, spec_cls, pkg, cluster_cls, max_replicas=6):
    p = MIXED["workload"]
    batch = wl.materialize_live("bursty", n_jobs=p["n_jobs"],
                                device_count=p["pool_devices"] // 2,
                                max_steps=p["max_steps"], seed=p["seed"])
    fleet = spec_cls(jid=1000, config=_mixed_config(pkg, max_replicas),
                     scenario="diurnal", n_requests=p["n_requests"],
                     horizon_s=p["horizon_s"], seed=p["seed"])
    cl = cluster_cls.sched_only(list(batch) + [fleet],
                                n_devices=p["pool_devices"],
                                record_trail=True)
    return cl, cl.run(), {s.jid for s in batch}


def _batch_jps(result, jids):
    ticks = max(r.end_tick for r in result.records if r.jid in jids)
    return len(jids) / (ticks * result.tick_s)


@pytest.mark.parametrize("engine", [dmr.Cluster, dmr.ReferenceCluster])
def test_mixed_pool_matches_committed(engine):
    """A batch workload beside a serving fleet as one composite tenant on
    16 workers (shared), against the 8 + 8 split (partitioned): both rows
    of ``BENCH_serving.json["mixed_pool"]["pools"]`` to the last digit,
    under both engines; the shared run's trail equals the JAX cluster's
    and audits clean in both packages."""
    cl, res, jids = _mixed_pool(twl, ServeTenantSpec,
                                tserve,
                                engine)
    jcl, _, _ = _mixed_pool(jwl, jserve.ServeTenantSpec, jserve, JCluster)
    assert cl.trail == jcl.trail
    fleet = next(t for t in cl.tenants if getattr(t, "composite", False))
    s = fleet.result.summary()
    violations = audit_trail(cl.trail, cl._pool_ids, jobs=job_metadata(cl))
    assert violations == []
    assert jtrail.audit_trail(cl.trail, cl._pool_ids,
                              jobs=jtrail.job_metadata(jcl)) == []
    shared, part = MIXED["pools"]
    assert {"pool": "shared", "devices": MIXED["workload"]["pool_devices"],
            "goodput_rps": s["goodput_rps"],
            "slo_attainment": s["slo_attainment"], "p99_s": s["p99_s"],
            "batch_jobs_per_s": _batch_jps(res, jids),
            "trail_violations": len(violations)} == shared
    ticks = {}
    for ev in fleet.result.scale_events:
        ticks.setdefault(ev["kind"], []).append(ev["ready_tick"] - ev["tick"])
    assert {k: sum(v) / len(v) for k, v in ticks.items()} == \
        MIXED["ticks_to_capacity"]
    p = MIXED["workload"]
    pb = engine.sched_only(twl.materialize_live(
        "bursty", n_jobs=p["n_jobs"], device_count=p["pool_devices"] // 2,
        max_steps=p["max_steps"], seed=p["seed"]),
        n_devices=p["pool_devices"] // 2)
    spec = ServeTenantSpec(jid=1000, config=_mixed_config(
        tserve, 4), scenario="diurnal",
        n_requests=p["n_requests"], horizon_s=p["horizon_s"], seed=p["seed"])
    ps = ReplicaSet(spec.make_requests(), devices=p["pool_devices"] // 2,
                    policy=spec.policy, config=spec.config).run().summary()
    half = p["pool_devices"] // 2
    assert {"pool": "partitioned", "devices": f"{half}+{half}",
            "goodput_rps": ps["goodput_rps"],
            "slo_attainment": ps["slo_attainment"], "p99_s": ps["p99_s"],
            "batch_jobs_per_s": _batch_jps(pb.run(), jids),
            "trail_violations": 0} == part


# -- live mode: real runners on CPU workers -------------------------------

#: the live fleet of chip_smoke.py's fleet:live phase: slo-aware at a 0.5 s
#: SLO consulted every 5 ticks, replicas of 2 workers that may grow to 4,
#: up to 3 of them on 8 workers; a 240-request diurnal swell over 3 s grows
#: a replica in place, cold-starts two and shrinks one in place in 158
#: ticks (289 replica-steps, at most 154 for one replica)
LIVE_CONFIG = dict(devices_per_replica=2, max_devices_per_replica=4,
                   min_replicas=1, max_replicas=3, initial_replicas=2,
                   cold_start_ticks=4, grow_ticks=1, slo_p99_s=0.5,
                   resize_every=5)
LIVE_STREAM = dict(scenario="diurnal", n_requests=240, horizon_s=3.0,
                   mean_decode=4, seed=0)
LIVE_BATCH, LIVE_CACHE, LIVE_PROMPT = 4, 160, 4
#: the smoke configs of the live tests: phi4-mini's (tied embeddings: its
#: random greedy decode repeats the last token fed) and qwen2.5's (untied:
#: its greedy tokens wander, which gives the token checks their teeth)
LIVE_ARCHS = ["phi4-mini-3.8b-smoke", "qwen2.5-32b-smoke"]


def _prompts(vocab):
    return np.random.default_rng(5).integers(
        0, vocab, (LIVE_BATCH, LIVE_PROMPT), dtype=np.int32)


def _prompted_app(cfg, params):
    """``make_decode_app`` fed ``_prompts`` at its first ticks
    (prefill-by-decode), so every row of the batch decodes its own
    sequence and a resize that mixed up rows would show."""
    app = make_decode_app(cfg, batch=LIVE_BATCH, cache_len=LIVE_CACHE,
                          params=params)
    prompts = _prompts(cfg.vocab_size)

    def step(mesh):
        fn = app.make_step(mesh)
        return lambda state, i: fn(state, i, prompts[:, i]
                                   if i < LIVE_PROMPT else None)
    return dmr.App(init=app.init_state, shardings=app.state_shardings,
                   step=step, patterns=app.patterns, name=app.name)


def _jax_tokens(arch, jparams, n):
    """The JAX serve step's greedy tokens over ``n`` ticks from the same
    parameters and prompts: ``(n, batch, 1)``."""
    cfg = jget_config(arch)
    serve = jax.jit(j_make_serve_step(cfg))
    cache = JM.init_cache(cfg, LIVE_BATCH, LIVE_CACHE, enc_len=LIVE_CACHE)
    tok = jnp.zeros((LIVE_BATCH, 1), jnp.int32)
    prompts, out = _prompts(cfg.vocab_size), []
    for i in range(n):
        if i < LIVE_PROMPT:
            tok = jnp.asarray(prompts[:, i]).reshape(LIVE_BATCH, 1)
        tok, cache = serve(jparams, cache, tok, jnp.int32(i))
        out.append(np.asarray(tok))
    return np.stack(out)


@pytest.fixture(scope="module", params=LIVE_ARCHS)
def live_arch(request):
    arch = request.param
    jp = jax.tree.map(np.asarray, JM.init_params(jget_config(arch),
                                                 jax.random.PRNGKey(0)))
    return arch, jp


def _live_fleet(arch, params, live):
    reqs = make_request_stream(
        LIVE_STREAM["scenario"], LIVE_STREAM["n_requests"],
        horizon_s=LIVE_STREAM["horizon_s"],
        mean_decode=LIVE_STREAM["mean_decode"], seed=LIVE_STREAM["seed"])
    kw = dict(app_factory=lambda: _prompted_app(get_config(arch), params)) \
        if live else {}
    rs = ReplicaSet(reqs, devices=logical_workers(8, "cpu") if live else 8,
                    config=ServeConfig(**LIVE_CONFIG), policy="slo-aware",
                    sanitize=True, **kw)
    return rs, rs.run()


def test_live_fleet_equals_host_model_and_jax_tokens(live_arch):
    """A policy-driven live fleet (in-place grow, two cold starts, an
    in-place shrink) has the host model's summary, CDF, timeline, scale
    events and trail, fits every replica's life in its cache, and every
    replica's tokens are the JAX serve step's from the same parameters."""
    arch, jp = live_arch
    params = params_from_numpy(jp)
    rs, res = _live_fleet(arch, params, True)
    hrs, host = _live_fleet(arch, params, False)
    assert _same(_observed(res), _observed(host))
    assert [e["kind"] for e in res.scale_events] == \
        ["replica-add", "grow-in-place", "replica-add", "shrink-in-place"]
    steps = [rep._tick_i for rep in rs.tenants]
    assert steps == [rep._tick_i for rep in hrs.tenants]
    assert sum(steps) == 289 and max(steps) <= LIVE_CACHE
    want = _jax_tokens(arch, jp, max(steps))
    for rep in rs.tenants:
        assert rep.state is None and not rep.runner.devices  # retired
        got = rep.token_history()
        assert got.shape == (rep._tick_i, LIVE_BATCH, 1)
        np.testing.assert_array_equal(got, want[:rep._tick_i])
    assert [e.action for rep in rs.tenants for e in rep.runner.events] == \
        ["expand", "shrink"]


def _drive_in_place(arch, params, resize):
    """``tests/test_serving.py``'s in-place script: one live replica of 2
    of 4 workers, grown in place to 4 at tick 3 and shrunk to 2 at tick 6,
    through the fleet's scale path, sanitized."""
    sc = ServeConfig(devices_per_replica=2, max_devices_per_replica=4,
                     min_replicas=1, max_replicas=1, initial_replicas=1,
                     slots_per_device=4)
    reqs = make_request_stream("steady", 8, horizon_s=1.0, mean_decode=6,
                               max_decode_factor=1.0, seed=1)
    rs = ReplicaSet(reqs, devices=logical_workers(4, "cpu"), config=sc,
                    static_replicas=1, sanitize=True,
                    app_factory=lambda: _prompted_app(get_config(arch),
                                                      params))
    rs.start_fleet()
    rep = rs._replicas[0]
    for i in range(10):
        if resize and i == 3:
            rs._grow_in_place(rep, 4)
            assert rep.current_size == 4 and len(rs._idle) == 0
        if resize and i == 6:
            rs._shrink_in_place(rep, 2)
            assert rep.current_size == 2 and len(rs._idle) == 2
        rs.tick_once()
        rs._tick += 1
    return rep, rs


def test_live_in_place_grow_shrink_bit_identical(live_arch):
    """In-place grow and shrink on a live replica leave its tokens and its
    KV cache bit-identical to a never-resized run; the runner moved the
    cache by ``default`` and the parameters by ``replicate``, with the
    reference's byte accounting."""
    arch, jp = live_arch
    params = params_from_numpy(jp)
    rep_s, _ = _drive_in_place(arch, params, False)
    rep_e, rs_e = _drive_in_place(arch, params, True)
    np.testing.assert_array_equal(rep_s.token_history(),
                                  rep_e.token_history())
    np.testing.assert_array_equal(rep_e.token_history(),
                                  _jax_tokens(arch, jp, 10))
    for a, b in zip(T.leaves(rep_s.state["cache"]),
                    T.leaves(rep_e.state["cache"])):
        assert torch.equal(a, b)
    assert [e["kind"] for e in rs_e.scale_events] == \
        ["grow-in-place", "shrink-in-place"]
    assert rs_e.n_scale_ups == 1 and rs_e.n_scale_downs == 1
    evs = rep_e.runner.events
    assert [(e.action, e.from_procs, e.to_procs) for e in evs] == \
        [("expand", 2, 4), ("shrink", 4, 2)]
    pbytes = sum(t.nbytes for t in T.leaves(params))
    cbytes = sum(t.nbytes for t in T.leaves(rep_e.state["cache"])) + \
        LIVE_BATCH * 4 + 4                              # + tok and pos
    for e in evs:
        assert {k: s.bytes_moved for k, s in e.per_pattern.items()} == \
            {"replicate": pbytes * e.to_procs, "default": cbytes}


def test_live_static_fleet_completes_and_tears_down():
    """``tests/test_serving.py``'s live fleet: two static replicas of a
    live decode app serve every request and are torn down at the end."""
    cfg = get_config("mamba2-370m-smoke")
    reqs = make_request_stream("steady", 12, horizon_s=1.0, mean_decode=4,
                               max_decode_factor=1.0, seed=0)
    sc = ServeConfig(devices_per_replica=2, max_replicas=2, min_replicas=1,
                     initial_replicas=1, slots_per_device=4)
    rs = ReplicaSet(reqs, devices=logical_workers(4, "cpu"), config=sc,
                    static_replicas=2, app_factory=lambda: make_decode_app(
                        cfg, batch=2, cache_len=64))
    res = rs.run()
    assert res.summary()["n_completed"] == 12
    assert rs._replicas == [] and len(rs._idle) == 4
    assert all(len(r.tokens) == r._tick_i > 0 for r in rs.tenants)


# -- the configs of this slice --------------------------------------------

@pytest.mark.parametrize("name", ["phi4-mini-3.8b", "qwen2.5-32b",
                                  "internlm2-20b"])
def test_dense_configs_match_jax(name):
    for n in (name, f"{name}-smoke"):
        assert get_config(n).__dict__ == jget_config(n).__dict__
