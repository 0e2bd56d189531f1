"""The port's resource manager against the JAX package's, on the CPU.

``repro_torch.rms`` (workload model, the two simulator engines, the event
index), the policy surface and the co-simulation connector are plain
Python and numpy in both packages, so everything here must be
bit-identical to the reference on the same seeds: the generated jobs field
by field, every float of ``summary()``, every ``ResizeRecord`` and every
timeline sample.  The trail auditor's verdicts on corrupted trails are
held to the reference's the same way.
"""
import dataclasses
import warnings

import numpy as np
import pytest

from repro.analysis import trail as jtrail
from repro.core import policy as jpolicy
from repro.dmr import cluster as jcluster
from repro.dmr import cosim as jcosim
from repro.rms import eventindex as jidx
from repro.rms import scheduler as jsched
from repro.rms import workload as jwl
from repro_torch.analysis import trail as ttrail
from repro_torch.core import policy as tpolicy
from repro_torch.core.params import MalleabilityParams
from repro_torch.dmr import cluster as tcluster
from repro_torch.dmr import cosim as tcosim
from repro_torch.rms import eventindex as tidx
from repro_torch.rms import scheduler as tsched
from repro_torch.rms import workload as twl

POLICIES = ("algorithm2", "energy", "throughput-greedy")
SCENARIOS = sorted(twl.SCENARIOS) + ["trace:synthetic"]


def _fields(obj):
    """A dataclass (or list of them) as plain nested data, for ``==``."""
    if isinstance(obj, (list, tuple)):
        return [_fields(o) for o in obj]
    return dataclasses.asdict(obj)


def test_scenario_registries_agree():
    assert sorted(twl.SCENARIOS) == sorted(jwl.SCENARIOS)
    assert {k: _fields(v) for k, v in twl.APPS.items()} == \
        {k: _fields(v) for k, v in jwl.APPS.items()}
    # importing either package's serving fleet registers its own latency
    # policies (slo-aware, queue-depth) into that package's registry
    import repro.serve  # noqa: F401
    import repro_torch.serve  # noqa: F401
    assert sorted(tpolicy.POLICIES) == sorted(jpolicy.POLICIES)
    for name, cls in tpolicy.POLICIES.items():
        assert jpolicy.POLICIES[name].__name__ == cls.__name__


# -- the event index --------------------------------------------------------

def _index_ops(mod, seed, n_ops=400):
    """A seeded random sequence of index operations; returns every answer
    the index gave (the same sequence is replayed on each package)."""
    rng = np.random.default_rng(seed)
    idx = mod.MinRequestIndex()
    keys, out, next_key = [], [], 0
    for _ in range(n_ops):
        op = int(rng.integers(0, 9))
        if op <= 2 or not keys:                                   # push
            lo = int(rng.integers(1, 9))
            prio = None if rng.random() < 0.2 else \
                (bool(rng.integers(0, 2)), float(rng.integers(0, 5)))
            idx.push(next_key, next_key, lo, prio)
            keys.append(next_key)
            next_key += 1
        elif op == 3:                                             # discard
            idx.discard(keys.pop(int(rng.integers(0, len(keys)))))
        elif op == 4:                                             # rekey
            k = keys[int(rng.integers(0, len(keys)))]
            idx.rekey(k, (False, float(rng.integers(0, 5))))
        elif op == 5:                                             # rebuild
            salt = int(rng.integers(0, 7))
            idx.rebuild(lambda item: ((item * salt) % 5, item))
        elif op == 6:
            free = int(rng.integers(0, 10))
            out.append(("best", free, idx.best(free, True),
                        idx.best(free, False)))
        elif op == 7:
            free = int(rng.integers(0, 10))
            out.append(("earliest", free, idx.earliest_fitting(free)))
        else:
            mins = idx.min_sizes(True)
            out.append(("mins", len(mins), bool(mins), list(mins),
                        list(idx.min_sizes(False)), idx.min_lo,
                        dict(idx.counts), len(idx), list(idx)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_event_index_answers_match_jax(seed):
    assert _index_ops(tidx, seed) == _index_ops(jidx, seed)


def test_pending_mins_matches_jax():
    counts = {4: 2, 1: 3, 8: 1}
    a, b = tidx.PendingMins(dict(counts), 6), jidx.PendingMins(
        dict(counts), 6)
    assert (len(a), bool(a), list(a)) == (len(b), bool(b), list(b))
    assert list(tidx.PendingMins({}, 0)) == [] and \
        not tidx.PendingMins({}, 0)


# -- the workload model -----------------------------------------------------

@pytest.mark.parametrize("malleable", [True, False])
@pytest.mark.parametrize("mode", [twl.MOLDABLE, twl.RIGID])
@pytest.mark.parametrize("name", SCENARIOS)
def test_make_scenario_matches_jax(name, mode, malleable):
    tjobs, tov = twl.make_scenario(name, 60, mode=mode, malleable=malleable,
                                   seed=5)
    jjobs, jov = jwl.make_scenario(name, 60, mode=mode, malleable=malleable,
                                   seed=5)
    assert tov == jov
    assert _fields(tjobs) == _fields(jjobs)


@pytest.mark.parametrize("fn", ["feitelson_arrivals", "bursty_arrivals",
                                "diurnal_arrivals"])
def test_arrival_processes_match_jax(fn):
    got = getattr(twl, fn)(200, np.random.default_rng(3))
    want = getattr(jwl, fn)(200, np.random.default_rng(3))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [
    dict(mode="moldable", malleable_fraction=0.5),
    dict(mode="rigid", malleable_only_app="cg"),
    dict(moldable=True, app_names=["jacobi", "hpg"])])
def test_make_workload_options_match_jax(kw):
    assert _fields(twl.make_workload(50, seed=2, **kw)) == \
        _fields(jwl.make_workload(50, seed=2, **kw))


def test_unknown_scenario_error_matches_jax():
    with pytest.raises(twl.UnknownScenarioError) as t_err:
        twl.make_scenario("nope")
    with pytest.raises(jwl.UnknownScenarioError) as j_err:
        jwl.make_scenario("nope")
    assert str(t_err.value) == str(j_err.value)


DIRTY_SWF = """\
; MaxNodes: 32
1 0 -1 100 4 -1 -1 4 200 -1 1 -1 -1 -1 -1 -1 -1 -1
this line is not a record at all
2 10 -1 50
3 20 -1 0 8 -1 -1 8 100 -1 0 -1 -1 -1 -1 -1 -1 -1
4 30 -1 80 0 -1 -1 0 100 -1 0 -1 -1 -1 -1 -1 -1 -1
5 40 -1 abc 8 -1 -1 8 100 -1 1 -1 -1 -1 -1 -1 -1 -1
6 25 -1 60 2 -1 -1 2 100 -1 1 -1 -1 -1 -1 -1 -1 -1
1 50 -1 70 16 -1 2048 16 100 -1 1 -1 -1 -1 -1 -1 -1 -1
"""


@pytest.mark.parametrize("n_jobs,seed,nodes", [(300, 0, 128), (120, 9, 64)])
def test_swf_round_trip_matches_jax(n_jobs, seed, nodes):
    """The synthetic trace text (past its first comment line, which names
    the generating module) and the jobs parsed from it."""
    text = twl.generate_synthetic_swf(n_jobs, seed=seed, nodes=nodes)
    jtext = jwl.generate_synthetic_swf(n_jobs, seed=seed, nodes=nodes)
    assert text.splitlines()[1:] == jtext.splitlines()[1:]
    for kw in (dict(), dict(max_jobs=n_jobs // 2, mode="rigid"),
               dict(nodes=16, malleable=False)):
        tj, tov = twl.parse_swf(text, **kw)
        jj, jov = jwl.parse_swf(jtext, **kw)
        assert tov == jov
        assert _fields(tj) == _fields(jj)


def test_parse_swf_dirty_records_match_jax():
    """Malformed, cancelled and duplicate-id records: the same jobs kept
    and the same one aggregated warning."""
    out = []
    for mod in (twl, jwl):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            jobs, ov = mod.parse_swf(DIRTY_SWF)
        out.append((_fields(jobs), ov,
                    [str(x.message) for x in w
                     if "parse_swf" in str(x.message)]))
    assert out[0] == out[1]
    assert len(out[0][2]) == 1


@pytest.mark.parametrize("scenario,kw", [
    ("steady", dict(n_jobs=6, max_steps=10, device_count=4, seed=0,
                    arrival_span=10)),
    ("steady", dict(n_jobs=6, max_steps=6, device_count=8, seed=0)),
    ("bursty", dict(n_jobs=12, device_count=16, mode="rigid", seed=3)),
    ("trace:synthetic", dict(n_jobs=60, device_count=16, arrival_span=10,
                             seed=4)),
    ("energy-capped", dict(n_jobs=10, device_count=8,
                           inhibit_iterations=3, malleable=False, seed=1))])
def test_materialize_live_matches_jax(scenario, kw):
    assert _fields(twl.materialize_live(scenario, **kw)) == \
        _fields(jwl.materialize_live(scenario, **kw))


# -- the simulator engines --------------------------------------------------

def _sim(sched_mod, wl_mod, engine, name, policy):
    jobs, ov = wl_mod.make_scenario(name, 48, seed=2)
    res = getattr(sched_mod, engine)(jobs, sched_mod.SimConfig(**ov),
                                     policy=policy).run()
    timeline = {k: np.asarray(v).tolist()
                for k, v in dataclasses.asdict(res.timeline).items()}
    return (res.summary(), _fields(res.resize_log), timeline,
            res.n_stragglers, res.n_straggler_mitigations,
            _fields(res.jobs), [dataclasses.astuple(v) for v in res.audit()])


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", SCENARIOS)
def test_simulators_match_jax(name, policy):
    """Both engines of the port against the JAX package's event engine:
    ``summary()``, ``resize_log``, the timeline, the straggler counters,
    every job's final state, and a clean resize-log audit."""
    want = _sim(jsched, jwl, "Simulator", name, policy)
    assert want[6] == []
    for engine in ("Simulator", "ReferenceSimulator"):
        assert _sim(tsched, twl, engine, name, policy) == want, engine


def test_simulator_custom_policy_flags_match_jax():
    """A policy with backfill off and queue keys that age with time: the
    fast engine's re-keying path."""
    def make(mod):
        class Aging(mod.Algorithm2Policy):
            name = "aging"
            backfill = False
            dynamic_priority = True

            def priority_key(self, job, now):
                return (-(now - job.submit_time) // 100, job.jid)
        return Aging()
    got = [tsched.Simulator(twl.make_workload(40, mode="rigid", seed=4),
                            policy=make(tpolicy)).run()]
    want = jsched.Simulator(jwl.make_workload(40, mode="rigid", seed=4),
                            policy=make(jpolicy)).run()
    got.append(tsched.ReferenceSimulator(
        twl.make_workload(40, mode="rigid", seed=4),
        policy=make(tpolicy)).run())
    for g in got:
        assert g.summary() == want.summary()
        assert _fields(g.resize_log) == _fields(want.resize_log)


# -- the policy surface -----------------------------------------------------

class _App:
    def __init__(self, params):
        self.params = params

    def exec_time(self, p):
        return 100.0 / p ** 0.7 + 0.5 * p


class _Job:
    """The duck-typed job the policies read."""

    def __init__(self, params, submit, boosted, work, nprocs, malleable,
                 opaque):
        self.app = _App(params)
        self.submit_time = submit
        self.boosted = boosted
        self.remaining_work = work
        self.nprocs = nprocs
        self.malleable = malleable
        if opaque:
            self.reclaim_opaque = True


def _policy_answers(pol_mod, params_cls, seed):
    rng = np.random.default_rng(seed)
    out = []
    pols = {n: pol_mod.get_policy(n) for n in POLICIES}

    class Cfg:
        nodes, idle_w, loaded_w = 64, 90.0, 310.0
    for n, p in pols.items():
        p.configure(Cfg())
        out.append((n, p.backfill, p.dynamic_priority, p.decide_stateless,
                    p.choose_scale_path(None), repr(p)))
    for _ in range(60):
        lo = int(rng.integers(1, 5))
        hi = int(rng.integers(lo, 17))
        pref = int(rng.integers(lo, hi + 1))
        params = params_cls(lo, hi, pref)
        jobs = [_Job(params, float(rng.integers(0, 50)),
                     bool(rng.integers(0, 2)), float(rng.random()),
                     int(rng.integers(lo, hi + 1)), bool(rng.integers(0, 2)),
                     bool(rng.integers(0, 4) == 0)) for _ in range(4)]
        pend = [int(x) for x in rng.integers(1, 9, int(rng.integers(0, 4)))]
        avail = int(rng.integers(0, 9))
        view = pol_mod.live_view(available=avail, pending_min_sizes=pend,
                                 tenants=jobs, exclude=jobs[0])
        out.append((view.available, list(view.pending_min_sizes),
                    view.reclaimable_others,
                    pol_mod.reclaimable_workers(jobs),
                    pol_mod.reclaimable_workers(jobs, exclude=jobs[1])))
        cur = jobs[0].nprocs
        for n, p in pols.items():
            out.append((n, p.priority_key(jobs[0], 7.0),
                        p.decide(cur, params, view, job=jobs[0]),
                        p.decide(cur, params, view)))
        energy = pols["energy"]
        out.append([(energy.job_energy(s, jobs[0], e),
                     energy.job_energy(s, None, e))
                    for s in params.legal_sizes() for e in (True, False)])
    cost = pol_mod.EnergyAwarePolicy(cost_fn=lambda p: 10.0 / p + p)
    out.append([cost.job_energy(s, None, True) for s in (1, 2, 4, 8)])
    return [_plain(x) for x in out]


def _plain(x):
    """Actions and views as tuples, so the two packages' compare."""
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(y) for y in x)
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,) + tuple(
            _plain(v) for v in dataclasses.astuple(x))
    return x


@pytest.mark.parametrize("seed", [0, 1])
def test_policy_surface_matches_jax(seed):
    """``configure``, ``priority_key``, ``choose_scale_path``, the capability
    flags (``backfill``, ``dynamic_priority``, ``decide_stateless``),
    ``decide`` with and without a job, the energy policy's ``job_energy``
    (job, ``cost_fn`` and proxy forms), ``reclaimable_workers`` and
    ``live_view`` over seeded random jobs and views."""
    from repro.core.params import MalleabilityParams as JParams
    assert _policy_answers(tpolicy, MalleabilityParams, seed) == \
        _policy_answers(jpolicy, JParams, seed)


def test_validate_policy_needs_decide_and_priority_key():
    class OnlyDecide:
        def decide(self, current, params, cluster, job=None):
            return tpolicy.Action.none(current)
    with pytest.raises(TypeError, match="priority_key"):
        tpolicy.get_policy(OnlyDecide())
    with pytest.raises(KeyError, match="unknown policy"):
        tpolicy.get_policy("nope")


# -- co-simulation ----------------------------------------------------------

@pytest.mark.parametrize("engine", ["Simulator", "ReferenceSimulator"])
@pytest.mark.parametrize("scenario,jid", [("steady", 3), ("bursty", 5)])
def test_simrms_matches_jax(scenario, jid, engine):
    """``SimRMS``'s embedded simulation, its normalized schedule, start
    size, expected resizes and answers to a runner's per-step queries."""
    def run(cosim, sched):
        s = cosim.SimRMS(scenario=scenario, n_jobs=16, jid=jid,
                         policy="algorithm2", engine=getattr(sched, engine))
        answers, cur = [], s.start_procs
        for step in range(s.total_steps):
            act = s.query(step=step, current=cur, params=s.params)
            answers.append(_plain(act))
            if act.kind != "none":
                cur = act.target
        return (s.start_procs, s.total_steps, s.expected_resizes(),
                [(d, _plain(a), _fields(r)) for d, a, r in s.schedule],
                s.result.summary(), answers)
    assert run(tcosim, tsched) == run(jcosim, jsched)


def test_sim_workload_matches_jax():
    def run(wl, cosim, sched):
        specs = wl.materialize_live("bimodal", n_jobs=12, device_count=16,
                                    seed=6)
        jobs = [wl.Job(jid=s.jid, app=dataclasses.replace(
                    s.app, params=s.params, iterations=s.steps),
                    submit_time=float(s.submit_step), moldable=s.moldable,
                    malleable=s.malleable) for s in specs]
        w = cosim.SimWorkload(jobs, total_steps={s.jid: s.steps
                                                 for s in specs},
                              config=sched.SimConfig(nodes=16),
                              policy="throughput")
        return (w.start_procs, w.start_order,
                {j: [(d, _plain(a)) for d, a, _ in s]
                 for j, s in w.schedules.items()},
                {j: w.expected_resizes(j) for j in w.schedules},
                w.result.summary())
    assert run(twl, tcosim, tsched) == run(jwl, jcosim, jsched)


def test_schedule_normalization_matches_jax():
    sched = [(5, "a"), (5, "b"), (9, "c"), (9, "d"), (9, "e")]
    for steps in (10, 6, 5):
        assert tcosim._normalize_schedule(sched, steps, 0) == \
            jcosim._normalize_schedule(sched, steps, 0)
    with pytest.raises(ValueError, match="resized 5 times"):
        tcosim._normalize_schedule(sched, 4, 0)


# -- the trail auditor ------------------------------------------------------

def _recorded(cluster_mod, wl_mod):
    specs = wl_mod.materialize_live("bursty", n_jobs=12, device_count=16,
                                    seed=9)
    cl = cluster_mod.Cluster.sched_only(specs, n_devices=16,
                                        policy="algorithm2",
                                        record_trail=True)
    cl.run()
    return cl


def _first(trail, kind):
    return next(i for i, e in enumerate(trail) if e[0] == kind)


def _dup_grant(trail, jobs):
    i = _first(trail, "grant")
    return trail[:i + 1] + [trail[i]] + trail[i + 1:], jobs, {}


def _alien(trail, jobs):
    i = _first(trail, "grant")
    k, jid, ids, tick = trail[i]
    trail[i] = (k, jid, ids[:-1] + (9999,), tick)
    return trail, jobs, {}


def _early_release(trail, jobs):
    i = _first(trail, "grant")
    k, jid, ids, tick = trail[i]
    return trail[:i] + [("release", jid, ids, tick)] + trail[i:], jobs, {}


def _double_release(trail, jobs):
    i = _first(trail, "release")
    return trail[:i + 1] + [trail[i]] + trail[i + 1:], jobs, {}


def _non_owner(trail, jobs):
    i = _first(trail, "release")
    k, jid, ids, tick = trail[i]
    return (trail[:i + 1] + [("release", jid + 1, ids, tick)]
            + trail[i + 1:], jobs, {})


def _drop_release(trail, jobs):
    i = _first(trail, "release")
    return trail[:i] + trail[i + 1:], jobs, {}


def _rigid_resize(trail, jobs):
    jid = trail[_first(trail, "resize")][1]
    jobs[jid] = dataclasses.replace(jobs[jid], malleable=False)
    return trail, jobs, {}


def _rigid_start(trail, jobs):
    i = _first(trail, "start")
    jid, procs = trail[i][1], trail[i][2]
    jobs[jid] = dataclasses.replace(jobs[jid], moldable=False,
                                    max_procs=procs + 1)
    return trail, jobs, {}


def _out_of_range(trail, jobs):
    i = _first(trail, "resize")
    jid = trail[i][1]
    jobs[jid] = dataclasses.replace(jobs[jid],
                                    max_procs=trail[i][2][3] - 1)
    return trail, jobs, {}


def _oversize(trail, jobs):
    i = _first(trail, "resize")
    k, jid, (step, kind, frm, to), tick = trail[i]
    trail[i] = (k, jid, (step, "expand", frm, to + 64), tick)
    return trail, jobs, {}


def _chain(trail, jobs):
    i = _first(trail, "resize")
    k, jid, (step, kind, frm, to), tick = trail[i]
    trail[i] = (k, jid, (step, kind, frm + 1, to), tick)
    return trail, jobs, {}


def _inhibitor(spacing):
    def fn(trail, jobs):
        i = _first(trail, "resize")
        k, jid, (step, kind, frm, to), tick = trail[i]
        trail.insert(i + 1, (k, jid, (step + 1, "shrink", to, frm), tick))
        jobs[jid] = dataclasses.replace(jobs[jid], sched_iterations=5)
        return trail, jobs, dict(expect_complete=False,
                                 check_spacing=spacing)
    return fn


def _final_mismatch(trail, jobs):
    fi = _first(trail, "finish")
    trail[fi] = ("finish", trail[fi][1], trail[fi][2] + 1, trail[fi][3])
    return trail, jobs, {}


def _after_finish(trail, jobs):
    fi = _first(trail, "finish")
    jid, procs, tick = trail[fi][1], trail[fi][2], trail[fi][3]
    return trail + [("resize", jid, (999, "expand", procs, procs + 1),
                     tick + 1)], jobs, {}


def _before_start(trail, jobs):
    return [("resize", 777, (0, "expand", 1, 2), 0)] + trail, jobs, {}


def _double_finish(trail, jobs):
    return trail + [trail[_first(trail, "finish")]], jobs, {}


def _truncated(trail, jobs):
    return trail[:_first(trail, "finish")], jobs, {}


MUTATIONS = {
    "clean": lambda trail, jobs: (trail, jobs, {}),
    "double-grant": _dup_grant, "unknown-device": _alien,
    "release-before-grant": _early_release,
    "double-release": _double_release, "non-owner-release": _non_owner,
    "leaked-devices": _drop_release, "rigid-resize": _rigid_resize,
    "rigid-start-size": _rigid_start, "resize-out-of-range": _out_of_range,
    "undersized-mesh": _oversize, "chain-continuity": _chain,
    "inhibitor-violation": _inhibitor(True),
    "inhibitor-cosim-exempt": _inhibitor(False),
    "final-procs-mismatch": _final_mismatch,
    "resize-after-finish": _after_finish,
    "resize-before-start": _before_start, "double-finish": _double_finish,
    "unfinished-job": _truncated,
}


BAD_RELEASE = dict.fromkeys(("release-before-grant", "double-release",
                             "non-owner-release"), "bad-release")


def _verdict(trail_mod, cl, mutate, jobs_cls):
    jobs = {j: jobs_cls(**dataclasses.asdict(m))
            for j, m in trail_mod.job_metadata(cl).items()}
    trail, jobs, kw = mutate([tuple(e) for e in cl.trail], jobs)
    return [dataclasses.astuple(v) for v in trail_mod.audit_trail(
        trail, cl._pool_ids, jobs=jobs, **kw)]


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_trail_auditor_verdicts_match_jax(name):
    """One valid recorded trail (equal in both packages), corrupted as
    ``tests/test_analysis_trail.py`` corrupts it: the port's auditor
    finds exactly the reference's violations, in order, with the same
    details."""
    tcl, jcl = _recorded(tcluster, twl), _recorded(jcluster, jwl)
    assert tcl.trail == jcl.trail
    got = _verdict(ttrail, tcl, MUTATIONS[name], ttrail.JobMeta)
    want = _verdict(jtrail, jcl, MUTATIONS[name], jtrail.JobMeta)
    assert got == want
    kinds = {v[0] for v in got}
    if name == "clean":
        assert not kinds
    elif name == "inhibitor-cosim-exempt":
        assert "inhibitor-violation" not in kinds
    else:
        assert BAD_RELEASE.get(name, name) in kinds


def test_grant_log_and_resize_log_audits_match_jax():
    pool = [0, 1, 2, 3]
    logs = [
        [("grant", 1, (0, 1)), ("release", 1, (1,)), ("grant", 2, (1, 2)),
         ("release", 2, (1, 2)), ("release", 1, (0,))],
        [("grant", 1, (0,)), ("grant", 2, (0,))], [("grant", 1, (7,))],
        [("grant", 1, (0,)), ("release", 2, (0,))],
        [("grant", 1, (0, 1)), ("release", 1, (1,))]]
    for log in logs:
        assert [dataclasses.astuple(v) for v in
                ttrail.audit_grant_log(log, pool)] == \
            [dataclasses.astuple(v) for v in
             jtrail.audit_grant_log(log, pool)]
    res = tsched.Simulator(twl.make_workload(16, seed=3, mode="moldable"),
                           policy="algorithm2").run()
    recs = list(res.resize_log)
    broken = [dataclasses.replace(recs[0], t=recs[-1].t + 1.0)] + recs[1:]
    jrecs = [jsched.ResizeRecord(**dataclasses.asdict(r)) for r in broken]
    jjobs = jwl.make_workload(16, seed=3, mode="moldable")
    assert [dataclasses.astuple(v) for v in
            ttrail.audit_resize_log(broken, res.jobs)] == \
        [dataclasses.astuple(v) for v in
         jtrail.audit_resize_log(jrecs, jjobs)]


def test_live_auditor_conservation_matches_jax():
    out = []
    for mod in (ttrail, jtrail):
        a = mod.TrailAuditor([0, 1, 2, 3])
        a.on_grant(1, (0, 1), 0)
        a.check_conservation(2, 0)
        a.check_conservation(3, 1)
        out.append([dataclasses.astuple(v) for v in a.violations])
    assert out[0] == out[1] and len(out[0]) == 1
