"""Workload model: application profiles, job classes, arrivals, scenarios
(port of ``repro/rms/workload.py``: the same numpy generators in the same
order, so a seed gives the JAX package's jobs).

Reproduces the paper's §5.2-5.4 setup: four applications with distinct
scalability personalities (Table 4/5), two submission modes (Table 6), four
job classes (Table 3), and factor-1 Feitelson (Poisson) inter-arrival times.

Submission modes (§4 / Table 6) are first-class: pass ``mode="rigid"`` or
``mode="moldable"`` to ``make_workload`` (the legacy ``moldable=`` bool is
still accepted).  Rigid jobs request exactly their upper worker limit;
moldable jobs request a ``[min, max]`` range and start with whatever the
scheduler can give.

Beyond the paper, ``SCENARIOS`` is a library of named cluster scenarios
(bursty arrivals, bimodal job sizes, straggler-heavy, energy-capped) —
each returns ``(jobs, simconfig_overrides)`` so any scheduling policy can
be evaluated against it with one call (see ``benchmarks/scenario_suite.py``).

Real-world traces are first-class too: ``parse_swf`` ingests the Standard
Workload Format (the archive format production HPC logs are published in)
into ``Job``/``AppProfile`` objects, ``generate_synthetic_swf`` emits a
deterministic SWF-format trace so tests and benchmarks need no downloads,
and ``make_scenario("trace:<path>")`` / ``make_scenario("trace:synthetic")``
wires both into the scenario library (the JAX package's
``docs/simulator.md``).

Execution-time models are Amdahl-type ``t(p) = t1*((1-f) + f/p) + c*(p-1)``
calibrated so the 10%-threshold *gain difference* heuristic (§5.3, Fig. 3)
yields exactly the paper's Table-5 malleability parameters — verified by
``benchmarks/scaling_study.py`` and tests/test_rms.py.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.params import MalleabilityParams

#: The paper's two job submission modes (§4, Table 6).
RIGID = "rigid"
MOLDABLE = "moldable"
SUBMISSION_MODES = (RIGID, MOLDABLE)


@dataclasses.dataclass(frozen=True)
class AppProfile:
    name: str
    t1: float                    # single-worker completion time (s)
    f: float                     # parallel fraction
    alpha: float                 # scaling exponent: t ~ p^-alpha
    c: float                     # per-worker comm/overhead cost (s)
    min_start: int               # minimum workers to run at all
    params: MalleabilityParams   # Table 5
    state_mb: float              # resident state (drives resize overhead)
    iterations: int              # Table 4 (sets the reconfig granularity)

    def exec_time(self, p: int) -> float:
        return self.t1 * ((1 - self.f) + self.f / p ** self.alpha) \
            + self.c * (p - 1)

    def gain_difference(self, p: int, pmin: Optional[int] = None) -> float:
        """Paper §5.3: s(p) = (t(p_prev) - t(p)) / t(min_procs) * 100."""
        pmin = pmin or self.min_start
        if p <= pmin:
            return 100.0
        return (self.exec_time(p // 2) - self.exec_time(p)) / \
            self.exec_time(pmin) * 100.0

    def step_time(self, p: int) -> float:
        return self.exec_time(p) / self.iterations


# Table 4/5 — constants calibrated so the 10%-threshold derivation over the
# doubling configurations reproduces Table 5 exactly (tests/test_rms.py):
#   CG     scalable:   lower 2, pref 16, upper 32
#   Jacobi mid:        lower 2, pref 4,  upper 32
#   N-body flat:       lower 1, pref 1,  upper 32 (never exceeds 10%)
#   HPG    I/O bound:  lower 6, pref 6,  upper 12 (min 3 workers: r/w + 1)
APPS: Dict[str, AppProfile] = {
    "cg": AppProfile(
        name="cg", t1=4000.0, f=1.0, alpha=0.30, c=0.0, min_start=1,
        params=MalleabilityParams(2, 32, 16, sched_period_s=10.0),
        state_mb=4 * 32768 * 8 / 1e6 + 32768 ** 2 * 8 / 1e6,
        iterations=10_000),
    "jacobi": AppProfile(
        name="jacobi", t1=1500.0, f=1.0, alpha=0.18, c=0.0, min_start=1,
        params=MalleabilityParams(2, 32, 4, sched_period_s=10.0),
        state_mb=2 * 16384 * 8 / 1e6 + 16384 ** 2 * 8 / 1e6,
        iterations=10_000),
    "nbody": AppProfile(
        name="nbody", t1=900.0, f=1.0, alpha=0.05, c=0.0, min_start=1,
        params=MalleabilityParams(1, 32, 1),
        state_mb=6_553_600 * 32 / 1e6,
        iterations=50),
    "hpg": AppProfile(
        name="hpg", t1=2400.0, f=1.0, alpha=0.30, c=0.008 * 2400, min_start=3,
        params=MalleabilityParams(6, 12, 6),
        state_mb=40e6 * 100 / 1e6 / 40,     # active chunk of the read set
        iterations=24),                      # #workers x 4
}


@dataclasses.dataclass
class Job:
    jid: int
    app: AppProfile
    submit_time: float
    moldable: bool               # submission mode (Table 6)
    malleable: bool              # can resize at runtime
    # -- runtime state (filled by the simulator) --
    start_time: float = -1.0
    end_time: float = -1.0
    nprocs: int = 0
    remaining_work: float = 1.0  # normalized
    last_update: float = 0.0
    work_synced_t: float = 0.0   # remaining_work is accurate as of this time
    next_reconfig_ok: float = 0.0
    boosted: bool = False        # paper: job that triggered a shrink gets top priority
    straggling: bool = False     # a slow node throttles the whole job

    @property
    def cls(self) -> str:
        """Table 3 naming."""
        if not self.moldable and not self.malleable:
            return "fixed"
        if self.moldable and not self.malleable:
            return "pure-moldable"
        if not self.moldable and self.malleable:
            return "pure-malleable"
        return "flexible"

    def request(self) -> tuple:
        """(min, max) workers requested at submission (Table 6)."""
        p = self.app.params
        if self.moldable:
            return (p.min_procs, p.max_procs)
        return (p.max_procs, p.max_procs)   # rigid: users ask for the upper limit

    def rate(self, p: int) -> float:
        """Normalized work per second at p workers."""
        return 1.0 / self.app.exec_time(p)

    def waiting(self) -> float:
        return self.start_time - self.submit_time

    def execution(self) -> float:
        return self.end_time - self.start_time

    def completion(self) -> float:
        return self.end_time - self.submit_time


def feitelson_arrivals(n_jobs: int, rng: np.random.Generator,
                       factor: float = 1.0, mean_s: float = 18.0) -> np.ndarray:
    """Factor-1 Feitelson-style Poisson arrivals (§5.4): exponential
    inter-arrival, heavily stressed queue."""
    gaps = rng.exponential(mean_s * factor, size=n_jobs)
    return np.cumsum(gaps)


def resolve_mode(mode: Optional[str], moldable: Optional[bool]) -> bool:
    """Resolve (mode, legacy-moldable-bool) to the moldable flag."""
    if mode is not None:
        if mode not in SUBMISSION_MODES:
            raise ValueError(
                f"unknown submission mode {mode!r}; known: {SUBMISSION_MODES}")
        if moldable is not None and bool(moldable) != (mode == MOLDABLE):
            raise ValueError(
                f"mode={mode!r} contradicts moldable={moldable!r}")
        return mode == MOLDABLE
    if moldable is None:
        raise TypeError("make_workload: pass mode='rigid'|'moldable' "
                        "(or the legacy moldable= bool)")
    return bool(moldable)


def make_workload(n_jobs: int, *, moldable: Optional[bool] = None,
                  malleable=True, mode: Optional[str] = None, seed: int = 0,
                  app_names: Optional[List[str]] = None,
                  malleable_fraction: float = 1.0,
                  malleable_only_app: Optional[str] = None,
                  arrivals: Optional[np.ndarray] = None,
                  app_pool: Optional[Sequence[AppProfile]] = None) -> List[Job]:
    """Random mixed workload (§5.4 / §5.6).

    ``mode`` is the submission mode (``"rigid"`` / ``"moldable"``, Table 6);
    the legacy ``moldable=`` bool is equivalent.  ``malleable`` may be a bool
    (all jobs) and is refined by ``malleable_fraction`` (Table 7 percentages)
    or ``malleable_only_app`` (Table 7 per-app columns).  ``arrivals`` and
    ``app_pool`` override the Feitelson arrival process and the Table-4 app
    mix — the hooks the scenario library builds on (duplicate an entry in
    ``app_pool`` to weight it).
    """
    is_moldable = resolve_mode(mode, moldable)
    rng = np.random.default_rng(seed)
    pool = list(app_pool) if app_pool is not None else \
        [APPS[n] for n in (app_names or list(APPS))]
    if arrivals is None:
        arrivals = feitelson_arrivals(n_jobs, rng)
    picks = rng.integers(0, len(pool), size=n_jobs)
    mall_draw = rng.random(n_jobs)
    jobs = []
    for i in range(n_jobs):
        app = pool[picks[i]]
        m = bool(malleable)
        if m and malleable_fraction < 1.0:
            m = mall_draw[i] < malleable_fraction
        if malleable_only_app is not None:
            m = app.name == malleable_only_app
        jobs.append(Job(jid=i, app=app, submit_time=float(arrivals[i]),
                        moldable=is_moldable, malleable=m))
    return jobs


# ======================================================================
# Standard Workload Format ingestion (real-world traces)
# ======================================================================
#
# SWF is the archive format of the Parallel Workloads Archive: `;`-prefixed
# header comments (including `MaxNodes:` / `MaxProcs:` directives) followed
# by one 18-field whitespace-separated record per job:
#   0 job_id   1 submit_s   2 wait_s     3 run_s      4 used_procs
#   5 avg_cpu  6 used_mem   7 req_procs  8 req_time   9 req_mem
#  10 status  11 uid       12 gid       13 exe       14 queue
#  15 part    16 prev_job  17 think_s
# Only fields 0/1/3/4 (falling back to 7) and 6 are consumed here.

#: Amdahl exponent assumed for trace jobs (traces record one (procs, time)
#: point; the profile must extrapolate to other sizes for malleability).
SWF_ALPHA = 0.5


def _swf_app(run_s: float, procs: int, mem_kb: float, nodes: int,
             cache: Dict) -> AppProfile:
    """Synthesize an ``AppProfile`` for one trace job: calibrated so
    ``exec_time(procs) == run_s`` exactly, with a legal malleability range
    [procs//4, 2*procs] (clamped to the cluster) around the recorded size."""
    pref = max(1, min(procs, nodes))
    key = (run_s, pref, mem_kb if mem_kb > 0 else -1.0)
    app = cache.get(key)
    if app is None:
        lo = max(1, pref // 4)
        hi = max(pref, min(nodes, pref * 2))
        state_mb = mem_kb * pref / 1024.0 if mem_kb > 0 else 64.0 * pref
        app = AppProfile(
            name=f"swf-{pref}p", t1=run_s * pref ** SWF_ALPHA, f=1.0,
            alpha=SWF_ALPHA, c=0.0, min_start=lo,
            params=MalleabilityParams(lo, hi, pref, sched_period_s=10.0),
            state_mb=state_mb,
            iterations=max(8, min(512, int(run_s) // 30)))
        cache[key] = app
    return app


def parse_swf(source, *, max_jobs: Optional[int] = None,
              mode: str = MOLDABLE, malleable: bool = True,
              nodes: Optional[int] = None) -> Tuple[List[Job], Dict]:
    """Parse an SWF trace into simulator jobs.

    ``source`` is a filesystem path, a string containing the trace text, or
    an iterable of lines.  Cancelled/failed records (non-positive runtime or
    processor count) and malformed/partial lines are skipped — never a
    crash — and one aggregated ``UserWarning`` reports how many records
    were dropped and why (real archive traces carry thousands of such
    records; a per-line warning would drown a 1M-job ingest).  Submit
    times may arrive non-monotonic (archives merge queues); jobs are
    re-sorted by submit time and re-based to t=0.  The cluster size is
    taken from ``nodes=``, the trace's ``MaxNodes:``/``MaxProcs:`` header,
    or the widest job seen — in that order.  Returns ``(jobs,
    simconfig_overrides)`` matching the scenario-library contract, so
    ``make_scenario("trace:path.swf")`` can hand the result straight to
    ``Simulator``.
    """
    is_moldable = resolve_mode(mode, None)
    if isinstance(source, str) and "\n" in source:
        lines = source.splitlines()
    elif isinstance(source, (list, tuple)):
        lines = source
    else:
        with open(source) as f:
            lines = f.read().splitlines()

    header: Dict[str, int] = {}
    rows = []
    n_malformed = n_cancelled = 0
    for raw in lines:
        s = raw.strip()
        if not s:
            continue
        if s.startswith(";"):
            body = s.lstrip(";").strip()
            for key in ("MaxNodes", "MaxProcs"):
                if body.startswith(key) and key not in header:
                    try:
                        header[key] = int(body.split(":", 1)[1].split()[0])
                    except (IndexError, ValueError):
                        pass
            continue
        f = s.split()
        if len(f) < 5:
            n_malformed += 1                  # partial record
            continue
        try:
            jid = int(f[0])
            submit = float(f[1])
            run_s = float(f[3])
            procs = int(float(f[4]))
            if procs <= 0 and len(f) > 7:
                procs = int(float(f[7]))      # fall back to requested procs
            mem_kb = float(f[6]) if len(f) > 6 else -1.0
        except ValueError:
            n_malformed += 1
            continue
        if run_s <= 0 or procs <= 0:
            n_cancelled += 1                  # cancelled/failed/zero-runtime
            continue
        rows.append((submit, jid, run_s, procs, mem_kb))
        if max_jobs is not None and len(rows) >= max_jobs:
            break
    if n_malformed or n_cancelled:
        warnings.warn(
            f"parse_swf: skipped {n_malformed + n_cancelled} records "
            f"({n_malformed} malformed/partial, {n_cancelled} "
            f"cancelled/zero-runtime); {len(rows)} jobs kept",
            stacklevel=2)

    # MaxNodes beats MaxProcs (whole-node allocation) wherever it appears
    # in the header — SWF imposes no directive order
    cluster = nodes or header.get("MaxNodes") or header.get("MaxProcs") or \
        (max(r[3] for r in rows) if rows else 128)
    t0 = min(r[0] for r in rows) if rows else 0.0
    cache: Dict = {}
    jobs = []
    seen = set()
    for i, (submit, jid, run_s, procs, mem_kb) in enumerate(rows):
        if jid in seen:                       # duplicate ids: renumber
            jid = -(i + 1)
        seen.add(jid)
        jobs.append(Job(jid=jid, app=_swf_app(run_s, procs, mem_kb,
                                              cluster, cache),
                        submit_time=submit - t0,
                        moldable=is_moldable, malleable=malleable))
    jobs.sort(key=lambda j: j.submit_time)
    return jobs, {"nodes": cluster}


def generate_synthetic_swf(n_jobs: int, *, seed: int = 0, nodes: int = 128,
                           mean_interarrival_s: float = 6.0,
                           mean_runtime_s: float = 120.0) -> str:
    """Emit a deterministic synthetic trace in Standard Workload Format.

    Power-of-two processor requests capped at ``nodes``, lognormal runtimes
    around ``mean_runtime_s``, Poisson arrivals — an overloaded-queue regime
    by default, which is what stresses the scheduler's queue indexes.  The
    output round-trips through ``parse_swf``; tests and benchmarks use it
    instead of downloading archive traces.
    """
    rng = np.random.default_rng(seed)
    submits = np.cumsum(rng.exponential(mean_interarrival_s, size=n_jobs))
    procs = 2 ** rng.integers(0, int(math.log2(nodes)) + 1, size=n_jobs)
    mu = math.log(mean_runtime_s) - 0.5           # lognormal mean ~ target
    runs = np.maximum(1.0, rng.lognormal(mu, 1.0, size=n_jobs))
    mem_kb = 2 ** rng.integers(16, 21, size=n_jobs)      # 64 MB – 1 GB
    lines = [
        "; Generated by repro_torch.rms.workload.generate_synthetic_swf",
        f"; MaxJobs: {n_jobs}",
        f"; MaxNodes: {nodes}",
        f"; Note: seed={seed}",
    ]
    for i in range(n_jobs):
        p = int(procs[i])
        lines.append(
            f"{i + 1} {submits[i]:.0f} -1 {runs[i]:.0f} {p} -1 "
            f"{int(mem_kb[i])} {p} {runs[i] * 2:.0f} -1 1 "
            f"-1 -1 -1 -1 -1 -1 -1")
    return "\n".join(lines) + "\n"


# ======================================================================
# Scenario library (beyond-paper): named cluster situations, policy-agnostic
# ======================================================================

def bursty_arrivals(n_jobs: int, rng: np.random.Generator,
                    burst_size: int = 25, intra_gap_s: float = 2.0,
                    inter_burst_gap_s: float = 1800.0) -> np.ndarray:
    """Arrivals in tight bursts separated by long quiet windows — the
    campaign-submission pattern that stresses shrink-to-admit policies."""
    gaps = rng.exponential(intra_gap_s, size=n_jobs)
    gaps[::burst_size] += rng.exponential(inter_burst_gap_s,
                                          size=len(gaps[::burst_size]))
    gaps[0] = 0.0
    return np.cumsum(gaps)


def diurnal_arrivals(n_jobs: int, rng: np.random.Generator,
                     period_s: float = 86400.0,
                     peak_to_trough: float = 4.0,
                     mean_gap_s: float = 18.0) -> np.ndarray:
    """Day/night arrival cycle: a non-homogeneous Poisson process whose
    rate follows a sinusoid with the given peak:trough ratio over one
    ``period_s`` cycle, starting at the trough.  Sampled by thinning
    (Lewis & Shedler), so arrivals are exact for the modulated rate.

    The mean rate is ``1 / mean_gap_s``; the instantaneous rate swings
    between ``mean * 2r/(r+1)`` (peak) and ``mean * 2/(r+1)`` (trough)
    for ``r = peak_to_trough``.  This is the serving-side counterpart of
    ``bursty_arrivals``: slow load swell instead of campaign spikes.
    """
    if peak_to_trough < 1.0:
        raise ValueError("peak_to_trough must be >= 1")
    rate_mean = 1.0 / mean_gap_s
    amp = (peak_to_trough - 1.0) / (peak_to_trough + 1.0)
    rate_max = rate_mean * (1.0 + amp)
    out = np.empty(n_jobs)
    t, i = 0.0, 0
    while i < n_jobs:
        t += rng.exponential(1.0 / rate_max)
        # phase -pi/2: t=0 sits at the trough, peak at period/2
        rate_t = rate_mean * (1.0 + amp * math.sin(
            2.0 * math.pi * t / period_s - math.pi / 2.0))
        if rng.random() * rate_max < rate_t:
            out[i] = t
            i += 1
    return out


def _scaled_app(app: AppProfile, suffix: str, t1_scale: float,
                max_procs: int) -> AppProfile:
    """Derive a size variant of an app (bimodal scenarios), keeping the
    malleability parameters legal."""
    p = app.params
    hi = min(p.max_procs, max_procs)
    lo = min(p.min_procs, hi)
    pref = min(max(p.preferred, lo), hi)
    return dataclasses.replace(
        app, name=f"{app.name}-{suffix}", t1=app.t1 * t1_scale,
        params=MalleabilityParams(lo, hi, pref, p.sched_period_s,
                                  p.sched_iterations))


def _steady(n_jobs, mode, malleable, seed):
    return make_workload(n_jobs, mode=mode, malleable=malleable,
                         seed=seed), {}


def _bursty(n_jobs, mode, malleable, seed):
    rng = np.random.default_rng(seed)
    arr = bursty_arrivals(n_jobs, rng)
    return make_workload(n_jobs, mode=mode, malleable=malleable, seed=seed,
                         arrivals=arr), {}


def _bimodal(n_jobs, mode, malleable, seed):
    # 70% short/narrow jobs, 30% long/wide jobs (duplicate entries = weights)
    small = [_scaled_app(a, "small", 0.25, 8) for a in APPS.values()]
    large = [_scaled_app(a, "large", 3.0, 32) for a in APPS.values()]
    pool = small * 7 + large * 3
    return make_workload(n_jobs, mode=mode, malleable=malleable, seed=seed,
                         app_pool=pool), {}


def _diurnal(n_jobs, mode, malleable, seed):
    rng = np.random.default_rng(seed)
    # span exactly one day-cycle regardless of n_jobs so the load swell
    # is visible even in small smoke workloads
    arr = diurnal_arrivals(n_jobs, rng, period_s=n_jobs * 18.0)
    return make_workload(n_jobs, mode=mode, malleable=malleable, seed=seed,
                         arrivals=arr), {}


def _straggler_heavy(n_jobs, mode, malleable, seed):
    jobs = make_workload(n_jobs, mode=mode, malleable=malleable, seed=seed)
    return jobs, {"straggler_mtbf_s": 4000.0, "straggler_seed": seed}


def _energy_capped(n_jobs, mode, malleable, seed):
    # power cap: half the fleet is switched off -> 64 usable nodes
    jobs = make_workload(n_jobs, mode=mode, malleable=malleable, seed=seed)
    return jobs, {"nodes": 64}


#: name -> fn(n_jobs, mode, malleable, seed) -> (jobs, simconfig_overrides)
SCENARIOS: Dict[str, Callable] = {
    "steady": _steady,
    "bursty": _bursty,
    "bimodal": _bimodal,
    "diurnal": _diurnal,
    "straggler-heavy": _straggler_heavy,
    "energy-capped": _energy_capped,
}


class UnknownScenarioError(KeyError):
    """Raised by ``make_scenario`` on an unregistered name.  Subclasses
    ``KeyError`` (the registry is a dict lookup, and callers historically
    catch that) but renders a readable multi-line message instead of
    ``KeyError``'s quoted-repr string."""

    def __str__(self) -> str:  # KeyError.__str__ would repr-quote this
        return self.args[0]


def make_scenario(name: str, n_jobs: int = 120, *, mode: str = MOLDABLE,
                  malleable: bool = True,
                  seed: int = 0) -> Tuple[List[Job], Dict]:
    """Instantiate a named scenario.

    Returns ``(jobs, overrides)`` where ``overrides`` are keyword arguments
    for ``SimConfig`` (kept as a plain dict so the workload layer stays
    import-independent from the scheduler).

    ``"trace:<path.swf>"`` replays a Standard Workload Format trace
    (``n_jobs`` caps how many records are ingested); ``"trace:synthetic"``
    generates an ``n_jobs``-record synthetic SWF trace in memory — the
    no-download stand-in used by tests and ``benchmarks/trace_replay.py``.
    """
    if name.startswith("trace:"):
        spec = name[len("trace:"):]
        if spec == "synthetic":
            text = generate_synthetic_swf(n_jobs, seed=seed)
            return parse_swf(text, mode=mode, malleable=malleable)
        return parse_swf(spec, max_jobs=n_jobs, mode=mode,
                         malleable=malleable)
    try:
        fn = SCENARIOS[name]
    except KeyError:
        names = "\n".join(f"  - {n}" for n in sorted(SCENARIOS))
        raise UnknownScenarioError(
            f"unknown scenario {name!r}; registered scenarios:\n{names}\n"
            "or a trace form: 'trace:<path.swf>' (replay an SWF file) / "
            "'trace:synthetic' (generated in memory)") from None
    return fn(n_jobs, mode, malleable, seed)


# ======================================================================
# Live materialization: scenario -> dmr.Cluster workload
# ======================================================================

@dataclasses.dataclass(frozen=True)
class LiveJobSpec:
    """One job of a *live* workload (``dmr.Cluster`` input): a scenario
    job scaled onto a real device pool and the cluster-step clock.

    ``app`` is the cost/priority model (``exec_time``, ``state_mb``) the
    scheduling policy consults; the executable the job actually runs is
    attached by the cluster (an explicit ``dmr.App`` or its
    ``app_factory``).  ``params`` are the job's original malleability
    parameters clamped to the device pool; ``steps`` is the scaled-down
    iteration count; ``submit_step`` the cluster tick of arrival.

    ``submit_s`` carries the job's *original* (pre-scale-down) submit
    time: the tick mapping can collide — two distinct submit seconds
    rounding onto one cluster tick — and every consumer must break such
    ties by ``(submit_step, submit_s, jid)`` so queue order is identical
    no matter which engine (tick reference, event cluster, or the cosim
    simulator) orders the arrivals."""
    jid: int
    app: AppProfile
    params: MalleabilityParams
    submit_step: int
    steps: int
    moldable: bool
    malleable: bool
    submit_s: float = 0.0


def materialize_live(scenario, n_jobs: Optional[int] = None, *,
                     device_count: int = 8,
                     max_steps: int = 24, arrival_span: Optional[int] = None,
                     inhibit_iterations: Optional[int] = None,
                     mode: str = MOLDABLE, malleable: bool = True,
                     seed: int = 0) -> List[LiveJobSpec]:
    """Scenario -> live-job materialization (the ``dmr.Cluster`` input).

    Takes any ``make_scenario`` name (or a prebuilt ``Job`` list) and
    scales it down to live size: worker limits scale *proportionally*
    onto ``device_count`` (an app whose upper limit is halved keeps its
    preferred size at the same fraction of it — merely clamping would
    push most preferred sizes onto the new maximum and leave Algorithm 2,
    which never shrinks below preferred, nothing to arbitrate), iteration
    counts are capped at ``max_steps`` (real steps execute — Table-4
    counts in the tens of thousands would take hours live), and submit
    *times* map proportionally onto an ``arrival_span``-tick cluster
    clock (default ``n_jobs * max_steps // 3`` ticks, which keeps
    several jobs in flight at once).

    Wall-clock inhibitors make no sense on the tick clock, so each app's
    §3.2 inhibitor is re-expressed in iterations: ``inhibit_iterations``
    if given, else 2 for apps that declared any inhibitor and 0 otherwise.
    """
    # n_jobs defaults to 8 for a scenario name and to the whole list for
    # prebuilt jobs — an explicitly supplied workload is never silently
    # truncated
    if isinstance(scenario, str):
        jobs, _ = make_scenario(scenario, n_jobs if n_jobs is not None
                                else 8, mode=mode, malleable=malleable,
                                seed=seed)
    else:
        jobs = list(scenario)
    jobs = sorted(jobs, key=lambda j: (j.submit_time, j.jid))
    if n_jobs is not None:
        jobs = jobs[:n_jobs]
    t_max = max((j.submit_time for j in jobs), default=0.0) or 1.0
    span = arrival_span if arrival_span is not None \
        else max(1, len(jobs) * max_steps // 3)
    specs = []
    for j in jobs:
        p = j.app.params
        hi = max(1, min(p.max_procs, device_count))
        scale = hi / p.max_procs
        if scale < 1.0:
            lo = max(1, min(hi, round(p.min_procs * scale) or 1))
            pref = min(hi, max(lo, round(p.preferred * scale) or 1))
        else:
            lo = min(p.min_procs, hi)
            pref = min(max(p.preferred, lo), hi)
        inhibit = inhibit_iterations if inhibit_iterations is not None \
            else (2 if (p.sched_period_s or p.sched_iterations) else 0)
        specs.append(LiveJobSpec(
            jid=j.jid,
            app=j.app,
            params=MalleabilityParams(lo, hi, pref,
                                      sched_iterations=inhibit),
            submit_step=int(round(j.submit_time / t_max * span)),
            steps=max(4, min(max_steps, j.app.iterations)),
            moldable=j.moldable, malleable=j.malleable,
            submit_s=float(j.submit_time)))
    return specs
