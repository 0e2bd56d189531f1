"""Co-simulation: live runners driven by the cluster simulator's decisions
(port of ``repro/dmr/cosim.py``).

``SimRMS`` embeds a job inside the event-indexed discrete-event simulator
(``repro_torch.rms.scheduler``) and exposes that job's policy-driven
resizes as an ``RMSConnector``: the simulator replays the whole cluster — queue, policy,
inhibitors, every other job — and the designated job's resize records become
the schedule a *real* ``dmr.MalleableRunner`` executes, mapped from simulated
time onto the job's iteration axis via the job's synced work fraction.

This closes the loop between the repo's two halves: the same policy that
decides resizes in the workload studies now drives an actual PyTorch job,
and
``crosscheck`` verifies the runner's ``ResizeEvent`` trail against the
simulator's ``resize_log`` record-for-record.

    simrms = dmr.SimRMS(scenario="steady", n_jobs=16, jid=3,
                        policy="algorithm2")
    runner = dmr.MalleableRunner(app, params, simrms,
                                 initial_procs=simrms.start_procs)
    for i in range(simrms.total_steps):
        state = dmr.reconfig(runner, state, i)
        state, _ = runner.step(state, i)
    simrms.crosscheck(runner.events)      # raises on any divergence

``SimWorkload`` is the multi-tenant generalization: one simulator run over
a *whole workload*, per-job resize schedules on each job's own iteration
axis, start sizes/order as the simulated scheduler chose them, and a
cluster-wide ``crosscheck``.  ``dmr.Cluster(..., decisions="cosim")``
replays it with real co-scheduled runners on one device pool.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.core.params import MalleabilityParams
from repro_torch.core.policy import Action


def _normalize_schedule(schedule: List[Tuple], total_steps: int,
                        jid) -> List[Tuple]:
    """Make every schedule entry consumable: a runner issues at most one
    query per step, so due steps must be strictly increasing and the k-th
    entry from the end must leave k-1 later steps free.  Resizes that map
    to the same iteration (or crowd the final steps) are spread
    backward/forward without reordering."""
    if len(schedule) > total_steps:
        raise ValueError(
            f"job {jid} resized {len(schedule)} times but has only "
            f"{total_steps} steps; raise total_steps= (SimRMS) or "
            f"max_steps= in materialize_live (dmr.Cluster cosim)")
    out = list(schedule)
    for k in range(len(out) - 1, -1, -1):          # leave room at the tail
        cap = total_steps - (len(out) - k)
        if out[k][0] > cap:
            out[k] = (cap,) + out[k][1:]
    for k in range(1, len(out)):                   # strictly increasing
        if out[k][0] <= out[k - 1][0]:
            out[k] = (out[k - 1][0] + 1,) + out[k][1:]
    return out


class SimRMS:
    """RMSConnector whose decisions come from a simulated cluster.

    Pass explicit ``jobs`` (+ optional ``config``) or a scenario name
    (``scenario="steady"`` / ``"bursty"`` / ``"trace:synthetic"`` / ...).
    ``jid`` designates the tracked job; its profile's ``iterations`` set the
    default step axis (``total_steps``) the simulated resize times are
    mapped onto.  The full simulation runs eagerly at construction:
    ``result`` / ``resize_log`` hold the cluster-wide outcome, ``schedule``
    the tracked job's resizes as ``(due_step, Action, ResizeRecord)``
    (due steps normalized to be strictly increasing so one query per step
    can consume them all).

    For an exact record-for-record replay the *runner's* params must not
    suppress queries: keep ``sched_iterations <= 1`` and
    ``sched_period_s == 0`` (inhibitor pacing is already modeled inside
    the simulation) and drive at least ``total_steps`` iterations.
    """

    def __init__(self, jobs: Optional[List] = None, *,
                 scenario: Optional[str] = None, n_jobs: int = 24,
                 jid: int = 0, policy=None, config=None, engine=None,
                 total_steps: Optional[int] = None, seed: int = 0,
                 mode: str = "moldable", malleable: bool = True):
        from repro_torch.rms.scheduler import SimConfig, Simulator
        from repro_torch.rms.workload import make_scenario

        overrides: Dict = {}
        if jobs is None:
            if scenario is None:
                raise ValueError("SimRMS needs jobs= or scenario=")
            jobs, overrides = make_scenario(scenario, n_jobs, mode=mode,
                                            malleable=malleable, seed=seed)
        cfg = config or SimConfig(**overrides)
        by_id = {j.jid: j for j in jobs}
        if jid not in by_id:
            raise KeyError(f"no job {jid!r} in the workload; "
                           f"jids: {sorted(by_id)[:10]}...")
        self.job = by_id[jid]
        if not self.job.malleable:
            raise ValueError(f"job {jid} is not malleable — nothing to drive")
        self.params: MalleabilityParams = self.job.app.params
        self.total_steps = int(total_steps or self.job.app.iterations)

        schedule: List[Tuple[int, Action, object]] = []

        def _listener(rec, j):
            if rec.jid != jid:
                return
            # j.remaining_work was synced to the resize instant by the
            # engine; map the cluster-time decision onto the job's own
            # iteration axis
            frac = min(max(1.0 - j.remaining_work, 0.0), 1.0)
            due = min(int(frac * self.total_steps), self.total_steps - 1)
            schedule.append((due, Action(rec.kind, rec.to_procs), rec))

        sim = (engine or Simulator)(jobs, cfg, policy=policy,
                                    resize_listener=_listener)
        self.result = sim.run()
        self.resize_log = self.result.resize_log
        self.schedule = self._normalize(schedule)
        self._cursor = 0

    def _normalize(self, schedule):
        return _normalize_schedule(schedule, self.total_steps, self.job.jid)

    # ------------------------------------------------------------------
    @property
    def start_procs(self) -> int:
        """Workers the scheduler started the tracked job with (a moldable
        job starts with whatever was free, not necessarily its preferred)."""
        if self.schedule:
            return self.schedule[0][2].from_procs
        return self.job.nprocs

    def query(self, *, step: int, current: int,
              params: MalleabilityParams) -> Action:
        if self._cursor >= len(self.schedule):
            return Action.none(current)
        due, act, _rec = self.schedule[self._cursor]
        if step < due:
            return Action.none(current)
        self._cursor += 1
        tgt = params.clamp(act.target)
        if tgt == current:
            return Action.none(current)
        return Action("expand" if tgt > current else "shrink", tgt)

    # ------------------------------------------------------------------
    def expected_resizes(self) -> List[Tuple[str, int, int]]:
        """The tracked job's resizes from the simulator's audit log."""
        return [(r.kind, r.from_procs, r.to_procs)
                for r in self.resize_log if r.jid == self.job.jid]

    def crosscheck(self, events) -> List[Tuple[str, int, int]]:
        """Verify a runner's ResizeEvent trail against ``resize_log``.

        Raises ``ValueError`` on any divergence (missed, extra, or
        re-ordered resizes); returns the matched ``(kind, from, to)`` list.
        """
        got = [(e.action, e.from_procs, e.to_procs) for e in events]
        want = self.expected_resizes()
        if got != want:
            raise ValueError(
                f"co-simulation divergence:\n  simulator resize_log: "
                f"{want}\n  runner events:        {got}")
        return got


class SimWorkload:
    """Whole-workload co-simulation (the multi-tenant ``SimRMS``).

    One simulator run over *all* jobs produces, per jid: the resize
    schedule mapped onto that job's own iteration axis (``schedules``),
    the start size the simulated scheduler granted (``start_procs`` — a
    moldable job starts with whatever was free), and the start order
    (``start_order``).  ``dmr.Cluster(..., decisions="cosim")`` replays
    the whole thing with real runners; ``crosscheck`` then verifies every
    runner's ``ResizeEvent`` trail against the one ``resize_log``,
    jid by jid, under either engine.

    ``total_steps`` maps jid -> live iteration count (the axis each job's
    simulated resize times are projected onto).
    """

    def __init__(self, jobs: List, *, total_steps: Dict[int, int],
                 config=None, policy=None, engine=None):
        from repro_torch.rms.scheduler import SimConfig, Simulator

        cfg = config or SimConfig()
        raw: Dict[int, List[Tuple[int, Action, object]]] = {}

        def _listener(rec, j):
            steps = total_steps.get(rec.jid)
            if steps is None:
                return
            frac = min(max(1.0 - j.remaining_work, 0.0), 1.0)
            due = min(int(frac * steps), steps - 1)
            raw.setdefault(rec.jid, []).append(
                (due, Action(rec.kind, rec.to_procs), rec))

        sim = (engine or Simulator)(jobs, cfg, policy=policy,
                                    resize_listener=_listener)
        self.result = sim.run()
        self.resize_log = self.result.resize_log
        # jid-indexed view of the resize log: ``crosscheck`` at trace
        # scale (100k+ jobs) would otherwise rescan the whole log per jid
        self._resizes_by_jid: Dict[int, List[Tuple[str, int, int]]] = {}
        for r in self.resize_log:
            self._resizes_by_jid.setdefault(r.jid, []).append(
                (r.kind, r.from_procs, r.to_procs))
        self.schedules = {jid: _normalize_schedule(s, total_steps[jid], jid)
                          for jid, s in raw.items()}
        self.start_procs: Dict[int, int] = {}
        self.start_order: Dict[int, int] = {}
        for rank, j in enumerate(sorted(self.result.jobs,
                                        key=lambda x: (x.start_time, x.jid))):
            self.start_order[j.jid] = rank
            sched = self.schedules.get(j.jid)
            # first resize's from_procs is the start size; a never-resized
            # job keeps its start size in nprocs after the run
            self.start_procs[j.jid] = sched[0][2].from_procs if sched \
                else j.nprocs
        self._cursors: Dict[int, int] = {jid: 0 for jid in self.schedules}

    # -- replay interface (one consumer: dmr.Cluster) -------------------
    def reset(self) -> None:
        """Rewind every schedule cursor (a fresh replay)."""
        self._cursors = {jid: 0 for jid in self.schedules}

    def pending_action(self, jid: int, step: int) -> Optional[Action]:
        """The next scheduled action for ``jid``, if due at ``step``
        (``None`` otherwise).  Peek only — ``consume`` advances."""
        sched = self.schedules.get(jid, ())
        cur = self._cursors.get(jid, 0)
        if cur >= len(sched) or step < sched[cur][0]:
            return None
        return sched[cur][1]

    def consume(self, jid: int) -> None:
        self._cursors[jid] += 1

    def unconsumed(self, jid: int) -> int:
        """Schedule entries not yet replayed (a tenant holds its
        completion until its trail is fully consumed)."""
        return len(self.schedules.get(jid, ())) - self._cursors.get(jid, 0)

    # -- verification ----------------------------------------------------
    def expected_resizes(self, jid: int) -> List[Tuple[str, int, int]]:
        return list(self._resizes_by_jid.get(jid, ()))

    def crosscheck(self, events_by_jid: Dict[int, List]) -> Dict[int, List]:
        """Verify per-job runner events against the simulator's resize_log.

        ``events_by_jid`` maps jid -> ``ResizeEvent`` list (what
        ``ClusterResult.events_by_jid`` holds).  Raises ``ValueError``
        naming every diverging jid; returns the matched per-jid
        ``(kind, from, to)`` lists."""
        jids = sorted(set(events_by_jid) | set(self._resizes_by_jid))
        matched, diverged = {}, []
        for jid in jids:
            got = [(e.action, e.from_procs, e.to_procs)
                   for e in events_by_jid.get(jid, [])]
            want = self.expected_resizes(jid)
            if got != want:
                diverged.append(f"  jid {jid}: simulator {want} != "
                                f"runner {got}")
            matched[jid] = got
        if diverged:
            raise ValueError("workload co-simulation divergence:\n"
                             + "\n".join(diverged))
        return matched
