"""MalleableRunner — the DMR_RECONFIG trigger for PyTorch jobs (paper
§3.1/§3.3; port of ``repro/dmr/runner.py``).

    runner = dmr.MalleableRunner(app, params, rms)
    state = runner.init()
    for step in range(start, total):
        state = dmr.reconfig(runner, state, step)   # <- the DMR_RECONFIG point
        state, out = runner.step(state, step)

``reconfig`` implements Algorithm 1 under a single controller: query the
RMS (honoring the §3.2 inhibitors), and on a resize build the new job mesh,
redistribute the state tree through the job's named redistribution
patterns (in memory, §2.2 — never through disk), swap in the step closure
for the new mesh, and continue at the same iteration.  The worker pool is
a list of logical workers (``repro_torch.parallel.mesh.logical_workers``),
on ``cuda`` unless the caller passes others; a job's step closures are
cached per size, the counterpart of the JAX package's executables.  Under
``dmr.Cluster`` the pool is a slice of the cluster's, grown and trimmed
through the ``MalleableTenant`` contract (``grant_devices`` /
``release_devices`` / ``shutdown`` / ``current_size``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.params import MalleabilityParams
from repro_torch.core.policy import Action, ClusterView, get_policy
from repro_torch.core.redistribute import TransferStats
from repro_torch.dmr.app import MalleableApp, ensure_app
from repro_torch.dmr.connectors import PolicyRMS, RMSConnector, connect
from repro_torch.dmr.patterns import PatternSpec, redistribute_tree
from repro_torch.parallel.mesh import logical_workers, make_job_mesh


@dataclasses.dataclass
class ResizeEvent:
    step: int
    action: str                       # "expand" | "shrink" | "migrate"
    from_procs: int
    to_procs: int
    transfer: TransferStats
    recompile_s: float
    #: TransferStats per named redistribution pattern (keyed by pattern
    #: spec, e.g. "default" / "blockcyclic:4"); empty for a custom
    #: whole-tree ``redistribute`` callable.
    per_pattern: Dict[str, TransferStats] = dataclasses.field(
        default_factory=dict)


class MalleableRunner:
    """Algorithm 1 under a single controller.

    ``app`` is a ``dmr.App`` or any MalleableApp-protocol object;
    ``rms`` anything ``dmr.connect`` accepts (connector, ``{step: target}``
    dict, ``"file:<path>"``); per-subtree redistribution ``patterns``
    default to the app's own (``dmr.App(patterns=...)``).
    """

    def __init__(self, app: MalleableApp, params: MalleabilityParams,
                 rms: Optional[RMSConnector] = None, *,
                 devices: Optional[List] = None,
                 patterns: Optional[Dict[str, PatternSpec]] = None,
                 redistribute: Optional[Callable] = None,
                 max_model_axis: int = 16,
                 policy=None,
                 cluster_view: Optional[Callable[[], ClusterView]] = None,
                 initial_procs: Optional[int] = None,
                 allow_partial: bool = False,
                 mesh_factory: Optional[Callable] = None,
                 event_listener: Optional[Callable] = None):
        self.app = ensure_app(app)
        self.params = params
        # default pool: max_procs logical workers on the card (raises when
        # there is none — pass CPU workers explicitly to run on the CPU)
        self.devices = list(devices) if devices is not None \
            else logical_workers(params.max_procs)
        self.patterns = patterns if patterns is not None \
            else getattr(self.app, "patterns", None)
        self._custom_redistribute = redistribute
        # ``mesh_factory(workers, max_model=)`` replaces ``make_job_mesh``:
        # scheduling-only studies (dmr.Cluster.sched_only) run many
        # runners over synthetic pools with no job meshes at all
        self._mesh_factory = mesh_factory
        self.max_model_axis = max_model_axis
        self.current = params.clamp(initial_procs) \
            if initial_procs is not None else params.preferred
        # ``allow_partial``: the pool may start below max_procs (under
        # dmr.Cluster a job begins with whatever the scheduler granted and
        # grows via grant_devices) — it only has to cover the starting
        # size.  Standalone runners keep the fail-fast default: an
        # undersized pool would otherwise silently collapse every expand.
        if len(self.devices) < self.current:
            raise ValueError(
                f"need {self.current} workers to start, have "
                f"{len(self.devices)} devices in the pool")
        if not allow_partial and len(self.devices) < params.max_procs:
            raise ValueError(
                f"device pool ({len(self.devices)}) cannot reach "
                f"max_procs={params.max_procs}; pass allow_partial=True if "
                f"the pool grows later via grant_devices (dmr.Cluster does)")
        rms = connect(rms)
        if rms is None:
            # run a named/custom Policy locally against a cluster view
            # (default: this runner owns every worker of its pool and
            # there is no queue — the single-tenant standalone case)
            view = cluster_view or (lambda: ClusterView(
                available=len(self.devices) - self.current,
                pending_min_sizes=[]))
            rms = PolicyRMS(view, policy=get_policy(policy))
        elif policy is not None or cluster_view is not None:
            raise ValueError(
                "pass either rms= or policy=/cluster_view=, not both")
        self.rms = rms
        self.mesh = self._mesh_for(self.current)
        self._step_cache: Dict[int, Callable] = {}
        self.events: List[ResizeEvent] = []
        #: optional pure observer ``fn(event)`` invoked on every appended
        #: ResizeEvent — *after* pool clamping, so it sees the resize that
        #: actually happened, including forced migrations and cosim
        #: boundary-drain replays.  ``dmr.Cluster`` hooks its schedule
        #: trail / live sanitizer here; listeners must not mutate state.
        self.event_listener = event_listener
        self._last_query_step = -10 ** 9
        self._last_query_time = 0.0

    # ------------------------------------------------------------------
    def _mesh_for(self, n: int):
        if n > len(self.devices):
            raise RuntimeError(
                f"cannot build a {n}-worker mesh: only {len(self.devices)} "
                f"devices in the live pool (shrunk by handle_failure, or a "
                f"partial dmr.Cluster grant?) — a still-legal size must be "
                f"clamped to the pool before building its mesh")
        factory = self._mesh_factory or make_job_mesh
        return factory(self.devices[:n], max_model=self.max_model_axis)

    def _pool_clamp(self, target: int) -> int:
        """Largest legal size that both satisfies ``params`` and fits the
        *live* device pool (which may have shrunk below ``max_procs``).

        A target beyond the pool collapses to the current size when
        nothing larger fits (an unhonorable expand is a no-op, never an
        accidental shrink); only when the current size itself no longer
        fits (mid-``handle_failure``) does it fall to the largest legal
        size below."""
        pool = len(self.devices)
        if target <= pool:
            return target
        best = max((s for s in self.params.legal_sizes() if s <= pool),
                   default=0)
        if best <= self.current <= pool:
            return self.current
        if not best:
            raise RuntimeError(
                f"no legal size fits the live pool: {pool} devices < "
                f"min_procs={self.params.min_procs}")
        return best

    def _step_fn(self, n: int) -> Callable:
        if n not in self._step_cache:
            self._step_cache[n] = self.app.make_step(self._mesh_for(n))
        return self._step_cache[n]

    def init(self) -> Any:
        return self.app.init_state(self.mesh)

    def prewarm(self, sizes: Optional[List[int]] = None):
        """Build the step closures of candidate sizes (min/pref/max by
        default) so a later resize costs only the state transfer — the
        counterpart of the JAX package's ahead-of-time compiles. Returns
        seconds spent.

        Candidates are clamped to the *live* pool: a size that no longer
        fits (post-failure, or under a partial Cluster grant) is skipped
        rather than built against an undersized mesh."""
        t0 = time.perf_counter()
        pool = len(self.devices)
        for n in sizes or [self.params.min_procs, self.params.preferred,
                           self.params.max_procs]:
            n = self.params.clamp(n)
            if n <= pool:
                self._step_fn(n)
        return time.perf_counter() - t0

    # -- device pool management (the MalleableTenant contract) ---------
    @property
    def current_size(self) -> int:
        """Workers actually running — the ``MalleableTenant`` spelling of
        ``self.current`` (``repro_torch.dmr.tenant``); ``len(devices) -
        current_size`` is the excess a manager may reclaim."""
        return self.current

    def grant_devices(self, new_devices: List) -> None:
        """Extend the live pool (Cluster expand path).  The grant may be
        non-contiguous — any workers the cluster has idle.  Appending
        preserves the ``devices[:n]`` prefix every cached step closure was
        built on, so existing closures stay valid."""
        ids = {d.id for d in self.devices}
        dup = [d.id for d in new_devices if d.id in ids]
        if dup:
            raise ValueError(f"devices {dup} already in this runner's pool")
        self.devices.extend(new_devices)

    def release_devices(self) -> List:
        """Trim the live pool to the current size, returning the released
        tail (Cluster reclaims it after a shrink).  Cached step closures
        for sizes beyond the new pool are dropped — their meshes are
        stale."""
        released = self.devices[self.current:]
        self.devices = self.devices[:self.current]
        for n in [k for k in self._step_cache if k > self.current]:
            del self._step_cache[n]
        return released

    def shutdown(self) -> List:
        """Release the whole pool (job complete); returns every device."""
        released, self.devices = self.devices, []
        self._step_cache.clear()
        return released

    # ------------------------------------------------------------------
    def query_due(self, step: int) -> bool:
        """True iff ``maybe_reconfig`` at this step would actually query
        the RMS — both §3.2 inhibitor guards pass.  Schedulers that track
        inhibitor windows externally (the event-driven ``dmr.Cluster``)
        use this to skip the call entirely for quiescent tenants."""
        p = self.params
        if step - self._last_query_step < max(p.sched_iterations, 1):
            return False
        if p.sched_period_s and \
                time.monotonic() - self._last_query_time < p.sched_period_s:
            return False
        return True

    def maybe_reconfig(self, state, step: int):
        """Algorithm 1: check the §3.2 inhibitors, query the RMS, resize if
        told to."""
        if not self.query_due(step):
            return state
        self._last_query_step = step
        self._last_query_time = time.monotonic()

        action = self.rms.query(step=step, current=self.current,
                                params=self.params)
        if action.kind == "none" or action.target == self.current:
            return state
        return self.apply_resize(state, step, action)

    def _redistribute(self, state, new_shardings, target: int):
        if self._custom_redistribute is not None:
            state, stats = self._custom_redistribute(state, new_shardings)
            return state, stats, {}
        return redistribute_tree(state, new_shardings,
                                 patterns=self.patterns,
                                 from_procs=self.current, to_procs=target)

    def apply_resize(self, state, step: int, action: Action, *,
                     force: bool = False):
        """Expand/shrink to action.target: reshard state, swap step closure.

        The target is re-checked after ``params.clamp`` — and clamped to
        the *live* device pool, which may have shrunk below ``max_procs``
        (handle_failure) or not yet cover it (a partial Cluster grant): a
        clamped action that collapses to the current size is a no-op — no
        redistribution runs and no ResizeEvent is logged.  ``force=True``
        overrides the guard for same-size *migrations* (the device set
        changed under the job, e.g. after a failure), which do move state
        and are logged.
        """
        target = self._pool_clamp(self.params.clamp(action.target))
        if target == self.current and not force:
            return state
        new_mesh = self._mesh_for(target)
        new_shardings = self.app.state_shardings(new_mesh)
        state, stats, per_pattern = self._redistribute(state, new_shardings,
                                                       target)
        t0 = time.perf_counter()
        self._step_fn(target)          # build (cached across resizes)
        recompile = time.perf_counter() - t0
        kind = action.kind if target != self.current else "migrate"
        event = ResizeEvent(
            step=step, action=kind, from_procs=self.current,
            to_procs=target, transfer=stats, recompile_s=recompile,
            per_pattern=per_pattern)
        self.events.append(event)
        if self.event_listener is not None:
            self.event_listener(event)
        self.current = target
        self.mesh = new_mesh
        return state

    # ------------------------------------------------------------------
    def step(self, state, step: int, *args):
        return self._step_fn(self.current)(state, step, *args)

    # fault tolerance: forced shrink onto survivors
    def handle_failure(self, state, step: int, failed_devices) -> Any:
        failed = {d.id for d in failed_devices}
        survivors = [d for d in self.devices if d.id not in failed]
        self.devices = survivors
        # legal size at or below the survivor count
        sizes = [s for s in self.params.legal_sizes() if s <= len(survivors)]
        if not sizes:
            raise RuntimeError("not enough survivors to continue; restart "
                               "from checkpoint (on-disk C/R path)")
        self._step_cache.clear()
        # force: even a same-size target is a migration (the device set
        # changed), so the state must move onto the survivor mesh
        return self.apply_resize(state, step, Action("shrink", max(sizes)),
                                 force=True)


def reconfig(runner: MalleableRunner, state, step: int):
    """The DMR_RECONFIG point (Algorithm 1), as a one-line call."""
    return runner.maybe_reconfig(state, step)
