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
cached per size, the counterpart of the JAX package's executables.
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
    #: spec, e.g. "default" / "blockcyclic:4").
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
                 policy=None):
        self.app = ensure_app(app)
        self.params = params
        # default pool: max_procs logical workers on the card (raises when
        # there is none — pass CPU workers explicitly to run on the CPU)
        self.devices = list(devices) if devices is not None \
            else logical_workers(params.max_procs)
        self.patterns = patterns if patterns is not None \
            else getattr(self.app, "patterns", None)
        self.current = params.preferred
        # fail fast: an undersized pool would silently collapse every expand
        if len(self.devices) < params.max_procs:
            raise ValueError(
                f"device pool ({len(self.devices)}) cannot reach "
                f"max_procs={params.max_procs}")
        rms = connect(rms)
        if rms is None:
            # run a named/custom Policy locally: this runner owns every
            # worker of its pool and there is no queue
            rms = PolicyRMS(lambda: ClusterView(
                available=len(self.devices) - self.current,
                pending_min_sizes=[]), policy=get_policy(policy))
        elif policy is not None:
            raise ValueError("pass either rms= or policy=, not both")
        self.rms = rms
        self.mesh = self._mesh_for(self.current)
        self._step_cache: Dict[int, Callable] = {}
        self.events: List[ResizeEvent] = []
        self._last_query_step = -10 ** 9
        self._last_query_time = 0.0

    # ------------------------------------------------------------------
    def _mesh_for(self, n: int):
        if n > len(self.devices):
            raise RuntimeError(
                f"cannot build a {n}-worker mesh: only {len(self.devices)} "
                f"devices in the live pool (shrunk by handle_failure) — a "
                f"still-legal size must be clamped to the pool first")
        return make_job_mesh(self.devices[:n])

    def _pool_clamp(self, target: int) -> int:
        """Largest legal size that both satisfies ``params`` and fits the
        *live* device pool (which handle_failure may have shrunk below
        ``max_procs``).

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

    # ------------------------------------------------------------------
    def maybe_reconfig(self, state, step: int):
        """Algorithm 1: check the §3.2 inhibitors, query the RMS, resize if
        told to."""
        p = self.params
        if step - self._last_query_step < max(p.sched_iterations, 1):
            return state
        if p.sched_period_s and \
                time.monotonic() - self._last_query_time < p.sched_period_s:
            return state
        self._last_query_step = step
        self._last_query_time = time.monotonic()

        action = self.rms.query(step=step, current=self.current,
                                params=self.params)
        if action.kind == "none" or action.target == self.current:
            return state
        return self.apply_resize(state, step, action)

    def apply_resize(self, state, step: int, action: Action, *,
                     force: bool = False):
        """Expand/shrink to action.target: reshard state, swap step closure.

        The target is re-checked after ``params.clamp`` — and clamped to
        the *live* device pool, which may have shrunk below ``max_procs``
        (handle_failure): a clamped action that collapses to the current
        size is a no-op — no redistribution runs and no ResizeEvent is
        logged.  ``force=True``
        overrides the guard for same-size *migrations* (the device set
        changed under the job, e.g. after a failure), which do move state
        and are logged.
        """
        target = self._pool_clamp(self.params.clamp(action.target))
        if target == self.current and not force:
            return state
        new_mesh = self._mesh_for(target)
        new_shardings = self.app.state_shardings(new_mesh)
        state, stats, per_pattern = redistribute_tree(
            state, new_shardings, patterns=self.patterns,
            from_procs=self.current, to_procs=target)
        t0 = time.perf_counter()
        self._step_fn(target)          # build (cached across resizes)
        recompile = time.perf_counter() - t0
        kind = action.kind if target != self.current else "migrate"
        event = ResizeEvent(
            step=step, action=kind, from_procs=self.current,
            to_procs=target, transfer=stats, recompile_s=recompile,
            per_pattern=per_pattern)
        self.events.append(event)
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
