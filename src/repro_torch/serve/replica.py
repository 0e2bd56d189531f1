"""Elastic LM serving: replicas as malleable jobs on one worker pool (port
of ``repro/serve/replica.py``).

Two levels of elasticity, both built from the malleability primitives:

* **Within a replica** — :func:`make_decode_app` wraps prefill-by-decode
  plus greedy decode (``make_serve_step`` and the decode cache of
  ``models/model.py``: a KV cache, or an SSM state and conv tails) as a
  ``dmr.App`` whose resize point is the decode-step boundary.  The state
  is ``{"params", "cache", "tok", "pos"}``; params move by the
  ``replicate`` pattern, the cache and the token column by ``default``
  along their batch axis — an inference server grows and shrinks
  mid-generation exactly the way a training job does between steps.  Each
  decode step runs the whole batch as one launch per operation whatever
  the worker count, so the tokens are bit-identical across resizes
  (:func:`decode_demo`, driven by ``python -m repro_torch.launch.serve``).

* **Across replicas** — :class:`ReplicaSet` runs a fleet of replicas
  against a request stream, growing and shrinking capacity under a resize
  policy.  Every replica is a ``MalleableTenant``
  (``repro_torch.dmr.tenant``): workers move between the shared pool and
  a replica only through ``grant_devices`` / ``release_devices`` /
  ``shutdown``, and when ``ServeConfig.max_devices_per_replica`` exceeds
  the quantum the fleet prefers resizing a live replica's mesh in place
  (warm, ``grow_ticks``) over cold-starting a new replica
  (``cold_start_ticks``); shrinks likewise prefer in-place mesh shrinks
  over drain-and-kill.  The serving surface the latency policies read
  (``slo``, ``queue_len``, ``head_wait_s``, ``utilization``) is the
  ReplicaSet itself, passed as the ``job`` handle.  Via
  ``repro_torch.serve.tenant`` the whole fleet is in turn submittable to
  ``dmr.Cluster`` as one composite tenant.

:class:`ReplicaSet` is a discrete-event engine in the mold of
``dmr.Cluster``: one tick is one decode-step boundary
(``ServeConfig.tick_s`` seconds), requests arrive / expire / dispatch /
advance per tick, and every worker handoff is recorded in the same trail
format the cluster uses (``replica-up`` / ``replica-down`` /
``request-drop`` / ``replica-resize`` events), audited by
``repro_torch.analysis`` — including live ``sanitize=True``.  By default
replicas are host-level service models over a synthetic pool (like
``Cluster.sched_only``); pass an ``app_factory`` plus real workers
(``logical_workers``) and each replica steps a live ``MalleableRunner``
every tick.  The host model is the JAX package's line for line (the same
sort keys, tie-breaks and float sums), and live mode does not change the
schedule: a live run's ``summary()``, timeline, scale events and trail
equal the host model's.

The **service model**: a replica with ``d`` workers offers
``slots_per_device × d`` concurrent sequences (continuous batching — up to
the slot count, co-resident sequences decode at full per-step rate).  An
admitted request spends ``ceil(prompt_len / prefill_tokens_per_tick)``
ticks in prefill, then one tick per generated token.  Deadlines bound
*queue wait* (time-to-first-token patience): a request that waits past
its deadline is dropped — the user navigated away — and counts zero
goodput; once admitted, a request always completes.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.core.params import MalleabilityParams
from repro_torch.core.policy import Action, ClusterView, get_policy
from repro_torch.parallel.mesh import Placement, logical_workers
from repro_torch.serve.metrics import ServingMetrics
from repro_torch.serve.slo import SLOTracker
from repro_torch.serve.traffic import (LeastLoadedBalancer, Request,
                                       RequestQueue)

__all__ = ["ServeConfig", "Replica", "ReplicaSet", "ServingResult",
           "make_decode_app", "decode_demo"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_decode_app(cfg, *, batch: int, cache_len: int, seed: int = 0,
                    params=None):
    """The serving step as a ``dmr.App``: resize point = decode-step
    boundary.

    State tree: ``{"params", "cache", "tok", "pos"}``.  Params stay
    replicated (the ``{"params": "replicate"}`` pattern); cache leaves and
    ``tok`` are split along their batch axis over the whole mesh whenever
    ``batch`` divides the worker count (an encoder-decoder model's cross
    cache too: ``cache_len`` slots, zeros, as the reference's serving path
    leaves it).  ``params`` (e.g. from
    ``repro_torch.interop.params_from_numpy``) replaces the seeded init.
    ``step(state, i, feed)`` consumes ``feed`` (a ``(batch,)`` int array of
    prompt tokens) when given — prefill-by-decode — and the previous step's
    argmax otherwise; it returns ``(state, next_tokens)``.
    """
    from repro_torch import dmr
    from repro_torch.models import model as M
    from repro_torch.models.train import make_serve_step

    def _shardings(mesh):
        n = mesh.size

        def shard_batch(shape):
            if batch % n == 0:
                # cache leaves stack layers in front: batch sits at axis
                # 1 for (L, B, ...) leaves, axis 0 for (B, ...) leaves
                for ax in (1, 0):
                    if ax < len(shape) and shape[ax] == batch:
                        return Placement(mesh, ax)
            return Placement(mesh)

        # the cache's real shapes, allocated nowhere (the counterpart of
        # the reference's jax.eval_shape)
        cache_meta = M.init_cache(cfg, batch, cache_len, device="meta",
                                  enc_len=cache_len)
        return {
            "params": T.tree_map(lambda _: Placement(mesh),
                                 M.model_schema(cfg)),
            "cache": T.tree_map(lambda t: shard_batch(tuple(t.shape)),
                                cache_meta),
            "tok": shard_batch((batch, 1)),
            "pos": Placement(mesh),
        }

    def _init(mesh):
        dev = mesh.device
        if params is not None:
            p = T.tree_map(lambda t: t.to(dev), params)
        else:
            gen = torch.Generator(device=dev).manual_seed(seed)
            p = M.init_params(cfg, gen, dev)
        return {"params": p,
                "cache": M.init_cache(cfg, batch, cache_len, device=dev,
                                      enc_len=cache_len),
                "tok": torch.zeros((batch, 1), dtype=torch.int32, device=dev),
                "pos": torch.zeros((), dtype=torch.int32, device=dev)}

    def _step(mesh):
        # one closure per mesh: the runner swaps closures on resize
        dev = mesh.device
        serve_impl = make_serve_step(cfg)

        def step_fn(state, i, feed=None):
            tok = state["tok"]
            if feed is not None:
                tok = torch.as_tensor(np.asarray(feed, np.int32)).reshape(
                    batch, 1).to(dev)
            with torch.no_grad():
                nxt, cache = serve_impl(state["params"], state["cache"], tok,
                                        state["pos"])
            state = {"params": state["params"], "cache": cache, "tok": nxt,
                     "pos": state["pos"] + 1}
            return state, nxt

        return step_fn

    name = getattr(cfg, "name", "lm")
    return dmr.App(init=_init, shardings=_shardings, step=_step,
                   patterns={"params": "replicate"},
                   name=f"decode-{name}")


def decode_demo(arch, *, batch: int = 4, prompt_len: int = 16,
                decode_steps: int = 16, cache_len: int = 128,
                schedule: Optional[Dict[int, int]] = None,
                workers: int = 1, devices: Optional[List] = None,
                device=None, seed: int = 0, params=None) -> Dict:
    """Prefill + greedy decode under a ``MalleableRunner``, resizing at
    decode-step boundaries through ``dmr.reconfig``.

    ``arch`` is a config name (``get_config``) or an ``ArchConfig``, such
    as one cut in depth with ``dataclasses.replace``.  The pool is
    ``workers`` logical workers on ``device`` (``cuda`` unless given;
    raises when no card is present) or an explicit ``devices`` list.
    ``schedule`` is a ``{step: target_workers}`` dict (``dmr.connect``'s
    scripted form); the default resizes nobody.  Returns ``{"tokens":
    (batch, decode_steps) array, "events": [ResizeEvent...], "sizes":
    [(step, workers)...], "prefill_s", "decode_s", "cache": the final
    decode cache (on the device)}``; the two times end with the device
    synchronised.
    """
    from repro_torch import dmr
    from repro_torch.configs import get_config

    cfg = get_config(arch) if isinstance(arch, str) else arch
    devices = list(devices) if devices is not None \
        else logical_workers(workers, device)
    dev = devices[0].device
    hi = 1 << (len(devices).bit_length() - 1)         # largest pow2 <= pool
    mparams = MalleabilityParams(1, hi, min(hi, max(1, hi // 2)))
    app = make_decode_app(cfg, batch=batch, cache_len=cache_len, seed=seed,
                          params=params)
    runner = dmr.MalleableRunner(app, mparams, rms=dict(schedule or {}),
                                 devices=devices[:hi])
    state = runner.init()

    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab_size, (batch, prompt_len),
                           dtype=np.int32)
    sizes: List[Tuple[int, int]] = [(0, runner.current)]
    outs: List[torch.Tensor] = []
    _sync(dev)
    t0 = time.perf_counter()
    prefill_s = 0.0
    total = prompt_len + decode_steps
    for i in range(total):
        state = dmr.reconfig(runner, state, i)
        if sizes[-1][1] != runner.current:
            sizes.append((i, runner.current))
        feed = prompts[:, i] if i < prompt_len else None
        state, tok = runner.step(state, i, feed)
        if i >= prompt_len - 1:
            outs.append(tok[:, 0])
        if i == prompt_len - 1:
            _sync(dev)
            prefill_s = time.perf_counter() - t0
            t0 = time.perf_counter()
    _sync(dev)
    decode_s = time.perf_counter() - t0
    tokens = torch.stack(outs[:decode_steps], dim=1).cpu().numpy()
    return {"tokens": tokens, "events": list(runner.events),
            "sizes": sizes, "prefill_s": prefill_s, "decode_s": decode_s,
            "cache": state["cache"]}


# ======================================================================
# the fleet engine
# ======================================================================

@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Fleet shape + service model + SLO knobs for :class:`ReplicaSet`.

    The per-replica mesh-elasticity knobs default to 0 = "same as
    ``devices_per_replica``", which disables in-place resizing and keeps
    the classic whole-replica fleet semantics; set
    ``max_devices_per_replica`` above the quantum to let scale-ups grow
    an existing replica's mesh through ``dmr.reconfig`` before paying a
    replica cold start (``cold_start_ticks`` of no service for a new
    replica vs ``grow_ticks`` of warm-up for in-place-granted devices).
    """
    devices_per_replica: int = 2
    min_replicas: int = 1
    max_replicas: int = 8
    initial_replicas: int = 2
    slots_per_device: int = 4        # concurrent sequences per device
    prefill_tokens_per_tick: int = 256
    tick_s: float = 0.02             # seconds per decode-step boundary
    resize_every: int = 10           # ticks between policy consults
    timeline_every: int = 10         # ticks between timeline samples
    slo_p99_s: float = 4.0
    estimator: str = "window"        # "window" | "p2"
    window: int = 512
    # -- per-replica mesh elasticity (0 = devices_per_replica) ----------
    min_devices_per_replica: int = 0
    max_devices_per_replica: int = 0
    cold_start_ticks: int = 0        # new-replica boot: no service yet
    grow_ticks: int = 0              # in-place-granted devices warming


class Replica:
    """One serving replica — a ``MalleableTenant``
    (:class:`~repro_torch.dmr.tenant.MalleableTenant`) over its grant.

    ``slots = slots_per_device x current_size`` concurrent sequences;
    devices enter and leave only through the tenant contract
    (``grant_devices`` / ``release_devices`` / ``shutdown``), and the
    fleet resizes the replica *in place* through ``apply_grow`` /
    ``apply_shrink`` at a tick (= decode-step) boundary.  In live mode
    those delegate to the replica's ``MalleableRunner`` —
    ``apply_resize`` re-shards the decode state through the pattern
    registry, so generated tokens are bit-identical across the resize
    (``self.tokens`` captures the per-tick decode output for exactly
    that assertion: device tensors, copied to the host once by
    :meth:`token_history`).  In the host service model the same contract
    moves only bookkeeping.
    """

    moldable = False

    def __init__(self, rid: int, devices: Sequence, cfg: ServeConfig,
                 runner=None, warm_left: int = 0):
        self.rid = rid
        self.jid = rid                       # the tenant-contract identity
        self.cfg = cfg
        self._devices = list(devices)        # host mode; runner owns live
        self._size = len(self._devices)
        n = self._size
        lo = min(cfg.min_devices_per_replica or n, n)
        hi = max(cfg.max_devices_per_replica or n, n)
        self.params = MalleabilityParams(lo, hi, n)
        self.malleable = hi > lo
        self.active: List[Request] = []
        self.draining = False
        self.runner = runner
        self.state = runner.init() if runner is not None else None
        #: per-tick decode output in live mode, kept on the device (the
        #: bit-identity tests compare these element-wise across in-place
        #: grow and shrink)
        self.tokens: Optional[List[torch.Tensor]] = \
            [] if runner is not None else None
        self.warm_left = warm_left           # cold-start boot countdown
        self._unwarmed = 0                   # granted, still warming up
        self._grow_left = 0
        self._tick_i = 0

    # -- the MalleableTenant contract -----------------------------------
    @property
    def devices(self) -> List:
        return self.runner.devices if self.runner is not None \
            else self._devices

    @property
    def current_size(self) -> int:
        return self.runner.current if self.runner is not None \
            else self._size

    def grant_devices(self, new_devices: Sequence) -> None:
        if self.runner is not None:
            self.runner.grant_devices(list(new_devices))
            return
        ids = {d.id for d in self._devices}
        dup = [d.id for d in new_devices if d.id in ids]
        if dup:
            raise ValueError(
                f"devices {dup} already in replica {self.rid}'s pool")
        self._devices.extend(new_devices)

    def release_devices(self) -> List:
        if self.runner is not None:
            return self.runner.release_devices()
        released = self._devices[self._size:]
        self._devices = self._devices[:self._size]
        return released

    def shutdown(self) -> List:
        if self.runner is not None:
            # a retired replica keeps its tokens, not its decode state: a
            # full-width replica's parameters are gigabytes of the card
            self.state = None
            return self.runner.shutdown()
        released, self._devices = self._devices, []
        return released

    # -- in-place mesh resize (fleet calls these at tick boundaries) ----
    def apply_grow(self, target: int) -> None:
        """Grow onto already-granted devices; live mode re-shards the
        decode state mid-generation (tokens stay bit-identical)."""
        k = target - self.current_size
        if self.runner is not None:
            self.state = self.runner.apply_resize(
                self.state, self._tick_i, Action("expand", target))
        else:
            self._size = target
        if self.cfg.grow_ticks > 0:
            self._unwarmed += k
            self._grow_left = self.cfg.grow_ticks

    def apply_shrink(self, target: int) -> None:
        """Shrink the mesh in place; the released tail is returned by a
        following ``release_devices`` call, never taken directly."""
        if self.runner is not None:
            self.state = self.runner.apply_resize(
                self.state, self._tick_i, Action("shrink", target))
        else:
            self._size = target
        self._unwarmed = 0
        self._grow_left = 0

    # -- the service model ----------------------------------------------
    @property
    def slots(self) -> int:
        return self.cfg.slots_per_device * (self.current_size
                                            - self._unwarmed)

    @property
    def free_slots(self) -> int:
        if self.draining or self.warm_left > 0:
            return 0
        return self.slots - len(self.active)

    def admit(self, req: Request, now_s: float, cfg: ServeConfig) -> None:
        req.start_s = now_s
        req.replica = self.rid
        req._prefill_left = max(1, -(-req.prompt_len
                                     // cfg.prefill_tokens_per_tick))
        req._decode_left = req.decode_len
        self.active.append(req)

    def advance(self, now_s: float, cfg: ServeConfig) -> List[Request]:
        """One tick of service; returns requests that just finished."""
        if self.warm_left > 0:               # still booting: no service
            self.warm_left -= 1
            return []
        if self._grow_left > 0:
            self._grow_left -= 1
            if self._grow_left == 0:
                self._unwarmed = 0
        if self.runner is not None:
            self.state, out = self.runner.step(self.state, self._tick_i)
            if self.tokens is not None and not isinstance(out, dict):
                # the step may hand back a tensor of its state, which later
                # steps or resizes can update in place: keep a copy
                self.tokens.append(out.clone())
        self._tick_i += 1
        done: List[Request] = []
        for req in self.active:
            if req._prefill_left > 0:
                req._prefill_left -= 1
            else:
                req._decode_left -= 1
                if req._decode_left <= 0:
                    req.finish_s = now_s + cfg.tick_s
                    done.append(req)
        if done:
            gone = set(id(r) for r in done)
            self.active = [r for r in self.active if id(r) not in gone]
        return done

    def token_history(self) -> np.ndarray:
        """Live mode: every tick's decode output, ``(ticks, batch, 1)``,
        in one device-to-host copy."""
        if not self.tokens:
            return np.zeros((0,), np.int32)
        return torch.stack(self.tokens).cpu().numpy()


@dataclasses.dataclass
class ServingResult:
    """Outcome of one :meth:`ReplicaSet.run`."""
    requests: List[Request]
    metrics: ServingMetrics
    ticks: int
    tick_s: float
    device_ticks: int
    peak_devices: int
    n_scale_ups: int
    n_scale_downs: int
    timeline: List[Tuple[int, int, int]]      # (tick, replicas, devices)
    trail: Optional[List[Tuple]]
    #: scale decisions with readiness horizon — dicts with ``kind``
    #: ("replica-add" | "grow-in-place" | "shrink-in-place"), ``tick``,
    #: ``ready_tick`` and ``devices`` (the mixed-pool benchmark compares
    #: time-to-capacity of the two scale-up paths from these)
    scale_events: Optional[List[Dict]] = None

    @property
    def makespan_s(self) -> float:
        return self.ticks * self.tick_s

    @property
    def mean_devices(self) -> float:
        return self.device_ticks / self.ticks if self.ticks else 0.0

    def summary(self) -> Dict[str, float]:
        out = self.metrics.summary(horizon_s=self.makespan_s,
                                   device_ticks=self.device_ticks,
                                   tick_s=self.tick_s)
        out.update(peak_devices=self.peak_devices,
                   mean_devices=self.mean_devices,
                   n_scale_ups=self.n_scale_ups,
                   n_scale_downs=self.n_scale_downs)
        return out


class ReplicaSet:
    """Serve a request stream on an elastic replica fleet.

    ``devices`` is the shared pool — an int builds a synthetic pool
    (host service model; the default, and what benchmarks use), a list
    of logical workers (``logical_workers(n, device)``) plus
    ``app_factory`` (a zero-arg callable returning a ``dmr.App``) runs a
    live ``MalleableRunner`` per replica.

    ``policy`` is any ``repro_torch.core.policy`` name/instance; the serving
    policies (``slo-aware``, ``queue-depth``) read this ReplicaSet as
    their ``job`` handle.  ``static_replicas=k`` disables elasticity:
    ``k`` replicas at tick 0, never resized — the provisioning baseline.

    Trail/auditing mirrors ``dmr.Cluster``: ``record_trail`` keeps the
    event stream (``.trail`` / ``dump_trail`` compatible),
    ``sanitize=True`` feeds a live :class:`TrailAuditor` that raises at
    the first accounting violation.

    ``external_pool=True`` hands fleet sizing to an outer resource
    manager (the ``repro_torch.serve.tenant.ReplicaSetRunner`` adapter embeds
    the fleet in a ``dmr.Cluster`` this way): the internal policy is
    off, the pool is whatever the manager granted, and ``trail_sink``
    forwards every trail event outward so the cluster's auditor sees
    the fleet's internal grants as delegations of its own grant.
    """

    def __init__(self, requests: Sequence[Request], devices=16, *,
                 policy="slo-aware", config: Optional[ServeConfig] = None,
                 static_replicas: Optional[int] = None,
                 app_factory: Optional[Callable] = None,
                 record_trail: bool = True, sanitize: bool = False,
                 max_ticks: int = 10_000_000, external_pool: bool = False,
                 trail_sink: Optional[Callable] = None):
        from repro_torch.dmr.cluster import synthetic_pool

        self.requests = sorted(requests, key=lambda r: (r.arrival_s, r.rid))
        if isinstance(devices, int):
            pool = synthetic_pool(devices)
        else:
            pool = list(devices)
        self._idle: List = list(pool)
        self._pool_ids = [d.id for d in pool]
        self.config = cfg = config or ServeConfig()
        self.external = external_pool
        if not external_pool and \
                cfg.devices_per_replica * cfg.max_replicas > len(pool) and \
                static_replicas is None:
            raise ValueError(
                f"pool of {len(pool)} devices cannot host max_replicas="
                f"{cfg.max_replicas} x {cfg.devices_per_replica} devices")
        self.app_factory = app_factory
        self.static = static_replicas
        if external_pool:
            self.policy = None
            self.decisions = "external"
        elif static_replicas is not None:
            if static_replicas * cfg.devices_per_replica > len(pool):
                raise ValueError(
                    f"static_replicas={static_replicas} needs "
                    f"{static_replicas * cfg.devices_per_replica} devices, "
                    f"pool has {len(pool)}")
            self.policy = None
            self.decisions = "static"
        else:
            self.policy = get_policy(policy)
            self.policy.configure(cfg)
            self.decisions = self.policy.name
        dpr = cfg.devices_per_replica
        self.params = MalleabilityParams(
            dpr * cfg.min_replicas, dpr * cfg.max_replicas,
            dpr * max(cfg.min_replicas, min(cfg.initial_replicas,
                                            cfg.max_replicas)))
        self.slo = SLOTracker(cfg.slo_p99_s, estimator=cfg.estimator,
                              window=cfg.window)
        self.metrics = ServingMetrics(cfg.slo_p99_s)
        self.queue = RequestQueue()
        self.balancer = LeastLoadedBalancer()
        self._replicas: List[Replica] = []
        self._all_replicas: Dict[int, Replica] = {}   # incl. retired
        self._next_rid = 0
        self._tick = 0
        self._now = 0.0
        self._arr_i = 0
        self.max_ticks = max_ticks
        self.n_scale_ups = 0
        self.n_scale_downs = 0
        self.peak_devices = 0
        self.device_ticks = 0
        self.timeline: List[Tuple[int, int, int]] = []
        self.scale_events: List[Dict] = []
        self.trail: Optional[List[Tuple]] = \
            [] if (record_trail or sanitize) else None
        self._trail_sink = trail_sink
        self._auditor = None
        if sanitize:
            from repro_torch.analysis.trail import TrailAuditor
            self._auditor = TrailAuditor(self._pool_ids, jobs={},
                                         check_spacing=False, live=True)

    # -- serving surface read by the latency policies (the job handle) --
    @property
    def queue_len(self) -> int:
        return len(self.queue)

    @property
    def head_wait_s(self) -> float:
        return self.queue.head_wait_s(self._now)

    @property
    def in_flight(self) -> int:
        return sum(len(r.active) for r in self._replicas)

    @property
    def utilization(self) -> float:
        slots = sum(r.slots for r in self._replicas if not r.draining)
        if slots == 0:
            return 1.0
        busy = sum(len(r.active) for r in self._replicas if not r.draining)
        return busy / slots

    @property
    def resize_quantum(self) -> int:
        return self.config.devices_per_replica

    @property
    def slots_per_replica(self) -> int:
        return self.config.slots_per_device * self.config.devices_per_replica

    # -- dump_trail / job_metadata compatibility ------------------------
    @property
    def tenants(self) -> List[Replica]:
        return list(self._all_replicas.values())

    # -- internals ------------------------------------------------------
    def _trail_event(self, kind: str, jid: int, payload) -> None:
        if self.trail is not None:
            self.trail.append((kind, jid, payload, self._tick))
        if self._auditor is not None:
            self._auditor.feed((kind, jid, payload, self._tick))
        if self._trail_sink is not None:
            self._trail_sink(kind, jid, payload)

    def _live(self) -> List[Replica]:
        return [r for r in self._replicas if not r.draining]

    def _replica_up(self) -> Optional[Replica]:
        cfg = self.config
        dpr = cfg.devices_per_replica
        if len(self._idle) < dpr:
            return None
        devs = [self._idle.pop() for _ in range(dpr)]
        rid = self._next_rid
        self._next_rid += 1
        runner = None
        if self.app_factory is not None:
            from repro_torch import dmr
            n = len(devs)
            lo = min(cfg.min_devices_per_replica or n, n)
            hi = max(cfg.max_devices_per_replica or n, n)
            runner = dmr.MalleableRunner(
                self.app_factory(), MalleabilityParams(lo, hi, n), rms={},
                devices=devs, allow_partial=True)
        rep = Replica(rid, devs, cfg, runner=runner,
                      warm_left=cfg.cold_start_ticks)
        self._all_replicas[rid] = rep
        if self._auditor is not None:
            from repro_torch.analysis.trail import JobMeta
            self._auditor.jobs[rid] = JobMeta(
                malleable=rep.malleable, moldable=False,
                min_procs=rep.params.min_procs,
                max_procs=rep.params.max_procs)
        self._replicas.append(rep)
        self._trail_event("replica-up", rid, tuple(d.id for d in devs))
        return rep

    def _replica_down(self, rep: Replica) -> None:
        self._trail_event("replica-down", rep.rid,
                          tuple(d.id for d in rep.devices))
        self._idle.extend(rep.shutdown())
        self._replicas.remove(rep)

    def _drop(self, req: Request) -> None:
        req.dropped = True
        self.metrics.drop(req)
        self._trail_event(
            "request-drop", -1,
            (req.rid, round(req.wait_s(self._now), 6), req.deadline_s))

    # -- scale paths (in-place mesh resize vs whole-replica churn) ------
    def _add_replicas(self, n_new: int) -> int:
        """Cold-start up to ``n_new`` replicas (the classic scale-up
        path: ``cold_start_ticks`` of no service before the new replica
        takes traffic).  Returns how many actually came up."""
        cfg = self.config
        added = 0
        for _ in range(n_new):
            if len(self._live()) >= cfg.max_replicas:
                break
            rep = self._replica_up()
            if rep is None:
                break
            self.n_scale_ups += 1
            self.scale_events.append(dict(
                kind="replica-add", tick=self._tick,
                ready_tick=self._tick + cfg.cold_start_ticks,
                devices=len(rep.devices)))
            added += 1
        return added

    def absorb_idle(self) -> int:
        """Spawn replicas from the idle pool until it drops below one
        quantum or the fleet is full — the composite adapter's start /
        expand path (start absorbs are not counted as scale-ups).
        Returns replicas started."""
        n = 0
        while len(self._live()) < self.config.max_replicas:
            if self._replica_up() is None:
                break
            n += 1
        return n

    def _grow_in_place(self, rep: Replica, target: int) -> None:
        """Grant idle devices to a live replica and grow its mesh in
        place — grant first, then resize, mirroring the runner's
        ordering so the auditor's held-set checks hold throughout."""
        need = target - rep.current_size
        devs = [self._idle.pop() for _ in range(need)]
        rep.grant_devices(devs)
        self._trail_event("grant", rep.rid, tuple(d.id for d in devs))
        frm = rep.current_size
        rep.apply_grow(target)
        self._trail_event("replica-resize", rep.rid,
                          (rep._tick_i, "expand", frm, target,
                           len(rep.active), self.config.slots_per_device))
        self.scale_events.append(dict(
            kind="grow-in-place", tick=self._tick,
            ready_tick=self._tick + self.config.grow_ticks,
            devices=need))
        self.n_scale_ups += 1

    def _shrink_in_place(self, rep: Replica, target: int) -> None:
        """Shrink a live replica's mesh and reclaim the shed tail —
        resize first, then release: the released devices are exactly
        the runner's ``devices[target:]`` excess."""
        frm = rep.current_size
        rep.apply_shrink(target)
        self._trail_event("replica-resize", rep.rid,
                          (rep._tick_i, "shrink", frm, target,
                           len(rep.active), self.config.slots_per_device))
        released = rep.release_devices()
        self._idle.extend(released)
        self._trail_event("release", rep.rid,
                          tuple(d.id for d in released))
        self.scale_events.append(dict(
            kind="shrink-in-place", tick=self._tick,
            ready_tick=self._tick, devices=len(released)))
        self.n_scale_downs += 1

    def _grow_live_replicas(self, need: int) -> int:
        """In-place mesh grows before any cold start: most-loaded
        replica first (it sheds queueing pressure soonest), stepping to
        the next legal mesh size while idle devices and ``need`` allow.
        Returns total devices added."""
        added = 0
        for rep in sorted(self._live(),
                          key=lambda r: (-len(r.active), r.rid)):
            while added < need:
                cur = rep.current_size
                cand = [s for s in rep.params.legal_sizes() if s > cur]
                if not cand:
                    break
                step = min(cand) - cur
                if step > need - added or step > len(self._idle):
                    break
                self._grow_in_place(rep, min(cand))
                added += step
        return added

    def _shrink_live_replicas(self, excess: int) -> int:
        """In-place mesh shrinks before any drain-and-kill: shed
        devices from lightly loaded replicas wherever the active batch
        still fits the smaller mesh.  Returns total devices shed."""
        spd = self.config.slots_per_device
        shed = 0
        for rep in sorted(self._live(),
                          key=lambda r: (len(r.active), -r.rid)):
            if shed >= excess:
                break
            cur = rep.current_size
            cand = [s for s in rep.params.legal_sizes()
                    if s < cur and len(rep.active) <= s * spd
                    and cur - s <= excess - shed]
            if not cand:
                continue
            target = min(cand)
            self._shrink_in_place(rep, target)
            shed += cur - target
        return shed

    def _consult(self) -> None:
        current = sum(len(r.devices) for r in self._live())
        view = ClusterView(available=len(self._idle),
                           pending_min_sizes=[], reclaimable_others=0)
        act = self.policy.decide(current, self.params, view, job=self)
        cfg = self.config
        dpr = cfg.devices_per_replica
        if act.kind == "expand" and act.target > current:
            need = min(act.target, self.params.max_procs) - current
            # the policy chooses the path: in-place mesh growth serves
            # from already-warm replicas grow_ticks later, a cold start
            # pays cold_start_ticks before taking any traffic
            path = getattr(self.policy, "choose_scale_path",
                           lambda job: "replica")(self)
            if path == "in-place":
                need -= self._grow_live_replicas(need)
            self._add_replicas(need // dpr)
        elif act.kind == "shrink" and act.target < current:
            excess = current - max(act.target, self.params.min_procs)
            excess -= self._shrink_live_replicas(excess)
            # drain whole replicas for the remainder: emptiest-first,
            # newest on ties — oldest replicas keep the load (matches
            # the balancer's low-rid tie-break)
            victims = sorted(self._live(),
                             key=lambda r: (len(r.active), -r.rid))
            for rep in victims:
                if excess < rep.current_size:
                    continue
                if len(self._live()) <= cfg.min_replicas:
                    break
                rep.draining = True
                excess -= rep.current_size
                self.n_scale_downs += 1

    # -- the engine (run() composes these; the ReplicaSetRunner adapter
    #    drives them one cluster-tick at a time) ------------------------
    def start_fleet(self) -> None:
        cfg = self.config
        if self.external:
            if self.absorb_idle() == 0:
                raise RuntimeError(
                    "start grant below one replica quantum")
            return
        n_start = self.static if self.static is not None \
            else max(cfg.min_replicas, min(cfg.initial_replicas,
                                           cfg.max_replicas))
        for _ in range(n_start):
            if self._replica_up() is None:
                raise RuntimeError("pool too small for the starting fleet")

    def tick_once(self) -> None:
        """One full fleet tick: arrivals, expiry, admission, service,
        teardown of drained replicas, then (internal policy only) a
        scaling consult.  Does *not* advance ``self._tick``."""
        cfg = self.config
        self._now = now = self._tick * cfg.tick_s
        reqs = self.requests
        while self._arr_i < len(reqs) and \
                reqs[self._arr_i].arrival_s <= now:
            self.queue.push(reqs[self._arr_i])
            self._arr_i += 1
        for req in self.queue.expire(now):
            self._drop(req)
        while len(self.queue):
            rep = self.balancer.pick(self._replicas)
            if rep is None:
                break
            rep.admit(self.queue.pop(), now, cfg)
        held = sum(len(r.devices) for r in self._replicas)
        self.device_ticks += held
        self.peak_devices = max(self.peak_devices, held)
        if self._tick % cfg.timeline_every == 0:
            self.timeline.append((self._tick, len(self._replicas), held))
        for rep in list(self._replicas):
            for req in rep.advance(now, cfg):
                self.slo.observe(req.latency_s())
                self.metrics.complete(req)
        for rep in [r for r in self._replicas
                    if r.draining and not r.active]:
            self._replica_down(rep)
        if self._auditor is not None:
            self._auditor.check_conservation(len(self._idle), self._tick)
        if self.policy is not None and self._tick % cfg.resize_every == 0:
            self._consult()

    @property
    def finished(self) -> bool:
        return (self._arr_i >= len(self.requests) and not len(self.queue)
                and not any(r.active for r in self._replicas))

    def finish_fleet(self) -> None:
        for rep in list(self._replicas):
            self._replica_down(rep)
        if self._auditor is not None:
            self._auditor.check_conservation(len(self._idle), self._tick)

    def build_result(self) -> ServingResult:
        return ServingResult(
            requests=list(self.requests), metrics=self.metrics,
            ticks=self._tick + 1, tick_s=self.config.tick_s,
            device_ticks=self.device_ticks, peak_devices=self.peak_devices,
            n_scale_ups=self.n_scale_ups, n_scale_downs=self.n_scale_downs,
            timeline=self.timeline, trail=self.trail,
            scale_events=list(self.scale_events))

    def run(self) -> ServingResult:
        self.start_fleet()
        while True:
            self.tick_once()
            if self.finished:
                break
            self._tick += 1
            if self._tick > self.max_ticks:
                raise RuntimeError(
                    f"serving run exceeded max_ticks={self.max_ticks}")
        self.finish_fleet()
        return self.build_result()
