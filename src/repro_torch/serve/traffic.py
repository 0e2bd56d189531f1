"""Request streams, the deadline queue, and the replica load balancer
(port of ``repro/serve/traffic.py``).

The serving workload layer reuses ``rms/workload.py``'s scenario library
with the units reinterpreted: a *scenario* shapes the arrival process
(steady / bursty / bimodal / diurnal / ``trace:``), but each arrival is
now an inference **request** — a prompt to prefill plus a number of
decode steps — not a batch job.  ``make_request_stream`` owns that
reinterpretation so benchmarks, tests and the CLI all draw from the same
distributions:

* arrivals — per-scenario generators (``diurnal_arrivals`` et al.),
  rescaled onto the caller's ``horizon_s`` so every scenario presents
  the same mean offered load and differs only in *shape*;
* ``prompt_len`` — lognormal around ``mean_prompt`` (chat-style skew);
* ``decode_len`` — geometric with mean ``mean_decode`` (most replies
  short, a heavy tail of long generations); the ``bimodal`` scenario
  additionally gives 30% of requests an 8× decode budget;
* ``deadline_s`` — per-request patience; the queue drops a request that
  waits past it (the user has navigated away — completing it would burn
  decode slots for zero goodput).

:class:`RequestQueue` is the FIFO those requests wait in, with deadline
expiry; :class:`LeastLoadedBalancer` fans admitted requests over live
replicas by free decode slots.  Both are engine-agnostic: the
:class:`~repro_torch.serve.replica.ReplicaSet` drives them tick by tick.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, List, Optional, Sequence

import numpy as np

from repro_torch.rms.workload import (SCENARIOS, UnknownScenarioError,
                                      bursty_arrivals, diurnal_arrivals,
                                      make_scenario)


@dataclasses.dataclass
class Request:
    """One inference request through its lifecycle.

    Filled in by the stream generator: ``rid``, ``arrival_s``,
    ``prompt_len`` (tokens to prefill), ``decode_len`` (tokens to
    generate), ``deadline_s`` (max queue wait before the client gives
    up).  Filled in by the engine: ``start_s`` / ``finish_s`` wall-clock
    marks, ``replica`` id, and the ``dropped`` flag.
    """

    rid: int
    arrival_s: float
    prompt_len: int
    decode_len: int
    deadline_s: float
    start_s: float = -1.0
    finish_s: float = -1.0
    replica: int = -1
    dropped: bool = False

    def latency_s(self) -> float:
        """Arrival-to-last-token latency (nan while unfinished)."""
        if self.finish_s < 0:
            return float("nan")
        return self.finish_s - self.arrival_s

    def wait_s(self, now_s: float) -> float:
        return now_s - self.arrival_s


#: scenario names make_request_stream accepts beyond the generic registry
_SERVING_SCENARIOS = ("steady", "bursty", "bimodal", "diurnal")


def _arrival_times(scenario: str, n: int, rng: np.random.Generator,
                   horizon_s: float) -> np.ndarray:
    """Arrival offsets for ``n`` requests, rescaled to ``[0, horizon_s)``
    so every scenario offers the same mean rate and differs in shape."""
    if scenario == "steady":
        t = np.cumsum(rng.exponential(1.0, size=n))
    elif scenario == "bursty":
        # bursts of 25 with quiet gaps, as in the batch scenario, then
        # rescaled: the spikes survive, the absolute seconds don't
        t = bursty_arrivals(n, rng, burst_size=25, intra_gap_s=1.0,
                            inter_burst_gap_s=60.0)
    elif scenario == "bimodal":
        t = np.cumsum(rng.exponential(1.0, size=n))
    elif scenario == "diurnal":
        # one full day-cycle mapped onto the horizon
        t = diurnal_arrivals(n, rng, period_s=n * 18.0, mean_gap_s=18.0)
    elif scenario.startswith("trace:"):
        jobs, _ = make_scenario(scenario, n, seed=int(rng.integers(2**31)))
        t = np.sort(np.array([j.submit_time for j in jobs], dtype=float))
        n_have = len(t)
        if n_have < n:          # trace shorter than requested: tile it
            span = t[-1] - t[0] + 1.0 if n_have else 1.0
            reps = -(-n // max(n_have, 1))
            t = np.concatenate([t + k * span for k in range(reps)])[:n]
    elif scenario in SCENARIOS:
        jobs, _ = SCENARIOS[scenario](n, "moldable", True,
                                      int(rng.integers(2**31)))
        t = np.sort(np.array([j.submit_time for j in jobs], dtype=float))
    else:
        names = "\n".join(f"  - {s}" for s in
                          sorted(set(_SERVING_SCENARIOS) | set(SCENARIOS)))
        raise UnknownScenarioError(
            f"unknown request-stream scenario {scenario!r}; known:\n{names}\n"
            "or 'trace:<path.swf>' / 'trace:synthetic'") from None
    t = t - t[0]
    span = t[-1]
    if span <= 0:
        return np.linspace(0.0, horizon_s, n, endpoint=False)
    return t * (horizon_s / span) * (1.0 - 1e-9)


def make_request_stream(scenario: str = "diurnal", n_requests: int = 1000, *,
                        horizon_s: float = 600.0, mean_prompt: int = 96,
                        mean_decode: int = 48, max_decode_factor: float = 3.0,
                        deadline_s: float = 8.0,
                        seed: int = 0) -> List[Request]:
    """Generate ``n_requests`` inference requests over ``horizon_s``
    seconds with ``scenario``-shaped arrivals (sorted by arrival time).

    ``max_decode_factor`` is the ``max_tokens``-style generation cap
    (``max_decode_factor × mean_decode``): without it the geometric tail
    alone would put p99 service time past any reasonable SLO, making the
    SLO unachievable at *every* capacity and the autoscaling signal
    meaningless.
    """
    if n_requests < 1:
        raise ValueError("n_requests must be >= 1")
    rng = np.random.default_rng(seed)
    arrivals = _arrival_times(scenario, n_requests, rng, horizon_s)
    # lognormal prompts: median ~= mean_prompt, long right tail
    prompts = np.maximum(
        1, rng.lognormal(np.log(mean_prompt), 0.5, n_requests)).astype(int)
    cap = max(1, int(max_decode_factor * mean_decode))
    decodes = np.clip(
        rng.geometric(1.0 / mean_decode, n_requests), 1, cap).astype(int)
    if scenario == "bimodal":
        long_mask = rng.random(n_requests) < 0.3
        decodes = np.where(long_mask, np.minimum(decodes * 8, cap * 8),
                           decodes)
    reqs = [Request(rid=i, arrival_s=float(arrivals[i]),
                    prompt_len=int(prompts[i]), decode_len=int(decodes[i]),
                    deadline_s=float(deadline_s))
            for i in range(n_requests)]
    reqs.sort(key=lambda r: (r.arrival_s, r.rid))
    for i, r in enumerate(reqs):        # keep rids = arrival order
        r.rid = i
    return reqs


class RequestQueue:
    """FIFO of waiting requests with deadline expiry.

    ``push`` admits an arrival, ``pop`` hands the head to a replica, and
    ``expire(now)`` removes (and returns) every request whose queue wait
    has exceeded its deadline — the caller marks those dropped and emits
    the ``request-drop`` trail event.
    """

    def __init__(self) -> None:
        self._q: Deque[Request] = collections.deque()

    def __len__(self) -> int:
        return len(self._q)

    def push(self, req: Request) -> None:
        self._q.append(req)

    def pop(self) -> Optional[Request]:
        return self._q.popleft() if self._q else None

    def head_wait_s(self, now_s: float) -> float:
        """Queue wait of the oldest request (0 when empty)."""
        return self._q[0].wait_s(now_s) if self._q else 0.0

    def expire(self, now_s: float) -> List[Request]:
        expired = [r for r in self._q
                   if r.deadline_s > 0 and r.wait_s(now_s) >= r.deadline_s]
        if expired:
            gone = set(id(r) for r in expired)
            self._q = collections.deque(
                r for r in self._q if id(r) not in gone)
        return expired


class LeastLoadedBalancer:
    """Fan requests over live replicas: pick the accepting replica with
    the most free decode slots (ties to the lowest replica id — stable,
    and biases load onto older replicas so the newest drains first on a
    scale-down)."""

    def pick(self, replicas: Sequence) -> Optional[object]:
        best = None
        for rep in replicas:
            free = rep.free_slots
            if free <= 0:
                continue
            if best is None or (free, -rep.rid) > (best.free_slots,
                                                   -best.rid):
                best = rep
        return best
