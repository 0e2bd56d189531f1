"""Latency SLOs: streaming percentile estimators + the first
latency-objective resize policies (port of ``repro/serve/slo.py``).

Serving inverts the repo's objective: batch policies (algorithm2, energy,
throughput) optimize makespan/jobs-per-second, while a replica fleet must
hold a *tail-latency* target under time-varying load.  Two estimator
flavors feed the policies:

* :class:`P2Estimator` — the P² algorithm (Jain & Chlamtac, CACM 1985):
  a single quantile tracked in O(1) memory with five markers, no sample
  buffer.  The right choice at production request rates.
* :class:`WindowedPercentile` — exact ``np.percentile`` over a sliding
  window of the last N latencies.  Exact but O(window) memory; the
  default because serving decisions key off the *recent* tail, and it
  forgets old regimes when load shifts (P² never forgets).

:class:`SLOTracker` bundles estimators for p50/p95/p99 behind one
``observe``/``quantile`` surface, and two policies consume it:

* ``slo-aware`` (:class:`SLOAwarePolicy`) — grow one replica-quantum when
  the p99 estimate breaches the SLO (or the queue head has already burned
  half its budget waiting), shrink one quantum only after a patience
  window of consecutive healthy looks.  Asymmetric on purpose: growing
  late costs goodput, shrinking late costs only money.
* ``queue-depth`` (:class:`QueueDepthPolicy`) — an estimator-free
  baseline keyed on backlog per replica; grows on deep queues, shrinks
  when the in-flight + queued work fits in fewer replicas.

Both are registered in ``repro_torch.core.policy.POLICIES`` on import, so
``get_policy("slo-aware")`` works anywhere once ``repro_torch.serve`` is
imported.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np

from repro_torch.core.params import MalleabilityParams
from repro_torch.core.policy import (POLICIES, Action, BasePolicy,
                                     ClusterView)


class P2Estimator:
    """Streaming estimate of one quantile ``q`` via the P² algorithm.

    Five markers track (min, q/2-ish, q, (1+q)/2-ish, max); marker
    heights are adjusted with a piecewise-parabolic fit as observations
    arrive.  Before five samples the estimate falls back to the exact
    percentile of what has been seen (``nan`` when empty).
    """

    def __init__(self, q: float):
        if not 0.0 < q < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {q}")
        self.q = q
        self._heights: list = []        # first 5 samples, then marker heights
        self._pos = [1.0, 2.0, 3.0, 4.0, 5.0]
        self._want = [1.0, 1.0 + 2.0 * q, 1.0 + 4.0 * q, 3.0 + 2.0 * q, 5.0]
        self._dwant = [0.0, q / 2.0, q, (1.0 + q) / 2.0, 1.0]
        self.n = 0

    def observe(self, x: float) -> None:
        self.n += 1
        h = self._heights
        if self.n <= 5:
            h.append(float(x))
            if self.n == 5:
                h.sort()
            return
        # locate the cell, clamping extremes onto the outer markers
        if x < h[0]:
            h[0] = float(x)
            k = 0
        elif x >= h[4]:
            h[4] = float(x)
            k = 3
        else:
            k = 0
            while k < 3 and not x < h[k + 1]:
                k += 1
        for i in range(k + 1, 5):
            self._pos[i] += 1.0
        for i in range(5):
            self._want[i] += self._dwant[i]
        # nudge the three interior markers toward their desired positions
        for i in (1, 2, 3):
            d = self._want[i] - self._pos[i]
            if (d >= 1.0 and self._pos[i + 1] - self._pos[i] > 1.0) or \
               (d <= -1.0 and self._pos[i - 1] - self._pos[i] < -1.0):
                d = 1.0 if d > 0 else -1.0
                cand = self._parabolic(i, d)
                if not h[i - 1] < cand < h[i + 1]:
                    cand = self._linear(i, d)
                h[i] = cand
                self._pos[i] += d

    def _parabolic(self, i: int, d: float) -> float:
        h, n = self._heights, self._pos
        return h[i] + d / (n[i + 1] - n[i - 1]) * (
            (n[i] - n[i - 1] + d) * (h[i + 1] - h[i]) / (n[i + 1] - n[i])
            + (n[i + 1] - n[i] - d) * (h[i] - h[i - 1]) / (n[i] - n[i - 1]))

    def _linear(self, i: int, d: float) -> float:
        h, n = self._heights, self._pos
        j = i + int(d)
        return h[i] + d * (h[j] - h[i]) / (n[j] - n[i])

    def quantile(self) -> float:
        if self.n == 0:
            return math.nan
        if self.n < 5:
            return float(np.percentile(self._heights, self.q * 100.0))
        return self._heights[2]


class WindowedPercentile:
    """Exact percentiles over a sliding window of the last ``window``
    observations (ring buffer + ``np.percentile``)."""

    def __init__(self, window: int = 512):
        if window < 1:
            raise ValueError("window must be >= 1")
        self.window = window
        self._buf = np.empty(window)
        self._next = 0
        self.n = 0

    def observe(self, x: float) -> None:
        self._buf[self._next] = x
        self._next = (self._next + 1) % self.window
        self.n += 1

    def quantile(self, q: float) -> float:
        if self.n == 0:
            return math.nan
        filled = self._buf[:min(self.n, self.window)]
        return float(np.percentile(filled, q * 100.0))


class SLOTracker:
    """Latency bookkeeping for one replica fleet: a p99 SLO target plus
    streaming estimates at the standard quantiles.

    ``estimator="window"`` keeps one exact sliding window shared by all
    quantiles; ``estimator="p2"`` keeps one O(1) P² marker set per
    quantile.  ``quantile(q)`` answers for any tracked q either way.
    """

    QUANTILES = (0.50, 0.95, 0.99)

    def __init__(self, slo_p99_s: float, *, estimator: str = "window",
                 window: int = 512,
                 quantiles: Sequence[float] = QUANTILES):
        if estimator not in ("window", "p2"):
            raise ValueError(
                f"estimator must be 'window' or 'p2', got {estimator!r}")
        self.slo_p99_s = float(slo_p99_s)
        self.estimator = estimator
        self.quantiles = tuple(quantiles)
        self.n = 0
        if estimator == "window":
            self._win = WindowedPercentile(window)
            self._p2: Dict[float, P2Estimator] = {}
        else:
            self._win = None
            self._p2 = {q: P2Estimator(q) for q in self.quantiles}

    def observe(self, latency_s: float) -> None:
        self.n += 1
        if self._win is not None:
            self._win.observe(latency_s)
        else:
            for est in self._p2.values():
                est.observe(latency_s)

    def quantile(self, q: float) -> float:
        if self._win is not None:
            return self._win.quantile(q)
        if q not in self._p2:                 # lazily track a new quantile
            raise KeyError(f"quantile {q} not tracked; have "
                           f"{sorted(self._p2)}")
        return self._p2[q].quantile()

    def breach(self) -> bool:
        """True when the current p99 estimate exceeds the SLO."""
        p99 = self.quantile(0.99)
        return not math.isnan(p99) and p99 > self.slo_p99_s


class SLOAwarePolicy(BasePolicy):
    """Grow on p99-SLO breach, shrink on sustained headroom.

    Reads the serving surface off the ``job`` handle (duck-typed — the
    :class:`~repro_torch.serve.replica.ReplicaSet` passes itself): ``slo``
    (an :class:`SLOTracker`), ``utilization`` (busy slots / total),
    ``queue_len`` and ``head_wait_s`` (waiting-queue state), and
    ``resize_quantum`` (devices per replica — resizes move in whole
    replicas).  Without a serving surface it holds steady.

    Grow triggers (any, once ``min_samples`` latencies are in):

    * p99 estimate > SLO, or
    * the queue head has already waited ``wait_fraction`` of the SLO
      (latency estimates lag a load swell; head-of-line wait leads it).

    Cold start (fewer than ``min_samples`` observations): grow whenever
    requests are queued — no evidence of health yet, and queued work is
    direct evidence of shortage.

    Shrink only after ``shrink_patience`` *consecutive* healthy looks
    (empty queue, utilization ≤ ``util_low``, p99 ≤ ``headroom`` × SLO):
    one late grow costs goodput, one late shrink costs only device-hours,
    so the hysteresis is deliberately one-sided.  ``headroom`` defaults
    to 1.0 — service time alone sets a latency floor no capacity can
    lower, so "p99 comfortably under the SLO" would never hold; low
    utilization is the real spare-capacity signal.
    """

    name = "slo-aware"
    backfill = True
    dynamic_priority = False
    decide_stateless = False      # holds the shrink-patience counter

    def __init__(self, *, min_samples: int = 20, wait_fraction: float = 0.5,
                 headroom: float = 1.0, util_low: float = 0.5,
                 shrink_patience: int = 5):
        self.min_samples = min_samples
        self.wait_fraction = wait_fraction
        self.headroom = headroom
        self.util_low = util_low
        self.shrink_patience = shrink_patience
        self._calm = 0

    def configure(self, cfg) -> None:
        self.min_samples = getattr(cfg, "slo_min_samples", self.min_samples)
        self.shrink_patience = getattr(cfg, "shrink_patience",
                                       self.shrink_patience)

    def decide(self, current: int, params: MalleabilityParams,
               cluster: ClusterView, job=None) -> Action:
        tracker = getattr(job, "slo", None)
        if tracker is None:
            return Action.none(current)
        quantum = max(1, int(getattr(job, "resize_quantum", 1)))
        queue_len = getattr(job, "queue_len", 0)
        head_wait = getattr(job, "head_wait_s", 0.0)
        util = getattr(job, "utilization", 1.0)

        warm = tracker.n >= self.min_samples
        slo = tracker.slo_p99_s
        p99 = tracker.quantile(0.99) if warm else math.nan
        pressure = (warm and p99 > slo) \
            or head_wait >= self.wait_fraction * slo \
            or (not warm and queue_len > 0)
        if pressure:
            self._calm = 0
            target = min(params.max_procs, current + quantum)
            if target > current:
                # no pool-availability guard here: the caller owns pool
                # arbitration (a standalone fleet simply fails to start
                # a replica; an embedded fleet's blocked expand must
                # surface so the cluster can publish its demand and
                # shrink co-tenants toward it)
                return Action("expand", target)
            return Action.none(current)

        healthy = queue_len == 0 and util <= self.util_low and \
            (not warm or p99 <= self.headroom * slo)
        if healthy:
            self._calm += 1
            if self._calm >= self.shrink_patience:
                target = max(params.min_procs, current - quantum)
                if target < current:
                    self._calm = 0
                    return Action("shrink", target)
        else:
            self._calm = 0
        return Action.none(current)

    def choose_scale_path(self, job) -> str:
        """Latency pressure means capacity is needed *now*: prefer
        growing a live replica's warm mesh in place (``grow_ticks`` to
        readiness) over a replica cold start (``cold_start_ticks``).
        A cold-queue grow (no latency evidence yet) builds out the
        baseline fleet with whole replicas instead."""
        tracker = getattr(job, "slo", None)
        if tracker is None:
            return "replica"
        warm = tracker.n >= self.min_samples
        slo = tracker.slo_p99_s
        p99 = tracker.quantile(0.99) if warm else math.nan
        if (warm and p99 > slo) or \
                getattr(job, "head_wait_s", 0.0) >= self.wait_fraction * slo:
            return "in-place"
        return "replica"


class QueueDepthPolicy(BasePolicy):
    """Estimator-free latency baseline: resize on backlog per replica.

    Grows one replica-quantum when the waiting queue exceeds
    ``grow_depth`` requests per live replica; shrinks one quantum when
    the *total* outstanding work (in-flight + queued) would fit in one
    replica fewer at ``shrink_fill`` occupancy.  No latency estimate, no
    internal state — the control signal every autoscaler starts from,
    and the bar the SLO-aware policy has to beat.
    """

    name = "queue-depth"
    backfill = True
    dynamic_priority = False
    decide_stateless = True

    def __init__(self, *, grow_depth: float = 4.0, shrink_fill: float = 0.6):
        self.grow_depth = grow_depth
        self.shrink_fill = shrink_fill

    def decide(self, current: int, params: MalleabilityParams,
               cluster: ClusterView, job=None) -> Action:
        quantum = max(1, int(getattr(job, "resize_quantum", 1)))
        queue_len = getattr(job, "queue_len", None)
        if queue_len is None:
            return Action.none(current)
        n_replicas = max(1, current // quantum)
        slots_per_replica = getattr(job, "slots_per_replica", 1)
        if queue_len > self.grow_depth * n_replicas:
            target = min(params.max_procs, current + quantum)
            if target > current:
                # pool arbitration is the caller's job (see SLOAware)
                return Action("expand", target)
            return Action.none(current)
        outstanding = queue_len + getattr(job, "in_flight", 0)
        if n_replicas > 1:
            fit = (n_replicas - 1) * slots_per_replica * self.shrink_fill
            if outstanding <= fit:
                target = max(params.min_procs, current - quantum)
                if target < current:
                    return Action("shrink", target)
        return Action.none(current)

    def choose_scale_path(self, job) -> str:
        """Backlog deeper than one replica's slot count means waiting
        out a cold start loses goodput: grow a warm mesh in place."""
        spr = max(1, int(getattr(job, "slots_per_replica", 1)))
        return "in-place" if getattr(job, "queue_len", 0) > spr \
            else "replica"


POLICIES.setdefault(SLOAwarePolicy.name, SLOAwarePolicy)
POLICIES.setdefault(QueueDepthPolicy.name, QueueDepthPolicy)
