"""Serving-domain metrics: goodput under SLO, tail-latency CDFs, and
cost per million requests (port of ``repro/serve/metrics.py``).

Every earlier metric family in the repo is a throughput metric
(jobs/s, makespan, allocation rate, joules).  Serving answers a
different question — *of the requests users sent, how many came back
fast enough, and what did each one cost?* — so the definitions live
here, in one place, shared by ``benchmarks/serving.py``, the tests and
``docs/serving.md``:

* **goodput** — completed requests whose arrival→last-token latency is
  within the p99 SLO target, per second of wall clock.  Dropped and
  SLO-violating completions both count zero: work the user no longer
  wanted is not throughput.
* **SLO attainment** — in-SLO completions over *all* requests (drops
  included), the fraction of users who got a timely answer.
* **latency CDF** — percentiles of completed-request latency (p50 /
  p95 / p99 headlined; ``cdf()`` gives the full curve for plotting).
* **cost / Mreq** — device-hours priced at a nominal rate, divided by
  in-SLO completions, scaled to one million requests.  The axis that
  makes over-provisioning visible: a static fleet at peak capacity wins
  every latency metric and loses here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

#: nominal accelerator price used for the cost axis ($ / device-hour).
#: Absolute dollars are arbitrary; ratios between policies are the signal.
PRICE_PER_DEVICE_HOUR = 4.0

#: percentile grid recorded by ``cdf()`` (fractions, not percents)
CDF_GRID = (0.05, 0.10, 0.25, 0.50, 0.75, 0.90, 0.95, 0.99, 0.999)


class ServingMetrics:
    """Accumulates per-request outcomes and derives the serving metrics.

    Feed it ``complete(request)`` / ``drop(request)`` as the engine
    resolves each request, then read ``summary(...)`` at the end.
    """

    def __init__(self, slo_p99_s: float):
        self.slo_p99_s = float(slo_p99_s)
        self.latencies: List[float] = []      # completed requests only
        self.n_in_slo = 0
        self.n_completed = 0
        self.n_dropped = 0

    def complete(self, req) -> None:
        lat = req.latency_s()
        if math.isnan(lat):
            raise ValueError(f"request {req.rid} has no finish time")
        self.latencies.append(lat)
        self.n_completed += 1
        if lat <= self.slo_p99_s:
            self.n_in_slo += 1

    def drop(self, req) -> None:
        self.n_dropped += 1

    @property
    def n_total(self) -> int:
        return self.n_completed + self.n_dropped

    def percentile(self, p: float) -> float:
        """Latency percentile over completed requests (p in [0, 100])."""
        if not self.latencies:
            return math.nan
        return float(np.percentile(self.latencies, p))

    def cdf(self, grid: Sequence[float] = CDF_GRID) -> List[Tuple[float,
                                                                  float]]:
        """(quantile, latency_s) pairs over completed requests."""
        if not self.latencies:
            return []
        arr = np.array(self.latencies)
        return [(q, float(np.percentile(arr, q * 100.0))) for q in grid]

    def goodput_rps(self, horizon_s: float) -> float:
        """In-SLO completions per second of wall clock."""
        return self.n_in_slo / horizon_s if horizon_s > 0 else math.nan

    def slo_attainment(self) -> float:
        """Fraction of ALL requests (drops included) answered in SLO."""
        return self.n_in_slo / self.n_total if self.n_total else math.nan

    def drop_rate(self) -> float:
        return self.n_dropped / self.n_total if self.n_total else math.nan

    @staticmethod
    def device_hours(device_ticks: int, tick_s: float) -> float:
        """Occupied device-time: one device held for one tick counts one
        ``tick_s``-second slice, idle pool devices count nothing."""
        return device_ticks * tick_s / 3600.0

    def cost_per_mreq(self, device_ticks: int, tick_s: float,
                      price: float = PRICE_PER_DEVICE_HOUR) -> float:
        """Dollars per million in-SLO requests at the nominal price."""
        if self.n_in_slo == 0:
            return math.inf
        dollars = self.device_hours(device_ticks, tick_s) * price
        return dollars / self.n_in_slo * 1e6

    def summary(self, *, horizon_s: float, device_ticks: int,
                tick_s: float) -> Dict[str, float]:
        return {
            "n_requests": self.n_total,
            "n_completed": self.n_completed,
            "n_dropped": self.n_dropped,
            "drop_rate": self.drop_rate(),
            "p50_s": self.percentile(50.0),
            "p95_s": self.percentile(95.0),
            "p99_s": self.percentile(99.0),
            "slo_p99_s": self.slo_p99_s,
            "slo_attainment": self.slo_attainment(),
            "goodput_rps": self.goodput_rps(horizon_s),
            "device_hours": self.device_hours(device_ticks, tick_s),
            "cost_per_mreq": self.cost_per_mreq(device_ticks, tick_s),
            "horizon_s": horizon_s,
        }
