"""``repro_torch.serve`` — elastic LM inference serving on the
malleability stack: latency SLOs, not makespan (port of ``repro.serve``).

The batch subsystems (``repro_torch.rms``, ``dmr.Cluster``) answer "how
fast does the queue drain?"; serving answers "of the requests users sent,
how many came back within the SLO, and at what cost?".  Five modules:

* :mod:`repro_torch.serve.traffic` — request streams (diurnal / bursty /
  bimodal / ``trace:`` arrivals reinterpreted from the scenario library),
  the deadline queue, the replica load balancer.
* :mod:`repro_torch.serve.slo` — streaming percentile estimators (P²,
  windowed) and the latency-objective policies ``slo-aware`` /
  ``queue-depth`` (registered into ``repro_torch.core.policy.POLICIES``
  on import).
* :mod:`repro_torch.serve.replica` — :func:`make_decode_app` (the decode
  path as a ``dmr.App``; resize point = decode-step boundary),
  :func:`decode_demo`, and :class:`ReplicaSet` (the elastic fleet engine,
  trail-audited like ``dmr.Cluster``; each replica is a
  ``MalleableTenant`` and scale-ups prefer in-place mesh grows over
  replica cold starts).
* :mod:`repro_torch.serve.tenant` — :class:`ServeTenantSpec` /
  :class:`ReplicaSetRunner`: a whole fleet submitted to ``dmr.Cluster``
  as one composite tenant (mixed train+serve pools).
* :mod:`repro_torch.serve.metrics` — goodput under SLO, tail-latency
  CDFs, cost per million requests.
"""
from repro_torch.serve.metrics import (CDF_GRID, PRICE_PER_DEVICE_HOUR,
                                       ServingMetrics)
from repro_torch.serve.replica import (Replica, ReplicaSet, ServeConfig,
                                       ServingResult, decode_demo,
                                       make_decode_app)
from repro_torch.serve.slo import (P2Estimator, QueueDepthPolicy,
                                   SLOAwarePolicy, SLOTracker,
                                   WindowedPercentile)
from repro_torch.serve.tenant import ReplicaSetRunner, ServeTenantSpec
from repro_torch.serve.traffic import (LeastLoadedBalancer, Request,
                                       RequestQueue, make_request_stream)

__all__ = [
    "Request", "RequestQueue", "LeastLoadedBalancer", "make_request_stream",
    "P2Estimator", "WindowedPercentile", "SLOTracker",
    "SLOAwarePolicy", "QueueDepthPolicy",
    "ServingMetrics", "PRICE_PER_DEVICE_HOUR", "CDF_GRID",
    "ServeConfig", "Replica", "ReplicaSet", "ServingResult",
    "make_decode_app", "decode_demo",
    "ServeTenantSpec", "ReplicaSetRunner",
]
