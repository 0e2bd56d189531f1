"""Malleability parameters — the DMRlib §3.2 knobs.

``DMR_Set_parameters(min, max, pref)`` + the two scheduling inhibitors
(``DMR_Set_sched_period`` / ``DMR_Set_sched_iterations``) map one-to-one.
Counts are in *workers*: MPI processes in the paper, logical
workers on one CUDA device in the PyTorch port.
"""
from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass
class MalleabilityParams:
    min_procs: int
    max_procs: int
    preferred: int
    sched_period_s: float = 0.0      # ignore RMS queries within this period
    sched_iterations: int = 0        # ignore RMS queries for N steps

    def __post_init__(self):
        assert 1 <= self.min_procs <= self.preferred <= self.max_procs, self

    def legal_sizes(self) -> List[int]:
        """Sizes reachable by multiply/divide-style resizes (paper §6: resizes
        are limited to multiples/divisors of the current process count)."""
        sizes = []
        n = self.min_procs
        while n <= self.max_procs:
            sizes.append(n)
            n *= 2
        if self.max_procs not in sizes:
            sizes.append(self.max_procs)
        return sizes

    def clamp(self, n: int) -> int:
        return max(self.min_procs, min(self.max_procs, n))


def expansion_target(current: int, params: MalleabilityParams,
                     available: int) -> int:
    """Largest legal expansion given `available` extra workers."""
    best = current
    for s in params.legal_sizes():
        if s > current and s - current <= available:
            best = max(best, s)
    return best


def shrink_target(current: int, params: MalleabilityParams,
                  floor: int | None = None) -> int:
    """Largest legal size strictly below current, never below preferred
    (Algorithm 2 never shrinks past the preferred configuration)."""
    lo = params.preferred if floor is None else max(floor, params.min_procs)
    best = current
    for s in params.legal_sizes():
        if lo <= s < current:
            best = s if best == current else max(best, s)
    return best
