"""The ``MalleableTenant`` protocol — one device-pool contract for every
elasticity level (port of ``repro/dmr/tenant.py``).

The repo grew two parallel elasticity stacks: ``dmr.Cluster`` moves
devices between *training* tenants through the runner's pool contract
(``grant_devices`` / ``release_devices`` / ``shutdown``), while the
serving fleet used to keep its own private replica bookkeeping.  This
module names the contract both levels now share, so a batch training
job, a serving replica, and a whole serving fleet embedded in a cluster
are interchangeable from the resource manager's point of view:

* ``grant_devices(new_devices)`` — extend the tenant's pool with an
  explicit (possibly non-contiguous) device slice.  Grants **append**:
  the existing ``devices[:n]`` prefix stays stable so cached
  executables built on it remain valid.  Duplicate ids are an error.
* ``release_devices() -> list`` — trim the pool to ``current_size``
  and return the released tail (the manager reclaims it after a
  shrink).  Idempotent when nothing is in excess.
* ``shutdown() -> list`` — return *every* device (tenant complete).
* ``current_size`` — the worker count the tenant is actually running
  at; ``len(devices) - current_size`` is the reclaimable excess.

Devices move between a shared pool and a tenant **only** through these
four members — direct mutation of a tenant's device list from outside
them is the bug class the JAX package's ``repro.analysis`` linter flags
as DMR106,
and the schedule-trail auditor checks the dynamic half of the same
contract (every grant/release event balanced, no double-grants).

Implementations in-tree:

* :class:`repro_torch.dmr.runner.MalleableRunner` — the mesh-level contract
  (a training job's live pool).
* ``repro_torch.dmr.cluster._Tenant`` — a cluster tenant, delegating to its
  runner.
* a serving replica (``repro_torch.serve.replica.Replica``) and a whole
  serving fleet presented to ``dmr.Cluster`` as a single composite
  tenant (``repro_torch.serve.tenant.ReplicaSetRunner``).
"""
from __future__ import annotations

from typing import List, Protocol, runtime_checkable

__all__ = ["MalleableTenant"]


@runtime_checkable
class MalleableTenant(Protocol):
    """The device-pool contract shared by training jobs, serving
    replicas and composite serving fleets (see the module docstring).

    ``runtime_checkable``: ``isinstance(x, MalleableTenant)`` verifies
    the members exist (not their signatures) — the shared contract
    tests of the JAX package (``tests/test_tenant_contract.py``) check the
    semantics, and ``tests/test_torch_cluster.py`` the port's.
    """

    @property
    def current_size(self) -> int:
        """Workers the tenant is running at right now."""
        ...

    def grant_devices(self, new_devices: List) -> None:
        """Append a device grant to the live pool (duplicate ids are an
        error; the existing prefix must stay stable)."""
        ...

    def release_devices(self) -> List:
        """Trim the pool to ``current_size``; return the released tail."""
        ...

    def shutdown(self) -> List:
        """Return every device (the tenant is done)."""
        ...
