"""``repro_torch.dmr`` — the DMRlib user-facing API of the port.

The paper's call set, as in the JAX package's ``repro.dmr``:

    DMR_Set_parameters(min, max, pref)   dmr.set_parameters(2, 8, 4)
    user compute/layout functions        dmr.App(init=, shardings=, step=)
    DMR_RECONFIG(...)                    dmr.reconfig(runner, state, i)
    Table-1 patterns                     dmr.get_pattern("blockcyclic:4"),
                                         App(patterns={"table": "replicate"})
    user send/recv functions (custom)    App(patterns={"t": fn}),
                                         dmr.register_pattern(name, factory)
    DMRlib <-> Slurm link (Fig. 1)       dmr.connect(...) / RMSConnector:
                                         ScriptedRMS, PolicyRMS, FileRMS,
                                         SimRMS (co-simulation)

One app definition runs live (PolicyRMS/FileRMS), scripted (ScriptedRMS),
inside a simulated cluster (SimRMS), or co-scheduled with other live jobs
on one shared worker pool (``dmr.Cluster`` — the multi-tenant elastic
runtime, with whole-workload co-simulation via ``SimWorkload``) without
changing a line of user code.
"""
from repro_torch.core.params import MalleabilityParams
from repro_torch.core.policy import Action, ClusterView, Policy, get_policy
from repro_torch.core.redistribute import TransferStats
from repro_torch.dmr.app import App, MalleableApp, ensure_app
from repro_torch.dmr.cluster import (Cluster, ClusterResult, ClusterRMS,
                                     JobRecord, ReferenceCluster,
                                     SchedOnlyApp, default_app_factory,
                                     synthetic_pool)
from repro_torch.dmr.connectors import (FileRMS, PolicyRMS, RMSConnector,
                                        ScriptedRMS, connect)
from repro_torch.dmr.cosim import SimRMS, SimWorkload
from repro_torch.dmr.patterns import (PATTERNS, BlockCyclicPattern,
                                      CallablePattern, DefaultPattern,
                                      Pattern, ReplicatePattern,
                                      ResizeContext, get_pattern,
                                      redistribute_tree, register_pattern)
from repro_torch.dmr.runner import MalleableRunner, ResizeEvent, reconfig
from repro_torch.dmr.tenant import MalleableTenant


def set_parameters(min_procs: int, max_procs: int, preferred: int, *,
                   sched_period_s: float = 0.0,
                   sched_iterations: int = 0) -> MalleabilityParams:
    """``DMR_Set_parameters(min, max, pref)`` + the §3.2 inhibitors."""
    return MalleabilityParams(min_procs=min_procs, max_procs=max_procs,
                              preferred=preferred,
                              sched_period_s=sched_period_s,
                              sched_iterations=sched_iterations)


__all__ = [
    # paper call set
    "App", "set_parameters", "reconfig", "MalleableRunner",
    # patterns
    "Pattern", "DefaultPattern", "BlockCyclicPattern", "ReplicatePattern",
    "CallablePattern", "ResizeContext", "PATTERNS", "get_pattern",
    "register_pattern", "redistribute_tree",
    # connectors
    "RMSConnector", "ScriptedRMS", "PolicyRMS", "FileRMS", "SimRMS",
    "connect",
    # multi-tenant live cluster
    "Cluster", "ReferenceCluster", "ClusterRMS", "ClusterResult", "JobRecord",
    "SimWorkload", "default_app_factory", "SchedOnlyApp", "synthetic_pool",
    # shared types
    "MalleableApp", "ensure_app", "MalleabilityParams", "Action",
    "ClusterView", "Policy", "get_policy", "TransferStats", "ResizeEvent",
    "MalleableTenant",
]
