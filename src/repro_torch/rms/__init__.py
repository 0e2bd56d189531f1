"""``repro_torch.rms`` — the paper's resource manager as a discrete-event
simulator (port of ``repro.rms``): the workload model (applications,
scenarios, SWF traces, live materialization) and the two scheduling
engines.  Plain Python and numpy: it needs neither torch nor a card."""
from repro_torch.core.policy import (POLICIES, Algorithm2Policy, BasePolicy,
                                     EnergyAwarePolicy, Policy,
                                     ThroughputGreedyPolicy, get_policy)
from repro_torch.rms.scheduler import (ReferenceSimulator, ResizeRecord,
                                       SimConfig, SimResult, Simulator,
                                       Timeline)
from repro_torch.rms.workload import (APPS, MOLDABLE, RIGID, SCENARIOS,
                                      SUBMISSION_MODES, AppProfile, Job,
                                      LiveJobSpec, UnknownScenarioError,
                                      bursty_arrivals, diurnal_arrivals,
                                      feitelson_arrivals,
                                      generate_synthetic_swf, make_scenario,
                                      make_workload, materialize_live,
                                      parse_swf)

__all__ = ["SimConfig", "SimResult", "Simulator", "ReferenceSimulator",
           "Timeline", "ResizeRecord",
           "APPS", "AppProfile", "Job", "feitelson_arrivals", "make_workload",
           "RIGID", "MOLDABLE", "SUBMISSION_MODES", "SCENARIOS",
           "bursty_arrivals", "diurnal_arrivals", "make_scenario",
           "UnknownScenarioError",
           "parse_swf", "generate_synthetic_swf",
           "LiveJobSpec", "materialize_live",
           "Policy", "BasePolicy", "Algorithm2Policy", "EnergyAwarePolicy",
           "ThroughputGreedyPolicy", "POLICIES", "get_policy"]
