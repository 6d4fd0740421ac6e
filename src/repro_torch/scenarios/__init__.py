"""Scenarios, event and fluid runs and the sweep runner of the port (port
of ``repro.scenarios``).  Importing this package registers the scenario
library."""

from repro_torch.scenarios.library import QUICK_OVERRIDES  # registers the library
from repro_torch.scenarios.metrics import (
    CellCI,
    RunMetrics,
    ci_from_runs,
    from_event_result,
    from_jcts,
    summarize,
)
from repro_torch.scenarios.registry import (
    Scenario,
    describe,
    get_scenario,
    register,
    scenario_names,
)
from repro_torch.scenarios.tracesource import (  # registers the trace_replay_* scenarios
    CsvTraceSource,
    SyntheticTraceSource,
    trace_source_from_spec,
)
from repro_torch.scenarios.sweep import (
    FLUID_POLICIES,
    SweepCell,
    canonical_comm,
    fluid_config,
    monte_carlo_fluid,
    run_cell,
    run_scenario_event,
    run_scenario_fluid,
    sweep,
    sweep_ci,
)

__all__ = [
    "QUICK_OVERRIDES",
    "CsvTraceSource",
    "SyntheticTraceSource",
    "trace_source_from_spec",
    "CellCI",
    "RunMetrics",
    "ci_from_runs",
    "from_event_result",
    "from_jcts",
    "summarize",
    "Scenario",
    "describe",
    "get_scenario",
    "register",
    "scenario_names",
    "FLUID_POLICIES",
    "SweepCell",
    "canonical_comm",
    "fluid_config",
    "monte_carlo_fluid",
    "run_cell",
    "run_scenario_event",
    "run_scenario_fluid",
    "sweep",
    "sweep_ci",
]
