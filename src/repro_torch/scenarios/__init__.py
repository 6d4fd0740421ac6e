"""Scenarios and fluid sweeps of the port (port of ``repro.scenarios``).
Importing this package registers the ported scenario library."""

from repro_torch.scenarios.library import QUICK_OVERRIDES  # registers the library
from repro_torch.scenarios.metrics import CellCI, RunMetrics, ci_from_runs, from_jcts
from repro_torch.scenarios.registry import Scenario, get_scenario, register, scenario_names
from repro_torch.scenarios.sweep import (
    FLUID_POLICIES,
    canonical_comm,
    fluid_config,
    monte_carlo_fluid,
    run_scenario_fluid,
    sweep_ci,
)

__all__ = [
    "QUICK_OVERRIDES",
    "CellCI",
    "RunMetrics",
    "ci_from_runs",
    "from_jcts",
    "Scenario",
    "get_scenario",
    "register",
    "scenario_names",
    "FLUID_POLICIES",
    "canonical_comm",
    "fluid_config",
    "monte_carlo_fluid",
    "run_scenario_fluid",
    "sweep_ci",
]
