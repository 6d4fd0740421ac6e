"""Scenario registry (port of ``repro/scenarios/registry.py``, trimmed to
what the fluid path reads: no event-engine scheduling, chaos or streaming
fields — the reference's fluid path rejects those anyway).

A scenario bundles a cluster shape, a job list and the contention model;
builders are registered by name and instantiated with :func:`get_scenario`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.cluster import JobSpec
from repro_torch.core.contention import ContentionParams
from repro_torch.core.topology import Topology


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One fully-instantiated workload + cluster + network scenario."""

    name: str
    seed: int
    n_servers: int
    gpus_per_server: int
    jobs: Tuple[JobSpec, ...]
    params: ContentionParams
    #: network fabric; None = the paper's NIC-only model
    topology: Optional[Topology] = None
    #: WFBP tensor fusion; only 'all' (monolithic all-reduce) is ported
    fusion: object = "all"

    def job_list(self) -> List[JobSpec]:
        return list(self.jobs)

    @property
    def n_jobs(self) -> int:
        return len(self.jobs)

    @property
    def total_gpus(self) -> int:
        return self.n_servers * self.gpus_per_server


ScenarioBuilder = Callable[..., Scenario]

_REGISTRY: Dict[str, ScenarioBuilder] = {}


def register(name: str):
    """Decorator: register ``fn(seed=0, **kw) -> Scenario`` under ``name``."""

    def deco(fn: ScenarioBuilder) -> ScenarioBuilder:
        if name in _REGISTRY:
            raise ValueError(f"scenario {name!r} already registered")
        _REGISTRY[name] = fn
        return fn

    return deco


def scenario_names() -> List[str]:
    return sorted(_REGISTRY)


def get_scenario(name: str, seed: int = 0, **overrides) -> Scenario:
    """Instantiate a registered scenario (same name+seed+overrides => same
    jobs, bitwise)."""
    try:
        builder = _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; registered: {scenario_names()}"
        ) from None
    return builder(seed=seed, **overrides)
