"""Scenario registry (port of ``repro/scenarios/registry.py``, trimmed to
what the fluid path reads plus the event-engine fields the ported builders
set; no chaos, checkpoint-cost or streaming fields, as the reference's
fluid path rejects or ignores those).

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
    #: GPU memory [MB]; the event engine's admission reads it, the fluid
    #: path (gang-exclusive placement) does not
    gpu_mem_mb: float = 16160.0
    #: network fabric; None = the paper's NIC-only model
    topology: Optional[Topology] = None
    #: WFBP tensor fusion ('all' | 'none' | a byte threshold): how each
    #: job's gradient exchange is bucketed (netmodel.fusion_plan) for models
    #: with layer data; 'all' is the paper's monolithic all-reduce
    fusion: object = "all"
    #: the event engine's job scheduling policy and its tick period, and
    #: its one-job-per-GPU mode; the fluid path runs every scenario as
    #: static gang scheduling and ignores them, as the reference's does
    sched: str = "static"
    preemption_quantum: Optional[float] = None
    exclusive_gpus: bool = False

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
