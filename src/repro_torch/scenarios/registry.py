"""Scenario registry (port of ``repro/scenarios/registry.py``).

A scenario bundles a cluster shape, a job list (or a streamed trace
source), the contention model and the event engine's scheduling and
fault-injection settings; builders are registered by name and
instantiated with :func:`get_scenario`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.chaos import ChaosSpec
from repro_torch.core.cluster import Cluster, JobSpec
from repro_torch.core.contention import ContentionParams
from repro_torch.core.topology import Topology
from repro_torch.core.trace import TraceSource


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
    #: the event engine's job scheduling policy ('static' |
    #: 'preemptive_srsf' | 'elastic'), its tick period (None = the policy's
    #: default), the checkpoint/restore penalty of a preemption or resize
    #: (None = ``netmodel.preemption_cost`` of the model state) and its
    #: one-job-per-GPU mode; the fluid path runs every scenario as static
    #: gang scheduling and ignores them, as the reference's does
    sched: str = "static"
    preemption_quantum: Optional[float] = None
    checkpoint_cost: Optional[float] = None
    exclusive_gpus: bool = False
    #: fault injection (core/chaos.py); event engine only, the fluid
    #: path's ``fluid_config`` raises for an active spec
    chaos: Optional[ChaosSpec] = None
    #: streamed arrivals: the event engine consumes this source in place of
    #: ``jobs`` (which a replay of a large trace leaves empty)
    source: Optional[TraceSource] = None

    def make_cluster(self) -> Cluster:
        """A fresh (mutable) cluster — one per event-engine run."""
        return Cluster(
            n_servers=self.n_servers,
            gpus_per_server=self.gpus_per_server,
            gpu_mem_mb=self.gpu_mem_mb,
        )

    def job_list(self) -> List[JobSpec]:
        if self.source is not None and not self.jobs:
            return self.source.materialize()
        return list(self.jobs)

    @property
    def n_jobs(self) -> int:
        if self.source is not None and not self.jobs:
            hint = self.source.n_jobs_hint()
            return hint if hint is not None else len(self.job_list())
        return len(self.jobs)

    @property
    def total_gpus(self) -> int:
        return self.n_servers * self.gpus_per_server


ScenarioBuilder = Callable[..., Scenario]

_REGISTRY: Dict[str, ScenarioBuilder] = {}
_DESCRIPTIONS: Dict[str, str] = {}


def register(name: str, description: str = ""):
    """Decorator: register ``fn(seed=0, **kw) -> Scenario`` under ``name``,
    with a one-line description (else the builder's docstring)."""

    def deco(fn: ScenarioBuilder) -> ScenarioBuilder:
        if name in _REGISTRY:
            raise ValueError(f"scenario {name!r} already registered")
        _REGISTRY[name] = fn
        _DESCRIPTIONS[name] = description or (fn.__doc__ or "").strip()
        return fn

    return deco


def scenario_names() -> List[str]:
    return sorted(_REGISTRY)


def describe(name: str) -> str:
    return _DESCRIPTIONS.get(name, "")


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
