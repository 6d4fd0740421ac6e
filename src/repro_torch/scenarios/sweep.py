"""Runs of registered scenarios (port of ``repro/scenarios/sweep.py``
without the multiprocessing ``sweep`` runner, ROADMAP queue 1, item 7h).

* :func:`run_scenario_event` — one exact event-engine simulation of a
  scenario, on the host.
* :func:`run_scenario_fluid` — one fluid simulation of a scenario.
* :func:`monte_carlo_fluid` — all seeds of one cell in one batch.
* :func:`sweep_ci` — mean +/- std per scenario x placement x comm cell.

Every fluid entry point runs on CUDA unless given ``device="cpu"``.  Policy
strings accept the simulator's names plus the paper aliases
'adadual'/'ada-srsf'.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import netmodel
from repro_torch.core.fluidsim import (
    FluidSimConfig,
    simulate_jobs,
    simulate_traces_batched,
    stack_traces,
    trace_from_jobs,
)
from repro_torch.core.placement import PlacementPolicy
from repro_torch.core.simulator import ClusterSimulator, SimResult, comm_policy_from_name
from repro_torch.device import resolve_device
from repro_torch.scenarios import metrics as metrics_mod
from repro_torch.scenarios.registry import Scenario, get_scenario

COMM_ALIASES = {
    "adadual": "ada",
    "ada-srsf": "ada",
    "ada_srsf": "ada",
}

#: The reference's fluid gating policies: AdaDUAL, SRSF(n) and the exact
#: k-way lookahead.
FLUID_POLICIES = ("ada", "srsf1", "srsf2", "srsf3", "kway2", "kway3")


def canonical_comm(comm: str) -> str:
    return COMM_ALIASES.get(comm.lower(), comm.lower())


def run_scenario_event(
    scenario: Scenario,
    placement: str = "lwf",
    kappa: int = 1,
    comm: str = "ada",
    **sim_kw,
) -> SimResult:
    """Exact event-engine simulation of one scenario instance.  The
    scenario's scheduling and fault fields (``sched``,
    ``preemption_quantum``, ``checkpoint_cost``, ``exclusive_gpus``,
    ``chaos``) are defaults that ``sim_kw`` overrides; ``max_time`` goes to
    ``run``.  A scenario with a ``source`` feeds the engine the streamed
    arrivals in place of the job list (the same results, O(live jobs)
    calendar)."""
    jobs = scenario.source if scenario.source is not None else scenario.job_list()
    sim_kw.setdefault("fusion", scenario.fusion)
    sim_kw.setdefault("sched", scenario.sched)
    sim_kw.setdefault("preemption_quantum", scenario.preemption_quantum)
    sim_kw.setdefault("checkpoint_cost", scenario.checkpoint_cost)
    sim_kw.setdefault("exclusive_gpus", scenario.exclusive_gpus)
    sim_kw.setdefault("chaos", scenario.chaos)
    max_time = sim_kw.pop("max_time", math.inf)
    sim = ClusterSimulator(
        jobs,
        cluster=scenario.make_cluster(),
        placement=PlacementPolicy(
            placement, kappa=kappa, seed=scenario.seed, topology=scenario.topology
        ),
        comm_policy=comm_policy_from_name(canonical_comm(comm)),
        params=scenario.params,
        topology=scenario.topology,
        **sim_kw,
    )
    return sim.run(max_time=max_time)


def fluid_config(
    scenario: Scenario,
    comm: str = "ada",
    placement: str = "lwf",
    dt: float = 0.05,
    max_steps: int = 400_000,
    device=None,
    **fast_kw,
) -> FluidSimConfig:
    """FluidSimConfig for a scenario: bandwidth and fabric pass through,
    event placement names map to their gang analogues, ``fast_kw``
    forwards ``skip``/``gating``/``compact``/``chunk_steps``/``kernel``.
    The scenario's event-engine scheduling fields (``sched``,
    ``preemption_quantum``, ``checkpoint_cost``, ``exclusive_gpus``) do not
    reach the fluid path: it runs static gang scheduling, as the
    reference's does.  Fault injection and an unmaterialized streamed
    source are event-engine only and raise, as in the reference."""
    comm = canonical_comm(comm)
    if comm not in FLUID_POLICIES:
        raise ValueError(f"fluid backend supports {FLUID_POLICIES}, got {comm!r}")
    if scenario.chaos is not None and scenario.chaos.active:
        raise ValueError(
            f"scenario {scenario.name!r} arms fault injection (chaos=), which is "
            "event-engine only: the fluid path's static traces cannot express a "
            "gang's teardown and repair"
        )
    if scenario.source is not None and not scenario.jobs:
        raise ValueError(
            f"scenario {scenario.name!r} is an unmaterialized streaming trace replay "
            "(source= without jobs), which is event-engine only: the fluid path needs "
            "the whole trace as one tensor"
        )
    p = scenario.params
    gang_mode = netmodel.canonical_placement(placement)
    return FluidSimConfig(
        n_servers=scenario.n_servers,
        gpus_per_server=scenario.gpus_per_server,
        dt=dt,
        max_steps=max_steps,
        policy=comm,
        placement=gang_mode,
        a=p.a,
        b=p.b,
        eta=p.eta,
        dual_threshold=p.dual_threshold,
        server_bandwidth=tuple(p.server_bandwidth),
        topology=scenario.topology,
        placement_seed=scenario.seed if gang_mode == "random" else 0,
        device=str(resolve_device(device)),
        **fast_kw,
    )


def run_scenario_fluid(
    scenario: Scenario,
    comm: str = "ada",
    placement: str = "lwf",
    dt: float = 0.05,
    max_steps: int = 400_000,
    device=None,
    **fast_kw,
) -> Dict[str, object]:
    """One fluid simulation of a scenario instance."""
    cfg = fluid_config(
        scenario, comm=comm, placement=placement, dt=dt,
        max_steps=max_steps, device=device, **fast_kw,
    )
    return simulate_jobs(scenario.job_list(), cfg, fusion=scenario.fusion)


def _dedupe_fluid_placements(placements: Sequence[str]) -> Tuple[str, ...]:
    seen: Dict[str, str] = {}
    for pl in placements:
        seen.setdefault(netmodel.canonical_placement(pl), pl)
    return tuple(seen.values())


def monte_carlo_fluid(
    scenario: str,
    seeds: Sequence[int],
    comm: str = "ada",
    placement: str = "lwf",
    overrides: Optional[Dict[str, object]] = None,
    dt: float = 0.05,
    max_steps: int = 400_000,
    device=None,
    **fast_kw,
) -> List[metrics_mod.RunMetrics]:
    """All seeds of one scenario x policy x placement cell in one batch:
    per-seed traces are padded and stacked, and finished lanes retire
    between chunks.  One :class:`RunMetrics` per seed."""
    seeds = list(seeds)
    scns = [get_scenario(scenario, seed=s, **(overrides or {})) for s in seeds]
    cfg = fluid_config(
        scns[0], comm=comm, placement=placement, dt=dt,
        max_steps=max_steps, device=device, **fast_kw,
    )
    t0 = time.time()
    batch = stack_traces(
        [trace_from_jobs(s.job_list(), fusion=s.fusion, device=cfg.device) for s in scns]
    )
    out = simulate_traces_batched(batch, cfg)
    jct, fin, mks = out["jct"], out["finished"], out["makespan"]
    wall = (time.time() - t0) / len(seeds)
    return [
        metrics_mod.from_jcts(
            jct[i][fin[i]].tolist(),
            scenario=scenario,
            backend="fluid",
            placement=f"gang-{cfg.placement}",
            comm=cfg.policy,
            seed=seed,
            n_jobs=scn.n_jobs,
            makespan=float(mks[i]),
            wall_s=wall,
            chunks=out["chunks"],
        )
        for i, (seed, scn) in enumerate(zip(seeds, scns))
    ]


def sweep_ci(
    scenarios: Sequence[str],
    comms: Sequence[str] = ("ada", "srsf1", "srsf2"),
    placements: Sequence[str] = ("lwf",),
    seeds: Sequence[int] = (0, 1, 2, 3, 4),
    overrides: Optional[Dict[str, object]] = None,
    per_scenario_overrides: Optional[Dict[str, Dict[str, object]]] = None,
    dt: float = 0.05,
    device=None,
) -> List[metrics_mod.CellCI]:
    """Mean +/- std avg-JCT per scenario x placement x comm cell over
    ``seeds``, one batch per cell (the fluid branch of the reference's
    ``sweep_ci``)."""
    placements = _dedupe_fluid_placements(placements)
    records: List[metrics_mod.RunMetrics] = []
    for s in scenarios:
        cell_over = dict(overrides or {})
        cell_over.update((per_scenario_overrides or {}).get(s, {}))
        for pl in placements:
            for c in comms:
                records.extend(
                    monte_carlo_fluid(
                        s, seeds, comm=c, placement=pl,
                        overrides=cell_over, dt=dt, device=device,
                    )
                )
    return metrics_mod.ci_from_runs(records)
