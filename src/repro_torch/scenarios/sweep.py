"""Sweep runner: scenario x policy x seed matrices over both backends
(port of ``repro/scenarios/sweep.py``).

* :func:`run_scenario_event` — one exact event-engine simulation of a
  scenario, on the host.
* :func:`run_scenario_fluid` — one fluid simulation of a scenario.
* :func:`run_cell` / :func:`sweep` — the full matrix, one
  :class:`~repro_torch.scenarios.metrics.RunMetrics` per cell; event cells
  can fan out over a ``spawn`` process pool, fluid cells run in the
  calling process.
* :func:`monte_carlo_fluid` — all seeds of one cell in one batch.
* :func:`sweep_ci` — mean +/- std per scenario x placement x comm cell.

Every fluid entry point runs on CUDA unless given ``device="cpu"``.  Policy
strings accept the simulator's names plus the paper aliases
'adadual'/'ada-srsf'.
"""

from __future__ import annotations

import dataclasses
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


@dataclasses.dataclass(frozen=True)
class SweepCell:
    """One picklable cell of the sweep matrix (workers rebuild the scenario
    from (name, seed, overrides), so nothing heavy crosses processes).

    ``sim_kw`` carries event-engine keyword overrides (``sched=``,
    ``comm_chunks=``, ...): event cells only, a fluid cell with ``sim_kw``
    raises.  ``device`` is where a fluid cell runs (None: CUDA); an event
    cell runs on the host."""

    scenario: str
    seed: int
    placement: str
    kappa: int
    comm: str
    backend: str  # "event" | "fluid"
    overrides: Tuple[Tuple[str, object], ...] = ()
    dt: float = 0.05
    sim_kw: Tuple[Tuple[str, object], ...] = ()
    device: Optional[str] = None


def run_cell(cell: SweepCell) -> metrics_mod.RunMetrics:
    scn = get_scenario(cell.scenario, seed=cell.seed, **dict(cell.overrides))
    if cell.sim_kw and cell.backend != "event":
        raise ValueError(
            f"sim_kw {dict(cell.sim_kw)} is event-backend only "
            f"(got backend {cell.backend!r})"
        )
    t0 = time.time()
    if cell.backend == "event":
        res = run_scenario_event(
            scn,
            placement=cell.placement,
            kappa=cell.kappa,
            comm=cell.comm,
            **dict(cell.sim_kw),
        )
        return metrics_mod.from_event_result(
            res,
            scenario=cell.scenario,
            seed=cell.seed,
            n_jobs=scn.n_jobs,
            wall_s=time.time() - t0,
        )
    if cell.backend == "fluid":
        out = run_scenario_fluid(
            scn, comm=cell.comm, placement=cell.placement, dt=cell.dt, device=cell.device
        )
        jcts = [float(j) for j, fin in zip(out["jct"], out["finished"]) if fin]
        return metrics_mod.from_jcts(
            jcts,
            scenario=cell.scenario,
            backend="fluid",
            placement=f"gang-{netmodel.canonical_placement(cell.placement)}",
            comm=canonical_comm(cell.comm),
            seed=cell.seed,
            n_jobs=scn.n_jobs,
            makespan=out["makespan"],
            wall_s=time.time() - t0,
            chunks=out["chunks"],
        )
    raise ValueError(f"unknown backend {cell.backend!r}")


def sweep(
    scenarios: Sequence[str],
    comms: Sequence[str] = ("ada", "srsf1", "srsf2"),
    placements: Sequence[str] = ("lwf",),
    kappa: int = 1,
    seeds: Sequence[int] = (0,),
    backend: str = "event",
    overrides: Optional[Dict[str, object]] = None,
    per_scenario_overrides: Optional[Dict[str, Dict[str, object]]] = None,
    processes: Optional[int] = None,
    dt: float = 0.05,
    sim_kw: Optional[Dict[str, object]] = None,
    device=None,
) -> List[metrics_mod.RunMetrics]:
    """Run the full scenario x placement x comm x seed matrix.

    ``overrides`` applies to every scenario; ``per_scenario_overrides``
    (keyed by scenario name, e.g. ``QUICK_OVERRIDES``) layers on top.
    ``sim_kw`` forwards event-engine keywords to every cell.
    ``processes > 1`` fans event cells out over a ``spawn`` process pool
    (the start method CUDA needs too); fluid cells run in this process, on
    ``device`` (None: CUDA)."""
    if backend == "fluid":
        placements = _dedupe_fluid_placements(placements)

    def cell_overrides(name: str) -> Tuple[Tuple[str, object], ...]:
        d = dict(overrides or {})
        d.update((per_scenario_overrides or {}).get(name, {}))
        return tuple(sorted(d.items()))

    cells = [
        SweepCell(
            scenario=s,
            seed=seed,
            placement=pl,
            kappa=kappa,
            comm=c,
            backend=backend,
            overrides=cell_overrides(s),
            dt=dt,
            sim_kw=tuple(sorted((sim_kw or {}).items())),
            device=None if device is None else str(device),
        )
        for s in scenarios
        for pl in placements
        for c in comms
        for seed in seeds
    ]
    if processes and processes > 1 and backend == "event" and len(cells) > 1:
        import multiprocessing as mp

        with mp.get_context("spawn").Pool(processes) as pool:
            return pool.map(run_cell, cells)
    return [run_cell(c) for c in cells]


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
    kappa: int = 1,
    backend: str = "fluid",
    processes: Optional[int] = None,
    sim_kw: Optional[Dict[str, object]] = None,
) -> List[metrics_mod.CellCI]:
    """Mean +/- std avg-JCT per scenario x placement x comm cell over
    ``seeds``.  Fluid: one batch per cell (:func:`monte_carlo_fluid`);
    event: the exact per-seed :func:`sweep` (optionally in a process
    pool), aggregated the same way.  ``sim_kw`` is event-only."""
    if backend != "fluid":
        records = sweep(
            scenarios, comms=comms, placements=placements, kappa=kappa, seeds=seeds,
            backend=backend, overrides=overrides,
            per_scenario_overrides=per_scenario_overrides, processes=processes,
            dt=dt, sim_kw=sim_kw,
        )
        return metrics_mod.ci_from_runs(records)
    if sim_kw:
        raise ValueError(f"sim_kw {sim_kw} is event-backend only")
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
