"""Fluid runs of registered scenarios (port of the fluid half of
``repro/scenarios/sweep.py``).

* :func:`run_scenario_fluid` — one fluid simulation of a scenario.
* :func:`monte_carlo_fluid` — all seeds of one cell in one batch.
* :func:`sweep_ci` — mean +/- std per scenario x placement x comm cell.

Every entry point runs on CUDA unless given ``device="cpu"``.  Policy
strings accept the simulator's names plus the paper aliases
'adadual'/'ada-srsf'.
"""

from __future__ import annotations

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
    ``preemption_quantum``, ``exclusive_gpus``) do not reach the fluid
    path: it runs static gang scheduling, as the reference's does."""
    comm = canonical_comm(comm)
    if comm not in FLUID_POLICIES:
        raise ValueError(f"fluid backend supports {FLUID_POLICIES}, got {comm!r}")
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
