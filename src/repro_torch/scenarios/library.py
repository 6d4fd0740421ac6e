"""The ported scenarios (port of ``repro/scenarios/library.py``; importing
this module registers them):

* ``paper``             — the paper's Section V-A 160-job trace.
* ``hetero_bandwidth``  — paper workload, heterogeneous per-server NICs.
* ``contended_residue`` — 5-GPU jobs on 4-GPU servers: placements share
                          servers and all-reduces collide.
* ``oversub_fabric``    — paper workload on a two-tier fabric with 3x
                          oversubscribed rack uplinks.
* ``smoke``             — tiny, deterministic.

The rest of the reference's library is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import random
from typing import List, Optional

from repro_torch.core.cluster import TABLE_III, JobSpec
from repro_torch.core.contention import ContentionParams
from repro_torch.core.topology import two_tier
from repro_torch.core.trace import paper_trace
from repro_torch.scenarios.registry import Scenario, register

#: The reference's downsized overrides for the ported scenarios.
QUICK_OVERRIDES = {
    "paper": dict(n_jobs=40, min_iters=100, max_iters=600),
    "hetero_bandwidth": dict(n_jobs=28, min_iters=100, max_iters=600),
    "contended_residue": {},
    "oversub_fabric": dict(n_jobs=32, min_iters=100, max_iters=600),
    "smoke": {},
}


def _finalize(jobs: List[JobSpec]) -> tuple:
    return tuple(sorted(jobs, key=lambda j: (j.arrival, j.job_id)))


@register("paper")
def paper_scenario(
    seed: int = 0,
    n_jobs: int = 160,
    horizon_s: float = 1200.0,
    min_iters: int = 1000,
    max_iters: int = 6000,
    n_servers: int = 16,
    gpus_per_server: int = 4,
    params: Optional[ContentionParams] = None,
) -> Scenario:
    """Paper Section V-A Microsoft-like trace (160 jobs / 20 min)."""
    jobs = paper_trace(
        seed=seed, n_jobs=n_jobs, horizon_s=horizon_s,
        min_iters=min_iters, max_iters=max_iters,
    )
    return Scenario(
        name="paper",
        seed=seed,
        n_servers=n_servers,
        gpus_per_server=gpus_per_server,
        jobs=tuple(jobs),
        params=params or ContentionParams(),
    )


@register("hetero_bandwidth")
def hetero_bandwidth(
    seed: int = 0,
    n_jobs: int = 100,
    horizon_s: float = 1200.0,
    min_iters: int = 1000,
    max_iters: int = 6000,
    slow_fraction: float = 0.5,
    slow_scale: float = 0.4,
    n_servers: int = 16,
    gpus_per_server: int = 4,
) -> Scenario:
    """Paper workload on a cluster with heterogeneous per-server NIC
    bandwidth (slow servers spread evenly)."""
    jobs = paper_trace(
        seed=seed, n_jobs=n_jobs, horizon_s=horizon_s,
        min_iters=min_iters, max_iters=max_iters,
    )
    n_slow = int(round(slow_fraction * n_servers))
    slow_ids = {int(i * n_servers / max(1, n_slow)) for i in range(n_slow)}
    bandwidth = tuple(slow_scale if s in slow_ids else 1.0 for s in range(n_servers))
    return Scenario(
        name="hetero_bandwidth",
        seed=seed,
        n_servers=n_servers,
        gpus_per_server=gpus_per_server,
        jobs=tuple(jobs),
        params=ContentionParams(server_bandwidth=bandwidth),
    )


@register("contended_residue")
def contended_residue(
    seed: int = 0,
    n_jobs: int = 6,
    n_gpus_per_job: int = 5,
    base_iters: int = 40,
    iter_jitter: float = 0.2,
    wave_size: int = 3,
    model: str = "vgg16",
    n_servers: int = 4,
    gpus_per_server: int = 4,
) -> Scenario:
    """Jobs one GPU wider than a server, arriving in waves: every placement
    leaves a cross-server residue, so all-reduces collide."""
    rng = random.Random(seed)
    profile = TABLE_III[model]
    jobs = []
    for k in range(n_jobs):
        iters = int(base_iters * (1.0 + rng.uniform(-iter_jitter, iter_jitter)))
        jobs.append(
            JobSpec(
                job_id=k,
                arrival=float(k // wave_size),
                n_gpus=n_gpus_per_job,
                iterations=max(1, iters),
                model=profile,
            )
        )
    return Scenario(
        name="contended_residue",
        seed=seed,
        n_servers=n_servers,
        gpus_per_server=gpus_per_server,
        jobs=_finalize(jobs),
        params=ContentionParams(),
    )


@register("oversub_fabric")
def oversub_fabric(
    seed: int = 0,
    n_jobs: int = 120,
    horizon_s: float = 1200.0,
    min_iters: int = 1000,
    max_iters: int = 6000,
    n_servers: int = 16,
    gpus_per_server: int = 4,
    servers_per_rack: int = 4,
    oversub: float = 3.0,
) -> Scenario:
    """Paper workload on a blocking two-tier fabric: per-server NICs plus
    oversubscribed rack uplinks."""
    jobs = paper_trace(
        seed=seed, n_jobs=n_jobs, horizon_s=horizon_s,
        min_iters=min_iters, max_iters=max_iters,
    )
    return Scenario(
        name="oversub_fabric",
        seed=seed,
        n_servers=n_servers,
        gpus_per_server=gpus_per_server,
        jobs=tuple(jobs),
        params=ContentionParams(),
        topology=two_tier(n_servers, servers_per_rack, oversub=oversub),
    )


@register("smoke")
def smoke(seed: int = 0, n_servers: int = 4, gpus_per_server: int = 2) -> Scenario:
    """Tiny deterministic 6-job / 8-GPU scenario."""
    t3 = TABLE_III
    jobs = (
        # (job_id, arrival, n_gpus, iterations, model)
        JobSpec(0, 0.0, 4, 30, t3["resnet50"]),      # spans 2 servers -> comm
        JobSpec(1, 0.0, 4, 25, t3["vgg16"]),         # big message, spans 2
        JobSpec(2, 1.0, 1, 60, t3["lstm_ptb"]),      # single GPU, no comm
        JobSpec(3, 2.0, 2, 40, t3["inception_v3"]),  # fits one server
        JobSpec(4, 3.0, 4, 20, t3["resnet50"]),      # queued until GPUs free
        JobSpec(5, 5.0, 1, 50, t3["resnet50"]),
    )
    return Scenario(
        name="smoke",
        seed=seed,
        n_servers=n_servers,
        gpus_per_server=gpus_per_server,
        jobs=jobs,
        params=ContentionParams(),
    )
