"""The paper's workload generator (port of ``repro/core/trace.py``).

160 jobs arriving over 20 minutes: GPU counts 80 x 1, 14 x 2, 26 x 4, 30 x 8,
8 x 16, 2 x 32; iterations ~ U{1000..6000}; models uniform over Table III.
The draws are the reference's ``random.Random(seed)`` sequence, so a seed
gives the same job list bit for bit.
"""

from __future__ import annotations

import random
from typing import List, Optional, Sequence

from repro_torch.core.cluster import TABLE_III, JobSpec, ModelProfile

PAPER_GPU_DISTRIBUTION = ((1, 80), (2, 14), (4, 26), (8, 30), (16, 8), (2 * 16, 2))


def paper_trace(
    seed: int = 0,
    n_jobs: int = 160,
    horizon_s: float = 1200.0,
    min_iters: int = 1000,
    max_iters: int = 6000,
    models: Optional[Sequence[ModelProfile]] = None,
    gpu_distribution=PAPER_GPU_DISTRIBUTION,
) -> List[JobSpec]:
    """Generate the paper's workload (scaled when ``n_jobs != 160``)."""
    rng = random.Random(seed)
    models = list(models) if models is not None else list(TABLE_III.values())

    total = sum(c for _, c in gpu_distribution)
    gpu_counts: List[int] = []
    for gpus, count in gpu_distribution:
        scaled = max(1, round(count * n_jobs / total)) if count else 0
        gpu_counts.extend([gpus] * scaled)
    # trim/pad with 1-GPU jobs to hit n_jobs exactly
    rng.shuffle(gpu_counts)
    gpu_counts = gpu_counts[:n_jobs]
    while len(gpu_counts) < n_jobs:
        gpu_counts.append(1)

    jobs = []
    for k in range(n_jobs):
        arrival = float(int(rng.uniform(1.0, horizon_s)))  # 1 s ticks
        iters = rng.randint(min_iters, max_iters)
        model = rng.choice(models)
        jobs.append(
            JobSpec(
                job_id=k,
                arrival=arrival,
                n_gpus=gpu_counts[k],
                iterations=iters,
                model=model,
            )
        )
    jobs.sort(key=lambda j: (j.arrival, j.job_id))
    return jobs
