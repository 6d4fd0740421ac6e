"""The paper's workload generator (port of ``repro/core/trace.py``).

160 jobs arriving over 20 minutes: GPU counts 80 x 1, 14 x 2, 26 x 4, 30 x 8,
8 x 16, 2 x 32; iterations ~ U{1000..6000}; models uniform over Table III.
The draws are the reference's ``random.Random(seed)`` sequence, so a seed
gives the same job list bit for bit.

:class:`TraceSource` is the streaming-arrival protocol the event engine
accepts in place of a job list: arrivals are yielded lazily in
nondecreasing order, so a long replay holds O(live jobs) memory.  The
synthetic and CSV sources are in :mod:`repro_torch.scenarios.tracesource`;
:class:`ListTraceSource` adapts an in-memory job list.
"""

from __future__ import annotations

import random
from typing import Iterator, List, Optional, Sequence

from repro_torch.core.cluster import TABLE_III, JobSpec, ModelProfile


class TraceSource:
    """Streaming arrival feed: the engine pulls arrivals one at a time.

    Subclasses implement :meth:`arrivals` to yield :class:`JobSpec`s in
    nondecreasing arrival order with unique job ids (the engine checks
    both and raises).  ``arrivals`` is restartable: each call returns a
    fresh iterator over the same trace.  ``n_jobs_hint`` is the job count
    where it is known up front, else None."""

    def arrivals(self) -> Iterator[JobSpec]:
        raise NotImplementedError

    def n_jobs_hint(self) -> Optional[int]:
        return None

    def materialize(self) -> List[JobSpec]:
        """The whole trace as an in-memory list."""
        return list(self.arrivals())


class ListTraceSource(TraceSource):
    """An in-memory job list behind the streaming protocol."""

    def __init__(self, jobs: Sequence[JobSpec]) -> None:
        self._jobs = sorted(jobs, key=lambda j: (j.arrival, j.job_id))

    def arrivals(self) -> Iterator[JobSpec]:
        return iter(self._jobs)

    def n_jobs_hint(self) -> Optional[int]:
        return len(self._jobs)


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


def is_large(job: JobSpec) -> bool:
    """A multi-server-sized job (more than 4 GPUs)."""
    return job.n_gpus > 4


def is_long(job: JobSpec) -> bool:
    """A job of more than 1,600 iterations."""
    return job.iterations > 1600
