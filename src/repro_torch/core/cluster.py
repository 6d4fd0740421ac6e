"""Job descriptions and cluster state (port of ``repro/core/cluster.py``).

The cluster is ``N_s`` servers x ``N_g`` GPUs; each GPU has a memory
capacity and may host several resident jobs (admission by memory,
Alg. 1 line 3) that time-share it at task granularity.  The event engine
(:mod:`repro_torch.core.engine`) reads and mutates it, its fault injection
(:mod:`repro_torch.core.chaos`) through each GPU's ``down`` flag; the fluid
path reads only the job descriptions.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple


@dataclasses.dataclass(frozen=True)
class ModelProfile:
    """Measured per-model constants (paper Table III, Tesla V100, PyTorch):
    ``t_f``/``t_b`` seconds per iteration at ``batch_size``, ``size_bytes``
    the gradient message, ``mem_mb`` the GPU memory footprint.

    ``layer_grad_bytes``/``layer_t_b`` optionally resolve the gradient
    message and the backward pass to layers, in backward-ready order
    (output layer first), for the WFBP bucket stream
    (:mod:`repro_torch.workloads` derives them from model configs).  Empty
    tuples (Table III) mean the monolithic iteration-level model."""

    name: str
    size_bytes: float
    mem_mb: float
    batch_size: int
    t_f: float
    t_b: float
    layer_grad_bytes: Tuple[float, ...] = ()
    layer_t_b: Tuple[float, ...] = ()

    def __post_init__(self) -> None:
        if len(self.layer_grad_bytes) != len(self.layer_t_b):
            raise ValueError(
                f"{self.name}: layer_grad_bytes ({len(self.layer_grad_bytes)}) "
                f"and layer_t_b ({len(self.layer_t_b)}) must align"
            )

    @property
    def t_iter_compute(self) -> float:
        return self.t_f + self.t_b

    @property
    def has_layers(self) -> bool:
        return bool(self.layer_grad_bytes)


# Paper Table III.
TABLE_III = {
    "vgg16": ModelProfile("vgg16", 526.4e6, 4527.0, 16, 35.8e-3, 53.7e-3),
    "resnet50": ModelProfile("resnet50", 99.2e6, 3213.0, 16, 25.0e-3, 37.4e-3),
    "inception_v3": ModelProfile("inception_v3", 103.0e6, 3291.0, 16, 34.9e-3, 52.4e-3),
    "lstm_ptb": ModelProfile("lstm_ptb", 251.8e6, 2751.0, 64, 31.5e-3, 47.3e-3),
}


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """One DDL training job (Table II: arrival A_k, |G(J_k)| GPUs, I_k
    iterations and the model).  ``min_gpus``/``max_gpus`` declare an
    elastic job for the event engine's elastic policy; the fluid path runs
    every job as a rigid gang of ``n_gpus``."""

    job_id: int
    arrival: float
    n_gpus: int
    iterations: int
    model: ModelProfile
    min_gpus: Optional[int] = None
    max_gpus: Optional[int] = None

    def __post_init__(self) -> None:
        lo, hi = self.gpu_bounds
        if not (1 <= lo <= self.n_gpus <= hi):
            raise ValueError(
                f"job {self.job_id}: elastic bounds must satisfy "
                f"1 <= min_gpus <= n_gpus <= max_gpus, got "
                f"({self.min_gpus}, {self.n_gpus}, {self.max_gpus})"
            )

    @property
    def gpu_bounds(self) -> Tuple[int, int]:
        """(lo, hi) world-size bounds; unset bounds default to the rigid
        ``n_gpus``."""
        lo = self.min_gpus if self.min_gpus is not None else self.n_gpus
        hi = self.max_gpus if self.max_gpus is not None else self.n_gpus
        return lo, hi

    @property
    def is_elastic(self) -> bool:
        return self.gpu_bounds != (self.n_gpus, self.n_gpus)

    @property
    def total_samples(self) -> int:
        """Total work in per-GPU batches (``iterations x n_gpus``)."""
        return self.iterations * self.n_gpus

    @property
    def compute_time(self) -> float:
        """C_J (Eq. 7): total compute time of the whole job."""
        return self.model.t_iter_compute * self.iterations

    def comm_time(self, n_servers: int, a: float, b: float) -> float:
        """E_J (Eq. 8): total contention-free communication time."""
        if n_servers <= 1:
            return 0.0
        return (a + b * self.model.size_bytes) * self.iterations

    def initial_workload(self, n_servers_hint: int, a: float, b: float) -> float:
        """L_J = (C_J + E_J) * |G(J)| (Alg. 1/3 initialization); the paper
        sets E_J = 0 before placement (``n_servers_hint=1``)."""
        return (self.compute_time + self.comm_time(n_servers_hint, a, b)) * self.n_gpus


# ---------------------------------------------------------------------------
# Cluster state (the event engine's)
# ---------------------------------------------------------------------------

GpuId = Tuple[int, int]  # (server index, gpu index)


@dataclasses.dataclass
class GpuState:
    """One GPU: memory admission and remaining-workload bookkeeping (L_g)."""

    server: int
    index: int
    mem_capacity_mb: float
    mem_used_mb: float = 0.0
    #: Alg. 1's L_{g_{i,j}}, maintained by the engine
    workload: float = 0.0
    #: job ids resident on this GPU (admitted by memory)
    resident_jobs: Set[int] = dataclasses.field(default_factory=set)
    #: busy with a compute task until this time (None = idle)
    busy_until: Optional[float] = None
    busy_job: Optional[int] = None
    #: total busy seconds (the utilization metric)
    busy_accum: float = 0.0
    #: the server is broken down (fault injection): left out of every
    #: placement and of compute scheduling until repair
    down: bool = False

    @property
    def gpu_id(self) -> GpuId:
        return (self.server, self.index)

    def mem_free_mb(self) -> float:
        return self.mem_capacity_mb - self.mem_used_mb


class Cluster:
    """N_s servers x N_g GPUs with one shared network per server."""

    def __init__(
        self,
        n_servers: int = 16,
        gpus_per_server: int = 4,
        gpu_mem_mb: float = 16160.0,
    ) -> None:
        self.n_servers = n_servers
        self.gpus_per_server = gpus_per_server
        self.gpus: Dict[GpuId, GpuState] = {
            (s, g): GpuState(s, g, gpu_mem_mb)
            for s in range(n_servers)
            for g in range(gpus_per_server)
        }
        # static grouping, built once (the innermost call of every LWF scan)
        self._server_gpus: List[List[GpuState]] = [
            [self.gpus[(s, g)] for g in range(gpus_per_server)]
            for s in range(n_servers)
        ]
        #: bumped whenever placeable capacity can have grown (a release):
        #: a failed-placement memo keyed on it stays valid across events
        self.capacity_epoch: int = 0

    #: True: a GPU hosts at most one job (paper assumption 3); False: jobs
    #: share GPUs by memory admission (Alg. 1 line 3)
    exclusive: bool = False

    def gpus_of_server(self, server: int) -> List[GpuState]:
        """Per-server GpuState list (shared cached list — do not mutate)."""
        return self._server_gpus[server]

    def server_workload(self, server: int) -> float:
        """L_{S_i} = sum_j L_{g_{i,j}}."""
        return sum(g.workload for g in self.gpus_of_server(server))

    def available_gpus(self, mem_required_mb: float) -> List[GpuState]:
        """GPUs with enough rest memory (Alg. 1 lines 3/14)."""
        return [
            g
            for g in self.gpus.values()
            if not g.down
            and g.mem_free_mb() >= mem_required_mb
            and not (self.exclusive and g.resident_jobs)
        ]

    def servers_of(self, gpu_ids: Sequence[GpuId]) -> Set[int]:
        return {s for (s, _) in gpu_ids}

    def place(self, job: JobSpec, gpu_ids: Sequence[GpuId], workload_share: float) -> None:
        """Commit a placement: admit memory and add the job's workload to
        each chosen GPU (Alg. 1 lines 6/18)."""
        for gid in gpu_ids:
            g = self.gpus[gid]
            if g.mem_free_mb() < job.model.mem_mb:
                raise RuntimeError(f"placement violates memory on {gid}")
            g.mem_used_mb += job.model.mem_mb
            g.workload += workload_share
            g.resident_jobs.add(job.job_id)

    def release(self, job: JobSpec, gpu_ids: Sequence[GpuId]) -> None:
        for gid in gpu_ids:
            g = self.gpus[gid]
            g.mem_used_mb -= job.model.mem_mb
            g.resident_jobs.discard(job.job_id)
        self.capacity_epoch += 1
