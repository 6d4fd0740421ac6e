"""Job placement algorithms (port of ``repro/core/placement.py``; paper
Section IV-A, Algorithm 1).

Given a job needing ``n`` GPUs and the current cluster state, pick the GPU
set G(J):

* ``RAND``  — uniformly random among memory-feasible GPUs (baseline).
* ``FF``    — First-Fit: first ``n`` feasible GPUs in (server, gpu) order.
* ``LS``    — List-Scheduling: top-``n`` feasible GPUs by least workload L_g.
* ``LWF-k`` — the paper's algorithm:   n <= kappa  ->  same as LS;
              n  > kappa  ->  sort *servers* by total workload L_S and take
              feasible GPUs server-by-server (consolidation), Alg. 1 lines
              10-21.
* ``LWF_RACK-k`` — beyond-paper, topology-aware LWF: racks (from
              ``core/topology.py``) are ordered by total rack workload and
              filled one at a time, servers within a rack in LWF order, so
              a job that fits inside a rack never crosses its (possibly
              oversubscribed) uplink.  Without a topology it degenerates to
              plain LWF (one rack = the whole cluster).

All functions return a list of GpuIds (len == n) or ``None`` when the job
cannot be admitted (Alg. 1 line 22 returns the empty set).  They never
mutate the cluster — the simulator commits via ``Cluster.place``.
"""

from __future__ import annotations

import heapq
import random
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.cluster import Cluster, GpuId, GpuState, JobSpec
from repro_torch.core.topology import Topology


def _feasible(cluster: Cluster, job: JobSpec) -> List[GpuState]:
    return cluster.available_gpus(job.model.mem_mb)


def _feasible_indexed(cluster: Cluster, job: JobSpec, index) -> List[GpuState]:
    """``cluster.available_gpus`` with whole-server skips from the
    maintained feasibility aggregates — same GPUs in the same (server,
    gpu) order (a skipped server contributes exactly zero feasible GPUs,
    so the surviving concatenation is identical)."""
    mem = job.model.mem_mb
    excl = cluster.exclusive
    out: List[GpuState] = []
    for s in range(cluster.n_servers):
        mf, mfe = index.server_feas(s)
        if (mfe if excl else mf) < mem:
            continue
        for g in cluster.gpus_of_server(s):
            if (
                not g.down
                and g.mem_capacity_mb - g.mem_used_mb >= mem
                and not (excl and g.resident_jobs)
            ):
                out.append(g)
    return out


def place_random(cluster: Cluster, job: JobSpec, rng: random.Random) -> Optional[List[GpuId]]:
    avail = _feasible(cluster, job)
    if len(avail) < job.n_gpus:
        return None
    return [g.gpu_id for g in rng.sample(avail, job.n_gpus)]


def place_first_fit(cluster: Cluster, job: JobSpec) -> Optional[List[GpuId]]:
    avail = sorted(_feasible(cluster, job), key=lambda g: g.gpu_id)
    if len(avail) < job.n_gpus:
        return None
    return [g.gpu_id for g in avail[: job.n_gpus]]


def place_list_scheduling(
    cluster: Cluster, job: JobSpec, index=None
) -> Optional[List[GpuId]]:
    n = job.n_gpus
    if index is not None:
        avail = _feasible_indexed(cluster, job, index)
        if len(avail) < n:
            return None
        # documented equivalent of sorted(avail, key=...)[:n], without
        # sorting the whole candidate list for a 1-2 GPU gang
        top = heapq.nsmallest(n, avail, key=lambda g: (g.workload, g.gpu_id))
        return [g.gpu_id for g in top]
    avail = _feasible(cluster, job)
    if len(avail) < n:
        return None
    avail.sort(key=lambda g: (g.workload, g.gpu_id))
    return [g.gpu_id for g in avail[:n]]


def place_lwf(
    cluster: Cluster, job: JobSpec, kappa: int = 1, index=None
) -> Optional[List[GpuId]]:
    """Algorithm 1 (LWF-kappa): the one-rack special case of
    :func:`place_lwf_rack` — least-loaded servers first (lines 10-21),
    global least-workload-first for small jobs (lines 2-9)."""
    return place_lwf_rack(cluster, job, (tuple(range(cluster.n_servers)),), kappa, index)


def place_lwf_rack(
    cluster: Cluster,
    job: JobSpec,
    racks: Sequence[Sequence[int]],
    kappa: int = 1,
    index=None,
) -> Optional[List[GpuId]]:
    """Rack-locality-aware LWF-kappa: least-loaded *racks* first, then LWF
    server order within each rack.  Filling a whole rack before touching the
    next keeps jobs that fit inside one rack off the rack uplink — the
    placement-side answer to oversubscribed two-tier fabrics.

    With a :class:`~repro_torch.core.clusterindex.ClusterIndex` the scan reads
    the maintained server/rack loads instead of re-summing every GPU, and
    stops as soon as ``n`` feasible GPUs are collected — the gang is the
    first-``n`` prefix of the full ordering, so the result is identical.
    """
    n = job.n_gpus
    if n <= kappa:
        return place_list_scheduling(cluster, job, index)
    if index is not None:
        return _place_lwf_rack_indexed(cluster, job, racks, index)
    # one workload sum per server per call (the sort keys previously
    # recomputed the per-server sum for every key evaluation; identical
    # values, identical ordering)
    load = [cluster.server_workload(s) for s in range(cluster.n_servers)]
    rack_order = sorted(
        range(len(racks)),
        key=lambda r: (sum(load[s] for s in racks[r]), r),
    )
    ordered: List[GpuState] = []
    for r in rack_order:
        servers = sorted(racks[r], key=lambda s: (load[s], s))
        for s in servers:
            gpus = [
                g
                for g in cluster.gpus_of_server(s)
                if not g.down
                and g.mem_free_mb() >= job.model.mem_mb
                and not (cluster.exclusive and g.resident_jobs)
            ]
            gpus.sort(key=lambda g: (g.workload, g.gpu_id))
            ordered.extend(gpus)
    if len(ordered) < n:
        return None
    return [g.gpu_id for g in ordered[:n]]


def _place_lwf_rack_indexed(
    cluster: Cluster,
    job: JobSpec,
    racks: Sequence[Sequence[int]],
    index,
) -> Optional[List[GpuId]]:
    """Index-backed LWF-rack scan: identical rack/server/GPU ordering from
    the maintained aggregates, early exit at ``n`` collected GPUs, and
    whole-server feasibility skips (a skipped server would contribute no
    GPUs, so skipping cannot change the prefix — nor the ``None`` case,
    which still requires visiting every rack)."""
    n = job.n_gpus
    mem = job.model.mem_mb
    excl = cluster.exclusive
    load = index.server_loads()
    rack_load = index.rack_loads(racks)
    rack_order = sorted(range(len(racks)), key=lambda r: (rack_load[r], r))
    ordered: List[GpuState] = []
    for r in rack_order:
        for s in sorted(racks[r], key=lambda s: (load[s], s)):
            mf, mfe = index.server_feas(s)
            if (mfe if excl else mf) < mem:
                continue
            gpus = [
                g
                for g in cluster.gpus_of_server(s)
                if not g.down
                and g.mem_capacity_mb - g.mem_used_mb >= mem
                and not (excl and g.resident_jobs)
            ]
            if not gpus:
                continue
            gpus.sort(key=lambda g: (g.workload, g.gpu_id))
            ordered.extend(gpus)
            if len(ordered) >= n:
                return [g.gpu_id for g in ordered[:n]]
    return None


class PlacementPolicy:
    """Callable wrapper so the simulator takes one pluggable object.

    ``topology`` supplies the rack grouping for ``lwf_rack``; without one,
    every server shares one rack and ``lwf_rack`` degenerates to ``lwf``.
    """

    def __init__(
        self,
        name: str,
        kappa: int = 1,
        seed: int = 0,
        topology: Optional[Topology] = None,
    ) -> None:
        name = name.lower()
        if name not in ("rand", "ff", "ls", "lwf", "lwf_rack"):
            raise ValueError(f"unknown placement policy {name!r}")
        self.name = name
        self.kappa = kappa
        self.topology = topology
        self._rng = random.Random(seed)
        #: a ClusterIndex (core/clusterindex.py) bound by the engine —
        #: enables the maintained-aggregate scan variants; None (a policy
        #: called outside an engine) = the full-rescan arithmetic
        self.index = None

    def _racks(self, cluster: Cluster) -> Tuple[Tuple[int, ...], ...]:
        if self.topology is not None:
            return self.topology.rack_groups()
        return (tuple(range(cluster.n_servers)),)

    def __call__(self, cluster: Cluster, job: JobSpec) -> Optional[List[GpuId]]:
        if self.name == "rand":
            return place_random(cluster, job, self._rng)
        if self.name == "ff":
            return place_first_fit(cluster, job)
        if self.name == "ls":
            return place_list_scheduling(cluster, job, self.index)
        if self.name == "lwf_rack":
            return place_lwf_rack(
                cluster, job, self._racks(cluster), self.kappa, self.index
            )
        return place_lwf(cluster, job, self.kappa, self.index)

    def __repr__(self) -> str:
        if self.name == "lwf":
            return f"LWF-{self.kappa}"
        if self.name == "lwf_rack":
            return f"LWF_RACK-{self.kappa}"
        return self.name.upper()
