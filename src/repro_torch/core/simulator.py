"""Event-driven cluster simulator for multi-job DDL training (port of
``repro/core/simulator.py``): the ``ClusterSimulator`` name of the engine
and the one-call :func:`simulate`.

Semantics (the paper's Algorithm 3 and Section V, exact continuous time):

* jobs arrive online, queue and are placed by a pluggable placement policy
  (Alg. 3 lines 6-13);
* GPUs may host several resident jobs (memory admission) and run one
  non-preemptive ``f``/``b`` task at a time, picked by SRSF priority
  (lines 22-30);
* each multi-server job's all-reduce is gated by a communication policy —
  AdaDUAL (lines 14-21), SRSF(n) or the k-way lookahead — and drains under
  the Eq. (5) contention model with exact piecewise-constant-rate
  integration;
* ``fusion=`` runs the WFBP bucket stream: per-bucket gated transfers
  overlap the remaining backward; ``fusion="all"`` is the paper's
  monolithic model;
* ``sched=`` picks static gang scheduling (the paper's, the default),
  preemptive SRSF or elastic resizing, ``chaos=`` injects faults, and a
  :class:`~repro_torch.core.trace.TraceSource` in place of the job list
  streams the arrivals;
* ``comm_chunks=`` splits each all-reduce into chunks gated one by one,
  ``contention_domain="link"`` reads contention per directed ring edge,
  ``observe=`` arms the observability recorder (:mod:`repro_torch.obs`),
  ``profile_phases=True`` times the engine's phases, and ``gating`` /
  ``workloads`` ``="rescan"`` run the oracle modes (see
  :mod:`repro_torch.core.engine`).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

from repro_torch.core.chaos import ChaosSpec  # noqa: F401  (re-export)
from repro_torch.core.cluster import Cluster, JobSpec
from repro_torch.core.contention import ContentionParams
from repro_torch.core.engine import (  # noqa: F401  (re-exports)
    CommTask,
    EventEngine,
    JobRun,
    SimResult,
    median,
    percentile,
)
from repro_torch.core.placement import PlacementPolicy
from repro_torch.core.schedpolicy import (  # noqa: F401  (re-exports)
    AdaDual,
    CommPolicy,
    KWayAdaDual,
    SchedPolicy,
    SrsfN,
    StaticGangPolicy,
    comm_policy_from_name,
    sched_policy_from_name,
)
from repro_torch.core.topology import Topology
from repro_torch.core.trace import TraceSource

#: The reference's name of the engine.
ClusterSimulator = EventEngine


def simulate(
    jobs: Union[Sequence[JobSpec], TraceSource],
    placement: str = "lwf",
    kappa: int = 1,
    comm: str = "ada",
    params: Optional[ContentionParams] = None,
    n_servers: int = 16,
    gpus_per_server: int = 4,
    seed: int = 0,
    fuse_fb: bool = True,
    exclusive_gpus: bool = False,
    bandwidth_aware_srsf: bool = False,
    topology: Optional[Topology] = None,
    fusion: object = "all",
    gpu_mem_mb: float = 16160.0,
    max_time: float = math.inf,
    **engine_kw,
) -> SimResult:
    """One simulation with string-configured policies.

    comm: 'ada' (AdaDUAL), 'srsfN' or 'kwayK'; placement: 'rand' | 'ff' |
    'ls' | 'lwf' | 'lwf_rack' (``topology`` supplies the racks); fusion:
    'all' | 'none' | a byte threshold.  ``max_time`` cuts the run at a
    horizon (jobs still running are ``SimResult.censored``).  The other
    keywords (``sched``, ``chaos``, ``record_trace``, ``checkpoint_cost``,
    ``comm_chunks``, ``contention_domain``, ``gating``, ``workloads``,
    ``profile_phases``, ``observe``, ...) pass through to
    :class:`EventEngine`.
    """
    sim = EventEngine(
        jobs,
        cluster=Cluster(
            n_servers=n_servers,
            gpus_per_server=gpus_per_server,
            gpu_mem_mb=gpu_mem_mb,
        ),
        placement=PlacementPolicy(placement, kappa=kappa, seed=seed, topology=topology),
        comm_policy=comm_policy_from_name(comm),
        params=params,
        fuse_fb=fuse_fb,
        exclusive_gpus=exclusive_gpus,
        bandwidth_aware_srsf=bandwidth_aware_srsf,
        topology=topology,
        fusion=fusion,
        **engine_kw,
    )
    return sim.run(max_time=max_time)
