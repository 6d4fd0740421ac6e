"""Event engine for multi-job DDL cluster simulation (port of
``repro/core/engine.py``; paper Algorithm 3 and Section V, exact
continuous-time variant).

The engine owns the mechanism: the event calendar, cluster/GPU occupancy,
the communication streams (Eq. 5 contention with exact piecewise-constant-
rate integration, WFBP bucket pipelines, topology domain sets), the task
trace and result collection.  Every job-level decision (admit, place,
preempt, resize) goes to a :class:`~repro_torch.core.schedpolicy.SchedPolicy`
through its hooks, which act through a small decision API:

* :meth:`EventEngine.place_job` commits a gang placement (the WFBP fusion
  plan and topology domain sets of the placed world);
* :meth:`EventEngine.preempt_job` tears a running gang down atomically:
  its in-flight compute and communication are cancelled, its memory is
  released, its completed iterations are carried and it is requeued (the
  iteration in progress is lost; the next placement pays the
  checkpoint/restore penalty :func:`repro_torch.core.netmodel.preemption_cost`);
* :meth:`EventEngine.request_resize` asks for an elastic world-size change,
  applied at the job's next iteration boundary.

Fault injection (:mod:`repro_torch.core.chaos`): a :class:`ChaosSpec` arms
server breakdown/repair (a breakdown preempts every gang on the dead
server, whose GPUs are unplaceable until repair), NIC degradation windows
(per-server bandwidth multipliers, integrated exactly), straggler jitter
per iteration and stochastic cancellation.  A :class:`TraceSource` in
place of the job list streams the arrivals, one ahead in the calendar.
``record_trace=True`` records every task as ``(job, iteration, kind,
worker, t0, t1)`` (with the preempt, resize and cancel markers), the
schedule :mod:`repro_torch.core.dag` validates.

``comm_chunks > 1`` splits each monolithic all-reduce into chunks gated
one by one (each pays the latency ``a``; a chunk boundary is a preemption
point of the link).  ``contention_domain="link"`` reads contention per
directed ring edge (:class:`~repro_torch.core.topology.RingEdgeTopology`)
instead of per NIC.  ``observe=ObsConfig(...)`` arms the observability
recorder (:mod:`repro_torch.obs`): the exact per-job JCT decomposition,
per-domain timelines, the gating audit and the Perfetto spans in
``SimResult.obs``; it only watches, so an observed run is bit-exact with
an unobserved one.  ``profile_phases=True`` sums wall seconds per engine
phase into ``SimResult.phase_seconds``.  ``gating`` and ``workloads``
pick the incremental modes (the default, or ``REPRO_GATING`` /
``REPRO_WORKLOADS``) or the ``"rescan"`` oracles they are held to: every
waiter evaluated on every event, and the zero-and-rebuild workload walk
with the whole-queue admission scan.

It is plain Python on Python floats, in the reference's order of
operations, so a run gives the reference's event stream and results bit
for bit.  It holds no tensors.

Progress is counted in samples (per-GPU batches): a job's work is
``iterations x n_gpus`` and each completed iteration contributes its world
size, so elastic resizes conserve the work.  Jobs still running or queued
when ``run(max_time=...)`` stops are reported as ``SimResult.censored``.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
import os
import time
from bisect import insort
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple, Union

from repro_torch.core import netmodel
from repro_torch.core.chaos import (
    ChaosSpec,
    cancel_time,
    jitter_factor,
    nic_degradation_stream,
    server_failure_stream,
)
from repro_torch.core.cluster import Cluster, GpuId, JobSpec
from repro_torch.core.clusterindex import ClusterIndex
from repro_torch.core.contention import ContentionParams
from repro_torch.core.placement import PlacementPolicy
from repro_torch.core.schedpolicy import (
    AdaDual,
    CommPolicy,
    SchedPolicy,
    StaticGangPolicy,
    sched_policy_from_name,
)
from repro_torch.core.topology import RingEdgeTopology, Topology, nic_topology
from repro_torch.core.trace import TraceSource
from repro_torch.obs.recorder import ObsRecorder

_EPS = 1e-9


# ---------------------------------------------------------------------------
# Runtime state
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CommTask:
    job_id: int
    servers: Set[int]
    remaining_bytes: float
    latency_left: float  # the fixed 'a' consumed in wall time before draining
    #: contention domains this task loads: topology domain indices (the
    #: fabric cuts its ring crosses) or, under the "link" reading, the
    #: directed ring edges themselves
    domains: frozenset = frozenset()
    #: WFBP bucket index this transfer carries (-1 = the monolithic
    #: iteration-level all-reduce)
    bucket: int = -1
    #: start order: sorting any task subset by ``seq`` reproduces the
    #: insertion order of ``_active_comm``
    seq: int = -1


@dataclasses.dataclass
class JobRun:
    spec: JobSpec
    gpus: List[GpuId]
    servers: Set[int]
    placed_at: float
    #: contention domains this placement's ring loads (computed once)
    domains: frozenset = frozenset()
    iter_done: int = 0
    # per-worker progress within the current iteration
    f_done: Set[int] = dataclasses.field(default_factory=set)
    b_done: Set[int] = dataclasses.field(default_factory=set)
    comm_ready_at: Optional[float] = None  # all-reduce ready, not yet started
    comm_active: bool = False
    #: chunks of the current iteration's all-reduce still to send
    comm_chunks_left: int = 0
    #: WFBP fusion plan ``(bucket_bytes, bucket_t_b)`` from
    #: ``netmodel.fusion_plan``; None = the monolithic all-reduce
    plan: Optional[Tuple[Tuple[float, ...], Tuple[float, ...]]] = None
    #: WFBP per-worker backward progress: completed segments (len n_world)
    b_prog: List[int] = dataclasses.field(default_factory=list)
    #: WFBP comm pipeline: next bucket for the FIFO comm stream, buckets done
    next_bucket: int = 0
    buckets_done: int = 0
    finished_at: Optional[float] = None
    #: progress in samples: total work (conserved across preemptions and
    #: resizes) and the part done
    samples_total: int = 0
    samples_done: int = 0
    #: iterations this incarnation will have completed when the remaining
    #: samples drain at its world size (None = ``spec.iterations``)
    target_iters: Optional[int] = None
    #: workers that still owe the checkpoint-restore penalty (charged on
    #: each one's first compute task after a preemption or resize)
    restore_need: Set[int] = dataclasses.field(default_factory=set)
    restore_cost: float = 0.0
    #: elastic world size requested for the next iteration boundary
    pending_resize: Optional[int] = None
    #: memo of the nominal per-iteration service time
    _svc_cache: Optional[tuple] = dataclasses.field(default=None, repr=False, compare=False)
    #: memo of the SRSF key, valid while ``iter_done`` and the engine's
    #: service epoch are unchanged
    _key_cache: Optional[tuple] = dataclasses.field(default=None, repr=False, compare=False)
    #: lazily-built gpu -> worker-rank map
    _worker_of: Optional[Dict[GpuId, int]] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    def __post_init__(self) -> None:
        if self.samples_total == 0:
            self.samples_total = self.spec.total_samples

    @property
    def n_world(self) -> int:
        return len(self.gpus)

    @property
    def has_comm(self) -> bool:
        return len(self.servers) > 1

    @property
    def n_buckets(self) -> int:
        return len(self.plan[0]) if self.plan is not None else 1

    @property
    def _target(self) -> int:
        return self.target_iters if self.target_iters is not None else self.spec.iterations

    def per_iter_service(
        self, params: ContentionParams, bandwidth_aware: bool = False
    ) -> float:
        """Per-iteration service time: compute + contention-free comm (the
        latency ``a`` once per WFBP bucket).  ``bandwidth_aware`` divides
        the per-byte term by the slowest member NIC's multiplier."""
        if not bandwidth_aware:
            key = (len(self.servers) > 1, self.n_buckets, params.a, params.b)
            cached = self._svc_cache
            if cached is not None and cached[0] == key:
                return cached[1]
        t = self.spec.model.t_iter_compute
        if self.has_comm:
            scale = params.bandwidth_scale(self.servers) if bandwidth_aware else 1.0
            t += self.n_buckets * params.a + params.b * self.spec.model.size_bytes / scale
        if not bandwidth_aware:
            self._svc_cache = (key, t)
        return t

    def remaining_service(
        self, params: ContentionParams, bandwidth_aware: bool = False
    ) -> float:
        """SRSF key: remaining time x allocated GPUs (Tiresias-style)."""
        rem_iters = self._target - self.iter_done
        return rem_iters * self.per_iter_service(params, bandwidth_aware) * self.n_world


@dataclasses.dataclass(frozen=True)
class _Carry:
    """Progress of a preempted or resized job between placements."""

    iter_done: int
    samples_done: int
    samples_total: int
    restore_cost: float


def median(xs: Sequence[float]) -> float:
    """Median (mean of the middle two for even-length lists)."""
    if not xs:
        return math.nan
    ys = sorted(xs)
    n = len(ys)
    return ys[n // 2] if n % 2 else 0.5 * (ys[n // 2 - 1] + ys[n // 2])


def percentile(xs: Sequence[float], q: float) -> float:
    """Nearest-rank percentile, q in [0, 1]."""
    if not xs:
        return math.nan
    ys = sorted(xs)
    idx = min(len(ys) - 1, int(math.ceil(q * len(ys))) - 1)
    return ys[max(0, idx)]


@dataclasses.dataclass
class SimResult:
    """The reference's result record, field for field."""

    policy_name: str
    placement_name: str
    jct: Dict[int, float]  # job_id -> completion - arrival
    finish: Dict[int, float]
    makespan: float
    gpu_busy: Dict[GpuId, float]
    gpu_util: float  # mean busy fraction over makespan
    queueing_delay: Dict[int, float]
    events_processed: int
    comm_started_contended: int
    comm_started_clean: int
    #: high-water mark of the event calendar (with a job list every arrival
    #: is pushed up front, so >= n_jobs; a streamed feed keeps one ahead)
    peak_calendar: int = 0
    sched_name: str = "static"
    #: jobs that entered and have no finish time (horizon cutoff, or never
    #: placeable); cancelled jobs are counted apart
    censored: int = 0
    preemptions: int = 0
    resizes: int = 0
    #: server breakdowns plus NIC degradation windows
    faults: int = 0
    cancelled: int = 0
    #: samples of in-progress work thrown away by teardowns
    work_lost_samples: int = 0
    #: delivered samples (finished or still-live jobs) per second of makespan
    goodput: float = 0.0
    #: ``record_trace=True``: (job, iteration, kind, worker, t0, t1) records
    task_trace: Optional[List[Tuple]] = None
    #: per-job delivered samples at finish time
    job_samples: Dict[int, int] = dataclasses.field(default_factory=dict)
    #: ``profile_phases=True``: wall seconds per engine phase over the run
    #: (comm_advance, dispatch, gating, gpu_schedule); None otherwise
    phase_seconds: Optional[Dict[str, float]] = None
    #: ``observe=ObsConfig(...)``: the :class:`repro_torch.obs.ObsReport`;
    #: None otherwise
    obs: Optional[object] = None

    def avg_jct(self) -> float:
        return sum(self.jct.values()) / len(self.jct)

    def median_jct(self) -> float:
        return median(list(self.jct.values()))

    def p95_jct(self) -> float:
        return percentile(list(self.jct.values()), 0.95)

    def p99_jct(self) -> float:
        return percentile(list(self.jct.values()), 0.99)

    def windowed(self, window_s: float) -> List[Dict[str, float]]:
        """Finished jobs bucketed into ``[i*w, (i+1)*w)`` windows by finish
        time: per window ``t0``, ``t1``, ``n_finished``, ``goodput``
        (delivered samples / window_s), ``jobs_per_sec``, ``p99_jct`` and
        ``queueing_delay_mean``."""
        if window_s <= 0:
            raise ValueError(f"window_s must be positive, got {window_s}")
        if not self.finish:
            return []
        rows = sorted(
            (
                f,
                self.jct[j],
                self.queueing_delay.get(j, 0.0),
                self.job_samples.get(j, 0),
            )
            for j, f in self.finish.items()
        )
        n_win = int(self.makespan // window_s) + 1
        out: List[Dict[str, float]] = []
        i = 0
        for w in range(n_win):
            t0, t1 = w * window_s, (w + 1) * window_s
            jcts: List[float] = []
            qds: List[float] = []
            samples = 0
            while i < len(rows) and rows[i][0] < t1:
                _, jct, qd, s = rows[i]
                jcts.append(jct)
                qds.append(qd)
                samples += s
                i += 1
            out.append(
                {
                    "t0": t0,
                    "t1": t1,
                    "n_finished": float(len(jcts)),
                    "goodput": samples / window_s,
                    "jobs_per_sec": len(jcts) / window_s,
                    "p99_jct": percentile(jcts, 0.99),
                    "queueing_delay_mean": (
                        sum(qds) / len(qds) if qds else math.nan
                    ),
                }
            )
        return out

    def steady_state(
        self, window_s: float, warmup_frac: float = 0.1
    ) -> Dict[str, float]:
        """Drop the warmup prefix (``warmup_frac`` of the makespan) and the
        trailing partial window, then summarize the body windows: medians
        of goodput and finish rate, nearest-rank tails of JCT and queueing
        delay over the jobs finishing inside the body."""
        wins = self.windowed(window_s)
        if not wins:
            return {}
        warmup_t = warmup_frac * self.makespan
        body = [w for w in wins[:-1] if w["t0"] >= warmup_t] or wins
        t_lo, t_hi = body[0]["t0"], body[-1]["t1"]
        jcts = [self.jct[j] for j, f in self.finish.items() if t_lo <= f < t_hi]
        qds = [
            self.queueing_delay.get(j, 0.0)
            for j, f in self.finish.items()
            if t_lo <= f < t_hi
        ]
        return {
            "window_s": window_s,
            "t_lo": t_lo,
            "t_hi": t_hi,
            "n_windows": float(len(body)),
            "n_jobs": float(len(jcts)),
            "sustained_goodput": median([w["goodput"] for w in body]),
            "sustained_jobs_per_sec": median([w["jobs_per_sec"] for w in body]),
            "p99_jct": percentile(jcts, 0.99),
            "queueing_delay_mean": sum(qds) / len(qds) if qds else math.nan,
            "queueing_delay_p99": percentile(qds, 0.99),
        }


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


class EventEngine:
    """Exact event-driven simulation of Algorithm 3's dynamics, with every
    job-level decision delegated to a :class:`SchedPolicy`."""

    def __init__(
        self,
        jobs: Union[Sequence[JobSpec], TraceSource],
        cluster: Optional[Cluster] = None,
        placement: Optional[PlacementPolicy] = None,
        comm_policy: Optional[CommPolicy] = None,
        params: Optional[ContentionParams] = None,
        fuse_fb: bool = True,
        record_trace: bool = False,
        comm_chunks: int = 1,
        contention_domain: str = "server",
        exclusive_gpus: bool = False,
        bandwidth_aware_srsf: bool = False,
        topology: Optional[Topology] = None,
        fusion: object = "all",
        sched: Union[SchedPolicy, str, None] = None,
        preemption_quantum: Optional[float] = None,
        checkpoint_cost: Optional[float] = None,
        chaos: Optional[ChaosSpec] = None,
        gating: Optional[str] = None,
        workloads: Optional[str] = None,
        profile_phases: bool = False,
        observe: Optional[object] = None,
    ) -> None:
        # A streamed feed keeps one future arrival in the calendar; a job
        # list pushes every arrival up front
        if isinstance(jobs, TraceSource):
            self._source: Optional[TraceSource] = jobs
            self.jobs: Dict[int, JobSpec] = {}
        else:
            self._source = None
            self.jobs = {j.job_id: j for j in jobs}
        self.cluster = cluster or Cluster()
        self.placement = placement or PlacementPolicy("lwf", kappa=1)
        self.comm_policy = comm_policy or AdaDual()
        self.params = params or ContentionParams()
        # Fusing f+b into one GPU occupancy halves the event count; a newly
        # placed higher-priority job can then take the GPU only at (f+b)
        # boundaries.  A recorded trace keeps f and b apart.
        self.fuse_fb = fuse_fb and not record_trace
        self.record_trace = record_trace
        # chunked all-reduce: each chunk is gated on its own, so a long
        # transfer can lose the link at every chunk boundary; each chunk
        # pays the latency a
        self.comm_chunks = max(1, comm_chunks)
        # WFBP tensor fusion: 'all' = one monolithic all-reduce per
        # iteration (the paper's model); 'none' / a byte threshold =
        # per-bucket transfers that overlap the remaining backward pass,
        # gated per bucket, for models that carry layer data.
        self._fusion_threshold = netmodel.fusion_threshold(fusion)
        self.fusion = fusion
        self._plan_cache: Dict[int, Optional[tuple]] = {}
        if self._fusion_threshold != math.inf and self.comm_chunks > 1:
            raise ValueError(
                "comm_chunks and WFBP fusion are mutually exclusive — the "
                "fusion plan already chunks the all-reduce"
            )
        # "server": a server's NIC is the shared resource; "link": only
        # tasks sharing a directed ring edge contend (RingEdgeTopology).
        # An explicit topology supersedes the string.
        if contention_domain not in ("server", "link"):
            raise ValueError(f"unknown contention domain {contention_domain!r}")
        self.contention_domain = contention_domain
        if topology is not None and topology.n_servers != self.cluster.n_servers:
            raise ValueError(
                f"topology covers {topology.n_servers} servers, cluster has "
                f"{self.cluster.n_servers}"
            )
        if topology is None:
            topology = (
                nic_topology(self.cluster.n_servers)
                if contention_domain == "server"
                else RingEdgeTopology(self.cluster.n_servers)
            )
        self.topology = topology
        #: every domain at unit oversubscription => k_eff is the integer load
        #: (ring edges are all 1.0 and their static domain tuple is empty)
        self._uniform_oversub = all(d.oversub == 1.0 for d in topology.domains)
        self.cluster.exclusive = exclusive_gpus
        # SRSF estimate: the paper's nominal comm time, or scaled by the
        # slowest member NIC (JobRun.per_iter_service)
        self.bandwidth_aware_srsf = bandwidth_aware_srsf
        if sched is None:
            sched = StaticGangPolicy()
        elif isinstance(sched, str):
            sched = sched_policy_from_name(sched, quantum=preemption_quantum)
        self.sched = sched
        self.checkpoint_cost = checkpoint_cost
        # "incremental" gating evaluates only the waiters whose domains a
        # comm start or end touched; "rescan" (the oracle) every waiter on
        # every event.  REPRO_GATING sets the default.
        if gating is None:
            gating = os.environ.get("REPRO_GATING", "incremental")
        if gating not in ("incremental", "rescan"):
            raise ValueError(
                f"unknown gating mode {gating!r} (expected 'incremental' or "
                "'rescan')"
            )
        self.gating = gating
        # "incremental" workloads keep the ClusterIndex aggregates; "rescan"
        # (the oracle) rebuilds every GPU's workload from the live runs and
        # scans the whole queue.  REPRO_WORKLOADS sets the default.
        if workloads is None:
            workloads = os.environ.get("REPRO_WORKLOADS", "incremental")
        if workloads not in ("incremental", "rescan"):
            raise ValueError(
                f"unknown workloads mode {workloads!r} (expected "
                "'incremental' or 'rescan')"
            )
        self.workloads = workloads
        self._windex: Optional[ClusterIndex] = (
            ClusterIndex(self.cluster) if workloads == "incremental" else None
        )
        # rebinding keeps a reused placement policy on this engine's mode
        self.placement.index = self._windex
        self.profile_phases = profile_phases
        self._phase_seconds: Optional[Dict[str, float]] = (
            {"comm_advance": 0.0, "dispatch": 0.0, "gating": 0.0,
             "gpu_schedule": 0.0}
            if profile_phases
            else None
        )

        self._heap: List[Tuple[float, int, str, tuple]] = []
        self._peak_heap = 0
        self._seq = itertools.count()
        self._queue: List[int] = []  # unplaced job ids, srsf_key_queued order
        #: queued job ids grouped by resource profile ``(n_gpus, mem_mb)``,
        #: each bucket in queue order
        self._queue_buckets: Dict[tuple, List[int]] = {}
        self._queue_profile_of: Dict[int, tuple] = {}
        self._runs: Dict[int, JobRun] = {}
        #: placed-and-unfinished job ids in ``_runs`` insertion order
        self._live: Dict[int, None] = {}
        self._active_comm: Dict[int, CommTask] = {}
        #: in-flight transfers per contention domain: count and tasks (each
        #: list in start order)
        self._domain_load: Dict[object, int] = {}
        self._domain_tasks: Dict[object, List[CommTask]] = {}
        self._comm_seq = 0
        #: memo of ``params.rate(k)`` (b and eta are fixed for the run; NIC
        #: faults replace only ``server_bandwidth``)
        self._rate_cache: Dict[float, float] = {}
        #: bumped whenever NIC faults rewrite the bandwidth map: part of the
        #: SRSF key memo's validity
        self._svc_epoch = 0
        self._waiting_comm: List[int] = []  # job ids with a gated all-reduce
        self._waiting_set: Set[int] = set()
        #: incremental gating: waiters per contention domain, and waiters
        #: whose decision may have changed since their last evaluation
        self._domain_waiters: Dict[object, Set[int]] = {}
        self._gate_candidates: Set[int] = set()
        self._comm_epoch = 0
        self._last_comm_update = 0.0
        self._dirty_gpus: Set[GpuId] = set()
        self._events = 0
        self._comm_contended = 0
        self._comm_clean = 0
        self._trace: List[Tuple] = []
        self._unfinished = set(self.jobs)
        # the streamed feed: the arrival iterator, arrival events in the
        # calendar not yet processed (at most 1), the order check, the jobs
        # that entered so far, and finished runs to drop at event end
        self._stream: Optional[Iterator[JobSpec]] = None
        self._arrivals_pending = 0
        self._last_arrival = -math.inf
        self._n_seen = len(self.jobs)
        self._retire_buf: List[int] = []
        # per-job results recorded at finish time (the streamed feed drops
        # finished runs, so they cannot be collected from _runs at the end)
        self._jct_at_finish: Dict[int, float] = {}
        self._finish_at: Dict[int, float] = {}
        self._qdelay_at_finish: Dict[int, float] = {}
        self._job_samples: Dict[int, int] = {}
        # preemption and resize state
        self._carry: Dict[int, _Carry] = {}  # progress of requeued jobs
        self._epoch_of: Dict[int, int] = {}  # run incarnation (tombstones)
        self._first_placed: Dict[int, float] = {}
        self._preemptions = 0
        self._resizes = 0
        self._comm_dirty = False  # active comm set changed outside gating
        # An absent or inactive spec pushes no fault event: the event
        # stream is the unfaulted engine's, bit for bit.
        self._chaos = chaos if (chaos is not None and chaos.active) else None
        self._faults = 0
        self._cancelled = 0
        self._work_lost_samples = 0
        self._fail_streams: Dict[int, Iterator[Tuple[float, float]]] = {}
        self._nic_streams: Dict[int, Iterator[Tuple[float, float]]] = {}
        self._nic_degraded: Set[int] = set()
        self._base_server_bw: Tuple[float, ...] = ()
        # Observability: an absent or inactive config keeps every hook cold
        # (one ``is None`` test each).  The recorder never changes engine
        # state, so the event stream is the unobserved one, bit for bit.
        self._obs = (
            ObsRecorder(observe)
            if (observe is not None and observe.active)
            else None
        )
        if self._obs is not None:
            # the deferred replay needs the Eq. 5 constants and the gating
            # policy (for the audit's explain terms), fixed for the run
            self._obs.bind(self.params, self.comm_policy)
        # The densest hooks (comm windows, compute spans, audit records,
        # gating-queue enter/leave, transfer ends) are flat list extends at
        # their call sites; a None reference means that family is off.
        # The recorder's flush clears its log in place, so these stay valid.
        o = self._obs
        self._obs_win = o.log if (o is not None and o.decompose_on) else None
        self._obs_comm = o.log if (o is not None and o.log_comm) else None
        self._obs_gate = o.log if (o is not None and o.log_gate) else None
        self._obs_rc = o.raw_compute if (o is not None and o.spans_on) else None
        # raw_compute is flat at stride 6, so the element cap is 6x
        self._obs_rc_cap = o.config.span_cap * 6 if o is not None else 0
        self._obs_audit = o.audit_raw if (o is not None and o.audit_on) else None
        self._obs_audit_left = o.config.audit_cap if o is not None else 0
        self.sched.bind(self)

    # -- policy-facing state views -------------------------------------------
    @property
    def queue(self) -> List[int]:
        """Unplaced job ids in ``srsf_key_queued`` order."""
        return self._queue

    @property
    def queue_buckets(self) -> Dict[tuple, List[int]]:
        """Queued jobs grouped by ``(n_gpus, mem_mb)`` resource profile."""
        if len(self._queue_profile_of) != len(self._queue):
            self._sync_queue_buckets()
        return self._queue_buckets

    @property
    def queue_profile_of(self) -> Dict[int, tuple]:
        """Resource profile of every queued job."""
        if len(self._queue_profile_of) != len(self._queue):
            self._sync_queue_buckets()
        return self._queue_profile_of

    def _sync_queue_buckets(self) -> None:
        """Rebuild the profile indices from the queue list, where outside
        code appended to ``queue`` instead of going through ``_enqueue``."""
        self._queue_profile_of = prof = {}
        self._queue_buckets = buckets = {}
        jobs = self.jobs
        for jid in sorted(self._queue, key=self.srsf_key_queued):
            spec = jobs[jid]
            profile = (spec.n_gpus, spec.model.mem_mb)
            prof[jid] = profile
            bucket = buckets.get(profile)
            if bucket is None:
                buckets[profile] = [jid]
            else:
                bucket.append(jid)

    @property
    def runs(self) -> Dict[int, JobRun]:
        """Job runs (read-only for policies; mutate through the API)."""
        return self._runs

    # -- queue maintenance -----------------------------------------------------
    def _enqueue(self, job_id: int) -> None:
        """Insert a job into the wait queue and its profile bucket, both in
        ``srsf_key_queued`` order (the key is static while the job waits)."""
        insort(self._queue, job_id, key=self.srsf_key_queued)
        spec = self.jobs[job_id]
        profile = (spec.n_gpus, spec.model.mem_mb)
        self._queue_profile_of[job_id] = profile
        bucket = self._queue_buckets.get(profile)
        if bucket is None:
            self._queue_buckets[profile] = [job_id]
        else:
            insort(bucket, job_id, key=self.srsf_key_queued)

    def remove_queued(self, job_ids) -> None:
        """Drop placed or cancelled jobs from the wait queue and its
        profile buckets; ids not queued are ignored."""
        drop = set(job_ids)
        if not drop:
            return
        buckets = self._queue_buckets
        if len(drop) == 1:
            (jid,) = drop
            profile = self._queue_profile_of.pop(jid, None)
            if profile is None:
                return
            self._queue.remove(jid)
            bucket = buckets[profile]
            bucket.remove(jid)
            if not bucket:
                del buckets[profile]
            return
        self._queue[:] = [j for j in self._queue if j not in drop]
        for jid in drop:
            profile = self._queue_profile_of.pop(jid, None)
            if profile is None:
                continue
            bucket = buckets[profile]
            bucket.remove(jid)
            if not bucket:
                del buckets[profile]

    def _push(self, t: float, kind: str, data: tuple) -> None:
        heapq.heappush(self._heap, (t, next(self._seq), kind, data))
        if len(self._heap) > self._peak_heap:
            self._peak_heap = len(self._heap)

    # -- SRSF priority ---------------------------------------------------------
    def srsf_key_queued(self, job_id: int):
        """SRSF key of a queued job: E_J = 0 before placement (Section
        IV-A); a requeued job's key is its carried remaining work."""
        spec = self.jobs[job_id]
        carry = self._carry.get(job_id)
        if carry is None:
            rem = spec.compute_time * spec.n_gpus
        else:
            rem_samples = carry.samples_total - carry.samples_done
            rem = spec.model.t_iter_compute * rem_samples
        return (rem, spec.arrival, job_id)

    def srsf_key_running(self, job_id: int):
        run = self._runs[job_id]
        cached = run._key_cache
        if (
            cached is not None
            and cached[0] == run.iter_done
            and cached[1] == self._svc_epoch
        ):
            return cached[2]
        rem = run.remaining_service(self.params, self.bandwidth_aware_srsf)
        key = (rem, run.spec.arrival, job_id)
        run._key_cache = (run.iter_done, self._svc_epoch, key)
        return key

    # -- communication bookkeeping --------------------------------------------
    def _domains_of(self, servers: Set[int]) -> frozenset:
        """Contention domains a transfer over ``servers`` loads: the
        topology cuts its ring crosses, or, under the "link" reading, the
        directed ring edges themselves."""
        return self.topology.loaded_domains(servers)

    def _comm_started(self, task: CommTask) -> None:
        for d in task.domains:
            self._domain_load[d] = self._domain_load.get(d, 0) + 1
            self._domain_tasks.setdefault(d, []).append(task)
        self._mark_domains_dirty(task.domains)

    def _comm_ended(self, task: CommTask) -> None:
        for d in task.domains:
            left = self._domain_load[d] - 1
            if left:
                self._domain_load[d] = left
            else:
                del self._domain_load[d]
            lst = self._domain_tasks[d]
            lst.remove(task)
            if not lst:
                del self._domain_tasks[d]
        self._mark_domains_dirty(task.domains)

    def _waiter_add(self, jid: int, run: JobRun) -> None:
        """Enqueue a gated all-reduce; a fresh waiter always gets its first
        evaluation."""
        self._waiting_comm.append(jid)
        self._waiting_set.add(jid)
        for d in run.domains:
            self._domain_waiters.setdefault(d, set()).add(jid)
        self._gate_candidates.add(jid)
        lg = self._obs_gate
        if lg is not None:
            lg.extend((4, self._last_comm_update, jid))

    def _waiter_drop(self, jid: int, domains: frozenset) -> None:
        """Remove a waiter from every gating index (started, preempted or
        cancelled); ``domains`` is given since a teardown pops the run
        first."""
        self._waiting_comm.remove(jid)
        self._waiting_set.discard(jid)
        for d in domains:
            ws = self._domain_waiters.get(d)
            if ws is not None:
                ws.discard(jid)
                if not ws:
                    del self._domain_waiters[d]
        self._gate_candidates.discard(jid)
        lg = self._obs_gate
        if lg is not None:
            lg.extend((5, self._last_comm_update, jid))

    def _mark_domains_dirty(self, domains: frozenset) -> None:
        """A comm start/end/abort touched these domains: every waiter
        sharing one must be re-evaluated."""
        for d in domains:
            ws = self._domain_waiters.get(d)
            if ws:
                self._gate_candidates.update(ws)

    def _comm_k_eff(self, task: CommTask) -> float:
        """Effective contention for the Eq. (5) rate (``_comm_k_eff`` of the
        reference): the largest per-domain count times that domain's
        oversubscription, at least 1."""
        if self._uniform_oversub:
            load = self._domain_load
            k = 1
            for d in task.domains:
                v = load.get(d, 0)
                if v > k:
                    k = v
            return float(k)
        k = 1.0
        load = self._domain_load
        oversub = self.topology.oversub_of
        for d in task.domains:
            v = load.get(d, 0) * oversub(d)
            if v > k:
                k = v
        return k

    def _advance_comm(self, now: float) -> List[int]:
        """Drain every in-flight transfer from the last update to ``now`` at
        the rates of the window's start (the active set changes only at
        events, so this is exact piecewise-rate integration).  Returns the
        job ids whose transfer completed."""
        dt = now - self._last_comm_update
        self._last_comm_update = now
        finished: List[int] = []
        if dt <= 0 or not self._active_comm:
            return finished
        lg = self._obs_win
        ks: Optional[Dict[int, float]] = None
        if lg is not None:
            # the window's per-task contention, logged before the drain
            # consumes latency_left (the replay consumes it the same way);
            # flat: 0, dt, n, the n job ids, the n k values
            ks = {jid: self._comm_k_eff(t) for jid, t in self._active_comm.items()}
            lg.extend((0, dt, len(ks)))
            lg.extend(ks)
            lg.extend(ks.values())
            if len(lg) >= self._obs.flush_at:
                self._obs._flush()
        params = self.params
        bw_uniform = not params.server_bandwidth
        rcache = self._rate_cache
        for jid, task in self._active_comm.items():
            ll = task.latency_left
            if ll < dt:
                task.latency_left = 0.0
                # loads are constant in this loop: the same k as the dict's
                k = ks[jid] if ks is not None else self._comm_k_eff(task)
                rate = rcache.get(k)
                if rate is None:
                    rate = params.rate(k)
                    rcache[k] = rate
                if not bw_uniform:
                    rate *= params.bandwidth_scale(task.servers)
                task.remaining_bytes -= (dt - ll) * rate
                if task.remaining_bytes <= 1.0:
                    # 1 byte ~ 1e-9 s absorbs drift of the integration
                    finished.append(jid)
            else:
                # pure-latency window: no drain
                task.latency_left = ll - dt
                if task.latency_left <= _EPS and task.remaining_bytes <= 1.0:
                    finished.append(jid)
        lg = self._obs_comm
        for jid in finished:
            self._comm_ended(self._active_comm[jid])
            del self._active_comm[jid]
            if lg is not None:
                lg.extend((2, now, jid))
        return finished

    def _next_comm_finish(self) -> Optional[float]:
        if not self._active_comm:
            return None
        t_min = math.inf
        params = self.params
        bw_uniform = not params.server_bandwidth
        rcache = self._rate_cache
        base = self._last_comm_update
        for task in self._active_comm.values():
            k = self._comm_k_eff(task)
            rate = rcache.get(k)
            if rate is None:
                rate = params.rate(k)
                rcache[k] = rate
            if not bw_uniform:
                rate *= params.bandwidth_scale(task.servers)
            t = base + task.latency_left + task.remaining_bytes / rate
            if t < t_min:
                t_min = t
        return t_min

    def _reschedule_comm_check(self) -> None:
        self._comm_epoch += 1
        t = self._next_comm_finish()
        if t is not None:
            self._push(t, "comm_check", (self._comm_epoch,))

    def _abort_comm(self, job_id: int) -> None:
        """Abort ``job_id``'s in-flight all-reduce (preemption, breakdown,
        cancellation).  ``_comm_dirty`` makes the main loop re-predict the
        survivors' finish times and re-run gating over every waiter in the
        same event: a waiter gated against the aborted transfer starts at
        the abort instant."""
        task = self._active_comm.pop(job_id)
        self._comm_ended(task)
        self._comm_dirty = True
        if self._obs is not None:
            # the aborted transfer's comm time delivered nothing: the
            # replay moves it to the preemption/fault overhead
            self._obs.comm_abort(job_id, self._last_comm_update)

    # -- WFBP fusion plans -------------------------------------------------------
    def _assign_plan(self, run: JobRun) -> None:
        """Attach the WFBP fusion plan when fusion is finite, the model
        carries layer data and the placement spans servers; otherwise the
        monolithic path (plan None)."""
        if self._fusion_threshold == math.inf or not run.has_comm:
            return
        model = run.spec.model
        if not model.has_layers:
            return
        key = id(model)
        if key not in self._plan_cache:
            self._plan_cache[key] = netmodel.fusion_plan(
                model.layer_grad_bytes, model.layer_t_b, self._fusion_threshold
            )
        run.plan = self._plan_cache[key]
        run.b_prog = [0] * run.n_world

    def _maybe_enqueue_bucket(self, run: JobRun) -> None:
        """Hand the next WFBP bucket to the gating queue once every worker
        finished its backward segment and the job's comm stream is free
        (buckets serialize FIFO, the PyTorch-DDP model)."""
        jid = run.spec.job_id
        if run.comm_active or jid in self._waiting_set:
            return
        if run.next_bucket >= run.n_buckets:
            return
        if run.next_bucket < min(run.b_prog):
            self._waiter_add(jid, run)

    # -- the decision API (called by SchedPolicy hooks) ------------------------
    def refresh_workloads(self) -> None:
        """Alg. 3 line 3: every GPU's remaining workload L_g.  Incremental
        mode re-folds the GPUs a release or an iteration boundary touched
        (the same values in the same order); the rescan rebuilds all."""
        if self._windex is not None:
            self._windex.refresh(self._runs, self.params, self.bandwidth_aware_srsf)
            return
        for g in self.cluster.gpus.values():
            g.workload = 0.0
        for jid in self._live:
            run = self._runs[jid]
            share = run.remaining_service(self.params, self.bandwidth_aware_srsf)
            for gid in run.gpus:
                self.cluster.gpus[gid].workload += share

    def place_job(self, job_id: int, gpu_ids: Sequence[GpuId], now: float) -> JobRun:
        """Commit a gang placement: member servers, topology domains, the
        WFBP plan for the placed world and the SRSF workload share; a
        requeued job gets its carried progress and the restore penalty."""
        spec = self.jobs[job_id]
        servers = self.cluster.servers_of(gpu_ids)
        run = JobRun(
            spec=spec,
            gpus=list(gpu_ids),
            servers=servers,
            placed_at=now,
            domains=self._domains_of(servers),
        )
        carry = self._carry.pop(job_id, None)
        if carry is not None:
            run.iter_done = carry.iter_done
            run.samples_done = carry.samples_done
            run.samples_total = carry.samples_total
            run.restore_cost = carry.restore_cost
            run.restore_need = set(range(run.n_world))
        rem_samples = run.samples_total - run.samples_done
        run.target_iters = run.iter_done + max(0, -(-rem_samples // run.n_world))
        self._assign_plan(run)
        workload = run.remaining_service(self.params, self.bandwidth_aware_srsf)
        self.cluster.place(spec, gpu_ids, workload)
        self._runs[job_id] = run
        self._live[job_id] = None
        if self._windex is not None:
            self._windex.on_place(job_id, run.gpus, workload)
        self._dirty_gpus.update(gpu_ids)
        self._first_placed.setdefault(job_id, now)
        if self._obs is not None:
            self._obs.placed(job_id, run, now)
        return run

    def _checkpoint_cost_of(self, run: JobRun) -> float:
        if self.checkpoint_cost is not None:
            return self.checkpoint_cost
        return netmodel.preemption_cost(run.spec.model.size_bytes)

    def _tear_down(self, job_id: int, run: JobRun, now: float) -> None:
        """Stop a gang atomically: tombstone its pending compute events,
        un-accrue the cancelled part of its in-flight tasks, release its
        memory and drop its waiting or in-flight all-reduce."""
        self._epoch_of[job_id] = self._epoch_of.get(job_id, 0) + 1
        for gid in run.gpus:
            g = self.cluster.gpus[gid]
            if g.busy_job == job_id:
                if g.busy_until is not None and g.busy_until > now:
                    g.busy_accum -= g.busy_until - now  # un-accrue lost work
                g.busy_until = None
                g.busy_job = None
            self._dirty_gpus.add(gid)
        self.cluster.release(run.spec, run.gpus)
        if self._windex is not None:
            self._windex.on_release(job_id, run.gpus)
        if job_id in self._waiting_set:
            self._waiter_drop(job_id, run.domains)
        if job_id in self._active_comm:
            self._abort_comm(job_id)

    def preempt_job(self, job_id: int, now: float) -> None:
        """Tear a running gang down atomically and requeue the job.  Its
        progress is carried at the last completed iteration (the iteration
        in progress is lost, a checkpoint-restart) and its next placement
        pays the checkpoint/restore penalty."""
        run = self._runs.pop(job_id)
        self._live.pop(job_id, None)
        if run.finished_at is not None:
            raise ValueError(f"cannot preempt finished job {job_id}")
        lost = self._lost_in_progress(run)
        self._work_lost_samples += lost
        self._tear_down(job_id, run, now)
        self._carry[job_id] = _Carry(
            iter_done=run.iter_done,
            samples_done=run.samples_done,
            samples_total=run.samples_total,
            restore_cost=self._checkpoint_cost_of(run),
        )
        # the queue key reads the carry: set it before the enqueue
        self._enqueue(job_id)
        self._preemptions += 1
        if self._obs is not None:
            # after the teardown, so an aborted transfer's reattribution is
            # already in the log
            self._obs.preempted(job_id, now, lost)
        if self.record_trace:
            # drop the aborted iteration's records (it runs again after the
            # resume) and mark the preemption
            self._trace = [
                r
                for r in self._trace
                if r[2] in ("preempt", "resize")
                or not (r[0] == job_id and r[1] >= run.iter_done)
            ]
            self._trace.append((job_id, run.iter_done, "preempt", -1, now, now))

    def request_resize(self, job_id: int, n_new: int) -> None:
        """Ask for an elastic world-size change, applied at the job's next
        iteration boundary (clamped to the job's bounds)."""
        run = self._runs[job_id]
        lo, hi = run.spec.gpu_bounds
        n_new = max(lo, min(hi, int(n_new)))
        run.pending_resize = None if n_new == run.n_world else n_new

    def _apply_resize(self, run: JobRun, now: float) -> None:
        """Apply a pending resize at an iteration boundary: tear the gang
        down (nothing in the iteration is lost here), place it again at the
        new size through the normal placement path (a new WFBP plan and
        domain set) and charge the checkpoint/restore penalty.  A grow that
        does not fit keeps the old GPUs, costs nothing and is not
        counted."""
        job_id = run.spec.job_id
        n_new = run.pending_resize
        run.pending_resize = None
        self._epoch_of[job_id] = self._epoch_of.get(job_id, 0) + 1
        self.cluster.release(run.spec, run.gpus)
        if self._windex is not None:
            self._windex.on_release(job_id, run.gpus)
        self._dirty_gpus.update(run.gpus)
        del self._runs[job_id]
        self._live.pop(job_id, None)
        # rank the GPUs with this gang's workload gone
        self.refresh_workloads()
        spec = run.spec
        trial = spec if n_new == spec.n_gpus else dataclasses.replace(spec, n_gpus=n_new)
        gpu_ids = self.placement(self.cluster, trial)
        applied = gpu_ids is not None
        if not applied:
            gpu_ids = list(run.gpus)
        self._carry[job_id] = _Carry(
            iter_done=run.iter_done,
            samples_done=run.samples_done,
            samples_total=run.samples_total,
            restore_cost=self._checkpoint_cost_of(run) if applied else 0.0,
        )
        self.place_job(job_id, gpu_ids, now)
        if applied:
            self._resizes += 1
            if self._obs is not None:
                self._obs.resized(job_id, now)
            if self.record_trace:
                self._trace.append((job_id, run.iter_done, "resize", -1, now, now))
        self.sched.on_resize(now, job_id)

    # -- fault injection (core/chaos.py) ------------------------------------------
    def _lost_in_progress(self, run: JobRun) -> int:
        """Samples of in-iteration work a teardown throws away: the gang's
        current iteration is lost if any worker made progress in it.  Call
        it before the per-GPU busy state is cleaned up."""
        in_prog = bool(
            run.f_done
            or run.b_done
            or run.comm_active
            or run.comm_ready_at is not None
            or (
                run.plan is not None
                and (run.next_bucket or run.buckets_done or any(run.b_prog))
            )
        )
        if not in_prog:
            # nothing recorded done yet, but a worker may be mid-task
            in_prog = any(
                self.cluster.gpus[gid].busy_job == run.spec.job_id
                for gid in run.gpus
            )
        return run.n_world if in_prog else 0

    def _seed_chaos_events(self) -> None:
        """Arm the fault processes at run start: one outstanding breakdown
        and NIC window per server (each stream advanced lazily) and every
        listed job's cancellation instant."""
        spec = self._chaos
        self._base_server_bw = tuple(self.params.server_bandwidth)
        for s in range(self.cluster.n_servers):
            self._fail_streams[s] = server_failure_stream(spec, s)
            self._advance_failure(s)
            self._nic_streams[s] = nic_degradation_stream(spec, s)
            self._advance_nic(s)
        for job in self.jobs.values():
            t_c = cancel_time(spec, job.job_id, job.arrival)
            if t_c is not None:
                # the arrival was pushed first, so a same-instant
                # cancellation still finds the job queued
                self._push(max(t_c, job.arrival), "cancel", (job.job_id,))

    def _advance_failure(self, server: int) -> None:
        win = next(self._fail_streams[server], None)
        if win is not None:
            self._push(win[0], "breakdown", (server, win[1]))

    def _advance_nic(self, server: int) -> None:
        win = next(self._nic_streams[server], None)
        if win is not None:
            self._push(win[0], "nic_down", (server, win[1]))

    def _on_breakdown(self, server: int, repair_t: float, now: float) -> None:
        """A server died: preempt every gang touching it (the normal
        preemption: tombstones, carried progress, restore penalty) and keep
        its GPUs out of placement until repair."""
        self._faults += 1
        for g in self.cluster.gpus_of_server(server):
            g.down = True
        if self._windex is not None:
            self._windex.on_server_capacity(server)
        victims = sorted(
            jid
            for jid, run in self._runs.items()
            if run.finished_at is None and server in run.servers
        )
        for jid in victims:
            self.preempt_job(jid, now)
        self._push(repair_t, "repair", (server,))
        if self._obs is not None:
            self._obs.fault("breakdown", server, now)
        self.sched.on_fault(now, server, victims)

    def _on_repair(self, server: int, now: float) -> None:
        for g in self.cluster.gpus_of_server(server):
            g.down = False
        if self._windex is not None:
            self._windex.on_server_capacity(server)
        self.cluster.capacity_epoch += 1  # placeable capacity grew
        self._advance_failure(server)
        if self._obs is not None:
            self._obs.fault("repair", server, now)
        self.sched.on_recovery(now, server)

    def _apply_nic_bandwidth(self) -> None:
        """Rebuild ``params.server_bandwidth`` from the base multipliers and
        the degraded set.  The transfers were integrated up to now before
        this event, so the piecewise-rate integration stays exact;
        ``_comm_dirty`` re-predicts the finish times."""
        scale = self._chaos.nic_degraded_scale
        base = self._base_server_bw
        self.params = dataclasses.replace(
            self.params,
            server_bandwidth=tuple(
                (base[s] if s < len(base) else 1.0)
                * (scale if s in self._nic_degraded else 1.0)
                for s in range(self.cluster.n_servers)
            ),
        )
        self._comm_dirty = True
        # the bandwidth-aware SRSF keys read the map just replaced
        self._svc_epoch += 1

    def _on_nic_down(self, server: int, end_t: float, now: float) -> None:
        self._faults += 1
        self._nic_degraded.add(server)
        self._apply_nic_bandwidth()
        self._push(end_t, "nic_up", (server,))
        if self._obs is not None:
            self._obs.fault("nic_down", server, now)

    def _on_nic_up(self, server: int, now: float) -> None:
        self._nic_degraded.discard(server)
        self._apply_nic_bandwidth()
        self._advance_nic(server)
        if self._obs is not None:
            self._obs.fault("nic_up", server, now)

    def _on_cancel(self, job_id: int, now: float) -> None:
        """A job is cancelled: a running gang is torn down as in a
        preemption, without the requeue; a queued job leaves the queue.
        Cancelled jobs are counted apart from ``censored`` and add nothing
        to the JCT statistics or the goodput."""
        if job_id not in self._unfinished:
            return  # finished before the cancellation
        run = self._runs.get(job_id)
        lost = 0.0
        if run is not None:
            lost = self._lost_in_progress(run)
            self._work_lost_samples += lost
            del self._runs[job_id]
            self._live.pop(job_id, None)
            self._tear_down(job_id, run, now)
            if self.record_trace:
                self._trace.append((job_id, run.iter_done, "cancel", -1, now, now))
        elif job_id in self._queue:
            self.remove_queued((job_id,))
            self._carry.pop(job_id, None)
        self._cancelled += 1
        self._unfinished.discard(job_id)
        if self._obs is not None:
            self._obs.cancelled(job_id, now, lost)
        # freed memory or a shorter queue may admit other jobs
        self.sched.on_job_finish(now, job_id)

    # -- communication gating -----------------------------------------------------
    def _gate_try_one(self, jid: int, run: JobRun, now: float, qpos: int = -1) -> bool:
        """Evaluate the gating policy for one waiter and start its transfer
        when the policy accepts.  Returns True iff a transfer started.  The
        rescan and the incremental pass share this body, so they differ
        only in which waiters they evaluate.  ``qpos`` is the waiter's rank
        in the pass's SRSF order, for the audit only."""
        domains = run.domains
        # WFBP: the decision and the transfer carry the current bucket's bytes
        if run.plan is not None:
            bucket = run.next_bucket
            new_bytes = run.plan[0][bucket]
        else:
            bucket = -1
            new_bytes = run.spec.model.size_bytes
        dload = self._domain_load
        max_conc = 0
        for d in domains:
            v = dload.get(d, 0)
            if v > max_conc:
                max_conc = v
        policy = self.comm_policy
        obs = self._obs
        lg = self._obs_audit
        dtasks = self._domain_tasks
        if lg is None and policy.scalar_gate:
            # the decision reads the overlapping set only through its
            # minimum (the count is max_conc); the audit needs the list
            min_old = math.inf
            for d in domains:
                lst = dtasks.get(d)
                if lst:
                    for t in lst:
                        if t.remaining_bytes < min_old:
                            min_old = t.remaining_bytes
            ok = policy.should_start_min(new_bytes, min_old, max_conc, self.params)
            old_rem: List[float] = []  # read by the audit only, which is off
        else:
            # the overlapping transfers in start order: one domain's list is
            # already in order, several dedupe through the seq-keyed dict.
            # The k-way lookahead sums over this list, so order matters.
            lists = [dtasks[d] for d in domains if d in dtasks]
            if not lists:
                old_rem = []
            elif len(lists) == 1:
                old_rem = [t.remaining_bytes for t in lists[0]]
            else:
                seen: Dict[int, float] = {}
                for lst in lists:
                    for t in lst:
                        seen[t.seq] = t.remaining_bytes
                old_rem = [seen[s] for s in sorted(seen)]
            ok = policy.should_start(new_bytes, old_rem, max_conc, self.params)
        if lg is not None:
            # one flat audit record per evaluation, within the audit cap
            n = self._obs_audit_left
            if n > 0:
                self._obs_audit_left = n - 1
                lg.extend((now, jid, bucket, new_bytes, max_conc, ok, qpos,
                           len(self._waiting_comm), len(old_rem)))
                lg.extend(old_rem)
            else:
                obs.audit_dropped += 1
        if not ok:
            return False
        self._waiter_drop(jid, domains)
        task = CommTask(
            job_id=jid,
            servers=set(run.servers),
            remaining_bytes=(
                new_bytes
                if run.plan is not None
                else run.spec.model.size_bytes / self.comm_chunks
            ),
            latency_left=self.params.a,
            domains=domains,
            bucket=bucket,
            seq=self._comm_seq,
        )
        self._comm_seq += 1
        self._active_comm[jid] = task
        self._comm_started(task)
        if run.plan is not None:
            run.next_bucket += 1
        else:
            run.comm_chunks_left -= 1
        run.comm_active = True
        if max_conc > 0:
            self._comm_contended += 1
        else:
            self._comm_clean += 1
        if obs is not None:
            obs.comm_start(jid, bucket, now, task)
        if self.record_trace:
            kind = "c" if bucket < 0 else f"c{bucket}"
            self._trace.append((jid, run.iter_done, kind, -1, now, None))
        return True

    def _try_start_comms(self, now: float) -> bool:
        if not self._waiting_comm:
            return False
        if self.gating == "rescan":
            return self._try_start_comms_rescan(now)
        return self._try_start_comms_incremental(now)

    def _try_start_comms_rescan(self, now: float) -> bool:
        """The oracle: evaluate every waiter in SRSF order on every call,
        from the top again after each start."""
        any_started = False
        self._waiting_comm.sort(key=self.srsf_key_running)
        started_any = True
        while started_any:
            started_any = False
            for qpos, jid in enumerate(list(self._waiting_comm)):
                run = self._runs[jid]
                if run.comm_active or jid in self._active_comm:
                    self._waiter_drop(jid, run.domains)
                    continue
                if self._gate_try_one(jid, run, now, qpos):
                    started_any = True
                    any_started = True
                    break  # the contention state changed: start over
        return any_started

    def _try_start_comms_incremental(self, now: float) -> bool:
        """Dirty-domain gating: evaluate, in SRSF order, the waiters whose
        inputs may have changed — fresh waiters and waiters sharing a
        domain with a comm start or end since their last evaluation — and
        merge the waiters a start wakes.  Between events the in-flight
        transfers only drain, which cannot flip a False decision of a
        drain-monotone policy; the k-way lookahead is not one, so all its
        waiters are evaluated every event, as are all waiters after an
        abort or a bandwidth change (``_comm_dirty``).  The rescan gives
        the same event stream."""
        if self._comm_dirty or not self.comm_policy.drain_monotone:
            cand = set(self._waiting_comm)
            self._gate_candidates.clear()
        else:
            if not self._gate_candidates:
                return False
            cand = self._gate_candidates
            self._gate_candidates = set()
        any_started = False
        if self._obs_audit is None:
            # SRSF keys are stable within a pass (no iteration completes
            # during gating), so a lazily-deduped heap pops the sorted(cand)
            # order that the loop below re-sorts after every start
            key = self.srsf_key_running
            heap = [(key(jid), jid) for jid in cand]
            heapq.heapify(heap)
            while heap:
                _, jid = heapq.heappop(heap)
                if jid not in cand:
                    continue  # re-pushed duplicate already handled
                cand.discard(jid)
                run = self._runs[jid]
                if run.comm_active or jid in self._active_comm:
                    self._waiter_drop(jid, run.domains)
                    continue
                if self._gate_try_one(jid, run, now, -1):
                    any_started = True
                    woken = self._gate_candidates
                    if woken:
                        for w in woken:
                            if w not in cand:
                                cand.add(w)
                                heapq.heappush(heap, (key(w), w))
                        woken.clear()
            return any_started
        # with the audit on: the same order, re-sorted after each start so
        # that every record carries its rank in the pass (qpos)
        while cand:
            restart = False
            for qpos, jid in enumerate(sorted(cand, key=self.srsf_key_running)):
                run = self._runs[jid]
                if run.comm_active or jid in self._active_comm:
                    self._waiter_drop(jid, run.domains)
                    cand.discard(jid)
                    restart = True
                    break
                if self._gate_try_one(jid, run, now, qpos):
                    any_started = True
                    cand.discard(jid)
                    cand |= self._gate_candidates
                    self._gate_candidates.clear()
                    restart = True
                    break
                cand.discard(jid)
            if not restart:
                break  # every candidate evaluated False: the pass is done
        return any_started

    # -- iteration/worker state machine ---------------------------------------------
    def _begin_iteration(self, run: JobRun, now: float) -> None:
        run.f_done.clear()
        run.b_done.clear()
        run.comm_ready_at = None
        run.comm_active = False
        if run.plan is not None:
            run.b_prog = [0] * run.n_world
            run.next_bucket = 0
            run.buckets_done = 0
        self._dirty_gpus.update(run.gpus)

    def _complete_iteration(self, run: JobRun, now: float) -> None:
        run.iter_done += 1
        run.samples_done += run.n_world
        if self._windex is not None:
            # the share is stale until the next refresh
            self._windex.on_decay(run.spec.job_id)
        if run.samples_done >= run.samples_total:
            self._finish_job(run, now)
        elif run.pending_resize is not None:
            self._apply_resize(run, now)
        else:
            self._begin_iteration(run, now)

    def _finish_job(self, run: JobRun, now: float) -> None:
        run.finished_at = now
        jid = run.spec.job_id
        self.cluster.release(run.spec, run.gpus)
        if self._windex is not None:
            self._windex.on_release(jid, run.gpus)
        self._dirty_gpus.update(run.gpus)
        self._unfinished.discard(jid)
        self._live.pop(jid, None)
        # recorded now: a streamed run drops finished runs at event end
        self._finish_at[jid] = now
        self._jct_at_finish[jid] = now - run.spec.arrival
        self._qdelay_at_finish[jid] = (
            self._first_placed.get(jid, run.placed_at) - run.spec.arrival
        )
        self._job_samples[jid] = run.samples_done
        if self._obs is not None:
            self._obs.finished(jid, run, now)
        if self._source is not None:
            self._retire_buf.append(jid)

    def _on_backward_done(self, run: JobRun, now: float) -> None:
        if len(run.b_done) < run.n_world:
            return
        # barrier reached (Fig. 3: the all-reduce waits for every backprop)
        if run.has_comm:
            jid = run.spec.job_id
            assert jid not in self._waiting_set and not run.comm_active, (
                f"duplicate barrier for job {jid}"
            )
            run.comm_ready_at = now
            run.comm_chunks_left = self.comm_chunks
            self._waiter_add(jid, run)
        else:
            self._complete_iteration(run, now)

    # -- GPU scheduling (Alg. 3 lines 22-30) -------------------------------------
    def _restore_extra(self, run: JobRun, w: int) -> float:
        """The checkpoint-restore penalty worker ``w`` owes on its first
        compute task after a preemption or resize."""
        return run.restore_cost if w in run.restore_need else 0.0

    def _ready_compute_tasks(self, gid: GpuId):
        """Yield (job_id, worker, kind, duration, segment) ready on this
        GPU; segment is the WFBP backward-segment index (-1 = monolithic)."""
        g = self.cluster.gpus[gid]
        for jid in g.resident_jobs:
            run = self._runs.get(jid)
            if run is None or run.finished_at is not None:
                continue
            wmap = run._worker_of
            if wmap is None:
                wmap = {g2: i for i, g2 in enumerate(run.gpus)}
                run._worker_of = wmap
            w = wmap.get(gid)
            if w is None:
                continue
            # straggler jitter: one compute stretch per (job, iteration),
            # never applied to the restore penalty (a state reload)
            jit = (
                jitter_factor(self._chaos, jid, run.iter_done)
                if self._chaos is not None
                else 1.0
            )
            if run.plan is not None:
                # WFBP: the backward runs in per-bucket segments that overlap
                # in-flight transfers
                if w not in run.f_done:
                    yield (jid, w, "f", run.spec.model.t_f * jit + self._restore_extra(run, w), -1)
                elif run.b_prog[w] < run.n_buckets:
                    s = run.b_prog[w]
                    yield (jid, w, "b", run.plan[1][s] * jit, s)
                continue
            if run.comm_ready_at is not None or run.comm_active:
                continue  # between barrier and next iteration
            if w not in run.f_done:
                if self.fuse_fb:
                    yield (jid, w, "fb",
                           run.spec.model.t_iter_compute * jit + self._restore_extra(run, w), -1)
                else:
                    yield (jid, w, "f", run.spec.model.t_f * jit + self._restore_extra(run, w), -1)
            elif w not in run.b_done:
                yield (jid, w, "b", run.spec.model.t_b * jit, -1)

    def _schedule_gpus(self, now: float) -> None:
        for gid in list(self._dirty_gpus):
            self._dirty_gpus.discard(gid)
            g = self.cluster.gpus[gid]
            if g.down:
                continue  # broken server: nothing runs until repair
            # busy_job is cleared only by this GPU's own gpu_done event, so a
            # task ending exactly at `now` cannot be double-scheduled
            if g.busy_job is not None:
                continue
            candidates = list(self._ready_compute_tasks(gid))
            if not candidates:
                g.busy_until = None
                g.busy_job = None
                continue
            # SRSF among resident jobs' ready tasks
            if len(candidates) > 1:
                candidates.sort(key=lambda c: self.srsf_key_running(c[0]))
            jid, w, kind, dur, seg = candidates[0]
            run = self._runs[jid]
            if kind in ("f", "fb") and w in run.restore_need:
                run.restore_need.discard(w)  # the penalty is in this task
            g.busy_until = now + dur
            g.busy_job = jid
            g.busy_accum += dur
            self._push(
                now + dur,
                "gpu_done",
                (gid, jid, w, kind, seg, self._epoch_of.get(jid, 0)),
            )
            rc = self._obs_rc
            if rc is not None:
                if len(rc) < self._obs_rc_cap:
                    rc.extend((jid, w, kind, seg, now, now + dur))
                else:
                    self._obs.span_dropped += 1
            if self.record_trace:
                if kind == "fb":
                    self._trace.append((jid, run.iter_done, "f", w, now, now + run.spec.model.t_f))
                    self._trace.append((jid, run.iter_done, "b", w, now + run.spec.model.t_f,
                                        now + dur))
                else:
                    tkind = kind if seg < 0 else f"{kind}{seg}"
                    self._trace.append((jid, run.iter_done, tkind, w, now, now + dur))

    # -- streaming arrival feed (TraceSource) -------------------------------------
    def _push_next_arrival(self) -> None:
        """Pull one arrival ahead from the streamed source into the
        calendar (so the calendar stays O(cluster) at any trace length)."""
        spec = next(self._stream, None)
        if spec is None:
            self._stream = None
            return
        if spec.arrival < self._last_arrival:
            raise ValueError(
                f"TraceSource must yield arrivals in nondecreasing order: "
                f"job {spec.job_id} arrives at {spec.arrival} after "
                f"{self._last_arrival}"
            )
        if spec.job_id in self.jobs:
            raise ValueError(f"TraceSource repeated job_id {spec.job_id}")
        self._last_arrival = spec.arrival
        self._push(spec.arrival, "arrival", (spec,))
        self._arrivals_pending += 1

    def _register_arrival(self, spec: JobSpec, now: float) -> None:
        """A streamed arrival fired: the job enters the system now."""
        jid = spec.job_id
        self.jobs[jid] = spec
        self._unfinished.add(jid)
        self._n_seen += 1
        self._arrivals_pending -= 1
        if self._chaos is not None:
            # the per-arrival twin of _seed_chaos_events' cancellations
            t_c = cancel_time(self._chaos, jid, spec.arrival)
            if t_c is not None:
                self._push(max(t_c, spec.arrival), "cancel", (jid,))
        self._push_next_arrival()

    def _retire_finished(self) -> None:
        """Streamed feed, end of event: drop finished runs (their results
        were recorded at finish; a stale gpu_done of a dropped run finds no
        run)."""
        for jid in self._retire_buf:
            self._runs.pop(jid, None)
            self.jobs.pop(jid, None)
            self._first_placed.pop(jid, None)
            self._epoch_of.pop(jid, None)
        self._retire_buf.clear()

    # -- main loop ----------------------------------------------------------------
    def run(self, max_time: float = math.inf) -> SimResult:
        if self._source is not None:
            self._stream = iter(self._source.arrivals())
            self._push_next_arrival()
        else:
            for spec in self.jobs.values():
                self._push(spec.arrival, "arrival", (spec.job_id,))
        if self.sched.quantum is not None:
            if self.jobs:
                first = min(s.arrival for s in self.jobs.values())
            elif self._heap:
                first = self._heap[0][0]  # streamed: the one-ahead arrival
            else:
                first = None
            if first is not None:
                self._push(first + self.sched.quantum, "quantum", ())
        if self._chaos is not None:
            self._seed_chaos_events()
        prof = self._phase_seconds
        perf = time.perf_counter
        streaming = self._source is not None
        now = 0.0
        while self._heap and (self._unfinished or self._arrivals_pending):
            t, _, kind, data = heapq.heappop(self._heap)
            if kind == "comm_check" and data[0] != self._comm_epoch:
                continue
            if t > max_time:
                break
            now = t
            self._events += 1
            self._comm_dirty = False
            if prof is not None:
                t0 = perf()

            finished_comms = self._advance_comm(now)
            for jid in finished_comms:
                run = self._runs[jid]
                run.comm_active = False
                if self.record_trace:
                    # close the open comm record ("c" or a WFBP "c<bucket>")
                    for i in range(len(self._trace) - 1, -1, -1):
                        r = self._trace[i]
                        if r[0] == jid and r[2].startswith("c") and r[5] is None:
                            self._trace[i] = (r[0], r[1], r[2], r[3], r[4], now)
                            break
                if run.plan is not None:
                    # WFBP: the iteration completes with the last bucket's
                    # transfer; otherwise hand the next ready bucket on
                    run.buckets_done += 1
                    if run.buckets_done >= run.n_buckets:
                        self._complete_iteration(run, now)
                    else:
                        self._maybe_enqueue_bucket(run)
                elif run.comm_chunks_left > 0:
                    # chunked comm: the next chunk competes for the link as
                    # a fresh transfer (a preemption point)
                    self._waiter_add(jid, run)
                else:
                    self._complete_iteration(run, now)
            if prof is not None:
                t1 = perf()
                prof["comm_advance"] += t1 - t0

            if kind == "arrival":
                if streaming:
                    spec = data[0]
                    jid = spec.job_id
                    self._register_arrival(spec, now)
                else:
                    jid = data[0]
                self._enqueue(jid)
                self.sched.on_arrival(now, jid)
            elif kind == "gpu_done":
                gid, jid, w, tkind, seg, epoch = data
                run = self._runs.get(jid)
                # else: a stale event of a torn-down incarnation, whose GPU
                # was freed (and maybe booked again) at the teardown
                if run is not None and epoch == self._epoch_of.get(jid, 0):
                    g = self.cluster.gpus[gid]
                    g.busy_until = None
                    g.busy_job = None
                    self._dirty_gpus.add(gid)
                    if run.plan is not None:
                        if tkind == "f":
                            run.f_done.add(w)
                        else:  # backward segment `seg` of worker w
                            run.b_prog[w] += 1
                            self._maybe_enqueue_bucket(run)
                    elif tkind == "fb":
                        run.f_done.add(w)
                        run.b_done.add(w)
                        self._on_backward_done(run, now)
                    elif tkind == "f":
                        run.f_done.add(w)
                    elif tkind == "b":
                        run.b_done.add(w)
                        self._on_backward_done(run, now)
                    if run.finished_at is not None:
                        # memory freed -> queued jobs may fit now
                        self.sched.on_job_finish(now, jid)
            elif kind == "quantum":
                self.sched.on_quantum(now)
                # tick on only while progress is possible: a pending event
                # or a live run (a never-placeable queue would spin forever)
                if (self._unfinished or self._arrivals_pending) and (
                    self._heap
                    or any(r.finished_at is None for r in self._runs.values())
                ):
                    self._push(now + self.sched.quantum, "quantum", ())
            elif kind == "breakdown":
                self._on_breakdown(data[0], data[1], now)
            elif kind == "repair":
                self._on_repair(data[0], now)
            elif kind == "nic_down":
                self._on_nic_down(data[0], data[1], now)
            elif kind == "nic_up":
                self._on_nic_up(data[0], now)
            elif kind == "cancel":
                self._on_cancel(data[0], now)
            # a comm_check needs nothing beyond the drain above

            if finished_comms:
                # a job finishing through its comm also frees memory: one
                # re-evaluation per event
                for j in finished_comms:
                    run = self._runs.get(j)
                    if run is not None and run.finished_at is not None:
                        self.sched.on_job_finish(now, j)
                        break
            if prof is not None:
                t2 = perf()
                prof["dispatch"] += t2 - t1

            started = self._try_start_comms(now)
            if prof is not None:
                t3 = perf()
                prof["gating"] += t3 - t2
            self._schedule_gpus(now)
            if prof is not None:
                prof["gpu_schedule"] += perf() - t3
            # rates change only when the active set does (or an abort or a
            # bandwidth change marks it dirty); a comm_check that finished
            # nothing (float drift) must still reschedule
            if started or finished_comms or kind == "comm_check" or self._comm_dirty:
                if prof is not None:
                    # the re-prediction is gating's when a start or an
                    # abort forced it, comm integration's otherwise
                    t4 = perf()
                    self._reschedule_comm_check()
                    phase = "gating" if (self._comm_dirty or started) else "comm_advance"
                    prof[phase] += perf() - t4
                else:
                    self._reschedule_comm_check()
            if self._retire_buf:
                self._retire_finished()

        return self._collect(now)

    # -- results ------------------------------------------------------------------
    def _collect(self, now: float) -> SimResult:
        if self._source is None:
            # a job list: results from the runs in their insertion order
            # (the reference's float accumulation order)
            jct, finish, qdelay = {}, {}, {}
            for jid, run in self._runs.items():
                if run.finished_at is not None:
                    finish[jid] = run.finished_at
                    jct[jid] = run.finished_at - run.spec.arrival
                    qdelay[jid] = (
                        self._first_placed.get(jid, run.placed_at) - run.spec.arrival
                    )
            # delivered: finished or still-live jobs (runs and requeued
            # carries); a cancelled job's progress is not delivered
            delivered = sum(r.samples_done for r in self._runs.values()) + sum(
                c.samples_done for c in self._carry.values()
            )
        else:
            # streamed: finished runs were dropped, their records are kept
            jct = self._jct_at_finish
            finish = self._finish_at
            qdelay = self._qdelay_at_finish
            delivered = (
                sum(self._job_samples.values())
                + sum(r.samples_done for r in self._runs.values())
                + sum(c.samples_done for c in self._carry.values())
            )
        makespan = max(finish.values()) if finish else now
        busy = {gid: g.busy_accum for gid, g in self.cluster.gpus.items()}
        util = sum(busy.values()) / (len(busy) * makespan) if makespan > 0 else 0.0
        obs_report = None
        if self._obs is not None:
            obs_report = self._obs.build_report(
                topology=self.topology,
                params=self.params,
                makespan=makespan,
                horizon=now,
            )
        return SimResult(
            policy_name=self.comm_policy.name,
            placement_name=repr(self.placement),
            jct=jct,
            finish=finish,
            makespan=makespan,
            gpu_busy=busy,
            gpu_util=util,
            queueing_delay=qdelay,
            events_processed=self._events,
            comm_started_contended=self._comm_contended,
            comm_started_clean=self._comm_clean,
            peak_calendar=self._peak_heap,
            sched_name=self.sched.name,
            # the jobs that entered (all of a list; the processed arrivals
            # of a stream) less the finished and the cancelled ones
            censored=self._n_seen - len(finish) - self._cancelled,
            preemptions=self._preemptions,
            resizes=self._resizes,
            faults=self._faults,
            cancelled=self._cancelled,
            work_lost_samples=self._work_lost_samples,
            goodput=(delivered / makespan) if makespan > 0 else 0.0,
            task_trace=self._trace if self.record_trace else None,
            job_samples=dict(self._job_samples),
            phase_seconds=dict(self._phase_seconds) if self._phase_seconds else None,
            obs=obs_report,
        )
