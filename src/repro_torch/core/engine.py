"""Event engine for multi-job DDL cluster simulation (port of
``repro/core/engine.py``, trimmed to static gang scheduling; paper
Algorithm 3 and Section V, exact continuous-time variant).

The engine owns the mechanism — the event calendar, cluster/GPU occupancy,
the communication streams (Eq. 5 contention with exact piecewise-constant-
rate integration, WFBP bucket pipelines, topology domain sets) and result
collection — and leaves every admission decision to a
:class:`~repro_torch.core.schedpolicy.SchedPolicy`, which commits gangs
through :meth:`EventEngine.place_job`.

It is plain Python on Python floats, in the reference's order of
operations, so a run gives the reference's event stream and results bit
for bit.  It holds no tensors.  Its one mode is the reference's default:
incremental gating and the maintained workload index
(:mod:`repro_torch.core.clusterindex`).  What the reference engine has
beyond that raises ``NotImplementedError`` naming its ROADMAP item (queue
1, items 7a-7h): preemptive and elastic scheduling, fault injection, the
observability recorder, a streaming ``TraceSource`` feed, chunked
all-reduces and the ring-edge ``"link"`` reading, trace recording,
per-phase profiling, and the ``rescan`` oracle modes.

Progress is counted in samples (per-GPU batches): a job's work is
``iterations x n_gpus`` and each completed iteration contributes its world
size.  Jobs still running when ``run(max_time=...)`` stops are reported as
``SimResult.censored``.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
from bisect import insort
from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

from repro_torch.core import netmodel
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
from repro_torch.core.topology import Topology, nic_topology

_EPS = 1e-9


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch's event engine; ROADMAP queue 1, item {item}"
    )


# ---------------------------------------------------------------------------
# Runtime state
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CommTask:
    job_id: int
    servers: Set[int]
    remaining_bytes: float
    latency_left: float  # the fixed 'a' consumed in wall time before draining
    #: topology domain indices this task loads (the fabric cuts its ring
    #: crosses)
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
    #: WFBP fusion plan ``(bucket_bytes, bucket_t_b)`` from
    #: ``netmodel.fusion_plan``; None = the monolithic all-reduce
    plan: Optional[Tuple[Tuple[float, ...], Tuple[float, ...]]] = None
    #: WFBP per-worker backward progress: completed segments (len n_world)
    b_prog: List[int] = dataclasses.field(default_factory=list)
    #: WFBP comm pipeline: next bucket for the FIFO comm stream, buckets done
    next_bucket: int = 0
    buckets_done: int = 0
    finished_at: Optional[float] = None
    #: progress in samples: total work and the part done
    samples_total: int = 0
    samples_done: int = 0
    #: memo of the nominal per-iteration service time
    _svc_cache: Optional[tuple] = dataclasses.field(default=None, repr=False, compare=False)
    #: memo of the SRSF key, valid while ``iter_done`` is unchanged
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
        rem_iters = self.spec.iterations - self.iter_done
        return rem_iters * self.per_iter_service(params, bandwidth_aware) * self.n_world


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
    """The reference's result record, field for field.  The fields of the
    parts not ported (preemption, resizes, faults, cancellations, traces,
    phase profiles, observability) keep their empty values."""

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
    #: high-water mark of the event calendar (every arrival is pushed up
    #: front, so >= n_jobs)
    peak_calendar: int = 0
    sched_name: str = "static"
    #: jobs with no finish time (horizon cutoff, or never placeable)
    censored: int = 0
    preemptions: int = 0
    resizes: int = 0
    faults: int = 0
    cancelled: int = 0
    work_lost_samples: int = 0
    #: delivered samples per second of makespan
    goodput: float = 0.0
    task_trace: Optional[List[Tuple]] = None
    #: per-job delivered samples at finish time
    job_samples: Dict[int, int] = dataclasses.field(default_factory=dict)
    phase_seconds: Optional[Dict[str, float]] = None
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
    """Exact event-driven simulation of Algorithm 3's dynamics, with job
    admission delegated to a :class:`SchedPolicy`.  The keywords are the
    reference's; the ones the port does not support raise."""

    def __init__(
        self,
        jobs: Sequence[JobSpec],
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
        chaos: Optional[object] = None,
        gating: Optional[str] = None,
        workloads: Optional[str] = None,
        profile_phases: bool = False,
        observe: Optional[object] = None,
    ) -> None:
        if hasattr(jobs, "arrivals"):
            raise _not_ported("a streaming TraceSource feed", "7c")
        if record_trace:
            raise _not_ported("record_trace=True (the task trace and core/dag.py)", "7d")
        if comm_chunks != 1:
            raise _not_ported(f"comm_chunks={comm_chunks} (chunked all-reduce)", "7e")
        if contention_domain == "link":
            raise _not_ported('contention_domain="link" (RingEdgeTopology)', "7e")
        if contention_domain != "server":
            raise ValueError(f"unknown contention domain {contention_domain!r}")
        if chaos is not None:
            raise _not_ported("fault injection (chaos=)", "7b")
        for knob, value in (("preemption_quantum", preemption_quantum),
                            ("checkpoint_cost", checkpoint_cost)):
            if value is not None:
                raise _not_ported(f"{knob}= (the preemptive and elastic policies' input)", "7a")
        if observe is not None:
            raise _not_ported("the observability recorder (observe=)", "7f")
        if profile_phases:
            raise _not_ported("profile_phases=True", "7f")
        for mode_name, mode in (("gating", gating), ("workloads", workloads)):
            if mode == "rescan":
                raise _not_ported(f'{mode_name}="rescan" (the oracle mode)', "7g")
            if mode not in (None, "incremental"):
                raise ValueError(
                    f"unknown {mode_name} mode {mode!r} (expected 'incremental' or 'rescan')"
                )
        self.jobs: Dict[int, JobSpec] = {j.job_id: j for j in jobs}
        self.cluster = cluster or Cluster()
        self.placement = placement or PlacementPolicy("lwf", kappa=1)
        self.comm_policy = comm_policy or AdaDual()
        self.params = params or ContentionParams()
        # Fusing f+b into one GPU occupancy halves the event count; a newly
        # placed higher-priority job can then take the GPU only at (f+b)
        # boundaries.
        self.fuse_fb = fuse_fb
        # WFBP tensor fusion: 'all' = one monolithic all-reduce per
        # iteration (the paper's model); 'none' / a byte threshold =
        # per-bucket transfers that overlap the remaining backward pass,
        # gated per bucket, for models that carry layer data.
        self._fusion_threshold = netmodel.fusion_threshold(fusion)
        self.fusion = fusion
        self._plan_cache: Dict[int, Optional[tuple]] = {}
        if topology is not None and topology.n_servers != self.cluster.n_servers:
            raise ValueError(
                f"topology covers {topology.n_servers} servers, cluster has "
                f"{self.cluster.n_servers}"
            )
        self.topology = topology if topology is not None else nic_topology(self.cluster.n_servers)
        #: every domain at unit oversubscription => k_eff is the integer load
        self._uniform_oversub = all(d.oversub == 1.0 for d in self.topology.domains)
        self.cluster.exclusive = exclusive_gpus
        # SRSF estimate: the paper's nominal comm time, or scaled by the
        # slowest member NIC (JobRun.per_iter_service)
        self.bandwidth_aware_srsf = bandwidth_aware_srsf
        if sched is None:
            sched = StaticGangPolicy()
        elif isinstance(sched, str):
            sched = sched_policy_from_name(sched)
        self.sched = sched
        self._windex = ClusterIndex(self.cluster)
        self.placement.index = self._windex

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
        #: memo of ``params.rate(k)`` (b and eta are fixed for the run)
        self._rate_cache: Dict[float, float] = {}
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
        self._unfinished = set(self.jobs)
        self._job_samples: Dict[int, int] = {}
        self.sched.bind(self)

    # -- policy-facing state views -------------------------------------------
    @property
    def queue(self) -> List[int]:
        """Unplaced job ids in ``srsf_key_queued`` order."""
        return self._queue

    @property
    def queue_buckets(self) -> Dict[tuple, List[int]]:
        """Queued jobs grouped by ``(n_gpus, mem_mb)`` resource profile."""
        return self._queue_buckets

    @property
    def queue_profile_of(self) -> Dict[int, tuple]:
        """Resource profile of every queued job."""
        return self._queue_profile_of

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
        """Drop placed jobs from the wait queue and its profile buckets."""
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
        """SRSF key of a queued job (E_J = 0 before placement, Section IV-A)."""
        spec = self.jobs[job_id]
        return (spec.compute_time * spec.n_gpus, spec.arrival, job_id)

    def srsf_key_running(self, job_id: int):
        run = self._runs[job_id]
        cached = run._key_cache
        if cached is not None and cached[0] == run.iter_done:
            return cached[1]
        rem = run.remaining_service(self.params, self.bandwidth_aware_srsf)
        key = (rem, run.spec.arrival, job_id)
        run._key_cache = (run.iter_done, key)
        return key

    # -- communication bookkeeping --------------------------------------------
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

    def _waiter_drop(self, jid: int, domains: frozenset) -> None:
        self._waiting_comm.remove(jid)
        self._waiting_set.discard(jid)
        for d in domains:
            ws = self._domain_waiters.get(d)
            if ws is not None:
                ws.discard(jid)
                if not ws:
                    del self._domain_waiters[d]
        self._gate_candidates.discard(jid)

    def _mark_domains_dirty(self, domains: frozenset) -> None:
        """A comm start/end touched these domains: every waiter sharing one
        must be re-evaluated."""
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
        params = self.params
        bw_uniform = not params.server_bandwidth
        rcache = self._rate_cache
        for jid, task in self._active_comm.items():
            ll = task.latency_left
            if ll < dt:
                task.latency_left = 0.0
                k = self._comm_k_eff(task)
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
        for jid in finished:
            self._comm_ended(self._active_comm[jid])
            del self._active_comm[jid]
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
        """Alg. 3 line 3: every GPU's remaining workload L_g, re-folded for
        the GPUs a release or an iteration boundary touched."""
        self._windex.refresh(self._runs, self.params, self.bandwidth_aware_srsf)

    def place_job(self, job_id: int, gpu_ids: Sequence[GpuId], now: float) -> JobRun:
        """Commit a gang placement: member servers, topology domains, the
        WFBP plan and the SRSF workload share."""
        spec = self.jobs[job_id]
        servers = self.cluster.servers_of(gpu_ids)
        run = JobRun(
            spec=spec,
            gpus=list(gpu_ids),
            servers=servers,
            placed_at=now,
            domains=self.topology.loaded_domains(servers),
        )
        self._assign_plan(run)
        workload = run.remaining_service(self.params, self.bandwidth_aware_srsf)
        self.cluster.place(spec, gpu_ids, workload)
        self._runs[job_id] = run
        self._live[job_id] = None
        self._windex.on_place(job_id, run.gpus, workload)
        self._dirty_gpus.update(gpu_ids)
        return run

    # -- communication gating -----------------------------------------------------
    def _gate_try_one(self, jid: int, run: JobRun, now: float) -> bool:
        """Evaluate the gating policy for one waiter and start its transfer
        when the policy accepts.  Returns True iff a transfer started."""
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
        dtasks = self._domain_tasks
        if policy.scalar_gate:
            # the decision reads the overlapping set only through its
            # minimum (the count is max_conc)
            min_old = math.inf
            for d in domains:
                lst = dtasks.get(d)
                if lst:
                    for t in lst:
                        if t.remaining_bytes < min_old:
                            min_old = t.remaining_bytes
            ok = policy.should_start_min(new_bytes, min_old, max_conc, self.params)
        else:
            # the overlapping transfers in start order: one domain's list is
            # already in order, several dedupe through the seq-keyed dict.
            # The k-way lookahead sums over this list, so order matters.
            lists = [dtasks[d] for d in domains if d in dtasks]
            if not lists:
                old_rem: List[float] = []
            elif len(lists) == 1:
                old_rem = [t.remaining_bytes for t in lists[0]]
            else:
                seen: Dict[int, float] = {}
                for lst in lists:
                    for t in lst:
                        seen[t.seq] = t.remaining_bytes
                old_rem = [seen[s] for s in sorted(seen)]
            ok = policy.should_start(new_bytes, old_rem, max_conc, self.params)
        if not ok:
            return False
        self._waiter_drop(jid, domains)
        task = CommTask(
            job_id=jid,
            servers=set(run.servers),
            remaining_bytes=new_bytes,
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
        run.comm_active = True
        if max_conc > 0:
            self._comm_contended += 1
        else:
            self._comm_clean += 1
        return True

    def _try_start_comms(self, now: float) -> bool:
        """Dirty-domain gating (``_try_start_comms_incremental`` of the
        reference): evaluate, in SRSF order, the waiters whose inputs may
        have changed — fresh waiters and waiters sharing a domain with a
        comm start or end since their last evaluation — and merge the
        waiters a start wakes.  Between events the in-flight transfers only
        drain, which cannot flip a False decision of a drain-monotone
        policy; the k-way lookahead is not one, so all its waiters are
        evaluated every event."""
        if not self._waiting_comm:
            return False
        if not self.comm_policy.drain_monotone:
            cand = set(self._waiting_comm)
            self._gate_candidates.clear()
        else:
            if not self._gate_candidates:
                return False
            cand = self._gate_candidates
            self._gate_candidates = set()
        any_started = False
        # SRSF keys are stable within a pass (no iteration completes during
        # gating), so a lazily-deduped heap pops the sorted(cand) order
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
            if self._gate_try_one(jid, run, now):
                any_started = True
                woken = self._gate_candidates
                if woken:
                    for w in woken:
                        if w not in cand:
                            cand.add(w)
                            heapq.heappush(heap, (key(w), w))
                    woken.clear()
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
        # the share is stale until the next refresh
        self._windex.on_decay(run.spec.job_id)
        if run.samples_done >= run.samples_total:
            self._finish_job(run, now)
        else:
            self._begin_iteration(run, now)

    def _finish_job(self, run: JobRun, now: float) -> None:
        run.finished_at = now
        jid = run.spec.job_id
        self.cluster.release(run.spec, run.gpus)
        self._windex.on_release(jid, run.gpus)
        self._dirty_gpus.update(run.gpus)
        self._unfinished.discard(jid)
        self._live.pop(jid, None)
        self._job_samples[jid] = run.samples_done

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
            self._waiter_add(jid, run)
        else:
            self._complete_iteration(run, now)

    # -- GPU scheduling (Alg. 3 lines 22-30) -------------------------------------
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
            if run.plan is not None:
                # WFBP: the backward runs in per-bucket segments that overlap
                # in-flight transfers
                if w not in run.f_done:
                    yield (jid, w, "f", run.spec.model.t_f, -1)
                elif run.b_prog[w] < run.n_buckets:
                    s = run.b_prog[w]
                    yield (jid, w, "b", run.plan[1][s], s)
                continue
            if run.comm_ready_at is not None or run.comm_active:
                continue  # between barrier and next iteration
            if w not in run.f_done:
                if self.fuse_fb:
                    yield (jid, w, "fb", run.spec.model.t_iter_compute, -1)
                else:
                    yield (jid, w, "f", run.spec.model.t_f, -1)
            elif w not in run.b_done:
                yield (jid, w, "b", run.spec.model.t_b, -1)

    def _schedule_gpus(self, now: float) -> None:
        for gid in list(self._dirty_gpus):
            self._dirty_gpus.discard(gid)
            g = self.cluster.gpus[gid]
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
            g.busy_until = now + dur
            g.busy_job = jid
            g.busy_accum += dur
            self._push(now + dur, "gpu_done", (gid, jid, w, kind, seg))

    # -- main loop ----------------------------------------------------------------
    def run(self, max_time: float = math.inf) -> SimResult:
        for spec in self.jobs.values():
            self._push(spec.arrival, "arrival", (spec.job_id,))
        now = 0.0
        while self._heap and self._unfinished:
            t, _, kind, data = heapq.heappop(self._heap)
            if kind == "comm_check" and data[0] != self._comm_epoch:
                continue
            if t > max_time:
                break
            now = t
            self._events += 1

            finished_comms = self._advance_comm(now)
            for jid in finished_comms:
                run = self._runs[jid]
                run.comm_active = False
                if run.plan is not None:
                    # WFBP: the iteration completes with the last bucket's
                    # transfer; otherwise hand the next ready bucket on
                    run.buckets_done += 1
                    if run.buckets_done >= run.n_buckets:
                        self._complete_iteration(run, now)
                    else:
                        self._maybe_enqueue_bucket(run)
                else:
                    self._complete_iteration(run, now)

            if kind == "arrival":
                jid = data[0]
                self._enqueue(jid)
                self.sched.on_arrival(now, jid)
            elif kind == "gpu_done":
                gid, jid, w, tkind, seg = data
                run = self._runs[jid]
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
            # a comm_check needs nothing beyond the drain above

            if finished_comms:
                # a job finishing through its comm also frees memory: one
                # re-evaluation per event
                for j in finished_comms:
                    if self._runs[j].finished_at is not None:
                        self.sched.on_job_finish(now, j)
                        break

            started = self._try_start_comms(now)
            self._schedule_gpus(now)
            # rates change only when the active set does; a comm_check that
            # finished nothing (float drift) must still reschedule
            if started or finished_comms or kind == "comm_check":
                self._reschedule_comm_check()

        return self._collect(now)

    # -- results ------------------------------------------------------------------
    def _collect(self, now: float) -> SimResult:
        jct, finish, qdelay = {}, {}, {}
        for jid, run in self._runs.items():
            if run.finished_at is not None:
                finish[jid] = run.finished_at
                jct[jid] = run.finished_at - run.spec.arrival
                qdelay[jid] = run.placed_at - run.spec.arrival
        delivered = sum(r.samples_done for r in self._runs.values())
        makespan = max(finish.values()) if finish else now
        busy = {gid: g.busy_accum for gid, g in self.cluster.gpus.items()}
        util = sum(busy.values()) / (len(busy) * makespan) if makespan > 0 else 0.0
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
            censored=len(self.jobs) - len(finish),
            goodput=(delivered / makespan) if makespan > 0 else 0.0,
            job_samples=dict(self._job_samples),
        )
