"""Scheduling strategy layer of the event engine (port of
``repro/core/schedpolicy.py``).

``core/engine.py`` owns the mechanism; every job-level decision goes to a
:class:`SchedPolicy` through its hooks: ``on_arrival`` (a job joined the
wait queue), ``on_job_finish`` (a job completed or was cancelled and freed
its resources), ``on_quantum`` (the policy's periodic tick), ``on_resize``
(the engine applied a resize), ``on_fault`` / ``on_recovery`` (a server
broke down or came back).  Hooks act through the engine's ``place_job``,
``remove_queued``, ``preempt_job`` and ``request_resize`` and read its
queue, runs, cluster and SRSF keys.

:class:`StaticGangPolicy` is the paper's Algorithm 3 admission: the wait
queue is scanned in SRSF order and each gang placement is held until the
job completes.  :class:`PreemptiveSrsfPolicy` (Tiresias-style gang
preemption) and :class:`ElasticPolicy` (min/max-GPU gangs resized at
iteration boundaries) build on it.

The communication gating policies (AdaDUAL Algorithm 2, SRSF(n), k-way
AdaDUAL) are the comm-task half of the strategy layer, consulted by the
engine's gating loop through :meth:`CommPolicy.should_start`.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import List, Optional, Sequence

from repro_torch.core.adadual import (
    adadual_should_start,
    kway_adadual_should_start,
    kway_lookahead_costs,
    srsf_n_should_start,
)
from repro_torch.core.cluster import JobSpec
from repro_torch.core.contention import ContentionParams

# ---------------------------------------------------------------------------
# Communication gating policies
# ---------------------------------------------------------------------------


class CommPolicy:
    """Decides whether a ready communication task may start now.

    ``max_concurrent`` and ``old_remaining`` describe the in-flight
    communication tasks on the contention domains the new task loads
    (Alg. 2's inputs).
    """

    name = "base"
    #: A False decision cannot flip to True while in-flight transfers only
    #: drain (no start/end on the waiter's domains): the engine's
    #: incremental gating then skips re-evaluating stably-False waiters.
    #: AdaDUAL qualifies (drain only shrinks ``min(old_remaining)``),
    #: SRSF(n) trivially; the exact k-way lookahead does not.
    drain_monotone = False
    #: The decision reads ``old_remaining`` only through its minimum: the
    #: engine then calls :meth:`should_start_min` without building the list.
    scalar_gate = False

    def should_start(
        self,
        new_bytes: float,
        old_remaining: Sequence[float],
        max_concurrent: int,
        params: ContentionParams,
    ) -> bool:
        raise NotImplementedError

    def should_start_min(
        self,
        new_bytes: float,
        min_old: float,
        max_concurrent: int,
        params: ContentionParams,
    ) -> bool:
        """``should_start`` given only ``min(old_remaining)`` (``inf`` for
        an empty overlap set); only meaningful when ``scalar_gate``."""
        raise NotImplementedError

    def explain(
        self,
        new_bytes: float,
        old_remaining: Sequence[float],
        max_concurrent: int,
        params: ContentionParams,
    ) -> Optional[dict]:
        """The terms ``should_start`` evaluated, for the observability
        audit (``ObsConfig(audit=True)``).  Never read by the gating loop;
        a policy without an override audits its decisions only (None)."""
        return None


class SrsfN(CommPolicy):
    """SRSF(n): accept at most n-way contention, blindly (paper baselines)."""

    drain_monotone = True  # decision reads max_concurrent only
    scalar_gate = True

    def __init__(self, n: int) -> None:
        self.n = n
        self.name = f"SRSF({n})"

    def should_start(self, new_bytes, old_remaining, max_concurrent, params) -> bool:
        return srsf_n_should_start(max_concurrent, self.n)

    def should_start_min(self, new_bytes, min_old, max_concurrent, params) -> bool:
        # srsf_n_should_start inlined: uncontended | k_would <= n
        return max_concurrent == 0 or max_concurrent + 1 <= self.n

    def explain(self, new_bytes, old_remaining, max_concurrent, params):
        return {
            "rule": "max_concurrent + 1 <= n",
            "max_concurrent": max_concurrent,
            "n": self.n,
        }


class AdaDual(CommPolicy):
    """The paper's AdaDUAL (Algorithm 2)."""

    name = "Ada-SRSF"
    drain_monotone = True
    scalar_gate = True

    def should_start(self, new_bytes, old_remaining, max_concurrent, params) -> bool:
        return adadual_should_start(new_bytes, old_remaining, max_concurrent, params)

    def should_start_min(self, new_bytes, min_old, max_concurrent, params) -> bool:
        # netmodel.may_start(k+1, new, min_old, max_ways=2, gated) inlined,
        # the same comparison (new < threshold * min_old)
        return max_concurrent == 0 or (
            max_concurrent <= 1 and new_bytes < params.dual_threshold * min_old
        )

    def explain(self, new_bytes, old_remaining, max_concurrent, params):
        min_old = min(old_remaining) if old_remaining else float("inf")
        ratio = (new_bytes / min_old) if min_old > 0 else float("inf")
        return {
            "rule": "new/min(old) < threshold and k+1 <= 2",
            "min_old_bytes": min_old,
            "ratio": ratio,
            "threshold": params.dual_threshold,
            "cap_ok": max_concurrent + 1 <= 2,
        }


class KWayAdaDual(CommPolicy):
    """Exact-lookahead k-way generalization (the paper's future work #2)."""

    drain_monotone = False  # the lookahead integrates remaining bytes

    def __init__(self, max_ways: int = 3) -> None:
        self.max_ways = max_ways
        self.name = f"KWay({max_ways})-SRSF"

    def should_start(self, new_bytes, old_remaining, max_concurrent, params) -> bool:
        return kway_adadual_should_start(
            new_bytes, old_remaining, params, max_ways=self.max_ways
        )

    def explain(self, new_bytes, old_remaining, max_concurrent, params):
        olds = [m for m in old_remaining if m > 0]
        k = len(olds)
        terms = {
            "rule": "avg(start now) < avg(wait for first old)",
            "k_in_flight": k,
            "max_ways": self.max_ways,
        }
        if k == 0:
            terms["clean_link"] = True
        elif k + 1 > self.max_ways:
            terms["ways_capped"] = True
        else:
            avg_a, avg_b = kway_lookahead_costs(new_bytes, olds, params)
            terms["t_contend_avg"] = avg_a
            terms["t_wait_avg"] = avg_b
        return terms


def comm_policy_from_name(comm: str) -> CommPolicy:
    """'ada' (AdaDUAL), 'srsfN', or 'kwayK' -> a CommPolicy instance."""
    if comm == "ada":
        return AdaDual()
    if comm.startswith("srsf"):
        return SrsfN(int(comm[4:]))
    if comm.startswith("kway"):
        return KWayAdaDual(int(comm[4:]))
    raise ValueError(f"unknown comm policy {comm!r}")


# ---------------------------------------------------------------------------
# Job scheduling policies
# ---------------------------------------------------------------------------


class SchedPolicy:
    """Job-level scheduling strategy consulted by ``core/engine.py``: it
    decides which jobs run where by calling the engine's decision API from
    its hooks."""

    name = "base"
    #: period of the engine's "quantum" events; None schedules none (the
    #: static policy's event stream has no ticks)
    quantum: Optional[float] = None

    def bind(self, engine) -> None:
        """Called once by the engine before the run starts."""
        self.engine = engine

    def on_arrival(self, now: float, job_id: int) -> None:
        """``job_id`` was just inserted into ``engine.queue``."""

    def on_job_finish(self, now: float, job_id: int) -> None:
        """``job_id`` completed or was cancelled; its memory and GPUs are
        free again."""

    def on_quantum(self, now: float) -> None:
        """Periodic tick (only fired when ``quantum`` is set)."""

    def on_resize(self, now: float, job_id: int) -> None:
        """The engine applied a pending resize of ``job_id`` at an
        iteration boundary (capacity may have been freed)."""

    def on_fault(self, now: float, server: int, victims: Sequence[int]) -> None:
        """A server broke down: its gangs (``victims``) were preempted and
        requeued, its GPUs are unplaceable until repair."""

    def on_recovery(self, now: float, server: int) -> None:
        """A broken server came back: its GPUs are placeable again."""


class StaticGangPolicy(SchedPolicy):
    """The paper's Algorithm 3 admission — SRSF-ordered queue scan, gang
    placement held until completion, no preemption, no elasticity."""

    name = "static"

    def bind(self, engine) -> None:
        super().bind(engine)
        # Every placement policy is a pure function of (n_gpus, mem_mb)
        # given the cluster state, and a failed attempt mutates nothing (the
        # rand policy draws only on success), so a failed profile keeps
        # failing until capacity grows — a release, which bumps
        # ``capacity_epoch``.  The memo is keyed on that epoch.
        self._failed_profiles: set = set()
        self._failed_epoch = -1
        # True after a scan that left jobs queued: every queued profile is
        # then in the memo, so at an unchanged epoch the next scan is one
        # long skip.  Cleared on an epoch bump and by on_arrival when a
        # fresh profile joins.
        self._queue_all_failed = False

    def on_arrival(self, now: float, job_id: int) -> None:
        if self._queue_all_failed:
            eng = self.engine
            if (
                eng.cluster.capacity_epoch == self._failed_epoch
                and eng.queue_profile_of[job_id] in self._failed_profiles
            ):
                return  # the scan would skip every job
            self._queue_all_failed = False
        self._place_queue(now)

    def on_job_finish(self, now: float, job_id: int) -> None:
        self._place_queue(now)

    def on_quantum(self, now: float) -> None:
        self._place_queue(now)

    def on_resize(self, now: float, job_id: int) -> None:
        self._place_queue(now)

    def on_fault(self, now: float, server: int, victims: Sequence[int]) -> None:
        # surviving servers may still fit the requeued victims
        self._place_queue(now)

    def on_recovery(self, now: float, server: int) -> None:
        # everything queued behind the failure competes for the repaired
        # capacity in one SRSF-ordered scan
        self._place_queue(now)

    def _place_queue(self, now: float) -> None:
        eng = self.engine
        if not eng.queue:
            return
        failed = self._failed_profiles
        epoch = eng.cluster.capacity_epoch
        if self._failed_epoch != epoch:
            failed.clear()
            self._failed_epoch = epoch
            self._queue_all_failed = False
        elif self._queue_all_failed:
            return
        if eng._windex is not None:
            placed = self._scan_buckets(eng, failed, now)
            # the merge drains until every profile is exhausted or failed,
            # so every job still queued is skippable at this epoch
            if placed:
                eng.remove_queued(placed)
            if eng.queue:
                self._queue_all_failed = True
        else:
            placed = self._scan_queue(eng, failed, now)
            if placed:
                eng.remove_queued(placed)
            else:
                self._queue_all_failed = True

    def _scan_queue(self, eng, failed: set, now: float) -> List[int]:
        """The whole-queue scan (the ``workloads="rescan"`` oracle of
        :meth:`_scan_buckets`): every queued job in SRSF order, skipping
        failed profiles."""
        placed: List[int] = []
        refreshed = False
        jobs = eng.jobs
        prof = eng.queue_profile_of
        for jid in eng.queue:
            profile = prof[jid]
            if profile in failed:
                continue  # no head-of-line blocking (Alg. 3 loops the queue)
            if not refreshed:
                # Alg. 3 line 3, deferred to the first real attempt
                eng.refresh_workloads()
                refreshed = True
            gpu_ids = eng.placement(eng.cluster, jobs[jid])
            if gpu_ids is None:
                failed.add(profile)
                continue
            eng.place_job(jid, gpu_ids, now)
            failed.clear()
            placed.append(jid)
        return placed

    def _scan_buckets(self, eng, failed: set, now: float) -> List[int]:
        """Bucket-merge admission scan: pops the SRSF-smallest head across
        the per-profile queue buckets (``engine.queue_buckets``, each in
        queue order), skipping failed profiles wholesale.  It places the
        same jobs in the same order as a walk of the whole queue in SRSF
        order: within a pass capacity only shrinks, so a profile that
        failed once fails again, with no side effect."""
        buckets = eng.queue_buckets
        key = eng.srsf_key_queued
        pos: dict = {}
        heap = [(key(lst[0]), p) for p, lst in buckets.items() if p not in failed]
        heapq.heapify(heap)
        placed: List[int] = []
        refreshed = False
        while heap:
            _, profile = heapq.heappop(heap)
            lst = buckets[profile]
            i = pos.get(profile, 0)
            jid = lst[i]
            if not refreshed:
                # Alg. 3 line 3, deferred to the first real attempt: the
                # workloads only order a placement's GPU choice
                eng.refresh_workloads()
                refreshed = True
            gpu_ids = eng.placement(eng.cluster, eng.jobs[jid])
            if gpu_ids is None:
                failed.add(profile)
                continue  # capacity only shrinks: out for the whole pass
            eng.place_job(jid, gpu_ids, now)
            placed.append(jid)
            i += 1
            pos[profile] = i
            if i < len(lst):
                heapq.heappush(heap, (key(lst[i]), profile))
        return placed


class PreemptiveSrsfPolicy(StaticGangPolicy):
    """Tiresias-style preemptive SRSF (beyond-paper).

    On every arrival and quantum tick, after the normal queue scan, each
    still-waiting job may evict running jobs whose SRSF remaining service
    exceeds its own by more than ``margin`` (hysteresis against thrash).
    Victims are checkpointed (``engine.preempt_job``: gang torn down
    atomically, progress carried in completed iterations) and requeued;
    they pay the checkpoint/restore penalty when they next run.  A victim
    younger than ``min_run`` seconds is immune, bounding preemption
    frequency the way Tiresias' promotion knob does.
    """

    name = "preemptive_srsf"

    def __init__(
        self,
        quantum: float = 25.0,
        margin: float = 1.25,
        min_run: Optional[float] = None,
    ) -> None:
        if quantum <= 0:
            raise ValueError(f"quantum must be positive, got {quantum}")
        if margin < 1.0:
            raise ValueError(f"margin must be >= 1, got {margin}")
        self.quantum = quantum
        self.margin = margin
        self.min_run = quantum if min_run is None else min_run

    def on_arrival(self, now: float, job_id: int) -> None:
        self._place_queue(now)
        self._preempt_for_queue(now)

    def on_quantum(self, now: float) -> None:
        self._place_queue(now)
        self._preempt_for_queue(now)

    def _preempt_for_queue(self, now: float) -> None:
        eng = self.engine
        if not eng.queue:
            return
        eng.refresh_workloads()
        eng.queue.sort(key=eng.srsf_key_queued)
        total_gpus = len(eng.cluster.gpus)
        gpu_mem = next(iter(eng.cluster.gpus.values())).mem_capacity_mb
        placed: List[int] = []
        for jid in list(eng.queue):
            spec = eng.jobs[jid]
            need = spec.n_gpus
            if need > total_gpus or spec.model.mem_mb > gpu_mem:
                continue  # can never be placed: evicting for it is pure churn
            # capacity freed by an earlier waiter's evictions may already
            # fit this one — always retry plain placement before evicting
            gpu_ids = eng.placement(eng.cluster, spec)
            if gpu_ids is not None:
                eng.place_job(jid, gpu_ids, now)
                placed.append(jid)
                continue
            waiter_rem = eng.srsf_key_queued(jid)[0]
            victims = sorted(
                (
                    (eng.srsf_key_running(rid)[0], rid)
                    for rid, run in eng.runs.items()
                    if run.finished_at is None
                    and now - run.placed_at >= self.min_run
                    and eng.srsf_key_running(rid)[0] > waiter_rem * self.margin
                ),
                reverse=True,
            )
            if not victims:
                continue
            gpu_ids = None
            evicted = 0
            for _, rid in victims:
                evicted += eng.runs[rid].n_world
                eng.preempt_job(rid, now)
                # re-rank with the victim's workload actually gone, so the
                # waiter lands on the just-freed GPUs instead of LWF still
                # seeing them as loaded (cluster.release keeps L_g)
                eng.refresh_workloads()
                gpu_ids = eng.placement(eng.cluster, eng.jobs[jid])
                if gpu_ids is not None:
                    break
                if evicted >= need:
                    break  # enough GPUs torn down; memory still blocks us
            if gpu_ids is not None:
                eng.place_job(jid, gpu_ids, now)
                placed.append(jid)
        eng.remove_queued(placed)


class ElasticPolicy(StaticGangPolicy):
    """Elastic gang scheduling (beyond-paper).

    Jobs that declare ``JobSpec.min_gpus``/``max_gpus`` are *elastic*:
    their total work is fixed in samples (``iterations x nominal GPUs``)
    and their world size may change at iteration boundaries.  The policy

    * admits an elastic job at the largest feasible size within its
      bounds (preferring max, then the nominal request, then min);
    * **shrinks** running elastic gangs toward ``min_gpus`` when queued
      work cannot be placed (resize requests applied by the engine at the
      next iteration boundary, freeing GPUs for the queue);
    * **grows** the running elastic job with the most remaining service
      into capacity freed by a finishing job.

    Every resize tears the gang down at a boundary and re-places it, so
    the WFBP fusion plan and the topology domain sets are rebuilt for the
    new world size by the same code path as a fresh admission.
    """

    name = "elastic"

    def __init__(self, quantum: Optional[float] = None) -> None:
        # a quantum is optional: arrivals/finishes/resizes already trigger
        # re-evaluation; a tick adds periodic growth on long-idle clusters
        self.quantum = quantum

    # -- admission ---------------------------------------------------------
    def _candidate_sizes(self, spec: JobSpec) -> List[int]:
        if not spec.is_elastic:
            return [spec.n_gpus]
        lo, hi = spec.gpu_bounds
        return sorted({hi, spec.n_gpus, lo}, reverse=True)

    def _place_queue(self, now: float) -> None:
        eng = self.engine
        if not eng.queue:
            return
        eng.refresh_workloads()
        eng.queue.sort(key=eng.srsf_key_queued)
        placed: List[int] = []
        for jid in eng.queue:
            spec = eng.jobs[jid]
            for n in self._candidate_sizes(spec):
                trial = (
                    spec if n == spec.n_gpus else dataclasses.replace(spec, n_gpus=n)
                )
                gpu_ids = eng.placement(eng.cluster, trial)
                if gpu_ids is not None:
                    eng.place_job(jid, gpu_ids, now)
                    placed.append(jid)
                    break
        eng.remove_queued(placed)

    # -- elasticity --------------------------------------------------------
    def on_arrival(self, now: float, job_id: int) -> None:
        self._place_queue(now)
        self._shrink_for_queue(now)

    def on_job_finish(self, now: float, job_id: int) -> None:
        self._place_queue(now)
        self._grow_into_free(now)

    def on_quantum(self, now: float) -> None:
        self._place_queue(now)
        self._shrink_for_queue(now)
        self._grow_into_free(now)

    def on_resize(self, now: float, job_id: int) -> None:
        self._place_queue(now)

    def on_fault(self, now: float, server: int, victims: Sequence[int]) -> None:
        # capacity just shrank: re-place what fits, then shrink elastic
        # gangs so the breakdown's victims get back in sooner
        self._place_queue(now)
        self._shrink_for_queue(now)

    def on_recovery(self, now: float, server: int) -> None:
        # repaired capacity: queue first, then grow elastic gangs into
        # whatever the re-admitted jobs left free
        self._place_queue(now)
        self._grow_into_free(now)

    def _shrink_for_queue(self, now: float) -> None:
        """Request boundary shrinks of elastic gangs until the freed GPU
        count covers the smallest waiting job's requirement."""
        eng = self.engine
        if not eng.queue:
            return
        needed = min(eng.jobs[jid].gpu_bounds[0] for jid in eng.queue)
        freeable = 0
        shrinkable = sorted(
            (
                (run.n_world, rid)
                for rid, run in eng.runs.items()
                if run.finished_at is None
                and eng.jobs[rid].is_elastic
                and run.pending_resize is None
                and run.n_world > eng.jobs[rid].gpu_bounds[0]
            ),
            reverse=True,
        )
        for n_world, rid in shrinkable:
            lo = eng.jobs[rid].gpu_bounds[0]
            eng.request_resize(rid, lo)
            freeable += n_world - lo
            if freeable >= needed:
                break

    def _grow_into_free(self, now: float) -> None:
        """Grow the running elastic job with the most remaining service
        into currently-free feasible GPUs (one job per event; the resize
        hook re-evaluates, so growth cascades without overcommitting)."""
        eng = self.engine
        if eng.queue:
            return  # queued work has first claim on free capacity
        candidates = sorted(
            (
                (eng.srsf_key_running(rid)[0], rid)
                for rid, run in eng.runs.items()
                if run.finished_at is None
                and eng.jobs[rid].is_elastic
                and run.pending_resize is None
                and run.n_world < eng.jobs[rid].gpu_bounds[1]
            ),
            reverse=True,
        )
        for _, rid in candidates:
            run = eng.runs[rid]
            free = len(eng.cluster.available_gpus(eng.jobs[rid].model.mem_mb))
            if free <= 0:
                return
            hi = eng.jobs[rid].gpu_bounds[1]
            eng.request_resize(rid, min(hi, run.n_world + free))
            return


SCHED_POLICIES = ("static", "preemptive_srsf", "elastic")


def sched_policy_from_name(
    sched: str,
    quantum: Optional[float] = None,
    **kw,
) -> SchedPolicy:
    """'static' | 'preemptive_srsf' | 'elastic' -> a :class:`SchedPolicy`.

    ``quantum`` overrides the policy's default tick period (ignored by
    ``static``, which never ticks)."""
    s = sched.lower()
    if s == "static":
        return StaticGangPolicy()
    if s in ("preemptive_srsf", "preemptive"):
        if quantum is not None:
            kw["quantum"] = quantum
        return PreemptiveSrsfPolicy(**kw)
    if s == "elastic":
        return ElasticPolicy(quantum=quantum, **kw)
    raise ValueError(
        f"unknown scheduling policy {sched!r}; expected one of {SCHED_POLICIES}"
    )
