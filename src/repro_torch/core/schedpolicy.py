"""Scheduling strategy layer of the event engine (port of
``repro/core/schedpolicy.py``, trimmed to static gang scheduling).

``core/engine.py`` owns the mechanism; every job-level decision goes to a
:class:`SchedPolicy` through ``on_arrival`` (a job joined the wait queue)
and ``on_job_finish`` (a job completed and freed its resources).  Hooks act
through the engine's ``place_job`` and ``remove_queued`` and read its
queue, runs, cluster and SRSF keys.

:class:`StaticGangPolicy` is the paper's Algorithm 3 admission: the wait
queue is scanned in SRSF order and each gang placement is held until the
job completes.  The reference's preemptive and elastic policies are not
ported (ROADMAP queue 1, item 7a).

The communication gating policies (AdaDUAL Algorithm 2, SRSF(n), k-way
AdaDUAL) are the comm-task half of the strategy layer, consulted by the
engine's gating loop through :meth:`CommPolicy.should_start`.
"""

from __future__ import annotations

import heapq
from typing import List, Sequence

from repro_torch.core.adadual import (
    adadual_should_start,
    kway_adadual_should_start,
    srsf_n_should_start,
)
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

    def bind(self, engine) -> None:
        """Called once by the engine before the run starts."""
        self.engine = engine

    def on_arrival(self, now: float, job_id: int) -> None:
        """``job_id`` was just inserted into ``engine.queue``."""

    def on_job_finish(self, now: float, job_id: int) -> None:
        """``job_id`` completed; its memory and GPUs are free again."""


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
        placed = self._scan_buckets(eng, failed, now)
        # the merge drains until every profile is exhausted or failed, so
        # every job still queued is skippable at this epoch
        if placed:
            eng.remove_queued(placed)
        if eng.queue:
            self._queue_all_failed = True

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


SCHED_POLICIES = ("static", "preemptive_srsf", "elastic")


def sched_policy_from_name(sched: str) -> SchedPolicy:
    """'static' -> :class:`StaticGangPolicy`; the reference's
    'preemptive_srsf' and 'elastic' raise ``NotImplementedError``."""
    s = sched.lower()
    if s == "static":
        return StaticGangPolicy()
    if s in ("preemptive_srsf", "preemptive", "elastic"):
        raise NotImplementedError(
            f"sched={sched!r}: the preemptive and elastic policies (preempt_job, "
            "request_resize) are not ported; ROADMAP queue 1, item 7a"
        )
    raise ValueError(
        f"unknown scheduling policy {sched!r}; expected one of {SCHED_POLICIES}"
    )
