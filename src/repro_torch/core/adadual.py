"""AdaDUAL — adaptive scheduling of communication tasks (port of
``repro/core/adadual.py``; paper Section IV-B).

The paper proves (Theorems 1-2) the optimal policy for two communication
tasks on the contended-link model of Eq. (5):

* Two tasks ready together (or the new task larger than what is left of the
  running one): run the smaller to completion first — Theorem 1.
* A new task of size ``M_new`` against one in-flight task with remaining
  ``M_old``: start now (2-way contention) iff
  ``M_new / M_old < b / (2*(b + eta))`` — Theorem 2.
* Against >= 2 in-flight tasks the paper always waits.

This module holds the decision rule (:func:`adadual_should_start`), the
closed forms of Eq. (14)'s candidate minima, an exact small-system
integrator (:func:`simulate_two_tasks`, :func:`simulate_task_set`) and the
k-way lookahead built on it (:func:`kway_adadual_should_start`).  Plain
Python floats, in the reference's order of operations, so every decision
and every float is the reference's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

from repro_torch.core import netmodel
from repro_torch.core.contention import ContentionParams

# ---------------------------------------------------------------------------
# Closed forms from the paper (Eqs. 10-14), used by tests.
# ---------------------------------------------------------------------------


def c1_average_completion(t: float, m1: float, m2: float, p: ContentionParams) -> float:
    """Eq. (10c): average completion when the *small* task c1 starts at 0 and
    c2 starts at ``t`` in [0, b*M1].  (Latency ``a`` neglected, as in P1.)"""
    b, eta = p.b, p.eta
    return (-(1.0 + 2.0 * eta / b) * t + (3.0 * b + 2.0 * eta) * m1 + b * m2) / 2.0


def c2a_average_completion(t: float, m1: float, m2: float, p: ContentionParams) -> float:
    """Eq. (11c): c2 (large) starts at 0, c1 starts at t in [0, b*(M2-M1)]."""
    b, eta = p.b, p.eta
    return (t + (3.0 * b + 2.0 * eta) * m1 + b * m2) / 2.0


def c2b_average_completion(t: float, m1: float, m2: float, p: ContentionParams) -> float:
    """Eq. (12c): c2 starts at 0, c1 starts at t in (b*(M2-M1), b*M2]."""
    b, eta = p.b, p.eta
    return (-(1.0 + 2.0 * eta / b) * t + (3.0 * b + 2.0 * eta) * m2 + b * m1) / 2.0


def candidate_minima(m1: float, m2: float, p: ContentionParams) -> Tuple[float, float, float]:
    """Eq. (14): (t_C1, t_C2a, t_C2b) candidate minimum average completions."""
    b, eta = p.b, p.eta
    c1 = (2.0 * b * m1 + b * m2) / 2.0
    c2a = ((3.0 * b + 2.0 * eta) * m1 + b * m2) / 2.0
    c2b = (b * m1 + 2.0 * b * m2) / 2.0
    return c1, c2a, c2b


# ---------------------------------------------------------------------------
# The AdaDUAL decision rule (Algorithm 2).
# ---------------------------------------------------------------------------


def adadual_should_start(
    new_bytes: float,
    old_remaining_bytes: Sequence[float],
    max_concurrent: int,
    params: ContentionParams,
) -> bool:
    """Algorithm 2 decision: should the newly-ready communication task start
    at the current time slot?

    Args:
      new_bytes: message size of the new task.
      old_remaining_bytes: remaining sizes of the in-flight communication
        tasks on the servers the new task would touch (``C_old`` in Alg. 2).
      max_concurrent: ``max_task`` in Alg. 2 — the max number of in-flight
        communication tasks over those servers.
      params: the (a, b, eta) contention model.

    When ``max_concurrent == 1`` but several distinct in-flight tasks touch
    disjoint servers of the new task, the paper's Alg. 2 line 12 implicitly
    assumes a single old task; we apply Theorem 2 against *each* and start
    only if every test passes (conservative) —
    equivalent to testing against the smallest remaining old size, which is
    how the shared predicate (``netmodel.may_start``) expresses it.
    """
    min_old = min(old_remaining_bytes, default=math.inf)
    return bool(
        netmodel.may_start(
            max_concurrent + 1,
            new_bytes,
            min_old,
            max_ways=2,
            threshold_gated=True,
            dual_threshold=params.dual_threshold,
        )
    )


# ---------------------------------------------------------------------------
# Exact integrator for a small set of contending tasks.
#
# This is an exact piecewise-constant-rate integration of Eq. (5) dynamics
# for tasks that all share one contention domain (every task counts every
# other as a contender, i.e. k = number of active tasks).  It is used to
# (a) numerically verify Theorems 1-2 against brute force over start times,
# and (b) implement the k-way lookahead policy.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Flight:
    idx: int
    remaining: float


def simulate_task_set(
    start_times: Sequence[float],
    sizes: Sequence[float],
    params: ContentionParams,
) -> List[float]:
    """Exact completion times for tasks sharing one contention domain.

    Task i becomes ready/starts at ``start_times[i]`` with ``sizes[i]`` bytes.
    While k tasks are in flight, each drains at ``1/(k*b + (k-1)*eta)`` B/s.
    Returns the list of completion times.  The fixed latency ``a`` is
    neglected, exactly as in the paper's problem P1.
    """
    n = len(sizes)
    assert len(start_times) == n
    events = sorted(range(n), key=lambda i: start_times[i])
    finish = [0.0] * n
    in_flight: List[_Flight] = []
    t = 0.0
    next_arrival = 0

    def rate(k: int) -> float:
        return params.rate(k)

    while next_arrival < n or in_flight:
        k = len(in_flight)
        # time to next arrival
        t_arr = start_times[events[next_arrival]] if next_arrival < n else float("inf")
        # time to next completion at current rate
        if k > 0:
            r = rate(k)
            min_rem = min(f.remaining for f in in_flight)
            t_fin = t + min_rem / r
        else:
            t_fin = float("inf")
        if t_arr <= t_fin:
            # advance to arrival
            if k > 0:
                drained = (t_arr - t) * rate(k)
                for f in in_flight:
                    f.remaining -= drained
            t = t_arr
            idx = events[next_arrival]
            in_flight.append(_Flight(idx, float(sizes[idx])))
            next_arrival += 1
        else:
            drained = (t_fin - t) * rate(k)
            if drained <= 0.0:
                # float underflow guard: the smallest remainder is too tiny
                # for `t + rem/rate` to advance the clock — force-drain it,
                # otherwise the loop cannot make progress.
                drained = min(f.remaining for f in in_flight)
            t = t_fin
            still: List[_Flight] = []
            for f in in_flight:
                f.remaining -= drained
                if f.remaining <= 1e-6:  # < 1e-6 bytes ~ femtoseconds
                    finish[f.idx] = t
                else:
                    still.append(f)
            in_flight = still
    return finish


def simulate_two_tasks(
    t_start_second: float, m_first: float, m_second: float, params: ContentionParams
) -> Tuple[float, float]:
    """Completion times (T_first, T_second) when the first task starts at 0
    and the second at ``t_start_second`` (problem P1's setting)."""
    f = simulate_task_set([0.0, t_start_second], [m_first, m_second], params)
    return f[0], f[1]


# ---------------------------------------------------------------------------
# Beyond-paper: k-way AdaDUAL (the paper's future-work item #2).
# ---------------------------------------------------------------------------


def kway_adadual_should_start(
    new_bytes: float,
    old_remaining_bytes: Sequence[float],
    params: ContentionParams,
    max_ways: int = 4,
) -> bool:
    """Decide start-now vs wait against k >= 1 in-flight tasks by exact
    lookahead on the Eq. (5) dynamics.

    Option A (start now): completion times of {olds..., new} all starting at
    the current instant (olds resume with their remaining bytes).
    Option B (wait): the new task starts when the *first* old task finishes
    and then contends with the survivors (one-step lookahead; the online
    scheduler re-evaluates the rule at every state change, so the effective
    policy is the fixed point of this one-step rule).

    Starts only if Option A's average completion time (over the new task and
    all in-flight tasks) is strictly smaller, and never exceeds ``max_ways``
    concurrent tasks (bandwidth efficiency collapse guard, mirroring the
    paper's empirical k<=2 observation but tunable).
    """
    olds = [m for m in old_remaining_bytes if m > 0]
    k = len(olds)
    if k == 0:
        return True
    if k + 1 > max_ways:
        return False
    avg_a, avg_b = kway_lookahead_costs(new_bytes, olds, params)
    return avg_a < avg_b


def kway_lookahead_costs(
    new_bytes: float,
    olds: Sequence[float],
    params: ContentionParams,
) -> Tuple[float, float]:
    """The two evaluated averages of the k-way rule: ``(avg_start_now,
    avg_wait)`` over {olds..., new}.  Factored out of the decision so the
    observability audit log can record exactly what the policy compared.
    ``olds`` must be non-empty with positive remaining bytes."""
    k = len(olds)
    # Option A: everything in flight now.
    now = [0.0] * (k + 1)
    sizes_a = list(olds) + [new_bytes]
    fin_a = simulate_task_set(now, sizes_a, params)
    avg_a = sum(fin_a) / len(fin_a)

    # Option B: olds run contended among themselves; new starts when the first
    # old finishes, then (recursively) contends with the survivors.
    fin_olds = simulate_task_set([0.0] * k, olds, params)
    t_first = min(fin_olds)
    # Remaining bytes of the surviving olds at t_first: all k contended from
    # 0 to t_first, so each drained exactly the smallest task's bytes.
    # (``t_first * rate(k)`` recomputes the same quantity through a
    # division/multiplication round-trip whose float noise used to leave a
    # ~1e-8-byte ghost survivor that was *also* counted as finished,
    # skewing borderline decisions — use the exact value instead and keep
    # done/survivors an exact partition of the olds.)
    drained = min(olds)
    survivors = [m - drained for m in olds if m - drained > 1e-9]
    start_b = [0.0] * len(survivors) + [0.0]
    fin_b_rel = simulate_task_set(start_b, survivors + [new_bytes], params)
    # olds that finished at t_first (ties with the smallest included):
    n_done = k - len(survivors)
    avg_b = (
        n_done * t_first + sum(t_first + f for f in fin_b_rel)
    ) / (n_done + len(fin_b_rel))
    return avg_a, avg_b


def srsf_n_should_start(
    max_concurrent: int,
    n: int,
) -> bool:
    """SRSF(n) baseline gating: start iff the resulting contention on every
    touched server stays <= n (SRSF(1) = avoid all contention; SRSF(2)/(3)
    blindly accept 2-/3-way contention)."""
    return bool(
        netmodel.may_start(
            max_concurrent + 1,
            0.0,
            math.inf,
            max_ways=n,
            threshold_gated=False,
            dual_threshold=0.0,
        )
    )
