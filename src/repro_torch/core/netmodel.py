"""Policy/network array layer of the fluid simulator (port of
``repro/core/netmodel.py``).

The scalar helpers (:class:`PolicySpec`, :func:`parse_policy`,
:func:`canonical_placement`, :func:`server_bandwidth_array`,
:func:`fusion_threshold`, :func:`fusion_plan`, :func:`plan_for_model`) are
plain-Python copies.  The array functions are written for torch tensors
with any number of leading batch axes (the fluid simulator puts its lane
axis first, so a ``(J, J)`` matrix of the reference is ``(L, J, J)`` here
and ``olds @ m`` a batched product); constants are built on the tensor's
device.  Each one rounds as the reference does: same operations, same
order, Python-float coefficients taken as float32.  The ``random``
placement's draws come from the caller (``repro_torch.prng``).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Eq. (5) rate model and contention levels
# ---------------------------------------------------------------------------


def rate_ratio(k: torch.Tensor, b: float, eta: float) -> torch.Tensor:
    """Fraction of the contention-free bandwidth one task keeps under
    k-way contention: ``b / (k*b + (k-1)*eta)``.  The numerator is a
    0-dim float32 tensor so the quotient is a true division (``float /
    tensor`` in torch multiplies by a reciprocal, which rounds
    differently)."""
    denom = k * b + (k - 1) * eta
    return torch.div(torch.tensor(b, dtype=denom.dtype), denom)


def domain_counts(loads: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Per-domain count of in-flight tasks: ``loads`` ``(..., J, D)`` bool,
    ``active`` ``(..., J)`` bool -> ``(..., D)`` int32."""
    return (loads & active[..., None]).sum(-2, dtype=torch.int32)


def domain_k(loads: torch.Tensor, weighted_counts: torch.Tensor, extra: int = 0) -> torch.Tensor:
    """Each task's contention level: the max of ``weighted_counts + extra``
    over the domains it loads, clamped to >= 1.  Raw int32 counts give the
    gating-side k, ``counts * oversub`` the Eq. (5) effective k."""
    w = weighted_counts + extra if extra else weighted_counts
    return (loads * w[..., None, :]).amax(-1).clamp(min=1)


def server_bandwidth_array(server_bandwidth: Sequence[float], n_servers: int) -> np.ndarray:
    """Per-server relative NIC bandwidth as a dense ``(n_servers,)`` array;
    servers beyond the tuple are nominal (1.0), extra entries dropped."""
    bw = np.ones((max(0, n_servers),), dtype=np.float64)
    for s, scale in enumerate(server_bandwidth[:n_servers]):
        bw[s] = scale
    return bw


def slowest_member_scale(bw: torch.Tensor, member_mask: torch.Tensor) -> torch.Tensor:
    """Drain-rate multiplier of each task: the smallest ``bw`` over its
    member servers (``member_mask`` bool ``(..., S)``), or 1.0 without
    members.  Bit-identical to the reference's sentinel arithmetic, which
    yields exactly the member minimum or exactly 1.0."""
    lo = torch.where(member_mask, bw, torch.full_like(bw, 1e30)).amin(-1)
    return torch.where(member_mask.any(-1), lo, torch.ones_like(lo))


# ---------------------------------------------------------------------------
# Tensor fusion (wait-free backpropagation, WFBP)
# ---------------------------------------------------------------------------


def fusion_threshold(fusion) -> float:
    """Normalize a fusion spec to a byte threshold: ``"all"`` -> inf,
    ``"none"``/0 -> 0.0, a positive number -> itself."""
    if isinstance(fusion, str):
        f = fusion.lower()
        if f == "all":
            return float("inf")
        if f == "none":
            return 0.0
        raise ValueError(
            f"unknown fusion spec {fusion!r}; expected 'all', 'none' or bytes"
        )
    thr = float(fusion)
    if thr < 0:
        raise ValueError(f"fusion threshold must be >= 0, got {fusion}")
    return thr


def fusion_plan(
    layer_bytes: Sequence[float],
    layer_t_b: Sequence[float],
    threshold: float,
) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
    """Greedy WFBP tensor fusion over layers in backward-ready order:
    layers accumulate into a bucket until it reaches ``threshold`` bytes,
    then it seals (PyTorch DDP's ``bucket_cap``).  Returns per-bucket
    gradient bytes and backward seconds; ``threshold=inf`` gives one
    bucket, ``0`` one per layer, and both sums are preserved."""
    if len(layer_bytes) != len(layer_t_b):
        raise ValueError(
            f"layer_bytes ({len(layer_bytes)}) and layer_t_b "
            f"({len(layer_t_b)}) must align"
        )
    if not layer_bytes:
        raise ValueError("fusion_plan needs at least one layer")
    sizes: list = []
    times: list = []
    acc_b = acc_t = 0.0
    for lb, lt in zip(layer_bytes, layer_t_b):
        acc_b += float(lb)
        acc_t += float(lt)
        if acc_b >= threshold:
            sizes.append(acc_b)
            times.append(acc_t)
            acc_b = acc_t = 0.0
    if acc_b > 0.0 or acc_t > 0.0 or not sizes:
        sizes.append(acc_b)
        times.append(acc_t)
    return tuple(sizes), tuple(times)


def plan_for_model(model, fusion) -> Optional[Tuple[Tuple[float, ...], Tuple[float, ...]]]:
    """The fusion plan of one ``ModelProfile``, or None where the
    monolithic path applies (``fusion="all"``, or no per-layer data)."""
    thr = fusion_threshold(fusion)
    if thr == float("inf") or not getattr(model, "layer_grad_bytes", ()):
        return None
    return fusion_plan(model.layer_grad_bytes, model.layer_t_b, thr)


# ---------------------------------------------------------------------------
# Communication gating policies
# ---------------------------------------------------------------------------

POLICY_PATTERN = re.compile(r"^(ada|srsf([1-9])|kway([2-9]))$")


@dataclasses.dataclass(frozen=True)
class PolicySpec:
    """A gating policy as (max_ways, threshold_gated[, exact_lookahead]):
    AdaDUAL is (2, gated), SRSF(n) is (n, blind), k-way AdaDUAL is
    (K, gated, exact)."""

    name: str
    max_ways: int
    threshold_gated: bool
    exact_lookahead: bool = False


def parse_policy(name: str) -> PolicySpec:
    """'ada' | 'srsfN' | 'kwayK' -> a :class:`PolicySpec`."""
    m = POLICY_PATTERN.match(name)
    if not m:
        raise ValueError(
            f"unknown comm policy {name!r}; expected 'ada', 'srsfN' or 'kwayK'"
        )
    if name == "ada":
        return PolicySpec("ada", 2, True)
    if name.startswith("srsf"):
        return PolicySpec(name, int(m.group(2)), False)
    return PolicySpec(name, int(m.group(3)), True, exact_lookahead=True)


def may_start_dynamic(
    k_would,
    new_cost,
    min_old_rem,
    max_ways,
    threshold_gated,
    dual_threshold: float,
    *,
    exact_kway_olds=None,
    rem=None,
    eta_over_b=None,
    exact_tol: float = 1e-9,
):
    """Threshold gating predicate with runtime policy parameters: a start
    is allowed when uncontended (``k_would <= 1``), or under the cap
    ``max_ways`` and, for gated policies, passing Theorem 2's
    ``new_cost < dual_threshold * min_old_rem``.  ``threshold_gated`` is
    a Python bool or a bool tensor.  With ``exact_kway_olds`` (the
    ``(..., J, J)`` in-flight overlap rows), ``rem`` and ``eta_over_b``
    the test is :func:`kway_exact_start` instead."""
    if exact_kway_olds is not None:
        return kway_exact_start(
            new_cost, rem, exact_kway_olds, max_ways, eta_over_b, tol=exact_tol
        )
    uncontended = k_would <= 1
    under_cap = k_would <= max_ways
    ratio_ok = new_cost < dual_threshold * min_old_rem
    if isinstance(threshold_gated, bool):
        contended_ok = under_cap & ratio_ok if threshold_gated else under_cap
    else:
        contended_ok = under_cap & (ratio_ok | ~threshold_gated)
    return uncontended | contended_ok


def gating_fixed_point(
    r1,
    priority,
    loads,
    counts,
    overlap,
    active,
    rem,
    new_cost,
    max_ways,
    threshold_gated,
    dual_threshold: float,
    *,
    exact_kway: bool = False,
    eta_over_b=None,
    not_eye,
    job_index,
):
    """One-shot greedy closure of the per-tick WFBP re-gating loop: the
    start set ``(r1 & r2) | c1``, where ``r1`` passes against the base
    active set, ``r2`` passes the pessimistic test against the base set
    plus every other ``r1`` candidate, and ``c1`` is the smallest-
    ``priority`` ``r1`` candidate (first index on ties).  The reference's
    docstring gives the antitone argument why this equals the sequential
    loop's closure.

    Shapes: ``r1``/``priority``/``active``/``rem``/``new_cost`` ``(..., J)``,
    ``loads`` ``(..., J, D)``, ``counts`` ``(..., D)`` int32, ``overlap``
    ``(..., J, J)`` bool.  ``not_eye`` (``~eye(J)``, bool) and
    ``job_index`` (``arange(J)``) come prebuilt, so that a CUDA graph of
    the tick allocates nothing for them."""
    # pessimistic active set per candidate: base + (r1 minus itself)
    counts2 = counts + domain_counts(loads, r1)
    k_would2 = domain_k(loads, counts2)
    olds2 = (overlap & (active | r1)[..., None, :]) & not_eye
    big = 1e30  # finite "absent" sentinel: 0 * big stays NaN-free
    o2 = olds2 * 1.0
    min_old2 = (o2 * rem[..., None, :] + (1.0 - o2) * big).amin(-1)
    if exact_kway:
        r2 = kway_exact_start(new_cost, rem, olds2, max_ways, eta_over_b)
    else:
        r2 = may_start_dynamic(
            k_would2, new_cost, min_old2, max_ways, threshold_gated, dual_threshold,
        )
    # greedy head: smallest-priority r1 candidate (round 1's start)
    head = (r1 * priority + (1.0 - r1 * 1.0) * big).argmin(-1, keepdim=True)
    c1 = r1 & (job_index == head)
    return (r1 & r2) | c1


def _pairwise_min(x, y):
    """Elementwise min as the reference writes it, ``(x + y - |x - y|) / 2``
    (broadcasting), so it rounds as the reference does."""
    return 0.5 * (x + y - torch.abs(x - y))


def kway_exact_start(
    new_cost,
    rem,
    olds_mask,
    max_ways,
    eta_over_b,
    tol: float = 1e-9,
):
    """Exact k-way AdaDUAL gate for every candidate: start now (option A,
    ``olds + new`` simultaneous) iff its average finish time is strictly
    smaller than waiting for the first old transfer to finish (option B),
    or the candidate is uncontended; never when ``k + 1 > max_ways``.  The
    closed form of the reference (finish time of ``x`` in a simultaneous
    set: ``(1 + e) * sum_y min(s_x, s_y) - e * s_x``), with its quadratic
    forms as batched products.

    ``new_cost``/``rem`` are ``(..., J)`` float32, ``olds_mask`` the
    ``(..., J, J)`` bool rows of in-flight tasks overlapping each
    candidate; returns ``(..., J)`` bool."""
    e = eta_over_b
    big = 1e30  # f32-safe "no old task" sentinel
    olds = olds_mask * 1.0  # (..., J, J) float mask
    k = olds.sum(-1)  # (..., J) in-flight tasks overlapping each candidate
    rem_row = rem[..., None, :]
    m = _pairwise_min(rem[..., :, None], rem_row)  # (..., J, J) pairwise mins
    # option A: olds + new simultaneous from now
    q_a = ((olds @ m) * olds).sum(-1)
    cross_a = (olds * _pairwise_min(new_cost[..., :, None], rem_row)).sum(-1)
    pairmin_a = q_a + 2.0 * cross_a + new_cost
    sum_a = (olds * rem_row).sum(-1) + new_cost
    avg_a = ((1.0 + e) * pairmin_a - e * sum_a) / (k + 1.0)
    # option B: wait for the first old to finish, then start
    m_min = (rem_row * olds + big * (1.0 - olds)).amin(-1) * (k > 0)
    t1 = m_min * (k + (k - 1.0) * e)
    shifted = rem_row - m_min[..., :, None]  # survivor sizes after t1
    sv = olds * (shifted > tol)
    kp = sv.sum(-1)
    q_sv = ((sv @ m) * sv).sum(-1) - kp * kp * m_min  # shifted quadratic form
    cross_b = (sv * _pairwise_min(shifted, new_cost[..., :, None])).sum(-1)
    pairmin_b = q_sv + 2.0 * cross_b + new_cost
    sum_b = (sv * shifted).sum(-1) + new_cost
    f_b = (1.0 + e) * pairmin_b - e * sum_b
    avg_b = t1 + f_b / (k + 1.0)
    return (k <= 0) | ((k + 1.0 <= max_ways) & (avg_a < avg_b))


# ---------------------------------------------------------------------------
# Placement-mode ranking (gang placement)
# ---------------------------------------------------------------------------

PLACEMENT_MODES = ("consolidate", "first_fit", "least_loaded", "random", "rack_pack")

#: Event-backend placement names -> fluid gang analogue.
FLUID_PLACEMENT_ALIASES = {
    "lwf": "consolidate",
    "gang": "consolidate",
    "consolidate": "consolidate",
    "ff": "first_fit",
    "first_fit": "first_fit",
    "ls": "least_loaded",
    "least_loaded": "least_loaded",
    "rand": "random",
    "random": "random",
    "lwf_rack": "rack_pack",
    "rack_pack": "rack_pack",
}


def canonical_placement(name: str) -> str:
    """Map an event-backend placement name to the fluid gang mode."""
    try:
        return FLUID_PLACEMENT_ALIASES[name.lower()]
    except KeyError:
        raise ValueError(
            f"fluid backend supports placements {sorted(FLUID_PLACEMENT_ALIASES)}, "
            f"got {name!r}"
        ) from None


def rack_pack_rank(free: torch.Tensor, server_rack: torch.Tensor, n_racks: int,
                   gpus_per_server: int) -> torch.Tensor:
    """Rank key of the ``rack_pack`` mode: the rack with the most free GPUs
    first, then most-free servers within it.  ``free`` is ``(..., S)``,
    ``server_rack`` the ``(S,)`` rack index of each server.  Small
    integers throughout, so exact in float32."""
    racks = torch.arange(n_racks, device=server_rack.device)
    one_hot = (server_rack[:, None] == racks).to(free.dtype)  # (S, R)
    rack_free = (one_hot * free[..., None]).sum(-2)  # (..., R)
    rack_free_per_server = (one_hot * rack_free[..., None, :]).sum(-1)  # (..., S)
    return -(rack_free_per_server * (gpus_per_server + 1) + free)


def placement_rank(mode: str, free: torch.Tensor, load: torch.Tensor,
                   server_index: torch.Tensor, rank_extra=None) -> torch.Tensor:
    """Primary sort key per server for gang placement (ascending, ties by
    server index): ``consolidate`` -> ``-free``, ``first_fit`` -> index,
    ``least_loaded`` -> remaining-service load, ``random`` -> the caller's
    uniform draw per server (a fresh random server order per admission),
    ``rack_pack`` -> the caller's :func:`rack_pack_rank`."""
    if mode == "consolidate":
        return -free
    if mode == "first_fit":
        return server_index.expand_as(free)
    if mode == "least_loaded":
        return load
    if mode in ("random", "rack_pack"):
        if rank_extra is None:
            raise ValueError(f"mode {mode!r} needs a caller-supplied rank_extra key")
        return rank_extra
    raise ValueError(f"unknown placement mode {mode!r}; expected {PLACEMENT_MODES}")
