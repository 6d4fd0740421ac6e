"""Policy/network array layer of the fluid simulator (port of
``repro/core/netmodel.py``).

The scalar helpers (:class:`PolicySpec`, :func:`parse_policy`,
:func:`canonical_placement`, :func:`server_bandwidth_array`,
:func:`fusion_threshold`) are plain-Python copies.  The array functions are
written for torch tensors with any number of leading batch axes (the fluid
simulator puts its lane axis first); constants are built on the tensor's
device.  Each one rounds as the reference does: same operations, same
order, Python-float coefficients taken as float32.

Not ported yet (each raises ``NotImplementedError``; see ROADMAP.md queue
1): the WFBP gating closure (:func:`gating_fixed_point`) and the exact
k-way lookahead (:func:`kway_exact_start`).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Sequence

import numpy as np
import torch

_NOT_PORTED = "not ported yet; see ROADMAP.md queue 1 (port of repro.core.netmodel.{})"

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
# Tensor fusion spec (only fusion="all" is ported)
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
):
    """Threshold gating predicate with runtime policy parameters: a start
    is allowed when uncontended (``k_would <= 1``), or under the cap
    ``max_ways`` and, for gated policies, passing Theorem 2's
    ``new_cost < dual_threshold * min_old_rem``.  ``threshold_gated`` is
    a Python bool or a bool tensor."""
    if exact_kway_olds is not None:
        raise NotImplementedError(_NOT_PORTED.format("kway_exact_start"))
    uncontended = k_would <= 1
    under_cap = k_would <= max_ways
    ratio_ok = new_cost < dual_threshold * min_old_rem
    if isinstance(threshold_gated, bool):
        contended_ok = under_cap & ratio_ok if threshold_gated else under_cap
    else:
        contended_ok = under_cap & (ratio_ok | ~threshold_gated)
    return uncontended | contended_ok


def gating_fixed_point(*args, **kwargs):
    """WFBP one-shot gating closure — not ported yet."""
    raise NotImplementedError(_NOT_PORTED.format("gating_fixed_point"))


def kway_exact_start(*args, **kwargs):
    """Exact k-way lookahead gate — not ported yet."""
    raise NotImplementedError(_NOT_PORTED.format("kway_exact_start"))


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
    ``least_loaded`` -> remaining-service load, ``rack_pack`` -> the
    caller's :func:`rack_pack_rank`.  ``random`` needs a threefry port and
    is not ported yet."""
    if mode == "consolidate":
        return -free
    if mode == "first_fit":
        return server_index.expand_as(free)
    if mode == "least_loaded":
        return load
    if mode == "random":
        raise NotImplementedError(
            "placement 'random' draws from jax.random and needs a threefry "
            "port; see ROADMAP.md queue 1"
        )
    if mode == "rack_pack":
        if rank_extra is None:
            raise ValueError(f"mode {mode!r} needs a caller-supplied rank_extra key")
        return rank_extra
    raise ValueError(f"unknown placement mode {mode!r}; expected {PLACEMENT_MODES}")
