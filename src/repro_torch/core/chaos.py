"""Fault injection for the event engine (port of ``repro/core/chaos.py``).

The specification side of fault injection: a frozen, hashable
:class:`ChaosSpec` and pure seed-deterministic generators for each fault
process.  The mechanism lives in :mod:`repro_torch.core.engine`: a
breakdown is an involuntary preemption (epoch tombstones, the carried
progress, the restore penalty), a NIC degradation a transient per-server
bandwidth multiplier, a straggler a per-iteration compute stretch.

Every draw is a pure function of ``ChaosSpec.seed`` and the entity's
identity (server index, job id, iteration number), never of wall clock,
dict order or Python's salted ``hash()``: ``random.Random`` seeded with a
string per server, and a splitmix64 hash (:func:`_mix`) for the per-job
and per-iteration draws.  The draws are the reference's bit for bit.  A
spec whose ``active`` property is false injects nothing and the engine
treats it as ``chaos=None``.

* **Server breakdown/repair**: per-server renewal process, time to failure
  ~ Exp(mean ``server_mtbf_s``), downtime ~ Exp(mean ``server_mttr_s``);
  ``scripted_failures`` windows ``(server, fail_t, repair_t)`` come first.
* **NIC degradation**: the same renewal shape (``nic_mtbf_s`` /
  ``nic_mttr_s``); during a window the server's bandwidth multiplier is
  scaled by ``nic_degraded_scale``.
* **Stragglers**: each (job, iteration) straggles with probability
  ``straggler_prob``; its compute is stretched by
  ``1 + straggler_slowdown * Exp(1)``.
* **Cancellation**: each job is killed with probability ``cancel_prob`` at
  ``arrival + Exp(mean cancel_after_s)`` if still unfinished then.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Iterator, Optional, Tuple

__all__ = [
    "ChaosSpec",
    "server_failure_stream",
    "nic_degradation_stream",
    "cancel_time",
    "jitter_factor",
]

# Minimum width of any stochastic window; keeps fail < repair strictly
# ordered in the event queue even for extreme spec values.
_MIN_WINDOW = 1e-6


@dataclasses.dataclass(frozen=True)
class ChaosSpec:
    """Seed-deterministic fault-injection configuration (hashable, so
    scenarios embedding one stay frozen/picklable for the sweep pool)."""

    seed: int = 0
    #: mean time between server failures; 0 disables stochastic breakdowns
    server_mtbf_s: float = 0.0
    #: mean server downtime once failed
    server_mttr_s: float = 60.0
    #: deterministic (server, fail_t, repair_t) windows, injected before any
    #: stochastic ones — the recovery-storm building block
    scripted_failures: Tuple[Tuple[int, float, float], ...] = ()
    #: per-(job, iteration) probability of a straggler iteration
    straggler_prob: float = 0.0
    #: mean extra compute stretch of a straggler iteration (multiplier - 1)
    straggler_slowdown: float = 0.5
    #: mean time between NIC degradation windows per server; 0 disables
    nic_mtbf_s: float = 0.0
    #: mean NIC degradation window length
    nic_mttr_s: float = 30.0
    #: bandwidth multiplier applied to a server while its NIC is degraded
    nic_degraded_scale: float = 0.25
    #: per-job probability of stochastic cancellation
    cancel_prob: float = 0.0
    #: mean delay after arrival before a doomed job is cancelled
    cancel_after_s: float = 300.0

    def __post_init__(self) -> None:
        for f in (
            "server_mtbf_s",
            "server_mttr_s",
            "nic_mtbf_s",
            "nic_mttr_s",
            "cancel_after_s",
            "straggler_slowdown",
        ):
            if getattr(self, f) < 0:
                raise ValueError(f"{f} must be >= 0, got {getattr(self, f)}")
        for f in ("straggler_prob", "cancel_prob"):
            if not 0.0 <= getattr(self, f) <= 1.0:
                raise ValueError(f"{f} must be in [0, 1], got {getattr(self, f)}")
        if not 0.0 < self.nic_degraded_scale <= 1.0:
            raise ValueError(
                f"nic_degraded_scale must be in (0, 1], got {self.nic_degraded_scale}"
            )
        last_repair: dict = {}
        for srv, fail_t, repair_t in sorted(self.scripted_failures):
            if srv < 0:
                raise ValueError(f"scripted failure on negative server {srv}")
            if not (0.0 <= fail_t < repair_t):
                raise ValueError(
                    f"scripted failure window ({fail_t}, {repair_t}) must satisfy "
                    "0 <= fail < repair"
                )
            if fail_t < last_repair.get(srv, 0.0):
                raise ValueError(
                    f"scripted failure windows overlap on server {srv}"
                )
            last_repair[srv] = repair_t

    @property
    def active(self) -> bool:
        """True iff this spec can inject *any* fault.  An inactive spec is
        treated as ``chaos=None`` by the engine — the zero-rate no-op."""
        return bool(
            self.server_mtbf_s > 0
            or self.scripted_failures
            or self.straggler_prob > 0
            or (self.nic_mtbf_s > 0 and self.nic_degraded_scale < 1.0)
            or self.cancel_prob > 0
        )


# ---------------------------------------------------------------------------
# splitmix64 — keyed deterministic uniforms for the per-iteration draws.
# random.Random would need one generator per (job, iteration) key; splitmix
# gives an O(1) stateless draw that is identical across processes (unlike
# Python's hash(), which is salted per interpreter).
# ---------------------------------------------------------------------------

_MASK64 = (1 << 64) - 1


def _mix(*keys: int) -> int:
    h = 0x9E3779B97F4A7C15
    for k in keys:
        h = (h + (k & _MASK64)) & _MASK64
        h ^= h >> 30
        h = (h * 0xBF58476D1CE4E5B9) & _MASK64
        h ^= h >> 27
        h = (h * 0x94D049BB133111EB) & _MASK64
        h ^= h >> 31
    return h


def _unit(*keys: int) -> float:
    """Uniform in [0, 1) keyed on the integers ``keys``."""
    return (_mix(*keys) >> 11) * (1.0 / (1 << 53))


# Domain-separation tags so the straggler, cancel-gate and cancel-delay
# draws never alias even for colliding (seed, job) keys.
_TAG_STRAGGLE_GATE = 0xA11CE
_TAG_STRAGGLE_MAG = 0x5EED5
_TAG_CANCEL_GATE = 0xCA9CE1
_TAG_CANCEL_DELAY = 0xDE1A9


def server_failure_stream(
    spec: ChaosSpec, server: int
) -> Iterator[Tuple[float, float]]:
    """Yield ``(fail_t, repair_t)`` windows for ``server`` in time order:
    scripted windows first, then (if ``server_mtbf_s > 0``) an infinite
    stochastic renewal process starting after the last scripted repair."""
    t = 0.0
    for srv, fail_t, repair_t in sorted(
        w for w in spec.scripted_failures if w[0] == server
    ):
        yield fail_t, repair_t
        t = max(t, repair_t)
    if spec.server_mtbf_s <= 0:
        return
    rng = random.Random(f"chaos:{spec.seed}:srv:{server}")
    while True:
        fail_t = t + rng.expovariate(1.0 / spec.server_mtbf_s)
        repair_t = fail_t + max(
            _MIN_WINDOW, rng.expovariate(1.0 / max(spec.server_mttr_s, _MIN_WINDOW))
        )
        yield fail_t, repair_t
        t = repair_t


def nic_degradation_stream(
    spec: ChaosSpec, server: int
) -> Iterator[Tuple[float, float]]:
    """Yield ``(start_t, end_t)`` NIC-degradation windows for ``server`` —
    an infinite stochastic renewal process (empty if disabled)."""
    if spec.nic_mtbf_s <= 0 or spec.nic_degraded_scale >= 1.0:
        return
    rng = random.Random(f"chaos:{spec.seed}:nic:{server}")
    t = 0.0
    while True:
        start_t = t + rng.expovariate(1.0 / spec.nic_mtbf_s)
        end_t = start_t + max(
            _MIN_WINDOW, rng.expovariate(1.0 / max(spec.nic_mttr_s, _MIN_WINDOW))
        )
        yield start_t, end_t
        t = end_t


def cancel_time(spec: ChaosSpec, job_id: int, arrival: float) -> Optional[float]:
    """Absolute cancellation instant for ``job_id``, or None if this job is
    never cancelled.  The engine ignores the instant if the job already
    finished by then."""
    if spec.cancel_prob <= 0:
        return None
    if _unit(spec.seed, job_id, _TAG_CANCEL_GATE) >= spec.cancel_prob:
        return None
    u = _unit(spec.seed, job_id, _TAG_CANCEL_DELAY)
    return arrival + spec.cancel_after_s * -math.log(1.0 - u)


def jitter_factor(spec: ChaosSpec, job_id: int, iteration: int) -> float:
    """Compute-time multiplier (>= 1) for iteration ``iteration`` of job
    ``job_id``.  1.0 for non-straggler iterations."""
    if spec.straggler_prob <= 0:
        return 1.0
    if _unit(spec.seed, job_id, iteration, _TAG_STRAGGLE_GATE) >= spec.straggler_prob:
        return 1.0
    u = _unit(spec.seed, job_id, iteration, _TAG_STRAGGLE_MAG)
    return 1.0 + spec.straggler_slowdown * -math.log(1.0 - u)
