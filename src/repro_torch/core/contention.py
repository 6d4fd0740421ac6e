"""Contention-model constants and parameters (port of
``repro/core/contention.py``, trimmed to what the fluid path reads).

Eq. (2): contention-free all-reduce time ``T_ar = a + b*M``.  Eq. (5): under
k-way contention each byte costs ``k*b + (k-1)*eta`` seconds.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

#: Latency component fitted on real hardware [s] (paper Section III-A2).
PAPER_A = 6.69e-4
#: Per-byte transmission time fitted on real hardware [s/B].
PAPER_B = 8.53e-10
#: Contention penalty per byte [s/B]; the paper never prints eta, the
#: reference calibrates it to 0.2*b (see the reference module).
DEFAULT_ETA = 1.706e-10


@dataclasses.dataclass(frozen=True)
class ContentionParams:
    """Parameters (a, b, eta) of the contended all-reduce model, Eq. (5),
    plus optional per-server relative NIC bandwidth multipliers (servers
    beyond the tuple are nominal; empty = homogeneous network)."""

    a: float = PAPER_A
    b: float = PAPER_B
    eta: float = DEFAULT_ETA
    server_bandwidth: Tuple[float, ...] = ()

    def __post_init__(self) -> None:
        if self.b <= 0:
            raise ValueError(f"b must be positive, got {self.b}")
        if self.a < 0 or self.eta < 0:
            raise ValueError("a and eta must be non-negative")
        if any(s <= 0 for s in self.server_bandwidth):
            raise ValueError("server_bandwidth multipliers must be positive")

    @property
    def dual_threshold(self) -> float:
        """``b / (2*(b + eta))`` — Theorem 2's ratio test."""
        return self.b / (2.0 * (self.b + self.eta))
