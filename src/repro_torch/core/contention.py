"""Contention-model constants and parameters (port of
``repro/core/contention.py``), with the offline float64 numpy fits of the
paper's Fig. 2 calibration.

Eq. (2): contention-free all-reduce time ``T_ar = a + b*M``.  Eq. (5): under
k-way contention each byte costs ``k*b + (k-1)*eta`` seconds.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

#: Latency component fitted on real hardware [s] (paper Section III-A2).
PAPER_A = 6.69e-4
#: Per-byte transmission time fitted on real hardware [s/B].
PAPER_B = 8.53e-10
#: Contention penalty per byte [s/B]; the paper never prints eta, the
#: reference calibrates it to 0.2*b (see the reference module).
DEFAULT_ETA = 1.706e-10

#: The reference's ``tpu-dcn`` virtual fabric for the multi-job launcher
#: (its values unchanged: a 2-pod TPU v5e slice's DCN latency and per-byte
#: time as the reference chose them).  They define a simulated network, not
#: any measurement of the card the port runs on.
TPU_DCN_A = 2.0e-5
TPU_DCN_B = 4.0e-11
TPU_DCN_ETA = 8.0e-12


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

    def bandwidth_scale(self, servers) -> float:
        """Drain-rate multiplier of a task touching ``servers``: the slowest
        member NIC bottlenecks the ring."""
        if not self.server_bandwidth:
            return 1.0
        n = len(self.server_bandwidth)
        return min((self.server_bandwidth[s] if s < n else 1.0) for s in servers)

    def mean_bandwidth_scale(self, n_servers: int) -> float:
        """Cluster-mean multiplier, the homogeneous-network equivalent (a
        summary statistic: both simulators model per-server rates).
        ``n_servers <= 0`` gives the nominal 1.0."""
        if not self.server_bandwidth or n_servers <= 0:
            return 1.0
        n = len(self.server_bandwidth)
        return sum(
            (self.server_bandwidth[s] if s < n else 1.0) for s in range(n_servers)
        ) / n_servers

    def allreduce_time(self, message_bytes: float, k: int = 1) -> float:
        """One all-reduce of ``message_bytes`` under k-way contention
        (Eq. 5; ``k=1`` is Eq. 2)."""
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        return self.a + (k * self.b + (k - 1) * self.eta) * message_bytes

    def rate(self, k: float) -> float:
        """Drain rate [B/s] of one task under k-way contention (Eq. 5
        without the latency ``a``); ``k`` may be the float ``k * oversub``."""
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        return 1.0 / (k * self.b + (k - 1) * self.eta)

    def seconds_per_byte(self, k: float) -> float:
        return k * self.b + (k - 1) * self.eta

    @property
    def dual_threshold(self) -> float:
        """``b / (2*(b + eta))`` — Theorem 2's ratio test."""
        return self.b / (2.0 * (self.b + self.eta))


# Table I — all-reduce algorithm costs in the (alpha, beta, gamma) model

ALLREDUCE_ALGORITHMS = (
    "binary_tree",
    "recursive_doubling",
    "recursive_halving_doubling",
    "ring",
)


def allreduce_cost_terms(
    algorithm: str, n_nodes: int, alpha: float, beta: float, gamma: float
) -> Tuple[float, float]:
    """``(a, b)`` of ``T = a + b*M`` for a classic all-reduce algorithm
    (paper Table I): ``alpha`` per-message latency, ``beta`` per-byte
    transfer time, ``gamma`` per-byte reduction time, ``n_nodes`` nodes."""
    if n_nodes < 2:
        return (0.0, 0.0)
    log_n = math.log2(n_nodes)
    n = float(n_nodes)
    if algorithm == "binary_tree":
        return (2 * alpha * log_n, (2 * beta + gamma) * log_n)
    if algorithm == "recursive_doubling":
        return (alpha * log_n, (beta + gamma) * log_n)
    if algorithm == "recursive_halving_doubling":
        return (2 * alpha * log_n, 2 * beta - (2 * beta + gamma) / n + gamma)
    if algorithm == "ring":
        return (
            2 * (n - 1) * alpha,
            2 * (n - 1) / n * beta + (n - 1) / n * gamma,
        )
    raise ValueError(
        f"unknown all-reduce algorithm {algorithm!r}; "
        f"expected one of {ALLREDUCE_ALGORITHMS}"
    )


# Model fitting (the Fig. 2 calibration): offline, float64 numpy


def fit_linear_cost(message_bytes, times) -> Tuple[float, float]:
    """Least-squares fit of ``T = a + b*M`` (Fig. 2(a)).  Returns (a, b).
    float64: the design matrix's columns span ~12 orders of magnitude."""
    m = np.asarray(message_bytes, dtype=np.float64)
    t = np.asarray(times, dtype=np.float64)
    b, a = np.polyfit(m, t, 1)
    return float(a), float(b)


def fit_contention_penalty(ks, times, message_bytes: float, a: float, b: float) -> float:
    """Fit eta from a k-sweep at fixed message size (Fig. 2(b)): with
    ``T(k) = a + k*b*M + (k-1)*eta*M``, eta by least squares over k > 1."""
    ks = np.asarray(ks, dtype=np.float64)
    times = np.asarray(times, dtype=np.float64)
    resid = times - (a + ks * b * message_bytes)
    x = (ks - 1.0) * message_bytes
    mask = ks > 1
    if not mask.any():
        return 0.0
    eta = float(np.dot(x[mask], resid[mask]) / np.dot(x[mask], x[mask]))
    return max(eta, 0.0)


def simulate_contention_sweep(
    params: ContentionParams, message_bytes: float, max_k: int
) -> np.ndarray:
    """Per-task completion time of k identical concurrent tasks for k in
    1..max_k (the Fig. 2(b) experiment: each sees k-way contention for its
    whole transfer)."""
    return np.asarray(
        [params.allreduce_time(message_bytes, k) for k in range(1, max_k + 1)]
    )
