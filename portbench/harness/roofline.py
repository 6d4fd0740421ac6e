"""The card's peaks and the least time of the fluid step core.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the full
700 W limit): 3.35 TB/s of HBM3 and 67 TFLOP/s of float32 outside the
tensor cores.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def fluid_step_work(L: int, J: int, S: int, D: int, need_overlap: bool):
    """(bytes, operations) one call of the fluid step core needs: each
    input read once and each output written once (the ``(L, J, J)`` bool
    overlap plane too, where asked); the float32 operations of the counts,
    k, rates and minima, plus a J x J x D product per lane for the plane."""
    nbytes = (L * J * D + L * J * S * 4 + L * J + L * J * 4 + S * 4 + D * 4
              + L * D * 4 + 4 * L * J * 4)
    ops = L * (5 * J * D + J * S + 5 * J + D)
    if need_overlap:
        nbytes += L * J * J
        ops += 2 * L * J * J * D
    return nbytes, ops


def fluid_step_bound_s(L: int, J: int, S: int, D: int, need_overlap: bool) -> float:
    """The least seconds a call can take: the larger of its bytes over the
    bandwidth and its operations over the float32 peak."""
    nbytes, ops = fluid_step_work(L, J, S, D, need_overlap)
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)
