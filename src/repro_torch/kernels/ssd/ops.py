"""Dispatch of the SSD decode step (port of
``repro/kernels/ssd/ops.py::ssd_decode_step``).

The kernel is bound as the ``torch.library`` custom op
``repro_torch::ssd_decode_step`` (:data:`ssd_decode_step_op`), which
writes the new state into its ``new_state`` argument and returns y: its
CUDA implementation launches the hand-written CUDA kernel (``kernel.py``)
or raises, its CPU implementation is the plain PyTorch version
(``ref.py``), its fake implementation gives y's shape and dtype to a
trace, and its FLOP formula (:func:`ssd_flops`) is the kernel's bound's
operation count.  ``state`` is declared mutated with ``new_state``: the
decode step's in-place call passes the state as both.  ``impl=""`` runs
the op (the tensor's device picks the implementation); ``impl="ref"``
runs the plain version on any device, so the two can be compared on the
card; ``impl="cuda"`` on a CPU tensor raises; there is no fallback.  The
reference's ``block_h`` is a TPU tiling knob and has no counterpart here.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.ssd.kernel import ssd_decode_step_cuda
from repro_torch.kernels.ssd.ref import ssd_decode_step_ref

#: "" runs the custom op, whose implementation the tensor's device picks:
#: the plain version on the CPU, the CUDA kernel on the card.
SSD_IMPLS = ("ref", "cuda")


@torch.library.custom_op("repro_torch::ssd_decode_step", mutates_args=("state", "new_state"),
                         device_types="cuda")
def ssd_decode_step_op(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, d: torch.Tensor, state: torch.Tensor,
                       new_state: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel (``kernel.ssd_decode_step_cuda``, ``out=new_state``),
    which raises on anything it does not take."""
    return ssd_decode_step_cuda(x, dt, a, b, c, d, state, out=new_state)[0]


@ssd_decode_step_op.register_kernel("cpu")
def _ssd_decode_step_cpu(x, dt, a, b, c, d, state, new_state):
    return ssd_decode_step_ref(x, dt, a, b, c, d, state, out=new_state)[0]


@ssd_decode_step_op.register_fake
def _ssd_decode_step_fake(x, dt, a, b, c, d, state, new_state):
    return x.new_empty(x.shape)


@register_flop_formula(torch.ops.repro_torch.ssd_decode_step)
def ssd_flops(x_shape, dt_shape, a_shape, b_shape, c_shape, d_shape, state_shape,
              new_state_shape, out_shape=None, **kwargs) -> int:
    """~5 float32 operations per state element (decay multiply, outer
    product multiply-add, C multiply-add), the per-row skip term and one
    exp per (batch, head): chip_smoke.py's ``_ssd_bound``."""
    bsz, h, p = x_shape
    n = state_shape[-1]
    return 5 * bsz * h * p * n + 3 * bsz * h * p + 2 * bsz * h


def ssd_decode_step(x, dt, a, b, c, d, state, *, impl: str = "", out=None):
    """One Mamba-2 decode step with the ``D·x`` skip term: x (B,H,P),
    dt (B,H), a and d (H,), b and c (B,N), state (B,H,P,N) float32 ->
    (y (B,H,P) in x's dtype, new state float32).  The new state is a new
    tensor (the reference's functional semantics), or is written into
    ``out`` when it is given: ``out=state`` updates the state in place."""
    if impl not in ("",) + SSD_IMPLS:
        raise ValueError(f"unknown SSD decode impl {impl!r}; expected one of {SSD_IMPLS}")
    if impl == "ref":
        return ssd_decode_step_ref(x, dt, a, b, c, d, state, out=out)
    if impl == "cuda" and not x.is_cuda:
        return ssd_decode_step_cuda(x, dt, a, b, c, d, state, out=out)  # raises
    new_state = out if out is not None else torch.empty(state.shape, dtype=torch.float32,
                                                        device=state.device)
    return ssd_decode_step_op(x, dt, a, b, c, d, state, new_state), new_state
