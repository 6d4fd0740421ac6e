"""Plain PyTorch version of the SSD decode step (port of
``repro/kernels/ssd/ref.py``).

:func:`ssd_step` is the model's own recurrence (``repro/models/ssm.py::
ssd_step``; ``repro_torch.models.ssm`` re-exports it from here), and
:func:`ssd_decode_step_ref` adds the ``D·x`` skip term in the reference's
order: ``y`` is cast to x's dtype first, then ``x * D`` is added in that
dtype.  The CPU path runs this, and the CUDA kernel is held against it.
"""

from __future__ import annotations

from typing import Tuple

import torch


def ssd_step(
    x1: torch.Tensor,   # (B, H, P)
    dt1: torch.Tensor,  # (B, H)
    a: torch.Tensor,    # (H,)
    b1: torch.Tensor,   # (B, N)
    c1: torch.Tensor,   # (B, N)
    h_state: torch.Tensor,  # (B, H, P, N) float32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrent step.  Returns (y (B,H,P) in x1's dtype, new state)."""
    f32 = torch.float32
    da = torch.exp((dt1 * a[None, :]).to(f32))  # (B,H)
    upd = (dt1.to(f32)[:, :, None] * x1.to(f32))[..., None] * b1.to(f32)[:, None, None, :]
    new_state = h_state * da[:, :, None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", c1.to(f32), new_state)
    return y.to(x1.dtype), new_state


def ssd_decode_step_ref(x, dt, a, b, c, d, state, out=None):
    """(y (B,H,P) in x's dtype, new state (B,H,P,N) float32); the new state
    is copied into ``out`` when it is given (``out`` may be ``state``)."""
    y, new_state = ssd_step(x, dt, a, b, c, state)
    y = y + x * d[None, :, None].to(x.dtype)
    if out is not None:
        new_state = out.copy_(new_state)
    return y, new_state
