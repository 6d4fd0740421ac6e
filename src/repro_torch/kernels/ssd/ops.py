"""Dispatch of the SSD decode step (port of
``repro/kernels/ssd/ops.py::ssd_decode_step``).

A CPU tensor takes the plain PyTorch version (``ref.py``).  A CUDA tensor
launches the hand-written CUDA kernel (``kernel.py``) or raises; there is
no fallback.  ``impl="ref"`` forces the plain version on CUDA too, so the
two can be compared on the card.  The reference's ``block_h`` is a TPU
tiling knob and has no counterpart here.
"""

from __future__ import annotations

from repro_torch.kernels.ssd.kernel import ssd_decode_step_cuda
from repro_torch.kernels.ssd.ref import ssd_decode_step_ref

#: "" lets the tensor's device decide: CPU -> "ref", CUDA -> "cuda".
SSD_IMPLS = ("ref", "cuda")


def ssd_decode_step(x, dt, a, b, c, d, state, *, impl: str = "", out=None):
    """One Mamba-2 decode step with the ``D·x`` skip term: x (B,H,P),
    dt (B,H), a and d (H,), b and c (B,N), state (B,H,P,N) float32 ->
    (y (B,H,P) in x's dtype, new state float32).  The new state is a new
    tensor (the reference's functional semantics), or is written into
    ``out`` when it is given: ``out=state`` updates the state in place."""
    impl = impl or ("cuda" if x.is_cuda else "ref")
    if impl not in SSD_IMPLS:
        raise ValueError(f"unknown SSD decode impl {impl!r}; expected one of {SSD_IMPLS}")
    if impl == "ref":
        return ssd_decode_step_ref(x, dt, a, b, c, d, state, out=out)
    return ssd_decode_step_cuda(x, dt, a, b, c, d, state, out=out)
