"""Dispatch of the fluid step core (port of
``repro/kernels/fluidstep/ops.py::fluid_step_core``).

A CPU tensor takes the plain PyTorch version (``ref.py``).  A CUDA tensor
launches the hand-written CUDA kernel (``kernel.py``) or raises; there is
no fallback.  ``impl="ref"`` forces the plain version on CUDA too, so the
two can be compared on the card.
"""

from __future__ import annotations

from repro_torch.kernels.fluidstep.kernel import fluid_step_core_cuda
from repro_torch.kernels.fluidstep.ref import fluid_step_core_ref

#: "" lets the tensor's device decide: CPU -> "ref", CUDA -> "cuda".
FLUID_KERNEL_IMPLS = ("ref", "cuda")


def fluid_step_core(loads, member, active, rem, bw, oversub, *,
                    b: float, eta: float, need_overlap: bool = False,
                    impl: str = ""):
    """Contention/rate core of one fluid step for every lane (semantics in
    ``ref.py``).  Outputs have the reference's dtypes: ``counts`` and
    ``k_would`` int32, rates float32, ``inf`` in ``min_old_rem`` where no
    overlapping transfer is in flight, ``overlap`` None unless
    ``need_overlap``."""
    impl = impl or ("cuda" if loads.is_cuda else "ref")
    if impl not in FLUID_KERNEL_IMPLS:
        raise ValueError(
            f"unknown fluid step impl {impl!r}; expected one of {FLUID_KERNEL_IMPLS}"
        )
    args = (loads, member, active, rem, bw, oversub)
    if impl == "ref":
        return fluid_step_core_ref(*args, b=b, eta=eta, need_overlap=need_overlap)
    return fluid_step_core_cuda(*args, b=b, eta=eta, need_overlap=need_overlap)
