"""Dispatch of flash attention (port of
``repro/kernels/flash_attention/ops.py::flash_attention``).

A CPU tensor takes the plain PyTorch version (``ref.py``).  A CUDA tensor
launches the hand-written CUDA kernel (``kernel.py``) or raises; there is
no fallback.  ``impl="ref"`` forces the plain version on CUDA too, so the
two can be compared on the card.  The reference's ``block_q`` and
``block_k`` are TPU tiling knobs (the VMEM tile of its grid) and have no
counterpart here: the CUDA kernel picks its own tiles from the head dim.

:func:`flash_attention_train` is the differentiable form for training: a
``torch.autograd.Function`` whose forward is the same dispatch (the CUDA
kernel on the card) and whose backward recomputes the plain version under
autograd and returns its gradient.  The reference has no Pallas backward
(ROADMAP R2), so neither has the port: a backward kernel would be a
feature the JAX package lacks.
"""

from __future__ import annotations

import torch
import torch.profiler

from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_reference

#: "" lets the tensor's device decide: CPU -> "ref", CUDA -> "cuda".
FLASH_IMPLS = ("ref", "cuda")
#: the profiler range around the backward's recompute of the plain version
BACKWARD_RANGE = "flash_attention.backward_recompute"


def flash_attention(q, k, v, *, causal: bool = True, scale: float | None = None,
                    block_q: int = 128, block_k: int = 128, impl: str = ""):
    """Attention over q (BH,S,D) and k, v (BH,T,D) -> (BH,S,D) in q's dtype;
    callers fold batch and heads.  Causality is top-left aligned (key j
    sees query i iff j <= i); ``scale`` defaults to ``1/sqrt(D)``."""
    del block_q, block_k
    impl = impl or ("cuda" if q.is_cuda else "ref")
    if impl not in FLASH_IMPLS:
        raise ValueError(f"unknown flash attention impl {impl!r}; expected one of {FLASH_IMPLS}")
    if impl == "ref":
        return attention_reference(q, k, v, causal=causal, scale=scale)
    return flash_attention_cuda(q, k, v, causal=causal, scale=scale)


class _FlashAttention(torch.autograd.Function):
    """Forward: :func:`flash_attention` (``impl`` as there).  Backward: the
    plain version (``ref.py``) recomputed from the saved q, k and v under
    autograd.  On the bf16 tensor-core path the forward rounds P to bf16
    before the product with V (ROADMAP R7), while the recomputed backward
    keeps P in float32, so the gradient is that of the plain version, not
    of the kernel's rounding."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, impl):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale = causal, scale
        return flash_attention(q, k, v, causal=causal, scale=scale, impl=impl)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        # a named range, so a profile can attribute the recompute's kernels
        with torch.profiler.record_function(BACKWARD_RANGE), torch.enable_grad():
            out = attention_reference(q, k, v, causal=ctx.causal, scale=ctx.scale)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), grad_out)
        return dq, dk, dv, None, None, None


def flash_attention_train(q, k, v, *, causal: bool = True, scale: float | None = None,
                          impl: str = ""):
    """:func:`flash_attention` with a gradient: the kernel's forward (or,
    with ``impl="ref"`` and on the CPU, the plain version's) and the plain
    version's backward, recomputed."""
    return _FlashAttention.apply(q, k, v, causal, scale, impl)
