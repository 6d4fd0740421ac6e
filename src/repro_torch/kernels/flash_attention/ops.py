"""Dispatch of flash attention (port of
``repro/kernels/flash_attention/ops.py::flash_attention``).

The kernel is bound as the ``torch.library`` custom op
``repro_torch::flash_attention`` (:data:`flash_attention_op`): its CUDA
implementation launches the hand-written CUDA kernel (``kernel.py``) or
raises, its CPU implementation is the plain PyTorch version (``ref.py``),
its fake implementation gives the output's shape and dtype to a trace
on fake or meta tensors (the dry-run's), and its FLOP formula
(:func:`flash_flops`) counts the causal pairs only for ``causal=True``.
A trace sees the op, where a ``ctypes`` launch has no data pointer to
take.  ``impl=""`` runs the op (the tensor's device picks the
implementation); ``impl="ref"`` runs the plain version on any device, so
the two can be compared on the card; ``impl="cuda"`` on a CPU tensor
raises; there is no fallback.  The reference's ``block_q`` and
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

import math

import torch
import torch.profiler
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_reference

#: "" runs the custom op, whose implementation the tensor's device picks:
#: the plain version on the CPU, the CUDA kernel on the card.
FLASH_IMPLS = ("ref", "cuda")
#: the profiler range around the backward's recompute of the plain version
BACKWARD_RANGE = "flash_attention.backward_recompute"


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(), device_types="cuda")
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                       scale: float) -> torch.Tensor:
    """The CUDA kernel (``kernel.flash_attention_cuda``), which raises on
    anything it does not take."""
    return flash_attention_cuda(q, k, v, causal=causal, scale=scale)


@flash_attention_op.register_kernel("cpu")
def _flash_attention_cpu(q, k, v, causal, scale):
    return attention_reference(q, k, v, causal=causal, scale=scale)


@flash_attention_op.register_fake
def _flash_attention_fake(q, k, v, causal, scale):
    return q.new_empty(q.shape)


def causal_pairs(s: int, t: int) -> int:
    """(query, key) pairs the top-left causal mask keeps: key j is seen by
    query i iff j <= i."""
    m = min(s, t)
    return m * (m + 1) // 2 + (s - m) * t


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def flash_flops(q_shape, k_shape, v_shape, causal, scale, out_shape=None, **kwargs) -> int:
    """Two products of 2 D operations (Q K^T and P V) for each (query,
    visible key) pair: the causal pairs for ``causal=True``, all S x T
    otherwise (chip_smoke.py's ``_flash_bound``)."""
    bh, s, d = q_shape
    t = k_shape[1]
    return 4 * bh * d * (causal_pairs(s, t) if causal else s * t)


def flash_attention(q, k, v, *, causal: bool = True, scale: float | None = None,
                    block_q: int = 128, block_k: int = 128, impl: str = ""):
    """Attention over q (BH,S,D) and k, v (BH,T,D) -> (BH,S,D) in q's dtype;
    callers fold batch and heads.  Causality is top-left aligned (key j
    sees query i iff j <= i); ``scale`` defaults to ``1/sqrt(D)``."""
    del block_q, block_k
    if impl not in ("",) + FLASH_IMPLS:
        raise ValueError(f"unknown flash attention impl {impl!r}; expected one of {FLASH_IMPLS}")
    if impl == "ref":
        return attention_reference(q, k, v, causal=causal, scale=scale)
    if impl == "cuda" and not q.is_cuda:
        return flash_attention_cuda(q, k, v, causal=causal, scale=scale)  # raises
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return flash_attention_op(q, k, v, bool(causal), float(scale))


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
