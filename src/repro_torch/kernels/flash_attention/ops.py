"""Dispatch of flash attention (port of
``repro/kernels/flash_attention/ops.py::flash_attention``).

A CPU tensor takes the plain PyTorch version (``ref.py``).  A CUDA tensor
launches the hand-written CUDA kernel (``kernel.py``) or raises; there is
no fallback.  ``impl="ref"`` forces the plain version on CUDA too, so the
two can be compared on the card.  The reference's ``block_q`` and
``block_k`` are TPU tiling knobs (the VMEM tile of its grid) and have no
counterpart here: the CUDA kernel picks its own tiles from the head dim.
"""

from __future__ import annotations

from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_reference

#: "" lets the tensor's device decide: CPU -> "ref", CUDA -> "cuda".
FLASH_IMPLS = ("ref", "cuda")


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
