"""Plain PyTorch version of the flash-attention kernel (port of
``repro/kernels/flash_attention/ref.py``).

Same signature and semantics as the kernel: float32 logits (float64 for
float64 inputs, so that ``torch.autograd.gradcheck`` can hold the
autograd Function's backward to it), the
top-left causal mask with the finite ``NEG_INF``, a softmax, and the output
in q's dtype.  The CPU path runs this, and the CUDA kernel is held against
it on the card.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -2.0**30


def attention_reference(
    q: torch.Tensor,  # (BH, S, D)
    k: torch.Tensor,  # (BH, T, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    s, d = q.shape[1], q.shape[2]
    t = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    f32 = torch.promote_types(q.dtype, torch.float32)  # float64 stays float64 (gradcheck)
    logits = torch.einsum("bsd,btd->bst", q.to(f32), k.to(f32))
    logits = logits * scale
    if causal:
        mask = (torch.arange(t, device=q.device)[None, :]
                <= torch.arange(s, device=q.device)[:, None])
        logits = logits.masked_fill(~mask[None], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bst,btd->bsd", probs, v.to(f32))
    return out.to(q.dtype)
