"""Grouped-query attention: prefill forward and decode step (port of
``repro/models/attention.py``).

Prefill (:func:`attention_forward`) projects q, k and v, applies RoPE as
the reference does, repeats the kv heads, folds (B, S, H, hd) to
(B*H, S, hd) and hands the causal attention to the flash-attention kernel
(``repro_torch.kernels.flash_attention``): the CUDA kernel for CUDA
tensors, its plain version for CPU tensors.  With grad enabled it goes
through ``flash_attention_train``, whose backward recomputes the plain
version (the reference has no attention backward kernel either).  The reference computes the
same attention inline, query chunk by query chunk (``lax.map``); its
logits and probabilities are rounded to the activation dtype there, while
the kernel and its plain version keep them in float32 (ROADMAP R7), so
the two agree to round-off in float32 and at the bf16 bar in bfloat16.

Decode (:func:`decode_attention`) is plain PyTorch, as in the reference,
which has no kernel for it.  It writes the new key and value into the
cache slot in place: the reference donates the cache to its jitted step
(``donate_argnums``), so no caller keeps the old cache.

Only causal self-attention with the full mask is ported: the sliding and
full masks and cross attention raise ``NotImplementedError`` (ROADMAP).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import flash_attention, flash_attention_train
from repro_torch.models.common import ParamSpec, apply_rope
from repro_torch.models.config import ModelConfig

NEG_INF = -2.0**30  # large-but-finite; avoids NaN from all-masked rows


def attn_schema(cfg: ModelConfig, cross: bool = False) -> Dict[str, ParamSpec]:
    d, h, kv, hd = cfg.d_model, cfg.q_heads_padded, cfg.n_kv_heads, cfg.head_dim_
    del cross  # same shapes; kv inputs differ at apply time
    return {
        "wq": ParamSpec((d, h, hd), ("embed", "q_heads", "head_dim")),
        "wk": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((h, hd, d), ("q_heads", "head_dim", "embed"), scale=0.5),
    }


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    b, s, kv, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, n_rep, hd).reshape(b, s, kv * n_rep, hd)


def attention_forward(
    x: torch.Tensor,
    params: Dict[str, torch.Tensor],
    cfg: ModelConfig,
    *,
    mask_kind: str = "causal",
    kv_input: Optional[torch.Tensor] = None,
    impl: str = "",
) -> torch.Tensor:
    """(B, S, D) -> (B, S, D), with RoPE on q and k.  The reference's
    ``q_chunk`` has no counterpart (the kernel tiles the queries itself);
    ``impl`` as in :func:`repro_torch.kernels.flash_attention.flash_attention`."""
    if mask_kind != "causal":
        raise NotImplementedError(
            f"mask_kind={mask_kind!r}: the port has the causal mask only; the sliding "
            "and full masks wait (ROADMAP queue 1, item 8)"
        )
    if kv_input is not None:
        raise NotImplementedError(
            "cross attention (kv_input) waits for the vlm and audio families "
            "(ROADMAP queue 1, item 8)"
        )
    b, s, _ = x.shape
    h, kvh, hd = cfg.q_heads_padded, cfg.n_kv_heads, cfg.head_dim_

    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("btd,dgk->btgk", x, params["wk"])
    v = torch.einsum("btd,dgk->btgk", x, params["wv"])
    pos = torch.arange(s, device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    k = _repeat_kv(k, h // kvh)
    v = _repeat_kv(v, h // kvh)

    def fold(t):  # (B, S, H, hd) -> (B*H, S, hd), contiguous for the kernel
        return t.transpose(1, 2).reshape(b * h, t.shape[1], hd).contiguous()

    # with grad enabled (training) the autograd Function around the same
    # kernel call; under torch.no_grad() (serving) the kernel call alone
    attend = flash_attention_train if torch.is_grad_enabled() else flash_attention
    out = attend(fold(q), fold(k), fold(v), causal=True, impl=impl)
    out = out.reshape(b, h, s, hd).transpose(1, 2)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"])


# ---------------------------------------------------------------------------
# Decode (one token against a cache)
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: ModelConfig, batch: int, window: int,
                  dtype: torch.dtype = torch.bfloat16, device="cpu") -> Dict[str, torch.Tensor]:
    kvh, hd = cfg.n_kv_heads, cfg.head_dim_
    return {
        "k": torch.zeros((batch, window, kvh, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, window, kvh, hd), dtype=dtype, device=device),
    }


def decode_attention(
    x1: torch.Tensor,  # (B, 1, D)
    params: Dict[str, torch.Tensor],
    cache: Dict[str, torch.Tensor],
    pos: torch.Tensor,  # 0-dim int32: index of the token being generated
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step of self-attention against a (ring-buffer) KV cache
    of ``window`` slots (slot = pos % window; RoPE is applied to keys at
    write time with absolute positions).  The slot is written in place and
    the cache's own tensors are returned.  ``pos`` stays on the device:
    nothing here waits for the host."""
    h, kvh, hd = cfg.q_heads_padded, cfg.n_kv_heads, cfg.head_dim_
    window = cache["k"].shape[1]

    q = torch.einsum("bsd,dhk->bshk", x1, params["wq"])
    k1 = torch.einsum("bsd,dgk->bsgk", x1, params["wk"])
    v1 = torch.einsum("bsd,dgk->bsgk", x1, params["wv"])
    p = pos[None] if pos.dim() == 0 else pos
    q = apply_rope(q, p, cfg.rope_theta)
    k1 = apply_rope(k1, p, cfg.rope_theta)
    slot = torch.remainder(pos, window).reshape(1).long()
    ck, cv = cache["k"], cache["v"]
    ck.index_copy_(1, slot, k1)
    cv.index_copy_(1, slot, v1)

    kk = _repeat_kv(ck, h // kvh)  # (B, W, H, hd)
    vv = _repeat_kv(cv, h // kvh)
    logits = torch.einsum("bshk,bthk->bhst", q, kk).to(torch.float32)
    logits = logits / math.sqrt(hd)
    # slot j is valid iff it has been written: j <= pos (before wrap) or
    # always (after wrap: every slot holds one of the last `window` keys).
    valid = torch.arange(window, device=x1.device)[None, :] <= pos
    valid = valid | (pos >= window)
    logits = logits.masked_fill(~valid[None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(x1.dtype)
    out = torch.einsum("bhst,bthk->bshk", probs, vv)
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    return y, {"k": ck, "v": cv}
