"""Grouped-query attention: prefill forward, decode step and cross
attention (port of ``repro/models/attention.py``).

Prefill (:func:`attention_forward`) projects q from x and k, v from x or,
for cross attention, from ``kv_input``; applies RoPE as the reference does
(only to self attention, and only with ``use_rope``) and repeats the kv
heads.  The causal and full masks fold (B, S, H, hd) to (B*H, S, hd) and
hand the attention to the flash-attention kernel
(``repro_torch.kernels.flash_attention``): the CUDA kernel for CUDA
tensors, its plain version for CPU tensors; the full mask (the audio
encoder, and cross attention over T keys) is the kernel with
``causal=False``, which masks nothing but the tail of the last key tile.
With grad enabled it goes through ``flash_attention_train``, whose
backward recomputes the plain version (the reference has no attention
backward kernel either).  The reference computes the same attention
inline, query chunk by query chunk (``lax.map``); its logits and
probabilities are rounded to the activation dtype there, while the kernel
and its plain version keep them in float32 (ROADMAP R7), so the two agree
to round-off in float32 and at the bf16 bar in bfloat16.

The sliding mask (key j visible from query i iff ``i - w < j <= i``, the
long-context variants') is plain PyTorch, as in the reference, whose
Pallas kernel has no window (ROADMAP R2): the reference's chunked
attention, query chunk by query chunk (:func:`_pick_chunk` of
``RunFlags.q_chunk``), logits in float32, probabilities rounded to the
activation dtype, the finite ``NEG_INF``.  Each chunk reads only the keys
its window reaches, ``[q0 - w + 1, q0 + qc)``: the others' probabilities
are exactly 0 in float32, so the result is the reference's, and a long
prompt's logits stay (B, H, qc, qc + w - 1) a chunk.

Under a mesh (DTensor q, k and v) the attention of both kinds runs on
each rank's own heads through a ``local_map`` (:func:`_per_local_heads`),
so the kernel reads plain local tensors.  Every projection, prefill,
decode and cross, runs on each rank's shard of its weight
(``sharding.rules.sharded_product``): wq, wk and wv column-parallel over
the heads (wk and wv replicated where "model" does not divide the kv
heads), wo row-parallel.

Decode (:func:`decode_attention`, :func:`decode_cross_attention`) is plain
PyTorch, as in the reference, which has no kernel for it.  Under a mesh
it runs on each rank's heads too, or, with ``decode_constrain``, on each
rank's sequence shard of the cache, its softmax as partial reductions
(:func:`_seq_sharded_decode`).  Self attention writes the new key and
value into the cache slot in place: the reference donates the cache to
its jitted step (``donate_argnums``), so no caller keeps the old cache.  Cross attention reads the keys and values that
:func:`precompute_cross_kv` made once at prefill and writes nothing.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_train
from repro_torch.models.common import ParamSpec, apply_rope
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.rules import (
    act_placements, all_reduce_shards, batch_spec_axes, shard_extent, sharded_product,
)

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


def _pick_chunk(s: int, target: int = 512) -> int:
    """Largest divisor of s that is <= target (q-chunk size)."""
    if s <= target:
        return s
    for c in range(target, 0, -1):
        if s % c == 0:
            return c
    return s


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
    use_rope: bool = True,
    impl: str = "",
    q_chunk: int = 512,
) -> torch.Tensor:
    """(B, S, D) -> (B, S, D); k and v from ``kv_input`` (B, T, D) where
    given (cross attention), else from x.  RoPE on q and k at positions
    0..S-1 when ``use_rope`` and there is no ``kv_input``, as the
    reference.  ``mask_kind`` is "causal" or "full" (the flash kernel,
    causal or not; ``impl`` as in
    :func:`repro_torch.kernels.flash_attention.flash_attention`, the kernel
    tiles the queries itself) or "sliding" (plain PyTorch over query
    chunks of ``_pick_chunk(S, q_chunk)``, as the reference)."""
    if mask_kind not in ("causal", "sliding", "full"):
        raise ValueError(f"unknown mask_kind {mask_kind!r}; expected 'causal', 'sliding' "
                         "or 'full'")
    b, s, _ = x.shape
    kv_x = x if kv_input is None else kv_input
    h, kvh, hd = cfg.q_heads_padded, cfg.n_kv_heads, cfg.head_dim_

    q = sharded_product("bsd,dhk->bshk", x, params["wq"], "no_batch")
    k = sharded_product("btd,dgk->btgk", kv_x, params["wk"], "no_batch")
    v = sharded_product("btd,dgk->btgk", kv_x, params["wv"], "no_batch")
    if use_rope and kv_input is None:
        pos = torch.arange(s, device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)

    def attend(q, k, v):
        return _attend_heads(q, k, v, mask_kind, cfg.sliding_window, _pick_chunk(s, q_chunk),
                             impl)

    if isinstance(q, DTensor):
        out = _per_local_heads(attend, q, k, v, h // kvh)
    else:
        out = attend(q, _repeat_kv(k, h // kvh), _repeat_kv(v, h // kvh))
    return sharded_product("bshk,hkd->bsd", out, params["wo"], "no_batch")


def _attend_heads(q, k, v, mask_kind: str, window: int, qc: int, impl: str) -> torch.Tensor:
    """q (B, S, H, hd), k and v (B, T, H, hd) -> (B, S, H, hd): the sliding
    mask in plain PyTorch, the causal and full masks through the flash
    kernel (its plain version on the CPU)."""
    if mask_kind == "sliding":
        return _sliding_attention(q, k, v, window, qc)
    b, s, h, hd = q.shape

    def fold(t):  # (B, S, H, hd) -> (B*H, S, hd), contiguous for the kernel
        return t.transpose(1, 2).reshape(b * h, t.shape[1], hd).contiguous()

    # with grad enabled (training) the autograd Function around the same
    # kernel call; under torch.no_grad() (serving) the kernel call alone
    attend = flash_attention_train if torch.is_grad_enabled() else flash_attention
    out = attend(fold(q), fold(k), fold(v), causal=mask_kind == "causal", impl=impl)
    return out.reshape(b, h, s, hd).transpose(1, 2)


def _per_local_heads(attend, q, k, v, n_rep: int):
    """``attend`` run by each rank on its own heads, through a
    ``local_map``: q (B, S, H, hd) with its heads sharded over the "model"
    mesh dim where that divides H, the batch as ``q`` has it over the other
    mesh dims (:func:`act_placements`).  Attention is independent per head
    and per sequence, so no rank needs another's, and the kernel reads
    plain local tensors (a fold of a sharded DTensor would be a
    ``_StridedShard``, which a raw pointer cannot read).  k and v (B, T,
    KV, hd) enter sharded alike where "model" divides KV too, and each rank
    repeats its own kv heads; where the guard left them replicated (2 kv
    heads on a 4-way axis), each rank repeats them whole and keeps the
    slice of its q heads, and their gradient is the sum of the ranks'
    (``Partial``).  The repeat runs on local tensors: DTensor's backward
    of a repeat of replicated heads into sharded ones fails."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    pq = act_placements(q, q.shape, 2)
    split = Shard(2) in pq
    whole = split and k.shape[2] % mesh.size(mesh.mesh_dim_names.index("model")) != 0
    pkv = [Replicate() if p == Shard(2) else p for p in pq] if whole else pq
    gkv = [Partial() if p == Shard(2) else p for p in pq] if whole else pq
    rank = mesh.get_local_rank("model") if whole else 0

    def local(q, k, v):
        k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
        if whole:  # the kv heads of this rank's q heads
            hl = q.shape[2]
            k, v = k[:, :, rank * hl:(rank + 1) * hl], v[:, :, rank * hl:(rank + 1) * hl]
        return attend(q, k, v)

    # one output: its placements as a list (a tuple would be one per output)
    return local_map(local, out_placements=pq, in_placements=(pq, pkv, pkv),
                     in_grad_placements=(pq, gkv, gkv), device_mesh=mesh,
                     redistribute_inputs=True)(q, k, v)


def _sliding_attention(q, k, v, window: int, qc: int) -> torch.Tensor:
    """q, k, v (B, S, H, hd) -> (B, S, H, hd): query i sees keys
    ``i - window < j <= i``; chunks of ``qc`` queries, each against the keys
    its window reaches."""
    s, hd = q.shape[1], q.shape[3]
    scale = 1.0 / math.sqrt(hd)
    outs = []
    for q0 in range(0, s, qc):
        k0 = max(0, q0 - window + 1)
        q_pos = torch.arange(q0, q0 + qc, device=q.device)[:, None]
        kv_pos = torch.arange(k0, q0 + qc, device=q.device)[None, :]
        mask = (kv_pos <= q_pos) & (kv_pos > q_pos - window)
        logits = torch.einsum("bqhk,bthk->bhqt", q[:, q0:q0 + qc], k[:, k0:q0 + qc])
        logits = logits.to(torch.float32) * scale
        logits = logits.masked_fill(~mask[None, None], NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        outs.append(torch.einsum("bhqt,bthk->bqhk", probs, v[:, k0:q0 + qc]))
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# Decode (one token against a cache)
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: ModelConfig, batch: int, window: int,
                  dtype: torch.dtype = torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    """Zero k/v cache on ``device`` (None = CUDA)."""
    device = resolve_device(device)
    kvh, hd = cfg.n_kv_heads, cfg.head_dim_
    return {
        "k": torch.zeros((batch, window, kvh, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, window, kvh, hd), dtype=dtype, device=device),
    }


def abstract_kv_cache(cfg: ModelConfig, batch: int, window: int,
                      dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """:func:`init_kv_cache`'s shapes and dtypes as meta tensors (no memory)."""
    return init_kv_cache(cfg, batch, window, dtype, "meta")


def _write_slot(cache_t: torch.Tensor, slot: torch.Tensor, new: torch.Tensor) -> None:
    """``cache_t[:, slot] = new`` in place: cache_t (B, W, KV, hd), new (B, 1,
    KV, hd), slot (1,) long on the device.  On DTensors each rank writes
    its own shard (the cache keeps its placements: a redistribution would
    write into a copy), ``new`` brought to the cache's placements but
    whole along W; where W is sharded, only the rank whose slots hold
    ``slot`` changes, the others write back what they hold, so nothing
    waits for the host."""
    if not isinstance(cache_t, DTensor):
        cache_t.index_copy_(1, slot, new)
        return
    from torch.distributed.tensor import Replicate

    mesh, pl = cache_t.device_mesh, list(cache_t.placements)
    want = [Replicate() if p.is_shard(1) else p for p in pl]
    new = new if list(new.placements) == want else new.redistribute(mesh, want)
    new, local = new.to_local(), cache_t._local_tensor
    slot = slot.to_local() if isinstance(slot, DTensor) else slot
    start, size = shard_extent(cache_t.shape[1], mesh, pl, 1)
    idx = slot - start
    valid = ((idx >= 0) & (idx < size)).view(1, 1, 1, 1)
    idx = idx.clamp(0, size - 1)
    local.index_copy_(1, idx, torch.where(valid, new, local.index_select(1, idx)))


def _decode_placements(t, batch_axes, model_dim: Optional[int]):
    """``t`` redistributed to the reference's decode constraint: dim 0 (the
    batch) sharded over the mesh dims ``batch_axes``, dim ``model_dim``
    over "model" (None: replicated), replicated over the rest."""
    from torch.distributed.tensor import Replicate, Shard

    names = t.device_mesh.mesh_dim_names
    pl = [Shard(0) if n in batch_axes else Shard(model_dim) if n == "model" and model_dim
          is not None else Replicate() for n in names]
    return t if list(t.placements) == pl else t.redistribute(t.device_mesh, pl)


def decode_attention(
    x1: torch.Tensor,  # (B, 1, D)
    params: Dict[str, torch.Tensor],
    cache: Dict[str, torch.Tensor],
    pos: torch.Tensor,  # 0-dim int32: index of the token being generated
    cfg: ModelConfig,
    *,
    constrain: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step of self-attention against a (ring-buffer) KV cache
    of ``window`` slots (slot = pos % window; RoPE is applied to keys at
    write time with absolute positions).  The slot is written in place and
    the cache's own tensors are returned.  ``pos`` stays on the device:
    nothing here waits for the host.

    On DTensors (a cache placed by ``sharding.place_cache``) each rank
    writes its shard of the slot (:func:`_write_slot`).  ``constrain`` is
    the reference's flash-decode sharding: after the update the keys and
    values are read sequence-sharded over "model" (the batch over the mesh
    dims that ``sharding.batch_spec_axes`` gives it) and q is replicated
    over "model", and each rank attends over its own slots, the softmax
    as partial reductions over the sequence shards
    (:func:`_seq_sharded_decode`): neither the cache nor the (B, H, 1, W)
    logits are gathered.  Plain tensors ignore it, as the reference's
    constraint does nothing on one device."""
    window = cache["k"].shape[1]

    q = sharded_product("bsd,dhk->bshk", x1, params["wq"])
    k1 = sharded_product("bsd,dgk->bsgk", x1, params["wk"])
    v1 = sharded_product("bsd,dgk->bsgk", x1, params["wv"])
    p = pos[None] if pos.dim() == 0 else pos
    q = apply_rope(q, p, cfg.rope_theta)
    k1 = apply_rope(k1, p, cfg.rope_theta)
    slot = torch.remainder(pos, window).reshape(1).long()
    ck, cv = cache["k"], cache["v"]
    _write_slot(ck, slot, k1)
    _write_slot(cv, slot, v1)
    if isinstance(q, DTensor) and constrain:
        dp = batch_spec_axes(q.device_mesh, q.shape[0]) or ()
        ck = _decode_placements(ck, dp, 1)
        cv = _decode_placements(cv, dp, 1)
        q = _decode_placements(q, dp, None)
        out = _seq_sharded_decode(q, ck, cv, pos)
    elif isinstance(q, DTensor):
        out = _per_rank_decode(q, ck, cv, pos)
    else:
        out = _decode_core(q, ck, cv, pos)
    y = sharded_product("bshk,hkd->bsd", out, params["wo"])
    return y, {"k": cache["k"], "v": cache["v"]}


def _masked_softmax_pv(logits, vv, pos, window: int, dtype):
    """Mask the unwritten slots of (B, H, 1, W) float32 logits, softmax,
    probabilities in ``dtype`` times the values (B, W, H, hd)."""
    # slot j is valid iff it has been written: j <= pos (before wrap) or
    # always (after wrap: every slot holds one of the last `window` keys).
    if pos is not None:
        valid = torch.arange(window, device=vv.device)[None, :] <= pos
        valid = valid | (pos >= window)
        logits = logits.masked_fill(~valid[None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(dtype)
    return torch.einsum("bhst,bthk->bshk", probs, vv)


def _seq_sharded_decode(q, ck, cv, pos):
    """Flash-decode, as the reference's comment describes its constrained
    decode: q (B, 1, H, hd) replicated over "model", the keys and values
    (B, W, KV, hd) split on W over "model" (the batch over its mesh dims
    on all three), each rank in a ``local_map`` on its own slots: float32
    logits, its unwritten slots masked (slot indices are global, so
    offset by the shard's start), a local max all-reduced, ``exp`` and a
    local sum all-reduced, the probabilities in the activation dtype times
    its values, and the (B, 1, H, hd) parts all-reduced
    (``sharding.rules.all_reduce_shards``).  On one shard every reduction
    is the identity.  The decode steps that use it run under
    ``torch.no_grad``: the normaliser's gradient would need the other
    ranks' terms."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    pq, pkv = list(q.placements), list(ck.placements)
    pp = [Replicate()] * mesh.ndim if isinstance(pos, DTensor) else None
    window = ck.shape[1]
    lo = shard_extent(window, mesh, pkv, 1)[0]
    h, kvh, hd = q.shape[2], ck.shape[2], q.shape[3]

    def reduce(t, op):
        return all_reduce_shards(t, op, mesh, pkv, 1)

    def local(q, ck, cv, pos):
        kk = _repeat_kv(ck, h // kvh)  # (B, W_loc, H, hd)
        vv = _repeat_kv(cv, h // kvh)
        logits = torch.einsum("bshk,bthk->bhst", q, kk).to(torch.float32)
        logits = logits / math.sqrt(hd)
        slots = torch.arange(lo, lo + ck.shape[1], device=ck.device)
        valid = (slots[None, :] <= pos) | (pos >= window)
        logits = logits.masked_fill(~valid[None, None], NEG_INF)
        p = torch.exp(logits - reduce(logits.amax(-1, keepdim=True), "max"))
        probs = (p / reduce(p.sum(-1, keepdim=True), "sum")).to(q.dtype)
        return reduce(torch.einsum("bhst,bthk->bshk", probs, vv), "sum")

    return local_map(local, out_placements=pq, in_placements=(pq, pkv, pkv, pp),
                     device_mesh=mesh, redistribute_inputs=True)(q, ck, cv, pos)


def _decode_core(q, ck, cv, pos=None):
    """One token's attention on plain tensors: q (B, 1, H, hd) over the keys
    and values (B, W, KV, hd), float32 logits, the unwritten slots masked
    where ``pos`` is given (self attention; cross attention masks none)."""
    h, kvh, hd = q.shape[2], ck.shape[2], q.shape[3]
    kk = _repeat_kv(ck, h // kvh)  # (B, W, H, hd)
    vv = _repeat_kv(cv, h // kvh)
    logits = torch.einsum("bshk,bthk->bhst", q, kk).to(torch.float32)
    logits = logits / math.sqrt(hd)
    return _masked_softmax_pv(logits, vv, pos, ck.shape[1], q.dtype)


def _per_rank_decode(q, ck, cv, pos=None):
    """:func:`_decode_core` on DTensors, run by each rank on its own heads
    (a ``local_map``, as the prefill's :func:`_per_local_heads`): q's heads
    sharded over "model" where they divide, the batch as q has it; the
    keys and values whole along the sequence, their kv heads sharded
    alike where "model" divides them too, else whole, each rank repeating
    them and keeping its q heads' slice.  DTensor's own plan for the
    batched products folds the batch and the head dims, which torch 2.11
    refuses with the heads sharded."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    pq = act_placements(q, q.shape, 2)
    whole = Shard(2) in pq and ck.shape[2] % mesh.size(mesh.mesh_dim_names.index("model")) != 0
    pkv = [Replicate() if p == Shard(2) else p for p in pq] if whole else pq
    rank = mesh.get_local_rank("model") if whole else 0
    pp = [Replicate()] * mesh.ndim if isinstance(pos, DTensor) else None

    def local(q, ck, cv, pos):
        if whole:  # the kv heads of this rank's q heads
            n_rep, hl = q.shape[2] * mesh.size(mesh.mesh_dim_names.index("model")) // ck.shape[2], \
                q.shape[2]
            ck = _repeat_kv(ck, n_rep)[:, :, rank * hl:(rank + 1) * hl]
            cv = _repeat_kv(cv, n_rep)[:, :, rank * hl:(rank + 1) * hl]
        return _decode_core(q, ck, cv, pos)

    return local_map(local, out_placements=pq, in_placements=(pq, pkv, pkv, pp),
                     device_mesh=mesh, redistribute_inputs=True)(q, ck, cv, pos)


def decode_cross_attention(
    x1: torch.Tensor,  # (B, 1, D)
    params: Dict[str, torch.Tensor],
    cross_k: torch.Tensor,  # (B, T, KV, hd), from the encoder's or the vision tokens
    cross_v: torch.Tensor,
    cfg: ModelConfig,
) -> torch.Tensor:
    """One decode step of cross attention against the prefill's keys and
    values: no mask, no RoPE, float32 logits, probabilities in the
    activation dtype (R7), as the reference.  Reads the cache only."""
    q = sharded_product("bsd,dhk->bshk", x1, params["wq"])
    attend = _per_rank_decode if isinstance(q, DTensor) else _decode_core
    return sharded_product("bshk,hkd->bsd", attend(q, cross_k, cross_v), params["wo"])


def precompute_cross_kv(enc_out: torch.Tensor, params: Dict[str, torch.Tensor]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cross sub-layer's keys and values (B, T, KV, hd) of the encoder
    output or the vision tokens (B, T, D), computed once at prefill."""
    k = sharded_product("btd,dgk->btgk", enc_out, params["wk"])
    v = sharded_product("btd,dgk->btgk", enc_out, params["wv"])
    return k, v
