"""Model assembly (port of ``repro/models/lm.py``) for the ``ssm`` and
``dense`` families.

One :class:`LM` object per config provides what training and serving
need, as plain functions of nested dicts of tensors:

* ``schema()`` / ``init`` — the reference's parameter schema (same flat
  keys) and its initialisation from a threefry key (``repro_torch.prng``),
  so the same seed gives the reference's weights;
* ``loss_fn`` — the causal-LM training loss, dense or chunked over the
  sequence, with per-block rematerialisation (``torch.utils.checkpoint``
  in place of ``jax.checkpoint``);
* ``prefill_fn`` — prompt pass producing last-token logits + the cache;
* ``decode_fn`` — one-token serve step, updating the cache in place;
* ``init_cache`` — ``{"pos", "layers": ...}``, each leaf stacked over
  layers, as the reference lays it out: ``{conv_x, conv_B, conv_C, state}``
  for ``ssm``, the ring-buffer KV cache ``{k, v}`` (L, B, window, KV, hd)
  for ``dense``.

The reference's ``lax.scan`` over the stacked layer axis is a Python loop
over that axis.  Every other family raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (
    ParamSpec, Schema, apply_rope, cross_entropy_loss, init_params, rms_norm, tree_map,
)
from repro_torch.models.config import ModelConfig

#: The families whose blocks the port has.
PORTED_FAMILIES = ("ssm", "dense")


def stack_schema(schema: Schema, n: int, axis: str = "layers") -> Schema:
    return tree_map(lambda s: ParamSpec((n,) + s.shape, (axis,) + s.axes, s.init, s.scale),
                    schema)


def _norm_spec(d: int) -> ParamSpec:
    return ParamSpec((d,), ("embed",), init="ones")


def _layer(tree, i: int):
    """Layer ``i`` of a tree stacked over layers (views, no copy)."""
    return tree_map(lambda a: a[i], tree)


def _stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


@dataclasses.dataclass(frozen=True)
class RunFlags:
    """The reference's run flags that training and serving read, plus the
    port's choice of kernel implementations.

    ``remat``: "none", or "block" to recompute each block's forward in the
    backward pass (``torch.utils.checkpoint`` per block, as the reference
    wraps its scan body in ``jax.checkpoint``); "dots" raises.
    ``loss_impl``: "dense" materialises the (B, S, V) logits, "chunked"
    computes the loss over sequence chunks of ``loss_chunk`` (each chunk
    recomputed in the backward pass), as the reference does.  ``q_chunk``
    has no effect (the attention kernel tiles the queries itself); it is
    kept so callers build flags as for the reference.  ``ssd_impl`` as in
    :func:`repro_torch.kernels.ssd.ssd_decode_step` and ``attn_impl`` (the
    prefill and training attention) as in
    :func:`repro_torch.kernels.flash_attention.flash_attention`: "" lets
    the device decide (CUDA kernel on the card, plain version on the CPU),
    "ref" forces the plain version."""

    remat: str = "block"
    q_chunk: int = 512
    loss_impl: str = "dense"
    loss_chunk: int = 512
    ssd_impl: str = ""
    attn_impl: str = ""

    def __post_init__(self) -> None:
        if self.remat == "dots":
            raise NotImplementedError(
                "remat='dots' (save the matmul outputs, recompute the rest) waits; the "
                "port has 'none' and 'block' (ROADMAP queue 1, item 9)")
        if self.remat not in ("none", "block"):
            raise ValueError(f"unknown remat {self.remat!r}; expected 'none' or 'block'")
        if self.loss_impl not in ("dense", "chunked"):
            raise ValueError(f"unknown loss_impl {self.loss_impl!r}; expected 'dense' "
                             "or 'chunked'")


class LM:
    def __init__(self, cfg: ModelConfig):
        if cfg.family not in PORTED_FAMILIES:
            raise NotImplementedError(
                f"{cfg.name}: the port's LM covers the {PORTED_FAMILIES} families, not "
                f"{cfg.family!r} (ROADMAP queue 1, item 8)"
            )
        self.cfg = cfg
        self.n_blocks = cfg.n_layers

    # -- schema ---------------------------------------------------------------
    def _block_schema(self) -> Schema:
        cfg = self.cfg
        d = cfg.d_model
        if cfg.family == "dense":
            return {
                "attn_norm": _norm_spec(d),
                "attn": attn_mod.attn_schema(cfg),
                "mlp_norm": _norm_spec(d),
                "mlp": ffn_mod.mlp_schema(cfg, cfg.d_ff),
            }
        return {"norm": _norm_spec(d), "ssm": ssm_mod.ssm_schema(cfg)}

    def schema(self) -> Schema:
        cfg = self.cfg
        return {
            "embed": ParamSpec((cfg.padded_vocab, cfg.d_model), ("vocab", "embed"), scale=1.0),
            "blocks": stack_schema(self._block_schema(), self.n_blocks),
            "final_norm": _norm_spec(cfg.d_model),
        }

    def init(self, key, dtype: torch.dtype = torch.bfloat16, device=None):
        """The reference's ``LM.init(key, dtype)``: weights drawn from the
        threefry ``key`` (:func:`repro_torch.prng.PRNGKey`), on ``device``
        (None = CUDA)."""
        return init_params(self.schema(), key, dtype, device)

    # -- prefill blocks -------------------------------------------------------
    def _apply_block(self, x, bp, *, flags: RunFlags, collect_kv: bool):
        """Returns (x, this layer's cache pieces or None): the RoPE'd keys
        and the values for ``dense``, the SSM cache for ``ssm``."""
        cfg = self.cfg
        if cfg.family == "dense":
            h = rms_norm(x, bp["attn_norm"])
            ap = bp["attn"]
            mask = "sliding" if cfg.sliding_window else "causal"
            x = x + attn_mod.attention_forward(h, ap, cfg, mask_kind=mask, impl=flags.attn_impl)
            kv = None
            if collect_kv:
                k = torch.einsum("btd,dgk->btgk", h, ap["wk"])
                k = apply_rope(k, torch.arange(h.shape[1], device=h.device), cfg.rope_theta)
                v = torch.einsum("btd,dgk->btgk", h, ap["wv"])
                kv = {"k": k, "v": v}
            h = rms_norm(x, bp["mlp_norm"])
            return x + ffn_mod.mlp(h, bp["mlp"], cfg.act), kv
        h = rms_norm(x, bp["norm"])
        if collect_kv:
            y, cache = ssm_mod.ssm_prefill(h, bp["ssm"], cfg)
            return x + y, cache
        return x + ssm_mod.ssm_forward(h, bp["ssm"], cfg), None

    def _run_blocks(self, x, blocks, *, flags: RunFlags, collect_kv: bool = False):
        remat = flags.remat == "block" and not collect_kv and torch.is_grad_enabled()
        caches = []
        for i in range(self.n_blocks):
            bp = _layer(blocks, i)
            if remat:
                x = torch.utils.checkpoint.checkpoint(
                    self._block_out, x, bp, flags, use_reentrant=False)
                continue
            x, cache = self._apply_block(x, bp, flags=flags, collect_kv=collect_kv)
            caches.append(cache)
        return x, (_stack(caches) if collect_kv else None)

    def _block_out(self, x, bp, flags: RunFlags):
        return self._apply_block(x, bp, flags=flags, collect_kv=False)[0]

    # -- training loss --------------------------------------------------------
    def loss_fn(self, params, batch: Dict[str, Any], flags: RunFlags = RunFlags()):
        """batch: tokens (B,S) and labels (B,S), integers.  Returns
        ``(loss, {"ce": loss, "aux": 0})``: the two families have no
        auxiliary loss."""
        cfg = self.cfg
        x = params["embed"][batch["tokens"].long()]
        x, _ = self._run_blocks(x, params["blocks"], flags=flags)
        x = rms_norm(x, params["final_norm"])
        if flags.loss_impl == "chunked":
            loss = self._chunked_ce(x, params["embed"], batch["labels"], flags)
        else:
            logits = torch.einsum("bsd,vd->bsv", x, params["embed"])
            loss = cross_entropy_loss(logits, batch["labels"], cfg.vocab_size)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return loss + aux, {"ce": loss, "aux": aux}

    def _chunked_ce(self, x, embed, labels, flags: RunFlags):
        """CE over sequence chunks: only one (B, chunk, V) logits tile is
        live, forward and (each chunk recomputed) backward."""
        s = x.shape[1]
        chunk = min(flags.loss_chunk, s)
        while s % chunk:
            chunk //= 2
        nll = torch.zeros((), dtype=torch.float32, device=x.device)
        n = torch.zeros((), dtype=torch.int64, device=x.device)
        for lo in range(0, s, chunk):
            part, valid = torch.utils.checkpoint.checkpoint(
                self._chunk_nll, x[:, lo:lo + chunk], embed, labels[:, lo:lo + chunk],
                use_reentrant=False)
            nll = nll + part
            n = n + valid
        return nll / torch.clamp(n, min=1)

    def _chunk_nll(self, xc, embed, lc):
        logits = torch.einsum("bsd,vd->bsv", xc, embed).to(torch.float32)
        valid = (lc >= 0) & (lc < self.cfg.vocab_size)
        safe = torch.where(valid, lc, torch.zeros_like(lc)).long()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, safe[..., None])[..., 0]
        return ((lse - gold) * valid).sum(), valid.sum()

    # -- caches ---------------------------------------------------------------
    def kv_window(self, max_seq: int) -> int:
        cfg = self.cfg
        return min(max_seq, cfg.sliding_window) if cfg.sliding_window else max_seq

    def init_cache(self, batch: int, max_seq: int, dtype: torch.dtype = torch.bfloat16,
                   device="cpu"):
        """Zero cache.  The ssm family's state does not grow with the
        sequence, so it does not read ``max_seq``."""
        if self.cfg.family == "dense":
            layer = attn_mod.init_kv_cache(self.cfg, batch, self.kv_window(max_seq), dtype,
                                           device)
        else:
            layer = ssm_mod.init_ssm_cache(self.cfg, batch, dtype, device)
        return {
            "pos": torch.zeros((), dtype=torch.int32, device=device),
            "layers": _stack([layer] * self.n_blocks),
        }

    # -- decode ---------------------------------------------------------------
    def _decode_block(self, x, bp, bc, pos, flags: RunFlags):
        """One layer of a decode step; writes its new state into ``bc``."""
        cfg = self.cfg
        if cfg.family == "dense":
            h = rms_norm(x, bp["attn_norm"])
            y, _ = attn_mod.decode_attention(h, bp["attn"], bc, pos, cfg)
            x = x + y
            h = rms_norm(x, bp["mlp_norm"])
            return x + ffn_mod.mlp(h, bp["mlp"], cfg.act)
        h = rms_norm(x, bp["norm"])
        y, _ = ssm_mod.ssm_decode_step(h, bp["ssm"], bc, cfg, ssd_impl=flags.ssd_impl)
        return x + y

    def decode_fn(self, params, cache, token, flags: RunFlags = RunFlags()):
        """One serve step.  token: (B, 1) int -> (logits (B, vocab), cache).

        The cache is donated, as the reference's server donates it
        (``donate_argnums``): each layer writes its new state into its view
        of the stacked cache (the new key and value for ``dense``, the conv
        caches and the SSM state for ``ssm``) and ``pos`` advances in
        place, so the returned cache is the one passed in.  A caller that
        needs the old cache again clones it first.  Nothing here waits for
        the host, so the step can be captured in a CUDA graph."""
        pos = cache["pos"]
        x = params["embed"][token.long()]
        for i in range(self.n_blocks):
            x = self._decode_block(x, _layer(params["blocks"], i), _layer(cache["layers"], i),
                                   pos, flags)
        x = rms_norm(x, params["final_norm"])
        logits = torch.einsum("bsd,vd->bsv", x, params["embed"])[:, 0, : self.cfg.vocab_size]
        pos.add_(1)
        return logits, cache

    # -- prefill --------------------------------------------------------------
    def prefill_fn(self, params, batch: Dict[str, Any], max_seq: int,
                   flags: RunFlags = RunFlags()) -> Tuple[torch.Tensor, dict]:
        """Prompt pass: batch["tokens"] (B,S) -> (last-token logits, cache).

        The cache is laid out as ``init_cache(B, max_seq)``, so ``decode_fn``
        continues from position S."""
        tokens = batch["tokens"]
        s = tokens.shape[1]
        x = params["embed"][tokens.long()]
        x, kvs = self._run_blocks(x, params["blocks"], flags=flags, collect_kv=True)
        x = rms_norm(x, params["final_norm"])
        logits = torch.einsum("bd,vd->bv", x[:, -1], params["embed"])[:, : self.cfg.vocab_size]
        pos = torch.tensor(s, dtype=torch.int32, device=tokens.device)
        return logits, {"pos": pos, "layers": self._pack_cache(kvs, s, self.kv_window(max_seq))}

    def _ring_pack(self, k: torch.Tensor, s: int, w: int) -> torch.Tensor:
        """Place the last w of s keys (axis 1) into ring-buffer slots
        (slot = pos % w)."""
        if s <= w:
            pad = torch.zeros((k.shape[0], w - s) + tuple(k.shape[2:]), dtype=k.dtype,
                              device=k.device)
            return torch.cat([k, pad], dim=1)
        last = k[:, s - w:]
        slots = np.arange(s - w, s) % w
        inv = np.empty(w, dtype=np.int64)
        inv[slots] = np.arange(w)
        return last[:, torch.from_numpy(inv).to(k.device)]

    def _ring_pack_stacked(self, k: torch.Tensor, s: int, w: int) -> torch.Tensor:
        """k: (L, B, S, KV, hd) stacked over layers; the reference's
        ``vmap`` over L is a fold of L into the batch axis."""
        packed = self._ring_pack(k.reshape((-1,) + tuple(k.shape[2:])), s, w)
        return packed.reshape(tuple(k.shape[:2]) + tuple(packed.shape[1:]))

    def _pack_cache(self, kvs, s: int, w: int):
        if self.cfg.family == "dense":
            return {"k": self._ring_pack_stacked(kvs["k"], s, w),
                    "v": self._ring_pack_stacked(kvs["v"], s, w)}
        return kvs  # stacked ssm caches from prefill
