"""Model assembly (port of ``repro/models/lm.py``) for the ``ssm``,
``dense``, ``moe`` and ``hybrid`` families.

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
  blocks, as the reference lays it out: ``{conv_x, conv_B, conv_C, state}``
  for ``ssm``, the ring-buffer KV cache ``{k, v}`` (L, B, window, KV, hd)
  for ``dense`` and ``moe``, and for ``hybrid`` both, nested:
  ``{"attn": {k, v}, "ssm": {...}}`` with the SSM leaves stacked again over
  a block's 7 mixers.

A ``hybrid`` block is one pattern of ``block_len`` layers (jamba: the SSD
mixer at 7 positions, attention at ``attn_index_in_block``, each followed
by a gated MLP at even positions and MoE at odd ones), its sub-layers
stacked inside the block along a ``sublayer`` axis.  The reference's
``lax.scan`` over the stacked block axis is a Python loop over that axis.
The ``audio`` and ``vlm`` families raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (
    ParamSpec, Schema, apply_rope, cross_entropy_loss, init_params, rms_norm, tree_map,
)
from repro_torch.models.config import ModelConfig

#: The families whose blocks the port has.
PORTED_FAMILIES = ("ssm", "dense", "moe", "hybrid")


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
    is the sliding mask's query chunk, as the reference's (the causal
    mask's kernel tiles the queries itself).  ``ssd_impl`` as in
    :func:`repro_torch.kernels.ssd.ssd_decode_step` and ``attn_impl`` (the
    causal prefill and training attention) as in
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
                "port has 'none' and 'block' (ROADMAP queue 1, item 5)")
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
                f"{cfg.family!r} (ROADMAP queue 1, items 3-4)"
            )
        self.cfg = cfg
        if cfg.family == "hybrid":
            if cfg.block_len <= 0 or cfg.n_layers % cfg.block_len:
                raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a multiple of "
                                 f"block_len {cfg.block_len}")
            self.n_blocks = cfg.n_layers // cfg.block_len
        else:
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
        if cfg.family == "moe":
            block: Schema = {
                "attn_norm": _norm_spec(d),
                "attn": attn_mod.attn_schema(cfg),
                "mlp_norm": _norm_spec(d),
                "moe": ffn_mod.moe_schema(cfg),
            }
            if cfg.dense_residual:
                block["mlp"] = ffn_mod.mlp_schema(cfg, cfg.d_ff)
            return block
        if cfg.family == "hybrid":
            bl = cfg.block_len
            n_ssm = bl - 1
            n_moe = sum(1 for i in range(bl) if i % 2 == 1)
            n_mlp = bl - n_moe
            return {
                "ssm_norm": ParamSpec((n_ssm, d), ("sublayer", "embed"), init="ones"),
                "ssm": stack_schema(ssm_mod.ssm_schema(cfg), n_ssm, "sublayer"),
                "attn_norm": _norm_spec(d),
                "attn": attn_mod.attn_schema(cfg),
                "mlp_norm": ParamSpec((bl, d), ("sublayer", "embed"), init="ones"),
                "mlp": stack_schema(ffn_mod.mlp_schema(cfg, cfg.d_ff), n_mlp, "sublayer"),
                "moe": stack_schema(ffn_mod.moe_schema(cfg), n_moe, "sublayer"),
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
    def _self_attn(self, x, norm, ap, flags: RunFlags, collect_kv: bool):
        """x + attention(rms_norm(x)); with ``collect_kv`` also the RoPE'd
        keys and the values for the cache."""
        cfg = self.cfg
        h = rms_norm(x, norm)
        mask = "sliding" if cfg.sliding_window else "causal"
        x = x + attn_mod.attention_forward(h, ap, cfg, mask_kind=mask, impl=flags.attn_impl,
                                           q_chunk=flags.q_chunk)
        if not collect_kv:
            return x, None
        k = torch.einsum("btd,dgk->btgk", h, ap["wk"])
        k = apply_rope(k, torch.arange(h.shape[1], device=h.device), cfg.rope_theta)
        v = torch.einsum("btd,dgk->btgk", h, ap["wv"])
        return x, {"k": k, "v": v}

    def _apply_block(self, x, bp, *, flags: RunFlags, collect_kv: bool):
        """Returns (x, aux loss (0-dim float32), this block's cache pieces
        or None): the RoPE'd keys and the values for ``dense`` and ``moe``,
        the SSM cache for ``ssm``, both for ``hybrid``."""
        cfg = self.cfg
        fam = cfg.family
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if fam in ("dense", "moe"):
            x, kv = self._self_attn(x, bp["attn_norm"], bp["attn"], flags, collect_kv)
            h = rms_norm(x, bp["mlp_norm"])
            if fam == "dense":
                return x + ffn_mod.mlp(h, bp["mlp"], cfg.act), aux, kv
            y, a = ffn_mod.moe(h, bp["moe"], cfg)
            if cfg.dense_residual:
                y = y + ffn_mod.mlp(h, bp["mlp"], cfg.act)
            return x + y, aux + a, kv
        if fam == "ssm":
            h = rms_norm(x, bp["norm"])
            if collect_kv:
                y, cache = ssm_mod.ssm_prefill(h, bp["ssm"], cfg)
                return x + y, aux, cache
            return x + ssm_mod.ssm_forward(h, bp["ssm"], cfg), aux, None
        kvs: Dict[str, Any] = {}
        ssm_caches = []
        ssm_i = mlp_i = moe_i = 0
        for pos in range(cfg.block_len):
            if pos == cfg.attn_index_in_block:
                x, kvs["attn"] = self._self_attn(x, bp["attn_norm"], bp["attn"], flags,
                                                 collect_kv)
            else:
                sp = _layer(bp["ssm"], ssm_i)
                h = rms_norm(x, bp["ssm_norm"][ssm_i])
                if collect_kv:
                    y, sc = ssm_mod.ssm_prefill(h, sp, cfg)
                    ssm_caches.append(sc)
                else:
                    y = ssm_mod.ssm_forward(h, sp, cfg)
                x = x + y
                ssm_i += 1
            h = rms_norm(x, bp["mlp_norm"][pos])
            if pos % 2 == 1:  # MoE on odd positions
                y, a = ffn_mod.moe(h, _layer(bp["moe"], moe_i), cfg)
                aux = aux + a
                moe_i += 1
            else:
                y = ffn_mod.mlp(h, _layer(bp["mlp"], mlp_i), cfg.act)
                mlp_i += 1
            x = x + y
        if not collect_kv:
            return x, aux, None
        kvs["ssm"] = _stack(ssm_caches)
        return x, aux, kvs

    def _run_blocks(self, x, blocks, *, flags: RunFlags, collect_kv: bool = False):
        """(x, the blocks' aux losses summed in block order, the stacked
        caches or None)."""
        remat = flags.remat == "block" and not collect_kv and torch.is_grad_enabled()
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        caches = []
        for i in range(self.n_blocks):
            bp = _layer(blocks, i)
            if remat:
                x, a = torch.utils.checkpoint.checkpoint(
                    self._block_out, x, bp, flags, use_reentrant=False)
            else:
                x, a, cache = self._apply_block(x, bp, flags=flags, collect_kv=collect_kv)
                caches.append(cache)
            aux = aux + a
        return x, aux, (_stack(caches) if collect_kv else None)

    def _block_out(self, x, bp, flags: RunFlags):
        return self._apply_block(x, bp, flags=flags, collect_kv=False)[:2]

    # -- training loss --------------------------------------------------------
    def loss_fn(self, params, batch: Dict[str, Any], flags: RunFlags = RunFlags()):
        """batch: tokens (B,S) and labels (B,S), integers.  Returns
        ``(ce + aux, {"ce": ce, "aux": aux})``; ``aux`` is the MoE layers'
        router losses summed over blocks (0 for families without MoE)."""
        cfg = self.cfg
        x = params["embed"][batch["tokens"].long()]
        x, aux, _ = self._run_blocks(x, params["blocks"], flags=flags)
        x = rms_norm(x, params["final_norm"])
        if flags.loss_impl == "chunked":
            loss = self._chunked_ce(x, params["embed"], batch["labels"], flags)
        else:
            logits = torch.einsum("bsd,vd->bsv", x, params["embed"])
            loss = cross_entropy_loss(logits, batch["labels"], cfg.vocab_size)
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
                   device=None):
        """Zero cache on ``device`` (None = CUDA).  The SSM state does not
        grow with the sequence, so the ssm family does not read ``max_seq``."""
        cfg = self.cfg
        device = resolve_device(device)
        if cfg.family in ("dense", "moe"):
            layer = attn_mod.init_kv_cache(cfg, batch, self.kv_window(max_seq), dtype, device)
        elif cfg.family == "ssm":
            layer = ssm_mod.init_ssm_cache(cfg, batch, dtype, device)
        else:
            layer = {
                "attn": attn_mod.init_kv_cache(cfg, batch, self.kv_window(max_seq), dtype,
                                               device),
                "ssm": _stack([ssm_mod.init_ssm_cache(cfg, batch, dtype, device)]
                              * (cfg.block_len - 1)),
            }
        return {
            "pos": torch.zeros((), dtype=torch.int32, device=device),
            "layers": _stack([layer] * self.n_blocks),
        }

    # -- decode ---------------------------------------------------------------
    def _decode_block(self, x, bp, bc, pos, flags: RunFlags):
        """One block of a decode step; writes its new state into ``bc``
        (for ``hybrid``, each sub-layer into its view of the stacked
        cache)."""
        cfg = self.cfg
        fam = cfg.family
        if fam in ("dense", "moe"):
            h = rms_norm(x, bp["attn_norm"])
            y, _ = attn_mod.decode_attention(h, bp["attn"], bc, pos, cfg)
            x = x + y
            h = rms_norm(x, bp["mlp_norm"])
            if fam == "dense":
                return x + ffn_mod.mlp(h, bp["mlp"], cfg.act)
            y, _ = ffn_mod.moe(h, bp["moe"], cfg)
            if cfg.dense_residual:
                y = y + ffn_mod.mlp(h, bp["mlp"], cfg.act)
            return x + y
        if fam == "ssm":
            h = rms_norm(x, bp["norm"])
            y, _ = ssm_mod.ssm_decode_step(h, bp["ssm"], bc, cfg, ssd_impl=flags.ssd_impl)
            return x + y
        ssm_i = mlp_i = moe_i = 0
        for p in range(cfg.block_len):
            if p == cfg.attn_index_in_block:
                h = rms_norm(x, bp["attn_norm"])
                y, _ = attn_mod.decode_attention(h, bp["attn"], bc["attn"], pos, cfg)
            else:
                h = rms_norm(x, bp["ssm_norm"][ssm_i])
                y, _ = ssm_mod.ssm_decode_step(h, _layer(bp["ssm"], ssm_i),
                                               _layer(bc["ssm"], ssm_i), cfg,
                                               ssd_impl=flags.ssd_impl)
                ssm_i += 1
            x = x + y
            h = rms_norm(x, bp["mlp_norm"][p])
            if p % 2 == 1:
                y, _ = ffn_mod.moe(h, _layer(bp["moe"], moe_i), cfg)
                moe_i += 1
            else:
                y = ffn_mod.mlp(h, _layer(bp["mlp"], mlp_i), cfg.act)
                mlp_i += 1
            x = x + y
        return x

    def decode_fn(self, params, cache, token, flags: RunFlags = RunFlags()):
        """One serve step.  token: (B, 1) int -> (logits (B, vocab), cache).

        The cache is donated, as the reference's server donates it
        (``donate_argnums``): each layer writes its new state into its view
        of the stacked cache (the new key and value for ``dense``, the conv
        caches and the SSM state for ``ssm``) and ``pos`` advances in
        place, so the returned cache is the one passed in (``moe`` as
        ``dense``; ``hybrid`` both, each sub-layer in its view of the
        stacked cache).  A caller that
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
        x, _, kvs = self._run_blocks(x, params["blocks"], flags=flags, collect_kv=True)
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
        fam = self.cfg.family
        if fam in ("dense", "moe"):
            return {"k": self._ring_pack_stacked(kvs["k"], s, w),
                    "v": self._ring_pack_stacked(kvs["v"], s, w)}
        if fam == "ssm":
            return kvs  # stacked ssm caches from prefill
        return {
            "attn": {"k": self._ring_pack_stacked(kvs["attn"]["k"], s, w),
                     "v": self._ring_pack_stacked(kvs["attn"]["v"], s, w)},
            "ssm": kvs["ssm"],
        }
