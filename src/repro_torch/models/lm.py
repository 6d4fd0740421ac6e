"""Model assembly (port of ``repro/models/lm.py``) for all six families:
``ssm``, ``dense``, ``moe``, ``hybrid``, ``vlm`` and the ``audio``
enc-dec backbone.

One :class:`LM` object per config provides what training and serving
need, as plain functions of nested dicts of tensors:

* ``schema()`` / ``init`` — the reference's parameter schema (same flat
  keys) and its initialisation from a threefry key (``repro_torch.prng``),
  so the same seed gives the reference's weights;
* ``loss_fn`` — the causal-LM training loss (enc-dec for ``audio``),
  dense or chunked over the sequence, with per-block rematerialisation
  (``torch.utils.checkpoint`` in place of ``jax.checkpoint``, selective
  under ``remat="dots"``); on DTensor parameters (``launch.train`` under a
  mesh) it gathers fsdp's weight shards per block, looks the embedding up
  vocab-parallel, runs every product on each rank's shard of its weight
  (``sharding.rules.sharded_product``; the vocab projection
  column-parallel) and takes the loss on each rank's vocab columns
  (``common.vocab_parallel_nll``);
* ``prefill_fn`` — prompt pass producing last-token logits + the cache;
* ``decode_fn`` — one-token serve step, updating the cache in place; both
  run on DTensor parameters too (a cache placed by
  ``sharding.place_cache``, each rank writing its shard);
* ``abstract_params`` / ``abstract_cache`` — the trees as meta tensors,
  for the dry-run (``launch/dryrun.py``);
* ``init_cache`` — ``{"pos", "layers": ...}``, each leaf stacked over
  blocks, as the reference lays it out: ``{conv_x, conv_B, conv_C, state}``
  for ``ssm``, the ring-buffer KV cache ``{k, v}`` (L, B, window, KV, hd)
  for ``dense`` and ``moe``, and for ``hybrid`` both, nested:
  ``{"attn": {k, v}, "ssm": {...}}`` with the SSM leaves stacked again over
  a block's 7 mixers; for ``vlm`` and ``audio`` ``{"self": {k, v},
  "cross": {k, v}}``, the vlm's self caches stacked again over a block's 4
  self-attention sub-layers, the cross keys and values (B, T, KV, hd) of
  the vision tokens or the encoder output, written once by the prefill
  and only read by decode.

A ``hybrid`` block is one pattern of ``block_len`` layers (jamba: the SSD
mixer at 7 positions, attention at ``attn_index_in_block``, each followed
by a gated MLP at even positions and MoE at odd ones), its sub-layers
stacked inside the block along a ``sublayer`` axis.  A ``vlm`` block is
one pattern of ``cross_attn_every`` layers: ``cross_attn_every - 1``
self-attention layers, then a cross-attention layer over the vision tokens
(``batch["image_embeds"]``) whose output is gated by
``tanh(cross_gate)`` (0 at init), each followed by an MLP.  An ``audio``
decoder block is self attention, ungated cross attention over the
encoder's output, MLP; the encoder (``enc_blocks``) is ``enc_layers``
full-mask self-attention layers over ``batch["audio_embeds"]``.  The
reference's ``lax.scan`` over the stacked block axis is a Python loop over
that axis.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (
    ParamSpec, Schema, apply_rope, cross_entropy_loss, in_no_batch_einsum, init_params,
    logical_axes, rms_norm, token_nll, tree_map,
)
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.rules import batch_spec_axes, gather_batch_dims, sharded_product

def stack_schema(schema: Schema, n: int, axis: str = "layers") -> Schema:
    return tree_map(lambda s: ParamSpec((n,) + s.shape, (axis,) + s.axes, s.init, s.scale),
                    schema)


def _norm_spec(d: int) -> ParamSpec:
    return ParamSpec((d,), ("embed",), init="ones")


def _layer(tree, i: int):
    """Layer ``i`` of a tree stacked over layers (views, no copy)."""
    return tree_map(lambda a: a[i], tree)


def _gathered(tree):
    """A block's (or a top-level) weights for its compute: under a mesh,
    each DTensor gathered whole over the batch's mesh dims (fsdp shards
    "embed" over "data"), its "model" shard kept, as FSDP gathers a layer
    before it runs and reduce-scatters its grads after (the gather's
    backward).  Left to itself DTensor would shard the activations' embed
    dim like the weights' and replicate the batch through the layers.
    Anything else (every other strategy's weights, plain tensors) as it
    is."""
    return tree_map(lambda t: gather_batch_dims(t) if isinstance(t, DTensor) else t, tree)


def _embed_tokens(tokens, embed):
    """The embedding rows of ``tokens`` for training (``F.embedding``: its
    backward sums the rows' grads deterministically on the card, where
    indexing's ``index_put`` uses atomics unless deterministic algorithms
    are on).  On DTensors a vocab-parallel lookup, per rank in a
    ``local_map``: where "model" splits the vocab, each rank looks up the
    tokens its rows hold, zeroes the others, and the output is the sum
    over the ranks (``Partial``), reduced once; the grad of each rank's
    rows stays with it.  DTensor's own strategies fail here: indexing's backward
    (``index_put``) in torch 2.11, the embedding's masked partial in 2.13."""
    if not isinstance(embed, DTensor):
        return F.embedding(tokens, embed)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = embed.device_mesh
    names = mesh.mesh_dim_names
    pw = [p if n == "model" else Replicate() for n, p in zip(names, embed.placements)]
    split = Shard(0) in pw
    # the batch stays split where the tokens split it, over "model" too
    # unless the vocab is split there
    batch = [Shard(0) if p == Shard(0) and not (n == "model" and split) else Replicate()
             for n, p in zip(names, tokens.placements)]
    rows = embed.shape[0] // (mesh.size(names.index("model")) if split else 1)
    lo = mesh.get_local_rank("model") * rows if split else 0
    out = [Partial() if q == Shard(0) else p for p, q in zip(batch, pw)]
    gw = [Partial() if p == Shard(0) else q for p, q in zip(batch, pw)]

    def local(t, w):
        if not split:
            return F.embedding(t, w)
        ids = t - lo
        valid = (ids >= 0) & (ids < rows)
        return F.embedding(torch.where(valid, ids, 0), w).masked_fill(~valid[..., None], 0)

    x = local_map(local, out_placements=out, in_placements=(batch, pw),
                  in_grad_placements=(batch, gw), device_mesh=mesh,
                  redistribute_inputs=True)(tokens, embed)
    # reduced once to the residual stream's placement: a Partial stream
    # would be reduced again by every op that reads it
    return x.redistribute(mesh, batch) if split else x


def _lookup(tokens, embed):
    """The serving steps' embedding rows: indexing, as the reference; on a
    DTensor table the vocab-parallel :func:`_embed_tokens`."""
    return _embed_tokens(tokens, embed) if isinstance(embed, DTensor) else embed[tokens]


def _constrain_acts(x, flags: "RunFlags"):
    """``RunFlags.constrain_acts``: the residual stream ``Shard(0)`` over the
    mesh dims that carry its batch (``sharding.batch_spec_axes``) and
    replicated over the rest (a plain tensor, or the flag off, as it is)."""
    if not flags.constrain_acts or not isinstance(x, DTensor):
        return x
    from torch.distributed.tensor import Replicate, Shard

    dp = batch_spec_axes(x.device_mesh, x.shape[0]) or ()
    pl = [Shard(0) if n in dp else Replicate() for n in x.device_mesh.mesh_dim_names]
    return x if list(x.placements) == pl else x.redistribute(x.device_mesh, pl)


#: rank of one layer's cache leaf: (B, W, KV, hd), (B, C, W-1), (B, H, P, N)
_LEAF_RANK = {"k": 4, "v": 4, "conv_x": 3, "conv_B": 3, "conv_C": 3, "state": 4}


def _stacked_whole(layers):
    """``layers`` (the cache's stacked leaves) with every DTensor leaf whose
    layer or sub-layer dims are sharded redistributed whole along them,
    and the (placed, working) pairs to copy back after the step.  The
    reference's rule shards the first dim whose size equals the batch,
    which a stacked dim can be (4 sub-layers at batch 4); a layer's view
    of a leaf sharded there would be a copy, and the step's in-place
    writes would be lost.  Elsewhere ``layers`` as it is, nothing to copy."""
    from torch.distributed.tensor import Replicate

    written = []

    def one(path, t):
        if not isinstance(t, DTensor):
            return t
        lead = t.dim() - _LEAF_RANK[path[-1]]
        pl = [Replicate() if p.is_shard() and p.dim < lead else p for p in t.placements]
        if pl == list(t.placements):
            return t
        work = t.redistribute(t.device_mesh, pl)
        written.append((t, work))
        return work

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return one(path, node)

    return walk(layers, ()), written


def _stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


@dataclasses.dataclass(frozen=True)
class RunFlags:
    """The reference's run flags that training and serving read, plus the
    port's choice of kernel implementations.

    ``remat``: "none"; "block" to recompute each block's forward in the
    backward pass (``torch.utils.checkpoint`` per block, as the reference
    wraps its scan body in ``jax.checkpoint``); or "dots", the reference's
    ``jax.checkpoint(policy=dots_with_no_batch_dims_saveable)``: each block
    is checkpointed selectively (:func:`_dots_policy`), saving the output
    of every product with no batch dimension and recomputing the rest, and
    the audio encoder's blocks are recomputed whole, as the reference's.
    The flash kernel is a custom op (``repro_torch::flash_attention``) that
    the dots policy does not save, so under "block" and "dots" alike it
    launches again in the recompute.
    ``loss_impl``: "dense" materialises the (B, S, V) logits, "chunked"
    computes the loss over sequence chunks of ``loss_chunk`` (each chunk
    recomputed in the backward pass), as the reference does.  ``q_chunk``
    is the sliding mask's query chunk, as the reference's (the causal
    mask's kernel tiles the queries itself).  ``ssd_impl`` as in
    :func:`repro_torch.kernels.ssd.ssd_decode_step` and ``attn_impl`` (the
    causal prefill and training attention) as in
    :func:`repro_torch.kernels.flash_attention.flash_attention`: "" lets
    the device decide (CUDA kernel on the card, plain version on the CPU),
    "ref" forces the plain version.

    The dry-run's fields (``launch/dryrun.py`` sets them from its profiles;
    they act only on DTensor activations, and change what is sharded, not
    what is computed): ``constrain_acts`` redistributes the residual
    stream to ``Shard(0)`` over the mesh dims of the batch and replicated
    over the rest, after the embedding and at every block boundary, the
    reference's ``with_sharding_constraint(x, P(act_dp, None, None))``;
    ``decode_constrain`` keeps the decode KV cache sharded on its sequence
    over "model" (the batch over its mesh dims) through the update,
    replicates q over "model" and runs the softmax as partial reductions
    over the sequence shards (the reference's flash-decode constraints;
    ``attention._seq_sharded_decode``): neither the cache nor the
    (B, H, 1, W) logits are gathered.  The reference's
    ``scan_unroll`` has no counterpart: the port has no ``lax.scan``
    (its blocks are a Python loop) and its counters see every block, so
    there is no scan body to correct for.  Nor have the reference's
    ``act_dp`` and ``decode_dp``: the batch's mesh dims are
    ``sharding.batch_spec_axes`` of the activation's mesh and global
    batch, which is what the reference's dry-run sets them to."""

    remat: str = "block"
    q_chunk: int = 512
    loss_impl: str = "dense"
    loss_chunk: int = 512
    ssd_impl: str = ""
    attn_impl: str = ""
    decode_constrain: bool = False
    constrain_acts: bool = False

    def __post_init__(self) -> None:
        if self.remat not in ("none", "block", "dots"):
            raise ValueError(f"unknown remat {self.remat!r}; expected 'none', 'block' or "
                             "'dots'")
        if self.loss_impl not in ("dense", "chunked"):
            raise ValueError(f"unknown loss_impl {self.loss_impl!r}; expected 'dense' "
                             "or 'chunked'")


def _dots_policy(ctx, op, *args, **kwargs):
    """The selective-checkpoint policy of ``remat="dots"``: save the output
    of every product with no batch dimension, recompute everything else.
    torch lowers ``x @ W`` to ``aten.mm`` and every einsum to ``aten.bmm``;
    a product with no batch dimension reaches ``aten.bmm`` with a batch of
    1, so those einsums are marked (:func:`common.no_batch_einsum`) and a
    marked ``aten.bmm`` is saved, never one by its shape alone."""
    if op is torch.ops.aten.mm.default or (op is torch.ops.aten.bmm.default
                                           and in_no_batch_einsum()):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


class LM:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        if cfg.family == "hybrid":
            if cfg.block_len <= 0 or cfg.n_layers % cfg.block_len:
                raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a multiple of "
                                 f"block_len {cfg.block_len}")
            self.n_blocks = cfg.n_layers // cfg.block_len
        elif cfg.family == "vlm":
            if cfg.cross_attn_every <= 0 or cfg.n_layers % cfg.cross_attn_every:
                raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a multiple of "
                                 f"cross_attn_every {cfg.cross_attn_every}")
            self.n_blocks = cfg.n_layers // cfg.cross_attn_every
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
        if cfg.family == "vlm":
            n_self = cfg.cross_attn_every - 1
            per = cfg.cross_attn_every
            return {
                "self_norm": ParamSpec((n_self, d), ("sublayer", "embed"), init="ones"),
                "self_attn": stack_schema(attn_mod.attn_schema(cfg), n_self, "sublayer"),
                "cross_norm": _norm_spec(d),
                "cross_attn": attn_mod.attn_schema(cfg, cross=True),
                "cross_gate": ParamSpec((1,), (None,), init="zeros"),
                "mlp_norm": ParamSpec((per, d), ("sublayer", "embed"), init="ones"),
                "mlp": stack_schema(ffn_mod.mlp_schema(cfg, cfg.d_ff), per, "sublayer"),
            }
        if cfg.family == "audio":
            return {  # decoder block
                "self_norm": _norm_spec(d),
                "self_attn": attn_mod.attn_schema(cfg),
                "cross_norm": _norm_spec(d),
                "cross_attn": attn_mod.attn_schema(cfg, cross=True),
                "mlp_norm": _norm_spec(d),
                "mlp": ffn_mod.mlp_schema(cfg, cfg.d_ff),
            }
        return {"norm": _norm_spec(d), "ssm": ssm_mod.ssm_schema(cfg)}

    def _enc_block_schema(self) -> Schema:
        cfg = self.cfg
        return {
            "attn_norm": _norm_spec(cfg.d_model),
            "attn": attn_mod.attn_schema(cfg),
            "mlp_norm": _norm_spec(cfg.d_model),
            "mlp": ffn_mod.mlp_schema(cfg, cfg.d_ff),
        }

    def schema(self) -> Schema:
        cfg = self.cfg
        out = {
            "embed": ParamSpec((cfg.padded_vocab, cfg.d_model), ("vocab", "embed"), scale=1.0),
            "blocks": stack_schema(self._block_schema(), self.n_blocks),
            "final_norm": _norm_spec(cfg.d_model),
        }
        if cfg.family == "audio":
            out["enc_blocks"] = stack_schema(self._enc_block_schema(), cfg.enc_layers)
            out["enc_norm"] = _norm_spec(cfg.d_model)
        return out

    def init(self, key, dtype: torch.dtype = torch.bfloat16, device=None):
        """The reference's ``LM.init(key, dtype)``: weights drawn from the
        threefry ``key`` (:func:`repro_torch.prng.PRNGKey`), on ``device``
        (None = CUDA)."""
        return init_params(self.schema(), key, dtype, device)

    def abstract_params(self, dtype: torch.dtype = torch.bfloat16):
        """The parameter tree's shapes, every leaf in ``dtype``, as meta
        tensors (the reference's ``abstract_params``): :meth:`init` on the
        meta device, which draws nothing."""
        return self.init(None, dtype, "meta")

    def logical_axes(self):
        """The logical-axis tuple of every parameter leaf, in the
        parameter tree's layout."""
        return logical_axes(self.schema())

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
        k = sharded_product("btd,dgk->btgk", h, ap["wk"])
        k = apply_rope(k, torch.arange(h.shape[1], device=h.device), cfg.rope_theta)
        v = sharded_product("btd,dgk->btgk", h, ap["wv"])
        return x, {"k": k, "v": v}

    def _cross_attn(self, x, norm, ap, cross_src, flags: RunFlags):
        """attention(rms_norm(x)) over ``cross_src``'s keys and values: the
        full mask, no RoPE (the residual is the caller's)."""
        return attn_mod.attention_forward(rms_norm(x, norm), ap, self.cfg, mask_kind="full",
                                          kv_input=cross_src, use_rope=False,
                                          impl=flags.attn_impl, q_chunk=flags.q_chunk)

    def _apply_block(self, x, bp, *, flags: RunFlags, collect_kv: bool, cross_src=None):
        """Returns (x, aux loss (0-dim float32), this block's cache pieces
        or None): the RoPE'd keys and the values for ``dense`` and ``moe``,
        the SSM cache for ``ssm``, both for ``hybrid``; for ``vlm`` and
        ``audio`` the self-attention keys and values and the cross
        sub-layer's of ``cross_src``."""
        cfg = self.cfg
        fam = cfg.family
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if fam in ("vlm", "audio"):
            x, kvs = self._apply_cross_block(x, bp, flags, collect_kv, cross_src)
            return x, aux, kvs
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

    def _apply_cross_block(self, x, bp, flags: RunFlags, collect_kv: bool, cross_src):
        """A ``vlm`` pattern block (self-attention layers, then the gated
        cross-attention layer, each with its MLP) or an ``audio`` decoder
        block (self attention, cross attention, MLP).  Returns (x, cache
        pieces or None)."""
        cfg = self.cfg
        if cfg.family == "audio":
            x, self_kv = self._self_attn(x, bp["self_norm"], bp["self_attn"], flags, collect_kv)
            x = x + self._cross_attn(x, bp["cross_norm"], bp["cross_attn"], cross_src, flags)
            x = x + ffn_mod.mlp(rms_norm(x, bp["mlp_norm"]), bp["mlp"], cfg.act)
        else:
            n_self = cfg.cross_attn_every - 1
            self_kvs = []
            for i in range(n_self):
                x, kv = self._self_attn(x, bp["self_norm"][i], _layer(bp["self_attn"], i), flags,
                                        collect_kv)
                self_kvs.append(kv)
                x = x + ffn_mod.mlp(rms_norm(x, bp["mlp_norm"][i]), _layer(bp["mlp"], i), cfg.act)
            y = self._cross_attn(x, bp["cross_norm"], bp["cross_attn"], cross_src, flags)
            x = x + torch.tanh(bp["cross_gate"]).to(x.dtype) * y
            x = x + ffn_mod.mlp(rms_norm(x, bp["mlp_norm"][n_self]), _layer(bp["mlp"], n_self),
                                cfg.act)
            self_kv = _stack(self_kvs) if collect_kv else None
        if not collect_kv:
            return x, None
        ck, cv = attn_mod.precompute_cross_kv(cross_src, bp["cross_attn"])
        return x, {"self": self_kv, "cross": {"k": ck, "v": cv}}

    def _run_blocks(self, x, blocks, *, flags: RunFlags, collect_kv: bool = False,
                    cross_src=None):
        """(x, the blocks' aux losses summed in block order, the stacked
        caches or None)."""
        remat = flags.remat != "none" and not collect_kv and torch.is_grad_enabled()
        kw = {}
        if flags.remat == "dots":
            kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                                 _dots_policy)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        caches = []
        for i in range(self.n_blocks):
            bp = _gathered(_layer(blocks, i))
            x = _constrain_acts(x, flags)
            if remat:
                x, a = torch.utils.checkpoint.checkpoint(
                    self._block_out, x, bp, flags, cross_src, use_reentrant=False, **kw)
            else:
                x, a, cache = self._apply_block(x, bp, flags=flags, collect_kv=collect_kv,
                                                cross_src=cross_src)
                caches.append(cache)
            aux = aux + a
        return x, aux, (_stack(caches) if collect_kv else None)

    def _block_out(self, x, bp, flags: RunFlags, cross_src=None):
        return self._apply_block(x, bp, flags=flags, collect_kv=False, cross_src=cross_src)[:2]

    def _encode(self, params, audio_embeds, flags: RunFlags):
        """The audio encoder: ``enc_layers`` full-mask self-attention layers
        (RoPE at positions 0..F-1) with their MLPs over the frame
        embeddings (B, F, D), then ``enc_norm``.  Under "block" and "dots"
        each encoder block is recomputed whole (the reference checkpoints
        its encoder without a policy for both)."""
        remat = flags.remat != "none" and torch.is_grad_enabled()
        x = audio_embeds
        for i in range(self.cfg.enc_layers):
            bp = _gathered(_layer(params["enc_blocks"], i))
            if remat:
                x = torch.utils.checkpoint.checkpoint(self._enc_block, x, bp, flags,
                                                      use_reentrant=False)
            else:
                x = self._enc_block(x, bp, flags)
        return rms_norm(x, params["enc_norm"])

    def _enc_block(self, x, bp, flags: RunFlags):
        cfg = self.cfg
        x = x + attn_mod.attention_forward(rms_norm(x, bp["attn_norm"]), bp["attn"], cfg,
                                           mask_kind="full", impl=flags.attn_impl,
                                           q_chunk=flags.q_chunk)
        return x + ffn_mod.mlp(rms_norm(x, bp["mlp_norm"]), bp["mlp"], cfg.act)

    def _cross_source(self, params, batch: Dict[str, Any], flags: RunFlags):
        """What the cross sub-layers attend to: the encoded
        ``audio_embeds`` (audio), the ``image_embeds`` as given (vlm), or
        None."""
        if self.cfg.family == "audio":
            return self._encode(params, batch["audio_embeds"], flags)
        if self.cfg.family == "vlm":
            return batch["image_embeds"]
        return None

    # -- training loss --------------------------------------------------------
    def loss_fn(self, params, batch: Dict[str, Any], flags: RunFlags = RunFlags()):
        """batch: tokens (B,S) and labels (B,S), integers [+ audio_embeds
        (B,F,D) | image_embeds (B,V,D)].  Returns ``(ce + aux, {"ce": ce,
        "aux": aux})``; ``aux`` is the MoE layers' router losses summed over
        blocks (0 for families without MoE)."""
        cfg = self.cfg
        top = {k: _gathered(v) for k, v in params.items() if "blocks" not in k}
        x = _constrain_acts(_embed_tokens(batch["tokens"].long(), top["embed"]), flags)
        cross_src = self._cross_source(dict(params, **top), batch, flags)
        x, aux, _ = self._run_blocks(x, params["blocks"], flags=flags, cross_src=cross_src)
        x = rms_norm(x, top["final_norm"])
        if flags.loss_impl == "chunked":
            loss = self._chunked_ce(x, top["embed"], batch["labels"], flags)
        else:
            logits = sharded_product("bsd,vd->bsv", x, top["embed"])
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
        nll, valid = token_nll(sharded_product("bsd,vd->bsv", xc, embed), lc, self.cfg.vocab_size)
        return nll.sum(), valid.sum()

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
        elif cfg.family in ("vlm", "audio"):
            kv = attn_mod.init_kv_cache(cfg, batch, self.kv_window(max_seq), dtype, device)
            n_cross = cfg.vision_tokens if cfg.family == "vlm" else cfg.audio_frames
            layer = {
                "self": _stack([kv] * (cfg.cross_attn_every - 1)) if cfg.family == "vlm" else kv,
                "cross": attn_mod.init_kv_cache(cfg, batch, n_cross, dtype, device),
            }
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

    def abstract_cache(self, batch: int, max_seq: int, dtype: torch.dtype = torch.bfloat16):
        """:meth:`init_cache`'s tree, shapes and dtypes as meta tensors (no
        memory): the reference's ``abstract_cache``."""
        return self.init_cache(batch, max_seq, dtype, "meta")

    # -- decode ---------------------------------------------------------------
    def _decode_block(self, x, bp, bc, pos, flags: RunFlags):
        """One block of a decode step; writes its new state into ``bc``
        (for ``hybrid`` and ``vlm``, each sub-layer into its view of the
        stacked cache; the cross keys and values are only read)."""
        cfg = self.cfg
        fam = cfg.family
        dc = flags.decode_constrain
        if fam in ("vlm", "audio"):
            return self._decode_cross_block(x, bp, bc, pos, dc)
        if fam in ("dense", "moe"):
            h = rms_norm(x, bp["attn_norm"])
            y, _ = attn_mod.decode_attention(h, bp["attn"], bc, pos, cfg, constrain=dc)
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
                y, _ = attn_mod.decode_attention(h, bp["attn"], bc["attn"], pos, cfg, constrain=dc)
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

    def _decode_cross_block(self, x, bp, bc, pos, dc=False):
        """A ``vlm`` pattern block or an ``audio`` decoder block of a decode
        step (see :meth:`_apply_cross_block`)."""
        cfg = self.cfg

        def cross(x, norm):
            return attn_mod.decode_cross_attention(rms_norm(x, norm), bp["cross_attn"],
                                                   bc["cross"]["k"], bc["cross"]["v"], cfg)

        if cfg.family == "audio":
            y, _ = attn_mod.decode_attention(rms_norm(x, bp["self_norm"]), bp["self_attn"],
                                             bc["self"], pos, cfg, constrain=dc)
            x = x + y
            x = x + cross(x, bp["cross_norm"])
            return x + ffn_mod.mlp(rms_norm(x, bp["mlp_norm"]), bp["mlp"], cfg.act)
        n_self = cfg.cross_attn_every - 1
        for i in range(n_self):
            y, _ = attn_mod.decode_attention(rms_norm(x, bp["self_norm"][i]),
                                             _layer(bp["self_attn"], i), _layer(bc["self"], i),
                                             pos, cfg, constrain=dc)
            x = x + y
            x = x + ffn_mod.mlp(rms_norm(x, bp["mlp_norm"][i]), _layer(bp["mlp"], i), cfg.act)
        x = x + torch.tanh(bp["cross_gate"]).to(x.dtype) * cross(x, bp["cross_norm"])
        return x + ffn_mod.mlp(rms_norm(x, bp["mlp_norm"][n_self]), _layer(bp["mlp"], n_self),
                               cfg.act)

    def decode_fn(self, params, cache, token, flags: RunFlags = RunFlags()):
        """One serve step.  token: (B, 1) int -> (logits (B, vocab), cache).

        The cache is donated, as the reference's server donates it
        (``donate_argnums``): each layer writes its new state into its view
        of the stacked cache (the new key and value for ``dense``, the conv
        caches and the SSM state for ``ssm``) and ``pos`` advances in
        place, so the returned cache is the one passed in (``moe`` as
        ``dense``; ``hybrid`` both, each sub-layer in its view of the
        stacked cache; ``vlm`` and ``audio`` their self caches, the cross
        keys and values read, never copied).  A caller that
        needs the old cache again clones it first.  Nothing here waits for
        the host, so the step can be captured in a CUDA graph."""
        pos = cache["pos"]
        top = {k: _gathered(v) for k, v in params.items() if "blocks" not in k}
        x = _lookup(token.long(), top["embed"])
        layers, written = _stacked_whole(cache["layers"])
        for i in range(self.n_blocks):
            x = self._decode_block(x, _gathered(_layer(params["blocks"], i)),
                                   _layer(layers, i), pos, flags)
        for placed, work in written:  # back into the donated cache's own tensors
            placed.copy_(work)
        x = rms_norm(x, top["final_norm"])
        logits = sharded_product("bsd,vd->bsv", x, top["embed"])[:, 0, : self.cfg.vocab_size]
        pos.add_(1)
        return logits, cache

    # -- prefill --------------------------------------------------------------
    def prefill_fn(self, params, batch: Dict[str, Any], max_seq: int,
                   flags: RunFlags = RunFlags()) -> Tuple[torch.Tensor, dict]:
        """Prompt pass: batch["tokens"] (B,S) [+ audio_embeds | image_embeds]
        -> (last-token logits, cache).

        The cache is laid out as ``init_cache(B, max_seq)``, so ``decode_fn``
        continues from position S."""
        tokens = batch["tokens"]
        s = tokens.shape[1]
        top = {k: _gathered(v) for k, v in params.items() if "blocks" not in k}
        x = _lookup(tokens.long(), top["embed"])
        cross_src = self._cross_source(dict(params, **top), batch, flags)
        x, _, kvs = self._run_blocks(x, params["blocks"], flags=flags, collect_kv=True,
                                     cross_src=cross_src)
        x = rms_norm(x, top["final_norm"])
        logits = sharded_product("bd,vd->bv", x[:, -1], top["embed"])[:, : self.cfg.vocab_size]
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

    def _ring_pack_stacked(self, k: torch.Tensor, s: int, w: int,
                           extra_lead: int = 0) -> torch.Tensor:
        """k: (L[, sub], B, S, KV, hd) stacked over layers (and sub-layers
        with ``extra_lead``); the reference's ``vmap`` over the stacked
        axes is a fold of them into the batch axis.  On a DTensor each rank
        packs its own shard (a ``local_map``, S whole): the fold of a
        batch-sharded dim into the stacked ones is no DTensor layout."""
        n = 2 + extra_lead
        if isinstance(k, DTensor):
            from torch.distributed.tensor import Replicate
            from torch.distributed.tensor.experimental import local_map

            pl = [Replicate() if p.is_shard(n) else p for p in k.placements]
            return local_map(lambda t: self._ring_pack_stacked(t, s, w, extra_lead),
                             out_placements=pl, in_placements=(pl,), device_mesh=k.device_mesh,
                             redistribute_inputs=True)(k)
        packed = self._ring_pack(k.reshape((-1,) + tuple(k.shape[n:])), s, w)
        return packed.reshape(tuple(k.shape[:n]) + tuple(packed.shape[1:]))

    def _pack_cache(self, kvs, s: int, w: int):
        fam = self.cfg.family
        if fam in ("dense", "moe"):
            return {"k": self._ring_pack_stacked(kvs["k"], s, w),
                    "v": self._ring_pack_stacked(kvs["v"], s, w)}
        if fam == "ssm":
            return kvs  # stacked ssm caches from prefill
        if fam in ("vlm", "audio"):
            lead = 1 if fam == "vlm" else 0
            return {
                "self": {"k": self._ring_pack_stacked(kvs["self"]["k"], s, w, lead),
                         "v": self._ring_pack_stacked(kvs["self"]["v"], s, w, lead)},
                "cross": kvs["cross"],
            }
        return {
            "attn": {"k": self._ring_pack_stacked(kvs["attn"]["k"], s, w),
                     "v": self._ring_pack_stacked(kvs["attn"]["v"], s, w)},
            "ssm": kvs["ssm"],
        }
