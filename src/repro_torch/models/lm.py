"""Model assembly (port of ``repro/models/lm.py``) for the ``ssm`` family.

One :class:`LM` object per config provides what serving needs, as plain
functions of nested dicts of tensors:

* ``schema()`` / ``init`` — the reference's parameter schema (same flat
  keys, so JAX-initialised weights carry across leaf by leaf);
* ``prefill_fn`` — prompt pass producing last-token logits + the SSM cache;
* ``decode_fn`` — one-token serve step against the cache;
* ``init_cache`` — ``{"pos", "layers": {conv_x, conv_B, conv_C, state}}``,
  each leaf stacked over layers, as the reference lays it out.

The reference's ``lax.scan`` over the stacked layer axis is a Python loop
over that axis.  Every other family raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import ParamSpec, Schema, init_params, rms_norm, tree_map
from repro_torch.models.config import ModelConfig


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
    """The reference's run flags that serving reads, plus the port's choice
    of SSD decode-step implementation.

    ``remat`` and ``q_chunk`` have no effect on the ``ssm`` family's
    serving (no autograd, no attention); they are kept so callers build
    flags as for the reference.  ``ssd_impl`` as in
    :func:`repro_torch.kernels.ssd.ssd_decode_step`: "" lets the device
    decide (CUDA kernel on the card, plain version on the CPU), "ref" forces
    the plain version."""

    remat: str = "block"
    q_chunk: int = 512
    ssd_impl: str = ""


class LM:
    def __init__(self, cfg: ModelConfig):
        if cfg.family != "ssm":
            raise NotImplementedError(
                f"{cfg.name}: the port's LM covers the ssm family only, not "
                f"{cfg.family!r} (ROADMAP queue 1, item 8)"
            )
        self.cfg = cfg
        self.n_blocks = cfg.n_layers

    # -- schema ---------------------------------------------------------------
    def _block_schema(self) -> Schema:
        cfg = self.cfg
        return {"norm": _norm_spec(cfg.d_model), "ssm": ssm_mod.ssm_schema(cfg)}

    def schema(self) -> Schema:
        cfg = self.cfg
        return {
            "embed": ParamSpec((cfg.padded_vocab, cfg.d_model), ("vocab", "embed"), scale=1.0),
            "blocks": stack_schema(self._block_schema(), self.n_blocks),
            "final_norm": _norm_spec(cfg.d_model),
        }

    def init(self, generator: torch.Generator, dtype: torch.dtype = torch.bfloat16,
             device="cpu"):
        return init_params(self.schema(), generator, dtype, device)

    # -- prefill blocks -------------------------------------------------------
    def _apply_block(self, x, bp, *, collect_kv: bool):
        """Returns (x, ssm cache or None)."""
        h = rms_norm(x, bp["norm"])
        if collect_kv:
            y, cache = ssm_mod.ssm_prefill(h, bp["ssm"], self.cfg)
            return x + y, cache
        return x + ssm_mod.ssm_forward(h, bp["ssm"], self.cfg), None

    def _run_blocks(self, x, blocks, *, collect_kv: bool = False):
        caches = []
        for i in range(self.n_blocks):
            x, cache = self._apply_block(x, _layer(blocks, i), collect_kv=collect_kv)
            caches.append(cache)
        return x, (_stack(caches) if collect_kv else None)

    # -- caches ---------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int, dtype: torch.dtype = torch.bfloat16,
                   device="cpu"):
        """Zero cache; ``max_seq`` is unused by the ssm family (its state
        does not grow with the sequence) and kept for the reference's
        signature."""
        layer = ssm_mod.init_ssm_cache(self.cfg, batch, dtype, device)
        return {
            "pos": torch.zeros((), dtype=torch.int32, device=device),
            "layers": _stack([layer] * self.n_blocks),
        }

    # -- decode ---------------------------------------------------------------
    def _decode_block(self, x, bp, bc, flags: RunFlags):
        h = rms_norm(x, bp["norm"])
        y, cache = ssm_mod.ssm_decode_step(h, bp["ssm"], bc, self.cfg, ssd_impl=flags.ssd_impl)
        return x + y, cache

    def decode_fn(self, params, cache, token, flags: RunFlags = RunFlags()):
        """One serve step.  token: (B, 1) int -> (logits (B, vocab), cache)."""
        x = params["embed"][token.long()]
        layers = []
        for i in range(self.n_blocks):
            x, lc = self._decode_block(x, _layer(params["blocks"], i),
                                       _layer(cache["layers"], i), flags)
            layers.append(lc)
        x = rms_norm(x, params["final_norm"])
        logits = torch.einsum("bsd,vd->bsv", x, params["embed"])[:, 0, : self.cfg.vocab_size]
        return logits, {"pos": cache["pos"] + 1, "layers": _stack(layers)}

    # -- prefill --------------------------------------------------------------
    def prefill_fn(self, params, batch: Dict[str, Any], max_seq: int,
                   flags: RunFlags = RunFlags()) -> Tuple[torch.Tensor, dict]:
        """Prompt pass: batch["tokens"] (B,S) -> (last-token logits, cache).

        The cache is laid out as ``init_cache(B, max_seq)``, so ``decode_fn``
        continues from position S."""
        tokens = batch["tokens"]
        s = tokens.shape[1]
        x = params["embed"][tokens.long()]
        x, layers = self._run_blocks(x, params["blocks"], collect_kv=True)
        x = rms_norm(x, params["final_norm"])
        logits = torch.einsum("bd,vd->bv", x[:, -1], params["embed"])[:, : self.cfg.vocab_size]
        pos = torch.tensor(s, dtype=torch.int32, device=tokens.device)
        return logits, {"pos": pos, "layers": layers}
