"""Meta-tensor input stand-ins for every (architecture x input shape)
(port of ``repro/launch/specs.py``).

``train_like_specs`` and ``decode_specs`` return what the corresponding
step function takes, as meta tensors of the reference's shapes and dtypes
(its ``ShapeDtypeStruct``s): no memory, and placed on a mesh by the
sharding rules before the dry-run traces a step.  The audio and vision
frontends are stubbed as the reference stubs them: ``audio_embeds`` and
``image_embeds`` stand in for the frontends' outputs.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models.config import InputShape, ModelConfig
from repro_torch.models.lm import LM


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_like_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    """Batch specs for the train and prefill step functions."""
    b, s = shape.global_batch, shape.seq_len
    specs: Dict[str, Any] = {"tokens": _meta((b, s), torch.int32)}
    if shape.kind == "train":
        specs["labels"] = _meta((b, s), torch.int32)
    if cfg.family == "audio":
        specs["audio_embeds"] = _meta((b, cfg.audio_frames, cfg.d_model), torch.bfloat16)
    if cfg.family == "vlm":
        specs["image_embeds"] = _meta((b, cfg.vision_tokens, cfg.d_model), torch.bfloat16)
    return specs


def decode_specs(lm: LM, shape: InputShape) -> Tuple[Any, torch.Tensor]:
    """(abstract cache of ``seq_len`` slots, next-token spec) for the serve
    step."""
    cache = lm.abstract_cache(shape.global_batch, shape.seq_len)
    return cache, _meta((shape.global_batch, 1), torch.int32)


def supports_shape(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    """long_500k applicability, with the reference's reasons word for word."""
    if shape.name != "long_500k":
        return True, ""
    if cfg.family in ("ssm", "hybrid"):
        return True, ""
    if cfg.family == "dense":
        return True, "requires sliding-window variant"
    reasons = {
        "moe": "full-attention MoE, 4k-context model card",
        "audio": "enc-dec speech model; 500k-token decode meaningless",
        "vlm": "full self-attn + image cross-attn; card max 128k",
    }
    return False, reasons.get(cfg.family, "full attention")
