"""Feed-forward layers: the gated MLPs (SwiGLU / GeGLU) and the plain GELU
MLP (port of ``repro/models/ffn.py``, dense part).  The Mixture-of-Experts
layer waits for the MoE slice (ROADMAP queue 1, item 8).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamSpec
from repro_torch.models.config import ModelConfig


def mlp_schema(cfg: ModelConfig, d_ff: int) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    if cfg.act in ("swiglu", "geglu"):
        return {
            "w_gate": ParamSpec((d, d_ff), ("embed", "ffn")),
            "w_up": ParamSpec((d, d_ff), ("embed", "ffn")),
            "w_down": ParamSpec((d_ff, d), ("ffn", "embed"), scale=0.5),
        }
    return {
        "w_up": ParamSpec((d, d_ff), ("embed", "ffn")),
        "w_down": ParamSpec((d_ff, d), ("ffn", "embed"), scale=0.5),
    }


def _act(h: torch.Tensor, kind: str) -> torch.Tensor:
    """``jax.nn.silu`` (``x * sigmoid(x)``) for swiglu; ``jax.nn.gelu``
    (tanh approximation, its default) otherwise."""
    if kind == "swiglu":
        return h * torch.sigmoid(h)
    return F.gelu(h, approximate="tanh")


def mlp(x: torch.Tensor, params: Dict[str, torch.Tensor], act: str) -> torch.Tensor:
    if "w_gate" in params:
        h = _act(x @ params["w_gate"], act) * (x @ params["w_up"])
    else:
        h = _act(x @ params["w_up"], act)
    return h @ params["w_down"]
