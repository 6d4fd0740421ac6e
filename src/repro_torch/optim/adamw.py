"""AdamW with decoupled weight decay, gradient clipping and schedules
(port of ``repro/optim/adamw.py``).

Plain functions over nested dicts of tensors, in the reference's order of
operations: clip by the global norm, moments in ``moment_dtype``, bias
correction, the update in float32, cast back to each leaf's dtype.
``torch.optim.AdamW`` places ``eps`` and the decay otherwise and is not
used.  :func:`adamw_update` writes the new parameters and moments into the
tensors it is given (the reference's jitted step donates them), so a
parameter stays the same leaf tensor from step to step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Union

import torch
import torch.profiler

from repro_torch.models.common import tree_leaves, tree_map


#: the profiler range around one update
UPDATE_RANGE = "adamw_update"


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: torch.dtype = torch.float32


def adamw_init(params, cfg: AdamWConfig):
    """Zero moments in ``cfg.moment_dtype`` beside each leaf, and the int32
    step."""
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)  # noqa: E731
    device = next(tree_leaves(params))[1].device
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def abstract_opt_state(abstract_params, cfg: AdamWConfig):
    """The optimizer state's shapes and dtypes as meta tensors (no memory)."""
    meta = lambda p: torch.empty(p.shape, dtype=cfg.moment_dtype, device="meta")  # noqa: E731
    return {
        "m": tree_map(meta, abstract_params),
        "v": tree_map(meta, abstract_params),
        "step": torch.empty((), dtype=torch.int32, device="meta"),
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (flatten order) of each leaf's float32
    sum of squares."""
    total = 0
    for _, g in tree_leaves(tree):
        total = total + torch.sum(torch.square(g.to(torch.float32)))
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig,
                 lr: Optional[Union[torch.Tensor, float]] = None):
    """One AdamW step.  Returns ``(params, state, {"grad_norm"})`` with the
    new values written into ``params`` and ``state``'s tensors."""
    with torch.profiler.record_function(UPDATE_RANGE):  # for a profile's attribution
        return _update(params, grads, state, cfg, lr)


def _update(params, grads, state, cfg: AdamWConfig, lr):
    step = state["step"] + 1
    gnorm = global_norm(grads)
    # a tensor numerator: torch divides a Python number by a tensor through
    # the reciprocal, which rounds differently
    scale = torch.clamp(torch.full_like(gnorm, cfg.grad_clip) / (gnorm + 1e-9), max=1.0)
    lr_t = cfg.lr if lr is None else lr
    b1, b2 = cfg.b1, cfg.b2
    step_f = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.full_like(step_f, b1), step_f)
    bc2 = 1.0 - torch.pow(torch.full_like(step_f, b2), step_f)

    flat_m = dict(tree_leaves(state["m"]))
    flat_v = dict(tree_leaves(state["v"]))
    flat_g = dict(tree_leaves(grads))
    for key, p in tree_leaves(params):
        g, m, v = flat_g[key], flat_m[key], flat_v[key]
        g32 = g.to(torch.float32) * scale
        m32 = m.to(torch.float32) * b1 + (1 - b1) * g32
        v32 = v.to(torch.float32) * b2 + (1 - b2) * torch.square(g32)
        mh = m32 / bc1
        vh = v32 / bc2
        p32 = p.to(torch.float32)
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p32
        p.copy_((p32 - lr_t * delta).to(p.dtype))
        m.copy_(m32.to(m.dtype))
        v.copy_(v32.to(v.dtype))
    state["step"].copy_(step)
    return params, state, {"grad_norm": gnorm}


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    min_ratio: float = 0.1) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warm-up to ``peak_lr``, then a cosine down to
    ``min_ratio * peak_lr`` at ``total_steps``; float32."""

    def schedule(step: torch.Tensor) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * torch.clamp(step / max(warmup_steps, 1), max=1.0)
        t = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup_steps, warm, peak_lr * cos)

    return schedule
