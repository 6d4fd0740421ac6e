"""Model-derived workload profiles (port of ``repro/workloads/profiles.py``):
the layer-granular scheduling profiles of the ``model_zoo`` and
``fusion_sweep`` scenarios.

Each profile comes from an architecture config (``repro_torch.configs``)
through the reference's roofline model:

    t_compute = FLOPs / (MFU * peak_flops)     FLOPs = 2*P*T fwd, 4*P*T bwd
    t_memory  = bytes / HBM_bandwidth          (weight reads; small-batch floor)
    t_layer   = max(t_compute, t_memory)

with per-layer parameter counts from ``ModelConfig._layer_params``, layers
in backward-ready order (the tied embedding / LM head first, then the
decoder layers from the output backwards).  ``layer_grad_bytes`` and
``layer_t_b`` of the resulting :class:`ModelProfile` feed the WFBP fusion
planner (``netmodel.fusion_plan``).

The constants (:data:`PEAK_FLOPS_BF16`, :data:`HBM_BW`, :data:`MFU`,
:data:`TOKENS_PER_GPU`, :data:`ZOO_GPU_MEM_MB`) are the reference's,
unchanged: ``PEAK_FLOPS_BF16`` and ``HBM_BW`` are the TPU v5e per-chip
rates of the reference's workload model, not numbers about the H100 the
port runs on.  They define the simulated jobs, so they must equal the
reference's for the zoo cells to match (ROADMAP R3).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

from repro_torch.core.cluster import ModelProfile

# Hardware constants of the reference's roofline model: the TPU v5e values
# of its ``launch/mesh.py``, copied unchanged.  They define the zoo's
# compute times; they describe no card the port runs on, and re-deriving
# them for another device would make the zoo cells diverge from the
# reference's (ROADMAP R3).
PEAK_FLOPS_BF16 = 197e12  # [FLOP/s] per chip
HBM_BW = 819e9            # [B/s] per chip

#: Achieved fraction of peak FLOPs (MFU) assumed for the derived compute
#: times — trainings of this size on commodity clusters sit near 0.4.
MFU = 0.4
#: bf16 gradients: the all-reduced message is 2 B per parameter.
GRAD_BYTES_PER_PARAM = 2.0
#: Resident bytes per parameter for memory admission: bf16 weights (2) +
#: bf16 grads (2) + a ZeRO-1-sharded fp32 AdamW slice (~2 amortized).
RESIDENT_BYTES_PER_PARAM = 6.0
#: Reference per-GPU workload shape: 4 sequences x 2048 tokens.
TOKENS_PER_GPU = 4 * 2048

#: The architectures the ``model_zoo``/``fusion_sweep`` scenarios sample
#: from: the configs whose data-parallel gradient exchange is plausible on
#: the modeled fabric (the 52B/480B configs are left out — their hundreds
#: of GB per iteration are not a scheduling workload, they are a wall).
ZOO_ARCHS = (
    "mamba2_130m",
    "llama32_1b",
    "phi4_mini_3_8b",
    "olmoe_1b_7b",
    "gemma_7b",
    "yi_9b",
)

#: GPU memory of the zoo cluster [MB] (A100-80G class).
ZOO_GPU_MEM_MB = 81920.0


@dataclasses.dataclass(frozen=True)
class LayerProfile:
    """One layer's contribution to the WFBP schedule: gradient bytes plus
    roofline-derived forward/backward seconds (backward-ready order)."""

    name: str
    grad_bytes: float
    t_f: float
    t_b: float


def _roofline_time(flops: float, bytes_moved: float) -> float:
    """max(compute, memory) roofline seconds for one layer pass."""
    return max(flops / (MFU * PEAK_FLOPS_BF16), bytes_moved / HBM_BW)


def _layer_entry(
    name: str, params: float, tokens: int, active_params: float = 0.0
) -> LayerProfile:
    """Roofline terms of one layer: 2*P*T fwd / 4*P*T bwd FLOPs, weight
    reads (bf16) as the memory floor, bf16 gradient message.  For MoE
    layers ``active_params`` (routed experts only) drive the FLOPs while
    the gradient message and weight traffic cover every expert."""
    compute_p = active_params or params
    weight_bytes = GRAD_BYTES_PER_PARAM * params
    t_f = _roofline_time(2.0 * compute_p * tokens, weight_bytes)
    t_b = _roofline_time(4.0 * compute_p * tokens, 2.0 * weight_bytes)
    return LayerProfile(name, GRAD_BYTES_PER_PARAM * params, t_f, t_b)


def derive_layer_profiles(cfg, tokens: int = TOKENS_PER_GPU) -> Tuple[LayerProfile, ...]:
    """Per-layer WFBP profiles of a ``ModelConfig``, in backward-ready
    order: the tied embedding/LM-head gradient materializes first (output
    side), then decoder layers from the last to the first.  Parameter
    counts use the config's own analytic layer model (norms folded into
    each layer); encoder stacks (audio enc-dec) are appended after the
    decoder — their gradients are ready only once the decoder backward has
    propagated through the cross-attention."""
    d = cfg.d_model
    layers = [_layer_entry("embed", float(cfg.vocab_size * d), tokens)]
    for i in reversed(range(cfg.n_layers)):
        params = float(cfg._layer_params(i, False) + 2 * d)  # + the 2 norms
        active = float(cfg._layer_params(i, False, active_only=True) + 2 * d)
        layers.append(_layer_entry(f"layer{i}", params, tokens, active))
    if cfg.enc_layers:
        enc_params = float(cfg._enc_layer_params(False))
        layers.extend(
            _layer_entry(f"enc{i}", enc_params, tokens)
            for i in reversed(range(cfg.enc_layers))
        )
    return tuple(layers)


def model_profile_from_config(
    cfg, tokens: int = TOKENS_PER_GPU
) -> ModelProfile:
    """Collapse the layer profiles into a scheduling ``ModelProfile`` whose
    ``layer_grad_bytes``/``layer_t_b`` arrays carry the WFBP structure.
    Invariants (tested): ``sum(layer_grad_bytes) == size_bytes`` and
    ``sum(layer_t_b) == t_b`` — the monolithic reading of a derived
    profile is exactly its fused-all plan."""
    layers = derive_layer_profiles(cfg, tokens)
    size = sum(l.grad_bytes for l in layers)
    t_f = sum(l.t_f for l in layers)
    t_b = sum(l.t_b for l in layers)
    mem_mb = (size / GRAD_BYTES_PER_PARAM) * RESIDENT_BYTES_PER_PARAM / 1e6
    return ModelProfile(
        name=cfg.name,
        size_bytes=size,
        mem_mb=mem_mb,
        batch_size=tokens,
        t_f=t_f,
        t_b=t_b,
        layer_grad_bytes=tuple(l.grad_bytes for l in layers),
        layer_t_b=tuple(l.t_b for l in layers),
    )


@functools.lru_cache(maxsize=None)
def zoo_profiles(tokens: int = TOKENS_PER_GPU) -> Dict[str, ModelProfile]:
    """The config-derived model zoo, keyed by arch id (cached — config
    import and derivation are pure)."""
    from repro_torch.configs import get_config

    return {
        arch: model_profile_from_config(get_config(arch), tokens)
        for arch in ZOO_ARCHS
    }


__all__ = [
    "GRAD_BYTES_PER_PARAM",
    "LayerProfile",
    "MFU",
    "RESIDENT_BYTES_PER_PARAM",
    "TOKENS_PER_GPU",
    "ZOO_ARCHS",
    "ZOO_GPU_MEM_MB",
    "derive_layer_profiles",
    "model_profile_from_config",
    "zoo_profiles",
]
