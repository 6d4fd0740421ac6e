"""Roofline terms of a dry-run step (port of ``repro/launch/roofline.py``;
side-effect free).

    compute    = FLOPs      / (chips x 989 TFLOP/s bf16)
    memory     = bytes      / (chips x 3.35 TB/s HBM)
    collective = model-axis bytes / (chips x 450 GB/s NVLink)
               + other bytes      / (chips x 50 GB/s network)

The numerators come from the dry-run's trace (``launch/hlo.py``): counted
per rank, then x chips, the reference's "per device, then global"
arithmetic.  The constants are the H100's (``launch/mesh.py``); the model
axis of the production mesh lies inside one NVLink domain, so its bytes
are priced at NVLink's rate and every other axis's at the NIC's.
``model_flops`` (6 N_active D and its kin) is a copy of the reference's
arithmetic; it gives the useful-compute ratio that exposes recompute and
dispatch waste.  ``run_flops`` is the part of it that the port's step
runs (a prefill projects only each sequence's last token onto the
vocab), and ``run_useful_ratio`` its ratio to the counted FLOPs: at most
1 unless the count misses work.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict, Optional

from repro_torch.configs import canonical, get_config
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.specs import supports_shape
from repro_torch.models.config import InputShape, ModelConfig


def config_for_shape(arch: str, shape: InputShape) -> Optional[ModelConfig]:
    """The config, switched to its sliding-window variant for dense archs
    at long_500k.  None when the combo is skipped."""
    cfg = get_config(arch)
    ok, _ = supports_shape(cfg, shape)
    if not ok:
        return None
    if shape.name == "long_500k" and cfg.family == "dense":
        mod = importlib.import_module(f"repro_torch.configs.{canonical(arch)}")
        cfg = mod.LONG_CONTEXT_VARIANT
    return cfg


def model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """Useful FLOPs per step: 6 N_active tokens (train), 2 N_active tokens
    (prefill), 2 N_active batch (decode, one token per sequence).

    Token counts are per stack: the audio encoder sees ``audio_frames``
    tokens (not the decoder's seq_len); the VLM's cross-attention
    parameters fire once per decoder token and count with the decoder."""
    n_active = cfg.active_param_count()
    mult = {"train": 6.0, "prefill": 2.0}.get(shape.kind)
    dec_tokens = shape.tokens if mult else shape.global_batch
    mult = mult or 2.0
    if cfg.family != "audio":
        return mult * n_active * dec_tokens
    enc_params = cfg.enc_layers * cfg._enc_layer_params(False)
    dec_params = n_active - enc_params
    if shape.kind == "decode":
        return mult * dec_params * dec_tokens  # encoder output is cached
    enc_tokens = cfg.audio_frames * shape.global_batch
    enc_mult = 6.0 if shape.kind == "train" else 2.0
    return mult * dec_params * dec_tokens + enc_mult * enc_params * enc_tokens


def run_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """:func:`model_flops` less what the step does not run: ``model_flops``
    counts the vocab projection (2 vocab d FLOPs a token) for every prompt
    token of a prefill, whose step projects only the last token of each
    sequence."""
    mf = model_flops(cfg, shape)
    if shape.kind != "prefill":
        return mf
    return mf - 2.0 * cfg.vocab_size * cfg.d_model * (shape.seq_len - 1) * shape.global_batch


def roofline_terms(cfg, shape, chips: int, res: Dict[str, Any]) -> Dict[str, Any]:
    """The reference's keys from a dry-run result ``res`` (its
    ``cost_corrected``, per rank, and ``memory``), and ``run_flops`` and
    ``run_useful_ratio``.  ``collective_model``,
    the bytes on the "model" axis, is priced at NVLink's rate; where ``res``
    has none (a reference result), every byte is priced at the network's."""
    cc = res["cost_corrected"]
    # the trace counts per rank: global = per rank x chips
    flops_global = cc["flops"] * chips
    bytes_global = cc["bytes_accessed"] * chips
    coll_model = cc.get("collective_model", 0.0) * chips
    coll_other = (cc["collective_total"] - cc.get("collective_model", 0.0)) * chips
    t_compute = flops_global / (chips * mesh_mod.PEAK_FLOPS_BF16)
    t_memory = bytes_global / (chips * mesh_mod.HBM_BW)
    t_collective = (coll_model / (chips * mesh_mod.NVLINK_BW)
                    + coll_other / (chips * mesh_mod.NET_BW))
    terms = {"compute_s": t_compute, "memory_s": t_memory, "collective_s": t_collective}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    rf = run_flops(cfg, shape)
    return {
        **terms,
        "dominant": dominant.replace("_s", ""),
        "model_flops": mf,
        "hlo_flops_global": flops_global,
        "useful_flops_ratio": mf / flops_global if flops_global else 0.0,
        "hbm_peak_frac": res["memory"]["peak_bytes"] / mesh_mod.HBM_BYTES,
        "chips": chips,
        "run_flops": rf,
        "run_useful_ratio": rf / flops_global if flops_global else 0.0,
    }
