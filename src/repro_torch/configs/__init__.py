"""Architecture configs (port of ``repro/configs/__init__.py``).

The same ids and aliases as the reference.  The port has the config
module of every arch of the reference (:data:`ARCH_IDS`) and serves a
model of each (``models/lm.py``).  Each
``<id>.py`` exports ``CONFIG`` (the published hyper-parameters) and
``REDUCED`` (the reference's small variant for CPU tests); the dense archs
with a long-context variant also export ``LONG_CONTEXT_VARIANT``
(``CONFIG`` with a sliding window of 8192), which ``LM`` and
``serve_batch`` take as they take ``CONFIG``.
"""

from __future__ import annotations

import importlib
from repro_torch.models.config import ModelConfig

ARCH_IDS = (
    "mamba2_130m",
    "jamba_v01_52b",
    "olmoe_1b_7b",
    "seamless_m4t_large_v2",
    "arctic_480b",
    "llama32_vision_11b",
    "phi4_mini_3_8b",
    "gemma_7b",
    "yi_9b",
    "llama32_1b",
)

_ALIASES = {
    "mamba2-130m": "mamba2_130m",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "arctic-480b": "arctic_480b",
    "llama-3.2-vision-11b": "llama32_vision_11b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "gemma-7b": "gemma_7b",
    "yi-9b": "yi_9b",
    "llama3.2-1b": "llama32_1b",
}


def canonical(arch: str) -> str:
    return _ALIASES.get(arch, arch.replace("-", "_").replace(".", "_"))


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    name = canonical(arch)
    if name not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch!r}; expected one of {ARCH_IDS} or an alias")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.REDUCED if reduced else mod.CONFIG


def served_config(arch: str, reduced: bool = False) -> ModelConfig:
    """:func:`get_config` for an arch the port serves a model of (every
    arch of the reference)."""
    return get_config(arch, reduced)
