"""Architecture configs (port of ``repro/configs/__init__.py``).

The same ids and aliases as the reference.  The port has the config
modules of the model zoo's six archs (:data:`PORTED_ARCH_IDS`); it serves
models of two of them (:data:`SERVED_ARCH_IDS`, see ``models/lm.py``), the
other four are read for their analytic layer counts only.  Each
``<id>.py`` exports ``CONFIG`` (the published hyper-parameters) and
``REDUCED`` (the reference's small variant for CPU tests).
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

#: The archs whose config module the port has.
PORTED_ARCH_IDS = ("mamba2_130m", "llama32_1b", "phi4_mini_3_8b", "olmoe_1b_7b",
                   "gemma_7b", "yi_9b")

#: The archs the port serves a model of (``LM`` raises for the others).
SERVED_ARCH_IDS = ("mamba2_130m", "llama32_1b")

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
    if name not in PORTED_ARCH_IDS:
        known = "an architecture of the reference" if name in ARCH_IDS else "unknown"
        raise NotImplementedError(
            f"arch {arch!r} ({known}) is not ported yet: the port registers "
            f"{PORTED_ARCH_IDS} (ROADMAP queue 1, item 7)"
        )
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.REDUCED if reduced else mod.CONFIG


def served_config(arch: str, reduced: bool = False) -> ModelConfig:
    """:func:`get_config` for an arch the port serves a model of; raises
    ``NotImplementedError`` for the others."""
    name = canonical(arch)
    if name not in SERVED_ARCH_IDS:
        raise NotImplementedError(
            f"arch {arch!r}: the port serves {SERVED_ARCH_IDS}; the other archs' "
            f"models are not ported yet (ROADMAP queue 1, item 7)"
        )
    return get_config(arch, reduced)
