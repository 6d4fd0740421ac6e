"""Model-derived workload profiles (port of ``repro.workloads``): the
architecture configs of ``repro_torch.configs`` as layer-granular
scheduling profiles (per-layer gradient bytes and roofline compute times)
for the WFBP bucket stream; see ``profiles.py``.
"""

from repro_torch.workloads.profiles import (
    GRAD_BYTES_PER_PARAM,
    LayerProfile,
    MFU,
    RESIDENT_BYTES_PER_PARAM,
    TOKENS_PER_GPU,
    ZOO_ARCHS,
    ZOO_GPU_MEM_MB,
    derive_layer_profiles,
    model_profile_from_config,
    zoo_profiles,
)

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
