"""Optimizer of the port (port of ``repro.optim``)."""

from repro_torch.optim.adamw import (
    AdamWConfig,
    abstract_opt_state,
    adamw_init,
    adamw_update,
    cosine_schedule,
    global_norm,
)

__all__ = [
    "AdamWConfig",
    "abstract_opt_state",
    "adamw_init",
    "adamw_update",
    "cosine_schedule",
    "global_norm",
]
