"""Sharding rules (port of ``repro/sharding``): logical axes to mesh axes,
and their DTensor placements."""

from repro_torch.sharding.rules import (
    ShardingStrategy,
    batch_spec_axes,
    cache_shardings,
    embeds_sharding,
    moment_shardings,
    param_shardings,
    place_cache,
    replicated,
    spec_for_param,
    token_sharding,
)

__all__ = [
    "ShardingStrategy",
    "batch_spec_axes",
    "cache_shardings",
    "embeds_sharding",
    "moment_shardings",
    "param_shardings",
    "place_cache",
    "replicated",
    "spec_for_param",
    "token_sharding",
]
