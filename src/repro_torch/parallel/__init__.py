from .sharding import (
    ShardingPolicy,
    sharding_policy,
    current_policy,
    constrain,
    dp_axes,
    tp_axis,
    active_mesh,
    param_pspec,
    param_shardings,
    batch_pspec,
    cache_pspec,
    cache_shardings,
)

__all__ = [
    "ShardingPolicy",
    "sharding_policy",
    "current_policy",
    "constrain",
    "dp_axes",
    "tp_axis",
    "active_mesh",
    "param_pspec",
    "param_shardings",
    "batch_pspec",
    "cache_pspec",
    "cache_shardings",
]
