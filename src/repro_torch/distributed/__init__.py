"""The port's distribution layer: logical-axis rules and their DTensor
placements (`repro.distributed`)."""

from repro_torch.distributed.sharding import (
    DEFAULT_RULES,
    NamedSharding,
    ShardingRules,
    activation_rules,
    constrain,
    input_shardings,
    logical_to_spec,
    params_shardings,
    prune_for_mesh,
)

__all__ = [
    "ShardingRules",
    "DEFAULT_RULES",
    "NamedSharding",
    "constrain",
    "activation_rules",
    "logical_to_spec",
    "params_shardings",
    "input_shardings",
    "prune_for_mesh",
]
