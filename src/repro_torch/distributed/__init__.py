from .sharding import (
    MULTI_POD_RULES,
    SINGLE_POD_RULES,
    AxisRules,
    NamedSharding,
    P,
    current_rules,
    placements,
    resolve_spec,
    resolve_spec_tree,
    set_rules,
    shard,
    shard_if_divisible,
    spec,
    use_rules,
)

__all__ = [
    "MULTI_POD_RULES", "SINGLE_POD_RULES", "AxisRules", "NamedSharding",
    "P", "current_rules", "placements", "resolve_spec",
    "resolve_spec_tree", "set_rules", "shard", "shard_if_divisible",
    "spec", "use_rules",
]
