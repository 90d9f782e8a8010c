"""Sharding rules and helpers (logical axes -> spec -> DTensor placements)."""

from repro_torch.shard.api import (BASE_RULES, NamedSharding, activation_ctx,
                                   axis_sizes, constrain, make_rules,
                                   mesh_axis_size, placements_for, pspec_for,
                                   sharding_for)

__all__ = ["BASE_RULES", "make_rules", "pspec_for", "sharding_for",
           "activation_ctx", "constrain", "mesh_axis_size", "axis_sizes",
           "placements_for", "NamedSharding"]
