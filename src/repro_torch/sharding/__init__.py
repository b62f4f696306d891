"""Rank meshes, sharding rules and collectives (port of
``repro.sharding``)."""
from repro_torch.sharding.rules import (
    LONGCTX_SERVE_RULES,
    SERVE_RULES,
    TRAIN_RULES,
    ShardingRules,
    spec_for,
    tree_shardings,
    tree_specs,
)
from repro_torch.sharding.mesh_utils import (
    data_axes_of, fl_view, flat_client_axes,
)

__all__ = [
    "ShardingRules", "TRAIN_RULES", "SERVE_RULES", "LONGCTX_SERVE_RULES",
    "spec_for", "tree_specs", "tree_shardings", "fl_view",
    "flat_client_axes", "data_axes_of",
]
