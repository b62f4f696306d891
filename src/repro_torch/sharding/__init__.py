"""Rank meshes and collectives (port of ``repro.sharding``; its XLA
sharding rules and ``fl_view`` belong to the XLA tooling, ROADMAP Queue
1, item 16)."""
from repro_torch.sharding.mesh_utils import data_axes_of, flat_client_axes

__all__ = ["flat_client_axes", "data_axes_of"]
