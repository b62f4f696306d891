"""Global-norm gradient clipping (port of ``repro.optim.clip``)."""
from __future__ import annotations

import torch

from repro_torch.common.tree import tree_global_norm, tree_map


def clip_by_global_norm(grads, max_norm: float):
    """Scale the tree so its global norm is at most ``max_norm``; returns
    (clipped tree, the norm before clipping)."""
    norm = tree_global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm
