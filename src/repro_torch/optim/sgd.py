"""Plain SGD on parameter trees (port of ``repro.optim.sgd``)."""
from __future__ import annotations

from repro_torch.common.tree import tree_map


def sgd_update(grads, params, lr):
    """p − lr·g leaf by leaf, in each parameter's dtype."""
    return tree_map(lambda p, g: (p - lr * g.to(p.dtype)).to(p.dtype),
                    params, grads)
