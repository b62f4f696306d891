"""Nested-dict parameter trees in ``jax.tree`` leaf order, and a map over
whole states.

The port keeps parameters, gradients and optimizer moments as nested
dicts of tensors. Leaf order matters: the leaf index and the packer
offsets key every channel stream, so it must equal ``jax.tree.flatten``,
which visits dict keys in sorted order (``final`` before ``trunk``,
``b`` before ``w``). Anything that is not a dict is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch


def tree_flatten_with_path(tree, prefix: Tuple[str, ...] = ()
                           ) -> List[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs in ``jax.tree.flatten`` order."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out.extend(tree_flatten_with_path(tree[k], prefix + (k,)))
    return out


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` in flatten order."""
    it = iter(leaves)

    def build(node):
        if not isinstance(node, dict):
            return next(it)
        return {k: build(node[k]) for k in sorted(node)}
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has slots")
    return out


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over trees of one structure."""
    if not isinstance(tree, dict):
        return fn(tree, *rest)
    return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
            for k in sorted(tree)}


def state_map(fn: Callable, state, *rest):
    """Apply ``fn`` leafwise over states of one structure: dicts, named
    tuples (``SimState`` and its optimizer states) and tensors; a None
    field (an absent fault copy) stays None."""
    if state is None:
        return None
    if isinstance(state, dict):
        return {k: state_map(fn, state[k], *(r[k] for r in rest))
                for k in state}
    if isinstance(state, tuple):
        out = [state_map(fn, *fields) for fields in zip(state, *rest)]
        return type(state)(*out) if hasattr(state, "_fields") else tuple(out)
    return fn(state, *rest)


def tree_global_norm(tree):
    """‖tree‖₂ over every leaf, in float32."""
    return torch.sqrt(torch.sum(torch.stack(
        [torch.sum(torch.square(l.to(torch.float32)))
         for l in tree_leaves(tree)])))
