"""Nested-dict parameter trees in ``jax.tree`` leaf order, a map over
whole states, and the leafwise arithmetic of ``repro.common.tree``.

The port keeps parameters, gradients and optimizer moments as nested
dicts of tensors. Leaf order matters: the leaf index and the packer
offsets key every channel stream, so it must equal ``jax.tree.flatten``,
which visits dict keys in sorted order (``final`` before ``trunk``,
``b`` before ``w``) and list elements in index order (the hybrid
model's cache holds a list of per-application KV dicts). Anything that
is neither a dict nor a list is a leaf: tuples too (shape tuples stand
for leaves in layout templates). No parameter tree holds a list, so the
leaf order that keys the channel streams is that of its dicts alone.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch


def tree_flatten_with_path(tree, prefix: Tuple[str, ...] = ()
                           ) -> List[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs in ``jax.tree.flatten`` order; a list element's
    path entry is its index."""
    if isinstance(tree, list):
        items = enumerate(tree)
    elif isinstance(tree, dict):
        items = ((k, tree[k]) for k in sorted(tree))
    else:
        return [(prefix, tree)]
    out = []
    for k, sub in items:
        out.extend(tree_flatten_with_path(sub, prefix + (k,)))
    return out


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` in flatten order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, list):
            return [build(n) for n in node]
        if not isinstance(node, dict):
            return next(it)
        return {k: build(node[k]) for k in sorted(node)}
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has slots")
    return out


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over trees of one structure."""
    if isinstance(tree, list):
        return [tree_map(fn, *nodes)
                for nodes in zip(tree, *rest, strict=True)]
    if not isinstance(tree, dict):
        return fn(tree, *rest)
    return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
            for k in sorted(tree)}


def state_map(fn: Callable, state, *rest):
    """Apply ``fn`` leafwise over states of one structure: dicts, lists,
    named tuples (``SimState`` and its optimizer states) and tensors; a None
    field (an absent fault copy) stays None."""
    if state is None:
        return None
    if isinstance(state, dict):
        return {k: state_map(fn, state[k], *(r[k] for r in rest))
                for k in state}
    if isinstance(state, list):
        return [state_map(fn, *items) for items in zip(state, *rest)]
    if isinstance(state, tuple):
        out = [state_map(fn, *fields) for fields in zip(state, *rest)]
        return type(state)(*out) if hasattr(state, "_fields") else tuple(out)
    return fn(state, *rest)


def tree_global_norm(tree):
    """‖tree‖₂ over every leaf, in float32."""
    return torch.sqrt(torch.sum(torch.stack(
        [torch.sum(torch.square(l.to(torch.float32)))
         for l in tree_leaves(tree)])))


def tree_size(tree) -> int:
    """Total number of elements in a tree of tensors."""
    return sum(l.numel() for l in tree_leaves(tree))


def tree_bytes(tree) -> int:
    return sum(l.numel() * l.element_size() for l in tree_leaves(tree))


def tree_zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def tree_cast(tree, dtype):
    """Cast floating-point leaves to ``dtype``; leave integer leaves alone."""
    return tree_map(lambda x: x.to(dtype) if torch.is_floating_point(x)
                    else x, tree)


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_scale(tree, s):
    return tree_map(lambda x: x * s, tree)


def tree_axpy(alpha, x, y):
    """alpha * x + y, leafwise."""
    return tree_map(lambda xi, yi: alpha * xi + yi, x, y)
