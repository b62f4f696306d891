"""Adam on parameter trees and on the flat slab view.

Port of ``repro.optim.adam``. ``adam_update`` works on nested dicts of
tensors; its ``step`` may carry leading batch axes (the (C, N) clients of
the simulator's per-client heads), each with its own bias correction.
``SlabAdamState`` keeps both moments of the PS update as one flat float32
slab (leaves butt-packed in ``jax.tree`` order), so the update is three
elementwise passes whatever the number of leaves, and the parameters are
sliced back into leaves once per step.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.common.tree import tree_leaves, tree_map, tree_unflatten


class AdamState(NamedTuple):
    step: torch.Tensor   # int32, scalar or batch-shaped
    mu: object           # first-moment tree
    nu: object           # second-moment tree


def adam_init(params, batch_shape=()) -> AdamState:
    like = tree_leaves(params)[0]
    return AdamState(
        step=torch.zeros(batch_shape, dtype=torch.int32, device=like.device),
        mu=tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                    params),
        nu=tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                    params))


def adam_update(grads, state: AdamState, params, lr, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8,
                weight_decay: float = 0.0):
    """One Adam step on trees (or on single tensors), with decoupled
    weight decay added to the step when ``weight_decay`` is set. Returns
    (new_params, new_state)."""
    step = state.step + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.full_like(t, b1), t)
    bc2 = 1.0 - torch.pow(torch.full_like(t, b2), t)

    def per_leaf(c, x):
        # broadcast a batch-shaped correction over a leaf's trailing axes
        return c.reshape(c.shape + (1,) * (x.dim() - c.dim()))

    def moment1(m, g):
        return b1 * m + (1.0 - b1) * g.to(torch.float32)

    def moment2(v, g):
        g32 = g.to(torch.float32)
        return b2 * v + (1.0 - b2) * g32 * g32

    mu = tree_map(moment1, state.mu, grads)
    nu = tree_map(moment2, state.nu, grads)

    def upd(p, m, v):
        mhat = m / per_leaf(bc1, m)
        vhat = v / per_leaf(bc2, v)
        delta = mhat / (torch.sqrt(vhat) + eps)
        if weight_decay:
            delta = delta + weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * delta).to(p.dtype)

    return tree_map(upd, params, mu, nu), AdamState(step=step, mu=mu, nu=nu)


class SlabAdamState(NamedTuple):
    step: torch.Tensor   # () int32
    mu: torch.Tensor     # (L,) f32, leaves in tree order
    nu: torch.Tensor     # (L,) f32


def tree_to_slab(tree) -> torch.Tensor:
    """One (L,) float32 slab of the tree's leaves in flatten order."""
    return torch.cat([l.reshape(-1).to(torch.float32)
                      for l in tree_leaves(tree)])


def slab_to_tree(slab: torch.Tensor, like):
    """Slice an (L,) slab back into ``like``'s leaf shapes and dtypes."""
    out, off = [], 0
    for l in tree_leaves(like):
        n = l.numel()
        out.append(slab[off:off + n].reshape(l.shape).to(l.dtype))
        off += n
    return tree_unflatten(like, out)


def slab_adam_init(params) -> SlabAdamState:
    leaves = tree_leaves(params)
    n = sum(l.numel() for l in leaves)
    dev = leaves[0].device
    return SlabAdamState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        mu=torch.zeros(n, dtype=torch.float32, device=dev),
        nu=torch.zeros(n, dtype=torch.float32, device=dev))


def slab_adam_update(grads, state: SlabAdamState, params, lr,
                     b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                     weight_decay: float = 0.0):
    """One Adam step on the slab view: ``grads``/``params`` are trees
    or flat (L,) slabs; the moments never leave the slab. Same math as
    ``adam_update``."""
    g_slab = grads if torch.is_tensor(grads) else tree_to_slab(grads)
    p_slab = params if torch.is_tensor(params) else tree_to_slab(params)
    new_p, inner = adam_update(g_slab, AdamState(state.step, state.mu,
                                                 state.nu),
                               p_slab, lr, b1, b2, eps, weight_decay)
    new_state = SlabAdamState(step=inner.step, mu=inner.mu, nu=inner.nu)
    if torch.is_tensor(params):
        return new_p, new_state
    return slab_to_tree(new_p, params), new_state
