"""Parameter specs and their initialization.

Port of ``repro.models.params`` for the shapes the port builds: a spec
tree (nested dicts of ``ParamSpec``) gives the parameter shapes and how
each leaf is initialized. ``init_params(specs, key)`` follows the
reference's key schedule: one ``rng.split`` of the key per leaf (in
``jax.tree`` order), and a normal leaf is ``rng.normal`` of its key
scaled like the reference (1/√fan_in, or 1.0 for an ``embed`` table), so
a seeded run starts from the reference's weights (within 5.7e-6
relative: ``erfinv`` differs from XLA's in the last place; zeros and ones
are exact). On the card the words are drawn there by the stream kernel
(``kernels.ota_channel.ops.bits``): a 3.2 B-parameter model's 12.7 GB of
float32 never passes through host memory.

A spec may carry the leaf's logical axes (``axes``, keyword-only): the
distributed step shards a leaf over the FL data axes along its ``embed``
dim (``logical_axes``), and ``abstract_params`` gives storage-free
stand-ins of the leaf shapes for the slab layout.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch

from repro_torch import rng
from repro_torch.common.tree import tree_leaves, tree_unflatten
from repro_torch.kernels.ota_channel.ops import MAX_DRAW_KEYS, bits

# entries of a normal leaf turned from words into floats at a time (the
# float64 fused multiply-add of ``rng.uniform`` needs 48 bytes per entry)
_NORMAL_SLICE = 1 << 26


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    init: str = "normal"           # normal | zeros | ones | embed
    scale: Optional[float] = None  # stddev override; default 1/√fan_in
    axes: Optional[Tuple[Optional[str], ...]] = field(default=None,
                                                      kw_only=True)

    def __post_init__(self):
        if self.axes is not None and len(self.axes) != len(self.shape):
            raise ValueError(f"axes {self.axes} do not match shape "
                             f"{self.shape}")


def _fan_in(shape: Tuple[int, ...]) -> int:
    if len(shape) == 1:
        return shape[0]
    # last dim is fan-out by convention; everything else fan-in
    return math.prod(shape[:-1])


def _normal(key, shape, device) -> torch.Tensor:
    """``rng.normal(key, shape)`` for each key of a (..., 2) table, its
    words drawn on ``device`` (the card's stream kernel there). The keys
    are drawn a slice of rows at a time (at most ``MAX_DRAW_KEYS``, one
    launch's, and no more than fit ``_NORMAL_SLICE`` entries, but always
    one) and the words turned into floats a slice at a time. A table of
    many small leaves (a population bank's heads: one key per client)
    thus keeps the transient word buffer near ``_NORMAL_SLICE`` entries;
    one key's words are drawn whole, so a leaf of n entries holds n words
    (4n bytes) beside its n floats while it is drawn: 12.9 GB for one
    stacked expert leaf of Mixtral-8x22B cut to 4 layers (4 x 8 x 6144 x
    16384 entries). Each key's words depend on that key alone, so the
    values are those of one draw."""
    n = math.prod(shape)
    batch = tuple(key.shape[:-1])
    keys = key.reshape(-1, 2)
    out = torch.empty((keys.shape[0], n), dtype=torch.float32,
                      device=device)
    rows = min(max(1, _NORMAL_SLICE // max(n, 1)), MAX_DRAW_KEYS)
    for r in range(0, keys.shape[0], rows):
        flat_w = bits(keys[r:r + rows], n, device=device).reshape(-1)
        flat_o = out[r:r + rows].reshape(-1)
        for a in range(0, flat_w.numel(), _NORMAL_SLICE):
            sl = slice(a, a + _NORMAL_SLICE)
            flat_o[sl] = rng.normal_from_words(flat_w[sl])
        del flat_w
    return out.reshape(batch + tuple(shape))


def init_params(specs, key, device="cpu"):
    """Materialize a spec tree as float32 tensors, as the reference's
    ``init_params(specs, key)``: ``rng.split(key, L)`` gives one key per
    leaf. ``key`` may be a (..., 2) table: each leaf is then
    ``key.shape[:-1] + spec.shape``, one draw per key (the reference's
    vmap over per-client keys)."""
    key = rng.as_key(key)
    batch = tuple(key.shape[:-1])
    leaves = tree_leaves(specs)
    keys = rng.split(key, max(len(leaves), 1))          # (..., L, 2)
    out = []
    for i, spec in enumerate(leaves):
        shape = batch + tuple(spec.shape)
        if spec.init == "zeros":
            arr = torch.zeros(shape, dtype=torch.float32, device=device)
        elif spec.init == "ones":
            arr = torch.ones(shape, dtype=torch.float32, device=device)
        else:
            if spec.scale is not None:
                std = spec.scale
            elif spec.init == "embed":
                std = 1.0
            else:
                std = 1.0 / math.sqrt(max(_fan_in(spec.shape), 1))
            arr = _normal(keys[..., i, :], spec.shape, device).mul_(std)
        out.append(arr)
    return tree_unflatten(specs, out)


def param_count(specs) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(specs))


def spec_shapes(specs):
    """The spec tree's shape tuples, in the same structure."""
    return tree_unflatten(specs, [tuple(s.shape) for s in tree_leaves(specs)])


def logical_axes(specs):
    """The spec tree's logical-axes tuples, in the same structure."""
    def axes(spec):
        if spec.axes is None:
            raise ValueError(
                f"a {spec.shape} spec has no logical axes: the "
                f"distributed step needs each leaf's axes to lay it out")
        return spec.axes
    return tree_unflatten(specs, [axes(s) for s in tree_leaves(specs)])


def abstract_params(specs, dtype=torch.float32):
    """Storage-free stand-ins (``meta`` tensors) of the leaves, float32
    unless ``dtype`` says otherwise."""
    return tree_unflatten(specs, [
        torch.empty(s.shape, dtype=dtype, device="meta")
        for s in tree_leaves(specs)])
