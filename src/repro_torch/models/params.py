"""Parameter specs and their initialization.

Port of ``repro.models.params`` for the shapes the port builds: a spec
tree (nested dicts of ``ParamSpec``) gives the parameter shapes and how
each leaf is initialized. Draws come from an explicit ``torch.Generator``
and are scaled like the reference (1/√fan_in, or 1.0 for an ``embed``
table); they are not the reference's numbers (``jax.random.normal`` goes
through erfinv), so tests pass weights across instead of redrawing them.
A generator on the card draws there: a 3.2 B-parameter model's 12.7 GB
of float32 never passes through host memory.

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

from repro_torch.common.tree import tree_leaves, tree_unflatten


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


def init_params(specs, generator: torch.Generator, batch_shape=(),
                device="cpu"):
    """Materialize a spec tree as float32 tensors of shape
    ``batch_shape + spec.shape``. Draws run on the generator's device (the
    host for a CPU generator) and then move to ``device``, so a CPU
    generator's seed gives the same weights on every device."""
    out = []
    for spec in tree_leaves(specs):
        shape = tuple(batch_shape) + tuple(spec.shape)
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
            arr = torch.randn(shape, generator=generator,
                              dtype=torch.float32, device=generator.device)
            arr = arr.mul_(std).to(device)
        out.append(arr)
    return tree_unflatten(specs, out)


def param_count(specs) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(specs))



def logical_axes(specs):
    """The spec tree's logical-axes tuples, in the same structure."""
    def axes(spec):
        if spec.axes is None:
            raise ValueError(
                f"a {spec.shape} spec has no logical axes: the port gives "
                f"them to the mlp family only (LM training is ROADMAP "
                f"Queue 1, item 14.1)")
        return spec.axes
    return tree_unflatten(specs, [axes(s) for s in tree_leaves(specs)])


def abstract_params(specs):
    """Storage-free float32 stand-ins (``meta`` tensors) of the leaves."""
    return tree_unflatten(specs, [
        torch.empty(s.shape, dtype=torch.float32, device="meta")
        for s in tree_leaves(specs)])
