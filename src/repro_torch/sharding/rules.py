"""Logical-axis -> mesh-axis sharding rules (port of
``repro.sharding.rules``).

Every parameter and activation carries a tuple of *logical* axis names
(e.g. ``("layer", "embed", "mlp")``). A ``ShardingRules`` maps each
logical name to an ordered list of candidate mesh axes. ``spec_for``
enforces the reference's two constraints:

* divisibility: a dim is split only if its size is divisible by the
  product of the mesh axes given to it;
* exclusivity: a mesh axis appears at most once per tensor; a later
  logical axis falls back to its next candidate (or stays whole).

The result is a layout tuple of ``mesh_utils`` (one entry per dim: None,
an axis name, or a tuple of names split jointly, major to minor), the
entries of the reference's ``PartitionSpec``. A layout tuple is the
port's sharding of a leaf on the mesh the caller holds, so
``tree_shardings`` gives the same tree as ``tree_specs``. Candidates and
their order, the fallback and the rule sets are the reference's, so one
model zoo lays out over meshes of shape (16, 16), (2, 16, 16) and the FL
view (pod, cluster, client, model) without per-model rules.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.common.tree import tree_map
from repro_torch.sharding.mesh_utils import Mesh

# A candidate is a tuple of mesh axis names splitting one dim jointly,
# e.g. ("data",) or ("cluster", "client").
Candidate = Tuple[str, ...]


@dataclass(frozen=True)
class ShardingRules:
    rules: Dict[str, Tuple[Candidate, ...]] = field(default_factory=dict)

    def candidates(self, logical: Optional[str]) -> Tuple[Candidate, ...]:
        if logical is None:
            return ()
        return self.rules.get(logical, ())


def _translate(cand: Candidate, sizes: Dict[str, int]) -> Optional[Candidate]:
    """The generic 'data' axis as the data-like axes the mesh has (the FL
    view's ("cluster", "client")); None if an axis is missing."""
    out = []
    for ax in cand:
        if ax in sizes:
            out.append(ax)
        elif ax == "data" and "cluster" in sizes and "client" in sizes:
            out.extend(["cluster", "client"])
        else:
            return None
    return tuple(out)


def spec_for(logical_axes: Sequence[Optional[str]], rules: ShardingRules,
             shape: Sequence[int], mesh: Mesh) -> tuple:
    """The layout tuple of one tensor."""
    if len(logical_axes) != len(shape):
        raise ValueError(f"axes {tuple(logical_axes)} do not match shape "
                         f"{tuple(shape)}")
    sizes = mesh.shape
    used: set = set()
    spec = []
    for dim, name in zip(shape, logical_axes):
        chosen = None
        for cand in rules.candidates(name):
            cand = _translate(cand, sizes)
            if cand is None or any(a in used for a in cand):
                continue
            prod = math.prod(sizes[a] for a in cand)
            if prod == 0 or dim % prod:
                continue
            chosen = cand
            break
        if chosen is None:
            spec.append(None)
        else:
            used.update(chosen)
            spec.append(chosen if len(chosen) > 1 else chosen[0])
    return tuple(spec)


def tree_specs(axes_tree, shapes_tree, rules: ShardingRules, mesh: Mesh):
    """``spec_for`` over parallel trees of logical-axes and shape tuples."""
    return tree_map(lambda axes, shape: spec_for(axes, rules, shape, mesh),
                    axes_tree, shapes_tree)


def tree_shardings(axes_tree, shapes_tree, rules: ShardingRules,
                   mesh: Mesh):
    """The leaves' shardings on ``mesh``: their layout tuples (see the
    module docstring)."""
    return tree_specs(axes_tree, shapes_tree, rules, mesh)


def _mk(rules: Dict[str, Sequence[Sequence[str]]]) -> ShardingRules:
    return ShardingRules({k: tuple(tuple(c) for c in v)
                          for k, v in rules.items()})


# --- canonical rule sets ---------------------------------------------------

# Training: FSDP over the data axis on the embed dim, tensor parallel on
# mlp/heads/vocab/expert dims. The "pod" axis replicates parameters (clusters
# never span pods; see DESIGN.md §3.2) and shards the batch.
TRAIN_RULES = _mk({
    "batch":    [("pod", "data"), ("data",), ("pod",)],
    "seq":      [],
    "embed":    [("data",)],
    "embed2":   [],             # second embed-sized dim (out-proj rows)
    "vocab":    [("model",)],
    "mlp":      [("model",)],
    "heads":    [("model",)],
    "kv_heads": [("model",)],
    "expert":   [("model",), ("data",)],
    "clients":  [("pod", "data"), ("data",)],   # per-client heads
    "qkv":      [("model",)],
    "state":    [],
    "head_dim": [],
    "layer":    [],
    "conv":     [],
    "cache_seq": [],
})

# Serving (prefill/decode): weights stay FSDP+TP sharded; batch over
# (pod, data). The KV cache shards its *sequence* dim over "model" (kv-head
# counts of 2-8 never divide a 16-way model axis; sequence always does).
SERVE_RULES = _mk({
    "batch":    [("pod", "data"), ("data",), ("pod",)],
    "seq":      [],
    "embed":    [("data",)],
    "embed2":   [],
    "vocab":    [("model",)],
    "mlp":      [("model",)],
    "heads":    [("model",)],
    "kv_heads": [],
    "expert":   [("model",), ("data",)],
    "clients":  [("pod", "data"), ("data",)],
    "qkv":      [("model",)],
    "state":    [],
    "head_dim": [],
    "layer":    [],
    "conv":     [],
    "cache_seq": [("model",)],
})

# Long-context serving (batch=1): batch is unshardable, so the KV cache
# sequence dim takes the model axis; kv heads often indivisible anyway.
LONGCTX_SERVE_RULES = _mk({
    "batch":    [],
    "seq":      [("data",)],
    "embed":    [("data",)],
    "embed2":   [],
    "vocab":    [("model",)],
    "mlp":      [("model",)],
    "heads":    [("model",)],
    "kv_heads": [],
    "expert":   [("model",), ("data",)],
    "clients":  [],
    "qkv":      [("model",)],
    "state":    [],
    "head_dim": [],
    "layer":    [],
    "conv":     [],
    "cache_seq": [("model",)],
})
