"""Serve steps (prefill and greedy decode), the stub frontends' abstract
inputs, and the layouts and abstract state of the dry run.

Port of ``repro.launch.steps``. The prefill step returns the last
position's logits, so it applies the final norm and head to that
position only: the same numbers without a (B, S, vocab) float32 logits
tensor. Its input is token ids (B, S), or for the vision stub frontend
projected patch embeddings (B, S, d_model). ``param_specs_tree`` and
``cache_specs_tree`` lay the weights and the cache out on a mesh by a
rule set (``sharding.rules``; layout tuples for the reference's
``PartitionSpec``s), ``abstract_serve_state`` gives storage-free
(``meta``) weights and cache, and ``serve_rules_for`` picks the rules of
an input shape.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.common.config import InputShape, ModelConfig
from repro_torch.common.spans import span
from repro_torch.common.tree import tree_map
from repro_torch.models.model import Model
from repro_torch.models.params import (
    abstract_params, logical_axes, spec_shapes,
)
from repro_torch.sharding.mesh_utils import Mesh
from repro_torch.sharding.rules import (
    LONGCTX_SERVE_RULES, SERVE_RULES, ShardingRules, spec_for, tree_specs,
)


def input_specs(cfg: ModelConfig,
                shape: InputShape) -> Dict[str, torch.Tensor]:
    """Storage-free stand-ins (``meta`` tensors) of every input for one
    (arch, input shape) pair, as the reference's ``ShapeDtypeStruct``s.
    The audio and vision frontends are stubbed: audio takes EnCodec token
    ids, vision (B, S, d_model) bfloat16 patch embeddings in training and
    prefill; decode takes one token (B, 1) at positions (B,)."""
    b, s = shape.global_batch, shape.seq_len

    def spec(size, dtype=torch.int32):
        return torch.empty(size, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        if cfg.modality == "vision":
            tokens = spec((b, s, cfg.d_model), torch.bfloat16)
        else:
            tokens = spec((b, s))
        if shape.kind == "prefill":
            return {"tokens": tokens}
        return {"tokens": tokens, "labels": spec((b, s))}
    return {"tokens": spec((b, 1)), "positions": spec((b,))}


def param_specs_tree(model: Model, rules: ShardingRules, mesh: Mesh,
                     include_head: bool = True, n_out=None):
    """Layout tuples of the backbone ({"trunk", "final"}) and, with
    ``include_head``, of the head: {"backbone": ..., "head": ...}."""
    def lay(specs):
        return tree_specs(logical_axes(specs), spec_shapes(specs), rules,
                          mesh)
    specs = {"trunk": lay(model.trunk_specs()),
             "final": lay(model.final_specs())}
    if include_head:
        specs = {"backbone": specs, "head": lay(model.head_specs(n_out))}
    return specs


def cache_specs_tree(model: Model, cache_abs, rules: ShardingRules,
                     mesh: Mesh):
    """Layout tuples of a cache tree from the model's ``cache_axes()``."""
    def one(axes, leaf):
        if len(axes) != leaf.dim():
            raise ValueError(f"cache axes {axes} do not match a leaf of "
                             f"{tuple(leaf.shape)}")
        return spec_for(axes, rules, tuple(leaf.shape), mesh)
    return tree_map(one, model.cache_axes(), cache_abs)


def abstract_serve_state(model: Model, shape: InputShape,
                         dtype=torch.bfloat16):
    """(backbone, head, cache) as ``meta`` tensors: the weights in
    ``dtype``, and for a decode shape the bfloat16 cache of
    ``shape.global_batch`` sequences of ``shape.seq_len`` (None
    otherwise)."""
    backbone = {"trunk": abstract_params(model.trunk_specs(), dtype),
                "final": abstract_params(model.final_specs(), dtype)}
    head = abstract_params(model.head_specs(), dtype)
    cache = None
    if shape.kind == "decode":
        cache = model.init_cache(shape.global_batch, shape.seq_len,
                                 torch.bfloat16, device="meta")
    return backbone, head, cache


def serve_rules_for(shape: InputShape) -> ShardingRules:
    return LONGCTX_SERVE_RULES if shape.name == "long_500k" else SERVE_RULES


def make_prefill_step(model: Model, cache_len: Optional[int] = None):
    def prefill_step(backbone, head, tokens):
        """tokens (B, S), or embeddings (B, S, d_model) -> (logits (B, V)
        float32, cache)."""
        s = tokens.shape[1]
        with torch.no_grad(), span("prefill"):
            h, _, cache = model.trunk_apply(
                backbone["trunk"], tokens,
                positions=torch.arange(s, device=tokens.device),
                mode="prefill", cache_len=cache_len or s + 1)
            feats = model.final_apply(backbone["final"], h[:, -1:])
            logits = model.head_apply(head, feats)
            return logits[:, -1], cache
    return prefill_step


def make_decode_step(model: Model):
    def decode_step(backbone, head, cache, tokens, positions):
        """tokens (B, 1) at absolute ``positions`` (B,) -> (next tokens
        (B,) int32, logits (B, V), cache). Use the returned cache: the
        attention caches are updated in place, the Mamba2 and xLSTM
        states come back as new tensors."""
        with torch.no_grad():
            logits, _, new_cache = model.forward_logits(
                backbone, head, tokens, positions=positions, mode="decode",
                cache=cache)
        next_tok = logits[:, -1].argmax(dim=-1).to(torch.int32)
        return next_tok, logits[:, -1], new_cache
    return decode_step
