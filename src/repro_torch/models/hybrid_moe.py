"""Granite-4.0-H family (``hybrid_moe``): a trunk of per-layer mixers,
Mamba2 or attention without position encoding, each followed by an MoE
block with a shared expert.

The port's own family (``common.config.HybridMoEConfig``; the JAX
package has none). Layer i, with rm the residual multiplier and norm the
port's RMSNorm scaled by (1 + w)::

    x <- x + rm * mixer_i(norm(x))      mixer_i by cfg.layer_types[i]:
                                        "mamba": mamba2.mamba2_mixer,
                                        "attention": transformer.attn_branch,
                                        no RoPE, scale attention_multiplier
    x <- x + rm * (moe(norm(x)) + shared(norm(x)))      moe.moe_branch

The residual stream x is float32: each branch takes x cast to the
compute dtype and its output is added in float32, so that the stream
is not rounded to bfloat16 at each of its two additions a layer; the
trunk returns x in the compute dtype. The trunk's input is embed(tokens) *
embedding_multiplier; the model's final norm and head follow (``Model``, which divides this family's
logits by ``logits_scaling``). Attention layers are full causal
attention: with ``attn_impl="pallas"`` a prefill launches K8 once per
attention layer.

Parameters: {"embed", "mamba": the Mamba2 mixers stacked in layer order,
"attention": the attention mixers stacked, "moe": every layer's MoE
block stacked}. Cache: {"mamba": {"ssm", "conv"} stacked over the Mamba2
layers, "attention": {"k", "v", "pos"} stacked over the attention
layers}; a decode step writes the attention caches in place and returns
new Mamba2 states. ``param_hook(params, klass, i)`` sees "embed", then
each layer's mixer as ("mamba", i) or ("attention", i), i its index in
that stack, and its MoE block as ("moe", layer).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.common.config import HybridMoEConfig
from repro_torch.common.device import resolve_device
from repro_torch.common.spans import span
from repro_torch.models.mamba2 import (
    init_mamba_cache, mamba2_mixer, mamba2_specs, mamba_cache_axes,
)
from repro_torch.models.moe import moe_branch, moe_specs
from repro_torch.models.params import ParamSpec
from repro_torch.models.transformer import (
    _index, _remat, _stack, _stack_caches, attn_branch, attn_specs,
    embed_inputs,
)


def _n_of(cfg: HybridMoEConfig, kind: str) -> int:
    return cfg.layer_types.count(kind)


def hybrid_moe_trunk_specs(cfg: HybridMoEConfig) -> Dict[str, Any]:
    return {
        "embed": ParamSpec((cfg.vocab_size, cfg.d_model), "embed",
                           axes=("vocab", "embed")),
        "mamba": _stack(mamba2_specs(cfg), _n_of(cfg, "mamba")),
        "attention": _stack(attn_specs(cfg), _n_of(cfg, "attention")),
        "moe": _stack(moe_specs(cfg, cfg.shared_d_ff), cfg.n_layers),
    }


def hybrid_moe_trunk_apply(params, tokens, cfg: HybridMoEConfig, *,
                           positions, mode: str = "train", cache=None,
                           cache_len=None, param_hook=None):
    """Returns (hidden, aux, new_cache): aux the MoE blocks' load-balance
    losses summed in layer order; the cache None in training."""
    rm = cfg.residual_multiplier
    train = mode == "train"

    def layer(kind, mp, ep, x, c):
        h = x.to(cdt)
        if kind == "mamba":
            y, c = mamba2_mixer(mp, h, cfg, mode=mode, cache=c)
        else:
            with span("tf.attn"):
                y, c = attn_branch(mp, h, cfg, positions=positions,
                                   window=None, theta=None, mode=mode,
                                   cache=c, cache_len=cache_len,
                                   scale=cfg.attention_multiplier)
        x = x + rm * y.float()
        y, aux = moe_branch(ep, x.to(cdt), cfg, train=train)
        return x + rm * y, aux, c
    if train:
        layer = _remat(layer, cfg)

    x = embed_inputs(params, tokens, cfg, param_hook)
    cdt = x.dtype
    x = x.float() * cfg.embedding_multiplier
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    seen = {"mamba": 0, "attention": 0}
    caches = {"mamba": [], "attention": []}
    for i, kind in enumerate(cfg.layer_types):
        j = seen[kind]
        seen[kind] += 1
        mp, ep = _index(params[kind], j), _index(params["moe"], i)
        if param_hook is not None:
            mp, ep = param_hook(mp, kind, j), param_hook(ep, "moe", i)
        c = _index(cache[kind], j) if mode == "decode" else None
        x, a, c = layer(kind, mp, ep, x, c)
        aux = aux + a
        caches[kind].append(c)
    x = x.to(cdt)
    if train:
        return x, aux, None
    new = {"mamba": _stack_caches(caches["mamba"]),
           "attention": (cache["attention"] if mode == "decode"
                         else _stack_caches(caches["attention"]))}
    return x, aux, new


def init_hybrid_moe_cache(cfg: HybridMoEConfig, batch: int, cache_len: int,
                          dtype=torch.bfloat16, device="cuda"):
    """Empty cache for decode from scratch, every layer's state in its own
    storage, on the card unless the caller asks for the CPU: the Mamba2
    states and a ``cache_len``-slot KV cache per attention layer."""
    dev = resolve_device(device)
    lead = (_n_of(cfg, "attention"), batch, cache_len)
    kv = lead + (cfg.n_kv_heads, cfg.resolved_head_dim)
    return {
        "mamba": init_mamba_cache(cfg, batch, dtype, dev,
                                  (_n_of(cfg, "mamba"),)),
        "attention": {
            "k": torch.zeros(kv, dtype=dtype, device=dev),
            "v": torch.zeros(kv, dtype=dtype, device=dev),
            "pos": torch.full(lead, -1, dtype=torch.int32, device=dev)},
    }


def hybrid_moe_cache_axes():
    kv = ("layer", "batch", "cache_seq", "kv_heads", "head_dim")
    return {"mamba": {k: ("layer",) + v
                      for k, v in mamba_cache_axes().items()},
            "attention": {"k": kv, "v": kv,
                          "pos": ("layer", "batch", "cache_seq")}}
