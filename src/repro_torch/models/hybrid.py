"""Zamba2-style hybrid backbone: Mamba2 layers and one *shared* attention
block.

Port of ``repro.models.hybrid``. A single transformer block (attention +
MLP) whose weights are reused at several depths, interleaved into a
Mamba backbone: the shared block runs after every ``hybrid.attn_every``
Mamba layers. Layout for n_layers=38, attn_every=6::

    [6 mamba] A [6 mamba] A [6 mamba] A [6 mamba] A [6 mamba] A [6 mamba] A [2 mamba]

(A = the shared block, the same parameters each time: 6 applications.)
Each application's attention is the port's ``transformer.attn_apply``:
with ``attn_impl="pallas"`` (what ``launch.serve`` sets) a prefill
launches the flash attention kernel K8 once per application.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.common.device import resolve_device
from repro_torch.common.tree import tree_map
from repro_torch.models.mamba2 import (
    init_mamba_cache, mamba2_specs, mamba_cache_axes, mamba_stack_apply,
)
from repro_torch.models.params import ParamSpec
from repro_torch.models.transformer import (
    _remat, _stack, attn_apply, attn_specs, embed_inputs, mlp_block_apply,
    mlp_specs,
)


def segments(cfg: ModelConfig) -> List[int]:
    k = cfg.hybrid.attn_every
    n = cfg.n_layers
    segs = [k] * (n // k)
    if n % k:
        segs.append(n % k)
    return segs


def n_shared_applications(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.hybrid.attn_every


def _shared_attn_cfg(cfg: ModelConfig) -> ModelConfig:
    h = cfg.hybrid
    return cfg.replace(n_heads=h.shared_attn_n_heads,
                       n_kv_heads=h.shared_attn_n_kv, moe=None)


def hybrid_trunk_specs(cfg: ModelConfig) -> Dict[str, Any]:
    shared_cfg = _shared_attn_cfg(cfg)
    return {
        "embed": ParamSpec((cfg.vocab_size, cfg.d_model), "embed",
                           axes=("vocab", "embed")),
        "mamba": _stack(mamba2_specs(cfg), cfg.n_layers),
        "shared_attn": attn_specs(shared_cfg),
        "shared_mlp": mlp_specs(shared_cfg),
    }


def hybrid_trunk_apply(params, tokens, cfg: ModelConfig, *, positions,
                       mode: str = "train", cache=None, cache_len=None,
                       param_hook=None):
    """Returns (hidden, aux = 0, new_cache). Cache layout: {"mamba":
    stacked over all n_layers, "attn": a list of per-application KV
    dicts}. ``param_hook(params, klass, *tags)`` sees "embed", then
    "shared_attn" and "shared_mlp" once each, then ("mamba", i) with the
    global layer index i, segment by segment. The shared block's weights
    are one parameter set used at several depths: they are gathered once,
    so the channel of eq. (8) is drawn once per iteration and autograd
    sums the cotangents of every use site before the OTA reduction."""
    shared_cfg = _shared_attn_cfg(cfg)
    x = embed_inputs(params, tokens, cfg, param_hook)

    shared_attn_p, shared_mlp_p = params["shared_attn"], params["shared_mlp"]
    if param_hook is not None:
        shared_attn_p = param_hook(shared_attn_p, "shared_attn")
        shared_mlp_p = param_hook(shared_mlp_p, "shared_mlp")

    def shared_fn(h, c):
        h2, c2 = attn_apply(shared_attn_p, h, shared_cfg,
                            positions=positions, window=cfg.sliding_window,
                            theta=cfg.rope_theta, mode=mode, cache=c,
                            cache_len=cache_len)
        return mlp_block_apply(shared_mlp_p, h2, shared_cfg), c2
    if mode == "train":
        shared_fn = _remat(shared_fn, cfg)

    n_apps = n_shared_applications(cfg)
    mamba_caches, attn_caches = [], []
    start = app = 0
    for seg in segments(cfg):
        lp_seg = tree_map(lambda a: a[start:start + seg], params["mamba"])
        c_seg = (tree_map(lambda a: a[start:start + seg], cache["mamba"])
                 if mode == "decode" else None)
        x, nc = mamba_stack_apply(lp_seg, x, cfg, mode=mode, cache=c_seg,
                                  param_hook=param_hook, klass="mamba",
                                  first=start)
        mamba_caches.append(nc)
        start += seg
        if app < n_apps and start >= (app + 1) * cfg.hybrid.attn_every:
            c_attn = cache["attn"][app] if mode == "decode" else None
            x, nc_attn = shared_fn(x, c_attn)
            attn_caches.append(nc_attn)
            app += 1

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if mode == "train":
        return x, aux, None
    mamba = {k: torch.cat([c[k] for c in mamba_caches])
             for k in mamba_caches[0]}
    return x, aux, {"mamba": mamba, "attn": attn_caches}


def init_hybrid_cache(cfg: ModelConfig, batch: int, cache_len: int,
                      dtype=torch.bfloat16, device="cuda"):
    """Empty cache for decode from scratch, materialised (each layer and
    each application its own storage), on the card unless the caller asks
    for the CPU. The attention rings hold min(window, cache_len) slots."""
    shared_cfg = _shared_attn_cfg(cfg)
    win = cfg.sliding_window
    cap = min(win, cache_len) if win is not None else cache_len
    kv, hd = shared_cfg.n_kv_heads, shared_cfg.resolved_head_dim
    dev = resolve_device(device)
    attn = [{
        "k": torch.zeros((batch, cap, kv, hd), dtype=dtype, device=dev),
        "v": torch.zeros((batch, cap, kv, hd), dtype=dtype, device=dev),
        "pos": torch.full((batch, cap), -1, dtype=torch.int32, device=dev),
    } for _ in range(n_shared_applications(cfg))]
    return {"mamba": init_mamba_cache(cfg, batch, dtype, dev,
                                      (cfg.n_layers,)),
            "attn": attn}


def hybrid_cache_axes(cfg: ModelConfig):
    m = {k: ("layer",) + v for k, v in mamba_cache_axes().items()}
    a = {"k": ("batch", "cache_seq", "kv_heads", "head_dim"),
         "v": ("batch", "cache_seq", "kv_heads", "head_dim"),
         "pos": ("batch", "cache_seq")}
    return {"mamba": m, "attn": [a for _ in range(n_shared_applications(cfg))]}
