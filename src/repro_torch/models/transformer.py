"""Dense decoder backbone: GQA + RoPE + SwiGLU/GELU, stacked layers.

Port of ``repro.models.transformer`` for training (``train``) and
inference (``prefill`` and ``decode``). Covers starcoder2 (sliding
window), stablelm, qwen2.5 (qkv bias), musicgen (audio tokens),
phi-3-vision (embeddings in), mixtral and phi-3.5-moe (an MoE block in
place of the MLP, ``models/moe.py``) and gemma3's local:global pattern
(stacks ``local`` of shape (n_super, r, ...) and ``global`` of shape
(n_super, ...)). Each layer returns an auxiliary loss (the MoE block's
load-balance loss, 0 for a dense MLP) and the trunk sums them over the
layers in layer order, as the reference's scan carry does.

Training runs each layer under ``cfg.remat_policy`` (``_remat``): the
backward recomputes the layer (``"nothing_saveable"``), recomputes all
but its matmul outputs (``"dots"``), or keeps everything (``"none"``).
A ``param_hook`` (the distributed per-leaf oracle's gather) sees each
layer's parameters inside that boundary, with the layer's index as its
last tag, so the backward gathers each layer again rather than keeping
the gathered copies: its collectives and channel draws run again in the
backward, in the same order and under the same keys on every rank.

Parameters are the reference's stacked trees: every leaf of
``layers`` carries a leading layer dim, and the layer loop indexes it
(a view, no copy). Weights stay in ``param_dtype`` (float32) and are
cast to the compute dtype where they are used, as in the reference.

Caches: dicts of stacked tensors
    {"k": (L, B, C, KV, D), "v": ..., "pos": (L, B, C)} with pos[.., b,
    slot] = absolute position held by that slot (-1 = empty). Windowed
    layers use a ring buffer of capacity min(window, cache_len), full
    layers capacity cache_len. Prefill returns new caches; decode writes
    the incoming token into the caller's cache in place (the reference
    returns an updated copy) and returns it.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from repro_torch.common.config import ModelConfig
from repro_torch.common.device import resolve_device
from repro_torch.common.spans import span
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.models import layers as L
from repro_torch.models.moe import moe_apply, moe_specs
from repro_torch.models.params import ParamSpec


# --------------------------------------------------------------------------
# param specs
# --------------------------------------------------------------------------

def _stack(specs, n: int):
    """Prepend a ('layer',) stacking dim of size ``n`` to every spec in a
    tree."""
    return tree_map(lambda s: ParamSpec((n,) + s.shape, s.init, s.scale,
                                        axes=("layer",) + s.axes), specs)


def attn_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, h, kv, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.resolved_head_dim)
    specs = {
        "norm": ParamSpec((d,), "zeros", axes=("embed",)),
        "wq": ParamSpec((d, h, hd), axes=("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, kv, hd), axes=("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, kv, hd), axes=("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((h, hd, d), axes=("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec((h, hd), "zeros", axes=("heads", "head_dim"))
        specs["bk"] = ParamSpec((kv, hd), "zeros",
                                axes=("kv_heads", "head_dim"))
        specs["bv"] = ParamSpec((kv, hd), "zeros",
                                axes=("kv_heads", "head_dim"))
    return specs


def mlp_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, cfg.d_ff
    specs = {
        "norm": ParamSpec((d,), "zeros", axes=("embed",)),
        "w_up": ParamSpec((d, f), axes=("embed", "mlp")),
        "w_down": ParamSpec((f, d), axes=("mlp", "embed")),
    }
    if cfg.mlp_act == "silu":
        specs["w_gate"] = ParamSpec((d, f), axes=("embed", "mlp"))
    return specs


def dense_layer_specs(cfg: ModelConfig) -> Dict[str, Any]:
    if cfg.moe is not None:
        return {"attn": attn_specs(cfg), "mlp": moe_specs(cfg)}
    return {"attn": attn_specs(cfg), "mlp": mlp_specs(cfg)}


def _super_blocks(cfg: ModelConfig) -> int:
    r = cfg.local_global_ratio
    n_super = cfg.n_layers // (r + 1)
    if n_super * (r + 1) != cfg.n_layers:
        raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of "
                         f"local_global_ratio + 1 = {r + 1}")
    return n_super


def dense_trunk_specs(cfg: ModelConfig) -> Dict[str, Any]:
    specs: Dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab_size, cfg.d_model), "embed",
                           axes=("vocab", "embed")),
    }
    if cfg.local_global_ratio:
        r, n_super = cfg.local_global_ratio, _super_blocks(cfg)
        specs["local"] = _stack(_stack(dense_layer_specs(cfg), r), n_super)
        specs["global"] = _stack(dense_layer_specs(cfg), n_super)
    else:
        specs["layers"] = _stack(dense_layer_specs(cfg), cfg.n_layers)
    return specs


def final_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    """The 'last shared layer' ω̃ that FedGradNorm differentiates."""
    return {"norm": ParamSpec((cfg.d_model,), "zeros", axes=("embed",))}


# --------------------------------------------------------------------------
# attention block apply
# --------------------------------------------------------------------------

def _project_qkv(p, x: torch.Tensor, cfg: ModelConfig):
    """q (B, S, H, D), k and v (B, S, KV, D): one matmul each over the
    flattened (heads, head_dim) columns."""
    def proj(w, b=None):
        d, n, hd = w.shape
        y = (x @ w.reshape(d, n * hd).to(x.dtype)).unflatten(-1, (n, hd))
        return y if b is None else y + b.to(x.dtype)
    return (proj(p["wq"], p.get("bq")), proj(p["wk"], p.get("bk")),
            proj(p["wv"], p.get("bv")))


def _prefill_cache(k, v, positions, window, cache_len, batch):
    """The layer's cache after a prefill: the last min(cap, S) positions in
    ring order by absolute position (window) or in order (full), padded
    to the capacity with zeros and pos = -1."""
    s = k.shape[1]
    total = cache_len if cache_len is not None else s + 1
    cap = min(window, total) if window is not None else total
    keep = min(cap, s)
    k_tail, v_tail = k[:, s - keep:], v[:, s - keep:]
    pos_tail = positions[s - keep:]
    if window is not None:
        order = torch.argsort(pos_tail % cap)
        k_tail, v_tail, pos_tail = k_tail[:, order], v_tail[:, order], \
            pos_tail[order]
    pos_tail = pos_tail.to(torch.int32).expand(batch, keep)
    pad = cap - keep
    if pad > 0:
        k_tail = torch.cat([k_tail, k_tail.new_zeros(
            (batch, pad) + tuple(k_tail.shape[2:]))], dim=1)
        v_tail = torch.cat([v_tail, v_tail.new_zeros(
            (batch, pad) + tuple(v_tail.shape[2:]))], dim=1)
        pos_tail = torch.cat([pos_tail, pos_tail.new_full((batch, pad), -1)],
                             dim=1)
    return {"k": k_tail.contiguous(), "v": v_tail.contiguous(),
            "pos": pos_tail.contiguous()}


def attn_branch(p, x: torch.Tensor, cfg: ModelConfig, *, positions,
                window: Optional[int], theta: Optional[float], mode: str,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                cache_len: Optional[int] = None,
                scale: Optional[float] = None):
    """The pre-norm attention block's branch, attn(norm(x)) without the
    residual; returns (branch, cache), the cache None in training.

    ``positions`` is (S,) in training and prefill and the (B,) absolute
    positions of the incoming tokens in decode. ``theta`` None leaves q
    and k unrotated (no position encoding); ``scale`` is the softmax
    scale, 1/√D when None."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be 'train', 'prefill' or 'decode', "
                         f"got {mode!r}")
    h = L.rms_norm(x, p["norm"], 1e-6)
    q, k, v = _project_qkv(p, h, cfg)
    if mode == "decode":
        if theta is not None:
            q = L.apply_rope(q, positions[:, None], theta)
            k = L.apply_rope(k, positions[:, None], theta)
        cap = cache["k"].shape[1]
        slot = positions % cap if window is not None else positions
        slot = slot.clamp(0, cap - 1)
        bidx = torch.arange(x.shape[0], device=x.device)
        cache["k"][bidx, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][bidx, slot] = v[:, 0].to(cache["v"].dtype)
        cache["pos"][bidx, slot] = positions.to(cache["pos"].dtype)
        out = L.decode_attention(q, cache["k"], cache["v"],
                                 pos_q=positions, pos_kv=cache["pos"],
                                 window=window, scale=scale)
        new_cache = cache
    else:
        if theta is not None:
            q = L.apply_rope(q, positions[None, :], theta)
            k = L.apply_rope(k, positions[None, :], theta)
        out = L.attention(q, k, v, pos_q=positions, pos_kv=positions,
                          impl=cfg.attn_impl, window=window,
                          block_q=cfg.attn_block_q,
                          block_kv=cfg.attn_block_kv, scale=scale)
        new_cache = None if mode == "train" else _prefill_cache(
            k, v, positions, window, cache_len, x.shape[0])
    wo = p["wo"]
    return out.flatten(-2) @ wo.reshape(-1, wo.shape[-1]).to(x.dtype), \
        new_cache


def attn_apply(p, x: torch.Tensor, cfg: ModelConfig, *, positions,
               window: Optional[int], theta: Optional[float], mode: str,
               cache: Optional[Dict[str, torch.Tensor]] = None,
               cache_len: Optional[int] = None):
    """Pre-norm attention block, x + ``attn_branch``; returns (x +
    attn(x), cache), the cache None in training."""
    with span("tf.attn"):
        y, new_cache = attn_branch(p, x, cfg, positions=positions,
                                   window=window, theta=theta, mode=mode,
                                   cache=cache, cache_len=cache_len)
        return x + y, new_cache


def mlp_block_apply(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    with span("tf.mlp"):
        h = L.rms_norm(x, p["norm"], 1e-6)
        w = {k: v.to(x.dtype) for k, v in p.items() if k != "norm"}
        return x + L.mlp_apply(w, h, cfg.mlp_act)


def dense_layer_apply(p, x, cfg: ModelConfig, *, positions, window, theta,
                      mode, cache=None, cache_len=None):
    """Returns (x, aux_loss, new_cache): the MoE block's load-balance loss
    (capacity dropping in training only), or 0 for a dense MLP."""
    x, new_cache = attn_apply(p["attn"], x, cfg, positions=positions,
                              window=window, theta=theta, mode=mode,
                              cache=cache, cache_len=cache_len)
    if cfg.moe is not None:
        x, aux = moe_apply(p["mlp"], x, cfg, train=(mode == "train"))
    else:
        x = mlp_block_apply(p["mlp"], x, cfg)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux, new_cache


# --------------------------------------------------------------------------
# trunk forward (a loop over stacked layers)
# --------------------------------------------------------------------------

_DOT_OPS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default}


def _save_dots(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy (``jax.checkpoint_policies.checkpoint_dots``):
    keep the matmul outputs, recompute the rest."""
    return (CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, cfg: ModelConfig):
    """``fn`` under ``cfg.remat_policy`` when autograd records: "none"
    runs it plainly, "dots" recomputes all but the matmul outputs in the
    backward, "nothing_saveable" recomputes it whole. The layer's aux
    loss is one of ``fn``'s tensor outputs, so its gradient flows back
    through the recomputed layer like the hidden state's."""
    if cfg.remat_policy == "none":
        return fn
    if cfg.remat_policy not in ("dots", "nothing_saveable"):
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = lambda: create_selective_checkpoint_contexts(
            _save_dots)

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return run


def _index(tree, i: int):
    """Layer ``i`` of a stacked tree (views, no copies)."""
    return tree_map(lambda t: t[i], tree)


def _stack_caches(caches: List[Dict[str, torch.Tensor]]):
    return {k: torch.stack([c[k] for c in caches]) for k in caches[0]}


def _hooked(layer_fn, param_hook, tags):
    """``layer_fn`` with the hook on its parameters: ``fn(lp, i, h, c) ->
    (h, aux, c)`` hooks ``lp`` as ("layers", *tags, i)."""
    def fn(lp, i, h, c):
        if param_hook is not None:
            lp = param_hook(lp, "layers", *tags, i)
        return layer_fn(lp, h, c)
    return fn


def _run_stack(layer_fn, stack_params, x, aux, cache, mode: str,
               cfg: ModelConfig, param_hook=None, hook_tags=()):
    """Run ``layer_fn(lp, h, c) -> (h, aux, c)`` over a stacked param tree
    (and, in decode, the matching stacked cache), each layer under the
    remat policy in training, adding each layer's aux loss to ``aux`` in
    layer order. Returns (x, aux, new_cache): None in training, the
    layers' caches stacked in prefill, the updated input cache in
    decode."""
    fn = _hooked(layer_fn, param_hook, hook_tags)
    if mode == "train":
        fn = _remat(fn, cfg)
    n = tree_leaves(stack_params)[0].shape[0]
    caches = []
    for i in range(n):
        c = _index(cache, i) if mode == "decode" else None
        x, a, c2 = fn(_index(stack_params, i), i, x, c)
        aux = aux + a
        caches.append(c2)
    if mode == "train":
        return x, aux, None
    if mode == "decode":
        return x, aux, cache
    return x, aux, _stack_caches(caches)


def _cdt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def embed_inputs(params, tokens_or_embeds, cfg: ModelConfig,
                 param_hook=None) -> torch.Tensor:
    """An LM trunk's input in the compute dtype: token ids (B, S) looked
    up in ``params["embed"]`` (hooked as "embed"), or float embeddings
    (B, S, d_model) as they are."""
    embed = params["embed"]
    if param_hook is not None:
        embed = param_hook(embed, "embed")
    if torch.is_floating_point(tokens_or_embeds):
        return tokens_or_embeds.to(_cdt(cfg))
    # gather, then cast: the same numbers as casting the table
    # (``F.embedding``: its backward sums each row's gradients in a fixed
    # order on every device, unlike an indexed gather's)
    return F.embedding(tokens_or_embeds, embed).to(_cdt(cfg))


def dense_trunk_apply(params, tokens_or_embeds, cfg: ModelConfig, *,
                      positions, mode: str = "train", cache=None,
                      cache_len=None, param_hook=None):
    """Returns (hidden_pre_final, aux_loss, new_cache), aux_loss the sum
    of the layers' (the MoE blocks' load-balance losses; 0 for a dense
    model). ``param_hook(params, klass, *tags)`` sees the
    embedding table as "embed" and each layer's parameters as "layers"
    with tags (layer,), or gemma3's (super-block, layer in it), the
    global layer of a super-block being layer r."""
    x = embed_inputs(params, tokens_or_embeds, cfg, param_hook)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    if cfg.local_global_ratio:
        theta_g = cfg.rope_theta_global or cfg.rope_theta
        r, n_super = cfg.local_global_ratio, _super_blocks(cfg)

        def local_fn(lp, h, c):
            return dense_layer_apply(lp, h, cfg, positions=positions,
                                     window=cfg.local_window,
                                     theta=cfg.rope_theta, mode=mode,
                                     cache=c, cache_len=cache_len)

        def global_fn(lp, h, c):
            return dense_layer_apply(lp, h, cfg, positions=positions,
                                     window=None, theta=theta_g, mode=mode,
                                     cache=c, cache_len=cache_len)

        loc, glob = [], []
        for si in range(n_super):
            c_l = _index(cache["local"], si) if mode == "decode" else None
            x, aux, nc_l = _run_stack(local_fn, _index(params["local"], si),
                                      x, aux, c_l, mode, cfg, param_hook,
                                      (si,))
            c_g = _index(cache["global"], si) if mode == "decode" else None
            # the global layer is hooked as ("layers", si, r)
            g_fn = _hooked(global_fn, param_hook, (si,))
            if mode == "train":
                g_fn = _remat(g_fn, cfg)
            x, a, nc_g = g_fn(_index(params["global"], si), r, x, c_g)
            aux = aux + a
            loc.append(nc_l)
            glob.append(nc_g)
        if mode == "train":
            return x, aux, None
        if mode == "decode":
            return x, aux, cache
        return x, aux, {"local": _stack_caches(loc),
                        "global": _stack_caches(glob)}

    def layer_fn(lp, h, c):
        return dense_layer_apply(lp, h, cfg, positions=positions,
                                 window=cfg.sliding_window,
                                 theta=cfg.rope_theta, mode=mode, cache=c,
                                 cache_len=cache_len)
    return _run_stack(layer_fn, params["layers"], x, aux, cache, mode, cfg,
                      param_hook)


# --------------------------------------------------------------------------
# cache construction
# --------------------------------------------------------------------------

def init_dense_cache(cfg: ModelConfig, batch: int, cache_len: int,
                     dtype=torch.bfloat16, device="cuda"):
    """Empty stacked cache for decode from scratch, on the card unless the
    caller asks for the CPU."""
    device = resolve_device(device)
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim

    def one(lead, window):
        cap = min(window, cache_len) if window is not None else cache_len
        return {
            "k": torch.zeros(lead + (batch, cap, kv, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros(lead + (batch, cap, kv, hd), dtype=dtype,
                             device=device),
            "pos": torch.full(lead + (batch, cap), -1, dtype=torch.int32,
                              device=device),
        }

    if cfg.local_global_ratio:
        r, n_super = cfg.local_global_ratio, _super_blocks(cfg)
        return {"local": one((n_super, r), cfg.local_window),
                "global": one((n_super,), None)}
    return one((cfg.n_layers,), cfg.sliding_window)


def dense_cache_axes(cfg: ModelConfig):
    """Logical axes of the cache's leaves (the reference's sharding
    names)."""
    def one(n_lead):
        lead = ("layer",) * n_lead
        return {
            "k": lead + ("batch", "cache_seq", "kv_heads", "head_dim"),
            "v": lead + ("batch", "cache_seq", "kv_heads", "head_dim"),
            "pos": lead + ("batch", "cache_seq"),
        }
    if cfg.local_global_ratio:
        return {"local": one(2), "global": one(1)}
    return one(1)
