"""Shared layers of the dense LM: RMSNorm, RoPE, MLP, GQA attention.

Port of ``repro.models.layers`` for the serving path. Shapes are the
reference's: q (B, Sq, H, D); k, v (B, Skv, KV, D), query heads grouped
over KV heads. ``attention(impl=...)`` dispatches:

* ``pallas`` — the flash attention kernel K8
  (``repro_torch.kernels.flash_attention``), the serving hot path;
* ``naive``  — full (Sq, Skv) score matrix, the plain oracle.

The reference's ``blocked`` and ``folded`` paths are its autodiff-able
training attention and are refused by name until the LM-training slice
ports them (ROADMAP Queue 1, item 14).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops as flash_ops

NEG_INF = -1e30


# --------------------------------------------------------------------------
# normalization / embeddings / mlp
# --------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """x / rms(x) · (1 + scale), in float32 inside, ``x.dtype`` out."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S). Rotates
    the two halves of D by float32 angles."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)   # (D/2,)
    angles = positions[..., :, None].float() * freqs        # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                   # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp_apply(params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """SwiGLU (``silu``) or plain GELU MLP. ``jax.nn.gelu`` defaults to
    the tanh approximation, so the GELU here is the tanh one too."""
    if act == "silu":
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    else:
        h = F.gelu(x @ params["w_up"], approximate="tanh")
    return h @ params["w_down"]


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

def _mask_block(pos_q: torch.Tensor, pos_kv: torch.Tensor,
                window: Optional[int]) -> torch.Tensor:
    """Causal (+ optional sliding window) mask, True = attend."""
    diff = pos_q[:, None] - pos_kv[None, :]
    mask = diff >= 0
    if window is not None:
        mask &= diff < window
    return mask


def naive_attention(q, k, v, *, pos_q, pos_kv, window=None):
    """Full-matrix attention: float32 scores and softmax, probabilities
    cast to ``q.dtype`` before PV, as the reference does."""
    b, sq, h, d = q.shape
    n_kv = k.shape[2]
    qg = q.reshape(b, sq, n_kv, h // n_kv, d)
    scale = 1.0 / math.sqrt(d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    scores = scores.masked_fill(~_mask_block(pos_q, pos_kv, window),
                                NEG_INF)
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(p.dtype))
    return out.reshape(b, sq, h, d)


def decode_attention(q, k_cache, v_cache, *, pos_q, pos_kv, window=None):
    """q (B, 1, H, D) against caches (B, L, KV, D); pos_kv (B, L) holds
    each slot's absolute position, -1 for an empty slot. Masking is
    positional, so ring-buffer slot order does not matter."""
    b, _, h, d = q.shape
    n_kv = k_cache.shape[2]
    qg = q.reshape(b, 1, n_kv, h // n_kv, d)
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bqkgd,blkd->bkgql", qg.float(),
                     k_cache.float()) * scale                 # (B,KV,G,1,L)
    diff = pos_q[:, None] - pos_kv                            # (B, L)
    mask = (pos_kv >= 0) & (diff >= 0)
    if window is not None:
        mask &= diff < window
    s = s.masked_fill(~mask[:, None, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgql,blkd->bqkgd", p, v_cache.float())
    return out.reshape(b, 1, h, d).to(q.dtype)


def attention(q, k, v, *, pos_q, pos_kv, impl: str = "pallas",
              window: Optional[int] = None):
    """Prefill attention, dispatched on ``impl`` (``ModelConfig.attn_impl``).
    The kernel, like the reference's, takes positions to be 0..S-1."""
    if impl == "pallas":
        return flash_ops.flash_attention(q, k, v, window=window)
    if impl == "naive":
        return naive_attention(q, k, v, pos_q=pos_q, pos_kv=pos_kv,
                               window=window)
    if impl in ("blocked", "folded"):
        raise NotImplementedError(
            f"attn_impl={impl!r} is the reference's training attention and "
            f"is not ported yet (ROADMAP Queue 1, item 14: LM training); "
            f"serve with attn_impl='pallas' or check with 'naive'")
    raise ValueError(f"unknown attn_impl {impl!r}")
