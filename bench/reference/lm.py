"""Plain PyTorch reference of the dense decoder's prefill: the last
position's float32 logits of a batch of prompts.

The model is the port's dense family as configured (StarCoder2-3B,
arXiv:2402.19173, at its published widths): a token embedding; per
layer, pre-norm attention and a pre-norm MLP, each added to the residual
stream; a final norm and a linear head. Its departures from the
published StarCoder2 are the port's, kept here so that both sides
compute one function: the norms are RMSNorm scaled by (1 + w) with no
bias, the layers' with eps 1e-6 and the final one with the
configuration's ``norm_eps``, and no projection has a bias.

* attention: q = h W_q, k = h W_k, v = h W_v (H query and KV key/value
  heads of size D), RoPE on q and k (the two halves of D rotated by
  angles p·θ^(-2j/D), j < D/2), then causal softmax(q kᵀ / √D) v in which
  position i sees positions j with 0 <= i - j < window, each query head
  reading KV head ⌊h·KV/H⌋, then W_o;
* MLP: GELU (tanh form) of h W_up, times W_down.

Everything is float32 with matrix products outside TF32; attention runs
in blocks of query rows so that its scores fit. ``quantize`` (the
control) rounds both operands of every product to another format first.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


def fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one per-tensor scale (amax to 448),
    returned in float32: the control's precision."""
    amax = x.abs().amax().clamp_min(1e-30)
    scale = 448.0 / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def _mm(a, b, quant: Quant):
    if quant is not None:
        a, b = quant(a), quant(b)
    return a @ b


def _rms(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + w)


def _rope(x, theta):
    """x (B, S, n, D) at positions 0..S-1."""
    s, d = x.shape[1], x.shape[-1]
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v, window, quant: Quant, block: int):
    """q (B, S, H, D), k and v (B, S, KV, D) -> (B, S, H, D)."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, s, kv, h // kv, d).permute(0, 2, 3, 1, 4)  # B KV G S D
    kt = k.permute(0, 2, 3, 1)[:, :, None]                        # B KV 1 D S
    vt = v.permute(0, 2, 1, 3)[:, :, None]                        # B KV 1 S D
    out = torch.empty_like(qg)
    pos = torch.arange(s, device=q.device)
    for i0 in range(0, s, block):
        i1 = min(i0 + block, s)
        j0 = 0 if window is None else max(0, i0 - window + 1)
        sc = _mm(qg[:, :, :, i0:i1], kt[..., j0:i1], quant) / math.sqrt(d)
        diff = pos[i0:i1, None] - pos[None, j0:i1]
        ok = diff >= 0
        if window is not None:
            ok &= diff < window
        sc = sc.masked_fill(~ok, float("-inf"))
        out[:, :, :, i0:i1] = _mm(torch.softmax(sc, dim=-1), vt[:, :, :, j0:i1],
                                  quant)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d)


def last_logits(weights: Dict[str, torch.Tensor], cfg: Dict, tokens,
                quant: Quant = None, block: int = 1024) -> torch.Tensor:
    """(B, V) float32 logits at the last position of ``tokens`` (B, S).

    ``weights`` holds "embed" (V, d), the stacked layers "attn_norm",
    "wq" (L, d, H, D), "wk", "wv" (L, d, KV, D), "wo" (L, H, D, d),
    "mlp_norm", "w_up" (L, d, f), "w_down" (L, f, d), and "final_norm"
    (d,), "head" (d, V)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            return _last_logits(weights, cfg, tokens, quant, block)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _last_logits(w, cfg, tokens, quant, block):
    h, kv, d = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    window = cfg.get("sliding_window")
    x = w["embed"][tokens.long()].float()
    b, s, dm = x.shape
    for i in range(cfg["n_layers"]):
        a = _rms(x, w["attn_norm"][i], 1e-6)
        q = _mm(a, w["wq"][i].reshape(dm, h * d), quant).reshape(b, s, h, d)
        k = _mm(a, w["wk"][i].reshape(dm, kv * d), quant).reshape(b, s, kv, d)
        v = _mm(a, w["wv"][i].reshape(dm, kv * d), quant).reshape(b, s, kv, d)
        q, k = _rope(q, cfg["rope_theta"]), _rope(k, cfg["rope_theta"])
        o = _attention(q, k, v, window, quant, block)
        x = x + _mm(o.reshape(b, s, h * d), w["wo"][i].reshape(h * d, dm),
                    quant)
        m = _rms(x, w["mlp_norm"][i], 1e-6)
        u = F.gelu(_mm(m, w["w_up"][i], quant), approximate="tanh")
        x = x + _mm(u, w["w_down"][i], quant)
    f = _rms(x[:, -1], w["final_norm"], cfg["norm_eps"])
    return _mm(f, w["head"], quant)
