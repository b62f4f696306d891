"""Mamba2 block in SSD (state-space duality) chunked form.

Port of ``repro.models.mamba2``. The sequence splits into chunks; within
a chunk the SSM output is a masked quadratic form, and states pass
between chunks through a recurrence over the chunks (a loop here, the
reference's ``lax.scan``). Decode is the O(1) recurrent update.

Layout: d_inner = expand * d_model, heads H = d_inner / head_dim P, a
scalar A per head, B/C shared across the heads of each of ``n_groups``
groups (head h reads group h // (H / G), as ``jnp.repeat`` spreads
them). The SSD runs in float32 whatever the compute dtype, as in the
reference. Its products are written as batched matmuls over the group
axis, so no intermediate is larger than the reference's (the scores are
computed once per group, not once per head): at Zamba2-1.2B's width one
(1, 32 chunks, 64 heads, 256, 256) float32 tensor is 537 MB.

State cache for decode:
    {"ssm": (B, H, P, N), "conv": (B, d_conv - 1, d_in + 2 * G * N)}
A prefill returns ``ssm`` in bfloat16 and ``conv`` in the compute dtype
(the reference's casts); a decode step returns new tensors and leaves
its input cache alone.

``mamba2_mixer`` is the block's branch alone (the ``repro.mamba`` span),
so that a caller can scale it before the residual (Granite-4.0-H's
``residual_multiplier``); ``mamba2_apply`` adds it to x.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.config import ModelConfig
from repro_torch.common.device import resolve_device
from repro_torch.common.spans import span
from repro_torch.models import layers as L
from repro_torch.models.params import ParamSpec
from repro_torch.models.transformer import _index, _remat, _stack_caches


def _dims(cfg: ModelConfig):
    scfg = cfg.ssm
    d_in = scfg.expand * cfg.d_model
    n_heads = d_in // scfg.head_dim
    conv_dim = d_in + 2 * scfg.n_groups * scfg.d_state
    return d_in, n_heads, conv_dim


def mamba2_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    scfg = cfg.ssm
    d = cfg.d_model
    d_in, n_heads, conv_dim = _dims(cfg)
    n, gr = scfg.d_state, scfg.n_groups
    return {
        "norm": ParamSpec((d,), "zeros", axes=("embed",)),
        # fused input projection: [z, x, B, C, dt]
        "w_in": ParamSpec((d, 2 * d_in + 2 * gr * n + n_heads),
                          axes=("embed", "mlp")),
        "conv_w": ParamSpec((scfg.d_conv, conv_dim), scale=0.1,
                            axes=(None, "mlp")),
        "conv_b": ParamSpec((conv_dim,), "zeros", axes=("mlp",)),
        "a_log": ParamSpec((n_heads,), "zeros", axes=("heads",)),
        "d_skip": ParamSpec((n_heads,), "ones", axes=("heads",)),
        "dt_bias": ParamSpec((n_heads,), "zeros", axes=("heads",)),
        "out_norm": ParamSpec((d_in,), "zeros", axes=("mlp",)),
        "w_out": ParamSpec((d_in, d), axes=("mlp", "embed")),
    }


def _split_proj(proj: torch.Tensor, cfg: ModelConfig):
    """(z, xBC, dt) of the fused projection."""
    scfg = cfg.ssm
    d_in, n_heads, _ = _dims(cfg)
    gn = scfg.n_groups * scfg.d_state
    return torch.split(proj, [d_in, d_in + 2 * gn, n_heads], dim=-1)


def _causal_conv(xbc, conv_w, conv_b, conv_state=None):
    """Depthwise causal conv along the sequence. xbc (B, S, C), conv_w
    (K, C). Returns (silu(conv + b), the last K - 1 inputs)."""
    k = conv_w.shape[0]
    if conv_state is not None:
        xbc_pad = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)
    else:
        xbc_pad = F.pad(xbc, (0, 0, k - 1, 0))
    new_state = xbc_pad[:, -(k - 1):] if k > 1 else None
    s = xbc.shape[1]
    out = torch.zeros_like(xbc)
    for i in range(k):
        out = out + xbc_pad[:, i:i + s] * conv_w[i]
    return F.silu(out + conv_b.to(xbc.dtype)), new_state


def _segsum(log_a: torch.Tensor) -> torch.Tensor:
    """Stable segment sum: out[i, j] = sum_{j < m <= i} log_a[m], -inf
    for j > i. log_a (..., L) -> (..., L, L)."""
    n = log_a.shape[-1]
    cs = torch.cumsum(log_a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    idx = torch.arange(n, device=log_a.device)
    mask = idx[:, None] >= idx[None, :]
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, dt, A, B, C, chunk: int):
    """SSD forward.

    x (B, S, H, P) values; dt (B, S, H) positive step sizes; A (H,)
    negative; B, C (B, S, G, N), group g serving heads g·H/G .. (g+1)·H/G
    - 1. A chunk that does not divide S becomes S (one whole-sequence
    chunk), as in the reference. Returns y (B, S, H, P) and the final
    state (B, H, P, N), float32.
    """
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if h % g:
        raise ValueError(f"{h} heads do not split into {g} groups")
    rep = h // g
    if s % chunk != 0:
        chunk = s
    nc = s // chunk

    xr = x.reshape(b, nc, chunk, h, p)
    dtr = dt.reshape(b, nc, chunk, h)
    # per group, chunk-major: (b, nc, g, l, n)
    Bg = B.reshape(b, nc, chunk, g, n).permute(0, 1, 3, 2, 4)
    Cg = C.reshape(b, nc, chunk, g, n).permute(0, 1, 3, 2, 4)

    dA = dtr * A                                        # (b,nc,l,h) negative
    dA_cum = torch.cumsum(dA, dim=2)

    # --- intra-chunk (diagonal blocks): masked quadratic form
    Lmat = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))   # (b,nc,h,l,l)
    scores = Cg @ Bg.transpose(-1, -2)                  # (b,nc,g,l,s)
    M = (scores.unsqueeze(3)
         * Lmat.reshape(b, nc, g, rep, chunk, chunk))   # (b,nc,g,rep,l,s)
    dx = (dtr.unsqueeze(-1) * xr).permute(0, 1, 3, 2, 4)    # (b,nc,h,s,p)
    y_diag = M.reshape(b, nc, h, chunk, chunk) @ dx          # (b,nc,h,l,p)
    del M

    # --- chunk states: sum_l exp(dA_cum_end - dA_cum_l) dt_l x_l B_l
    decay_to_end = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)     # (b,nc,l,h)
    wx = ((decay_to_end * dtr).unsqueeze(-1) * xr).permute(0, 1, 3, 4, 2)
    states = (wx.reshape(b, nc, g, rep, p, chunk)
              @ Bg.unsqueeze(3)).reshape(b, nc, h, p, n)   # (b,nc,h,p,n)

    # --- inter-chunk recurrence over chunk states
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])                # (b,nc,h)
    carry = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(carry)                 # the state *before* chunk c
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                 # (b,nc,h,p,n)

    # --- the carried-in state's contribution to each position
    state_decay = torch.exp(dA_cum).permute(0, 1, 3, 2)    # (b,nc,h,l)
    y_off = (Cg.unsqueeze(3) @ prev_states.reshape(
        b, nc, g, rep, p, n).transpose(-1, -2)).reshape(
        b, nc, h, chunk, p) * state_decay.unsqueeze(-1)    # (b,nc,h,l,p)

    y = (y_diag + y_off).permute(0, 1, 3, 2, 4).reshape(b, s, h, p)
    return y, carry


def mamba2_mixer(p, x: torch.Tensor, cfg: ModelConfig, *,
                 mode: str = "train",
                 cache: Optional[Dict[str, torch.Tensor]] = None
                 ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """The block's branch without the residual, from the norm to the
    out-projection: x (B, S, d). Decode: S = 1 with cache {"ssm",
    "conv"}. Returns (block(x), the new cache: None in training)."""
    with span("mamba"):
        return _mixer(p, x, cfg, mode, cache)


def _mixer(p, x, cfg: ModelConfig, mode: str, cache):
    scfg = cfg.ssm
    d_in, n_heads, _ = _dims(cfg)
    gr, n = scfg.n_groups, scfg.d_state
    ph = scfg.head_dim
    h = L.rms_norm(x, p["norm"], 1e-6)
    proj = h @ p["w_in"].to(h.dtype)
    z, xbc, dt = _split_proj(proj, cfg)
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["a_log"].float())
    conv_w = p["conv_w"].to(h.dtype)

    if mode == "decode":
        xbc_act, conv_tail = _causal_conv(xbc, conv_w, p["conv_b"],
                                          cache["conv"])
        xs, B_, C_ = torch.split(xbc_act, [d_in, gr * n, gr * n], dim=-1)
        xs = xs.reshape(-1, n_heads, ph).float()            # (B, H, P)
        rep = n_heads // gr
        Bh = B_.reshape(-1, gr, n).repeat_interleave(rep, dim=1).float()
        Ch = C_.reshape(-1, gr, n).repeat_interleave(rep, dim=1).float()
        dt0 = dt[:, 0]                                      # (B, H)
        decay = torch.exp(dt0 * A)                          # (B, H)
        ssm = cache["ssm"].float()
        ssm = ssm * decay[..., None, None] + (
            dt0[..., None, None] * xs[..., :, None] * Bh[..., None, :])
        y = (ssm @ Ch.unsqueeze(-1)).squeeze(-1)            # (B, H, P)
        y = y + p["d_skip"][None, :, None] * xs
        y = y.reshape(-1, 1, d_in).to(h.dtype)
        new_cache = {"ssm": ssm.to(cache["ssm"].dtype), "conv": conv_tail}
    else:
        xbc_act, conv_tail = _causal_conv(xbc, conv_w, p["conv_b"])
        b, s, _ = xbc_act.shape
        xs, B_, C_ = torch.split(xbc_act, [d_in, gr * n, gr * n], dim=-1)
        xs = xs.reshape(b, s, n_heads, ph).float()
        y, final_state = ssd_chunked(xs, dt, A,
                                     B_.reshape(b, s, gr, n).float(),
                                     C_.reshape(b, s, gr, n).float(),
                                     scfg.chunk_size)
        y = y + p["d_skip"][None, None, :, None] * xs
        y = y.reshape(b, s, d_in).to(h.dtype)
        new_cache = None
        if mode == "prefill":
            new_cache = {"ssm": final_state.to(torch.bfloat16),
                         "conv": conv_tail}

    y = y * F.silu(z)
    y = L.rms_norm(y, p["out_norm"], 1e-6)
    return y @ p["w_out"].to(h.dtype), new_cache


def mamba2_apply(p, x: torch.Tensor, cfg: ModelConfig, *,
                 mode: str = "train",
                 cache: Optional[Dict[str, torch.Tensor]] = None
                 ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """x (B, S, d). Decode: S = 1 with cache {"ssm", "conv"}. Returns
    (x + block(x), the new cache: None in training)."""
    y, new_cache = mamba2_mixer(p, x, cfg, mode=mode, cache=cache)
    return x + y, new_cache


def mamba_stack_apply(layers, x: torch.Tensor, cfg: ModelConfig, *,
                      mode: str, cache=None, param_hook=None,
                      klass: str = "layers", first: int = 0):
    """``mamba2_apply`` over the stacked layers ``layers`` (and, in decode,
    their stacked ``cache``), layer i hooked as (klass, first + i) inside
    the remat boundary in training. Returns (x, the layers' caches stacked
    in prefill and decode, None in training)."""
    def fn(lp, i, h, c):
        if param_hook is not None:
            lp = param_hook(lp, klass, i)
        return mamba2_apply(lp, h, cfg, mode=mode, cache=c)
    if mode == "train":
        fn = _remat(fn, cfg)
    n = layers["w_in"].shape[0]
    caches = []
    for i in range(n):
        c = _index(cache, i) if mode == "decode" else None
        x, c2 = fn(_index(layers, i), first + i, x, c)
        caches.append(c2)
    return x, (None if mode == "train" else _stack_caches(caches))


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                     device="cuda", lead: Tuple[int, ...] = ()):
    """Empty state of ``lead`` stacked layers, materialised (each layer
    its own storage), on the card unless the caller asks for the CPU."""
    scfg = cfg.ssm
    _, n_heads, conv_dim = _dims(cfg)
    dev = resolve_device(device)
    return {
        "ssm": torch.zeros(lead + (batch, n_heads, scfg.head_dim,
                                   scfg.d_state), dtype=dtype, device=dev),
        "conv": torch.zeros(lead + (batch, scfg.d_conv - 1, conv_dim),
                            dtype=dtype, device=dev),
    }


def mamba_cache_axes():
    return {
        "ssm": ("batch", "heads", "head_dim", "state"),
        "conv": ("batch", "conv", "mlp"),
    }

