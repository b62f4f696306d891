"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory).

Port of ``repro.models.xlstm``. The mLSTM runs in chunkwise form (the
intra-chunk quadratic / inter-chunk state structure of SSD) with the
exp-input-gate stabiliser m carried across chunks; decode is the O(1)
recurrent update. The sLSTM has recurrent (hidden-to-gate) connections,
so it is sequential by construction: a loop over time, one host step per
token per layer (the reference's ``lax.scan``).

Block pattern (xlstm-1.3b): every ``slstm_every``-th block is an sLSTM;
the stack runs as super-blocks of (slstm_every - 1 mLSTM + 1 sLSTM), the
mLSTM parameters stacked (n_super, per_super, ...) and the sLSTM's
(n_super, ...).

The reference's simplifications stand (its DESIGN.md §3.5): no short
causal conv in front of q/k, no per-block learnable skip scales; exp
input gate and sigmoid forget gate. Its maxima are ``jnp.max``, whose
gradient splits ties evenly, as ``torch.amax`` does; the sLSTM's FFN
uses the tanh GELU of ``jax.nn.gelu``.

Caches: a prefill returns C, n (mLSTM) and c, n, h (sLSTM) in bfloat16
and m in float32 (the reference's casts); a decode step returns new
tensors and leaves its input cache alone.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.config import ModelConfig
from repro_torch.common.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.params import ParamSpec
from repro_torch.models.transformer import (
    _index, _remat, _stack, _stack_caches, embed_inputs,
)

CHUNK = 256


def _dims(cfg: ModelConfig):
    d_in = int(cfg.xlstm.proj_factor_mlstm * cfg.d_model)
    dh = d_in // cfg.n_heads
    return d_in, dh


# --------------------------------------------------------------------------
# specs
# --------------------------------------------------------------------------

def mlstm_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    h = cfg.n_heads
    d_in, dh = _dims(cfg)
    return {
        "norm": ParamSpec((d,), "zeros", axes=("embed",)),
        "w_up": ParamSpec((d, d_in), axes=("embed", "mlp")),
        "w_gate_out": ParamSpec((d, d_in), axes=("embed", "mlp")),
        "wq": ParamSpec((d_in, h, dh), axes=("mlp", "heads", "head_dim")),
        "wk": ParamSpec((d_in, h, dh), axes=("mlp", "heads", "head_dim")),
        "wv": ParamSpec((d_in, h, dh), axes=("mlp", "heads", "head_dim")),
        "w_if": ParamSpec((d_in, h, 2), scale=0.02,
                          axes=("mlp", "heads", None)),
        "b_if": ParamSpec((h, 2), "zeros", axes=("heads", None)),
        "out_norm": ParamSpec((d_in,), "zeros", axes=("mlp",)),
        "w_down": ParamSpec((d_in, d), axes=("mlp", "embed")),
    }


def slstm_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    f = int(cfg.xlstm.proj_factor_slstm * d)
    return {
        "norm": ParamSpec((d,), "zeros", axes=("embed",)),
        # 4 gates (z, i, f, o), input + recurrent (block-diagonal per head)
        "w_gates": ParamSpec((d, 4, h, dh),
                             axes=("embed", None, "heads", "head_dim")),
        "r_gates": ParamSpec((4, h, dh, dh), scale=0.02,
                             axes=(None, "heads", "head_dim", None)),
        "b_gates": ParamSpec((4, h, dh), "zeros",
                             axes=(None, "heads", "head_dim")),
        "out_norm": ParamSpec((d,), "zeros", axes=("embed",)),
        "w_up": ParamSpec((d, f), axes=("embed", "mlp")),
        "w_down": ParamSpec((f, d), axes=("mlp", "embed")),
    }


# --------------------------------------------------------------------------
# mLSTM chunkwise forward
# --------------------------------------------------------------------------

def _mlstm_chunked(q, k, v, log_i, log_f, state=None):
    """q, k, v (B, S, H, D) float32 (k pre-scaled by 1/√D); log_i, log_f
    (B, S, H). Chunks of ``CHUNK`` steps, or one whole-sequence chunk when
    ``CHUNK`` does not divide S (the reference's rule).

    Returns y (B, S, H, D) and the final state (C̃ (B, H, D, D), ñ (B, H,
    D), m (B, H)). Inside a chunk the work is laid out (B, H, t, s), so
    every product is a batched matmul over (B, H)."""
    b, s, h, d = q.shape
    chunk = CHUNK if s % CHUNK == 0 else s
    nc = s // chunk
    dev = q.device

    # (b, h, nc, l, ...) head-major
    qc = q.reshape(b, nc, chunk, h, d).permute(0, 3, 1, 2, 4)
    kc = k.reshape(b, nc, chunk, h, d).permute(0, 3, 1, 2, 4)
    vc = v.reshape(b, nc, chunk, h, d).permute(0, 3, 1, 2, 4)
    li = log_i.float().reshape(b, nc, chunk, h).permute(0, 3, 1, 2)
    lf = log_f.float().reshape(b, nc, chunk, h).permute(0, 3, 1, 2)
    a = torch.cumsum(lf, dim=-1)                 # (b,h,nc,l) decay from start

    if state is None:
        C_in = torch.zeros((b, h, d, d), dtype=torch.float32, device=dev)
        n_in = torch.zeros((b, h, d), dtype=torch.float32, device=dev)
        m_in = torch.full((b, h), -1e30, dtype=torch.float32, device=dev)
    else:
        C_in, n_in, m_in = state

    idx = torch.arange(chunk, device=dev)
    causal = idx[:, None] >= idx[None, :]
    ys = []
    for c in range(nc):
        q_i, k_i, v_i = qc[:, :, c], kc[:, :, c], vc[:, :, c]   # (b,h,l,d)
        a_i, li_i = a[:, :, c], li[:, :, c]                     # (b,h,l)
        aend_i = a_i[..., -1]                                   # (b,h)
        # intra-chunk log weights w[t, s] = a[t] - a[s] + li[s] (s <= t)
        logw = a_i[..., :, None] - a_i[..., None, :] + li_i[..., None, :]
        logw = logw.masked_fill(~causal, float("-inf"))         # (b,h,t,s)
        m_intra = torch.amax(logw, dim=-1)                      # (b,h,t)
        m_inter = a_i + m_in[..., None]
        m_tot = torch.maximum(torch.maximum(m_intra, m_inter),
                              torch.full_like(m_intra, -1e30))

        w = torch.exp(logw - m_tot[..., None])
        scores = (q_i @ k_i.transpose(-1, -2)) * w              # (b,h,t,s)
        num = scores @ v_i                                      # (b,h,t,d)
        den = scores.sum(dim=-1)                                # (b,h,t)

        inter_scale = torch.exp(m_inter - m_tot)                # (b,h,t)
        num = num + (q_i @ C_in) * inter_scale[..., None]
        den = den + (q_i @ n_in[..., None]).squeeze(-1) * inter_scale
        ys.append(num / torch.maximum(torch.abs(den),
                                      torch.exp(-m_tot))[..., None])

        # state update to the chunk's end
        decay_in = aend_i[..., None] - a_i + li_i               # (b,h,s)
        m_out = torch.maximum(m_in + aend_i, torch.amax(decay_in, dim=-1))
        carry_scale = torch.exp(m_in + aend_i - m_out)          # (b,h)
        kw = torch.exp(decay_in - m_out[..., None])[..., None] * k_i
        C_in = (C_in * carry_scale[..., None, None]
                + kw.transpose(-1, -2) @ v_i)
        n_in = n_in * carry_scale[..., None] + kw.sum(dim=-2)
        m_in = m_out
    y = torch.stack(ys, dim=2)                                  # (b,h,nc,l,d)
    y = y.permute(0, 2, 3, 1, 4).reshape(b, s, h, d)
    return y, (C_in, n_in, m_in)


def _mlstm_decode(q, k, v, log_i, log_f, state):
    """One recurrent mLSTM step. q, k, v (B, H, D); gates (B, H)."""
    C, n, m = state
    m_new = torch.maximum(log_f + m, log_i)
    f_s = torch.exp(log_f + m - m_new)
    i_s = torch.exp(log_i - m_new)
    C = C * f_s[..., None, None] + i_s[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n = n * f_s[..., None] + i_s[..., None] * k
    num = (q[..., None, :] @ C).squeeze(-2)                     # (B,H,D)
    den = torch.abs((q * n).sum(dim=-1))
    y = num / torch.maximum(den, torch.exp(-m_new))[..., None]
    return y, (C, n, m_new)


def _heads_proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhe->bshe", x, w) as one matmul."""
    d, h, e = w.shape
    return (x @ w.reshape(d, h * e).to(x.dtype)).unflatten(-1, (h, e))


def mlstm_apply(p, x: torch.Tensor, cfg: ModelConfig, *, mode="train",
                cache=None):
    d_in, dh = _dims(cfg)
    hid = L.rms_norm(x, p["norm"], 1e-6)
    up = hid @ p["w_up"].to(x.dtype)
    gate = F.silu(hid @ p["w_gate_out"].to(x.dtype))

    q = _heads_proj(up, p["wq"])
    k = _heads_proj(up, p["wk"]) / math.sqrt(dh)
    v = _heads_proj(up, p["wv"])
    gates = _heads_proj(up, p["w_if"]) + p["b_if"].to(x.dtype)
    log_i = gates[..., 0].float()                            # exp input gate
    log_f = F.logsigmoid(gates[..., 1].float())

    if mode == "decode":
        state = (cache["C"].float(), cache["n"].float(), cache["m"].float())
        y, (C, n_, m_) = _mlstm_decode(
            q[:, 0].float(), k[:, 0].float(), v[:, 0].float(),
            log_i[:, 0], log_f[:, 0], state)
        y = y[:, None]                                       # (B,1,H,D)
        new_cache = {"C": C.to(cache["C"].dtype),
                     "n": n_.to(cache["n"].dtype), "m": m_}
    else:
        state = None
        if cache is not None:
            state = (cache["C"].float(), cache["n"].float(),
                     cache["m"].float())
        y, (C, n_, m_) = _mlstm_chunked(q.float(), k.float(), v.float(),
                                        log_i, log_f, state)
        new_cache = None
        if mode == "prefill":
            new_cache = {"C": C.to(torch.bfloat16),
                         "n": n_.to(torch.bfloat16), "m": m_}

    y = y.reshape(x.shape[0], -1, d_in).to(x.dtype)
    y = L.rms_norm(y, p["out_norm"], 1e-6) * gate
    return x + y @ p["w_down"].to(x.dtype), new_cache


# --------------------------------------------------------------------------
# sLSTM (a loop over time: the true recurrence)
# --------------------------------------------------------------------------

def slstm_apply(p, x: torch.Tensor, cfg: ModelConfig, *, mode="train",
                cache=None):
    b, s, d = x.shape
    h_heads = cfg.n_heads
    dh = d // h_heads
    hid = L.rms_norm(x, p["norm"], 1e-6)
    # the input's contribution to all 4 gates: (B, S, 4, H, dh)
    w = p["w_gates"]
    gx = (hid @ w.reshape(d, -1).to(x.dtype)).unflatten(-1, w.shape[1:])
    gx = (gx + p["b_gates"].to(x.dtype)).float()

    if cache is not None:
        c, n, hh, m = (cache[k].float() for k in ("c", "n", "h", "m"))
    else:
        z0 = torch.zeros((b, h_heads, dh), dtype=torch.float32,
                         device=x.device)
        c, n, hh, m = z0, torch.ones_like(z0), z0, z0

    r = p["r_gates"].float()                        # (4, H, dh, dh)
    hs = []
    for t in range(s):
        # einsum("bhe,ghef->bghf", hh, r): (B,1,H,1,e) @ (4,H,e,f)
        gr = (hh[:, None, :, None, :] @ r).squeeze(-2)      # (B,4,H,dh)
        g = gx[:, t] + gr
        z = torch.tanh(g[:, 0])
        i_t = g[:, 1]
        f_t = F.logsigmoid(g[:, 2])
        o = torch.sigmoid(g[:, 3])
        m_new = torch.maximum(f_t + m, i_t)
        i_s = torch.exp(i_t - m_new)
        f_s = torch.exp(f_t + m - m_new)
        c = f_s * c + i_s * z
        n = f_s * n + i_s
        hh = o * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(hh)
    y = torch.stack(hs, dim=1).reshape(b, s, d).to(x.dtype)
    y = L.rms_norm(y, p["out_norm"], 1e-6)
    x = x + y
    # feed-forward
    hmlp = F.gelu(L.rms_norm(x, torch.zeros_like(p["out_norm"]), 1e-6)
                  @ p["w_up"].to(x.dtype), approximate="tanh")
    x = x + hmlp @ p["w_down"].to(x.dtype)

    new_cache = None
    if mode in ("prefill", "decode"):
        new_cache = {"c": c.to(torch.bfloat16), "n": n.to(torch.bfloat16),
                     "h": hh.to(torch.bfloat16), "m": m}
    return x, new_cache


# --------------------------------------------------------------------------
# trunk: super-blocks of (slstm_every - 1 mLSTM + 1 sLSTM)
# --------------------------------------------------------------------------

def _layout(cfg: ModelConfig) -> Tuple[int, int]:
    k = cfg.xlstm.slstm_every
    if cfg.n_layers % k:
        raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of "
                         f"slstm_every = {k}")
    return cfg.n_layers // k, k - 1     # (n_super, mlstm_per_super)


def xlstm_trunk_specs(cfg: ModelConfig) -> Dict:
    n_super, m_per = _layout(cfg)
    return {
        "embed": ParamSpec((cfg.vocab_size, cfg.d_model), "embed",
                           axes=("vocab", "embed")),
        "mlstm": _stack(_stack(mlstm_specs(cfg), m_per), n_super),
        "slstm": _stack(slstm_specs(cfg), n_super),
    }


def xlstm_trunk_apply(params, tokens, cfg: ModelConfig, *, positions=None,
                      mode: str = "train", cache=None, cache_len=None,
                      param_hook=None):
    """Returns (hidden, aux = 0, new_cache). ``param_hook(params, klass,
    *tags)`` sees the embedding as "embed", mLSTM i of super-block si as
    ("mlstm", si, i) and the sLSTM closing it as ("slstm", si), inside
    each block's remat boundary in training. The cache is {"mlstm":
    stacked (n_super, per_super, ...), "slstm": stacked (n_super, ...)}."""
    n_super, m_per = _layout(cfg)
    x = embed_inputs(params, tokens, cfg, param_hook)

    def m_fn(lp, si, i, h, c):
        if param_hook is not None:
            lp = param_hook(lp, "mlstm", si, i)
        return mlstm_apply(lp, h, cfg, mode=mode, cache=c)

    def s_fn(lp, si, h, c):
        if param_hook is not None:
            lp = param_hook(lp, "slstm", si)
        return slstm_apply(lp, h, cfg, mode=mode, cache=c)

    if mode == "train":
        m_fn, s_fn = _remat(m_fn, cfg), _remat(s_fn, cfg)
    decode = mode == "decode"
    nc_m, nc_s = [], []
    for si in range(n_super):
        lp_m = _index(params["mlstm"], si)
        inner = []
        for i in range(m_per):
            c = _index(_index(cache["mlstm"], si), i) if decode else None
            x, c2 = m_fn(_index(lp_m, i), si, i, x, c)
            inner.append(c2)
        c = _index(cache["slstm"], si) if decode else None
        x, c2 = s_fn(_index(params["slstm"], si), si, x, c)
        nc_m.append(inner)
        nc_s.append(c2)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if mode == "train":
        return x, aux, None
    return x, aux, {"mlstm": _stack_caches([_stack_caches(c) for c in nc_m]),
                    "slstm": _stack_caches(nc_s)}


# --------------------------------------------------------------------------
# caches
# --------------------------------------------------------------------------

def init_mlstm_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                     device="cuda", lead: Tuple[int, ...] = ()):
    _, dh = _dims(cfg)
    h = cfg.n_heads
    dev = resolve_device(device)
    return {
        "C": torch.zeros(lead + (batch, h, dh, dh), dtype=dtype, device=dev),
        "n": torch.zeros(lead + (batch, h, dh), dtype=dtype, device=dev),
        "m": torch.full(lead + (batch, h), -1e30, dtype=torch.float32,
                        device=dev),
    }


def init_slstm_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                     device="cuda", lead: Tuple[int, ...] = ()):
    h = cfg.n_heads
    shape = lead + (batch, h, cfg.d_model // h)
    dev = resolve_device(device)
    return {
        "c": torch.zeros(shape, dtype=dtype, device=dev),
        "n": torch.ones(shape, dtype=dtype, device=dev),
        "h": torch.zeros(shape, dtype=dtype, device=dev),
        "m": torch.zeros(shape, dtype=torch.float32, device=dev),
    }


def init_xlstm_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                     device="cuda"):
    """Empty stacked caches, materialised (each layer its own storage),
    on the card unless the caller asks for the CPU."""
    n_super, m_per = _layout(cfg)
    return {
        "mlstm": init_mlstm_cache(cfg, batch, dtype, device,
                                  (n_super, m_per)),
        "slstm": init_slstm_cache(cfg, batch, dtype, device, (n_super,)),
    }


def mlstm_cache_axes():
    return {"C": ("batch", "heads", "head_dim", "state"),
            "n": ("batch", "heads", "head_dim"),
            "m": ("batch", "heads")}


def slstm_cache_axes():
    return {k: ("batch", "heads", "head_dim") for k in ("c", "n", "h", "m")}


def xlstm_cache_axes():
    m = {k: ("layer", "layer") + v for k, v in mlstm_cache_axes().items()}
    s = {k: ("layer",) + v for k, v in slstm_cache_axes().items()}
    return {"mlstm": m, "slstm": s}
