"""Plain PyTorch reference of Granite-4.0-H's prefill: the last
position's float32 logits of a batch of prompts.

The model (huggingface.co/ibm-granite/granite-4.0-h-small, the
``granitemoehybrid`` equations of Hugging Face's transformers) at its
published widths, ``num_hidden_layers`` of its ``layer_types``. With rm
the residual multiplier, per layer:

    x <- x + rm * mixer(norm(x))     mixer: Mamba2 or attention, by layer
    x <- x + rm * (moe(norm(x)) + shared(norm(x)))

after x = embed(tokens) * embedding_multiplier, and logits =
norm(x_last) E^T / logits_scaling with E the (tied) embedding.

* Mamba2: [z, x, B, C, dt] = h W_in; xBC = silu(causal depthwise conv
  of width d_conv over the sequence, plus its bias); dt = softplus(dt +
  dt_bias); A = -exp(a_log); per head (P channels, state N, group g of
  the head's B and C) the recurrence h_t = exp(dt_t A) h_(t-1) + dt_t
  x_t B_t^T and y_t = h_t C_t + D x_t, then norm(y * silu(z)) W_out.
  It is evaluated in blocks of positions: within a block each output
  sums the block's earlier inputs through their decays directly, and
  the state carried into the block enters through its decay
  (``_ssm_blocks``); ``ssm_steps`` is the token-by-token recurrence
  itself.
* attention: q = h W_q, k = h W_k, v = h W_v (H query and KV key/value
  heads of size D, query head i reading KV head floor(i KV / H)), no
  position encoding, causal softmax(q k^T * attention_multiplier) v,
  then W_o; the blocked attention of ``bench/reference/lm.py``, its
  fixed 1/sqrt(D) undone by scaling q.
* MoE: router logits h W_r over the E experts; the top k (ties to the
  lower index) weighted by the softmax of their logits; each expert
  e a SwiGLU (silu(h W_gate) * h W_up) W_down, run in a plain loop over
  the experts on the tokens that chose it; the shared expert a SwiGLU of
  its own width on every token.

Departures from the published model, which the program makes too: every
norm is RMSNorm scaled by (1 + w), and the norms inside the blocks (the
mixers', the MoE block's and Mamba2's gated norm) take eps 1e-6; the
final norm takes ``rms_norm_eps``.

Everything is float32 with matrix products outside TF32; weights are
cast to float32 one layer at a time. ``quant`` (the control) rounds both
operands of every product to another format first.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from bench.reference.lm import Quant, _attention, _mm, _rms

MAMBA_KEYS = ("mamba_norm", "w_in", "conv_w", "conv_b", "a_log", "dt_bias",
              "d_skip", "out_norm", "w_out")
ATTN_KEYS = ("attn_norm", "wq", "wk", "wv", "wo")
MOE_KEYS = ("moe_norm", "router", "w_gate", "w_up", "w_down", "shared_gate",
            "shared_up", "shared_down")
SSM_BLOCK = 256


def _layer(w, keys, i):
    return {k: w[k][i].float() for k in keys}


def _heads(t, n):
    """(B, S, n·D) -> (B, S, n, D)."""
    return t.reshape(t.shape[0], t.shape[1], n, -1)


def ssm_steps(x, dt, A, B, C):
    """The recurrence one position at a time: x (Bt, S, H, P), dt (Bt, S,
    H), A (H,), B and C (Bt, S, G, N) -> y (Bt, S, H, P) without the
    skip."""
    bt, s, h, p = x.shape
    rep = h // B.shape[2]
    Bh, Ch = B.repeat_interleave(rep, 2), C.repeat_interleave(rep, 2)
    state = x.new_zeros((bt, h, p, B.shape[-1]))
    ys = []
    for t in range(s):
        state = (torch.exp(dt[:, t] * A)[..., None, None] * state
                 + (dt[:, t, :, None] * x[:, t])[..., None]
                 * Bh[:, t, :, None, :])
        ys.append(state @ Ch[:, t, :, :, None])
    return torch.stack(ys, 1).squeeze(-1)


def _ssm_blocks(x, dt, A, B, C, block: int = SSM_BLOCK):
    """The same recurrence evaluated ``block`` positions at a time."""
    bt, s, h, p = x.shape
    rep = h // B.shape[2]
    Bh, Ch = B.repeat_interleave(rep, 2), C.repeat_interleave(rep, 2)
    state = x.new_zeros((bt, h, p, B.shape[-1]))
    out = torch.empty_like(x)
    for t0 in range(0, s, block):
        t1 = min(t0 + block, s)
        n = t1 - t0
        la = torch.cumsum(dt[:, t0:t1] * A, dim=1)           # (Bt, n, H)
        # decay from position u to position t of the block, t >= u
        gap = la[:, :, None, :] - la[:, None, :, :]          # (Bt, t, u, H)
        live = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()
        decay = torch.exp(gap.masked_fill(~live[None, :, :, None],
                                          float("-inf")))
        cb = torch.einsum("bthn,buhn->btuh", Ch[:, t0:t1], Bh[:, t0:t1])
        wgt = decay * cb * dt[:, None, t0:t1, :]             # (Bt, t, u, H)
        y = torch.einsum("btuh,buhp->bthp", wgt, x[:, t0:t1])
        y = y + torch.einsum("bthn,bhpn->bthp", Ch[:, t0:t1], state) \
            * torch.exp(la)[..., None]
        out[:, t0:t1] = y
        to_end = torch.exp(la[:, -1:, :] - la) * dt[:, t0:t1]   # (Bt, n, H)
        state = (torch.exp(la[:, -1])[..., None, None] * state
                 + torch.einsum("buh,buhp,buhn->bhpn", to_end, x[:, t0:t1],
                                Bh[:, t0:t1]))
    return out


def _conv(xbc, w, b):
    """Causal depthwise conv of width K over the sequence, plus bias."""
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    return sum(pad[:, i:i + s] * w[i] for i in range(k)) + b


def _mamba(p, x, c, quant: Quant):
    d = c["hidden_size"]
    d_in = c["mamba_expand"] * d
    hh, ph = c["mamba_n_heads"], c["mamba_d_head"]
    gn = c["mamba_n_groups"] * c["mamba_d_state"]
    b, s, _ = x.shape
    proj = _mm(_rms(x, p["mamba_norm"], 1e-6), p["w_in"], quant)
    z, xbc, dt = torch.split(proj, [d_in, d_in + 2 * gn, hh], dim=-1)
    xbc = F.silu(_conv(xbc, p["conv_w"], p["conv_b"]))
    xs, B, C = torch.split(xbc, [d_in, gn, gn], dim=-1)
    xs = xs.reshape(b, s, hh, ph)
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["a_log"])
    grp = (b, s, c["mamba_n_groups"], c["mamba_d_state"])
    y = _ssm_blocks(xs, dt, A, B.reshape(grp), C.reshape(grp))
    y = (y + p["d_skip"][:, None] * xs).reshape(b, s, d_in)
    y = _rms(y * F.silu(z), p["out_norm"], 1e-6)
    return _mm(y, p["w_out"], quant)


def _attn(p, x, c, quant: Quant, block: int):
    d, h, kv = (c["hidden_size"], c["num_attention_heads"],
                c["num_key_value_heads"])
    hd = d // h
    a = _rms(x, p["attn_norm"], 1e-6)
    q = _heads(_mm(a, p["wq"].reshape(d, -1), quant), h)
    k = _heads(_mm(a, p["wk"].reshape(d, -1), quant), kv)
    v = _heads(_mm(a, p["wv"].reshape(d, -1), quant), kv)
    q = q * (c["attention_multiplier"] * math.sqrt(hd))
    o = _attention(q, k, v, None, quant, block)
    return _mm(o.reshape(x.shape[0], x.shape[1], -1),
               p["wo"].reshape(-1, d), quant)


def _swiglu(h, wg, wu, wd, quant: Quant):
    return _mm(F.silu(_mm(h, wg, quant)) * _mm(h, wu, quant), wd, quant)


def _moe(p, x, c, quant: Quant):
    b, s, d = x.shape
    k = c["num_experts_per_tok"]
    h = _rms(x, p["moe_norm"], 1e-6).reshape(b * s, d)
    logits = _mm(h, p["router"], quant)
    ranked = torch.sort(logits, dim=-1, descending=True, stable=True)
    top = ranked.indices[:, :k]
    gates = torch.softmax(ranked.values[:, :k], dim=-1)
    out = torch.zeros_like(h)
    for e in range(c["num_local_experts"]):
        tok, j = torch.nonzero(top == e, as_tuple=True)
        if tok.numel():
            ye = _swiglu(h[tok], p["w_gate"][e], p["w_up"][e],
                         p["w_down"][e], quant)
            out.index_add_(0, tok, gates[tok, j, None] * ye)
    out = out + _swiglu(h, p["shared_gate"], p["shared_up"],
                        p["shared_down"], quant)
    return out.reshape(b, s, d)


def last_logits(weights: Dict[str, torch.Tensor], cfg: Dict, tokens,
                quant: Quant = None, block: int = 1024) -> torch.Tensor:
    """(B, V) float32 logits at the last position of ``tokens`` (B, S).

    ``weights`` holds "embed" (V, d), the Mamba2 layers' stacked
    ``MAMBA_KEYS``, the attention layers' ``ATTN_KEYS`` and every layer's
    ``MOE_KEYS`` (the layout of ``bench/drivers/hybrid_moe_prefill``),
    and "final_norm" (d,)."""
    prev = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return _last_logits(weights, cfg, tokens, quant, block)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev


def _last_logits(w, c, tokens, quant: Quant, block: int):
    rm = c["residual_multiplier"]
    x = w["embed"][tokens.long()].float() * c["embedding_multiplier"]
    seen = {"mamba": 0, "attention": 0}
    for i, kind in enumerate(c["layer_types"][:c["num_hidden_layers"]]):
        j = seen[kind]
        seen[kind] += 1
        if kind == "mamba":
            x = x + rm * _mamba(_layer(w, MAMBA_KEYS, j), x, c, quant)
        else:
            x = x + rm * _attn(_layer(w, ATTN_KEYS, j), x, c, quant, block)
        x = x + rm * _moe(_layer(w, MOE_KEYS, i), x, c, quant)
    f = _rms(x[:, -1], w["final_norm"].float(), c["rms_norm_eps"])
    return _mm(f, w["embed"].float().t(), quant) / c["logits_scaling"]
