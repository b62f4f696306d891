"""Shared layers of the dense LM: RMSNorm, RoPE, MLP, GQA attention.

Port of ``repro.models.layers``. Shapes are the reference's: q (B, Sq,
H, D); k, v (B, Skv, KV, D), query heads grouped over KV heads.
``attention(impl=...)`` dispatches (``ModelConfig.attn_impl``):

* ``pallas``  — the flash attention kernel K8
  (``repro_torch.kernels.flash_attention``), the serving hot path;
* ``naive``   — full (Sq, Skv) score matrix, the plain oracle;
* ``blocked`` — the reference's training attention, an online softmax
  over (query block, key block) pairs in plain PyTorch with autograd:
  a loop over query blocks, each scanning the key blocks; with a
  sliding window each query block reads only a band of keys of static
  width. Each key block's update is recomputed in the backward
  (``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` on the
  scan body), so no (bq × bkv) probabilities are kept for every pair;
* ``folded``  — causal blocked attention over the exact lower triangle:
  query block p is paired with block nq-1-p, whose key needs add up to
  nq+1 blocks. It falls back to ``blocked`` on the reference's shape
  conditions (a window, Sq ≠ Skv, a ragged or odd block count).

Masked scores are the reference's finite -1e30, and a row's running
maximum never falls below it: a key block that the window masks whole
then gives exp(m_old − m_new) = 0 rather than NaN, in the gradient too.
Every path scales the scores by ``scale``: 1/√D when None (the
reference's only scale), or another softmax scale (Granite-4.0-H's
``attention_multiplier``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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


def _scale(scale: Optional[float], d: int) -> float:
    return 1.0 / math.sqrt(d) if scale is None else scale


def naive_attention(q, k, v, *, pos_q, pos_kv, window=None, scale=None):
    """Full-matrix attention: float32 scores and softmax, probabilities
    cast to ``q.dtype`` before PV, as the reference does."""
    b, sq, h, d = q.shape
    n_kv = k.shape[2]
    qg = q.reshape(b, sq, n_kv, h // n_kv, d)
    scale = _scale(scale, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    scores = scores.masked_fill(~_mask_block(pos_q, pos_kv, window),
                                NEG_INF)
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(p.dtype))
    return out.reshape(b, sq, h, d)


def decode_attention(q, k_cache, v_cache, *, pos_q, pos_kv, window=None,
                     scale=None):
    """q (B, 1, H, D) against caches (B, L, KV, D); pos_kv (B, L) holds
    each slot's absolute position, -1 for an empty slot. Masking is
    positional, so ring-buffer slot order does not matter."""
    b, _, h, d = q.shape
    n_kv = k_cache.shape[2]
    qg = q.reshape(b, 1, n_kv, h // n_kv, d)
    scale = _scale(scale, d)
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


# --------------------------------------------------------------------------
# blocked online-softmax attention (the training path)
# --------------------------------------------------------------------------

def _gqa_scores(q, k, scale: float) -> torch.Tensor:
    """q (B, Sq, KV, G, D), k (B, Skv, KV, D) -> (B, KV, G, Sq, Skv),
    float32."""
    return torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) * scale


def _online_block(m, l, acc, q_blk, k_blk, v_blk, mask_blk, scale: float):
    """One online-softmax update of a query block's (m, l, acc) by one
    key block."""
    s = _gqa_scores(q_blk, k_blk, scale)                # (B,KV,G,bq,bkv)
    s = s.masked_fill(~mask_blk, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    # a row with no live key yet keeps a finite maximum
    m_new = torch.maximum(m_new, torch.full_like(m_new, NEG_INF))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * alpha + p.sum(dim=-1)
    acc_new = acc * alpha[..., None] + torch.einsum(
        "bkgqs,bskd->bkgqd", p, v_blk.float())
    return m_new, l_new, acc_new


def _remat_update(*args):
    """``_online_block``, recomputed in the backward when autograd
    records."""
    if torch.is_grad_enabled():
        return checkpoint(_online_block, *args, use_reentrant=False)
    return _online_block(*args)


def _init_carry(b, n_kv, g, bq, d, device):
    return (torch.full((b, n_kv, g, bq), -math.inf, device=device),
            torch.zeros((b, n_kv, g, bq), device=device),
            torch.zeros((b, n_kv, g, bq, d), device=device))


def _finish(m, l, acc) -> torch.Tensor:
    """(B, KV, G, bq, D) accumulator normalized by l -> (B, bq, KV, G, D)."""
    out = acc / torch.maximum(l, torch.full_like(l, 1e-30))[..., None]
    return out.permute(0, 3, 1, 2, 4)


def _scan_kv(q_blk, k_seq, v_seq, pos_blk, pos_kv_seq, window, block_kv,
             scale):
    """The online softmax of one query block (B, bq, KV, G, D) over the
    key blocks of k_seq/v_seq (B, Skv', KV, D); (B, bq, KV, G, D)
    float32."""
    b, bq, n_kv, g, d = q_blk.shape
    carry = _init_carry(b, n_kv, g, bq, d, q_blk.device)
    for j in range(k_seq.shape[1] // block_kv):
        sl = slice(j * block_kv, (j + 1) * block_kv)
        mask = _mask_block(pos_blk, pos_kv_seq[sl], window)
        carry = _remat_update(*carry, q_blk, k_seq[:, sl], v_seq[:, sl],
                              mask, scale)
    return _finish(*carry)


def blocked_attention(q, k, v, *, pos_q, pos_kv, window=None,
                      block_q: int = 512, block_kv: int = 1024, scale=None):
    """Flash-style attention in plain PyTorch. With ``window`` set and
    ``window + block_q <= Skv``, each query block scans only a band of
    keys of static width ending at its last position (no rectangle
    waste). Ragged shapes fall back to ``naive_attention``."""
    b, sq, h, d = q.shape
    skv, n_kv = k.shape[1], k.shape[2]
    block_q = min(block_q, sq)
    block_kv = min(block_kv, skv)
    if sq % block_q or skv % block_kv:
        return naive_attention(q, k, v, pos_q=pos_q, pos_kv=pos_kv,
                               window=window, scale=scale)
    scale = _scale(scale, d)
    g, nq = h // n_kv, sq // block_q
    qg = q.reshape(b, nq, block_q, n_kv, g, d)
    pos_qb = pos_q.reshape(nq, block_q)
    band = skv
    if window is not None and window + block_q <= skv:
        band = min(block_kv * -(-(window + block_q) // block_kv), skv)
    outs = []
    for i in range(nq):
        start = min(max(i * block_q + block_q - band, 0), skv - band)
        sl = slice(start, start + band)
        outs.append(_scan_kv(qg[:, i], k[:, sl], v[:, sl], pos_qb[i],
                             pos_kv[sl], window, block_kv, scale))
    out = torch.stack(outs, dim=1)                 # (B, nq, bq, KV, G, D)
    return out.reshape(b, sq, h, d).to(q.dtype)


def blocked_attention_folded(q, k, v, *, pos_q, pos_kv, block: int = 512,
                             scale=None):
    """Causal blocked attention without the rectangle waste: query block
    p is paired with block nq-1-p, and the pair's causal keys take
    exactly nq+1 key blocks, each update computing one (bq × bkv) block
    for whichever member it belongs to. Requires Sq == Skv, divisible by
    ``block``, and an even block count (``attention`` falls back to
    ``blocked_attention`` otherwise)."""
    b, sq, h, d = q.shape
    skv, n_kv = k.shape[1], k.shape[2]
    if sq != skv or sq % block:
        raise ValueError(f"folded attention needs Sq == Skv divisible by "
                         f"{block}, got {sq} and {skv}")
    nq = sq // block
    if nq % 2:
        raise ValueError(f"folded attention needs an even block count, "
                         f"got {nq}")
    g = h // n_kv
    scale = _scale(scale, d)
    qg = q.reshape(b, nq, block, n_kv, g, d)
    pos_qb = pos_q.reshape(nq, block)
    kb = k.reshape(b, nq, block, n_kv, d)
    vb = v.reshape(b, nq, block, n_kv, d)
    pos_kb = pos_kv.reshape(nq, block)
    out = [None] * nq
    for p_idx in range(nq // 2):
        lo, hi = p_idx, nq - 1 - p_idx
        carry = {lo: _init_carry(b, n_kv, g, block, d, q.device),
                 hi: _init_carry(b, n_kv, g, block, d, q.device)}
        for j in range(nq + 1):
            qi, kv_idx = (lo, j) if j <= p_idx else (hi, j - p_idx - 1)
            mask = _mask_block(pos_qb[qi], pos_kb[kv_idx], None)
            carry[qi] = _remat_update(*carry[qi], qg[:, qi], kb[:, kv_idx],
                                      vb[:, kv_idx], mask, scale)
        out[lo], out[hi] = _finish(*carry[lo]), _finish(*carry[hi])
    return torch.stack(out, dim=1).reshape(b, sq, h, d).to(q.dtype)


def attention(q, k, v, *, pos_q, pos_kv, impl: str = "pallas",
              window: Optional[int] = None, block_q: int = 512,
              block_kv: int = 1024, scale: Optional[float] = None):
    """Attention over a whole sequence, dispatched on ``impl``
    (``ModelConfig.attn_impl``), the scores scaled by ``scale`` (1/√D
    when None). The kernel, like the reference's, takes positions to be
    0..S-1."""
    if impl == "pallas":
        return flash_ops.flash_attention(q, k, v, window=window, scale=scale)
    if impl == "naive":
        return naive_attention(q, k, v, pos_q=pos_q, pos_kv=pos_kv,
                               window=window, scale=scale)
    if impl not in ("blocked", "folded"):
        raise ValueError(f"unknown attn_impl {impl!r}")
    sq, skv = q.shape[1], k.shape[1]
    if (impl == "folded" and window is None and sq == skv
            and sq % block_q == 0 and (sq // block_q) % 2 == 0):
        return blocked_attention_folded(q, k, v, pos_q=pos_q, pos_kv=pos_kv,
                                        block=block_q, scale=scale)
    return blocked_attention(q, k, v, pos_q=pos_q, pos_kv=pos_kv,
                             window=window, block_q=block_q,
                             block_kv=block_kv, scale=scale)
