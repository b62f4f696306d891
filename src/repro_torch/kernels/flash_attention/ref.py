"""Plain PyTorch version of the flash attention forward (K8).

Port of ``repro.kernels.flash_attention.ref``: full-matrix GQA
self-attention with causal and optional sliding-window masking, scores,
softmax and PV in float32, the output cast to ``q.dtype``. Masked scores
are -1e30, as in the reference. (This is not ``layers.naive_attention``,
which rounds the probabilities to ``q.dtype`` before PV.)
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, window: Optional[int] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, S, KV, D) with H % KV == 0; scores
    scaled by ``scale``, 1/√D when None."""
    b, sq, h, d = q.shape
    n_kv = k.shape[2]
    qg = q.reshape(b, sq, n_kv, h // n_kv, d)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    pos = torch.arange(sq, device=q.device)
    diff = pos[:, None] - pos[None, :]
    mask = diff >= 0
    if window is not None:
        mask &= diff < window
    scores = scores.masked_fill_(~mask, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    del scores
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)
