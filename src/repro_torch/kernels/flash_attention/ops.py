"""Wrapper of the flash attention forward kernel (K8).

``flash_attention(q, k, v, window=...)`` is the port of
``repro.kernels.flash_attention.ops.flash_attention``: causal GQA
self-attention with an optional sliding window, q (B, S, H, D) and k, v
(B, S, KV, D) in the model's own layout, output (B, S, H, D) in
``q.dtype``. As in the reference, positions are 0..S-1 (a prefill from
scratch; the reference's wrapper takes ``pos_q``/``pos_kv`` and does not
read them, this one does not take them). For CPU tensors it
runs the plain version (``ref.py``); for CUDA tensors it launches
``csrc/flash_attention.cu`` once for the whole (B, H, S) or raises.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

counter = _build.LaunchCounter("flash_attention")

MAX_HEAD_DIM = 256
_ENTRIES = {torch.bfloat16: "flash_attention_bf16",
            torch.float32: "flash_attention_f32"}


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, window: Optional[int]) -> torch.Tensor:
    """Launch the kernel on contiguous CUDA operands of one dtype
    (bfloat16 or float32): q, out (B, S, H, D); k, v (B, S, KV, D)."""
    b, s, h, d = q.shape
    n_kv = k.shape[2]
    if q.dtype not in _ENTRIES:
        raise ValueError(f"flash_attention takes bfloat16 or float32, got "
                         f"{q.dtype}")
    if not 1 <= d <= MAX_HEAD_DIM or n_kv < 1 or h % n_kv:
        raise ValueError(f"head dim {d} (1..{MAX_HEAD_DIM}) and heads "
                         f"{h} over {n_kv} KV heads are not supported")
    for name, t, shape in (("q", q, (b, s, h, d)), ("k", k, (b, s, n_kv, d)),
                           ("v", v, (b, s, n_kv, d)),
                           ("out", out, (b, s, h, d))):
        if (t.dtype != q.dtype or t.device != q.device
                or not t.is_contiguous() or tuple(t.shape) != shape):
            raise ValueError(f"{name} must be a contiguous {q.dtype} CUDA "
                             f"tensor of shape {shape}")
    if out.numel() == 0:
        return out
    fn = getattr(_build.library(), _ENTRIES[q.dtype])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             b, s, h, n_kv, d, 0 if window is None else int(window),
             1.0 / math.sqrt(d), _build.current_stream_handle(q.device))
    _build.check(err, "flash_attention")
    counter.count += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: Optional[int] = None) -> torch.Tensor:
    """Causal self-attention, q (B, S, H, D), k, v (B, S, KV, D)."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: expected (B, S, H, D) and "
                         f"(B, S, KV, D)")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return launch(q, k, v, torch.empty_like(q), window)
