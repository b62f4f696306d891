"""Wrapper of the flash attention forward kernel (K8).

``flash_attention(q, k, v, window=...)`` is the port of
``repro.kernels.flash_attention.ops.flash_attention``: causal GQA
self-attention with an optional sliding window, q (B, S, H, D) and k, v
(B, S, KV, D) in the model's own layout, output (B, S, H, D) in
``q.dtype``. The softmax scale defaults to 1/√D, the reference's only
one; ``scale`` sets another (Granite-4.0-H's ``attention_multiplier``).
As in the reference, positions are 0..S-1 (a prefill from
scratch; the reference's wrapper takes ``pos_q``/``pos_kv`` and does not
read them, this one does not take them). For CPU tensors it
runs the plain version (``ref.py``); for CUDA tensors it launches
``csrc/flash_attention.cu`` once for the whole (B, H, S) or raises. A
running cost trace records each launch (``common.cost_trace``); on
``meta`` tensors inside one (the dry run) the kernel is recorded and not
run, and outside one they raise.

Which kernel runs is a rule of the shape (``kernel_for``), not a
fallback: bfloat16 at a head dim that is a multiple of 16 from 64 to 256
(every LM config of the port: 64, 80, 96, 128, 240) takes the Hopper
kernel (TMA and wgmma); bfloat16 at any other head dim (below 64 or not a
multiple of 16, such as the smoke configs' 20, 24 and 30) takes the
``mma.sync`` kernel, and float32 the FMA kernel. A Hopper launch that
fails raises; it never falls back to another kernel.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.common.cost_trace import kernel_launch
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

counter = _build.LaunchCounter("flash_attention")

MAX_HEAD_DIM = 256
HOPPER_MIN_HEAD_DIM = 64      # the Hopper kernel: D a multiple of
HOPPER_HEAD_DIM_STEP = 16     # HOPPER_HEAD_DIM_STEP in [64, MAX_HEAD_DIM]
_ENTRIES = {"hopper": "flash_attention_bf16_hopper",
            "mma_sync": "flash_attention_bf16",
            "fma": "flash_attention_f32"}


def kernel_for(dtype: torch.dtype, head_dim: int) -> str:
    """Which kernel ``launch`` runs: "hopper" (TMA + wgmma) for bfloat16 at
    a head dim that is a multiple of 16 from 64 to 256, "mma_sync" for
    bfloat16 at any other head dim, "fma" for float32."""
    if dtype == torch.bfloat16:
        hopper = (HOPPER_MIN_HEAD_DIM <= head_dim <= MAX_HEAD_DIM
                  and head_dim % HOPPER_HEAD_DIM_STEP == 0)
        return "hopper" if hopper else "mma_sync"
    if dtype == torch.float32:
        return "fma"
    raise ValueError(f"flash_attention takes bfloat16 or float32, got "
                     f"{dtype}")


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, window: Optional[int],
           kernel: Optional[str] = None,
           scale: Optional[float] = None) -> torch.Tensor:
    """Launch the kernel on contiguous CUDA operands of one dtype
    (bfloat16 or float32): q, out (B, S, H, D); k, v (B, S, KV, D); the
    scores scaled by ``scale``, 1/√D when None.
    ``kernel`` defaults to ``kernel_for``'s choice; naming "mma_sync" for
    a Hopper shape is for a run that times the two designs against each
    other, and that launch is not counted."""
    b, s, h, d = q.shape
    n_kv = k.shape[2]
    rule = kernel_for(q.dtype, d)
    kernel = rule if kernel is None else kernel
    if kernel != rule and not (kernel == "mma_sync" and rule == "hopper"):
        raise ValueError(f"kernel {kernel!r} does not take {q.dtype} at head "
                         f"dim {d}")
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
    if not kernel_launch("flash_attention",
                         4 * d * attention_pairs(s, window) * b * h,
                         (q, k, v), (out,)):
        return out
    if kernel == "hopper" and (any(t.data_ptr() % 16 for t in (q, k, v))
                               or out.data_ptr() % 4):
        raise ValueError("the Hopper kernel reads q, k, v by TMA from "
                         "16-byte aligned data and writes out in 4-byte "
                         "pairs")
    fn = getattr(_build.library(), _ENTRIES[kernel])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             b, s, h, n_kv, d, 0 if window is None else int(window),
             _scale(scale, d), _build.current_stream_handle(q.device))
    _build.check(err, f"flash_attention ({kernel})")
    if kernel == rule:
        counter.count += 1
    return out


def _scale(scale: Optional[float], d: int) -> float:
    return 1.0 / math.sqrt(d) if scale is None else float(scale)


def attention_pairs(s: int, window: Optional[int]) -> int:
    """(query, key) pairs a causal attention over ``s`` positions scores,
    with an optional sliding window: K8's bound counts 4·D FLOPs per pair
    and query head (QKᵀ and PV)."""
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Causal self-attention, q (B, S, H, D), k, v (B, S, KV, D), the
    scores scaled by ``scale`` (1/√D when None)."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: expected (B, S, H, D) and "
                         f"(B, S, KV, D)")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, window=window, scale=scale)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {q.device}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return launch(q, k, v, torch.empty_like(q), window, scale=scale)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *,
                              window: Optional[int] = None,
                              scale: Optional[float] = None) -> torch.Tensor:
    """``flash_attention`` through its plain version, on q's device (the
    reference's oracle name)."""
    return flash_attention_ref(q, k, v, window=window, scale=scale)
