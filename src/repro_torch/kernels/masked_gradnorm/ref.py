"""Plain PyTorch version of the masked gradient norm (paper eq. 6).

n_t = ‖ M ∘ g_t ‖₂ per task row, accumulated in float32: the FedGradNorm
input. Port of ``repro.kernels.masked_gradnorm.ref`` generalised to a
leading cluster axis: g (C, T, P) with one mask row per cluster (C, P).
"""
from __future__ import annotations

import torch


def masked_gradnorm_ref(g: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """g: (..., T, P); mask: (..., P) -> (..., T) float32 norms."""
    g32 = g.to(torch.float32)
    m = mask.to(torch.float32).unsqueeze(-2)
    return torch.sqrt(torch.sum((g32 * m) ** 2, dim=-1))
