"""FedGradNorm with the channel-sparsified auxiliary loss (paper Alg. 2,
eqs. 5-6), batched over clusters.

Port of ``repro.core.fedgradnorm``. The reference runs one cluster per
call under ``vmap``; here the cluster axis is written out: every function
takes (C, N) tensors (or (N,) for one cluster) and reduces over the last
axis. The IS of cluster l minimizes, one Adam step per round (lr α),

    F_grad(p) = Σ_i | p_i · n_i  −  Ḡ · r_i^γ |,
    Ḡ = mean_i(p_i n_i),  r_i = F̃_i / mean_j F̃_j,

with Ḡ and r held constant, then renormalizes Σ_i p_i = N.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.common.config import FLConfig
from repro_torch.common.tree import tree_leaves


class FGNState(NamedTuple):
    """Adam state of the loss-weight optimization, per cluster."""
    step: torch.Tensor   # (C,) int32
    mu: torch.Tensor     # (C, N)
    nu: torch.Tensor     # (C, N)


def fgn_init(n: int, n_clusters: int, device="cpu") -> FGNState:
    """Zeroed state for C clusters of N clients."""
    z = torch.zeros((n_clusters, n), dtype=torch.float32, device=device)
    return FGNState(step=torch.zeros((n_clusters,), dtype=torch.int32,
                                     device=device),
                    mu=z, nu=z.clone())


def fgrad_value(p, norms, gbar, targets) -> torch.Tensor:
    """F_grad (eq. 5) given the masked norms and the targets Ḡ·r^γ,
    summed over the last (client) axis."""
    return torch.sum(torch.abs(p * norms - gbar * targets), dim=-1)


def fgn_targets(loss_ratios: torch.Tensor, gamma: float) -> torch.Tensor:
    """r_i^γ with r_i = F̃_i / mean(F̃)."""
    r = loss_ratios / torch.clamp(loss_ratios.mean(-1, keepdim=True),
                                  min=1e-12)
    return torch.pow(torch.clamp(r, min=1e-12), gamma)


def fgn_grad_p(p, norms, loss_ratios, gamma: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """∂F_grad/∂p_i = sign(p_i n_i − Ḡ r_i^γ) · n_i (Ḡ, r held fixed).
    Returns (grad, F_grad value)."""
    gbar = torch.mean(p * norms, dim=-1, keepdim=True)
    resid = p * norms - gbar * fgn_targets(loss_ratios, gamma)
    return torch.sign(resid) * norms, torch.sum(torch.abs(resid), dim=-1)


def fgn_update(p, norms, loss_ratios, state: FGNState, fl: FLConfig
               ) -> Tuple[torch.Tensor, FGNState, torch.Tensor]:
    """One Alg.-2 step: p ← renorm(AdamStep(p, ∇_p F_grad))."""
    g, fval = fgn_grad_p(p, norms, loss_ratios, fl.gamma)
    step = state.step + 1
    t = step.to(torch.float32).unsqueeze(-1)
    b1, b2, eps = 0.9, 0.999, 1e-8
    mu = b1 * state.mu + (1 - b1) * g
    nu = b2 * state.nu + (1 - b2) * g * g
    mhat = mu / (1 - torch.pow(torch.full_like(t, b1), t))
    vhat = nu / (1 - torch.pow(torch.full_like(t, b2), t))
    p_new = p - fl.alpha * mhat / (torch.sqrt(vhat) + eps)
    # constraint: p_i > p_min, Σ_i p_i = N (Sec. II)
    p_new = torch.clamp(p_new, min=fl.p_min + 1e-6)
    p_new = p_new * (p.shape[-1] / torch.clamp(
        torch.sum(p_new, dim=-1, keepdim=True), min=1e-12))
    return p_new, FGNState(step=step, mu=mu, nu=nu), fval


def fgn_update_gated(p, norms, loss_ratios, state: FGNState, fl: FLConfig,
                     fgn_on: torch.Tensor
                     ) -> Tuple[torch.Tensor, FGNState, torch.Tensor]:
    """Alg.-2 step behind the weighting gate: with ``fgn_on`` < 0.5 the
    weights and state pass through and F_grad reads 0 (equal weighting).
    The gate is a tensor and selects through ``torch.where``: () for
    every cluster, or (C,) per cluster (the faulted round passes
    ``fgn_on · live``, so a dead cluster's state freezes); a per-cluster
    gate is laid along the cluster axis of the (C, N) fields."""
    p_fgn, st_fgn, fval = fgn_update(p, norms, loss_ratios, state, fl)
    on = torch.as_tensor(fgn_on, device=p.device) > 0.5     # () or (C,)
    on_cn = on.unsqueeze(-1)                    # against the N axis
    st_new = FGNState(step=torch.where(on, st_fgn.step, state.step),
                      mu=torch.where(on_cn, st_fgn.mu, state.mu),
                      nu=torch.where(on_cn, st_fgn.nu, state.nu))
    return (torch.where(on_cn, p_fgn, p), st_new,
            torch.where(on, fval, torch.zeros_like(fval)))


def masked_tree_norm(grad_tree, mask_tree) -> torch.Tensor:
    """‖M ∘ g‖ over a tree (the n_i of eq. 6): boolean (or 0/1) masks
    shaped like, or broadcasting to, their gradient leaves."""
    total = torch.zeros((), dtype=torch.float32)
    for g, m in zip(tree_leaves(grad_tree), tree_leaves(mask_tree)):
        sq = torch.sum(torch.where(m.bool(), g.to(torch.float32), 0.0) ** 2)
        total = total.to(sq.device) + sq
    return torch.sqrt(total)
