"""Mixture-of-Experts FFN block (Mixtral / Phi-3.5-MoE style).

Port of ``repro.models.moe``: top-k routing, the Switch load-balance aux
loss, capacity dropping in training and dropless inference. Tokens are
grouped along the sequence (``GROUP_SIZE`` contiguous tokens, one group
when S is not a multiple of it); in training each expert takes at most

    cap = max(int(top_k * g / E * capacity_factor + 0.999), 1)

tokens of a group, in token order, and a token past its expert's
capacity gets combine weight 0 for that expert (it keeps its other
experts' gates, not renormalized).

The reference computes every expert at once with dispatch/combine
einsums over (B, nG, g, E, cap) one-hot tensors. Here the experts run one
at a time as ``torch.matmul`` over the layer's tokens, so transients stay
at (tokens, d_ff), and the combine accumulates in float32 and casts once:

* training gathers each expert's kept tokens into its (B, nG, cap) slots
  (an index table, no host sync: ``cap`` is static), runs the expert on
  them and adds the gated outputs back (``scatter_add``); the gradient
  reaches the router only through the gates and the aux loss, as in the
  reference;
* inference runs every expert on every token, weighted by the top-k
  gates (the reference's dropless path): a token's output does not
  depend on how many tokens share its group, so prefill + decode equals
  a longer prefill.

Ties: ``jax.lax.top_k`` keeps the lower index among equal weights and
``torch.topk`` promises no order, so ``_route`` keeps expert e when fewer
than k experts rank before it (a larger weight, or an equal weight at a
lower index).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.params import ParamSpec

GROUP_SIZE = 512


def moe_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, cfg.d_ff
    e = cfg.moe.n_experts
    return {
        "norm": ParamSpec((d,), "zeros", axes=("embed",)),
        "router": ParamSpec((d, e), scale=0.02, axes=("embed", None)),
        "w_gate": ParamSpec((e, d, f), axes=("expert", "embed", "mlp")),
        "w_up": ParamSpec((e, d, f), axes=("expert", "embed", "mlp")),
        "w_down": ParamSpec((e, f, d), axes=("expert", "mlp", "embed")),
    }


def capacity(top_k: int, group: int, n_experts: int,
             capacity_factor: float) -> int:
    """Tokens an expert takes per group in training: the reference's
    ``int(x + 0.999)``, which is not ``ceil`` (x = 2.0005 gives 2 where
    ``ceil`` gives 3)."""
    return max(int(top_k * group / n_experts * capacity_factor + 0.999), 1)


def _route(logits: torch.Tensor, top_k: int):
    """logits (..., E) -> (gates, mask, weights), each (..., E) float32:
    the softmax weights, the top-k mask (ties to the lower index) and
    the weights on the mask renormalized to sum 1."""
    weights = torch.softmax(logits.float(), dim=-1)
    n = weights.shape[-1]
    w_i, w_j = weights.unsqueeze(-1), weights.unsqueeze(-2)   # e, e'
    idx = torch.arange(n, device=weights.device)
    lower = idx.unsqueeze(0) < idx.unsqueeze(1)               # [e, e']: e' < e
    before = (w_j > w_i) | ((w_j == w_i) & lower)
    mask = (before.sum(dim=-1) < top_k).to(torch.float32)
    gates = weights * mask
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    return gates, mask, weights


def _expert(p, e: int, h: torch.Tensor) -> torch.Tensor:
    """Expert e's SwiGLU on h (..., d), weights cast to h's dtype."""
    dt = h.dtype
    act = F.silu(h @ p["w_gate"][e].to(dt)) * (h @ p["w_up"][e].to(dt))
    return act @ p["w_down"][e].to(dt)


def _group_size(s: int) -> int:
    """``GROUP_SIZE`` tokens, or the whole sequence when S is not a
    multiple of it (the reference's smoke-test shapes)."""
    g = min(GROUP_SIZE, s)
    return g if s % g == 0 else s


def moe_apply(p, x: torch.Tensor, cfg: ModelConfig,
              train: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (x + moe(x), aux loss () float32). ``train=False``
    (prefill, decode) is dropless; ``train=True`` drops by capacity."""
    mcfg = cfg.moe
    n_exp, k = mcfg.n_experts, mcfg.top_k
    b, s, d = x.shape
    h = L.rms_norm(x, p["norm"], 1e-6)
    g = _group_size(s)
    ng = s // g
    hg = h.reshape(b, ng, g, d)

    logits = hg @ p["router"].to(h.dtype)                    # (B, nG, g, E)
    gates, mask, weights = _route(logits, k)

    # load-balance aux loss (Switch): E * sum_e f_e * P_e
    frac_tokens = mask.mean(dim=(0, 1, 2))
    frac_weight = weights.mean(dim=(0, 1, 2))
    aux = n_exp * torch.sum(frac_tokens * frac_weight) * mcfg.aux_loss_weight

    gates_c = gates.to(h.dtype).float()    # the reference's combine dtype
    if not train:
        y = torch.zeros((b, ng, g, d), dtype=torch.float32, device=x.device)
        for e in range(n_exp):
            y += gates_c[..., e:e + 1] * _expert(p, e, hg).float()
        return x + y.to(x.dtype).reshape(b, s, d), aux

    cap = capacity(k, g, n_exp, mcfg.capacity_factor)
    # each token's place in its expert's queue, in token order
    pos = torch.cumsum(mask, dim=2) * mask - 1.0             # (B, nG, g, E)
    keep = (pos >= 0) & (pos < cap)
    # slot table (B, nG, E, cap + 1): the token in each slot, g for an
    # empty slot; tokens past capacity land in the spare slot ``cap``
    slot = torch.where(keep, pos, torch.full_like(pos, cap)).long()
    table = torch.full((b, ng, n_exp, cap + 1), g, dtype=torch.long,
                       device=x.device)
    tok = torch.arange(g, device=x.device).expand(b, ng, n_exp, g)
    table.scatter_(-1, slot.permute(0, 1, 3, 2), tok)
    table = table[..., :cap]
    # row g is the empty slot's: zero input, zero gate, output discarded
    h_pad = torch.cat([hg, hg.new_zeros((b, ng, 1, d))], dim=2)
    g_pad = torch.cat([gates_c * keep, gates_c.new_zeros((b, ng, 1, n_exp))],
                      dim=2)
    y = torch.zeros((b, ng, g + 1, d), dtype=torch.float32, device=x.device)
    for e in range(n_exp):
        idx = table[:, :, e]                                 # (B, nG, cap)
        idx_d = idx.unsqueeze(-1).expand(b, ng, cap, d)
        ye = _expert(p, e, torch.gather(h_pad, 2, idx_d)).float()
        w = torch.gather(g_pad[..., e], 2, idx).unsqueeze(-1)
        y = y.scatter_add(2, idx_d, w * ye)
    return x + y[:, :, :g].to(x.dtype).reshape(b, s, d), aux
