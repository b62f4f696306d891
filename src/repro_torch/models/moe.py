"""Mixture-of-Experts FFN block (Mixtral / Phi-3.5-MoE / Granite-4.0-H
style).

Port of ``repro.models.moe``: top-k routing, the Switch load-balance aux
loss, capacity dropping in training and dropless inference. Tokens are
grouped along the sequence (``GROUP_SIZE`` contiguous tokens, one group
when S is not a multiple of it); in training each expert takes at most

    cap = max(int(top_k * g / E * capacity_factor + 0.999), 1)

tokens of a group, in token order, and a token past its expert's
capacity gets combine weight 0 for that expert (it keeps its other
experts' gates, not renormalized).

The reference computes every expert at once with dispatch/combine
einsums over (B, nG, g, E, cap) one-hot tensors. Here each expert runs
only on its own rows, and the combine accumulates in float32 and casts
once:

* training gathers each expert's kept tokens into its (B, nG, cap) slots
  (an index table, no host sync: ``cap`` is static), runs the expert on
  them one expert at a time and adds the gated outputs back
  (``scatter_add``); the gradient reaches the router only through the
  gates and the aux loss, as in the reference;
* inference is the reference's dropless path, routed: the T·k token
  slots (T tokens, k experts each) are sorted by expert once per layer
  (``_group_slots``: a stable sort, and each expert's end offset by a
  search of the sorted ids, all on the device), each expert's SwiGLU
  runs on its rows alone, and each token sums its k gated outputs in
  float32, in expert order. The three products are grouped GEMMs over
  all experts (``torch._grouped_mm``): on the card in bfloat16 they read
  the offsets on the device, and the layer makes no host sync; torch's
  fallback for float32 and for the CPU reads them on the host, once a
  product. A token's output does not depend on how many tokens share
  its group, so prefill + decode equals a longer prefill. The router's
  logits are float32 in both modes (``router_logits``).

``moe_specs(cfg, shared_d_ff)`` adds a shared SwiGLU expert of that
width (Granite-4.0-H): every token's block output is then the routed
sum plus the shared expert's output, on the same normed input. The
routed experts' width is ``cfg.d_ff``.

Ties: ``jax.lax.top_k`` keeps the lower index among equal weights and
``torch.topk`` promises no order, so ``_route`` keeps the first k
experts of a stable descending sort of the weights: expert e is kept
when fewer than k experts rank before it (a larger weight, or an equal
weight at a lower index).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.config import ModelConfig
from repro_torch.common.spans import span
from repro_torch.models import layers as L
from repro_torch.models.params import ParamSpec

GROUP_SIZE = 512
# float32 elements of one stretch of the combine's (tokens, k, d) gather
COMBINE_ELEMENTS = 1 << 28


def moe_specs(cfg: ModelConfig, shared_d_ff: int = 0) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, cfg.d_ff
    e = cfg.moe.n_experts
    specs = {
        "norm": ParamSpec((d,), "zeros", axes=("embed",)),
        "router": ParamSpec((d, e), scale=0.02, axes=("embed", None)),
        "w_gate": ParamSpec((e, d, f), axes=("expert", "embed", "mlp")),
        "w_up": ParamSpec((e, d, f), axes=("expert", "embed", "mlp")),
        "w_down": ParamSpec((e, f, d), axes=("expert", "mlp", "embed")),
    }
    if shared_d_ff:
        fs = shared_d_ff
        specs["shared"] = {
            "w_gate": ParamSpec((d, fs), axes=("embed", "mlp")),
            "w_up": ParamSpec((d, fs), axes=("embed", "mlp")),
            "w_down": ParamSpec((fs, d), axes=("mlp", "embed")),
        }
    return specs


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
    ranked = torch.sort(weights, dim=-1, descending=True, stable=True)
    mask = torch.zeros_like(weights).scatter_(
        -1, ranked.indices[..., :top_k], 1.0)
    gates = weights * mask
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    return gates, mask, weights


def router_logits(p, h: torch.Tensor) -> torch.Tensor:
    """h (..., d) -> the router's logits (..., E), float32: a product in
    the compute dtype would round them to its step, and near ties between
    the k-th and the next expert would then rank as they round."""
    return h.float() @ p["router"].float()


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


def _group_slots(top: torch.Tensor, n_exp: int):
    """top (T, k) expert ids -> (order, ends): the T·k slots (token t's
    j-th expert is slot t·k + j) sorted by expert, stably, and each
    expert's end offset in that order (E,), int64, on the device."""
    ids, order = torch.sort(top.reshape(-1), stable=True)
    ends = torch.searchsorted(
        ids, torch.arange(n_exp, device=top.device), right=True)
    return order, ends


def _grouped_swiglu(p, rows: torch.Tensor, ends: torch.Tensor
                    ) -> torch.Tensor:
    """Each expert's SwiGLU on its rows: rows (T·k, d) grouped by expert,
    expert e's ending at ``ends[e]``, as three grouped GEMMs over all the
    experts (``torch._grouped_mm``). On the card in bfloat16 they read the
    offsets on the device; torch's fallback for other dtypes and for the
    CPU reads them on the host, once a product."""
    dt = rows.dtype
    offs = ends.to(torch.int32)
    w = {n: p[n].to(dt) for n in ("w_gate", "w_up", "w_down")}
    act = (F.silu(torch._grouped_mm(rows, w["w_gate"], offs=offs))
           * torch._grouped_mm(rows, w["w_up"], offs=offs))
    return torch._grouped_mm(act, w["w_down"], offs=offs)


def _top(mask: torch.Tensor, top_k: int) -> torch.Tensor:
    """Each token's k experts (..., k) in index order: the mask's ones."""
    return torch.sort(mask, dim=-1, descending=True,
                      stable=True).indices[..., :top_k]


def _routed_experts(p, h: torch.Tensor, gates_c: torch.Tensor,
                    top: torch.Tensor, order: torch.Tensor,
                    ends: torch.Tensor) -> torch.Tensor:
    """Dropless inference: h (T, d), the combine gates (T, E), each
    token's experts ``top`` (T, k) and their slots grouped by expert
    (``_group_slots``) -> each token's gated sum of its k experts in
    expert order (T, d), float32."""
    t, d = h.shape
    k = top.shape[-1]
    y = _grouped_swiglu(p, h[order // k], ends)
    slot = torch.empty_like(order)
    slot[order] = torch.arange(order.numel(), device=order.device)
    slot = slot.view(t, k)                             # token's rows in y
    g = gates_c.gather(-1, top)                        # (T, k)
    out = torch.empty((t, d), dtype=torch.float32, device=h.device)
    step = max(1, COMBINE_ELEMENTS // (k * d))
    for i in range(0, t, step):
        sl = slice(i, i + step)
        out[sl] = (y[slot[sl]].float() * g[sl, :, None]).sum(dim=1)
    return out


def _capacity_experts(p, hg: torch.Tensor, gates_c: torch.Tensor,
                      mask: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Training: each expert on its kept tokens of each group, hg (B, nG,
    g, d) -> the gated sum (B, nG, g, d) float32."""
    n_exp, k = cfg.moe.n_experts, cfg.moe.top_k
    b, ng, g, d = hg.shape
    cap = capacity(k, g, n_exp, cfg.moe.capacity_factor)
    # each token's place in its expert's queue, in token order
    pos = torch.cumsum(mask, dim=2) * mask - 1.0             # (B, nG, g, E)
    keep = (pos >= 0) & (pos < cap)
    # slot table (B, nG, E, cap + 1): the token in each slot, g for an
    # empty slot; tokens past capacity land in the spare slot ``cap``
    slot = torch.where(keep, pos, torch.full_like(pos, cap)).long()
    table = torch.full((b, ng, n_exp, cap + 1), g, dtype=torch.long,
                       device=hg.device)
    tok = torch.arange(g, device=hg.device).expand(b, ng, n_exp, g)
    table.scatter_(-1, slot.permute(0, 1, 3, 2), tok)
    table = table[..., :cap]
    # row g is the empty slot's: zero input, zero gate, output discarded
    h_pad = torch.cat([hg, hg.new_zeros((b, ng, 1, d))], dim=2)
    g_pad = torch.cat([gates_c * keep, gates_c.new_zeros((b, ng, 1, n_exp))],
                      dim=2)
    y = torch.zeros((b, ng, g + 1, d), dtype=torch.float32, device=hg.device)
    for e in range(n_exp):
        idx = table[:, :, e]                                 # (B, nG, cap)
        idx_d = idx.unsqueeze(-1).expand(b, ng, cap, d)
        ye = _expert(p, e, torch.gather(h_pad, 2, idx_d)).float()
        w = torch.gather(g_pad[..., e], 2, idx).unsqueeze(-1)
        y = y.scatter_add(2, idx_d, w * ye)
    return y[:, :, :g]


def moe_branch(p, x: torch.Tensor, cfg: ModelConfig, train: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (moe(norm(x)) (B, S, d) float32, aux loss ()
    float32): the routed experts' gated sum, plus the shared expert's
    output where ``p`` holds one. ``train=False`` (prefill, decode) is
    dropless; ``train=True`` drops by capacity."""
    mcfg = cfg.moe
    n_exp, k = mcfg.n_experts, mcfg.top_k
    b, s, d = x.shape
    with span("moe"):
        h = L.rms_norm(x, p["norm"], 1e-6)
        g = _group_size(s)
        hg = h.reshape(b, s // g, g, d)
        with span("moe.route"):
            logits = router_logits(p, hg)                    # (B, nG, g, E)
            gates, mask, weights = _route(logits, k)
            # load-balance aux loss (Switch): E * sum_e f_e * P_e
            frac_tokens = mask.mean(dim=(0, 1, 2))
            frac_weight = weights.mean(dim=(0, 1, 2))
            aux = (n_exp * torch.sum(frac_tokens * frac_weight)
                   * mcfg.aux_loss_weight)
            gates_c = gates.to(h.dtype).float()  # the reference's combine
            if not train:
                gates_c = gates_c.reshape(b * s, n_exp)
                top = _top(mask.reshape(b * s, n_exp), k)
                order, ends = _group_slots(top, n_exp)
        with span("moe.experts"):
            if train:
                y = _capacity_experts(p, hg, gates_c, mask, cfg)
            else:
                y = _routed_experts(p, h.reshape(b * s, d), gates_c, top,
                                    order, ends)
        y = y.reshape(b, s, d)
        if "shared" in p:
            w = {n: t.to(h.dtype) for n, t in p["shared"].items()}
            y = y + L.mlp_apply(w, h).float()
        return y, aux


def moe_apply(p, x: torch.Tensor, cfg: ModelConfig,
              train: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (x + moe(x), aux loss () float32). ``train=False``
    (prefill, decode) is dropless; ``train=True`` drops by capacity."""
    y, aux = moe_branch(p, x, cfg, train)
    return x + y.to(x.dtype), aux
