"""The numbers that decide ``correct``.

Training (the scenario bank): each round's loss, the first round's
gradient as each optimizer gets it and the change of every parameter
over the compared rounds. A gradient or a change is judged leaf by leaf
by the gap between the program's norm and the reference's, over the
larger of the reference's norm of that leaf and of the median leaf (some
gradients are all but zero), and the worst leaf counts. Leaves whose
reference gradient is under a thousandth of the median leaf's are left
out of both by that rule, never by name.

Serving: for each compared request, the widest gap by which the served
token's reference logit lies below the reference's best, over the
spread (standard deviation) of the reference's logits, and the relative
L2 error of the last position's logits.
"""
from __future__ import annotations

from typing import Dict, Iterable, List

import torch

TINY_GRADIENT = 1e-3     # of the median leaf's reference gradient norm


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def loss_gap(prog: Iterable[torch.Tensor], ref: Iterable[torch.Tensor]
             ) -> float:
    """Largest relative gap of any loss entry over all compared rounds."""
    worst = 0.0
    for a, b in zip(prog, ref):
        a, b = a.double().cpu(), b.double().cpu()
        worst = max(worst, float(((a - b).abs()
                                  / b.abs().clamp_min(1e-30)).max()))
    return worst


def kept_leaves(ref_grad: Dict[str, torch.Tensor]) -> List[str]:
    norms = {k: _norm(v) for k, v in ref_grad.items()}
    med = float(torch.tensor(list(norms.values())).median())
    return sorted(k for k, v in norms.items() if v >= TINY_GRADIENT * med)


def leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             keep: List[str]) -> float:
    """Worst leaf's |‖prog‖ - ‖ref‖| / max(‖ref‖, median leaf ‖ref‖)."""
    ref_n = {k: _norm(ref[k]) for k in keep}
    med = float(torch.tensor(list(ref_n.values())).median())
    return max(abs(_norm(prog[k]) - ref_n[k]) / max(ref_n[k], med, 1e-30)
               for k in keep)


def token_gap(ref_logits: torch.Tensor, tokens: torch.Tensor) -> float:
    """Widest gap, over rows, of the served token's reference logit below
    the row's best, in units of the row's logit spread."""
    ref = ref_logits.double()
    best = ref.max(dim=-1).values
    got = ref.gather(-1, tokens.long().reshape(-1, 1)).squeeze(-1)
    return float(((best - got) / ref.std(dim=-1)).max())


def logits_error(logits: torch.Tensor, ref_logits: torch.Tensor) -> float:
    """Worst row's relative L2 error of the logits."""
    a, b = logits.double(), ref_logits.double()
    return float((torch.linalg.vector_norm(a - b, dim=-1)
                  / torch.linalg.vector_norm(b, dim=-1)).max())
