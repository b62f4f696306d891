"""Faults planted under the Granite-4.0-H cell's timed path (the
``hybrid_moe`` family), each a context manager that patches the program
for as long as it is open, as ``bench/lib/faults.py``'s:

* ``top9_routing``: every MoE block keeps 9 experts a token in place of
  its top 10 (its top k - 1);
* ``no_shared_expert``: the MoE blocks leave the shared expert out;
* ``sqrt_attention_scale``: attention scales its scores by 1/sqrt(D)
  (1/sqrt(128)) in place of the configured multiplier (1/128).
"""
from __future__ import annotations

from bench.lib.faults import _patched


def top9_routing():
    from repro_torch.models import moe

    def make(route):
        def fewer(logits, top_k):
            return route(logits, top_k - 1)
        return fewer
    return _patched(moe, "_route", make)


def no_shared_expert():
    from repro_torch.models import hybrid_moe

    def make(branch):
        def unshared(p, x, cfg, train=True):
            return branch({k: v for k, v in p.items() if k != "shared"},
                          x, cfg, train)
        return unshared
    return _patched(hybrid_moe, "moe_branch", make)


def sqrt_attention_scale():
    from repro_torch.models import hybrid_moe

    def make(branch):
        def unscaled(*a, **k):
            return branch(*a, **dict(k, scale=None))
        return unscaled
    return _patched(hybrid_moe, "attn_branch", make)


FAULTS = {"top9_routing": top9_routing, "no_shared_expert": no_shared_expert,
          "sqrt_attention_scale": sqrt_attention_scale}
