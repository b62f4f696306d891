"""Serve steps: prefill and greedy decode.

Port of the serve steps of ``repro.launch.steps`` (its sharding rules
and abstract dry-run specs are XLA tooling: ROADMAP Queue 1, item 16).
The prefill step returns the last position's logits, so it applies the
final norm and head to that position only: the same numbers without a
(B, S, vocab) float32 logits tensor.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.model import Model


def make_prefill_step(model: Model, cache_len: Optional[int] = None):
    def prefill_step(backbone, head, tokens):
        """tokens (B, S) -> (logits (B, V) float32, cache)."""
        s = tokens.shape[1]
        with torch.no_grad():
            h, _, cache = model.trunk_apply(
                backbone["trunk"], tokens,
                positions=torch.arange(s, device=tokens.device),
                mode="prefill", cache_len=cache_len or s + 1)
            feats = model.final_apply(backbone["final"], h[:, -1:])
            logits = model.head_apply(head, feats)
        return logits[:, -1], cache
    return prefill_step


def make_decode_step(model: Model):
    def decode_step(backbone, head, cache, tokens, positions):
        """tokens (B, 1) at absolute ``positions`` (B,) -> (next tokens
        (B,) int32, logits (B, V), cache). The cache is updated in place."""
        with torch.no_grad():
            logits, _, new_cache = model.forward_logits(
                backbone, head, tokens, positions=positions, mode="decode",
                cache=cache)
        next_tok = logits[:, -1].argmax(dim=-1).to(torch.int32)
        return next_tok, logits[:, -1], new_cache
    return decode_step
