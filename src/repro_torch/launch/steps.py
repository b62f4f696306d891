"""Serve steps (prefill and greedy decode) and the stub frontends'
abstract inputs.

Port of the serve steps and ``input_specs`` of ``repro.launch.steps``
(its sharding rules and the abstract parameter, cache and serve-state
specs are XLA tooling: ROADMAP Queue 1, item 16). The prefill step
returns the last position's logits, so it applies the final norm and
head to that position only: the same numbers without a (B, S, vocab)
float32 logits tensor. Its input is token ids (B, S), or for the
vision stub frontend projected patch embeddings (B, S, d_model).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.common.config import InputShape, ModelConfig
from repro_torch.models.model import Model


def input_specs(cfg: ModelConfig,
                shape: InputShape) -> Dict[str, torch.Tensor]:
    """Storage-free stand-ins (``meta`` tensors) of every input for one
    (arch, input shape) pair, as the reference's ``ShapeDtypeStruct``s.
    The audio and vision frontends are stubbed: audio takes EnCodec token
    ids, vision (B, S, d_model) bfloat16 patch embeddings in training and
    prefill; decode takes one token (B, 1) at positions (B,)."""
    b, s = shape.global_batch, shape.seq_len

    def spec(size, dtype=torch.int32):
        return torch.empty(size, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        if cfg.modality == "vision":
            tokens = spec((b, s, cfg.d_model), torch.bfloat16)
        else:
            tokens = spec((b, s))
        if shape.kind == "prefill":
            return {"tokens": tokens}
        return {"tokens": tokens, "labels": spec((b, s))}
    return {"tokens": spec((b, 1)), "positions": spec((b,))}


def make_prefill_step(model: Model, cache_len: Optional[int] = None):
    def prefill_step(backbone, head, tokens):
        """tokens (B, S), or embeddings (B, S, d_model) -> (logits (B, V)
        float32, cache)."""
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
        (B,) int32, logits (B, V), cache). Use the returned cache: the
        attention caches are updated in place, the Mamba2 and xLSTM
        states come back as new tensors."""
        with torch.no_grad():
            logits, _, new_cache = model.forward_logits(
                backbone, head, tokens, positions=positions, mode="decode",
                cache=cache)
        next_tok = logits[:, -1].argmax(dim=-1).to(torch.int32)
        return next_tok, logits[:, -1], new_cache
    return decode_step
