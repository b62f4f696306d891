"""Serving entry point: prefill + batched greedy decode for any LM
--arch: the dense text models, the MoE pair (mixtral-8x22b,
phi3.5-moe-42b-a6.6b: dropless inference, each expert on the tokens
routed to it), the audio and vision stub frontends (musicgen-medium,
phi-3-vision-4.2b), zamba2-1.2b (Mamba2 layers and one shared attention
block), xlstm-1.3b (mLSTM and sLSTM blocks) and the port's own
granite-4.0-h-small (Mamba2 and NoPE-attention mixers, each followed by
a routed MoE block with a shared expert).

Port of ``repro.launch.serve``: the same flags and output lines, on the
card unless ``--device cpu``. It serves with ``attn_impl="pallas"``, the
reference's serving attention, so every prefill runs the flash attention
kernel K8 once per attention layer (once per application of zamba2's
shared block, never for xlstm; decode attends to the cache in plain
PyTorch, as the reference does). A decode step returns the new cache:
the attention rings are written in place, the Mamba2 and xLSTM states
are new tensors::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-3b \\
        --batch 4 --prefill-len 32 --decode-steps 16

``main()`` serves the reduced (smoke) config, as the reference does;
``serve(cfg, ...)`` takes any ported config, the full-size one included
(Mixtral-8x22B cut in depth: ``get_config("mixtral_8x22b").replace(
n_layers=4)`` holds 41.7 GB of float32 weights), and a ``prompt`` of
token ids (B, S) or, for the vision frontend, (B, S, d_model) float
embeddings (the decode steps take the greedy token ids).
Weights and prompt follow the reference's keys: ``split(PRNGKey(seed),
4)`` gives the trunk, final, head and prompt keys, the weights are
``init_params`` of the first three (drawn on the serving device: 12.7 GB
of float32 for StarCoder2-3B never touch the host) and the prompt is
``randint(k_prompt, (batch, prefill_len), 0, vocab)``, drawn on the host.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from repro_torch import rng
from repro_torch.common.config import ModelConfig
from repro_torch.common.device import resolve_device
from repro_torch.configs import ALIASES, get_smoke_config
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models.model import Model, build_model
from repro_torch.models.params import init_params


@dataclass
class ServeResult:
    tokens: torch.Tensor          # (B, decode_steps) int32 greedy tokens, host
    prefill_logits: torch.Tensor  # (B, V) float32, last prompt position
    last_logits: torch.Tensor     # (B, V) float32 of the last decode step
    prefill_s: float              # host clock, ends in a device sync
    decode_s: List[float]         # one entry per decode step


def serving_model(cfg: ModelConfig) -> Model:
    """The model ``serve`` runs: ``cfg`` with the kernel attention."""
    return build_model(cfg.replace(attn_impl="pallas"))


def serve_keys(seed: int) -> torch.Tensor:
    """The reference's (trunk, final, head, prompt) keys of ``seed``."""
    return rng.split(rng.PRNGKey(seed), 4)


def init_weights(model: Model, seed: int, device):
    """(backbone, head) float32 weights of ``seed`` on ``device``, the
    reference's ``init_params`` at the same keys."""
    dev = resolve_device(device)
    k_trunk, k_final, k_head, _ = serve_keys(seed)
    backbone = {"trunk": init_params(model.trunk_specs(), k_trunk,
                                     device=dev),
                "final": init_params(model.final_specs(), k_final,
                                     device=dev)}
    return backbone, init_params(model.head_specs(), k_head, device=dev)


def draw_prompt(cfg: ModelConfig, batch: int, prefill_len: int,
                seed: int) -> torch.Tensor:
    """The reference's prompt of ``seed``: (batch, prefill_len) int64 token
    ids of ``randint(k_prompt, ..., 0, vocab)`` (int32 values)."""
    return rng.randint(serve_keys(seed)[3], (batch, prefill_len), 0,
                       cfg.vocab_size).to(torch.int64)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(cfg: ModelConfig, batch: int, prefill_len: int, decode_steps: int,
          seed: int = 0, device="cuda", *, weights=None,
          prompt: Optional[torch.Tensor] = None,
          log=print) -> ServeResult:
    """Prefill a (batch, prefill_len) prompt, then decode greedily: the
    first token from the prefill, ``decode_steps - 1`` more from the
    decode step. ``weights`` (backbone, head) and ``prompt`` default to
    draws from ``seed``."""
    dev = resolve_device(device)
    model = serving_model(cfg)
    if weights is None:
        weights = init_weights(model, seed, dev)
    backbone, head = weights
    if prompt is None:
        prompt = draw_prompt(cfg, batch, prefill_len, seed)
    prompt = prompt.to(dev)

    cache_len = prefill_len + decode_steps + 1
    prefill = make_prefill_step(model, cache_len=cache_len)
    decode = make_decode_step(model)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(backbone, head, prompt)
    next_tok = logits.argmax(dim=-1).to(torch.int32)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    prefill_logits = logits
    log(f"prefill({batch}x{prefill_len}) {prefill_s:.2f}s -> first tokens "
        f"{np.asarray(next_tok.cpu())}")

    toks = [next_tok]
    pos = torch.full((batch,), prefill_len, dtype=torch.int32, device=dev)
    decode_s = []
    for _ in range(decode_steps - 1):
        t0 = time.perf_counter()
        next_tok, logits, cache = decode(backbone, head, cache,
                                         next_tok[:, None], pos)
        _sync(dev)
        decode_s.append(time.perf_counter() - t0)
        toks.append(next_tok)
        pos = pos + 1
    dt = sum(decode_s)
    out = torch.stack(toks, dim=1).cpu()
    log(f"decoded {decode_steps - 1} steps in {dt:.2f}s "
        f"({dt / max(decode_steps - 1, 1) * 1000:.0f} ms/tok)")
    for b in range(min(batch, 2)):
        log(f"  request {b}: {np.asarray(out[b][:16])}")
    return ServeResult(tokens=out, prefill_logits=prefill_logits,
                       last_logits=logits, prefill_s=prefill_s,
                       decode_s=decode_s)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prefill-len", type=int, default=32)
    ap.add_argument("--decode-steps", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    cfg = get_smoke_config(ALIASES.get(args.arch, args.arch))
    return serve(cfg, args.batch, args.prefill_len, args.decode_steps,
                 seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
