"""Batched serving example: prefill a batch of requests, then greedy-decode
continuations with the cache, for any architecture's reduced (smoke)
config (--arch takes the assignment ids).

Port of ``examples/serve_batched.py``: the same flags, output lines,
weights and prompts, on the card unless ``--device cpu``. It serves
through ``launch.serve.serve``, whose model takes ``attn_impl="pallas"``,
so every prefill on the card runs the flash attention kernel K8 once per
attention layer (once per application of zamba2's shared block, never for
xlstm); the reference's example runs its smoke config's ``blocked``
attention, the same function within the attention tolerances.

Its keys: the trunk's weights from the root key, the final layer's, the
head's and the prompt from ``fold_in(root, salt)`` with the salts of
``SERVE_SALT`` (the example's 7, 9 and 1; 7 is the registry's
``FINAL_INIT_FOLD``, the final layer's init fold off the trunk key).

    PYTHONPATH=src python -m repro_torch.experiments.serve_batched \\
        --arch mixtral-8x22b
    PYTHONPATH=src python -m repro_torch.experiments.serve_batched \\
        --arch zamba2-1.2b --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch import rng
from repro_torch.common.device import resolve_device
from repro_torch.configs import ALIASES, get_smoke_config
from repro_torch.core.ota import FINAL_INIT_FOLD
from repro_torch.launch.serve import serve, serving_model
from repro_torch.models.params import init_params

# the example's folds off its root key, one registry (as core.hota's
# KLASS_SALT names the hook's): each key derives from the root by one of
# these, so distinct salts keep the streams apart
SERVE_SALT = {"final": FINAL_INIT_FOLD, "head": 9, "prompt": 1}
if len(set(SERVE_SALT.values())) != len(SERVE_SALT):
    raise AssertionError(f"colliding serve salts {SERVE_SALT}")


def serve_key(root, purpose: str):
    """The example's key for ``purpose`` ("final", "head" or "prompt")."""
    salt = SERVE_SALT[purpose]
    return rng.fold_in(root, salt)


def example_weights(model, seed: int, device):
    """(backbone, head) float32 weights: the trunk from the root key of
    ``seed``, the final layer and the head from its serve keys."""
    root = rng.PRNGKey(seed)
    backbone = {"trunk": init_params(model.trunk_specs(), root,
                                     device=device),
                "final": init_params(model.final_specs(),
                                     serve_key(root, "final"),
                                     device=device)}
    head = init_params(model.head_specs(), serve_key(root, "head"),
                       device=device)
    return backbone, head


def example_prompt(cfg, batch: int, prefill_len: int, seed: int):
    """(batch, prefill_len) int64 token ids of ``randint(fold_in(root,
    1), ..., 0, vocab)``."""
    return rng.randint(serve_key(rng.PRNGKey(seed), "prompt"),
                       (batch, prefill_len), 0, cfg.vocab_size).long()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x22b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prefill-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(ALIASES.get(args.arch, args.arch))
    model = serving_model(cfg)
    weights = example_weights(model, args.seed, dev)
    prompt = example_prompt(cfg, args.batch, args.prefill_len, args.seed)
    print(f"== {cfg.name} ({cfg.family}) | batch={args.batch} "
          f"prefill={args.prefill_len} ==")
    res = serve(cfg, args.batch, args.prefill_len, args.new_tokens,
                seed=args.seed, device=dev, weights=weights, prompt=prompt,
                log=lambda *a: None)
    print(f"prefill: {res.prefill_s:.2f}s")
    n = args.new_tokens - 1
    dt = sum(res.decode_s)
    print(f"decode: {n} tokens x {args.batch} reqs in "
          f"{dt:.2f}s ({dt / max(n, 1) * 1000:.0f} ms/step)")
    gen = np.asarray(res.tokens)
    for b in range(min(args.batch, 3)):
        print(f"  req{b}: {gen[b, :12]} ...")
    return res


if __name__ == "__main__":
    main()
