"""Federated HOTA-FedGradNorm training of a ~100M-parameter dense LM on
the distributed step.

Port of ``examples/train_lm_federated.py``: the same model (``LM_100M``),
topology, flags and printed lines. Each of the four clients owns a
differently skewed synthetic token stream (Zipf exponent 1.05 + 0.15·i:
statistical heterogeneity) and a personalized vocab head; dynamic
FedGradNorm weighting and the fading-MAC OTA aggregation run between the
cluster ISs and the PS. The reference's mesh is 2 clusters × 2 clients ×
2 model replicas; no layout names the "model" axis, so its ranks run the
same step as the FL ranks (``launch.train``), here one process per
position on the card unless ``--device cpu``::

    PYTHONPATH=src python -m repro_torch.experiments.train_lm_federated \\
        --steps 200

Rank 0 writes the shared network's checkpoint (the global ω, in the
reference's format, metadata ``params_m``) to ``--out``.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch import rng
from repro_torch.checkpoint.store import save_checkpoint
from repro_torch.common.config import FLConfig, ModelConfig, TrainConfig
from repro_torch.common.device import resolve_device
from repro_torch.convert import hota_state_to_numpy
from repro_torch.core.hota_step import make_hota_train_step
from repro_torch.data.lm import synthetic_lm_batches
from repro_torch.launch.mesh import run_ranks
from repro_torch.launch.train import MESH_AXES
from repro_torch.models.model import build_model
from repro_torch.models.params import param_count

# ~100M-parameter dense GQA transformer: 94,224,000 shared floats (the
# embedding, 12 layers of 6,145,280, the final norm), a 20,480,000-float
# head per client
LM_100M = ModelConfig(
    name="lm-100m", family="dense", n_layers=12, d_model=640, n_heads=8,
    n_kv_heads=4, d_ff=2560, vocab_size=32_000, compute_dtype="float32",
    remat_policy="none", attn_block_q=64, attn_block_kv=64)
MESH = (2, 2, 2)                 # clusters, clients, model replicas
FL = dict(n_clusters=2, n_clients=2, noise_std=0.5, ota_mode="scatter")
LR = 3e-4
SEED_KEY, ROUND_KEY = 0, 1       # PRNGKey(0) inits, PRNGKey(1) every round


def client_streams(cfg: ModelConfig, batch_per_client: int, seq_len: int,
                   n_clients: int = 4):
    """Client i's stream: its own seed and Zipf exponent 1.05 + 0.15·i."""
    return [synthetic_lm_batches(cfg.vocab_size, batch_per_client, seq_len,
                                 seed=i, zipf_s=1.05 + 0.15 * i)
            for i in range(n_clients)]


def next_batch(streams):
    """The round's global (tokens, labels): the clients' batches stacked
    client-major, numpy int32 (B·n_clients, S)."""
    toks, labs = zip(*(next(s) for s in streams))
    return np.concatenate(toks), np.concatenate(labs)


def train_rank(mesh, args, cfg: ModelConfig = LM_100M):
    """One rank's run of ``args``'s rounds on ``cfg`` (``LM_100M``, or a
    smaller model of the same family); returns the losses. Rank 0 prints
    the example's lines and writes the checkpoint."""
    if mesh.device.type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // mesh.size))
    lead = mesh.rank == 0
    model = build_model(cfg)
    fl = FLConfig(weighting=args.weighting, **FL)
    init_fn, step_fn, specs, batch_spec = make_hota_train_step(
        model, mesh, fl, TrainConfig(lr=LR), loss_kind="lm")
    state = init_fn(rng.PRNGKey(SEED_KEY))
    n_params = param_count({"t": model.trunk_specs()})
    if lead:
        print(f"model: {n_params/1e6:.1f}M shared params", flush=True)
    streams = client_streams(cfg, args.batch_per_client, args.seq_len)
    me = mesh.axis_index(batch_spec[0][0])
    rows = slice(me * args.batch_per_client,
                 (me + 1) * args.batch_per_client)
    key = rng.PRNGKey(ROUND_KEY)
    losses = []
    t0 = time.time()
    for step in range(args.steps):
        toks, labs = next_batch(streams)
        state, m = step_fn(state, toks[rows], labs[rows], key)
        losses.append(float(m["loss"]))
        if lead and (step % 10 == 0 or step == args.steps - 1):
            print(f"round {step:4d} | loss {float(m['loss']):.4f} | "
                  f"p∈[{float(m['p_min']):.3f},{float(m['p_max']):.3f}] | "
                  f"fgrad {float(m['fgrad']):.3f} | "
                  f"{(time.time()-t0)/(step+1):.2f}s/round", flush=True)
    omega = hota_state_to_numpy(state.omega, specs.omega, mesh)
    if lead:
        os.makedirs(args.out, exist_ok=True)
        path = save_checkpoint(args.out, args.steps, omega,
                               {"params_m": n_params / 1e6})
        print("saved shared-network checkpoint:", path, flush=True)
    return losses


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch-per-client", type=int, default=4)
    ap.add_argument("--weighting", default="fedgradnorm")
    ap.add_argument("--out", default="results/example_lm")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: every rank on the card) or cpu")
    return ap


def main(argv=None):
    """The example's run of ``LM_100M`` on ``MESH``; returns each rank's
    losses."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":      # built once, before the ranks start
        from repro_torch.kernels import _build
        _build.library()
    return run_ranks(train_rank, (args,), shape=MESH, axes=MESH_AXES,
                     device=str(dev), timeout_s=1800)


if __name__ == "__main__":
    main()
