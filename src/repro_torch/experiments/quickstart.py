"""Quickstart: train the paper's exact setting for a few rounds.

Port of ``examples/quickstart.py``: HOTA-FedGradNorm (Alg. 1 + 2) on
synthetic RadComDynamic with the Table-I MLP, C=4 clusters x N=3 clients,
fading MAC with AWGN, dynamic loss weights (γ = 0.6, α = 8e-3, lr 3e-4),
60 rounds; then ``sweep``: 3 channel scenarios in one ``ScenarioBank``
for 20 rounds. The same settings, keys and output lines, on the card
unless ``--device cpu`` (``n_points`` cuts the data set for a test)::

    PYTHONPATH=src python -m repro_torch.experiments.quickstart
    PYTHONPATH=src python -m repro_torch.experiments.quickstart --device cpu
"""
from __future__ import annotations

import argparse
from typing import Dict, List

import numpy as np
import torch

from repro_torch import rng
from repro_torch.common.config import FLConfig, ModelConfig, TrainConfig
from repro_torch.common.device import resolve_device
from repro_torch.core.paper_setup import paper_mlp_setup
from repro_torch.core.sim import HotaSim
from repro_torch.core.sweep import ScenarioBank
from repro_torch.data.federated import FederatedBatcher
from repro_torch.data.radcom import (
    N_CLASSES, RadComConfig, TASKS, client_partition, make_radcom_dataset,
)
from repro_torch.models.model import build_model

N_POINTS = 20_000
SEED = 0                   # the example's PRNGKey(0), for the init
SWEEP_SCENARIOS = {
    "hota_fgn": dict(),                               # fading MAC + FGN
    "equal": dict(weighting="equal"),                 # naive baseline
    "bad_channel": dict(sigma2=(0.05, 1.0, 1.0, 1.0)),   # one bad channel
}


def quickstart_sim(device="cuda", n_points: int = N_POINTS):
    """The example's (sim, batcher): 4 clusters x 3 clients, batch 32."""
    data = make_radcom_dataset(RadComConfig(n_points=n_points))
    parts = client_partition(data, n_clusters=4, n_clients=3)
    batcher = FederatedBatcher(parts, batch=32)
    n_cls = [N_CLASSES[TASKS[i % 3]] for i in range(3)]
    model = build_model(ModelConfig(family="mlp"))
    fl = FLConfig(n_clusters=4, n_clients=3, weighting="fedgradnorm",
                  h_threshold=3.2e-2, noise_std=1.0, gamma=0.6, alpha=8e-3)
    return HotaSim(model, fl, TrainConfig(lr=3e-4), n_cls,
                   device=device), batcher


def main(steps: int = 60, device="cuda",
         n_points: int = N_POINTS) -> List[Dict[str, np.ndarray]]:
    """Train ``steps`` rounds; returns each round's metrics on the host
    (the last round's also with the final ``state``)."""
    print("== HOTA-FedGradNorm quickstart ==")
    sim, batcher = quickstart_sim(resolve_device(device), n_points)
    state = sim.init(rng.PRNGKey(SEED))
    history = []
    for step in range(steps):
        x, y = batcher.next_stacked()
        state, m = sim.step(state, x, y, rng.PRNGKey(step))
        history.append({k: v.detach().cpu().numpy() for k, v in m.items()})
        if step % 10 == 0 or step == steps - 1:
            loss = history[-1]["loss"].mean(axis=0)   # per-task mean
            p = history[-1]["p"].mean(axis=0)
            print(f"round {step:3d} | loss per task "
                  f"mod={loss[0]:.3f} sig={loss[1]:.3f} anom={loss[2]:.3f} "
                  f"| p = [{p[0]:.3f} {p[1]:.3f} {p[2]:.3f}]")
    print("done — task weights adapted to task difficulty & channel state.")
    history[-1]["state"] = state
    return history


def sweep(steps: int = 20, device="cuda",
          n_points: int = N_POINTS) -> Dict[str, torch.Tensor]:
    """Multi-scenario sweep: 3 channel scenarios in ONE ``ScenarioBank``.

    The bank batches the channel knobs (σ², noise, threshold, OTA on/off,
    weighting) over a leading scenario axis; data batches and round keys
    are shared between scenarios (common random numbers), so the
    comparison is paired. Returns the (T, S, ...) metric history."""
    print("== 3-scenario ScenarioBank sweep ==")
    sim, batcher = paper_mlp_setup(FLConfig(n_clusters=4, n_clients=3),
                                   batch=32, n_points=n_points,
                                   device=resolve_device(device))
    bank = ScenarioBank(sim, list(SWEEP_SCENARIOS.values()))
    states = bank.init(rng.PRNGKey(SEED))
    states, history = bank.run(
        states, (batcher.next_stacked() for _ in range(steps)),
        [rng.PRNGKey(step) for step in range(steps)])
    loss = history["loss"][-1].mean(dim=(1, 2)).cpu().numpy()   # (S,)
    for lbl, l in zip(SWEEP_SCENARIOS, loss):
        print(f"  scenario {lbl:12s} mean loss after {steps} rounds: "
              f"{l:.3f}")
    print("one bank served all scenarios — same data, same channel draws.")
    return history


def cli(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    main(device=args.device)
    sweep(device=args.device)


if __name__ == "__main__":
    cli()
