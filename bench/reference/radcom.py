"""The data of the HOTA cells, made from the run's seed, and a frozen copy
of the federated batcher's draw.

``make_dataset`` builds the synthetic RadComDynamic stand-in of the
paper's experiments (Jagannath & Jagannath, ICC'21: 256-dim features,
modulation 6 classes, signal type 8, anomaly 2 with SNR < -4 dB as the
anomaly), ``partition`` splits it over C clusters x N clients with
Dirichlet(0.5) class skew, client i of each cluster holding task i mod 3.
Both sides of a run get these arrays. ``batches`` is the reference's own
copy of the batcher's draw: one ``numpy`` Generator seeded with the batch
seed, B uniform indices per client, clusters in order, clients in order,
each round.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

TASKS = ("modulation", "signal", "anomaly")
N_CLASSES = {"modulation": 6, "signal": 8, "anomaly": 2}


def make_dataset(seed: int, n_points: int, feature_dim: int = 256,
                 snr_threshold_db: float = -4.0,
                 task_scale=(0.55, 1.0, 1.4)) -> Dict[str, np.ndarray]:
    """'x' (n, d) float32 and one int64 label array per task."""
    rng = np.random.default_rng(seed)
    n, d = n_points, feature_dim
    mod = rng.integers(0, N_CLASSES["modulation"], size=n)
    sig = rng.integers(0, N_CLASSES["signal"], size=n)
    snr_db = rng.uniform(-10.0, 16.0, size=n)
    anomaly = (snr_db < snr_threshold_db).astype(np.int64)
    proto_mod = rng.normal(size=(N_CLASSES["modulation"], d)).astype(
        np.float32)
    proto_sig = rng.normal(size=(N_CLASSES["signal"], d)).astype(np.float32)
    mix = rng.normal(size=(d, d)).astype(np.float32) / np.sqrt(d)
    s_mod, s_sig, s_snr = task_scale
    x = (s_mod * proto_mod[mod] + s_sig * proto_sig[sig]).astype(np.float32)
    x = np.tanh(x @ mix) + 0.5 * x
    snr_lin = (10.0 ** (snr_db / 20.0)).astype(np.float32)[:, None]
    x = x * (0.25 + s_snr * snr_lin / (1.0 + snr_lin))
    x = x + rng.normal(size=(n, d)).astype(np.float32) * 0.35
    x = (x - x.mean(0)) / (x.std(0) + 1e-6)
    return {"x": x.astype(np.float32), "modulation": mod.astype(np.int64),
            "signal": sig.astype(np.int64), "anomaly": anomaly}


def partition(data: Dict[str, np.ndarray], n_clusters: int, n_clients: int,
              seed: int, alpha: float = 0.5) -> List[List[Dict]]:
    """C lists of N client dicts ('x', 'y', 'task', 'n_classes')."""
    rng = np.random.default_rng(seed)
    shards = np.array_split(rng.permutation(data["x"].shape[0]),
                            n_clusters * n_clients)
    out, k = [], 0
    for _ in range(n_clusters):
        clients = []
        for i in range(n_clients):
            task = TASKS[i % len(TASKS)]
            idx = shards[k]
            k += 1
            labels = data[task][idx]
            w = rng.dirichlet([alpha] * N_CLASSES[task])[labels]
            take = rng.choice(idx, size=len(idx), replace=True, p=w / w.sum())
            clients.append({"x": data["x"][take], "y": data[task][take],
                            "task": task, "n_classes": N_CLASSES[task]})
        out.append(clients)
    return out


def batches(parts: List[List[Dict]], batch: int, seed: int, rounds: int):
    """The first ``rounds`` (x (C, N, B, d) float32, y (C, N, B) int64)
    batches of the batcher seeded with ``seed``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(rounds):
        xs, ys = [], []
        for cluster in parts:
            cx, cy = [], []
            for client in cluster:
                idx = rng.integers(0, client["x"].shape[0], size=batch)
                cx.append(client["x"][idx])
                cy.append(client["y"][idx])
            xs.append(np.stack(cx))
            ys.append(np.stack(cy))
        out.append((np.stack(xs).astype(np.float32),
                    np.stack(ys).astype(np.int64)))
    return out
