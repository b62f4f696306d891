"""Synthetic RadComDynamic (numpy only; a copy of ``repro.data.radcom`` so
the port depends on nothing in the JAX package and draws identical data).

The real RadComDynamic dataset [Jagannath & Jagannath, ICC'21] is not
available offline (DESIGN.md §2). This module generates a synthetic stand-in
with the same schema and the statistical structure the paper's experiments
rely on:

* 125,000 points, 256-dim features (the paper's shared net is FC(256,512)...),
* task 1 — modulation classification, 6 classes
  (amdsb, amssb, ask, bpsk, fmcw, pcw),
* task 2 — signal-type classification, 8 classes
  (AM radio, short-range, radar-altimeter, air-ground-MTI,
  airborne-detection, airborne-range, ground-mapping, +1 to total 8),
* task 3 — anomaly detection: SNR < -4 dB is anomalous (SNR is drawn per
  sample and baked into the features, so the task is learnable),
* tasks have *different difficulty* (class-dependent feature scale and
  noise), which is exactly the statistical heterogeneity FedGradNorm exists
  to balance.

Features are built from class-conditional random prototypes + per-class
nonlinear mixing + noise whose level differs per task, so the three tasks
train at different speeds — reproducing the paper's setting where task 1
(modulation) is initially slower (Fig. 2).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

TASKS = ("modulation", "signal", "anomaly")
N_CLASSES = {"modulation": 6, "signal": 8, "anomaly": 2}
FEATURE_DIM = 256


@dataclass(frozen=True)
class RadComConfig:
    n_points: int = 125_000
    feature_dim: int = FEATURE_DIM
    seed: int = 1234
    snr_threshold_db: float = -4.0
    # per-task feature signal-to-noise (controls task difficulty / speed):
    # modulation is made the hardest (lowest scale), matching Fig. 2 where
    # task 1's loss moves slowest at the start.
    task_scale: Tuple[float, float, float] = (0.55, 1.0, 1.4)


def make_radcom_dataset(cfg: RadComConfig = RadComConfig()) -> Dict[str, np.ndarray]:
    """Returns dict with 'x' (n,256) float32 and one label array per task."""
    rng = np.random.default_rng(cfg.seed)
    n, d = cfg.n_points, cfg.feature_dim

    mod = rng.integers(0, N_CLASSES["modulation"], size=n)
    sig = rng.integers(0, N_CLASSES["signal"], size=n)
    snr_db = rng.uniform(-10.0, 16.0, size=n)
    anomaly = (snr_db < cfg.snr_threshold_db).astype(np.int64)

    # class prototypes living in disjoint-ish subspaces per task
    proto_mod = rng.normal(size=(N_CLASSES["modulation"], d)).astype(np.float32)
    proto_sig = rng.normal(size=(N_CLASSES["signal"], d)).astype(np.float32)
    mix = rng.normal(size=(d, d)).astype(np.float32) / np.sqrt(d)

    s_mod, s_sig, s_snr = cfg.task_scale
    x = (
        s_mod * proto_mod[mod]
        + s_sig * proto_sig[sig]
    ).astype(np.float32)
    # nonlinear mixing makes the tasks non-trivially coupled
    x = np.tanh(x @ mix) + 0.5 * x
    # SNR enters multiplicatively (low SNR -> attenuated + noisier signal),
    # making anomaly detection learnable from feature statistics.
    snr_lin = (10.0 ** (snr_db / 20.0)).astype(np.float32)[:, None]
    gain = snr_lin / (1.0 + snr_lin)
    x = x * (0.25 + s_snr * gain)
    x = x + rng.normal(size=(n, d)).astype(np.float32) * 0.35
    # normalize
    x = (x - x.mean(0)) / (x.std(0) + 1e-6)

    return {
        "x": x.astype(np.float32),
        "modulation": mod.astype(np.int64),
        "signal": sig.astype(np.int64),
        "anomaly": anomaly,
        "snr_db": snr_db.astype(np.float32),
    }


def client_partition(
    data: Dict[str, np.ndarray],
    n_clusters: int,
    n_clients: int,
    seed: int = 0,
    noniid_alpha: float = 0.5,
) -> List[List[Dict[str, np.ndarray]]]:
    """Partition the dataset across C clusters x N clients, non-iid.

    Client i of every cluster owns task TASKS[i % 3] (paper: tasks within a
    cluster are distinct). Non-iid-ness: each client's sample pool is drawn
    with Dirichlet(alpha) class skew over its own task's classes.
    """
    rng = np.random.default_rng(seed)
    n = data["x"].shape[0]
    perm = rng.permutation(n)
    shards = np.array_split(perm, n_clusters * n_clients)

    out: List[List[Dict[str, np.ndarray]]] = []
    k = 0
    for c in range(n_clusters):
        cluster_clients = []
        for i in range(n_clients):
            task = TASKS[i % len(TASKS)]
            idx = shards[k]
            k += 1
            labels = data[task][idx]
            n_cls = N_CLASSES[task]
            # Dirichlet reweighting for non-iid class skew
            weights = rng.dirichlet([noniid_alpha] * n_cls)
            p = weights[labels]
            p = p / p.sum()
            take = rng.choice(idx, size=len(idx), replace=True, p=p)
            cluster_clients.append({
                "x": data["x"][take],
                "y": data[task][take],
                "task": task,
                "n_classes": n_cls,
            })
        out.append(cluster_clients)
    return out
