"""Federated batching: per-(cluster, client) minibatch streams (numpy only;
a copy of ``repro.data.federated``, so both packages see the same batches).

Produces stacked arrays of shape (C, N, B, ...) for the vmap simulator and
flat (C*N*B, ...) global batches (client-major) for the sharded dist path,
so the same underlying stream feeds both execution paths (used by the
sim-vs-dist equivalence tests).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.common.spans import span


class FederatedBatcher:
    def __init__(self, partitions: List[List[Dict[str, np.ndarray]]], batch: int, seed: int = 0):
        self.partitions = partitions
        self.batch = batch
        self.n_clusters = len(partitions)
        self.n_clients = len(partitions[0])
        self._rng = np.random.default_rng(seed)

    def next_stacked(self):
        """Returns x (C,N,B,d) float32, y (C,N,B) int32."""
        with span("data.next_stacked"):
            xs, ys = [], []
            for cluster in self.partitions:
                cx, cy = [], []
                for client in cluster:
                    idx = self._rng.integers(0, client["x"].shape[0],
                                             size=self.batch)
                    cx.append(client["x"][idx])
                    cy.append(client["y"][idx])
                xs.append(np.stack(cx))
                ys.append(np.stack(cy))
            return (np.stack(xs).astype(np.float32),
                    np.stack(ys).astype(np.int32))

    def tasks(self) -> List[List[str]]:
        return [[cl["task"] for cl in cluster] for cluster in self.partitions]

    @staticmethod
    def flatten(x: np.ndarray) -> np.ndarray:
        """(C,N,B,...) -> (C*N*B, ...) client-major, matching the FL mesh
        device order (cluster major, then client, then within-client batch)."""
        return x.reshape((-1,) + x.shape[3:])
