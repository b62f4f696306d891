"""Federated batching: per-(cluster, client) minibatch streams (numpy only).

The batches and the generator stream are those of ``repro.data.federated``
(B uniform indices per client, clusters in order, clients in order), drawn
in one call: one broadcast ``Generator.integers`` over every client's pool
size and one gather from the clients' pools concatenated.

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
    """Draws (C, N, B, ...) batches from the clients' pools.

    The pools are snapshotted when the batcher is built: every client's
    ``x`` (as float32) and ``y`` (as int32) are copied, cluster-major then
    client-minor, into one pool each, so a later change to ``partitions``
    does not reach the batches. ``partitions`` is kept for ``tasks``."""

    def __init__(self, partitions: List[List[Dict[str, np.ndarray]]], batch: int, seed: int = 0):
        self.partitions = partitions
        self.batch = batch
        self.n_clusters = len(partitions)
        self.n_clients = len(partitions[0])
        self._rng = np.random.default_rng(seed)
        clients = [client for cluster in partitions for client in cluster]
        self._sizes = np.array([c["x"].shape[0] for c in clients], np.int64)
        self._offsets = np.cumsum(self._sizes) - self._sizes
        self._x = np.concatenate([c["x"] for c in clients], dtype=np.float32)
        self._y = np.concatenate([c["y"] for c in clients], dtype=np.int32)

    def next_stacked(self):
        """Returns x (C,N,B,d) float32, y (C,N,B) int32, fresh each call.

        One draw of (C*N, B) indices, row k in [0, n_k): the generator
        stream of drawing B indices per client in turn. A client with an
        empty pool raises ``ValueError``."""
        with span("data.next_stacked"):
            idx = self._rng.integers(0, self._sizes[:, None],
                                     size=(self._sizes.size, self.batch))
            idx += self._offsets[:, None]
            lead = (self.n_clusters, self.n_clients, self.batch)
            x = np.take(self._x, idx, axis=0)
            y = np.take(self._y, idx, axis=0)
            return (x.reshape(lead + self._x.shape[1:]),
                    y.reshape(lead + self._y.shape[1:]))

    def tasks(self) -> List[List[str]]:
        return [[cl["task"] for cl in cluster] for cluster in self.partitions]

    @staticmethod
    def flatten(x: np.ndarray) -> np.ndarray:
        """(C,N,B,...) -> (C*N*B, ...) client-major, matching the FL mesh
        device order (cluster major, then client, then within-client batch)."""
        return x.reshape((-1,) + x.shape[3:])
