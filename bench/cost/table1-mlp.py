"""Closed-form work of one scenario round of the Table-I bank, from the
configuration's shapes alone (never from what the program launches).

FLOPs (2 per multiply-add) of every client's MLP on its batch of B: the
forward of the shared network once, its backward (weight gradients of
every layer, input gradients of all but the first), and the head: its
forward and weight gradient in the head step, its forward under the new
head and its input gradient in the ω step. No recomputation is counted.

Bytes of K1, the over-the-air client fold, per round: each (C, N, n)
gradient entry, each (C, n) gain word and each (n,) noise word read
once, the (n,) estimate written once, over every leaf of ω.
"""


def _weights(dims):
    return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def round_flops(n_clusters, n_clients, batch, dims, n_classes):
    w = _weights(dims)
    first = dims[0] * dims[1]
    head = dims[-1] * n_classes
    per_client = 2 * batch * (w + w + (w - first) + 4 * head)
    return n_clusters * n_clients * per_client


def k1_bytes(n_clusters, n_clients, dims):
    n = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
    return 4 * n * (n_clusters * n_clients + n_clusters + 1 + 1)
