"""A frozen copy of the threefry-2x32 key schedule and stream layout that
the simulated channel is defined by, in plain numpy and torch.

The channel of a HOTA round is a function of its random words, so the
reference has to draw the same words as the program under test. This
module holds its own copy of the hash (Salmon et al., "Parallel random
numbers: as easy as 1, 2, 3", SC'11; 20 rounds, as ``jax.random``
unrolls it) and of the layout built on it:

* ``fold_in(key, d)``: both output words of threefry2x32(key, (0, d));
* ``bits(key, i)``: word i of ``jax.random.bits(key)`` in the
  partitionable layout, the XOR of the two outputs of threefry2x32(key,
  (0, i));
* a chunk-quantized stream: word i of the stream of ``key`` is word
  ``i mod CHUNK`` of the bits of ``fold_in(key, i // CHUNK)``.

Keys are (..., 2) arrays of uint32 values. Key derivation runs in numpy
uint32 on the host; the bulk words are hashed on any torch device in
int64 tensors holding uint32 values (torch has no full uint32
arithmetic), masked back to 32 bits after every add.
"""
from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA
CHUNK = 1024 * 128          # words per chunk of a chunk-quantized stream


def _rotl(x, r: int):
    hi = x >> (32 - r)
    x = (x << r) & MASK32
    return x | hi


def threefry2x32(k0, k1, x0, x1):
    """The two output words of the hash; the operands broadcast together
    and are numpy uint32 arrays or uint32-valued int64 tensors."""
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def key_array(key) -> np.ndarray:
    """A key or key table as a uint32 numpy array of shape (..., 2)."""
    if isinstance(key, torch.Tensor):
        key = key.cpu().numpy()
    return (np.asarray(key).astype(np.int64) & MASK32).astype(np.uint32)


def fold_in(key, data) -> np.ndarray:
    """fold_in for a (..., 2) key table and integer data broadcasting
    against its leading dimensions: (..., 2) uint32."""
    k = key_array(key)
    d = (np.asarray(data).astype(np.int64) & MASK32).astype(np.uint32)
    with np.errstate(over="ignore"):
        y0, y1 = threefry2x32(k[..., 0].astype(np.uint64),
                              k[..., 1].astype(np.uint64),
                              np.zeros_like(d, dtype=np.uint64),
                              d.astype(np.uint64))
    return np.stack([y0, y1], axis=-1).astype(np.uint32)


def _words(keys: np.ndarray, counters: torch.Tensor) -> torch.Tensor:
    """bits(key, counter) for each key of a (K, 2) table against a (n,)
    int64 counter vector: (K, n) uint32 values in int64."""
    dev = counters.device
    k = torch.from_numpy(keys.astype(np.int64)).to(dev)
    k0, k1 = k[:, 0:1], k[:, 1:2]
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(counters)[None, :],
                          counters[None, :])
    return y0 ^ y1


def stream_words(keys, start: int, length: int, device) -> torch.Tensor:
    """Words [start, start + length) of the chunk-quantized stream of each
    key of a (K, 2) table: (K, length) uint32 values in int64."""
    keys = key_array(keys).reshape(-1, 2)
    out = torch.empty((keys.shape[0], length), dtype=torch.int64,
                      device=device)
    i = start
    while i < start + length:
        j = i // CHUNK
        stop = min((j + 1) * CHUNK, start + length)
        kj = fold_in(keys, j)
        ctr = torch.arange(i - j * CHUNK, stop - j * CHUNK,
                           dtype=torch.int64, device=device)
        out[:, i - start:stop - start] = _words(kj, ctr)
        i = stop
    return out
