"""Over-the-air aggregation over the fading MAC (paper Sec. III-B), the part
the simulator's main path runs.

Port of ``repro.core.ota``: the reserved fold registry and key schedule
(DESIGN.md §4), the chunk-quantized section streams, the client-folded
estimator ``ota_aggregate_client_folded`` and the eq.-5 masks
``final_layer_masks_packed``. The channel is defined by its random
streams, so every draw here is bit-identical to the reference's under
the same ``jax_threefry_partitionable`` mode (``repro_torch.rng``).

Keys are (2,) int64 host tensors of uint32 values; key derivation
(``fold_in``) stays on the host, and the stream words are drawn on the
device the caller names. A section's gain stream for cluster c is
chunk-quantized: chunk j holds ``bits(fold_in(fold_in(fold_in(key,
fold), c), j), CHUNK)`` and a partial last chunk is truncated.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch import rng
from repro_torch.common.flatpack import TreePacker, check_tree_matches_packer
from repro_torch.common.tree import tree_leaves, tree_unflatten
from repro_torch.core.channel import ChannelParams
from repro_torch.kernels.ota_channel.ops import ota_client_fold_apply
from repro_torch.kernels.ota_channel.ref import bits_to_mask
from repro_torch.kernels.slab import LANE

# --------------------------------------------------------------------------
# the reserved fold registry (DESIGN.md §4): same names, same values
# --------------------------------------------------------------------------
NOISE_FOLD = 0x7FFFFFFF          # AWGN stream (per-leaf and packed)
PACKED_HEAD_FOLD = 0x7FFF0001    # gain bits, packed head section
PACKED_TAIL_FOLD = 0x7FFF0002    # gain bits, packed tail (ω̃) section
SIM_CHAN_FOLD = 0x7FFF0003       # the simulator round's channel-key domain
PART_FOLD = 0x7FFF0004           # fault-participation draw domain
SAMPLE_FOLD = 0x7FFF0005         # client-sampling draw domain
PACKED_SECTION_FOLD_BASE = 0x7FFF0100   # + section index: trunk sections
FINAL_INIT_FOLD = 7              # ω̃ init off the trunk init key
SAMPLE_INIT_FOLD = 11            # population client-bank init
HOTA_MASK_SALT = 0xBEEF          # distributed backward's AWGN key
TUNE_PROBE_FOLD = 99             # layout autotuner's probe draw
PART_DROP_FOLD = 0               # client dropout uniforms
PART_BLACK_FOLD = 1              # cluster blackout uniforms
PART_STRAG_FOLD = 2              # straggler-flag uniforms

CHUNK_ROWS = 1024
CHUNK = CHUNK_ROWS * LANE        # the stream quantum (entries per chunk)


def cluster_key(key, cluster) -> torch.Tensor:
    return rng.fold_in(key, cluster)


def noise_key(key) -> torch.Tensor:
    """AWGN key in a fold-in domain no cluster index can reach."""
    return rng.fold_in(key, NOISE_FOLD)


def sim_channel_key(key) -> torch.Tensor:
    """The simulator round's channel key: every channel stream of a
    ``HotaSim.step`` folds off it (DESIGN.md §4)."""
    return rng.fold_in(key, SIM_CHAN_FOLD)


def _chunk_stream(keys: torch.Tensor, j0: int, j1: int,
                  device=None) -> torch.Tensor:
    """Chunks j0..j1 (inclusive) of each (..., 2) key's stream, laid end
    to end: (..., (j1 - j0 + 1) * CHUNK) int32 bit patterns."""
    keys = rng.as_key(keys)
    j = torch.arange(j0, j1 + 1, dtype=torch.int64)
    chunk_keys = rng.fold_in(keys.unsqueeze(-2), j)     # (..., n_chunks, 2)
    words = rng.bits(chunk_keys, CHUNK, device=device)  # (..., n_chunks, K)
    return words.reshape(words.shape[:-2] + (-1,))


def _chunked_stream(key, length: int, device=None) -> torch.Tensor:
    """(..., length) words of each key's chunk-quantized stream."""
    n_chunks = -(-length // CHUNK)
    return _chunk_stream(key, 0, n_chunks - 1, device)[..., :length]


def _section_bits(key, fold: int, n_clusters: int, length: int,
                  device=None) -> torch.Tensor:
    """(C, length) gain bits of one section: cluster c's stream is keyed
    ``fold_in(fold_in(key, fold), c)``."""
    skey = rng.fold_in(key, fold)
    ckeys = cluster_key(skey.unsqueeze(0),
                        torch.arange(n_clusters, dtype=torch.int64))
    return _chunked_stream(ckeys, length, device)


def packed_section_folds(packer: TreePacker) -> List[int]:
    """The stream fold of each ``packer.sections`` entry: the tail keeps
    PACKED_TAIL_FOLD in every layout; the two-section layout's head is
    PACKED_HEAD_FOLD; "toplevel" trunk section s folds BASE + s."""
    folds = []
    for sec in packer.sections:
        if sec.name == packer.tail_name:
            folds.append(PACKED_TAIL_FOLD)
        elif packer.layout == "tail":
            folds.append(PACKED_HEAD_FOLD)
        else:
            folds.append(PACKED_SECTION_FOLD_BASE + sec.index)
    return folds


def stream_range_bits(key, start: int, length: int,
                      device=None) -> torch.Tensor:
    """Words [start, start + length) of ``key``'s chunk-quantized stream;
    only the chunks that meet the range are drawn."""
    j0 = start // CHUNK
    j1 = (start + length - 1) // CHUNK
    a = start - j0 * CHUNK
    return _chunk_stream(key, j0, j1, device)[..., a:a + length]


def section_gain_key(slab_key, fold: int, cluster) -> torch.Tensor:
    """Gain-stream key of one (section, cluster)."""
    return cluster_key(rng.fold_in(slab_key, fold), cluster)


def section_noise_key(slab_key, fold: int) -> torch.Tensor:
    """AWGN-stream key of one section."""
    return rng.fold_in(noise_key(slab_key), fold)


def section_gain_streams(key, packer: TreePacker, n_clusters: int,
                         device=None) -> List[torch.Tensor]:
    """One (C, length) gain stream per section, under its fold. The
    (section, cluster) keys are derived for all sections at once."""
    folds = torch.tensor(packed_section_folds(packer), dtype=torch.int64)
    skeys = rng.fold_in(rng.as_key(key).unsqueeze(0), folds)     # (S, 2)
    ckeys = cluster_key(skeys.unsqueeze(1),
                        torch.arange(n_clusters, dtype=torch.int64))
    return [_chunked_stream(ckeys[sec.index], sec.length, device)
            for sec in packer.sections]


def section_noise_streams(key, packer: TreePacker,
                          device=None) -> List[torch.Tensor]:
    """One (length,) AWGN stream per section, under its fold."""
    folds = torch.tensor(packed_section_folds(packer), dtype=torch.int64)
    nkeys = rng.fold_in(noise_key(key).unsqueeze(0), folds)      # (S, 2)
    return [_chunked_stream(nkeys[sec.index], sec.length, device)
            for sec in packer.sections]


# --------------------------------------------------------------------------
# the channel on the simulator's main path
# --------------------------------------------------------------------------

def ota_aggregate_client_folded(key, grads, p: torch.Tensor,
                                chan: ChannelParams, n_clients: int,
                                packer: TreePacker,
                                live: Optional[torch.Tensor] = None,
                                n_eff: Optional[torch.Tensor] = None):
    """PS estimate ĝ of eqs. 3 + 8-10 from the raw (C, N, ...) gradient
    tree and the (C, N) loss weights, one leaf at a time: each leaf is
    read in place and meets its slice of its section's streams, so
    neither the client-weighted tree nor a (C, P) slab is built. Returns
    a tree of ĝ leaves shaped like the model's parameters."""
    check_tree_matches_packer(packer, grads,
                              "gradient tree (client-folded OTA)",
                              batch_ndim=2)
    n_clusters = int(chan.sigma2.shape[0])
    device = p.device
    gbits = section_gain_streams(key, packer, n_clusters, device)
    nbits = section_noise_streams(key, packer, device)
    leaves = tree_leaves(grads)
    out = [None] * len(leaves)
    for run in packer.leaf_runs():
        b = gbits[run.section][:, run.offset:run.offset + run.size]
        nb = nbits[run.section][run.offset:run.offset + run.size]
        out[run.leaf] = ota_client_fold_apply(
            leaves[run.leaf], p, b, nb, chan.sigma2, chan.h_threshold,
            chan.noise_std, chan.ota_on, n_clients, live=live, n_eff=n_eff)
    return tree_unflatten(grads, out)


def final_layer_masks_packed(key, chan: ChannelParams, packer: TreePacker):
    """Masks M^(l) on the last-shared-layer params ω̃ (eqs. 5-7), drawn
    from the tail section's stream: the same masks the aggregation
    applies to those entries. Returns the tail subtree of (C, *shape)
    bool masks."""
    if packer.tail_name is None or not packer.tail_len:
        raise ValueError("final_layer_masks_packed needs a packer with a "
                         "non-empty tail section (the ω̃ params)")
    n_clusters = int(chan.sigma2.shape[0])
    tail_sec = next(s for s in packer.sections
                    if s.name == packer.tail_name)
    bits = _section_bits(key, PACKED_TAIL_FOLD, n_clusters, tail_sec.length,
                         chan.sigma2.device)
    sig = chan.sigma2.reshape(n_clusters, 1)
    masks = {}
    for run in packer.leaf_runs():
        if run.section != tail_sec.index:
            continue
        b = bits[:, run.offset:run.offset + run.size]
        m = bits_to_mask(b, sig, chan.h_threshold, chan.ota_on)
        node = masks
        path = packer.paths[run.leaf][1:]
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = m.reshape((n_clusters,) + packer.slots[run.leaf].shape)
    return masks
