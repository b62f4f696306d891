"""Over-the-air aggregation over the fading MAC (paper Sec. III-B).

Port of ``repro.core.ota``: the reserved fold registry and key schedule
(DESIGN.md §4), the round's fault participation (``draw_participation``,
DESIGN.md §3.14) and client sample (``draw_client_sample``, §3.15), the
chunk-quantized section streams, the eq.-5 masks
(``final_layer_masks_packed``, and ``final_layer_masks`` for the per-leaf
oracle) and the aggregation engines:

* ``ota_aggregate_tree``: the per-leaf oracle, gains drawn per (leaf,
  cluster) through ``rng.normal`` and thresholded as |H|² ≥ H_th (eq. 7);
* ``ota_aggregate_packed``: pack the (C, ...) weighted tree into a
  (C, P) slab, one K4 launch per section (stream words drawn in the
  kernel), or K3 on words drawn outside (``bits_mode="supplied"``);
* ``ota_aggregate_client_folded``: every cluster's streams drawn at once,
  one K1 launch per leaf;
* ``ota_aggregate_streaming``: one cluster at a time (the reference's
  cluster ``lax.scan`` is a Python loop here), one K5 launch per
  (cluster, leaf), with no (C, section) stream or mask alive;
* ``ota_aggregate_sectioned``: one section at a time, either folding all
  clusters (bit-identical to the client-folded engine) or streaming them
  inside the section (bit-identical to the streaming engine).

Every engine takes the round's participation as ``live`` (C,) and
``n_eff`` (): a dead cluster adds neither data nor count, and N_eff
replaces N in eq. 10. The faithful channel-inversion helpers
(``tree_channel``, ``power_allocation``, ``transmit_signal``,
``transmit_power``) are run by no engine; they state eq. 3 as written.

The channel is defined by its random streams, so every draw here is
bit-identical to the reference's under the same
``jax_threefry_partitionable`` mode (``repro_torch.rng``).

Keys are (2,) int64 host tensors of uint32 values; key derivation
(``fold_in``) stays on the host, and the stream words are drawn on the
device the caller names. A section's gain stream for cluster c is
chunk-quantized: chunk j holds ``bits(fold_in(fold_in(fold_in(key,
fold), c), j), CHUNK)`` and a partial last chunk is truncated, so any
range of it can be drawn on its own (``stream_range_bits``).
"""
from __future__ import annotations

from typing import Any, List, NamedTuple, Optional

import torch

from repro_torch import rng
from repro_torch.common.flatpack import TreePacker, check_tree_matches_packer
from repro_torch.common.tree import tree_leaves, tree_unflatten
from repro_torch.core.channel import ChannelParams
from repro_torch.kernels.ota_channel.ops import (
    _ota_aggregate_fused_impl, bits, chunked_stream, ota_client_fold_apply,
    ota_stream_fold_apply, stream_range,
)
from repro_torch.kernels.ota_channel.ref import (
    CHUNK, CHUNK_ROWS, bits_to_gaussian, bits_to_mask,
)

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


def cluster_key(key, cluster) -> torch.Tensor:
    return rng.fold_in(key, cluster)


def leaf_key(ckey, leaf_idx) -> torch.Tensor:
    return rng.fold_in(ckey, leaf_idx)


def noise_key(key) -> torch.Tensor:
    """AWGN key in a fold-in domain no cluster index can reach."""
    return rng.fold_in(key, NOISE_FOLD)


def sim_channel_key(key) -> torch.Tensor:
    """The simulator round's channel key: every channel stream of a
    ``HotaSim.step`` folds off it (DESIGN.md §4)."""
    return rng.fold_in(key, SIM_CHAN_FOLD)


def participation_key(key) -> torch.Tensor:
    """The round's participation-draw key: every fault draw (dropout,
    blackout, straggler) folds off it, in a reserved domain disjoint from
    every channel stream (DESIGN.md §4)."""
    return rng.fold_in(key, PART_FOLD)


def sample_key(key) -> torch.Tensor:
    """The round's client-sample key (DESIGN.md §4): the id draw that
    fills each (cluster, slot) position from its subpopulation folds off
    it, in a reserved domain disjoint from every channel and participation
    stream, so resampling moves no mask, noise or fault draw."""
    return rng.fold_in(key, SAMPLE_FOLD)


def draw_client_sample(key, n_clusters: int, n_clients: int,
                       population: int, device=None) -> torch.Tensor:
    """(C, N) int32 ids in [0, population) on ``device`` (default: the
    host): which member of each (cluster, slot) subpopulation takes part
    this round (DESIGN.md §3.15), equal to the reference's
    ``jax.random.randint(sample_key(key), (C, N), 0, population)`` in
    both threefry layouts. A pure function of the round key: O(C·N) work
    whatever the population, and a host can recompute it without state.
    Both words of every id come from one stream-draw launch
    (``ops.bits`` over the (2, 2) table of ``split(sample_key(key))``)."""
    cn = n_clusters * n_clients
    words = bits(rng.split(sample_key(key), 2), cn, device)
    ids = rng.randint_from_words(words[0], words[1], 0, population)
    return ids.reshape(n_clusters, n_clients)


class Participation(NamedTuple):
    """One round's fault realization, all float32 tensors. With no fault
    injected ``part`` and ``live`` are all ones and ``n_eff`` is N."""
    part: torch.Tensor     # (C, N) 1.0 = the client takes part
    stale: torch.Tensor    # (C, N) 1.0 = it takes part with a stale model
    live: torch.Tensor     # (C,)   1.0 = the cluster has a participant
    n_live: torch.Tensor   # ()     live-cluster count
    total: torch.Tensor    # ()     participant count
    n_eff: torch.Tensor    # ()     total / max(n_live, 1): eq. 10's N


def draw_participation(key, faults, n_clusters: int, n_clients: int,
                       device=None) -> Participation:
    """The round's participation (DESIGN.md §3.14), equal to the
    reference's: one uniform per (kind, slot) under the sub-folds of
    ``participation_key(key)``, compared with the rates of ``faults``
    (a ``FaultParams``) on ``device`` (default: the knobs' device).

    The words come from the stream-draw kernel (``ops.bits``): the
    dropout and straggler draws, both of C·N words, in one launch over
    a (2, 2) key table, and the blackout draw of C words in another (its
    words depend on its length in the original threefry layout, so it
    is not a prefix of the longer draws)."""
    dev = faults.dropout.device if device is None else torch.device(device)
    pk = participation_key(key)
    cn = n_clusters * n_clients
    u = rng.uniform_from_words(bits(
        rng.fold_in(pk, [PART_DROP_FOLD, PART_STRAG_FOLD]), cn, dev))
    u_drop, u_strag = u.reshape(2, n_clusters, n_clients).unbind(0)
    u_black = rng.uniform_from_words(bits(
        rng.fold_in(pk, PART_BLACK_FOLD), n_clusters, dev))
    on = faults.faults_on.to(dev) >= 0.5
    drop = on & (u_drop < faults.dropout.to(dev))
    black = on & (u_black < faults.blackout.to(dev))
    part = (~drop & ~black.unsqueeze(1)).to(torch.float32)
    stale = part * (on & (u_strag < faults.straggler.to(dev))).to(
        torch.float32)
    live = (part.sum(dim=1) > 0).to(torch.float32)
    n_live = live.sum()
    total = part.sum()
    return Participation(part=part, stale=stale, live=live, n_live=n_live,
                         total=total,
                         n_eff=total / torch.clamp(n_live, min=1.0))


def _section_bits(key, fold: int, n_clusters: int, length: int,
                  device=None) -> torch.Tensor:
    """(C, length) gain bits of one section: cluster c's stream is keyed
    ``fold_in(fold_in(key, fold), c)``."""
    skey = rng.fold_in(key, fold)
    ckeys = cluster_key(skey.unsqueeze(0),
                        torch.arange(n_clusters, dtype=torch.int64))
    return chunked_stream(ckeys, length, device)


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
    only the chunks that meet the range are drawn (on the card, only the
    range's words)."""
    return stream_range(key, start, length, device)


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
    return [chunked_stream(ckeys[sec.index], sec.length, device)
            for sec in packer.sections]


def section_noise_streams(key, packer: TreePacker,
                          device=None) -> List[torch.Tensor]:
    """One (length,) AWGN stream per section, under its fold."""
    folds = torch.tensor(packed_section_folds(packer), dtype=torch.int64)
    nkeys = rng.fold_in(noise_key(key).unsqueeze(0), folds)      # (S, 2)
    return [chunked_stream(nkeys[sec.index], sec.length, device)
            for sec in packer.sections]


def packed_gain_bits(key, packer: TreePacker, n_clusters: int,
                     device=None) -> torch.Tensor:
    """The round's (C, P) gain words: the per-section streams of
    ``section_gain_streams`` in layout order."""
    parts = section_gain_streams(key, packer, n_clusters, device)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def packed_noise_bits(key, packer: TreePacker, device=None) -> torch.Tensor:
    """The round's (P,) AWGN words, section by section."""
    parts = section_noise_streams(key, packer, device)
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def packed_section_keys(key, packer: TreePacker) -> torch.Tensor:
    """(S, 2, 2) keys of the packer's sections in layout order: [gain,
    AWGN] = [fold_in(key, f), fold_in(noise_key(key), f)] for each
    section fold f of ``packed_section_folds``."""
    folds = torch.tensor(packed_section_folds(packer), dtype=torch.int64)
    k = rng.as_key(key).unsqueeze(0)
    return torch.stack([rng.fold_in(k, folds),
                        rng.fold_in(noise_key(key).unsqueeze(0), folds)],
                       dim=1)


class SectionStreams(NamedTuple):
    """A round's stream words for every section, drawn at once: what the
    client-folded engine and the eq.-5 masks read. The scenario bank
    draws them once per round and hands them to every scenario."""
    gain: List[torch.Tensor]    # per section: (C, length) int32
    noise: List[torch.Tensor]   # per section: (length,) int32


def section_streams(key, packer: TreePacker, n_clusters: int,
                    device=None) -> SectionStreams:
    """The round's gain and AWGN streams of every section under ``key``
    (the simulator round's channel key)."""
    return SectionStreams(
        section_gain_streams(key, packer, n_clusters, device),
        section_noise_streams(key, packer, device))


def _check_streams(streams: SectionStreams, packer: TreePacker,
                   n_clusters: int) -> None:
    """Raise unless ``streams`` holds one gain and one noise stream of the
    right shape for each of ``packer``'s sections."""
    if (len(streams.gain) != len(packer.sections)
            or len(streams.noise) != len(packer.sections)):
        raise ValueError(f"streams hold {len(streams.gain)} gain and "
                         f"{len(streams.noise)} noise sections, the layout "
                         f"has {len(packer.sections)}")
    for sec in packer.sections:
        if (tuple(streams.gain[sec.index].shape) != (n_clusters, sec.length)
                or tuple(streams.noise[sec.index].shape) != (sec.length,)):
            raise ValueError(
                f"section {sec.index}: streams shaped "
                f"{tuple(streams.gain[sec.index].shape)} / "
                f"{tuple(streams.noise[sec.index].shape)}, expected "
                f"({n_clusters}, {sec.length}) / ({sec.length},)")


def _check_bits_mode(bits_mode: str) -> None:
    if bits_mode not in ("fused", "supplied"):
        raise ValueError(f"bits_mode must be 'fused' or 'supplied', got "
                         f"{bits_mode!r}")


# --------------------------------------------------------------------------
# the per-leaf oracle
# --------------------------------------------------------------------------

def sample_gain(key, shape, sigma2, device=None) -> torch.Tensor:
    """Gains H ~ N(0, σ²) of ``shape`` from ``key`` (or from a (..., 2) key
    table, with ``sigma2`` broadcasting against the result)."""
    dev = device if device is not None else torch.as_tensor(sigma2).device
    return rng.normal(key, shape, device=dev) * torch.sqrt(
        torch.as_tensor(sigma2, dtype=torch.float32, device=dev))


def gain_mask(h: torch.Tensor, h_threshold) -> torch.Tensor:
    """eq. (7): pass the entries with |H|² ≥ H_th."""
    return (h * h) >= h_threshold


def _cluster_gains(ks, shape, chan: ChannelParams, device) -> torch.Tensor:
    """(C, *shape) gains of one leaf: cluster c's draw is keyed
    ``cluster_key(ks, c)`` and scaled by √σ²_c."""
    n_clusters = int(chan.sigma2.shape[0])
    ckeys = cluster_key(rng.as_key(ks).unsqueeze(0),
                        torch.arange(n_clusters, dtype=torch.int64))
    sig = chan.sigma2.to(device).reshape((n_clusters,) + (1,) * len(shape))
    return sample_gain(ckeys, shape, sig, device=device)


def _leaf_masks(ks, shape, chan: ChannelParams, device) -> torch.Tensor:
    """(C, *shape) eq.-7 masks of one leaf; ``ota_on`` off passes all."""
    hs = _cluster_gains(ks, shape, chan, device)
    return torch.logical_or(gain_mask(hs, chan.h_threshold.to(device)),
                            chan.ota_on.to(device) < 0.5)


def tree_channel(key, tree, sigma2, h_threshold):
    """(gains, masks) trees shaped like ``tree``: leaf i's gains are
    ``sample_gain(leaf_key(key, i))``, its masks eq. 7."""
    leaves = tree_leaves(tree)
    gains = [sample_gain(leaf_key(key, i), tuple(l.shape), sigma2,
                         device=l.device) for i, l in enumerate(leaves)]
    masks = [gain_mask(h, h_threshold) for h in gains]
    return tree_unflatten(tree, gains), tree_unflatten(tree, masks)


def power_allocation(p_i, h: torch.Tensor, mask: torch.Tensor
                     ) -> torch.Tensor:
    """eq. (3): β = p / H where the channel passes, else 0."""
    safe_h = torch.where(mask, h, torch.ones_like(h))
    return torch.where(mask, p_i / safe_h, torch.zeros_like(h))


def transmit_signal(p_i, g, h, mask) -> torch.Tensor:
    """x^(l,i) = β ∘ g: what a cluster's IS puts on the air for one
    client's gradient, with the channel inversion written out."""
    return power_allocation(p_i, h, mask) * g


def transmit_power(x: torch.Tensor) -> torch.Tensor:
    """The instantaneous ‖x‖² of the average power constraint (eq. 4)."""
    return torch.sum(torch.square(x))


def ota_aggregate_leaf(weighted_grads: torch.Tensor, masks: torch.Tensor,
                       noise: torch.Tensor, n_clients: int,
                       live=None, n_eff=None) -> torch.Tensor:
    """eqs. (8)-(10) for one leaf: y = Σ_l M_l ∘ wg_l + z, then the
    guarded |M|·N estimate. ``live`` (C,) ANDs into the masks; ``n_eff``
    replaces the static N."""
    if live is not None:
        lv = torch.as_tensor(live, dtype=torch.float32,
                             device=masks.device).reshape(
            (masks.shape[0],) + (1,) * (masks.dim() - 1))
        masks = torch.logical_and(masks, lv > 0.5)
    wg = weighted_grads.to(torch.float32)
    y = torch.sum(torch.where(masks, wg, torch.zeros_like(wg)), dim=0)
    y = y + noise
    cnt = torch.sum(masks.to(torch.float32), dim=0)
    denom = _denominator(n_clients, n_eff, y.device)
    return torch.where(cnt > 0, y / (torch.clamp(cnt, min=1.0) * denom),
                       torch.zeros_like(y))


def ota_aggregate_tree(key, weighted_grads, chan: ChannelParams,
                       n_clients: int, live=None, n_eff=None):
    """The per-leaf oracle: for leaf i, ks = ``leaf_key(key, i)``; cluster
    c's gains are ``normal(cluster_key(ks, c))·√σ²_c``, its mask |H|² ≥
    H_th (all-pass with ``ota_on`` off) and the AWGN
    ``normal(noise_key(ks))·noise_std·ota_on``. ``weighted_grads`` has
    (C, ...) leaves; returns the ĝ tree."""
    leaves = tree_leaves(weighted_grads)
    out = []
    for i, wg in enumerate(leaves):
        ks = leaf_key(key, i)
        shape = tuple(wg.shape[1:])
        masks = _leaf_masks(ks, shape, chan, wg.device)
        noise = (rng.normal(noise_key(ks), shape, device=wg.device)
                 * chan.noise_std.to(wg.device)
                 * chan.ota_on.to(wg.device))
        out.append(ota_aggregate_leaf(wg, masks, noise, n_clients,
                                      live=live, n_eff=n_eff))
    return tree_unflatten(weighted_grads, out)


def final_layer_masks(key, final_tree, chan: ChannelParams,
                      leaf_offset: int = 0):
    """Masks M^(l) on the last-shared-layer params ω̃ (eqs. 5-7) for the
    per-leaf oracle: the per-leaf keys of the full aggregation (ω̃'s
    leaves come first in the tree), so FedGradNorm sees the channel the
    transmission uses. Returns a tree of (C, *shape) bool masks."""
    leaves = tree_leaves(final_tree)
    masks = [_leaf_masks(leaf_key(key, leaf_offset + i), tuple(l.shape),
                         chan, l.device)
             for i, l in enumerate(leaves)]
    return tree_unflatten(final_tree, masks)


# --------------------------------------------------------------------------
# the packed slab engine
# --------------------------------------------------------------------------

def ota_aggregate_packed(key, weighted_grads, chan: ChannelParams,
                         n_clients: int, packer: TreePacker,
                         bits_mode: str = "fused"):
    """Packed-slab OTA aggregation: pack the (C, ...) weighted tree into a
    (C, P) slab, estimate every section (``ops._ota_aggregate_fused_impl``:
    one K4 launch per section, which draws the section's stream words in
    the kernel), unpack. Same math as ``ota_aggregate_tree`` on the packed
    key schedule.

    ``bits_mode="supplied"`` draws the identical (C, P) gain and (P,)
    noise words outside (``packed_gain_bits``/``packed_noise_bits``) and
    hands them to K3: a caller running several scenarios on one key draws
    them once. Both modes return the same values."""
    _check_bits_mode(bits_mode)
    check_tree_matches_packer(packer, weighted_grads,
                              "weighted gradient tree (packed OTA)",
                              batch_ndim=1)
    wg = packer.pack(weighted_grads)                       # (C, P)
    n_clusters = int(wg.shape[0])
    bits = nbits = None
    if bits_mode == "supplied":
        bits = packed_gain_bits(key, packer, n_clusters, wg.device)
        nbits = packed_noise_bits(key, packer, wg.device)
    ghat = _ota_aggregate_fused_impl(
        wg, packed_section_keys(key, packer),
        [sec.length for sec in packer.sections], chan.sigma2,
        chan.h_threshold, chan.noise_std, chan.ota_on, n_clients,
        bits=bits, nbits=nbits)
    return packer.unpack(ghat)


# --------------------------------------------------------------------------
# the channel on the simulator's main path
# --------------------------------------------------------------------------

def ota_aggregate_client_folded(key, grads, p: torch.Tensor,
                                chan: ChannelParams, n_clients: int,
                                packer: TreePacker, bits_mode: str = "fused",
                                live: Optional[torch.Tensor] = None,
                                n_eff: Optional[torch.Tensor] = None,
                                streams: Optional[SectionStreams] = None):
    """PS estimate ĝ of eqs. 3 + 8-10 from the raw (C, N, ...) gradient
    tree and the (C, N) loss weights, one leaf at a time: each leaf is
    read in place and meets its slice of its section's streams, so
    neither the client-weighted tree nor a (C, P) slab is built. Returns
    a tree of ĝ leaves shaped like the model's parameters.

    ``bits_mode="fused"`` draws the round's streams from ``key``;
    ``"supplied"`` reads them from ``streams`` (``section_streams`` of the
    same key), so a caller that runs several scenarios on one key draws
    them once. Both give identical values."""
    _check_bits_mode(bits_mode)
    check_tree_matches_packer(packer, grads,
                              "gradient tree (client-folded OTA)",
                              batch_ndim=2)
    n_clusters = int(chan.sigma2.shape[0])
    if bits_mode == "fused":
        if streams is not None:
            raise ValueError("bits_mode='fused' draws the streams itself; "
                             "pass bits_mode='supplied' with streams")
        streams = section_streams(key, packer, n_clusters, p.device)
    elif streams is None:
        raise ValueError("bits_mode='supplied' needs the round's streams "
                         "(ota.section_streams)")
    _check_streams(streams, packer, n_clusters)
    leaves = tree_leaves(grads)
    out = [None] * len(leaves)
    for run in packer.leaf_runs():
        b = streams.gain[run.section][:, run.offset:run.offset + run.size]
        nb = streams.noise[run.section][run.offset:run.offset + run.size]
        out[run.leaf] = ota_client_fold_apply(
            leaves[run.leaf], p, b, nb, chan.sigma2, chan.h_threshold,
            chan.noise_std, chan.ota_on, n_clients, live=live, n_eff=n_eff)
    return tree_unflatten(grads, out)


# --------------------------------------------------------------------------
# the streaming engines: one cluster's streams alive at a time
# --------------------------------------------------------------------------

class OTAStreamAcc(NamedTuple):
    """Running state of the streaming aggregator: the masked MAC sum and
    the |M| pass count, one leaf-shaped float32 tensor each, with no
    cluster axis."""
    y: Any       # tree: Σ_{folded l} M_l ∘ (Σ_n p g)
    cnt: Any     # tree: Σ_{folded l} M_l


def ota_stream_init(packer: TreePacker, device=None) -> OTAStreamAcc:
    """Zeroed accumulator shaped like ``packer``'s tree."""
    def zeros():
        tree: dict = {}
        for i, path in enumerate(packer.paths):
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = torch.zeros(packer.slots[i].shape,
                                         dtype=torch.float32, device=device)
        return tree
    return OTAStreamAcc(y=zeros(), cnt=zeros())


def _cluster_gain_keys(key, folds, cluster) -> torch.Tensor:
    """Gain-stream keys of one cluster for each fold in ``folds``:
    (len(folds), 2), derived in two batched host hashes."""
    skeys = rng.fold_in(rng.as_key(key).unsqueeze(0),
                        torch.tensor(folds, dtype=torch.int64))
    return cluster_key(skeys, int(cluster))


def _stream_term(g_leaf, p_c, gkey, run, sig_c, chan: ChannelParams,
                 live_c):
    """One (cluster, leaf) term: draw the cluster's words of the leaf's
    stream range and fold them through K5."""
    b = stream_range_bits(gkey, run.offset, run.size, g_leaf.device)
    return ota_stream_fold_apply(g_leaf, p_c, b, sig_c, chan.h_threshold,
                                 chan.ota_on, live_c=live_c)


def _finalize_leaf(y, cnt, nkey, run, chan: ChannelParams, denom):
    """AWGN from the leaf's noise range, then the guarded eq.-10 estimate."""
    nb = stream_range_bits(nkey, run.offset, run.size, y.device)
    z = (bits_to_gaussian(nb, 1.0) * chan.noise_std.to(torch.float32)
         * chan.ota_on.to(torch.float32))
    yl = y.reshape(-1) + z
    cl = cnt.reshape(-1)
    g = torch.where(cl > 0, yl / (torch.clamp(cl, min=1.0) * denom),
                    torch.zeros_like(yl))
    return g.reshape(y.shape)


def _denominator(n_clients: int, n_eff, device) -> torch.Tensor:
    if n_eff is None:
        return torch.tensor(float(n_clients), dtype=torch.float32,
                            device=device)
    return torch.clamp(torch.as_tensor(n_eff, dtype=torch.float32,
                                       device=device), min=1.0)


def _live_flags(live, n_clusters: int, device) -> List[Optional[torch.Tensor]]:
    if live is None:
        return [None] * n_clusters
    lv = torch.as_tensor(live, dtype=torch.float32,
                         device=device).reshape(n_clusters)
    return [lv[c] for c in range(n_clusters)]


def ota_stream_fold(key, acc: OTAStreamAcc, grads_c, p_c: torch.Tensor,
                    chan: ChannelParams, cluster: int, packer: TreePacker,
                    live_c=None) -> OTAStreamAcc:
    """Fold ONE cluster's contribution into the running sum: draw only
    cluster ``cluster``'s words of each leaf's stream range (the same
    words the client-folded engine applies at those positions, because
    partial chunks truncate), fold its client weights into the masked
    apply (one K5 launch per leaf), and add the masked sum and the pass
    count into ``acc``. ``grads_c`` has leading (N, ...) leaves.
    Updates ``acc``'s tensors in place and returns it."""
    folds = packed_section_folds(packer)
    gkeys = _cluster_gain_keys(key, folds, cluster)
    sig_c = chan.sigma2[cluster]
    leaves = tree_leaves(grads_c)
    y, cnt = tree_leaves(acc.y), tree_leaves(acc.cnt)
    for run in packer.leaf_runs():
        dy, dc = _stream_term(leaves[run.leaf], p_c, gkeys[run.section],
                              run, sig_c, chan, live_c)
        y[run.leaf].add_(dy)
        cnt[run.leaf].add_(dc)
    return acc


def ota_stream_finalize(key, acc: OTAStreamAcc, chan: ChannelParams,
                        n_clients: int, packer: TreePacker, n_eff=None):
    """Close a streaming round: add the AWGN (the words
    ``section_noise_streams`` draws, range by range) and apply the guarded
    |M|·N_eff estimate of eq. 10. Returns the ĝ tree."""
    folds = torch.tensor(packed_section_folds(packer), dtype=torch.int64)
    nkeys = rng.fold_in(noise_key(key).unsqueeze(0), folds)
    y, cnt = tree_leaves(acc.y), tree_leaves(acc.cnt)
    denom = _denominator(n_clients, n_eff, y[0].device)
    out = [None] * len(y)
    for run in packer.leaf_runs():
        out[run.leaf] = _finalize_leaf(y[run.leaf], cnt[run.leaf],
                                       nkeys[run.section], run, chan, denom)
    return tree_unflatten(acc.y, out)


def ota_aggregate_streaming(key, grads, p: torch.Tensor, chan: ChannelParams,
                            n_clients: int, packer: TreePacker,
                            bits_mode: str = "fused",
                            live: Optional[torch.Tensor] = None,
                            n_eff: Optional[torch.Tensor] = None):
    """Streaming OTA aggregation: the client-folded engine's math and
    streams, with the cluster axis a loop over ``ota_stream_fold``, so
    only one cluster's stream words and masked term are alive besides the
    leaf-shaped accumulator; no (C, section) tensor is made. Sums over
    clusters in cluster order, so it matches the client-folded engine to
    float rounding, not bit for bit.

    The draw depends on ``key`` alone and happens cluster by cluster
    whatever ``bits_mode`` says ("fused" or "supplied", accepted as the
    reference accepts them); there are no streams to supply."""
    _check_bits_mode(bits_mode)
    check_tree_matches_packer(packer, grads,
                              "gradient tree (streaming OTA)", batch_ndim=2)
    n_clusters = int(chan.sigma2.shape[0])
    leaves = tree_leaves(grads)
    acc = ota_stream_init(packer, p.device)
    p32 = p.to(torch.float32)
    for c, live_c in enumerate(_live_flags(live, n_clusters, p.device)):
        grads_c = tree_unflatten(grads, [l[c] for l in leaves])
        acc = ota_stream_fold(key, acc, grads_c, p32[c], chan, c, packer,
                              live_c=live_c)
    return ota_stream_finalize(key, acc, chan, n_clients, packer,
                               n_eff=n_eff)


def ota_aggregate_sectioned(key, grads, p: torch.Tensor, chan: ChannelParams,
                            n_clients: int, packer: TreePacker,
                            bits_mode: str = "fused",
                            live: Optional[torch.Tensor] = None,
                            n_eff: Optional[torch.Tensor] = None,
                            streaming: bool = False):
    """Section-at-a-time OTA aggregation: walk ``packer.sections`` in
    order, draw only that section's streams (the same folds, so the same
    words as the all-sections draw), fold only its leaf runs, and let the
    buffers go before the next section. Peak live streams are one section
    (bounded by the layout's ``max_section_rows``), never the (C, P) slab.

    ``streaming=False`` hands every K1 launch the bytes the client-folded
    engine hands it, so the result is bit-identical to that engine.
    ``streaming=True`` runs the cluster loop inside each section (one
    cluster's slice of one section alive at a time) and accumulates every
    leaf in the streaming engine's cluster order: bit-identical to
    ``ota_aggregate_streaming``. ``bits_mode`` is accepted as the
    reference accepts it; the draw is per section either way."""
    _check_bits_mode(bits_mode)
    check_tree_matches_packer(packer, grads,
                              "gradient tree (sectioned OTA)", batch_ndim=2)
    n_clusters = int(chan.sigma2.shape[0])
    device = p.device
    folds = packed_section_folds(packer)
    leaves = tree_leaves(grads)
    out = [None] * len(leaves)
    runs_by_sec: dict = {}
    for run in packer.leaf_runs():
        runs_by_sec.setdefault(run.section, []).append(run)
    p32 = p.to(torch.float32)
    live_v = _live_flags(live, n_clusters, device)
    denom = _denominator(n_clients, n_eff, device)
    for sec in packer.sections:
        runs = runs_by_sec.get(sec.index, [])
        if not runs:
            continue
        fold = folds[sec.index]
        nkey = section_noise_key(key, fold)
        if not streaming:
            gb = _section_bits(key, fold, n_clusters, sec.length, device)
            nb = chunked_stream(nkey, sec.length, device)
            for run in runs:
                cols = slice(run.offset, run.offset + run.size)
                out[run.leaf] = ota_client_fold_apply(
                    leaves[run.leaf], p, gb[:, cols], nb[cols], chan.sigma2,
                    chan.h_threshold, chan.noise_std, chan.ota_on, n_clients,
                    live=live, n_eff=n_eff)
            continue
        y = [torch.zeros(packer.slots[r.leaf].shape, dtype=torch.float32,
                         device=device) for r in runs]
        cnt = [torch.zeros_like(t) for t in y]
        for c in range(n_clusters):
            gkey = section_gain_key(key, fold, c)
            for k, run in enumerate(runs):
                dy, dc = _stream_term(leaves[run.leaf][c], p32[c], gkey, run,
                                      chan.sigma2[c], chan, live_v[c])
                y[k].add_(dy)
                cnt[k].add_(dc)
        for k, run in enumerate(runs):
            out[run.leaf] = _finalize_leaf(y[k], cnt[k], nkey, run, chan,
                                           denom)
    return tree_unflatten(grads, out)


def final_layer_masks_packed(key, chan: ChannelParams, packer: TreePacker,
                             gain: Optional[List[torch.Tensor]] = None):
    """Masks M^(l) on the last-shared-layer params ω̃ (eqs. 5-7), drawn
    from the tail section's stream: the same masks the aggregation
    applies to those entries. ``gain``, the round's per-section gain
    streams (``SectionStreams.gain``) when the caller has drawn them, is
    read instead of drawing the tail again. Returns the tail subtree of
    (C, *shape) bool masks."""
    if packer.tail_name is None or not packer.tail_len:
        raise ValueError("final_layer_masks_packed needs a packer with a "
                         "non-empty tail section (the ω̃ params)")
    n_clusters = int(chan.sigma2.shape[0])
    tail_sec = next(s for s in packer.sections
                    if s.name == packer.tail_name)
    if gain is None:
        bits = _section_bits(key, PACKED_TAIL_FOLD, n_clusters,
                             tail_sec.length, chan.sigma2.device)
    else:
        bits = gain[tail_sec.index]
        if tuple(bits.shape) != (n_clusters, tail_sec.length):
            raise ValueError(f"tail gain stream shaped {tuple(bits.shape)}, "
                             f"expected ({n_clusters}, {tail_sec.length})")
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
