"""Slab-native distributed HOTA aggregation (DESIGN.md §3.10).

Port of ``repro.core.hota_slab``. The WHOLE shared model rides one
multi-section slab layout (``TreePacker``, ``sections="toplevel"``), and
the (P,) slab is never materialized: ``TreePacker.leaf_runs()`` maps each
leaf's storage to a static slice of its section's chunk-quantized stream
(DESIGN.md §4), and a kernel consumes each leaf's gradient in place. The
FedGradNorm weight folds into the kernel (w·g·M in one pass), so the
backward needs ONE set of collectives for the whole model: the LAN sum
of eq. 3 as a reduce-scatter over "client", then the MAC sum of eq. 8
over the cluster axes.

How |M| reaches the eq.-10 estimate (``count_mode``; the values are the
same either way, the masks being pure functions of the streams):

* ``"local"`` (the card's default): every rank draws EVERY cluster's
  stream and K6 (``ota_mask_count_apply``) counts the masks locally, one
  launch per leaf: no mask collective, C× the stream words;
* ``"psum"`` (the CPU's default): each rank draws only its cluster's
  stream (only its client region's words, where the region is a
  contiguous range of the leaf) and K5 (``ota_mask_weight_apply``) masks,
  one launch per leaf; the masks ride the MAC psum with the data.

``sectioned_final_norm`` re-draws ONLY the ω̃ section's stream, so the
FGN phase (eq. 5) sees the masks the backward applies.
``packed_omega_aggregate_ref`` is the single-process oracle of the
backward on the same streams. ``sectioned=True`` runs the backward one
section at a time (the section-streaming schedule, DESIGN.md §3.16).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch import rng
from repro_torch.common.flatpack import TreePacker, packer_for
from repro_torch.common.tree import tree_leaves, tree_unflatten
from repro_torch.core.channel import ChannelParams
from repro_torch.core.hota import (
    CLIENT_AXIS, OTACtx, cluster_index, custom_gather, gather_leaf,
    shard_of,
)
from repro_torch.core.ota import (
    _section_bits, packed_section_folds, section_gain_key,
    section_noise_key, stream_range_bits,
)
from repro_torch.kernels.ota_channel.ops import (
    chunked_stream, ota_mask_count_apply, ota_mask_weight_apply,
)
from repro_torch.kernels.ota_channel.ref import bits_to_gaussian, bits_to_mask
from repro_torch.sharding import collectives as col
from repro_torch.sharding.mesh_utils import Mesh

# the whole-model slab's channel key domain — reserved fold near 2³¹,
# disjoint from PACKED_FINAL_FOLD and every cluster/leaf index (DESIGN.md §4)
PACKED_OMEGA_FOLD = 0x7FFF00F2


def _fsdp_axis_full(axes: tuple) -> int:
    """FSDP dim index in the FULL logical-axes tuple (-1: replicated)."""
    return axes.index("embed") if "embed" in axes else -1


def plain_gather_full(shard_tree, fsdp_axes: List[int], mesh: Mesh,
                      data_axes: Tuple[str, ...], compute_dtype):
    """Per-leaf all-gather of a whole shard tree with no channel in its
    backward: phases 0 and B of the step."""
    return tree_unflatten(shard_tree, [
        gather_leaf(l, ax, mesh, data_axes, compute_dtype)
        for l, ax in zip(tree_leaves(shard_tree), fsdp_axes)])


def packed_omega_key(base_key) -> torch.Tensor:
    """The single channel key of the slab-native whole-model round."""
    return rng.fold_in(base_key, PACKED_OMEGA_FOLD)


def omega_packer(template, sections: str = "toplevel",
                 min_section_rows: int = 0,
                 max_section_rows: int = 0) -> TreePacker:
    """The slab layout of one omega template, all float32, ω̃ last."""
    f32 = tree_unflatten(template, [
        torch.empty(tuple(l.shape), dtype=torch.float32, device="meta")
        for l in tree_leaves(template)])
    return packer_for(f32, tail="final", sections=sections,
                      min_section_rows=min_section_rows,
                      max_section_rows=max_section_rows)


def default_count_mode(device) -> str:
    """"local" on the card (stream words are cheap beside the collectives
    of ranks that share it), "psum" on the CPU (fewest words)."""
    return "local" if torch.device(device).type == "cuda" else "psum"


def make_packed_omega_gather(mesh: Mesh, data_axes: Tuple[str, ...],
                             cluster_axes: Tuple[str, ...],
                             n_clients: int, n_shards: int, compute_dtype,
                             template, axes_list: List[tuple],
                             n_clusters: Optional[int] = None,
                             count_mode: Optional[str] = None,
                             sections: str = "toplevel",
                             min_section_rows: int = 0,
                             max_section_rows: int = 0,
                             sectioned: bool = False):
    """Custom-backward FSDP gather for the ENTIRE shared model {trunk,
    final}: returns ``(gather_omega, packer)``.

    forward : per-leaf all-gather of the FSDP shards -> full tree
    backward: per leaf, in place: the channel kernel on the leaf's slice of
              its section's streams (``count_mode``, module docstring),
              the LAN reduce-scatter over "client" (FSDP leaves; the sum
              arrives split into 1/N regions) and the MAC psum over the
              cluster axes (replicated leaves: one full-size psum); AWGN
              from the section noise streams; the guarded |M|·N estimate
              (eq. 10); each leaf's own shard.

    ``ctx.sigma2`` must be the FULL (n_clusters,) per-cluster vector.
    ``count_mode`` None picks by the mesh's device
    (``default_count_mode``).

    ``sectioned`` (DESIGN.md §3.16) makes the layout's sections the unit
    of the backward: it walks them in order (draw a section's streams,
    apply its leaves' kernels, issue their collectives) and finalizes
    each section (AWGN, the estimate, the shard) one section late. Only
    one section's streams are alive at a time (split sections with
    ``max_section_rows`` to bound them), and every leaf's values equal
    the full-slab schedule's bit for bit: the same streams, the same
    kernels and the same per-leaf collectives, in another order. The
    port's collectives block, so the late finalize overlaps nothing."""
    if count_mode is None:
        count_mode = default_count_mode(mesh.device)
    if count_mode not in ("psum", "local"):
        raise ValueError(f"count_mode must be 'psum' or 'local', got "
                         f"{count_mode!r}")
    packer = omega_packer(template, sections=sections,
                          min_section_rows=min_section_rows,
                          max_section_rows=max_section_rows)
    folds = packed_section_folds(packer)
    runs = {run.leaf: run for run in packer.leaf_runs()}
    n_leaves = len(packer.slots)
    if len(axes_list) != n_leaves:
        raise ValueError(f"{len(axes_list)} axes for {n_leaves} leaves")
    fsdp_axes = [_fsdp_axis_full(ax) for ax in axes_list]
    n_sub = n_shards // n_clients      # cluster sub-shards per region
    cidx = cluster_index(mesh, cluster_axes)
    my_reg = mesh.axis_index(CLIENT_AXIS)
    sub_idx = mesh.axis_index(data_axes[1:])
    lan_mac = (CLIENT_AXIS,) + tuple(cluster_axes)

    # a region (1/n_clients slice along the FSDP dim) is a CONTIGUOUS
    # range of the leaf's stream slice iff every dim before the FSDP dim
    # is trivial: then a rank draws ONLY its region's words
    def _contig(i):
        ax = fsdp_axes[i]
        return ax >= 0 and all(s == 1 for s in packer.slots[i].shape[:ax])

    def _region(a, i):
        return shard_of(a, fsdp_axes[i], my_reg, n_clients)

    def _draw(fn):
        """A stream draw, timed into ``mesh.stats`` when it is set."""
        return col.timed(mesh, "draw", 0, fn)

    def _backward(grads, ctx: OTACtx):
        for i, g in enumerate(grads):
            if tuple(g.shape) != packer.slots[i].shape:
                raise ValueError(
                    f"gradient of leaf {'/'.join(packer.paths[i])} has "
                    f"shape {tuple(g.shape)}, the layout expects "
                    f"{packer.slots[i].shape}")
        leaves = [g.to(torch.float32) for g in grads]
        dev = leaves[0].device
        n_cl = (int(ctx.sigma2.shape[0]) if n_clusters is None
                else n_clusters)
        sig_me = ctx.sigma2[cidx]
        live_me = None if ctx.live is None else ctx.live[cidx]
        denom = (torch.tensor(float(n_clients), device=dev)
                 if ctx.n_eff is None
                 else torch.clamp(torch.as_tensor(ctx.n_eff,
                                                  dtype=torch.float32),
                                  min=1.0))
        out = [None] * n_leaves

        def _collect(idxs):
            """The channel work and the collectives of the leaves
            ``idxs`` (the whole model, or one section): ({leaf: y},
            {leaf: |M|}), summed over the clusters. A leaf's values do
            not depend on the grouping: the streams are sliced per leaf
            and every collective is one leaf's."""
            reg = [i for i in idxs if fsdp_axes[i] >= 0]
            rep = [i for i in idxs if fsdp_axes[i] < 0]
            y, cnt = {}, {}
            if count_mode == "local":
                # every cluster's stream, |M| counted locally by K6
                gbits = {s: _draw(lambda s=s: _section_bits(
                    ctx.key, folds[s], n_cl, packer.sections[s].length, dev))
                    for s in sorted({runs[i].section for i in idxs})}
                outs, cnts = {}, {}
                for i in idxs:
                    run = runs[i]
                    b = gbits[run.section][:, run.offset:run.offset + run.size]
                    outs[i], cnts[i] = ota_mask_count_apply(
                        leaves[i], b, cidx, ctx.sigma2, ctx.h_th, ctx.ota_on,
                        ctx.p_weight, live_all=ctx.live)
                del gbits
                for i in reg:
                    y[i] = col.psum(col.reduce_scatter(
                        outs[i], mesh, CLIENT_AXIS, fsdp_axes[i]).contiguous(),
                        mesh, cluster_axes)
                    cnt[i] = _region(cnts[i], i)
                for i in rep:
                    y[i] = col.psum(outs[i], mesh, lan_mac)
                    cnt[i] = cnts[i]
                return y, cnt
            # this cluster's stream only; the masks ride the MAC psum
            full_bits = {}
            for i in rep + [i for i in reg if not _contig(i)]:
                s = runs[i].section
                if s not in full_bits:
                    full_bits[s] = _draw(lambda s=s: chunked_stream(
                        section_gain_key(ctx.key, folds[s], cidx),
                        packer.sections[s].length, dev))

            def _live(o, m):
                if live_me is None:
                    return o, m
                return o * live_me, m * live_me

            for i in reg:
                run, ax = runs[i], fsdp_axes[i]
                if _contig(i):
                    x_reg = col.reduce_scatter(ctx.p_weight * leaves[i],
                                               mesh, CLIENT_AXIS, ax)
                    lreg = run.size // n_clients
                    b = _draw(lambda: stream_range_bits(
                        section_gain_key(ctx.key, folds[run.section], cidx),
                        run.offset + my_reg * lreg, lreg, dev))
                    o, m = _live(*ota_mask_weight_apply(
                        x_reg, b, sig_me, ctx.h_th, ctx.ota_on, 1.0))
                else:
                    b = full_bits[run.section][run.offset:
                                               run.offset + run.size]
                    o, m = _live(*ota_mask_weight_apply(
                        leaves[i], b, sig_me, ctx.h_th, ctx.ota_on,
                        ctx.p_weight))
                    o = col.reduce_scatter(o, mesh, CLIENT_AXIS, ax)
                    m = _region(m, i)
                y[i] = col.psum(o.contiguous(), mesh, cluster_axes)
                cnt[i] = col.psum(m.contiguous(), mesh, cluster_axes)
            for i in rep:
                run = runs[i]
                b = full_bits[run.section][run.offset:run.offset + run.size]
                o, m = _live(*ota_mask_weight_apply(
                    leaves[i], b, sig_me, ctx.h_th, ctx.ota_on,
                    ctx.p_weight))
                y[i] = col.psum(o.contiguous(), mesh, lan_mac)
                cnt[i] = col.psum(m.contiguous(), mesh, cluster_axes)
            return y, cnt

        def _finalize(idxs, y, cnt):
            """AWGN from the section noise streams (contiguous regions
            draw only their words), the guarded estimate and the rank's
            own shard of the leaves ``idxs``, into ``out``."""
            full_nbits = {}
            for i in idxs:
                if fsdp_axes[i] < 0 or not _contig(i):
                    s = runs[i].section
                    if s not in full_nbits:
                        full_nbits[s] = _draw(lambda s=s: chunked_stream(
                            section_noise_key(ctx.key, folds[s]),
                            packer.sections[s].length, dev))
            for i in idxs:
                run, ax = runs[i], fsdp_axes[i]
                if ax >= 0 and _contig(i):
                    lreg = run.size // n_clients
                    nb = _draw(lambda: stream_range_bits(
                        section_noise_key(ctx.key, folds[run.section]),
                        run.offset + my_reg * lreg, lreg, dev))
                    z = bits_to_gaussian(nb, 1.0).reshape(y[i].shape)
                else:
                    nb = full_nbits[run.section][run.offset:
                                                 run.offset + run.size]
                    z = bits_to_gaussian(nb, 1.0).reshape(leaves[i].shape)
                    if ax >= 0:
                        z = _region(z, i)
                z = z * ctx.noise_std * ctx.ota_on
                ghat = torch.where(
                    cnt[i] > 0,
                    (y[i] + z) / (torch.clamp(cnt[i], min=1.0) * denom),
                    torch.zeros_like(y[i]))
                if ax >= 0:
                    ghat = shard_of(ghat, ax, sub_idx, n_sub)
                out[i] = ghat

        if sectioned:
            # one section at a time, in layout order, each finalized one
            # section late: section s's collectives are issued before
            # section s-1 is finished, and one section's streams are
            # alive at a time
            pending = None
            for sec in packer.sections:
                idxs = list(sec.leaf_indices)
                if not idxs:
                    continue
                y, cnt = _collect(idxs)
                if pending is not None:
                    _finalize(*pending)
                pending = (idxs, y, cnt)
            if pending is not None:
                _finalize(*pending)
        else:
            idxs = list(range(n_leaves))
            _finalize(idxs, *_collect(idxs))
        return out

    full_like = tree_unflatten(template, [
        torch.empty(packer.slots[i].shape, device="meta")
        for i in range(n_leaves)])

    def gather_omega(shard_tree, ctx: OTACtx):
        def fwd(leaves):
            return [gather_leaf(l, ax, mesh, data_axes, compute_dtype)
                    for l, ax in zip(leaves, fsdp_axes)]
        return custom_gather(shard_tree, fwd,
                             lambda grads: _backward(grads, ctx), full_like)

    return gather_omega, packer


# --------------------------------------------------------------------------
# FGN inputs from the same round draw (eq. 5)
# --------------------------------------------------------------------------

def sectioned_final_norm(g_final, slab_key, chan_c: ChannelParams,
                         cluster: int, packer: TreePacker) -> torch.Tensor:
    """n_i = ‖M ∘ ∇_{ω̃}F_i‖ (eq. 6) from the ω̃ SECTION of the round's
    slab draw: the masks ``make_packed_omega_gather``'s backward applies to
    the same entries (only this one stream is drawn)."""
    folds = packed_section_folds(packer)
    tail_secs = [s for s in packer.sections if s.name == packer.tail_name]
    if not tail_secs:
        raise ValueError("the layout has no ω̃ tail section")
    sec = tail_secs[0]
    leaves = tree_leaves(g_final)
    if len(leaves) != len(sec.leaf_indices):
        raise ValueError(f"{len(leaves)} ω̃ leaves, the tail section holds "
                         f"{len(sec.leaf_indices)}")
    bits = chunked_stream(section_gain_key(slab_key, folds[sec.index],
                                           cluster), sec.length,
                          leaves[0].device)
    runs = {r.leaf: r for r in packer.leaf_runs()}
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for leaf, i in zip(leaves, sec.leaf_indices):
        run = runs[i]
        b = bits[run.offset:run.offset + run.size]
        mask = bits_to_mask(b, chan_c.sigma2, chan_c.h_threshold,
                            chan_c.ota_on).reshape(leaf.shape)
        g = leaf.to(torch.float32)
        total = total + torch.sum(torch.where(mask, g,
                                              torch.zeros_like(g)) ** 2)
    return torch.sqrt(total)


# --------------------------------------------------------------------------
# single-process oracle on the identical streams (tests)
# --------------------------------------------------------------------------

def packed_omega_aggregate_ref(g_tree, slab_key, chan: ChannelParams,
                               n_clients: int, packer: TreePacker,
                               live=None, n_eff=None):
    """Single-process oracle of the slab backward for ONE weighted-grad
    tree with leading (C,) cluster axes on every leaf: same section
    streams, same mask law, same guarded estimate, in plain torch, so the
    distributed step can be pinned to it on shared keys."""
    folds = packed_section_folds(packer)
    sigma2 = torch.as_tensor(chan.sigma2, dtype=torch.float32)
    n_clusters = int(sigma2.shape[0])
    leaves = tree_leaves(g_tree)
    dev = leaves[0].device
    runs = {run.leaf: run for run in packer.leaf_runs()}
    gbits = [_section_bits(slab_key, folds[s.index], n_clusters, s.length,
                           dev) for s in packer.sections]
    nbits = [chunked_stream(section_noise_key(slab_key, folds[s.index]),
                            s.length, dev) for s in packer.sections]
    if n_eff is None:
        denom = torch.tensor(float(n_clients), device=dev)
    else:
        denom = torch.clamp(torch.as_tensor(n_eff, dtype=torch.float32,
                                            device=dev), min=1.0)
    out = []
    for i in range(len(leaves)):
        run = runs[i]
        b = gbits[run.section][:, run.offset:run.offset + run.size]
        masks = bits_to_mask(b, sigma2.reshape(n_clusters, 1),
                             chan.h_threshold, chan.ota_on)
        if live is not None:
            lv = torch.as_tensor(live, dtype=torch.float32,
                                 device=dev).reshape(n_clusters, 1)
            masks = torch.logical_and(masks, lv > 0.5)
        wg = leaves[i].to(torch.float32).reshape(n_clusters, -1)
        y = torch.sum(torch.where(masks, wg, torch.zeros_like(wg)), dim=0)
        nb = nbits[run.section][run.offset:run.offset + run.size]
        z = bits_to_gaussian(nb, 1.0) * chan.noise_std * chan.ota_on
        c = torch.sum(masks.to(torch.float32), dim=0)
        ghat = torch.where(c > 0, (y + z) / (torch.clamp(c, min=1.0)
                                             * denom), torch.zeros_like(y))
        out.append(ghat.reshape(leaves[i].shape[1:]))
    return tree_unflatten(g_tree, out)
