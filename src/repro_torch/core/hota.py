"""HOTA-FedGradNorm, distributed: the OTA gathers (DESIGN.md §3.1).

Port of ``repro.core.hota``. The paper's two-level aggregation rides the
FSDP parameter gather as a custom backward (``torch.autograd.Function``,
the port's ``jax.custom_vjp``):

    forward : shard --all-gather over ("client", "cluster")--> full param
              (= PS -> IS -> client broadcast, Alg. 1 lines 3-6)
    backward: per-client full grad
              --weighted psum over "client"-->        x^(l) at the IS (eq. 3)
              --masked psum over ("pod", "cluster")-> MAC superposition (eq. 8)
              + AWGN, / (|M|·N)                       PS estimate     (eq. 10)
              --slice own shard-->                    FSDP reduce-scatter

Each process of the mesh is one (cluster, client) position, so its
cluster index is a plain integer (``cluster_index``), not a traced one.

The per-leaf oracle (``use_pallas_ota=False`` in the step):
``make_ota_gather`` wraps one leaf, ``make_param_hook`` calls it for each
leaf of a layer's parameters right before the model uses them (the
models' ``param_hook``), under the key ``fold_tags(step key, klass,
*tags, leaf)``. Its backward draws each cluster's Gaussian gains (eq. 7,
``channel_mask_for``) and the AWGN through ``rng.normal`` from words of
the card's stream kernel (``ops.bits``): whole-tensor draws in
``mode="naive"``, one draw per client region of the FSDP dim in
``mode="scatter"`` (``region_mask_key``), where the LAN sum arrives as a
reduce-scatter. ``full_transmission_mask`` redraws a leaf's mask exactly
as its transmission does, so FedGradNorm's eq. 5 sees the channel the
MAC applies.

``make_packed_final_gather`` packs ω̃'s whole gradient into one slab
and masks it with the per-cluster gain-threshold kernel K7
(``_packed_mask_apply``); ``packed_final_norm`` reads the same masks for
eq. 6; ``make_param_hook(final_packed_gather=...)`` routes the "final"
klass through it.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch import rng
from repro_torch.common.flatpack import packer_for
from repro_torch.common.tree import (
    tree_flatten_with_path, tree_leaves, tree_map, tree_unflatten,
)
from repro_torch.core.channel import ChannelParams
from repro_torch.core.ota import HOTA_MASK_SALT
from repro_torch.kernels.ota_channel.ops import _ota_channel_impl, bits
from repro_torch.models.params import logical_axes
from repro_torch.sharding import collectives as col
from repro_torch.sharding.mesh_utils import Mesh

CLIENT_AXIS = "client"

KLASS_SALT = {
    "embed": 1, "layers": 2, "final": 3, "mamba": 4,
    "shared_attn": 5, "shared_mlp": 6, "mlstm": 7, "slstm": 8,
}

PACKED_FINAL_FOLD = 0x7FFF00F1   # reserved fold — disjoint from leaf indices


def _strip_layer(axes: tuple) -> tuple:
    return tuple(a for a in axes if a != "layer")


def _fsdp_axis(axes: tuple) -> int:
    stripped = _strip_layer(axes)
    return stripped.index("embed") if "embed" in stripped else -1


class OTACtx(NamedTuple):
    """What the OTA backward reads besides the gradient."""
    p_weight: Any            # this client's FedGradNorm weight p_k^(l,i)
    key: torch.Tensor        # the channel key (a (2,) threefry key)
    sigma2: Any              # σ²: this cluster's (), or every cluster's (C,)
    h_th: Any                # threshold H_th
    noise_std: Any           # AWGN std
    ota_on: Any              # 1.0 = fading MAC; 0.0 = error-free baseline
    live: Optional[Any] = None    # (C,) cluster participation flags
    n_eff: Optional[Any] = None   # () effective N of eq. 10


def fold_tags(key, klass: str, tags, leaf_idx: int) -> torch.Tensor:
    k = rng.fold_in(key, KLASS_SALT[klass])
    for t in tags:
        k = rng.fold_in(k, t)
    return rng.fold_in(k, leaf_idx)


def cluster_index(mesh: Mesh, cluster_axes: Tuple[str, ...]) -> int:
    """This rank's cluster, mixed radix over the cluster axes."""
    return mesh.axis_index(cluster_axes)


class _CustomGather(torch.autograd.Function):
    """A gather whose backward is given: ``forward(fwd, bwd, *leaves)``
    returns ``fwd(leaves)``, and the leaves' gradients are
    ``bwd(output grads)``."""

    @staticmethod
    def forward(fctx, fwd: Callable, bwd: Callable, *leaves):
        fctx.bwd = bwd
        fctx.like = [(l.shape, l.dtype, l.device) for l in leaves]
        return tuple(fwd(list(leaves)))

    @staticmethod
    def backward(fctx, *grads):
        return (None, None) + tuple(fctx.bwd(list(grads)))


def custom_gather(shard_tree, fwd: Callable, bwd: Callable, full_like):
    """Apply a ``_CustomGather`` to a tree of shards: ``fwd`` maps the
    shard leaves to the full leaves, ``bwd`` the full leaves' gradients
    (zeros for an unused leaf, shaped like ``full_like``'s leaves) to the
    shards'."""
    leaves = tree_leaves(shard_tree)
    full_shapes = [tuple(l.shape) for l in tree_leaves(full_like)]

    def bwd_filled(grads):
        out = [torch.zeros(s, dtype=torch.float32, device=leaves[0].device)
               if g is None else g for g, s in zip(grads, full_shapes)]
        return bwd(out)
    full = _CustomGather.apply(fwd, bwd_filled, *leaves)
    return tree_unflatten(shard_tree, list(full))


def gather_leaf(leaf: torch.Tensor, ax: int, mesh: Mesh, data_axes,
                compute_dtype) -> torch.Tensor:
    """One leaf's FSDP all-gather (``ax`` >= 0) or its replicated copy,
    in the compute dtype."""
    if ax >= 0:
        return col.all_gather(leaf.detach(), mesh, data_axes,
                              ax).to(compute_dtype)
    return leaf.detach().to(compute_dtype, copy=True)


def shard_of(full: torch.Tensor, ax: int, index: int,
             n_shards: int) -> torch.Tensor:
    """Piece ``index`` of ``n_shards`` along dim ``ax``."""
    sz = full.shape[ax] // n_shards
    return full.narrow(ax, index * sz, sz)


# --------------------------------------------------------------------------
# the per-leaf oracle: one gather per leaf, Gaussian gains per leaf
# --------------------------------------------------------------------------

REGION_SALT = 0xC0


def _normal(key, shape, device) -> torch.Tensor:
    """``rng.normal(key, shape)`` from words of ``ops.bits``: the card's
    stream kernel there, the (counted) plain draw on the host."""
    shape = tuple(int(d) for d in shape)
    return rng.normal_from_words(bits(key, math.prod(shape),
                                      device=device)).reshape(shape)


def channel_mask_for(key, shape, sigma2, h_th, ota_on, cluster: int,
                     device) -> torch.Tensor:
    """The mask M_k^(l) that cluster ``cluster`` sees for one leaf (eq. 7):
    gains ``normal(fold_in(key, cluster))·√σ²``, passed where h² ≥ H_th
    (everywhere with ``ota_on`` off)."""
    h = _normal(rng.fold_in(key, cluster), shape, device) * torch.sqrt(
        torch.as_tensor(sigma2, dtype=torch.float32, device=device))
    return torch.logical_or((h * h) >= h_th, torch.as_tensor(
        ota_on, device=device) < 0.5)


def region_mask_key(leaf_key, region: int) -> torch.Tensor:
    """The key of one scatter region's channel draw (scatter mode). The
    regions split the FSDP dim client-major; a leaf's full mask is the
    concatenation of its region masks (``full_transmission_mask``)."""
    return rng.fold_in(rng.fold_in(leaf_key, REGION_SALT), region)


def full_transmission_mask(leaf_key, shape, axis: int, n_regions: int,
                           sigma2, h_th, ota_on, cluster: int,
                           scatter_mode: bool, device) -> torch.Tensor:
    """A leaf's full mask M_k^(l) exactly as its transmission draws it,
    for FedGradNorm's eq. 5: per region in scatter mode for an FSDP leaf
    (``axis`` ≥ 0), whole-tensor for a replicated leaf or in naive
    mode."""
    if not scatter_mode or axis < 0:
        return channel_mask_for(leaf_key, shape, sigma2, h_th, ota_on,
                                cluster, device)
    sub = list(shape)
    if sub[axis] % n_regions:
        raise ValueError(f"dim {axis} of {tuple(shape)} does not split into "
                         f"{n_regions} regions")
    sub[axis] //= n_regions
    return torch.cat([channel_mask_for(region_mask_key(leaf_key, r), sub,
                                       sigma2, h_th, ota_on, cluster, device)
                      for r in range(n_regions)], dim=axis)


def _estimate(y, cnt, z, denom) -> torch.Tensor:
    """eq. 10's guarded estimate (y + z) / (|M|·N); 0 where no cluster
    passed."""
    return torch.where(cnt > 0, (y + z) / (torch.clamp(cnt, min=1.0)
                                           * denom), torch.zeros_like(y))


def make_ota_gather(mesh: Mesh, data_axes: Tuple[str, ...],
                    cluster_axes: Tuple[str, ...], n_clients: int,
                    n_shards: int, compute_dtype, mode: str = "scatter"):
    """The per-leaf custom-backward FSDP gather for this rank of ``mesh``:
    returns ``ota_gather(axis, shard, ctx)``, the full leaf in the compute
    dtype. ``data_axes`` must be ("client", "cluster"): client-major
    pieces make the scatter regions line up with the FSDP pieces.

    ``axis`` ≥ 0 is the leaf's FSDP dim; -1 a leaf replicated over the
    data axes (its forward copies it, its backward runs at full size).
    The backward is Alg. 1's aggregation in one of two forms with the
    same math:

    * ``mode="naive"`` (as the paper writes it): the weighted psum over
      "client" (eq. 3) and the masked psum over the clusters (eq. 8) at
      full size, the estimate (eq. 10), the rank's own shard;
    * ``mode="scatter"``: the weighted gradients reduce-scattered over
      "client", so the LAN sum arrives split into client regions of 1/N
      size; one mask and one AWGN draw per region; the MAC psum on the
      region; the rank's cluster's piece of it. No full-size
      intermediate, about a third of the collective bytes.

    Channel keys fold only (step, layer, leaf), so every microbatch sees
    the same masks and AWGN: averaging microbatch estimates is one MAC
    transmission of the round-averaged x^(l)."""
    if data_axes[0] != CLIENT_AXIS:
        raise ValueError(f"data_axes must start with {CLIENT_AXIS!r}, got "
                         f"{data_axes}")
    if mode not in ("scatter", "naive"):
        raise ValueError(f"ota_mode must be 'scatter' or 'naive', got "
                         f"{mode!r}")
    cidx = cluster_index(mesh, cluster_axes)
    my_region = mesh.axis_index(CLIENT_AXIS)
    sub_idx = mesh.axis_index(data_axes[1:])
    me = mesh.axis_index(data_axes)
    n_sub = n_shards // n_clients

    def _channel(key, shape, ctx: OTACtx, dev):
        """The leaf's (or region's) eq.-7 mask and its AWGN, timed into
        ``mesh.stats`` as draws when it is set."""
        return col.timed(mesh, "draw", 0, lambda: (
            channel_mask_for(key, shape, ctx.sigma2, ctx.h_th, ctx.ota_on,
                             cidx, dev),
            _normal(rng.fold_in(key, HOTA_MASK_SALT), shape, dev)
            * ctx.noise_std * ctx.ota_on))

    def _bwd(axis: int, g: torch.Tensor, ctx: OTACtx) -> torch.Tensor:
        g = g.to(torch.float32)
        if mode == "scatter" and axis >= 0:
            x_reg = col.reduce_scatter(ctx.p_weight * g, mesh, CLIENT_AXIS,
                                       axis)
            mask, z = _channel(region_mask_key(ctx.key, my_region),
                               x_reg.shape, ctx, g.device)
            cnt = col.psum(mask.to(torch.float32), mesh, cluster_axes)
            y = col.psum(torch.where(mask, x_reg, torch.zeros_like(x_reg)),
                         mesh, cluster_axes)
            return shard_of(_estimate(y, cnt, z, n_clients), axis, sub_idx,
                            n_sub)
        x = col.psum(ctx.p_weight * g, mesh, CLIENT_AXIS)
        mask, z = _channel(ctx.key, g.shape, ctx, g.device)
        cnt = col.psum(mask.to(torch.float32), mesh, cluster_axes)
        y = col.psum(torch.where(mask, x, torch.zeros_like(x)), mesh,
                     cluster_axes)
        ghat = _estimate(y, cnt, z, n_clients)
        return shard_of(ghat, axis, me, n_shards) if axis >= 0 else ghat

    def ota_gather(axis: int, shard: torch.Tensor, ctx: OTACtx):
        shape = list(shard.shape)
        if axis >= 0:
            shape[axis] *= n_shards
        return custom_gather(
            shard,
            lambda leaves: [gather_leaf(leaves[0], axis, mesh, data_axes,
                                        compute_dtype)],
            lambda grads: [_bwd(axis, grads[0], ctx)],
            torch.empty(shape, dtype=torch.float32, device="meta"))

    return ota_gather


def build_axes_registry(model) -> Dict[str, List[tuple]]:
    """klass -> the logical-axes tuple of each leaf the hook sees for it,
    in flatten order: the ``mlp`` trunk as one "layers" call; an LM's
    "embed" and its blocks: one dense layer's "layers" (gemma3's local
    and global layers hold the same leaves), one Mamba2 layer's "layers"
    (``ssm``) or "mamba" and the shared block's "shared_attn" and
    "shared_mlp" (``hybrid``), one mLSTM's "mlstm" and one sLSTM's
    "slstm" (``xlstm``); and "final". The "layer" stacking dims stay in
    the tuples; ``_fsdp_axis`` strips them."""
    family = model.cfg.family
    ax = logical_axes(model.trunk_specs())
    reg: Dict[str, List[tuple]] = {}
    if family == "mlp":
        reg["layers"] = tree_leaves(ax)
    else:
        reg["embed"] = [ax["embed"]]
        if family == "hybrid":
            for klass in ("mamba", "shared_attn", "shared_mlp"):
                reg[klass] = tree_leaves(ax[klass])
        elif family == "xlstm":
            reg["mlstm"] = tree_leaves(ax["mlstm"])
            reg["slstm"] = tree_leaves(ax["slstm"])
        else:
            reg["layers"] = tree_leaves(ax["layers"] if "layers" in ax
                                        else ax["global"])
    reg["final"] = tree_leaves(logical_axes(model.final_specs()))
    return reg


def make_param_hook(gather, registry: Dict[str, List[tuple]], base_key,
                    p_weight, chan: ChannelParams, final_packed_gather=None):
    """``hook(params, klass, *tags)``: the subtree with every leaf through
    ``gather`` (``make_ota_gather``) under ``fold_tags(base_key, klass,
    tags, leaf)``. ``chan`` is this cluster's channel view (scalar σ²,
    ``core.channel.cluster_channel``), ``p_weight`` the client's
    FedGradNorm weight. With ``final_packed_gather``
    (``make_packed_final_gather``) the "final" klass takes the whole ω̃
    subtree through one packed gather under ``packed_final_key``."""
    consts = dict(p_weight=p_weight, sigma2=chan.sigma2,
                  h_th=chan.h_threshold, noise_std=chan.noise_std,
                  ota_on=chan.ota_on)

    def hook(lp, klass: str, *tags):
        if klass == "final" and final_packed_gather is not None:
            return final_packed_gather(
                lp, OTACtx(key=packed_final_key(base_key), **consts))
        leaves, axes = tree_leaves(lp), registry[klass]
        if len(leaves) != len(axes):
            raise ValueError(f"klass {klass!r}: {len(leaves)} leaves, the "
                             f"registry holds {len(axes)}")
        return tree_unflatten(lp, [
            gather(_fsdp_axis(a), leaf,
                   OTACtx(key=fold_tags(base_key, klass, tags, i), **consts))
            for i, (leaf, a) in enumerate(zip(leaves, axes))])
    return hook


def identity_hook(lp, klass: str, *tags):
    return lp


def shard_specs_for(model, mesh: Mesh):
    """The FL layout of the shared parameters {"final", "trunk"}: a leaf
    with an "embed" dim splits it over the data axes ("client",
    "cluster"), any other leaf is replicated (``()``)."""
    data_axes = _mesh_data_axes(mesh)

    def spec(axes):
        if "embed" not in axes:
            return ()
        ax = axes.index("embed")
        return tuple(data_axes if d == ax else None for d in range(ax + 1))
    return tree_map(spec, {"final": logical_axes(model.final_specs()),
                           "trunk": logical_axes(model.trunk_specs())})


# --------------------------------------------------------------------------
# flat-packed final-subtree gather (ω̃ as ONE slab through the OTA MAC)
# --------------------------------------------------------------------------

def packed_final_key(base_key) -> torch.Tensor:
    """The single channel key of the packed ω̃ slab."""
    return rng.fold_in(rng.fold_in(base_key, KLASS_SALT["final"]),
                       PACKED_FINAL_FOLD)


def _packed_mask_apply(x_slab: torch.Tensor, key, sigma2, h_th, ota_on,
                       cluster: int):
    """This cluster's bits -> Box-Muller gain -> threshold -> apply on a
    (P,) slab (K7): (masked x, mask), both (P,) float32. The words are
    ``bits(fold_in(key, cluster), P)``; the gather backward and the FGN
    norm call it with the same key, so eq. 5 sees the transmission's
    masks."""
    words = bits(rng.fold_in(key, cluster), x_slab.shape[-1],
                 device=x_slab.device)
    return _ota_channel_impl(x_slab, words, sigma2, h_th, ota_on)


def make_packed_final_gather(mesh: Mesh, data_axes: Tuple[str, ...],
                             cluster_axes: Tuple[str, ...],
                             n_clients: int, n_shards: int, compute_dtype,
                             axes_list: List[tuple], template=None):
    """Custom-backward gather for the WHOLE final subtree.

    forward : per-leaf all-gather of the FSDP shards
    backward: pack full-size cotangents -> (P,) slab; weighted psum over
              "client" (LAN, eq. 3); K7 mask+apply; masked psum over
              clusters (MAC, eq. 8) + AWGN; guarded |M|·N estimate
              (eq. 10); unpack; slice each leaf's own FSDP shard.

    Returns ``gather_final(shard_tree, ctx)``. ``ctx.sigma2`` is this
    cluster's σ². ``template`` (full-size ω̃ shapes, e.g.
    ``abstract_params(model.final_specs())``) makes a mismatched tree an
    error that names the leaf. The AWGN is ``rng.normal`` (erfinv), which
    matches ``jax.random.normal`` to float32 rounding, not bit for bit."""
    fsdp = [_fsdp_axis(a) for a in axes_list]
    tpl_paths = (None if template is None else
                 [p for p, _ in tree_flatten_with_path(template)])
    me = mesh.axis_index(data_axes)
    cidx = cluster_index(mesh, cluster_axes)

    def _check(tree, what):
        paths = [p for p, _ in tree_flatten_with_path(tree)]
        if tpl_paths is not None and paths != tpl_paths:
            raise ValueError(f"{what}: leaves {['/'.join(p) for p in paths]}"
                             f" do not mirror model.final_specs() "
                             f"{['/'.join(p) for p in tpl_paths]}")
        if len(paths) != len(fsdp):
            raise ValueError(f"{what}: got {len(paths)} leaves but this "
                             f"gather was built over {len(fsdp)} ω̃ leaves")

    def gather_final(shard_tree, ctx: OTACtx):
        _check(shard_tree, "parameter tree (packed final gather)")
        like = tree_unflatten(shard_tree, [None] * len(fsdp))

        def fwd(leaves):
            return [gather_leaf(l, ax, mesh, data_axes, compute_dtype)
                    for l, ax in zip(leaves, fsdp)]

        def bwd(grads):
            g_tree = tree_unflatten(like, [g.to(torch.float32)
                                           for g in grads])
            packer = packer_for(g_tree, tail=None)
            g_slab = packer.pack(g_tree)                   # (P,) full-size
            x = col.psum(ctx.p_weight * g_slab, mesh, CLIENT_AXIS)
            xm, mask = _packed_mask_apply(x, ctx.key, ctx.sigma2, ctx.h_th,
                                          ctx.ota_on, cidx)
            y = col.psum(xm, mesh, cluster_axes)
            cnt = col.psum(mask, mesh, cluster_axes)
            z = (rng.normal(rng.fold_in(ctx.key, HOTA_MASK_SALT),
                            g_slab.shape, device=g_slab.device)
                 * ctx.noise_std * ctx.ota_on)
            ghat = torch.where(cnt > 0, (y + z) / (torch.clamp(cnt, min=1.0)
                                                   * n_clients),
                               torch.zeros_like(y))
            out = tree_leaves(packer.unpack(ghat))
            return [shard_of(l, ax, me, n_shards) if ax >= 0 else l
                    for l, ax in zip(out, fsdp)]

        return custom_gather(shard_tree, fwd, bwd, _full_shapes(
            shard_tree, fsdp, n_shards))

    return gather_final


def _full_shapes(shard_tree, fsdp, n_shards):
    """Meta stand-ins of the full leaves of a shard tree."""
    out = []
    for l, ax in zip(tree_leaves(shard_tree), fsdp):
        shape = list(l.shape)
        if ax >= 0:
            shape[ax] *= n_shards
        out.append(torch.empty(shape, dtype=torch.float32, device="meta"))
    return tree_unflatten(shard_tree, out)


def packed_final_norm(g_final, base_key, chan_c: ChannelParams,
                      cluster: int) -> torch.Tensor:
    """n_i = ‖M ∘ ∇_{ω̃}F_i‖ (eq. 6) on the packed slab: the SAME flat mask
    draw the packed gather backward applies (one K7 launch)."""
    g32 = tree_unflatten(g_final, [g.to(torch.float32)
                                   for g in tree_leaves(g_final)])
    packer = packer_for(g32, tail=None)
    masked, _ = _packed_mask_apply(
        packer.pack(g32), packed_final_key(base_key), chan_c.sigma2,
        chan_c.h_threshold, chan_c.ota_on, cluster)
    return torch.sqrt(torch.sum(torch.square(masked)))


def _mesh_data_axes(mesh: Mesh) -> Tuple[str, ...]:
    """FSDP axes in CLIENT-major order (scatter-region alignment)."""
    if "client" not in mesh.axis_names or "cluster" not in mesh.axis_names:
        raise ValueError(f"the FL mesh needs 'cluster' and 'client' axes, "
                         f"got {mesh.axis_names}")
    return ("client", "cluster")


def _mesh_cluster_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in ("pod", "cluster"))


def _mesh_client_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.axis_names
                 if a in ("pod", "cluster", "client"))
