"""The distributed HOTA-FedGradNorm training step on ``torch.distributed``.

Port of ``repro.core.hota_step`` on the slab engine. Each process of the
FL mesh is one (cluster, client) position and runs the step on its own
shards; ``make_hota_train_step(model, mesh, fl, tcfg, loss_kind="cls",
n_out=...)`` returns (init_fn, step_fn, state_specs, batch_spec), where
step_fn is the whole Algorithm 1 round:

  phase 0  trunk forward once (PS->IS->client broadcast = FSDP gather)
  phase A  τ_h personalized-head Adam steps on the frozen features
  phase B  FGN inputs: the client's tail loss and masked ‖∇_{ω̃}F‖ (eq. 6,
           ``sectioned_final_norm``), then the distributed Alg. 2 update of
           p (means over "client")
  phase C  full forward/backward; every shared-parameter gradient flows
           through the slab gather's backward (``make_packed_omega_gather``:
           K6 or K5 per leaf, LAN reduce-scatter, MAC psum, ĝ), averaged
           over ``fl.microbatches``; Adam on the rank's FSDP shard (the PS
           update, moments as one local slab); local Adam on the head.

The channel and weighting knobs are tensors (``ChannelParams``): step_fn
takes an optional ``chan`` whose σ² is (n_total_clusters,); dynamic vs.
equal weighting is a ``torch.where`` on ``fgn_on``. Omitting ``chan``
with equal weighting and τ_h = 0 (and no faults) takes the fast path that
skips phases 0/A/B, whose outputs could never be read.

Fault injection (DESIGN.md §3.14, ``fl.faults``; the knobs a
``FaultParams``, overridable per call): every rank draws the round's
(C, N) participation from the round key and reads its own slot. A
straggler runs the whole round against the delayed copy ``omega_stale``
(sharded like ω and gathered by the same all-gather); its phase-C loss
is taken at the stale parameters while the gradient flows through the
OTA gather (a straight-through select). The transmit weight folds
participation and the 1/√(1+age) discount; ``live`` and N_eff reach the
K6 or K5 backward; a dead cluster's FedGradNorm state and a
non-participant's head freeze. The guard's ‖ĝ‖² is the sum of the FSDP
shards' sums over the data axes plus the replicated leaves' sums, and a
skipped round is the bit-exact identity of the whole state (only
``step`` advances).

Layouts (``state_specs``, ``batch_spec``) are ``PartitionSpec``-like
tuples (``repro_torch.sharding.mesh_utils``): FSDP leaves split their
``embed`` dim over ("client", "cluster"), client-indexed fields their
leading dim over the client axes, the slab Adam moments over the data
axes (the global moment is the shard-major concatenation of the ranks'
local slabs). ``shard_state`` cuts a rank's state from a global one.

Not ported yet, each refused by name: the per-leaf oracle
(``use_pallas_ota=False``) and the sectioned schedule (``ota_sectioned``,
``max_section_rows``), ROADMAP Queue 1 item 13; the LM loss
(``loss_kind="lm"``, item 14.1).
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import rng
from repro_torch.common.config import FLConfig, TrainConfig
from repro_torch.common.tree import (
    state_map, tree_leaves, tree_map, tree_unflatten,
)
from repro_torch.core import ota
from repro_torch.core.channel import (
    ChannelParams, FaultParams, channel_params, cluster_channel,
    fault_params,
)
from repro_torch.core.hota import (
    CLIENT_AXIS, OTACtx, _mesh_client_axes, _mesh_cluster_axes,
    _mesh_data_axes, cluster_index,
)
from repro_torch.core.hota_slab import (
    _fsdp_axis_full, make_packed_omega_gather,
    packed_omega_key, plain_gather_full, sectioned_final_norm,
)
from repro_torch.models.model import Model
from repro_torch.models.params import (
    abstract_params, init_params, logical_axes,
)
from repro_torch.optim.adam import (
    AdamState, SlabAdamState, adam_update, slab_adam_update,
)
from repro_torch.sharding import collectives as col
from repro_torch.sharding.mesh_utils import Mesh, shard_slices


def cls_head_loss(head, head_apply, feats, labels) -> torch.Tensor:
    logits = head_apply(head, feats)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.gather(logp, -1, labels.to(torch.int64).unsqueeze(-1))
    return -torch.mean(ll.squeeze(-1))


class HotaState(NamedTuple):
    omega: Any          # {"trunk","final"}: this rank's FSDP shards
    opt: Any            # SlabAdamState: this rank's local moment slab
    heads: Any          # this client's head, leaves (1, ...)
    head_opt: Any       # AdamState: step (), moments (1, ...)
    p: torch.Tensor         # (1,)
    fgn_mu: torch.Tensor    # (1,)
    fgn_nu: torch.Tensor    # (1,)
    fgn_t: torch.Tensor     # () int32
    f0: torch.Tensor        # (1,)
    step: torch.Tensor      # () int32
    # fault injection only (None otherwise):
    omega_stale: Any = None     # the delayed ω copy, sharded like ω
    stale_age: Any = None       # () float32 rounds since its refresh


class StepParts(NamedTuple):
    """The round body and what a harness needs to lay it on a mesh."""
    init_fn: Callable       # init_fn(key) -> this rank's HotaState
    step: Callable  # step(state, tokens, labels, key, chan, faults[, fast])
    state_specs: Any        # HotaState of layout tuples
    batch_spec: tuple
    chan_all: ChannelParams  # the factory FLConfig's knobs
    n_total_clusters: int
    has_fast: bool          # equal weighting, τ_h = 0, no faults
    faults_all: FaultParams  # the factory FLConfig's fault knobs


def _refuse(fl: FLConfig, loss_kind: str) -> None:
    """What this port does not carry yet refuses by name, like the
    reference's own static refusals, instead of running another round."""
    if loss_kind == "lm":
        raise NotImplementedError(
            "loss_kind='lm' (the chunked LM loss) waits for LM training: "
            "ROADMAP Queue 1, item 14.1")
    if loss_kind != "cls":
        raise ValueError(f"loss_kind must be 'cls' or 'lm', got "
                         f"{loss_kind!r}")
    if fl.faults and not fl.use_pallas_ota:
        raise ValueError(
            "fl.faults requires the slab engine (use_pallas_ota=True): the "
            "per-leaf distributed path has no participation-aware "
            "aggregation — use the per-leaf SIMULATOR (repro_torch.core."
            "sim) as the fault oracle instead (DESIGN.md §3.14)")
    if not fl.use_pallas_ota:
        raise NotImplementedError(
            "use_pallas_ota=False (the per-leaf distributed oracle) is not "
            "ported yet: ROADMAP Queue 1, item 13")
    if fl.ota_streaming:
        raise ValueError(
            "fl.ota_streaming is a SIMULATOR engine (DESIGN.md §3.15): the "
            "distributed round already holds one cluster per device group, "
            "so there is no cluster batch to stream. Use fl.ota_sectioned "
            "for the section-streaming distributed schedule (DESIGN.md "
            "§3.16)")
    if fl.ota_sectioned:
        raise NotImplementedError(
            "fl.ota_sectioned (the section-streaming distributed schedule) "
            "is not ported yet: ROADMAP Queue 1, item 13")
    if fl.max_section_rows:
        raise NotImplementedError(
            "fl.max_section_rows in the distributed step comes with the "
            "sectioned schedule: ROADMAP Queue 1, item 13")


def shard_state(state, specs, mesh: Mesh, rank: Optional[int] = None,
                device=None):
    """The piece of a global state (tensors or arrays, any nesting of
    dicts and named tuples) that ``rank`` holds under ``specs``."""
    if isinstance(state, dict):
        return {k: shard_state(state[k], specs[k], mesh, rank, device)
                for k in state}
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*[None if v is None else
                             shard_state(v, s, mesh, rank, device)
                             for v, s in zip(state, specs)])
    t = torch.as_tensor(np.asarray(state)) if not torch.is_tensor(
        state) else state
    piece = t[shard_slices(tuple(t.shape), specs, mesh, rank)]
    return piece.to(device).clone()


def _requires_grad(tree):
    return tree_map(lambda t: t.detach().requires_grad_(True), tree)


def make_hota_step_parts(model: Model, mesh: Mesh, fl: FLConfig,
                         tcfg: TrainConfig, *, loss_kind: str = "lm",
                         n_out: Optional[int] = None,
                         count_mode: Optional[str] = None) -> StepParts:
    """The Alg.-1 round body for this rank of ``mesh`` and its layouts.
    ``count_mode`` picks how the backward counts |M| ("local": K6,
    "psum": K5; None: by the mesh's device, see ``hota_slab``)."""
    _refuse(fl, loss_kind)
    cfg = model.cfg
    data_axes = _mesh_data_axes(mesh)           # ("client", "cluster")
    cluster_axes = _mesh_cluster_axes(mesh)     # ("pod","cluster") | ...
    client_axes = _mesh_client_axes(mesh)       # all FL axes
    n_clients = mesh.shape["client"]
    n_shards = mesh.axis_size(data_axes)
    n_total_clients = mesh.axis_size(client_axes)
    n_total_clusters = mesh.axis_size(cluster_axes)
    dev = mesh.device
    compute_dtype = getattr(torch, cfg.compute_dtype)
    chan_all = channel_params(fl, device=dev, n_clusters=n_total_clusters)
    faults_all = fault_params(fl, device=dev)
    cidx = cluster_index(mesh, cluster_axes)

    head_specs = model.head_specs(n_out)
    omega_specs = {"final": model.final_specs(),
                   "trunk": model.trunk_specs()}
    omega_template = abstract_params(omega_specs)
    omega_axes = tree_leaves(logical_axes(omega_specs))
    omega_gather, omega_pk = make_packed_omega_gather(
        mesh, data_axes, cluster_axes, n_clients, n_shards, compute_dtype,
        omega_template, omega_axes, n_clusters=n_total_clusters,
        count_mode=count_mode, sections=fl.ota_sections,
        min_section_rows=fl.min_section_rows,
        max_section_rows=fl.max_section_rows, sectioned=fl.ota_sectioned)
    omega_fsdp = [_fsdp_axis_full(ax) for ax in omega_axes]
    slab_local_len = sum(
        math.prod(l.shape) // (n_shards if ax >= 0 else 1)
        for l, ax in zip(tree_leaves(omega_template), omega_fsdp))

    def loss_fn(head, feats, labels):
        return cls_head_loss(head, model.head_apply, feats, labels)

    # ---------------- layouts ----------------
    def fsdp_spec(axes):
        ax = _fsdp_axis_full(axes)
        if ax < 0:
            return ()
        return tuple(data_axes if d == ax else None for d in range(ax + 1))
    omega_layout = tree_unflatten(omega_specs,
                                  [fsdp_spec(a) for a in omega_axes])
    per_client = (client_axes,)
    heads_layout = tree_map(lambda _: per_client, head_specs)
    slab_spec = (data_axes,)
    state_specs = HotaState(
        omega=omega_layout,
        opt=SlabAdamState(step=(), mu=slab_spec, nu=slab_spec),
        heads=heads_layout,
        head_opt=AdamState(step=(), mu=heads_layout, nu=heads_layout),
        p=per_client, fgn_mu=per_client, fgn_nu=per_client, fgn_t=(),
        f0=per_client, step=(),
        omega_stale=omega_layout if fl.faults else None,
        stale_age=() if fl.faults else None)
    batch_spec = (per_client, per_client)

    # ---------------- init ----------------
    def init_fn(key) -> HotaState:
        """This rank's piece of the global state of a PRNG key, the
        reference's ``init_fn(key)``: ``k1, k2 = split(key)``, the trunk
        from ``k1``, ω̃ from ``fold_in(k1, FINAL_INIT_FOLD)``, one head
        per client from ``split(k2, n_clients)``. Drawn on the host, the
        same on every rank."""
        k1, k2 = rng.split(key)
        omega = {"final": init_params(model.final_specs(),
                                      rng.fold_in(k1, ota.FINAL_INIT_FOLD)),
                 "trunk": init_params(model.trunk_specs(), k1)}
        heads = init_params(head_specs, rng.split(k2, n_total_clients))
        zc = torch.zeros((n_total_clients,), dtype=torch.float32)
        i32 = torch.zeros((), dtype=torch.int32)
        zeros = lambda t: tree_map(torch.zeros_like, t)   # noqa: E731
        state = HotaState(
            omega=omega,
            opt=SlabAdamState(step=i32,
                              mu=torch.zeros(n_shards * slab_local_len),
                              nu=torch.zeros(n_shards * slab_local_len)),
            heads=heads,
            head_opt=AdamState(step=i32, mu=zeros(heads), nu=zeros(heads)),
            p=torch.ones(n_total_clients), fgn_mu=zc, fgn_nu=zc.clone(),
            fgn_t=i32, f0=torch.ones(n_total_clients), step=i32,
            omega_stale=(tree_map(torch.clone, omega) if fl.faults
                         else None),
            stale_age=(torch.zeros((), dtype=torch.float32) if fl.faults
                       else None))
        return shard_state(state, state_specs, mesh, device=dev)

    def _metrics(loss_val, p_new, fgrad_val, n_i):
        v = torch.stack([loss_val, p_new, fgrad_val, n_i]).to(torch.float32)
        v = col.pmean(v, mesh, client_axes)
        mx = col.pmax(torch.stack([-p_new, p_new]).contiguous(), mesh,
                      client_axes)
        return {"loss": v[0], "p_mean": v[1], "p_min": -mx[0],
                "p_max": mx[1], "fgrad": v[2], "gnorm_mean": v[3]}

    # ---------------- the step ----------------
    @torch.no_grad()
    def _step(state: HotaState, tokens, labels, key, chan: ChannelParams,
              faults: Optional[FaultParams] = None, fast: bool = False):
        base_key = rng.fold_in(key, int(state.step))
        chan = ChannelParams(*[torch.as_tensor(f, dtype=torch.float32,
                                               device=dev) for f in chan])
        chan_c = cluster_channel(chan, cidx)
        tokens = torch.as_tensor(tokens).to(device=dev,
                                            dtype=torch.float32)
        labels = torch.as_tensor(labels).to(device=dev, dtype=torch.int64)
        head = tree_map(lambda a: a[0], state.heads)
        head_opt = AdamState(step=state.head_opt.step,
                             mu=tree_map(lambda a: a[0], state.head_opt.mu),
                             nu=tree_map(lambda a: a[0], state.head_opt.nu))
        head0, head_opt0 = head, head_opt
        p_i = state.p[0]
        f0_i = state.f0[0]
        zero = torch.zeros((), dtype=torch.float32, device=dev)

        # fault injection: every rank draws the same (C, N) participation
        # from the round key and reads its own slot
        partc = stale_full = None
        if fl.faults:
            fp = FaultParams(*[torch.as_tensor(f, dtype=torch.float32,
                                               device=dev)
                               for f in (faults_all if faults is None
                                         else faults)])
            partc = ota.draw_participation(base_key, fp, n_total_clusters,
                                           n_clients, dev)
            my_client = mesh.axis_index(CLIENT_AXIS)
            part_me = partc.part[cidx, my_client]
            stale_me = partc.stale[cidx, my_client]
            live_me = partc.live[cidx]

        if fast:
            # equal weighting, τ_h = 0, default chan: phases 0/A/B vanish
            p_new = p_i
            mu, nu = state.fgn_mu[0], state.fgn_nu[0]
            fgn_t_new = state.fgn_t
            fgrad_val = n_i = zero
            f0 = f0_i
        else:
            # ---- phase 0: trunk features (ω frozen; broadcast = gather)
            omega_full0 = plain_gather_full(state.omega, omega_fsdp, mesh,
                                            data_axes, compute_dtype)
            if partc is not None:
                # the stale copy rides the same gather; a straggler sees
                # it for the whole round (the sim's per-client select)
                stale_full = plain_gather_full(state.omega_stale,
                                               omega_fsdp, mesh, data_axes,
                                               compute_dtype)
                omega_full0 = tree_map(
                    lambda f, o: torch.where(stale_me > 0.5, o, f),
                    omega_full0, stale_full)
            hidden = model.trunk_apply(omega_full0["trunk"], tokens)
            final_full = omega_full0["final"]

            def tail_loss(ff, hd):
                return loss_fn(hd, model.final_apply(ff, hidden), labels)

            # ---- phase A: τ_h personalized-head steps (Alg. 1 l. 10-11)
            for _ in range(fl.tau_h):
                hd = _requires_grad(head)
                with torch.enable_grad():
                    g = torch.autograd.grad(tail_loss(final_full, hd),
                                            tree_leaves(hd))
                head, head_opt = adam_update(
                    tree_unflatten(hd, list(g)), head_opt,
                    tree_map(torch.Tensor.detach, hd), tcfg.lr)

            # ---- phase B: FGN inputs + distributed Alg. 2
            ff = _requires_grad(final_full)
            with torch.enable_grad():
                F_i = tail_loss(ff, head)
                g_final = torch.autograd.grad(F_i, tree_leaves(ff))
            F_i = F_i.detach()
            n_i = sectioned_final_norm(
                tree_unflatten(ff, list(g_final)),
                packed_omega_key(base_key), chan_c, cidx, omega_pk)
            f0 = torch.where(state.step == 0, F_i, f0_i)
            ratio = F_i / torch.clamp(f0, min=1e-12)
            # Alg. 2, computed whatever the gate so the collectives stay
            # uniform across ranks, then selected by the weighting gate
            means = col.pmean(torch.stack([p_i * n_i, ratio]), mesh,
                              CLIENT_AXIS)
            gbar, rmean = means[0], means[1]
            target = torch.pow(torch.clamp(
                ratio / torch.clamp(rmean, min=1e-12), min=1e-12), fl.gamma)
            resid = p_i * n_i - gbar * target
            gp = torch.sign(resid) * n_i
            # scalar Adam on p_i (state shared-stepped)
            t = (state.fgn_t + 1).to(torch.float32)
            b1, b2, eps = 0.9, 0.999, 1e-8
            mu_fgn = b1 * state.fgn_mu[0] + (1 - b1) * gp
            nu_fgn = b2 * state.fgn_nu[0] + (1 - b2) * gp * gp
            p_fgn = p_i - fl.alpha * (mu_fgn / (1 - b1 ** t)) / (
                torch.sqrt(nu_fgn / (1 - b2 ** t)) + eps)
            p_fgn = torch.clamp(p_fgn, min=fl.p_min + 1e-6)
            sums = col.psum(torch.stack([torch.abs(resid), p_fgn]), mesh,
                            CLIENT_AXIS)
            fgrad_fgn = sums[0]
            p_fgn = p_fgn * n_clients / torch.clamp(sums[1], min=1e-12)
            fgn_on = chan_c.fgn_on > 0.5
            # under faults a dead cluster's (p, moment) state freezes too;
            # fgn_t stays uniform across the ranks
            fgn_upd = fgn_on if partc is None else fgn_on & (live_me > 0.5)
            p_new = torch.where(fgn_upd, p_fgn, p_i)
            mu = torch.where(fgn_upd, mu_fgn, state.fgn_mu[0])
            nu = torch.where(fgn_upd, nu_fgn, state.fgn_nu[0])
            fgn_t_new = torch.where(fgn_on, state.fgn_t + 1, state.fgn_t)
            fgrad_val = torch.where(fgn_on, fgrad_fgn, zero)

        # ---- phase C: full backward through the OTA aggregation
        # channel keys fold only (step, section): masks and AWGN are the
        # same for every microbatch, so averaging the microbatch estimates
        # is ONE MAC transmission of the round-averaged x^(l)
        # under faults the transmit weight folds participation and the
        # FedBuff discount from the carried age; live/N_eff generalize
        # eq. 10
        w_tx = p_new.to(torch.float32)
        ctx_live = ctx_n_eff = None
        if partc is not None:
            disc = torch.where(stale_me > 0.5,
                               torch.rsqrt(1.0 + state.stale_age),
                               torch.ones_like(stale_me))
            w_tx = w_tx * part_me * disc
            ctx_live, ctx_n_eff = partc.live, partc.n_eff
        slab_ctx = OTACtx(
            p_weight=w_tx,
            key=packed_omega_key(base_key),
            sigma2=chan.sigma2,       # every cluster's σ² (local counts)
            h_th=chan_c.h_threshold, noise_std=chan_c.noise_std,
            ota_on=chan_c.ota_on, live=ctx_live, n_eff=ctx_n_eff)

        def st_sel(fr, old):
            # a straggler's loss at the stale parameters, the gradient
            # through the OTA gather: (sel + fr) − fr is sel's value
            # (to rounding, as the reference computes it) and has
            # d/dfr = 1
            sel = torch.where(stale_me > 0.5, old, fr)
            return (sel.detach() + fr) - fr.detach()
        n_mb = max(fl.microbatches, 1)
        b_loc = tokens.shape[0]
        if b_loc % n_mb:
            raise ValueError(f"a local batch of {b_loc} does not split into "
                             f"{n_mb} microbatches")
        om = _requires_grad(state.omega)
        hd = _requires_grad(head)
        n_om = len(tree_leaves(om))
        g_sum, loss_sum = None, None
        for tok_mb, lab_mb in zip(tokens.chunk(n_mb), labels.chunk(n_mb)):
            with torch.enable_grad():
                full = omega_gather(om, slab_ctx)
                if stale_full is not None:
                    full = tree_map(st_sel, full, stale_full)
                h = model.trunk_apply(full["trunk"], tok_mb)
                loss = loss_fn(hd, model.final_apply(full["final"], h),
                               lab_mb)
                g = torch.autograd.grad(loss, tree_leaves(om)
                                        + tree_leaves(hd))
            g_sum = list(g) if g_sum is None else [
                a + b for a, b in zip(g_sum, g)]
            loss_sum = loss.detach() if loss_sum is None else (
                loss_sum + loss.detach())
        if n_mb > 1:
            g_sum = [x / n_mb for x in g_sum]
            loss_sum = loss_sum / n_mb
        g_omega = tree_unflatten(om, g_sum[:n_om])
        g_head = tree_unflatten(hd, g_sum[n_om:])

        # the PS update on the slab view of this rank's shards
        omega, opt = slab_adam_update(
            g_omega, state.opt, state.omega, tcfg.lr, tcfg.betas[0],
            tcfg.betas[1], tcfg.eps, tcfg.weight_decay)
        # Alg. 1 trains heads in the τ_h phase only; with τ_h = 0 they
        # train on the phase-C gradient instead, for every scenario
        if fl.tau_h == 0:
            head, head_opt = adam_update(g_head, head_opt, head, tcfg.lr)
        if partc is not None:
            # a non-participant keeps its head and moments (the head Adam
            # step counter stays uniform across the ranks)
            keep = part_me > 0.5
            head = tree_map(lambda a, b: torch.where(keep, a, b), head,
                            head0)
            head_opt = AdamState(
                step=head_opt.step,
                mu=tree_map(lambda a, b: torch.where(keep, a, b),
                            head_opt.mu, head_opt0.mu),
                nu=tree_map(lambda a, b: torch.where(keep, a, b),
                            head_opt.nu, head_opt0.nu))

        new_state = HotaState(
            omega=omega, opt=opt,
            heads=tree_map(lambda a: a.unsqueeze(0), head),
            head_opt=AdamState(
                step=head_opt.step,
                mu=tree_map(lambda a: a.unsqueeze(0), head_opt.mu),
                nu=tree_map(lambda a: a.unsqueeze(0), head_opt.nu)),
            p=p_new.reshape(1), fgn_mu=mu.reshape(1), fgn_nu=nu.reshape(1),
            fgn_t=fgn_t_new, f0=f0.reshape(1), step=state.step + 1)
        metrics = _metrics(loss_sum, p_new, fgrad_val, n_i)
        if partc is None:
            return new_state, metrics

        # the round guard (DESIGN.md §3.14): ‖ĝ‖², the same on every rank
        # (the FSDP shards' sums over the data axes, the replicated
        # leaves' sums as they are)
        sq = [torch.sum(l.to(torch.float32) ** 2)
              for l in tree_leaves(g_omega)]
        gn2_loc = torch.stack([v for v, ax in zip(sq, omega_fsdp)
                               if ax >= 0] + [zero]).sum().reshape(1)
        gn2_rep = torch.stack([v for v, ax in zip(sq, omega_fsdp)
                               if ax < 0] + [zero]).sum()
        gn2 = col.psum(gn2_loc, mesh, data_axes)[0] + gn2_rep
        skip = ((partc.total < 0.5) | ~torch.isfinite(gn2)
                | (gn2 > fp.spike_norm * fp.spike_norm))
        # the stale copy refreshes every fp.staleness rounds
        refresh = (state.stale_age + 1.0) >= fp.staleness
        new_state = new_state._replace(
            omega_stale=tree_map(lambda a, b: torch.where(refresh, a, b),
                                 new_state.omega, state.omega_stale),
            stale_age=torch.where(refresh,
                                  torch.zeros_like(state.stale_age),
                                  state.stale_age + 1.0))
        # a skipped round is the bit-exact identity (step aside)
        new_state = state_map(lambda a, b: torch.where(skip, b, a),
                              new_state, state)
        new_state = new_state._replace(step=state.step + 1)
        metrics.update(skipped=skip.to(torch.float32),
                       n_participants=partc.total)
        return new_state, metrics

    return StepParts(
        init_fn=init_fn, step=_step, state_specs=state_specs,
        batch_spec=batch_spec, chan_all=chan_all,
        n_total_clusters=n_total_clusters,
        has_fast=(fl.weighting == "equal" and fl.tau_h == 0
                  and not fl.faults),
        faults_all=faults_all)


def make_hota_train_step(model: Model, mesh: Mesh, fl: FLConfig,
                         tcfg: TrainConfig, *, loss_kind: str = "lm",
                         n_out: Optional[int] = None,
                         count_mode: Optional[str] = None):
    """Returns (init_fn, step_fn, state_specs, batch_spec) for this rank.

    ``step_fn(state, tokens, labels, key, chan=None, faults=None)`` runs
    one round on the rank's shards and its local batch (``batch_spec``
    cuts it from a global one); ``key`` is the round's threefry key.
    ``chan`` overrides the factory config's knobs for this call (σ² of
    shape (n_total_clusters,)), ``faults`` its fault knobs (read only
    when ``fl.faults`` is on)."""
    parts = make_hota_step_parts(model, mesh, fl, tcfg, loss_kind=loss_kind,
                                 n_out=n_out, count_mode=count_mode)
    n_total_clusters = parts.n_total_clusters

    def step_fn(state: HotaState, tokens, labels, key,
                chan: Optional[ChannelParams] = None,
                faults: Optional[FaultParams] = None):
        if chan is None:
            return parts.step(state, tokens, labels, key, parts.chan_all,
                              faults, fast=parts.has_fast)
        if tuple(chan.sigma2.shape) != (n_total_clusters,):
            raise ValueError(
                f"chan.sigma2 shape {tuple(chan.sigma2.shape)} != "
                f"(n_total_clusters,) = ({n_total_clusters},)")
        return parts.step(state, tokens, labels, key, chan, faults)

    return parts.init_fn, step_fn, parts.state_specs, parts.batch_spec
