"""Paper-scale simulator of HOTA-FedGradNorm (Algorithm 1 + Algorithm 2).

Port of ``repro.core.sim``: the slab-native round on each of the
reference's aggregation engines (client-folded, streaming, sectioned,
sectioned + streaming, picked by ``FLConfig.ota_streaming`` /
``ota_sectioned``; ``"toplevel"`` or ``"tail"`` section layout, optional
``max_section_rows`` splits) and the per-leaf oracle
(``use_pallas_ota=False``: ``ota.ota_aggregate_tree`` with the tree Adam
for the PS), with or without fault injection (``FLConfig.faults``). The
reference's ``vmap`` over (cluster, client) is a batch dimension written
out: every client-indexed tensor carries leading (C, N) axes.

Per global iteration k (Alg. 1):
 1. PS broadcasts ω_k.
 2. Each client: τ_h head steps (Adam), then τ_ω local shared steps (SGD),
    averaging its shared-net gradient ḡ and loss F̄.
 3. IS l runs FGN_Server (Alg. 2) on channel-masked last-layer gradient
    norms (the ``masked_gradnorm`` kernel, one launch for all clusters).
 4. The clusters superpose over the fading MAC and the PS estimates ĝ
    (eqs. 3, 8-10): the ``ota_client_fold`` kernel, one launch per leaf,
    or on the streaming engines ``ota_mask_weight``, one launch per
    (cluster, leaf); the per-leaf oracle draws Gaussian gains per leaf.
 5. PS updates ω with the slab-view Adam (the tree Adam on the per-leaf
    oracle).

Fault injection (DESIGN.md §3.14, the static ``FLConfig.faults`` gate;
the knobs are ``FaultParams`` tensors): the round's participation is
drawn from the round key (``ota.draw_participation``). Stragglers train
against the delayed copy ``omega_stale`` and transmit with the
1/√(1+age) discount; a dropped client keeps its head and Adam state; a
dead cluster's FedGradNorm state freezes; ``live`` and N_eff reach every
engine. A round with no participant, a non-finite ĝ or ‖ĝ‖ above
``spike_norm`` is the bit-exact identity (only ``step`` advances). Every
one of these is a ``torch.where`` on device tensors: nothing on the host
depends on the rates, so a faultier round costs the same.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch import rng
from repro_torch.common.config import FLConfig, TrainConfig
from repro_torch.common.device import resolve_device
from repro_torch.common.flatpack import TreePacker, packer_for
from repro_torch.common.spans import span
from repro_torch.common.tree import (
    state_map, tree_leaves, tree_map, tree_unflatten,
)
from repro_torch.core import ota
from repro_torch.core.channel import (
    ChannelParams, FaultParams, channel_params, fault_params,
)
from repro_torch.core.fedgradnorm import FGNState, fgn_init, fgn_update_gated
from repro_torch.kernels.masked_gradnorm.ops import masked_gradnorm
from repro_torch.models.model import Model
from repro_torch.models.params import abstract_params, init_params
from repro_torch.optim.adam import (
    AdamState, adam_init, adam_update, slab_adam_init, slab_adam_update,
)


class SimState(NamedTuple):
    omega: Any                  # {"final": ..., "trunk": ...} shared net
    heads: Any                  # leaves (C, N, ...)
    p: torch.Tensor             # (C, N) loss weights
    ps_opt: Any                 # PS update: SlabAdamState (AdamState per-leaf)
    head_opt: AdamState         # step (C, N), moments (C, N, ...)
    fgn: FGNState               # step (C,), moments (C, N)
    f0: torch.Tensor            # (C, N) initial losses (for F̃)
    step: torch.Tensor          # () int32
    # fault injection only (None otherwise, as in the reference):
    omega_stale: Any = None     # the delayed ω copy stragglers train on
    stale_age: Any = None       # () float32 rounds since its refresh


def masked_cls_loss(logits: torch.Tensor, labels: torch.Tensor,
                    n_valid: torch.Tensor) -> torch.Tensor:
    """Cross-entropy with classes ≥ n_valid masked out (heads are padded
    to the largest class count). logits (..., B, c), labels (..., B),
    n_valid broadcastable to the leading axes; returns the (...,) mean
    over B."""
    c = logits.shape[-1]
    valid = (torch.arange(c, device=logits.device)
             < n_valid.unsqueeze(-1).unsqueeze(-1))
    logits = torch.where(valid, logits, torch.full_like(logits, -1e30))
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, labels.to(torch.int64).unsqueeze(-1))
    return -ll.squeeze(-1).mean(dim=-1)


def _requires_grad(tree):
    return tree_map(lambda t: t.detach().requires_grad_(True), tree)


class HotaSim:
    def __init__(self, model: Model, fl: FLConfig, tcfg: TrainConfig,
                 n_classes_per_client, max_classes: int = None,
                 device="cuda"):
        self.device = resolve_device(device)
        # the reference's own refusals: a static gate the chosen engine
        # cannot honour refuses loudly instead of being silently inert
        if fl.ota_sectioned and not fl.use_pallas_ota:
            raise ValueError(
                "fl.ota_sectioned requires the slab engine "
                "(use_pallas_ota=True): the per-leaf oracle has no "
                "Section partition to stream — the gate would be "
                "silently inert (DESIGN.md §3.16)")
        if fl.ota_sectioned and fl.ota_sections != "toplevel":
            raise ValueError(
                "fl.ota_sectioned requires a multi-section layout "
                f"(ota_sections='toplevel', got {fl.ota_sections!r}): "
                "section streaming over the legacy two-section layout "
                "holds most of the model in its head section — the "
                "memory bound would be silently vacuous (DESIGN.md §3.16)")
        if fl.max_section_rows and not fl.use_pallas_ota:
            raise ValueError(
                "fl.max_section_rows requires the slab engine "
                "(use_pallas_ota=True): the per-leaf oracle has no "
                "section layout to split — the cap would be silently "
                "inert (DESIGN.md §3.16)")
        self.model = model
        self.fl = fl
        self.tcfg = tcfg
        self.n_classes = torch.tensor(list(n_classes_per_client),
                                      dtype=torch.int32, device=self.device)
        self.max_classes = int(max_classes or max(n_classes_per_client))
        self.chan = channel_params(fl, device=self.device)
        # the fault knobs, read only when the static fl.faults gate is on
        self.faults = fault_params(fl, device=self.device)

    # ------------------------------------------------------------------
    def init(self, key) -> SimState:
        """Fresh state from a PRNG key (``rng.PRNGKey(seed)``), on the
        reference's key schedule: ``k1, k2 = split(key)``; the trunk from
        ``k1``, ω̃ from ``fold_in(k1, FINAL_INIT_FOLD)``; one head per
        client from ``split(k2, C·N)``. The weights are the reference's
        ``init`` at the same key (``models.params``)."""
        fl, dev = self.fl, self.device
        c, n = fl.n_clusters, fl.n_clients
        k1, k2 = rng.split(key)
        omega = {"final": init_params(self.model.final_specs(),
                                      rng.fold_in(k1, ota.FINAL_INIT_FOLD),
                                      device=dev),
                 "trunk": init_params(self.model.trunk_specs(), k1,
                                      device=dev)}
        head_keys = rng.split(k2, c * n).reshape(c, n, 2)
        heads = init_params(self.model.head_specs(self.max_classes),
                            head_keys, device=dev)
        return self._state_of(omega, heads, dev)

    def abstract_state(self) -> SimState:
        """The shapes and dtypes of ``init``'s state as storage-free
        ``meta`` tensors: what a checkpoint restore checks against."""
        c, n = self.fl.n_clusters, self.fl.n_clients
        omega = abstract_params({"final": self.model.final_specs(),
                                 "trunk": self.model.trunk_specs()})
        heads = tree_map(lambda t: t.expand((c, n) + tuple(t.shape)),
                         abstract_params(
                             self.model.head_specs(self.max_classes)))
        return self._state_of(omega, heads, "meta")

    def _state_of(self, omega, heads, dev) -> SimState:
        """The fresh state around the given weights, on ``dev``."""
        fl = self.fl
        c, n = fl.n_clusters, fl.n_clients
        ones = torch.ones((c, n), dtype=torch.float32, device=dev)
        ps_opt = (slab_adam_init(omega) if fl.use_pallas_ota
                  else adam_init(omega))
        return SimState(
            omega=omega, heads=heads, p=ones, ps_opt=ps_opt,
            head_opt=adam_init(heads, batch_shape=(c, n)),
            fgn=fgn_init(n, c, device=dev), f0=ones.clone(),
            step=torch.zeros((), dtype=torch.int32, device=dev),
            omega_stale=(tree_map(torch.clone, omega) if fl.faults
                         else None),
            stale_age=(torch.zeros((), dtype=torch.float32, device=dev)
                       if fl.faults else None))

    # ------------------------------------------------------------------
    def _client_update(self, omega, heads, head_opt, x, y,
                       omega_stale=None, stale=None):
        """τ_h head steps then τ_ω local shared steps (Alg. 1 lines 10-15)
        for every (cluster, client) at once. Returns (heads, head_opt,
        ḡ tree with (C, N, ...) leaves, F̄ (C, N)).

        With ``stale`` ((C, N) float flags) a flagged client works from
        ``omega_stale`` instead of ``omega`` in both phases: the head
        steps' features of both copies are computed and selected per
        client, and the τ_ω phase starts each client's copy from its
        own ω."""
        model, lr, fl = self.model, self.tcfg.lr, self.fl
        n_valid = self.n_classes
        batch = x.shape[:2]
        if stale is not None:
            use_stale = stale > 0.5

            def pick(fresh, old):      # per client: fresh or stale
                m = use_stale.reshape(batch + (1,) * (fresh.dim() - 2))
                return torch.where(m, old, fresh)
        with torch.no_grad():           # ω is fixed during the head steps
            feats = model.features(omega, x)
            if stale is not None:
                feats = pick(feats, model.features(omega_stale, x))
        with torch.enable_grad():
            for _ in range(fl.tau_h):
                hd = _requires_grad(heads)
                loss = masked_cls_loss(model.head_apply(hd, feats), y,
                                       n_valid)
                g = torch.autograd.grad(loss.sum(), tree_leaves(hd))
                heads, head_opt = adam_update(
                    tree_unflatten(hd, g), head_opt,
                    tree_map(torch.Tensor.detach, hd), lr)
            # per-client copies of ω: each client's loss reaches only its
            # own copy, so one backward gives every client's gradient
            om = tree_map(lambda t: t.expand(batch + t.shape).clone(), omega)
            if stale is not None:
                om = tree_map(lambda f, o: pick(f, o.expand(batch + o.shape)),
                              om, omega_stale)
            gacc, lsum = None, None
            for _ in range(fl.tau_w):
                om_r = _requires_grad(om)
                loss = masked_cls_loss(
                    model.head_apply(heads, model.features(om_r, x)), y,
                    n_valid)
                g = tree_unflatten(om_r, torch.autograd.grad(
                    loss.sum(), tree_leaves(om_r)))
                om = tree_map(lambda w, gg: w.detach() - lr * gg, om_r, g)
                gacc = g if gacc is None else tree_map(torch.add, gacc, g)
                lsum = (loss.detach() if lsum is None
                        else lsum + loss.detach())
        g_avg = tree_map(lambda a: a / fl.tau_w, gacc)
        return heads, head_opt, g_avg, lsum / fl.tau_w

    # ------------------------------------------------------------------
    def _masked_final_norms(self, g_final, final_masks) -> torch.Tensor:
        """(C, N) masked last-shared-layer gradient norms n_i (eq. 6): the
        clients are the task rows, the cluster's eq.-7 mask the shared
        column mask; one ``masked_gradnorm`` launch covers all clusters."""
        c, n = self.fl.n_clusters, self.fl.n_clients
        gm = torch.cat([l.reshape(c, n, -1).to(torch.float32)
                        for l in tree_leaves(g_final)], dim=-1)   # (C, N, P̃)
        mm = torch.cat([m.reshape(c, -1).to(torch.float32)
                        for m in tree_leaves(final_masks)], dim=-1)  # (C, P̃)
        return masked_gradnorm(gm, mm)

    # ------------------------------------------------------------------
    def packer(self, omega) -> Optional[TreePacker]:
        """The round's slab layout of the shared tree ``omega``: the
        config's section layout, coalescing and split cap; None on the
        per-leaf oracle, which has no slab."""
        fl = self.fl
        if not fl.use_pallas_ota:
            return None
        return packer_for(omega, tail="final", sections=fl.ota_sections,
                          min_section_rows=fl.min_section_rows,
                          max_section_rows=fl.max_section_rows)

    @property
    def draws_streams_at_once(self) -> bool:
        """Whether this sim's engine reads the round's streams of every
        section at once (the client-folded engine), so that a caller
        running several scenarios on one key can draw them once
        (``round_streams``). The streaming and sectioned engines draw
        inside the aggregation, a cluster or a section at a time, and the
        per-leaf oracle a leaf at a time."""
        fl = self.fl
        return fl.use_pallas_ota and not (fl.ota_streaming
                                          or fl.ota_sectioned)

    def round_streams(self, key, omega) -> ota.SectionStreams:
        """The round's section streams under round key ``key`` for the
        client-folded engine: what ``step_with_channel(...,
        ota_bits_mode="supplied", streams=...)`` reads."""
        if not self.draws_streams_at_once:
            raise ValueError("the streaming, sectioned and per-leaf engines "
                             "draw their streams inside the aggregation")
        return ota.section_streams(ota.sim_channel_key(key),
                                   self.packer(omega), self.fl.n_clusters,
                                   self.device)

    def aggregate(self, chan_key, g, p, chan: ChannelParams,
                  packer: TreePacker, ota_bits_mode: str = "fused",
                  streams: Optional[ota.SectionStreams] = None,
                  live: Optional[torch.Tensor] = None,
                  n_eff: Optional[torch.Tensor] = None):
        """The PS estimate ĝ (eqs. 3, 8-10) of the raw (C, N, ...) gradient
        tree ``g`` under the (C, N) weights ``p``, on this sim's engine as
        the reference picks it: ``use_pallas_ota=False`` weights the
        clients' gradients and runs the per-leaf oracle (``packer`` is then
        None), ``ota_sectioned`` walks the sections (streaming inside them
        with ``ota_streaming``), else ``ota_streaming`` folds one cluster
        at a time, else the client-folded engine reads ``streams`` (drawn
        from ``chan_key`` when None). ``live`` (C,) and ``n_eff`` () are
        the round's participation (None: everyone)."""
        fl = self.fl
        if not fl.use_pallas_ota:
            weighted = tree_map(
                lambda gl: torch.einsum("cn,cn...->c...",
                                        p.to(torch.float32),
                                        gl.to(torch.float32)), g)
            return ota.ota_aggregate_tree(chan_key, weighted, chan,
                                          fl.n_clients, live=live,
                                          n_eff=n_eff)
        if fl.ota_sectioned:
            return ota.ota_aggregate_sectioned(
                chan_key, g, p, chan, fl.n_clients, packer,
                bits_mode=ota_bits_mode, live=live, n_eff=n_eff,
                streaming=fl.ota_streaming)
        if fl.ota_streaming:
            return ota.ota_aggregate_streaming(
                chan_key, g, p, chan, fl.n_clients, packer,
                bits_mode=ota_bits_mode, live=live, n_eff=n_eff)
        return ota.ota_aggregate_client_folded(
            chan_key, g, p, chan, fl.n_clients, packer,
            bits_mode="fused" if streams is None else "supplied",
            live=live, n_eff=n_eff, streams=streams)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def step(self, state: SimState, xb, yb, key,
             chan: ChannelParams = None, faults: FaultParams = None):
        """One Alg.-1 round. xb: (C, N, B, d) float32; yb: (C, N, B) int;
        key: the round's threefry key, (2,) uint32 values (a JAX key as
        numpy, or ``repro_torch.rng.PRNGKey``/``fold_in`` output).
        ``chan`` overrides the channel knobs and ``faults`` the fault
        knobs (default: this sim's; the fault knobs are read only when
        ``fl.faults`` is on)."""
        return self.step_with_channel(state, xb, yb, key,
                                      self.chan if chan is None else chan,
                                      faults=faults)

    @torch.no_grad()
    def step_with_channel(self, state: SimState, xb, yb, key,
                          chan: ChannelParams, ota_bits_mode: str = "fused",
                          streams: Optional[ota.SectionStreams] = None,
                          faults: Optional[FaultParams] = None):
        """The round with explicit channel (and fault) knobs: what
        ``ScenarioBank`` runs for each scenario, on the engine the config
        picks (``aggregate``).

        ``ota_bits_mode="supplied"`` on the client-folded engine reads the
        round's streams from ``streams`` (``round_streams(key, ...)``), so
        the bank draws them once per round for all scenarios; "fused"
        draws them here. The other engines draw inside the aggregation in
        either mode and take no ``streams``. The values are the same."""
        with span("sim.round"):
            fl, tcfg, dev = self.fl, self.tcfg, self.device
            if ota_bits_mode not in ("fused", "supplied"):
                raise ValueError(f"ota_bits_mode must be 'fused' or "
                                 f"'supplied', got {ota_bits_mode!r}")
            if streams is not None and (ota_bits_mode != "supplied"
                                        or not self.draws_streams_at_once):
                raise ValueError("streams are read only by the client-folded "
                                 "engine with ota_bits_mode='supplied'")
            x = torch.as_tensor(xb, dtype=torch.float32).to(dev)
            y = torch.as_tensor(yb).to(device=dev, dtype=torch.int64)
            partc = fp = None
            if fl.faults:       # the static gate; the rates are tensors
                fp = self.faults if faults is None else faults
                partc = ota.draw_participation(key, fp, fl.n_clusters,
                                               fl.n_clients, dev)
            with span("sim.client_update"):
                heads, head_opt, g, F = self._client_update(
                    state.omega, state.heads, state.head_opt, x, y,
                    omega_stale=state.omega_stale,
                    stale=None if partc is None else partc.stale)
            if partc is not None:
                # a client that sat the round out keeps its head and Adam
                # state (its per-slot step counter included)
                keep = partc.part > 0.5

                def slot(new, old):
                    return torch.where(
                        keep.reshape(keep.shape + (1,) * (new.dim() - 2)),
                        new, old)
                heads = tree_map(slot, heads, state.heads)
                head_opt = state_map(slot, head_opt, state.head_opt)

            # reserved fold (DESIGN.md §4)
            chan_key = ota.sim_channel_key(key)
            packer = self.packer(state.omega)
            if self.draws_streams_at_once and streams is None:
                if ota_bits_mode == "supplied":
                    raise ValueError("ota_bits_mode='supplied' needs the "
                                     "round's streams "
                                     "(HotaSim.round_streams)")
                streams = ota.section_streams(chan_key, packer, fl.n_clusters,
                                              dev)

            # --- Alg. 2: FGN_Server per cluster ---------------------------
            # f0 latches each slot's first observed loss (the F̃ baseline); a
            # negative f0 marks a never-seen slot
            with span("sim.fgn"):
                f0 = torch.where((state.step == 0) | (state.f0 < 0.0), F,
                                 state.f0)
                ratios = F / torch.clamp(f0, min=1e-12)
                if packer is None:      # the per-leaf oracle's draw for ω̃
                    final_masks = ota.final_layer_masks(
                        chan_key, state.omega["final"], chan)
                else:                   # the tail section of the round's draw
                    final_masks = ota.final_layer_masks_packed(
                        chan_key, chan, packer,
                        gain=None if streams is None else streams.gain)
                norms = self._masked_final_norms(g["final"],
                                                 final_masks)   # (C, N)
                # a dead cluster's IS heard nothing: its (p, FGN) state freezes
                gate = (chan.fgn_on if partc is None
                        else chan.fgn_on * partc.live)
                p_new, fgn_state, fval = fgn_update_gated(
                    state.p, norms, ratios, state.fgn, fl, gate)

            # --- eqs. (3), (8)-(10): OTA aggregation, then the PS update ---
            # under faults the transmit weights fold participation and the
            # FedBuff 1/√(1+age) discount of stragglers; live/N_eff
            # generalize eq. 10
            w_tx, live, n_eff = p_new, None, None
            if partc is not None:
                disc = torch.where(partc.stale > 0.5,
                                   torch.rsqrt(1.0 + state.stale_age),
                                   torch.ones_like(partc.stale))
                w_tx = p_new * partc.part * disc
                live, n_eff = partc.live, partc.n_eff
            with span("sim.aggregate"):
                ghat = self.aggregate(chan_key, g, w_tx, chan, packer,
                                      ota_bits_mode, streams, live=live,
                                      n_eff=n_eff)
            with span("sim.adam"):
                if packer is None:
                    omega, ps_opt = adam_update(ghat, state.ps_opt,
                                                state.omega, tcfg.lr)
                else:       # the slab view: moments stay one flat slab
                    omega, ps_opt = slab_adam_update(ghat, state.ps_opt,
                                                     state.omega, tcfg.lr)
            metrics = {"loss": F, "p": p_new, "fgrad": fval,
                       "grad_norms": norms}
            if partc is None:
                return SimState(omega=omega, heads=heads, p=p_new,
                                ps_opt=ps_opt, head_opt=head_opt,
                                fgn=fgn_state, f0=f0,
                                step=state.step + 1), metrics

            # --- the round guard (DESIGN.md §3.14) -------------------------
            # gn2 = ‖ĝ‖² (one dot over the leaves end to end: a round on
            # the card is host-bound, so two launches, not two per leaf);
            # spike_norm = inf leaves only the non-finite check
            flat = torch.cat([l.reshape(-1).to(torch.float32)
                              for l in tree_leaves(ghat)])
            gn2 = torch.dot(flat, flat)
            skip = ((partc.total < 0.5) | ~torch.isfinite(gn2)
                    | (gn2 > fp.spike_norm * fp.spike_norm))
            # the stale copy refreshes every fp.staleness rounds (age in
            # [0, τ))
            refresh = (state.stale_age + 1.0) >= fp.staleness
            omega_stale = tree_map(
                lambda new, old: torch.where(refresh, new, old),
                omega, state.omega_stale)
            stale_age = torch.where(refresh, torch.zeros_like(state.stale_age),
                                    state.stale_age + 1.0)
            new_state = SimState(omega=omega, heads=heads, p=p_new,
                                 ps_opt=ps_opt, head_opt=head_opt,
                                 fgn=fgn_state, f0=f0, step=state.step,
                                 omega_stale=omega_stale,
                                 stale_age=stale_age)
            # a skipped round is the bit-exact identity: every leaf keeps its
            # old value, only the step counter advances
            new_state = state_map(lambda new, old: torch.where(skip, old, new),
                                  new_state, state)
            new_state = new_state._replace(step=state.step + 1)
            metrics.update(skipped=skip.to(torch.float32),
                           n_participants=partc.total)
            return new_state, metrics
