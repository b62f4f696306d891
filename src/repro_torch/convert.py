"""Carry a JAX-package ``SimState``, a ``ScenarioBank``'s banked state,
a sampled sim's ``SampledSimState`` (its ``ClientBank``), a distributed
``HotaState`` or an LM's parameters across into the port.

The caller turns the reference state into numpy first
(``jax.tree.map(np.asarray, state)``); this module reads only those
numpy leaves, in the reference's field order, and never imports JAX::

    SimState(omega, heads, p, ps_opt, head_opt, fgn, f0, step, ...)
    ps_opt   = SlabAdamState(step, mu, nu)     (moments flat, (L,)), or on
               the per-leaf oracle AdamState(step, mu, nu) (moment trees)
    head_opt = AdamState(step, mu, nu)         (step (C, N), moments trees)
    fgn      = FGNState(step, mu, nu)          (step (C,), moments (C, N))
    omega_stale, stale_age                     (fault injection only, or None)

A distributed ``HotaState`` (``hota_state_from_numpy``) is global; each
rank takes its piece, and ``hota_state_to_numpy`` gathers the ranks'
pieces back into the reference's global numpy state (a checkpoint of
the port's launcher restores in the reference). A bank's state is the same structure with a
leading (S,) axis on every leaf; a ``DistScenarioBank``'s global state
(``dist_bank_state_from_numpy``/``_to_numpy``) is the distributed one
with that axis, which each rank holds as (S/n_rows, ...) stacks of its
shards.

An LM's parameters (``init_params`` of the reference's ``trunk_specs``,
``final_specs`` or ``head_specs``) are nested dicts with stacked layer
dims (``layers``, or gemma3's ``local`` (n_super, r, ...) and ``global``
(n_super, ...)); an MoE layer's ``mlp`` holds ``norm`` (d,), ``router``
(d, E) and the stacked experts ``w_gate``/``w_up`` (E, d, d_ff) and
``w_down`` (E, d_ff, d), each behind the layer dim. The port's models
read the same trees (the hybrid's ``mamba`` stack and shared blocks,
xLSTM's (n_super, per_super, ...) ``mlstm`` and (n_super, ...) ``slstm``
stacks too), so ``lm_params_from_numpy`` only turns each leaf into a
tensor; ``lm_cache_from_numpy`` does the same for a cache, keeping each
leaf's dtype.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.tree import state_map
from repro_torch.core.fedgradnorm import FGNState
from repro_torch.core.hota_step import HotaState, gather_state, shard_state
from repro_torch.core.sampling import ClientBank, SampledSimState
from repro_torch.core.sim import SimState
from repro_torch.optim.adam import AdamState, SlabAdamState
from repro_torch.sharding.mesh_utils import scenario_banked_tree


def _tensor(x, device, dtype=None):
    t = torch.from_numpy(np.array(x, copy=True))
    return t.to(device=device, dtype=dtype) if dtype else t.to(device)


def _tree(tree, device):
    if isinstance(tree, dict):
        return {k: _tree(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


def lm_params_from_numpy(params, device="cpu"):
    """The port's copy of a reference LM parameter tree (numpy leaves),
    dense or MoE: the same nesting and stacked shapes, each leaf a
    float32 tensor."""
    if isinstance(params, dict):
        return {k: lm_params_from_numpy(v, device) for k, v in params.items()}
    return _tensor(np.asarray(params, np.float32), device, torch.float32)


def lm_cache_from_numpy(cache, device="cpu"):
    """The port's copy of a reference LM cache (numpy leaves, from a
    prefill or ``init_cache``): the same nesting, dicts and lists alike
    (the hybrid's per-application KV list), each leaf a tensor of the
    leaf's dtype. A bfloat16 leaf (``ml_dtypes``, which numpy cannot
    hand to torch) crosses through float32, exactly."""
    if isinstance(cache, dict):
        return {k: lm_cache_from_numpy(v, device) for k, v in cache.items()}
    if isinstance(cache, list):
        return [lm_cache_from_numpy(v, device) for v in cache]
    arr = np.asarray(cache)
    if arr.dtype.name == "bfloat16":
        return _tensor(arr.astype(np.float32), device, torch.bfloat16)
    return _tensor(arr, device)


def _stale_fields(fields, n: int, device):
    """The fault-injection fields after the first ``n``: (omega_stale,
    stale_age) as tensors, or (None, None)."""
    extra = tuple(fields[n:]) + (None, None)
    if len(fields) > n + 2 or (extra[0] is None) != (extra[1] is None):
        raise ValueError(f"expected {n} fields, then omega_stale and "
                         f"stale_age (both set or both None)")
    if extra[0] is None:
        return None, None
    return (_tree(extra[0], device),
            _tensor(extra[1], device, torch.float32))


def sim_state_from_numpy(state, device="cpu") -> SimState:
    """A port ``SimState`` holding the same ω, heads, optimizer and
    FedGradNorm state, loss weights, f0, step and (under faults) stale
    copy and its age as the reference's."""
    fields = tuple(state)
    if len(fields) < 8:
        raise ValueError("expected a reference SimState (omega, heads, p, "
                         "ps_opt, head_opt, fgn, f0, step, ...)")
    omega, heads, p, ps_opt, head_opt, fgn, f0, step = fields[:8]
    omega_stale, stale_age = _stale_fields(fields, 8, device)
    i32 = torch.int32
    if isinstance(ps_opt[1], dict):     # the per-leaf oracle's tree Adam
        ps = AdamState(step=_tensor(ps_opt[0], device, i32),
                       mu=_tree(ps_opt[1], device),
                       nu=_tree(ps_opt[2], device))
    else:
        ps = SlabAdamState(step=_tensor(ps_opt[0], device, i32),
                           mu=_tensor(ps_opt[1], device, torch.float32),
                           nu=_tensor(ps_opt[2], device, torch.float32))
    return SimState(
        omega=_tree(omega, device),
        heads=_tree(heads, device),
        p=_tensor(p, device, torch.float32),
        ps_opt=ps,
        head_opt=AdamState(step=_tensor(head_opt[0], device, i32),
                           mu=_tree(head_opt[1], device),
                           nu=_tree(head_opt[2], device)),
        fgn=FGNState(step=_tensor(fgn[0], device, i32),
                     mu=_tensor(fgn[1], device, torch.float32),
                     nu=_tensor(fgn[2], device, torch.float32)),
        f0=_tensor(f0, device, torch.float32),
        step=_tensor(step, device, i32),
        omega_stale=omega_stale, stale_age=stale_age)


def bank_state_from_numpy(states, device="cpu") -> SimState:
    """A port ``ScenarioBank`` state from a reference bank's (S,)-leading
    state turned into numpy; raises unless every leaf carries the same
    leading scenario axis."""
    out = sim_state_from_numpy(states, device=device)
    sizes = set()
    state_map(lambda t: sizes.add(tuple(t.shape[:1])), out)
    if len(sizes) != 1 or () in sizes:
        raise ValueError(f"expected one leading scenario axis on every "
                         f"leaf, found leading shapes {sorted(sizes)}")
    return out


def client_bank_from_numpy(bank, device="cpu") -> ClientBank:
    """A port ``ClientBank`` from a reference one turned into numpy:
    ``(heads, head_opt, f0)`` with ``head_opt = AdamState(step, mu, nu)``
    (any leading axes: (C, N, M), or (S, C, N, M) in a bank's state)."""
    heads, head_opt, f0 = tuple(bank)
    return ClientBank(
        heads=_tree(heads, device),
        head_opt=AdamState(step=_tensor(head_opt[0], device, torch.int32),
                           mu=_tree(head_opt[1], device),
                           nu=_tree(head_opt[2], device)),
        f0=_tensor(f0, device, torch.float32))


def sampled_state_from_numpy(state, device="cpu") -> SampledSimState:
    """A port ``SampledSimState`` from a reference one (or a reference
    ``ScenarioBank``'s over a ``SampledHotaSim``) turned into numpy:
    the inner ``SimState`` and the ``ClientBank``."""
    sim, bank = tuple(state)
    return SampledSimState(sim=sim_state_from_numpy(sim, device=device),
                           bank=client_bank_from_numpy(bank, device=device))


def hota_state_from_numpy(state, mesh, rank: int, device, specs):
    """Rank ``rank``'s piece of a reference distributed ``HotaState``
    (turned into numpy), laid out by ``specs``, the port step's
    ``state_specs``: FSDP leaves cut on their "embed" dim over
    ("client", "cluster"), each client's head, ``p``, ``fgn_mu``,
    ``fgn_nu`` and ``f0`` its own (a leading dim of 1), and the slab Adam
    moments the rank's local slab (the reference's global moment is the
    shard-major concatenation of the local slabs), and under faults the
    stale copy cut like ω. On the per-leaf oracle the optimizer is the
    tree Adam, its moments cut like ω."""
    fields = tuple(state)
    if len(fields) < 10:
        raise ValueError("expected a reference HotaState (omega, opt, "
                         "heads, head_opt, p, fgn_mu, fgn_nu, fgn_t, f0, "
                         "step, ...)")
    omega, opt, heads, head_opt, p, mu, nu, fgn_t, f0, step = fields[:10]
    omega_stale, stale_age = _stale_fields(fields, 10, "cpu")
    i32, f32 = torch.int32, torch.float32
    if isinstance(opt[1], dict):    # the per-leaf oracle's tree Adam
        opt = AdamState(step=_tensor(opt[0], "cpu", i32),
                        mu=_tree(opt[1], "cpu"), nu=_tree(opt[2], "cpu"))
    else:
        opt = SlabAdamState(step=_tensor(opt[0], "cpu", i32),
                            mu=_tensor(opt[1], "cpu", f32),
                            nu=_tensor(opt[2], "cpu", f32))
    glob = HotaState(
        omega=_tree(omega, "cpu"),
        opt=opt,
        heads=_tree(heads, "cpu"),
        head_opt=AdamState(step=_tensor(head_opt[0], "cpu", i32),
                           mu=_tree(head_opt[1], "cpu"),
                           nu=_tree(head_opt[2], "cpu")),
        p=_tensor(p, "cpu", f32), fgn_mu=_tensor(mu, "cpu", f32),
        fgn_nu=_tensor(nu, "cpu", f32), fgn_t=_tensor(fgn_t, "cpu", i32),
        f0=_tensor(f0, "cpu", f32), step=_tensor(step, "cpu", i32),
        omega_stale=omega_stale, stale_age=stale_age)
    return shard_state(glob, specs, mesh, rank=rank, device=device)


def hota_state_to_numpy(state, specs, mesh):
    """The global state of which ``state`` is this rank's piece (``specs``
    the step's ``state_specs``), its leaves numpy arrays in the
    reference's layout: FSDP leaves whole, every client's head, ``p``,
    ``fgn_mu``, ``fgn_nu`` and ``f0`` stacked over the clients, the slab
    Adam moments the shard-major concatenation of the local slabs. Every
    rank of the mesh must call it (all-gathers); ``state`` may be any
    sub-tree of a ``HotaState`` with the matching sub-tree of specs (ω
    alone, for the launcher's final checkpoint)."""
    return state_map(lambda t: t.detach().cpu().numpy(),
                     gather_state(state, specs, mesh))


def dist_bank_state_from_numpy(states, mesh, rank: int, device, specs):
    """Rank ``rank``'s stacks of a reference ``DistScenarioBank`` state
    (the (S,)-banked global ``HotaState``, turned into numpy): the rows of
    its scenario row, each cut as ``hota_state_from_numpy`` cuts a
    distributed state (``specs`` the step's ``state_specs``, unbanked)."""
    return hota_state_from_numpy(states, mesh, rank, device,
                                 scenario_banked_tree(specs))


def dist_bank_state_to_numpy(states, specs, mesh):
    """The reference's (S,)-banked global ``HotaState`` of which
    ``states`` is this rank's stacks (``specs`` unbanked, as above), its
    leaves numpy arrays. Every rank of the mesh must call it
    (all-gathers over "scenario" and the FL axes)."""
    return hota_state_to_numpy(states, scenario_banked_tree(specs), mesh)
