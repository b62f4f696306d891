"""Carry a JAX-package ``SimState``, a ``ScenarioBank``'s banked state,
a distributed ``HotaState`` or an LM's parameters across into the port.

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
rank takes its piece. A bank's state is the same structure with a
leading (S,) axis on every leaf.

An LM's parameters (``init_params`` of the reference's ``trunk_specs``,
``final_specs`` or ``head_specs``) are nested dicts with stacked layer
dims (``layers``, or gemma3's ``local`` (n_super, r, ...) and ``global``
(n_super, ...)); the port's dense model reads the same trees, so
``lm_params_from_numpy`` only turns each leaf into a tensor.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.tree import state_map
from repro_torch.core.fedgradnorm import FGNState
from repro_torch.core.hota_step import HotaState, shard_state
from repro_torch.core.sim import SimState
from repro_torch.optim.adam import AdamState, SlabAdamState


def _tensor(x, device, dtype=None):
    t = torch.from_numpy(np.array(x, copy=True))
    return t.to(device=device, dtype=dtype) if dtype else t.to(device)


def _tree(tree, device):
    if isinstance(tree, dict):
        return {k: _tree(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


def lm_params_from_numpy(params, device="cpu"):
    """The port's copy of a reference LM parameter tree (numpy leaves):
    the same nesting and stacked shapes, each leaf a float32 tensor."""
    if isinstance(params, dict):
        return {k: lm_params_from_numpy(v, device) for k, v in params.items()}
    return _tensor(np.asarray(params, np.float32), device, torch.float32)


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


def hota_state_from_numpy(state, mesh, rank: int, device, specs):
    """Rank ``rank``'s piece of a reference distributed ``HotaState``
    (turned into numpy), laid out by ``specs``, the port step's
    ``state_specs``: FSDP leaves cut on their "embed" dim over
    ("client", "cluster"), each client's head, ``p``, ``fgn_mu``,
    ``fgn_nu`` and ``f0`` its own (a leading dim of 1), and the slab Adam
    moments the rank's local slab (the reference's global moment is the
    shard-major concatenation of the local slabs), and under faults the
    stale copy cut like ω."""
    fields = tuple(state)
    if len(fields) < 10:
        raise ValueError("expected a reference HotaState (omega, opt, "
                         "heads, head_opt, p, fgn_mu, fgn_nu, fgn_t, f0, "
                         "step, ...)")
    omega, opt, heads, head_opt, p, mu, nu, fgn_t, f0, step = fields[:10]
    omega_stale, stale_age = _stale_fields(fields, 10, "cpu")
    i32, f32 = torch.int32, torch.float32
    glob = HotaState(
        omega=_tree(omega, "cpu"),
        opt=SlabAdamState(step=_tensor(opt[0], "cpu", i32),
                          mu=_tensor(opt[1], "cpu", f32),
                          nu=_tensor(opt[2], "cpu", f32)),
        heads=_tree(heads, "cpu"),
        head_opt=AdamState(step=_tensor(head_opt[0], "cpu", i32),
                           mu=_tree(head_opt[1], "cpu"),
                           nu=_tree(head_opt[2], "cpu")),
        p=_tensor(p, "cpu", f32), fgn_mu=_tensor(mu, "cpu", f32),
        fgn_nu=_tensor(nu, "cpu", f32), fgn_t=_tensor(fgn_t, "cpu", i32),
        f0=_tensor(f0, "cpu", f32), step=_tensor(step, "cpu", i32),
        omega_stale=omega_stale, stale_age=stale_age)
    return shard_state(glob, specs, mesh, rank=rank, device=device)
