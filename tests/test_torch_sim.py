"""One HotaSim round of the port against the JAX package's, at narrow width.

The JAX package's ``PAPER_MLP_DIMS`` is monkeypatched to narrow dims for
this module only, and the port is given the same dims. Both simulators
start from the same state (the JAX one's, carried across by
``repro_torch.convert``) and see the same batches and round keys; the JAX
side runs as its suite runs on the CPU (the jnp references of its
kernels), the port with the plain versions of its kernels.

Tolerances: loss, p, F_grad and the masked norms to rtol 1e-5 (float32
matmul and reduction order differ between XLA and PyTorch); parameters
after the Adam updates to rtol 1e-4, atol 1e-6 (a first Adam step divides
by |g|, which amplifies the last-bit differences of small gradients); a
3-round loss trajectory to rtol 1e-4.
"""
import jax
import numpy as np
import pytest
import torch

import repro.models.model as jmodel
from repro.common.config import (
    FLConfig as JFLConfig, ModelConfig as JModelConfig,
    TrainConfig as JTrainConfig,
)
from repro.core.fedgradnorm import FGNState as JFGNState
from repro.core.fedgradnorm import fgn_update_gated as jfgn_update_gated
from repro.core.sim import HotaSim as JHotaSim
from repro.data import federated as jfed
from repro.data import radcom as jradcom
from repro.optim.adam import SlabAdamState as JSlabAdamState
from repro.optim.adam import slab_adam_update as jslab_adam_update
from repro_torch import rng
from repro_torch.common.config import FLConfig, ModelConfig, TrainConfig
from repro_torch.common.tree import tree_leaves
from repro_torch.convert import sim_state_from_numpy
from repro_torch.core.fedgradnorm import FGNState, fgn_update_gated
from repro_torch.core.paper_setup import paper_mlp_setup
from repro_torch.core.sim import HotaSim
from repro_torch.models.model import build_model
from repro_torch.optim.adam import SlabAdamState, slab_adam_update

DIMS = (32, 64, 128, 64, 32, 16)
C, N, B = 3, 2, 8
SIGMA2 = (1.0, 0.5, 2.0)
N_CLS = [jradcom.N_CLASSES[jradcom.TASKS[i]] for i in range(N)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at
    once, and torch's default of one thread per core oversubscribes them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np_leaves(tree):
    return [np.asarray(l) for l in jax.tree.leaves(tree)]


def _close(got_tree, want_tree, rtol, atol):
    got = [t.numpy() for t in tree_leaves(got_tree)]
    want = _np_leaves(want_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def pair():
    """(JAX sim, JAX state, port sim, port state, batcher) at narrow dims,
    with the port's threefry mode set to the live JAX mode."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jmodel, "PAPER_MLP_DIMS", DIMS)
    prev = rng.set_threefry_partitionable(jax.config.jax_threefry_partitionable)
    try:
        jsim = JHotaSim(jmodel.Model(JModelConfig(family="mlp")),
                        JFLConfig(n_clusters=C, n_clients=N, sigma2=SIGMA2),
                        JTrainConfig(lr=3e-4), N_CLS)
        jstate = jsim.init(jax.random.PRNGKey(0))
        sim = HotaSim(build_model(ModelConfig(family="mlp"), DIMS),
                      FLConfig(n_clusters=C, n_clients=N, sigma2=SIGMA2),
                      TrainConfig(lr=3e-4), N_CLS, device="cpu")
        state = sim_state_from_numpy(jax.tree.map(np.asarray, jstate))
        data = jradcom.make_radcom_dataset(
            jradcom.RadComConfig(n_points=600, feature_dim=DIMS[0]))
        batcher = jfed.FederatedBatcher(
            jradcom.client_partition(data, C, N, seed=0), B, seed=1)
        yield jsim, jstate, sim, state, batcher
    finally:
        rng.set_threefry_partitionable(prev)
        mp.undo()


def test_convert_carries_every_field(pair):
    jsim, jstate, sim, state, _ = pair
    _close(state.omega, jstate.omega, 0, 0)
    _close(state.heads, jstate.heads, 0, 0)
    assert state.ps_opt.mu.shape == jstate.ps_opt.mu.shape
    assert state.head_opt.step.shape == (C, N)
    assert state.fgn.step.shape == (C,) and state.step.dtype == torch.int32


@pytest.mark.parametrize("taus", [(1, 1), (2, 3)], ids=["tau1", "tau2_3"])
def test_client_update_matches(pair, taus):
    """Forward pass, τ_h head Adam steps and τ_ω local SGD steps with the
    averaged per-client ω gradients and losses."""
    jsim, jstate, sim, state, batcher = pair
    if taus != (1, 1):
        kw = dict(n_clusters=C, n_clients=N, sigma2=SIGMA2, tau_h=taus[0],
                  tau_w=taus[1])
        jsim = JHotaSim(jmodel.Model(JModelConfig(family="mlp")),
                        JFLConfig(**kw), JTrainConfig(lr=3e-4), N_CLS)
        sim = HotaSim(build_model(ModelConfig(family="mlp"), DIMS),
                      FLConfig(**kw), TrainConfig(lr=3e-4), N_CLS,
                      device="cpu")
    xb, yb = batcher.next_stacked()
    upd = jax.vmap(jax.vmap(jsim._client_update,
                            in_axes=(None, 0, 0, 0, 0, 0)),
                   in_axes=(None, 0, 0, 0, 0, None))
    jh, jho, jg, jF = jax.jit(upd)(jstate.omega, jstate.heads,
                                   jstate.head_opt, xb, yb, jsim.n_classes)
    h, ho, g, F = sim._client_update(state.omega, state.heads,
                                     state.head_opt, torch.from_numpy(xb),
                                     torch.from_numpy(yb).long())
    np.testing.assert_allclose(F.numpy(), np.asarray(jF), rtol=1e-5)
    _close(g, jg, 1e-4, 1e-7)
    _close(h, jh, 1e-4, 1e-6)
    _close(ho.mu, jho.mu, 1e-4, 1e-7)
    assert np.array_equal(ho.step.numpy(), np.asarray(jho.step))


@pytest.mark.parametrize("fgn_on", [1.0, 0.0])
def test_fgn_update_gated_matches(fgn_on):
    r = np.random.default_rng(2)
    p = r.uniform(0.5, 1.5, (C, N)).astype(np.float32)
    norms = r.uniform(0.1, 2.0, (C, N)).astype(np.float32)
    ratios = r.uniform(0.5, 1.5, (C, N)).astype(np.float32)
    mu = r.normal(size=(C, N)).astype(np.float32) * 0.1
    nu = r.uniform(0.0, 0.1, (C, N)).astype(np.float32)
    step = np.full((C,), 3, np.int32)
    fl = JFLConfig(n_clusters=C, n_clients=N)
    jp, jst, jf = jax.vmap(lambda a, b, c, s: jfgn_update_gated(
        a, b, c, s, fl, fgn_on))(p, norms, ratios, JFGNState(step, mu, nu))
    t = torch.from_numpy
    tp, tst, tf = fgn_update_gated(
        t(p), t(norms), t(ratios), FGNState(t(step), t(mu), t(nu)),
        FLConfig(n_clusters=C, n_clients=N), torch.tensor(fgn_on))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-5)
    for a, b in zip(tst, jst):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)


def test_slab_adam_update_matches():
    r = np.random.default_rng(3)
    shapes = {"final": {"b": (4,), "w": (3, 4)}, "trunk": {"w": (5, 3)}}
    params = jax.tree.map(lambda s: r.normal(size=s).astype(np.float32),
                          shapes, is_leaf=lambda s: isinstance(s, tuple))
    grads = jax.tree.map(lambda s: r.normal(size=s).astype(np.float32),
                         shapes, is_leaf=lambda s: isinstance(s, tuple))
    mu = r.normal(size=31).astype(np.float32) * 0.1
    nu = r.uniform(0, 0.1, 31).astype(np.float32)
    jnew, jst = jslab_adam_update(grads, JSlabAdamState(np.int32(2), mu, nu),
                                  params, 3e-4)
    t = lambda tree: jax.tree.map(torch.from_numpy, tree)
    new, st = slab_adam_update(
        t(grads), SlabAdamState(torch.tensor(2, dtype=torch.int32),
                                torch.from_numpy(mu), torch.from_numpy(nu)),
        t(params), 3e-4)
    _close(new, jnew, 1e-6, 1e-7)
    np.testing.assert_allclose(st.mu.numpy(), np.asarray(jst.mu), rtol=1e-6)
    np.testing.assert_allclose(st.nu.numpy(), np.asarray(jst.nu), rtol=1e-6)
    assert int(st.step) == 3


def test_one_step_matches(pair):
    jsim, jstate, sim, state, batcher = pair
    xb, yb = batcher.next_stacked()
    key = jax.random.PRNGKey(7)
    jnew, jm = jsim.step(jstate, xb, yb, key)
    new, m = sim.step(state, xb, yb, np.asarray(key))
    for name in ("loss", "p", "fgrad", "grad_norms"):
        np.testing.assert_allclose(m[name].numpy(), np.asarray(jm[name]),
                                   rtol=1e-5, err_msg=name)
    _close(new.omega, jnew.omega, 1e-4, 1e-6)
    _close(new.heads, jnew.heads, 1e-4, 1e-6)
    np.testing.assert_allclose(new.ps_opt.mu.numpy(),
                               np.asarray(jnew.ps_opt.mu), rtol=1e-4,
                               atol=1e-8)
    np.testing.assert_allclose(new.f0.numpy(), np.asarray(jnew.f0), rtol=1e-5)
    assert int(new.step) == int(jnew.step) == 1


def test_three_round_trajectory(pair):
    jsim, jstate, sim, state, batcher = pair
    base = jax.random.PRNGKey(5)
    for r in range(3):
        xb, yb = batcher.next_stacked()
        key = jax.random.fold_in(base, r)
        jstate, jm = jsim.step(jstate, xb, yb, key)
        state, m = sim.step(state, xb, yb, np.asarray(key))
        np.testing.assert_allclose(m["loss"].numpy(), np.asarray(jm["loss"]),
                                   rtol=1e-4, err_msg=f"round {r}")
        np.testing.assert_allclose(m["p"].numpy(), np.asarray(jm["p"]),
                                   rtol=1e-4, err_msg=f"round {r}")


def test_port_init_runs_a_round():
    sim = HotaSim(build_model(ModelConfig(family="mlp"), DIMS),
                  FLConfig(n_clusters=C, n_clients=N), TrainConfig(), N_CLS,
                  device="cpu")
    state = sim.init(rng.PRNGKey(0))
    assert state.heads["w"].shape == (C, N, DIMS[-1], max(N_CLS))
    assert torch.equal(sim.init(rng.PRNGKey(0)).omega["trunk"]["fc1"]["w"],
                       state.omega["trunk"]["fc1"]["w"])
    r = np.random.default_rng(0)
    xb = r.normal(size=(C, N, B, DIMS[0])).astype(np.float32)
    yb = r.integers(0, 6, size=(C, N, B)).astype(np.int32)
    new, m = sim.step(state, xb, yb, rng.PRNGKey(3))
    assert torch.isfinite(m["loss"]).all() and m["loss"].shape == (C, N)
    assert torch.allclose(m["p"].sum(-1), torch.full((C,), float(N)))
    assert all(torch.isfinite(l).all() for l in tree_leaves(new.omega))


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fl = FLConfig(n_clusters=C, n_clients=N)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HotaSim(build_model(ModelConfig(family="mlp"), DIMS), fl,
                TrainConfig(), N_CLS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        paper_mlp_setup(fl, n_points=100)


@pytest.mark.parametrize("gate", [
    dict(faults=True, ota_sectioned=True, use_pallas_ota=False),
    dict(faults=True, max_section_rows=64, use_pallas_ota=False)])
def test_unported_gates_refuse(gate):
    """Faults are ported (``tests/test_torch_faults.py``); what the sim
    still refuses, faults on or off, are the reference's own gates that
    the per-leaf oracle cannot honour."""
    with pytest.raises(ValueError, match="requires the slab engine"):
        HotaSim(build_model(ModelConfig(family="mlp"), DIMS),
                FLConfig(n_clusters=C, n_clients=N, **gate), TrainConfig(),
                N_CLS, device="cpu")
