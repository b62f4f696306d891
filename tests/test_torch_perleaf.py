"""The port's per-leaf oracle against the JAX package: ``rng.uniform`` and
``rng.normal``, ``ota_aggregate_tree`` and ``final_layer_masks``, and the
``HotaSim(use_pallas_ota=False)`` round.

Tolerances:
- ``rng.uniform`` is bit-identical to ``jax.random.uniform``.
- ``rng.normal`` is √2·erfinv(u) on that uniform; ``torch.special.erfinv``
  and XLA's ``erf_inv`` differ in the last places (up to 5.7e-6 relative
  in the far tails, where XLA's float32 polynomial is the less accurate
  one), so normals agree to rtol 1e-5, atol 1e-6.
- The per-leaf mask rule: gains thresholded as h² ≥ H_th may flip only
  where |h² − H_th| is within ``MASK_ULPS`` = 16 ulp of H_th (the normal's
  last-place difference, squared); ĝ is compared at entries where no
  cluster is that close, rtol 1e-5, atol 1e-6 (``noise_std`` 0.1 keeps the
  AWGN's tail error below the atol).
- The round: loss, p and F_grad rtol 1e-5; parameters after the Adam
  update rtol 1e-4, atol 1e-6, as in ``test_torch_sim.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.model as jmodel
from repro.common.config import (
    FLConfig as JFLConfig, ModelConfig as JModelConfig,
    TrainConfig as JTrainConfig,
)
from repro.core import ota as jota
from repro.core.channel import channel_params as jchannel_params
from repro.core.sim import HotaSim as JHotaSim
from repro.data import federated as jfed
from repro.data import radcom as jradcom
from repro_torch import rng
from repro_torch.common.config import FLConfig, ModelConfig, TrainConfig
from repro_torch.common.tree import state_map, tree_leaves, tree_map
from repro_torch.convert import sim_state_from_numpy
from repro_torch.core import ota
from repro_torch.core.channel import channel_params, scenario_channel
from repro_torch.core.sim import HotaSim
from repro_torch.core.sweep import ScenarioBank
from repro_torch.models.model import build_model
from repro_torch.optim.adam import AdamState, tree_to_slab

DIMS = (32, 64, 128, 64, 32, 16)
C, N, B = 3, 2, 8
SIGMA2 = (1.0, 0.5, 2.0)
H_TH = 3.2e-2
N_CLS = [jradcom.N_CLASSES[jradcom.TASKS[i]] for i in range(N)]
MASK_ULPS = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread_and_jax_mode():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    prev_mode = rng.set_threefry_partitionable(
        jax.config.jax_threefry_partitionable)
    yield
    rng.set_threefry_partitionable(prev_mode)
    torch.set_num_threads(prev)


@pytest.fixture(params=[True, False], ids=["partitionable", "original"])
def threefry_mode(request):
    prev_jax = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", request.param)
    prev = rng.set_threefry_partitionable(request.param)
    yield request.param
    rng.set_threefry_partitionable(prev)
    jax.config.update("jax_threefry_partitionable", prev_jax)


SHAPES = [(7,), (3, 5), (4, 33, 9), (2 * 1024 + 3,)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_uniform_bit_identical(threefry_mode, shape):
    key = jax.random.fold_in(jax.random.PRNGKey(3), 17)
    for lo, hi in ((0.0, 1.0), (0.5, 1.5), (-2.0, 3.0)):
        want = np.asarray(jax.random.uniform(key, shape, jnp.float32, lo, hi))
        got = rng.uniform(np.asarray(key), shape, lo, hi).numpy()
        assert got.shape == want.shape and got.dtype == np.float32
        assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_uniform_broadcasts_over_a_key_table():
    keys = rng.fold_in(rng.PRNGKey(5).unsqueeze(0), torch.arange(4))
    table = rng.uniform(keys, (3, 7))
    assert table.shape == (4, 3, 7)
    for k in range(4):
        assert torch.equal(table[k], rng.uniform(keys[k], (3, 7)))


@pytest.mark.parametrize("shape", [(50_000,), (6, 70)], ids=str)
def test_normal_within_erfinv_noise(threefry_mode, shape):
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax.random.normal(key, shape))
    got = rng.normal(np.asarray(key), shape).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    err = np.abs(got - want)
    worst = float((err / np.maximum(np.abs(want), 1e-30)).max())
    np.testing.assert_allclose(
        got, want, rtol=1e-5, atol=1e-6,
        err_msg=f"largest abs err {err.max():.3e}, relative {worst:.3e}")


def _tree(seed):
    r = np.random.default_rng(seed)

    def a(*shape):
        return r.normal(size=(C,) + shape).astype(np.float32)
    return {"final": {"w": a(40, 8), "b": a(8)},
            "trunk": {"fc0": {"w": a(30, 50), "b": a(50)}}}


def _gains_jax(key, i, shape, sigma2):
    ks = jota.leaf_key(key, i)
    return np.stack([np.asarray(jota.sample_gain(jota.cluster_key(ks, c),
                                                 shape, sigma2[c]))
                     for c in range(C)])


def test_ota_aggregate_tree_matches_jax(threefry_mode):
    """The per-leaf oracle against the reference's on the same key: every
    mask equal except within MASK_ULPS ulp of H_th, ĝ within tolerance
    wherever no cluster is that close."""
    kw = dict(n_clusters=C, n_clients=N, sigma2=SIGMA2, noise_std=0.1)
    jchan, tchan = jchannel_params(JFLConfig(**kw)), channel_params(
        FLConfig(**kw))
    tree = _tree(1)
    key = jax.random.PRNGKey(42)
    want = jota.ota_aggregate_tree(key, jax.tree.map(jnp.asarray, tree),
                                   jchan, N)
    got = ota.ota_aggregate_tree(np.asarray(key),
                                 tree_map(torch.from_numpy, tree), tchan, N)
    tol = MASK_ULPS * np.spacing(np.float32(H_TH))
    flips = 0
    for i, (g, w, leaf) in enumerate(zip(tree_leaves(got),
                                         jax.tree.leaves(want),
                                         jax.tree.leaves(tree))):
        shape = leaf.shape[1:]
        hj = _gains_jax(key, i, shape, SIGMA2)
        ht = ota._cluster_gains(ota.leaf_key(np.asarray(key), i), shape,
                                tchan, "cpu").numpy()
        np.testing.assert_allclose(ht, hj, rtol=1e-5, atol=1e-6)
        near = np.abs(hj * hj - np.float32(H_TH)) <= tol
        flip = (hj * hj >= np.float32(H_TH)) != (ht * ht >= np.float32(H_TH))
        assert not (flip & ~near).any()
        flips += int(flip.sum())
        ok = ~near.any(axis=0)
        np.testing.assert_allclose(g.numpy()[ok], np.asarray(w)[ok],
                                   rtol=1e-5, atol=1e-6)
    assert flips <= 2


def test_final_layer_masks_match_the_aggregation_draw():
    """The eq.-5 masks of the per-leaf oracle are the masks its
    aggregation applies to ω̃ (the same per-leaf keys)."""
    tchan = channel_params(FLConfig(n_clusters=C, n_clients=N,
                                    sigma2=SIGMA2))
    tree = tree_map(torch.from_numpy, _tree(2))
    key = rng.PRNGKey(7)
    masks = ota.final_layer_masks(key, tree_map(lambda l: l[0],
                                                tree["final"]), tchan)
    for i, (m, leaf) in enumerate(zip(tree_leaves(masks),
                                      tree_leaves(tree["final"]))):
        h = ota._cluster_gains(ota.leaf_key(key, i), tuple(leaf.shape[1:]),
                               tchan, "cpu")
        assert torch.equal(m, h * h >= H_TH)
        assert 0.5 < float(m.float().mean()) < 1.0


@pytest.fixture(scope="module")
def perleaf_pair():
    """(JAX sim, JAX state, port sim, port state, batcher) on the per-leaf
    oracle at narrow dims."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jmodel, "PAPER_MLP_DIMS", DIMS)
    try:
        kw = dict(n_clusters=C, n_clients=N, sigma2=SIGMA2,
                  use_pallas_ota=False)
        jsim = JHotaSim(jmodel.Model(JModelConfig(family="mlp")),
                        JFLConfig(**kw), JTrainConfig(lr=3e-4), N_CLS)
        jstate = jsim.init(jax.random.PRNGKey(0))
        sim = HotaSim(build_model(ModelConfig(family="mlp"), DIMS),
                      FLConfig(**kw), TrainConfig(lr=3e-4), N_CLS,
                      device="cpu")
        state = sim_state_from_numpy(jax.tree.map(np.asarray, jstate))
        data = jradcom.make_radcom_dataset(
            jradcom.RadComConfig(n_points=600, feature_dim=DIMS[0]))
        batcher = jfed.FederatedBatcher(
            jradcom.client_partition(data, C, N, seed=0), B, seed=1)
        yield jsim, jstate, sim, state, batcher
    finally:
        mp.undo()


def _close(got_tree, want_tree, rtol, atol):
    got = [t.numpy() for t in tree_leaves(got_tree)]
    want = [np.asarray(l) for l in jax.tree.leaves(want_tree)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def test_perleaf_state_converts_with_tree_adam(perleaf_pair):
    _, jstate, sim, state, _ = perleaf_pair
    assert isinstance(state.ps_opt, AdamState)
    _close(state.ps_opt.mu, jstate.ps_opt.mu, 0, 0)
    fresh = sim.init(rng.PRNGKey(0))
    assert isinstance(fresh.ps_opt, AdamState)
    assert not sim.draws_streams_at_once and sim.packer(fresh.omega) is None
    with pytest.raises(ValueError, match="per-leaf"):
        sim.round_streams(rng.PRNGKey(0), fresh.omega)


def test_perleaf_step_matches_jax(perleaf_pair):
    jsim, jstate, sim, state, batcher = perleaf_pair
    xb, yb = batcher.next_stacked()
    key = jax.random.PRNGKey(7)
    jnew, jm = jsim.step(jstate, xb, yb, key)
    new, m = sim.step(state, xb, yb, np.asarray(key))
    for name in ("loss", "p", "fgrad", "grad_norms"):
        np.testing.assert_allclose(m[name].numpy(), np.asarray(jm[name]),
                                   rtol=1e-5, err_msg=name)
    _close(new.omega, jnew.omega, 1e-4, 1e-6)
    _close(new.ps_opt.mu, jnew.ps_opt.mu, 1e-4, 1e-8)
    _close(new.heads, jnew.heads, 1e-4, 1e-6)
    assert int(new.ps_opt.step) == int(jnew.ps_opt.step) == 1


def _flat(state):
    """The tensors of a state field (tensor, dict tree or named tuple)."""
    out = []
    state_map(out.append, state)
    return out


def test_sim_packed_equals_per_leaf_when_ota_off():
    """The reference's test on the port: with the channel off both engines
    compute the same weighted mean, so one step from one state matches
    leaf for leaf; the slab Adam moments equal the tree ones."""
    base = FLConfig(n_clusters=C, n_clients=N, ota=False, noise_std=3.0)
    model = build_model(ModelConfig(family="mlp"), DIMS)
    r = np.random.default_rng(1)
    x = r.normal(size=(C, N, B, DIMS[0])).astype(np.float32)
    y = r.integers(0, 4, size=(C, N, B))
    outs = []
    for packed in (True, False):
        sim = HotaSim(model, dataclasses.replace(base, use_pallas_ota=packed),
                      TrainConfig(lr=3e-4), [4, 4], device="cpu")
        outs.append(sim.step(sim.init(rng.PRNGKey(0)), x, y, rng.PRNGKey(9)))
    (st_p, m_p), (st_l, m_l) = outs
    for field in ("omega", "heads", "p", "head_opt", "fgn", "f0", "step"):
        for u, v in zip(_flat(getattr(st_p, field)),
                        _flat(getattr(st_l, field))):
            np.testing.assert_allclose(u.numpy(), v.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=field)
    for k in m_p:
        np.testing.assert_allclose(m_p[k].numpy(), m_l[k].numpy(), rtol=1e-5,
                                   atol=1e-6)
    assert int(st_p.ps_opt.step) == int(st_l.ps_opt.step) == 1
    for slab, tree in ((st_p.ps_opt.mu, st_l.ps_opt.mu),
                       (st_p.ps_opt.nu, st_l.ps_opt.nu)):
        np.testing.assert_allclose(slab.numpy(), tree_to_slab(tree).numpy(),
                                   rtol=1e-6, atol=1e-7)


def test_scenario_bank_runs_the_per_leaf_engine():
    """A bank over the per-leaf engine draws inside each scenario's step
    (no hoisted streams) and equals the scenarios run one by one."""
    sim = HotaSim(build_model(ModelConfig(family="mlp"), DIMS),
                  FLConfig(n_clusters=C, n_clients=N, use_pallas_ota=False),
                  TrainConfig(lr=3e-4), N_CLS, device="cpu")
    scen = [dict(sigma2=SIGMA2), dict(weighting="equal")]
    bank = ScenarioBank(sim, scen)
    r = np.random.default_rng(2)
    x = r.normal(size=(C, N, B, DIMS[0])).astype(np.float32)
    y = r.integers(0, 2, size=(C, N, B))
    states, m = bank.step(bank.init(rng.PRNGKey(0)), x, y, rng.PRNGKey(4))
    assert m["loss"].shape == (2, C, N)
    one, _ = sim.step_with_channel(sim.init(rng.PRNGKey(0)), x, y, rng.PRNGKey(4),
                                   scenario_channel(bank.chan_bank, 1))
    for a, b in zip(tree_leaves(one.omega),
                    tree_leaves(bank.scenario_state(states, 1).omega)):
        assert torch.equal(a, b)
