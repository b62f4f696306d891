"""Fault injection in the port against the JAX package (DESIGN.md §3.14).

The narrow MLP of ``tests/test_torch_sim.py`` (the JAX package's
``PAPER_MLP_DIMS`` monkeypatched for this module, the port given the same
dims). The port starts from the reference's initial state (carried across
by ``repro_torch.convert``) and sees the same numpy batches and round
keys; the JAX side runs its kernels' jnp references, the port their plain
versions (``device="cpu"``).

Tolerances: the participation flags exactly, in both threefry modes;
faulted rounds on all five engines (client-folded, streaming, sectioned,
sectioned + streaming, per-leaf oracle) over 3 rounds with mixed dropout,
blackout and straggler rates and staleness 2: every metric within rtol
1e-4, atol 1e-6 and ω within relative L2 1e-3 (``test_torch_sim.py``'s
rule: a first Adam step moves an entry with |ĝ| at float noise by ±lr);
identity rounds (blackout 1, a tiny ``spike_norm``) bit for bit; zero-rate
faults against the unfaulted round bit for bit (every select passes the
same values through); a fault bank against the reference's bank as the
rounds above.
"""
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
from repro.core.channel import fault_params as jfault_params
from repro.core.fedgradnorm import FGNState as JFGNState
from repro.core.fedgradnorm import fgn_update_gated as jfgn_update_gated
from repro.core.sim import HotaSim as JHotaSim
from repro.core.sweep import ScenarioBank as JScenarioBank
from repro_torch import rng
from repro_torch.common.config import FLConfig, ModelConfig, TrainConfig
from repro_torch.common.tree import state_map, tree_leaves
from repro_torch.convert import bank_state_from_numpy, sim_state_from_numpy
from repro_torch.core import ota
from repro_torch.core.channel import FaultParams, fault_params
from repro_torch.core.fedgradnorm import FGNState, fgn_update_gated
from repro_torch.core.sim import HotaSim
from repro_torch.core.sweep import ScenarioBank
from repro_torch.models.model import build_model

DIMS = (32, 64, 128, 64, 32, 16)
C, N, B = 3, 2, 8
N_CLS = [6, 6]
ROUNDS = 3
FAULTS = dict(n_clusters=C, n_clients=N, sigma2=(1.0, 0.5, 2.0),
              faults=True, dropout_rate=0.3, blackout_rate=0.2,
              straggler_rate=0.4, staleness_rounds=2)
ENGINES = {"client_folded": {}, "streaming": dict(ota_streaming=True),
           "sectioned": dict(ota_sectioned=True),
           "sectioned_streaming": dict(ota_sectioned=True,
                                       ota_streaming=True),
           "per_leaf": dict(use_pallas_ota=False)}


@pytest.fixture(autouse=True, scope="module")
def _narrow_and_one_thread():
    """Narrow reference dims, one intra-op thread (the suite runs several
    workers at once), and the port's threefry mode set to JAX's."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jmodel, "PAPER_MLP_DIMS", DIMS)
    prev_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    prev = rng.set_threefry_partitionable(
        jax.config.jax_threefry_partitionable)
    yield
    rng.set_threefry_partitionable(prev)
    torch.set_num_threads(prev_threads)
    mp.undo()


def _sims(fl_kw):
    jsim = JHotaSim(jmodel.Model(JModelConfig(family="mlp")),
                    JFLConfig(**fl_kw), JTrainConfig(lr=3e-4), N_CLS)
    sim = HotaSim(build_model(ModelConfig(family="mlp"), DIMS),
                  FLConfig(**fl_kw), TrainConfig(lr=3e-4), N_CLS,
                  device="cpu")
    return jsim, sim


def _batches(rounds=ROUNDS, seed=0):
    r = np.random.default_rng(seed)
    return [(r.normal(size=(C, N, B, DIMS[0])).astype(np.float32),
             r.integers(0, N_CLS[0], (C, N, B)).astype(np.int32))
            for _ in range(rounds)]


def _keys(rounds=ROUNDS):
    return [jax.random.PRNGKey(10 + r) for r in range(rounds)]


def _rel_l2(got_tree, want_tree) -> float:
    a = np.concatenate([t.numpy().ravel() for t in tree_leaves(got_tree)])
    b = np.concatenate([np.asarray(t).ravel()
                        for t in jax.tree.leaves(want_tree)])
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _assert_same_state(a, b, skip_step=True):
    """Every leaf of two port states equal bit for bit (``step`` aside
    when ``skip_step``)."""
    if skip_step:
        a, b = a._replace(step=None), b._replace(step=None)
    pairs = []
    state_map(lambda x, y: pairs.append((x, y)), a, b)
    assert pairs
    for x, y in pairs:
        assert torch.equal(x, y)


# --------------------------------------------------------------------------
# the participation draw
# --------------------------------------------------------------------------

@pytest.mark.parametrize("partitionable", [True, False],
                         ids=["partitionable", "original"])
def test_draw_participation_matches_jax(partitionable):
    """``part``, ``stale``, ``live`` and the counts equal the reference's
    exactly, in both threefry layouts, over keys and rate mixes (the gate
    off included)."""
    prev_j = jax.config.jax_threefry_partitionable
    prev = rng.set_threefry_partitionable(partitionable)
    jax.config.update("jax_threefry_partitionable", partitionable)
    try:
        for i, kw in enumerate([
                dict(dropout_rate=0.3, blackout_rate=0.2,
                     straggler_rate=0.4),
                dict(dropout_rate=0.6, straggler_rate=0.7),
                dict(blackout_rate=0.5),
                dict(dropout_rate=0.5, faults=False)]):
            kw = dict(dict(n_clusters=5, n_clients=3, faults=True), **kw)
            for k in range(4):
                key = jax.random.fold_in(jax.random.PRNGKey(i), k)
                want = jota.draw_participation(key, jfault_params(
                    JFLConfig(**kw)), 5, 3)
                got = ota.draw_participation(np.asarray(key), fault_params(
                    FLConfig(**kw)), 5, 3)
                for name, g, w in zip(got._fields, got, want):
                    assert np.array_equal(g.numpy(), np.asarray(w)), \
                        (name, i, k)
    finally:
        jax.config.update("jax_threefry_partitionable", prev_j)
        rng.set_threefry_partitionable(prev)


def test_participation_uses_the_reserved_fold():
    """The draw folds off ``fold_in(key, PART_FOLD)`` only: the
    participation key is disjoint from the round's channel key."""
    key = rng.PRNGKey(3)
    assert ota.PART_FOLD == jota.PART_FOLD
    assert (ota.PART_DROP_FOLD, ota.PART_BLACK_FOLD, ota.PART_STRAG_FOLD) \
        == (jota.PART_DROP_FOLD, jota.PART_BLACK_FOLD, jota.PART_STRAG_FOLD)
    assert not torch.equal(ota.participation_key(key),
                           ota.sim_channel_key(key))


def test_fgn_gate_per_cluster_matches():
    """``fgn_update_gated`` with a (C,) gate (``fgn_on · live``): a gated
    cluster's p and state pass through."""
    r = np.random.default_rng(2)
    p = r.uniform(0.5, 1.5, (C, N)).astype(np.float32)
    norms = r.uniform(0.1, 2.0, (C, N)).astype(np.float32)
    ratios = r.uniform(0.5, 1.5, (C, N)).astype(np.float32)
    mu = r.normal(size=(C, N)).astype(np.float32) * 0.1
    nu = r.uniform(0.0, 0.1, (C, N)).astype(np.float32)
    step = np.full((C,), 3, np.int32)
    gate = np.array([1.0, 0.0, 1.0], np.float32)
    fl = JFLConfig(n_clusters=C, n_clients=N)
    jp, jst, jf = jax.vmap(lambda a, b, c, s, g: jfgn_update_gated(
        a, b, c, s, fl, g))(p, norms, ratios, JFGNState(step, mu, nu), gate)
    t = torch.from_numpy
    tp, tst, tf = fgn_update_gated(
        t(p), t(norms), t(ratios), FGNState(t(step), t(mu), t(nu)),
        FLConfig(n_clusters=C, n_clients=N), t(gate))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-5)
    for a, b in zip(tst, jst):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)
    assert np.array_equal(tp[1].numpy(), p[1]) and int(tst.step[1]) == 3


# --------------------------------------------------------------------------
# faulted rounds
# --------------------------------------------------------------------------

@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_faulted_rounds_match_jax(engine):
    fl_kw = dict(FAULTS, **ENGINES[engine])
    jsim, sim = _sims(fl_kw)
    jstate = jsim.init(jax.random.PRNGKey(0))
    state = sim_state_from_numpy(jax.tree.map(np.asarray, jstate))
    stale = dropped = 0.0
    for r, ((xb, yb), key) in enumerate(zip(_batches(), _keys())):
        jstate, jm = jsim.step(jstate, xb, yb, key)
        state, m = sim.step(state, xb, yb, np.asarray(key))
        assert set(m) == set(jm)
        for name in jm:
            np.testing.assert_allclose(m[name].numpy(), np.asarray(jm[name]),
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"{engine} round {r} {name}")
        assert _rel_l2(state.omega, jstate.omega) < 1e-3
        assert _rel_l2(state.omega_stale, jstate.omega_stale) < 1e-3
        part = ota.draw_participation(np.asarray(key), sim.faults, C, N)
        stale += float(part.stale.sum())
        dropped += C * N - float(part.total)
    np.testing.assert_allclose(state.heads["w"].numpy(),
                               np.asarray(jstate.heads["w"]), rtol=1e-4,
                               atol=1e-6)
    assert np.array_equal(state.head_opt.step.numpy(),
                          np.asarray(jstate.head_opt.step))
    assert np.array_equal(state.fgn.step.numpy(), np.asarray(jstate.fgn.step))
    assert float(state.stale_age) == float(jstate.stale_age)
    assert int(state.step) == ROUNDS
    # the rounds really mixed the faults: stragglers and dropped slots
    assert stale > 0 and dropped > 0


@pytest.mark.parametrize("case", ["blackout", "spike"])
def test_identity_rounds_are_bit_exact(case):
    """Blackout 1 (no participant) and a tiny ``spike_norm`` (the guard
    trips) each skip the round: every leaf bit for bit, ``step`` + 1,
    ``skipped`` = 1 (the reference's skip against the port's:
    ``test_fault_bank_matches_jax``'s blackout scenario)."""
    knob = (dict(blackout_rate=1.0) if case == "blackout"
            else dict(spike_norm=1e-30))
    _, sim = _sims(dict(FAULTS, **knob))
    state0 = sim.init(rng.PRNGKey(0))
    state = state0
    for (xb, yb), key in zip(_batches(2), _keys(2)):
        state, m = sim.step(state, xb, yb, np.asarray(key))
        assert float(m["skipped"]) == 1.0
        assert (float(m["n_participants"]) == 0.0) == (case == "blackout")
    _assert_same_state(state, state0)
    assert int(state.step) == 2


def test_zero_rate_faults_match_the_unfaulted_round():
    """faults=True at zero rates is the unfaulted round bit for bit: every
    participation select and the guard pass the same values through."""
    base = dict(n_clusters=C, n_clients=N, sigma2=(1.0, 0.5, 2.0))
    _, sim0 = _sims(base)
    _, sim1 = _sims(dict(base, faults=True))
    st0 = sim0.init(rng.PRNGKey(0))
    st1 = sim1.init(rng.PRNGKey(0))
    for (xb, yb), key in zip(_batches(2), _keys(2)):
        st0, m0 = sim0.step(st0, xb, yb, np.asarray(key))
        st1, m1 = sim1.step(st1, xb, yb, np.asarray(key))
        for name in m0:
            assert torch.equal(m0[name], m1[name]), name
        assert float(m1["skipped"]) == 0.0
        assert float(m1["n_participants"]) == C * N
    _assert_same_state(st1._replace(omega_stale=None, stale_age=None), st0,
                       skip_step=False)


# --------------------------------------------------------------------------
# the fault bank
# --------------------------------------------------------------------------

def test_fault_bank_matches_jax():
    """A ``ScenarioBank`` of fault scenarios (dicts and a ``FaultParams``)
    against the reference's bank over 2 rounds."""
    fl_kw = dict(n_clusters=C, n_clients=N, sigma2=(1.0, 0.5, 2.0),
                 faults=True)
    jsim, sim = _sims(fl_kw)
    black = dict(fl_kw, blackout_rate=1.0)
    jscen = [dict(dropout_rate=0.0), dict(dropout_rate=0.5),
             jfault_params(JFLConfig(**black)),
             dict(straggler_rate=0.6, staleness_rounds=2)]
    scen = jscen[:2] + [fault_params(FLConfig(**black))] + jscen[3:]
    jbank = JScenarioBank(jsim, jscen)
    bank = ScenarioBank(sim, scen)
    jst = jbank.init(jax.random.PRNGKey(0))
    st = bank_state_from_numpy(jax.tree.map(np.asarray, jst))
    for r, ((xb, yb), key) in enumerate(zip(_batches(2), _keys(2))):
        jst, jm = jbank.step(jst, xb, yb, key)
        st, m = bank.step(st, xb, yb, np.asarray(key))
        for name in jm:
            np.testing.assert_allclose(m[name].numpy(), np.asarray(jm[name]),
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"round {r} {name}")
        assert _rel_l2(st.omega, jst.omega) < 1e-3
    assert m["skipped"].tolist() == [0.0, 0.0, 1.0, 0.0]
    assert m["n_participants"][0] == C * N > m["n_participants"][1]


def test_fault_scenario_refusals():
    """The reference's two refusals: a fault knob, or a ``FaultParams``
    scenario, on a bank whose base config has ``faults=False``; a
    ``FaultParams`` scenario on a faulted bank runs the base channel."""
    _, sim = _sims(dict(n_clusters=C, n_clients=N))
    with pytest.raises(ValueError, match="faults=True"):
        ScenarioBank(sim, [dict(dropout_rate=0.5)])
    with pytest.raises(ValueError, match="faults=True"):
        ScenarioBank(sim, [fault_params(FLConfig(n_clusters=C, n_clients=N,
                                                 faults=True))])
    _, sim_f = _sims(dict(n_clusters=C, n_clients=N, faults=True))
    bank = ScenarioBank(sim_f, [fault_params(FLConfig(
        n_clusters=C, n_clients=N, faults=True, dropout_rate=0.25))])
    assert torch.equal(bank.chan_bank.sigma2[0], sim_f.chan.sigma2)
    assert float(bank.fault_bank.dropout[0]) == 0.25
    assert isinstance(bank.fault_bank, FaultParams)


# --------------------------------------------------------------------------
# the channel-inversion helpers (run by no engine)
# --------------------------------------------------------------------------

def test_channel_inversion_helpers_match():
    """``tree_channel``'s gains (to float32 rounding of ``normal``) and
    masks, and eq. 3's allocation, signal and power."""
    key = jax.random.PRNGKey(4)
    tree = {"a": np.zeros((7, 5), np.float32), "b": np.zeros(9, np.float32)}
    jg, jmk = jota.tree_channel(key, tree, 0.5, 0.032)
    tg, tmk = ota.tree_channel(np.asarray(key),
                               {k: torch.from_numpy(v)
                                for k, v in tree.items()}, 0.5, 0.032)
    for k in tree:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   rtol=1e-5, atol=1e-6)
        near = np.abs(np.asarray(jg[k]) ** 2 - 0.032) < 1e-5
        assert np.array_equal(tmk[k].numpy()[~near],
                              np.asarray(jmk[k])[~near])
    r = np.random.default_rng(5)
    g = r.normal(size=(7, 5)).astype(np.float32)
    h, m = np.array(jg["a"]), np.array(jmk["a"])
    t = torch.from_numpy
    np.testing.assert_allclose(
        ota.power_allocation(0.7, t(h), t(m)).numpy(),
        np.asarray(jota.power_allocation(0.7, jnp.asarray(h), m)),
        rtol=1e-6)
    x = ota.transmit_signal(0.7, t(g), t(h), t(m))
    np.testing.assert_allclose(
        x.numpy(), np.asarray(jota.transmit_signal(0.7, g, h, m)),
        rtol=1e-6)
    np.testing.assert_allclose(float(ota.transmit_power(x)),
                               float(jota.transmit_power(x.numpy())),
                               rtol=1e-5)
