"""Client sampling in the port against the JAX package (DESIGN.md §3.15).

The narrow MLP (the JAX package's ``PAPER_MLP_DIMS`` monkeypatched for
this module, the port given the same dims), C=2 clusters, N=2 slots,
populations of 1, 3 and 8 per slot. The port starts from the reference's
state (``repro_torch.convert.sampled_state_from_numpy``) and sees the
same numpy batches and round keys; the port's threefry mode is set to the
live JAX mode.

Tolerances: the sample draw bit for bit in both threefry modes; the
bank's init leaf by leaf (the heads' normal draws within rtol 1e-5, as
``test_torch_seeded.py``: the uniforms are bit-identical, but
``torch.special.erfinv`` and XLA's ``erf_inv`` differ in the last place,
1.16e-6 relative on one of 2,048 entries here; the zeros, steps and the
-1 sentinel exactly); a chunked init equal to an
unchunked one bit for bit; population 1, the position pin, the f0 latch
and a blackout round bit for bit (they compare the port with itself); 3
sampled rounds and a ``ScenarioBank`` over the sampled sim against the
reference's over 2-3 rounds: metrics within rtol 1e-4, atol 1e-6, ω
within relative L2 1e-3 (``test_torch_sim.py``'s rule), the bank's heads
within rtol 1e-4, atol 1e-6, the ids and Adam steps exactly. A round
moves O(C·N) rows of the bank: every bank leaf keeps its storage, rows
not drawn keep their values, and no tensor of a bank leaf's shape is
made on the round path.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.models.model as jmodel
from repro.common.config import (
    FLConfig as JFLConfig, ModelConfig as JModelConfig,
    TrainConfig as JTrainConfig,
)
from repro.core import ota as jota
from repro.core.sampling import SampledHotaSim as JSampledHotaSim
from repro.core.sweep import ScenarioBank as JScenarioBank
from repro_torch import rng
from repro_torch.common.config import FLConfig, ModelConfig, TrainConfig
from repro_torch.common.tree import state_map, tree_leaves
from repro_torch.convert import sampled_state_from_numpy
from repro_torch.core import ota
from repro_torch.core.sampling import (
    ClientBank, SampledHotaSim, gather_clients, init_client_bank,
    scatter_clients,
)
from repro_torch.core.sweep import ScenarioBank
from repro_torch.models import params as tparams
from repro_torch.models.model import build_model

DIMS = (32, 64, 128, 64, 32, 16)
C, N, B = 2, 2, 4
N_CLS = [4, 4]
ROUNDS = 3
ENGINES = {"client_folded": {}, "streaming": dict(ota_streaming=True)}


@pytest.fixture(autouse=True, scope="module")
def _narrow_and_one_thread():
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


@pytest.fixture(params=[True, False], ids=["partitionable", "original"])
def threefry_mode(request):
    prev_j = jax.config.jax_threefry_partitionable
    prev = rng.set_threefry_partitionable(request.param)
    jax.config.update("jax_threefry_partitionable", request.param)
    yield request.param
    jax.config.update("jax_threefry_partitionable", prev_j)
    rng.set_threefry_partitionable(prev)


def _model():
    return build_model(ModelConfig(family="mlp"), DIMS)


def _sampled(population, **fl_kw):
    fl = dict(n_clusters=C, n_clients=N, **fl_kw)
    return SampledHotaSim(_model(), FLConfig(**fl), TrainConfig(lr=3e-4),
                          N_CLS, population, device="cpu")


def _jsampled(population, **fl_kw):
    fl = dict(n_clusters=C, n_clients=N, **fl_kw)
    return JSampledHotaSim(jmodel.Model(JModelConfig(family="mlp")),
                           JFLConfig(**fl), JTrainConfig(lr=3e-4), N_CLS,
                           population)


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


def _leaves(state):
    out = []
    state_map(out.append, state)
    return out


def _clone(state):
    return state_map(torch.clone, state)


# --------------------------------------------------------------------------
# the draw and the bank
# --------------------------------------------------------------------------

def test_draw_client_sample_matches_jax(threefry_mode):
    """The ids bit for bit, over keys and populations (the full int32
    span included), and the reserved fold."""
    assert ota.SAMPLE_FOLD == jota.SAMPLE_FOLD
    assert ota.SAMPLE_INIT_FOLD == jota.SAMPLE_INIT_FOLD
    for i in range(4):
        key = jax.random.fold_in(jax.random.PRNGKey(3), i)
        np.testing.assert_array_equal(ota.sample_key(np.asarray(key)).numpy(),
                                      np.asarray(jota.sample_key(key)))
        for pop in (1, 3, 8, 32768, 2 ** 31 - 1):
            want = np.asarray(jota.draw_client_sample(key, 5, 3, pop))
            got = ota.draw_client_sample(np.asarray(key), 5, 3, pop)
            assert got.dtype == torch.int32 and got.shape == (5, 3)
            np.testing.assert_array_equal(got.numpy(), want)


def _same_init_leaves(got_leaves, want_leaves):
    """Leaf by leaf: constant leaves (zeros, steps, the -1 sentinel)
    exactly, the normal draws within rtol 1e-5 (erfinv's last place)."""
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and g.numpy().dtype == w.dtype
        if np.all(w == w.reshape(-1)[0]):
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=0)


@pytest.mark.parametrize("population", [1, 3, 8])
def test_init_client_bank_matches_jax(threefry_mode, population):
    """``init_client_bank`` against the reference's at the same key: the
    heads' normal draws within rtol 1e-5 (erfinv's last place), the zero
    biases, the Adam moments and steps and the -1 sentinel exactly."""
    from repro.core.sampling import init_client_bank as jinit_client_bank
    key = jax.random.PRNGKey(5)
    want = jinit_client_bank(jmodel.Model(JModelConfig(family="mlp")),
                             JFLConfig(n_clusters=C, n_clients=N),
                             population, 4, key)
    got = init_client_bank(_model(), FLConfig(n_clusters=C, n_clients=N),
                           population, 4, np.asarray(key), device="cpu")
    _same_init_leaves(_leaves(got), jax.tree.leaves(want))
    assert got.heads["w"].shape[:3] == (C, N, population)
    np.testing.assert_array_equal(got.f0.numpy(), -np.ones((C, N, population),
                                                           np.float32))


def test_sampled_init_matches_jax():
    """``SampledHotaSim.init(key)``: the inner sim's ``init(key)`` and the
    bank from ``fold_in(key, SAMPLE_INIT_FOLD)``, as the reference's."""
    key = jax.random.PRNGKey(6)
    want = _jsampled(3).init(key)
    got = _sampled(3).init(np.asarray(key))
    _same_init_leaves(_leaves(got), jax.tree.leaves(want))


def test_chunked_init_equals_unchunked(monkeypatch):
    """A bank drawn one client at a time (the slice cut to 100 words,
    under two clients' 64-word heads) equals one drawn at once, bit for
    bit."""
    model, fl = _model(), FLConfig(n_clusters=C, n_clients=N)
    key = rng.PRNGKey(9)
    whole = init_client_bank(model, fl, 8, 4, key, device="cpu")
    monkeypatch.setattr(tparams, "_NORMAL_SLICE", 100)
    sliced = init_client_bank(model, fl, 8, 4, key, device="cpu")
    for a, b in zip(_leaves(whole), _leaves(sliced)):
        assert torch.equal(a, b)


def test_init_draws_at_most_one_launch_of_keys(monkeypatch):
    """A key table longer than one draw launch takes (here cut to 5 keys)
    is drawn in several, with the values of one draw."""
    model, fl = _model(), FLConfig(n_clusters=C, n_clients=N)
    key = rng.PRNGKey(10)
    whole = init_client_bank(model, fl, 8, 4, key, device="cpu")
    seen = []
    orig = tparams.bits

    def bits(keys, n, device=None):
        seen.append(int(rng.as_key(keys).reshape(-1, 2).shape[0]))
        return orig(keys, n, device=device)
    monkeypatch.setattr(tparams, "bits", bits)
    monkeypatch.setattr(tparams, "MAX_DRAW_KEYS", 5)
    sliced = init_client_bank(model, fl, 8, 4, key, device="cpu")
    assert max(seen) == 5 and len(seen) > 1
    for a, b in zip(_leaves(whole), _leaves(sliced)):
        assert torch.equal(a, b)


def test_gather_scatter_roundtrip_and_isolation():
    """scatter(gather) is the identity and writes in place (every leaf
    keeps its storage); a real write lands at the drawn ids only."""
    bank = _sampled(5).init(rng.PRNGKey(0)).bank
    before = _clone(bank)
    ptrs = [l.data_ptr() for l in _leaves(bank)]
    ids = torch.tensor([[4, 0], [2, 2]], dtype=torch.int32)
    heads, head_opt, f0 = gather_clients(bank, ids)
    back = scatter_clients(bank, ids, heads, head_opt, f0)
    assert [l.data_ptr() for l in _leaves(back)] == ptrs
    for a, b in zip(_leaves(back), _leaves(before)):
        assert torch.equal(a, b)
    marked = {k: v + 1.0 for k, v in heads.items()}
    out = scatter_clients(bank, ids, marked, head_opt, f0)
    touched = np.zeros((C, N, 5), bool)
    touched[np.arange(C)[:, None], np.arange(N)[None, :], ids.numpy()] = True
    diff = (out.heads["w"] != before.heads["w"]).reshape(C, N, 5, -1)
    np.testing.assert_array_equal(diff.any(-1).numpy(), touched)


def test_population_one_round_equals_plain_sim():
    """M=1 with the bank holding the plain sim's own slot state: the
    sampled round equals the plain round bit for bit."""
    samp = _sampled(1)
    sst = samp.init(rng.PRNGKey(3))
    plain = sst.sim
    bank = ClientBank(
        heads={k: v.unsqueeze(2).clone() for k, v in plain.heads.items()},
        head_opt=state_map(lambda l: l.unsqueeze(2).clone(), plain.head_opt),
        f0=plain.f0.unsqueeze(2).clone())
    (x, y), = _batches(1, seed=4)
    new_s, m_s = samp.step(sst._replace(bank=bank), x, y, rng.PRNGKey(9))
    new_p, m_p = samp.sim.step(plain, x, y, rng.PRNGKey(9))
    for a, b in zip(_leaves(new_s.sim), _leaves(new_p)):
        assert torch.equal(a, b)
    for k in m_p:
        assert torch.equal(m_s[k], m_p[k])
    assert torch.equal(m_s["sample_ids"], torch.zeros((C, N),
                                                      dtype=torch.int32))


def test_stream_words_identical_across_populations():
    """Position determinism: banks of 3 and 8 whose every member holds
    the same state draw different ids yet give the same round bit for
    bit (every channel stream keys off the slot position), and the
    round's channel words are the same at every population."""
    sims = [_sampled(m) for m in (3, 8)]
    states = [s.init(rng.PRNGKey(0)) for s in sims]
    src = states[0].bank.heads
    states = [st._replace(bank=st.bank._replace(heads={
        k: src[k][:, :, :1].expand_as(v).clone()
        for k, v in st.bank.heads.items()})) for st in states]
    (x, y), = _batches(1, seed=5)
    key = rng.PRNGKey(21)
    words = [s.round_streams(key, st.sim.omega) for s, st in
             zip(sims, states)]
    for a, b in zip(words[0].gain + words[0].noise,
                    words[1].gain + words[1].noise):
        assert torch.equal(a, b)
    outs = [s.step(st, x, y, key) for s, st in zip(sims, states)]
    assert not torch.equal(outs[0][1]["sample_ids"], outs[1][1]["sample_ids"])
    for a, b in zip(_leaves(outs[0][0].sim), _leaves(outs[1][0].sim)):
        assert torch.equal(a, b)
    for k in ("loss", "p", "fgrad", "grad_norms"):
        assert torch.equal(outs[0][1][k], outs[1][1][k])


def test_f0_latch_and_coverage():
    """Over 3 rounds the bank's f0 sentinel turns into a loss exactly at
    the drawn ids (each the host recompute of the round key's draw);
    members never drawn keep -1."""
    samp = _sampled(4)
    state = samp.init(rng.PRNGKey(1))
    seen = np.zeros((C, N, 4), bool)
    for r, (x, y) in enumerate(_batches(3, seed=6)):
        key = rng.fold_in(rng.PRNGKey(1), 100 + r)
        state, m = samp.step(state, x, y, key)
        ids = m["sample_ids"].numpy()
        np.testing.assert_array_equal(
            ids, ota.draw_client_sample(key, C, N, 4).numpy())
        seen[np.arange(C)[:, None], np.arange(N)[None, :], ids] = True
    f0 = state.bank.f0.numpy()
    assert (f0[seen] >= 0.0).all() and (f0[~seen] == -1.0).all()
    assert 0 < seen.sum() < seen.size


def test_blackout_round_is_bank_identity():
    """Blackout 1: no participant, the round skips, and the bank is its
    own identity bit for bit (the step consumes its state, so the bank is
    cloned before)."""
    samp = _sampled(3, faults=True, blackout_rate=1.0)
    state = samp.init(rng.PRNGKey(2))
    before = _clone(state.bank)
    (x, y), = _batches(1, seed=7)
    new, m = samp.step(state, x, y, rng.PRNGKey(7))
    assert float(m["skipped"]) == 1.0
    for a, b in zip(_leaves(new.bank), _leaves(before)):
        assert torch.equal(a, b)


class _Made(TorchDispatchMode):
    """The shapes and storages of every tensor an op makes."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.made.append((tuple(t.shape), t.data_ptr()))
        return out


def _assert_rows_moved(bank_before, bank_after, ptrs, made, drawn):
    """Every bank leaf kept its storage, no op made a tensor of a bank
    leaf's shape elsewhere, and only the drawn rows changed."""
    after = _leaves(bank_after)
    assert [l.data_ptr() for l in after] == ptrs
    for leaf in after:
        copies = [p for s, p in made if s == tuple(leaf.shape)
                  and p not in ptrs]
        assert not copies, f"a copy of a {tuple(leaf.shape)} bank leaf"
    for a, b in zip(after, _leaves(bank_before)):
        keep = ~drawn.reshape(drawn.shape + (1,) * (a.dim() - drawn.dim()))
        assert torch.equal(torch.where(keep, a, torch.zeros_like(a)),
                           torch.where(keep, b, torch.zeros_like(b)))


def test_sampled_round_moves_only_the_drawn_rows():
    """M = 37, a size no tensor of the round has, so that a tensor of a
    bank leaf's shape can only be a copy of the bank."""
    samp = _sampled(37)
    state = samp.init(rng.PRNGKey(4))
    before = _clone(state.bank)
    ptrs = [l.data_ptr() for l in _leaves(state.bank)]
    (x, y), = _batches(1, seed=8)
    with _Made() as rec:
        new, m = samp.step(state, x, y, rng.PRNGKey(44))
    drawn = torch.zeros((C, N, 37), dtype=torch.bool)
    drawn[torch.arange(C)[:, None], torch.arange(N)[None, :],
          m["sample_ids"].long()] = True
    _assert_rows_moved(before, new.bank, ptrs, rec.made, drawn)


# --------------------------------------------------------------------------
# against the reference's sampled sim and bank
# --------------------------------------------------------------------------

@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_sampled_rounds_match_jax(engine):
    jsim, sim = _jsampled(3, **ENGINES[engine]), _sampled(3,
                                                          **ENGINES[engine])
    jstate = jsim.init(jax.random.PRNGKey(0))
    state = sampled_state_from_numpy(jax.tree.map(np.asarray, jstate))
    for r, ((xb, yb), key) in enumerate(zip(_batches(), _keys())):
        jstate, jm = jsim.step(jstate, jnp.asarray(xb), jnp.asarray(yb), key)
        state, m = sim.step(state, xb, yb, np.asarray(key))
        assert set(m) == set(jm)
        np.testing.assert_array_equal(m["sample_ids"].numpy(),
                                      np.asarray(jm["sample_ids"]))
        for name in jm:
            np.testing.assert_allclose(m[name].numpy(), np.asarray(jm[name]),
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"{engine} round {r} {name}")
        assert _rel_l2(state.sim.omega, jstate.sim.omega) < 1e-3
    for g, w in zip(_leaves(state.bank), jax.tree.leaves(jstate.bank)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6)
    assert np.array_equal(state.bank.head_opt.step.numpy(),
                          np.asarray(jstate.bank.head_opt.step))
    assert (state.bank.head_opt.step.numpy() > 0).any()


def test_scenario_bank_over_sampled_sim_matches_jax():
    """A ``ScenarioBank`` over the sampled sim against the reference's
    (``tests/test_sampling.py``'s composition) over 2 rounds: the same
    ids in every scenario, each round moving only the drawn rows of the
    (S, C, N, M) bank in place (M = 5, a size no tensor of the round
    has); then save, restore and one more round
    bit for bit."""
    jsim, sim = _jsampled(5), _sampled(5)
    scen = [dict(noise_std=0.3), dict(sigma2=(0.5, 2.0))]
    jbank = JScenarioBank(jsim, scen + [JFLConfig(n_clusters=C,
                                                  n_clients=N)])
    bank = ScenarioBank(sim, scen + [FLConfig(n_clusters=C, n_clients=N)])
    jst = jbank.init(jax.random.PRNGKey(0))
    st = sampled_state_from_numpy(jax.tree.map(np.asarray, jst))
    for r, ((xb, yb), key) in enumerate(zip(_batches(2), _keys(2))):
        jst, jm = jbank.step(jst, jnp.asarray(xb), jnp.asarray(yb), key)
        before = _clone(st.bank)
        ptrs = [l.data_ptr() for l in _leaves(st.bank)]
        with _Made() as rec:
            st, m = bank.step(st, xb, yb, np.asarray(key))
        ids = m["sample_ids"]
        assert ids.shape == (3, C, N)
        assert torch.equal(ids[0], ids[1]) and torch.equal(ids[0], ids[2])
        drawn = torch.zeros((3, C, N, 5), dtype=torch.bool)
        drawn[:, torch.arange(C)[:, None], torch.arange(N)[None, :],
              ids[0].long()] = True
        _assert_rows_moved(before, st.bank, ptrs, rec.made, drawn)
        for name in jm:
            np.testing.assert_allclose(m[name].numpy(), np.asarray(jm[name]),
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"round {r} {name}")
        assert _rel_l2(st.sim.omega, jst.sim.omega) < 1e-3
    for g, w in zip(_leaves(st.bank), jax.tree.leaves(jst.bank)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6)


def test_sampled_bank_save_restore_continues(tmp_path):
    bank = ScenarioBank(_sampled(3), [dict(noise_std=0.3),
                                      dict(sigma2=(0.5, 2.0))])
    (x0, y0), (x1, y1) = _batches(2, seed=9)
    st, _ = bank.step(bank.init(rng.PRNGKey(0)), x0, y0, rng.PRNGKey(1))
    bank.save(str(tmp_path), 1, st)
    restored = bank.restore(str(tmp_path), 1)
    a, ma = bank.step(_clone(st), x1, y1, rng.PRNGKey(2))
    b, mb = bank.step(restored, x1, y1, rng.PRNGKey(2))
    for u, v in zip(_leaves(a), _leaves(b)):
        assert torch.equal(u, v)
    for k in ma:
        assert torch.equal(ma[k], mb[k])


def test_population_must_be_positive():
    with pytest.raises(ValueError, match="population"):
        _sampled(0)
