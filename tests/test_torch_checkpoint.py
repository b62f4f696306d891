"""Checkpoints, the round guard, transmit power and the small optimisers
of the port against the JAX package.

- the manifest codec (``repro_torch.checkpoint.msgpack_lite``) against the
  ``msgpack`` package: the same bytes, and each reads what the other
  writes;
- a faulted ``SimState`` and a fault bank's state written by the JAX
  package restore into the port leaf for leaf (bit for bit), and ones the
  port writes restore into the JAX package; a bank restored in the port
  continues bit for bit;
- the atomic save under a crash, ``latest_step`` skipping a directory
  with no manifest, the layout pin and the scenario-count pin;
- ``RoundGuard`` restoring after ``patience`` skipped rounds, and a clean
  round resetting its streak;
- ``core.power`` at thresholds of the paper's range, H_th from 1e-4 to
  0.5 (rtol 1e-5: float32 in the port, the reference's erfc in XLA; in
  the far tail, pass rates near 1e-15 at σ² = 0.05 and H_th = 3, the two
  float32 erfc differ by 2e-5 relative), ``clip_by_global_norm`` (rtol
  1e-6), the schedules (rtol 1e-6) and ``sgd_update`` (exact) against
  the reference's functions.
"""
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

import repro.checkpoint.store as jstore
import repro.models.model as jmodel
from repro.common.config import (
    FLConfig as JFLConfig, ModelConfig as JModelConfig,
    TrainConfig as JTrainConfig,
)
from repro.core import power as jpower
from repro.core.sim import HotaSim as JHotaSim
from repro.core.sweep import ScenarioBank as JScenarioBank
from repro.optim import clip as jclip
from repro.optim import schedules as jsched
from repro.optim import sgd as jsgd
from repro_torch import rng
from repro_torch.checkpoint import msgpack_lite
from repro_torch.checkpoint import store
from repro_torch.common.config import FLConfig, ModelConfig, TrainConfig
from repro_torch.convert import bank_state_from_numpy, sim_state_from_numpy
from repro_torch.core import power
from repro_torch.core.sim import HotaSim
from repro_torch.core.sweep import ScenarioBank
from repro_torch.launch.train import RoundGuard
from repro_torch.models.model import build_model
from repro_torch.optim import clip, schedules, sgd

DIMS = (32, 64, 128, 64, 32, 16)
C, N, B = 3, 2, 8
N_CLS = [6, 6]
FL = dict(n_clusters=C, n_clients=N, sigma2=(1.0, 0.5, 2.0), faults=True,
          dropout_rate=0.3, straggler_rate=0.4, staleness_rounds=2)
SCENARIOS = [dict(dropout_rate=0.0), dict(blackout_rate=0.5)]


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


def _sims(fl_kw=FL):
    jsim = JHotaSim(jmodel.Model(JModelConfig(family="mlp")),
                    JFLConfig(**fl_kw), JTrainConfig(lr=3e-4), N_CLS)
    sim = HotaSim(build_model(ModelConfig(family="mlp"), DIMS),
                  FLConfig(**fl_kw), TrainConfig(lr=3e-4), N_CLS,
                  device="cpu")
    return jsim, sim


def _batch(seed=0):
    r = np.random.default_rng(seed)
    return (r.normal(size=(C, N, B, DIMS[0])).astype(np.float32),
            r.integers(0, N_CLS[0], (C, N, B)).astype(np.int32))


def _port_leaves(state):
    return [t.numpy() for t in store.flatten(state)]


def _assert_leaves_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


# --------------------------------------------------------------------------
# the manifest codec
# --------------------------------------------------------------------------

CODEC_CASES = {
    "manifest": {"treedef": "PyTreeDef({'w': *})", "n_leaves": 3,
                 "step": 12, "metadata": {"kind": "ScenarioBank",
                                          "n_scenarios": 4,
                                          "layout": {"engine": "slab",
                                                     "sections": "toplevel",
                                                     "min_section_rows": 0}},
                 "dtypes": ["float32", "int32"], "shapes": [[4, 3], []]},
    "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
             2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
             -2 ** 31, -2 ** 31 - 1, -2 ** 63],
    "scalars": [None, True, False, 0.0, -1.5, 3.141592653589793, 1e300,
                float("inf")],
    "strings": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256,
                "e" * 70000, "σ² ĝ"],
    "sizes": {"list15": list(range(15)), "list16": list(range(16)),
              "list70000": [1] * 70000, "tuple": (1, "x"),
              "map15": {str(i): i for i in range(15)},
              "map16": {str(i): i for i in range(16)},
              "nested": [[{"a": [[]]}], {}]},
}


@pytest.mark.parametrize("case", sorted(CODEC_CASES))
def test_codec_matches_msgpack(case):
    obj = CODEC_CASES[case]
    want = msgpack.packb(obj)
    assert msgpack_lite.packb(obj) == want
    assert msgpack_lite.unpackb(want) == msgpack.unpackb(want)
    assert msgpack.unpackb(msgpack_lite.packb(obj)) == msgpack.unpackb(want)


def test_codec_refuses_what_it_does_not_read():
    """The codec reads the manifest's subset and raises on the rest:
    truncated or trailing bytes, a type code outside the subset (``bin``,
    float32), an object it cannot write."""
    assert msgpack_lite.unpackb(b"\xcd\x00\x05") == 5   # a wide int form
    for data, match in ((b"\x92\x01", "truncated"),
                        (b"\x01\x02", "trailing"),
                        (msgpack.packb(b"abc"), "unsupported"),
                        (msgpack.packb(1.5, use_single_float=True),
                         "unsupported")):
        with pytest.raises(ValueError, match=match):
            msgpack_lite.unpackb(data)
    with pytest.raises(TypeError):
        msgpack_lite.packb({"a": object()})


# --------------------------------------------------------------------------
# checkpoints across the two packages
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def states():
    """A faulted reference SimState one round in, and a fault bank's
    state one round in, with the port's sim and bank beside them."""
    jsim, sim = _sims()
    xb, yb = _batch()
    key = jax.random.PRNGKey(10)
    jst, _ = jsim.step(jsim.init(jax.random.PRNGKey(0)), xb, yb, key)
    jbank = JScenarioBank(jsim, SCENARIOS)
    jbst, _ = jbank.step(jbank.init(jax.random.PRNGKey(0)), xb, yb, key)
    return jsim, sim, jst, jbank, ScenarioBank(sim, SCENARIOS), jbst


def test_jax_sim_checkpoint_restores_into_the_port(states, tmp_path):
    jsim, sim, jst, _, _, _ = states
    jstore.save_checkpoint(str(tmp_path), 1, jax.tree.map(np.asarray, jst))
    got = store.restore_checkpoint(str(tmp_path), 1, sim.abstract_state())
    _assert_leaves_equal(_port_leaves(got),
                         [np.asarray(l) for l in jax.tree.leaves(jst)])
    want = sim_state_from_numpy(jax.tree.map(np.asarray, jst))
    _assert_leaves_equal(_port_leaves(got), _port_leaves(want))


def test_port_sim_checkpoint_restores_into_jax(states, tmp_path):
    jsim, sim, jst, _, _, _ = states
    st = sim_state_from_numpy(jax.tree.map(np.asarray, jst))
    store.save_checkpoint(str(tmp_path), 2, st, {"note": "port"})
    like = jax.eval_shape(jsim.init, jax.random.PRNGKey(0))
    got = jstore.restore_checkpoint(str(tmp_path), 2, like)
    _assert_leaves_equal([np.asarray(l) for l in jax.tree.leaves(got)],
                         [np.asarray(l) for l in jax.tree.leaves(jst)])
    assert jstore.checkpoint_metadata(str(tmp_path), 2) == {"note": "port"}


def test_bank_checkpoints_cross_both_ways(states, tmp_path):
    """``ScenarioBank.save``/``restore`` on either side read the other's:
    the manifests pin the same scenario count and layout."""
    _, _, _, jbank, bank, jbst = states
    jbank.save(str(tmp_path / "jax"), 1, jbst)
    got = bank.restore(str(tmp_path / "jax"), 1)
    want = [np.asarray(l) for l in jax.tree.leaves(jbst)]
    _assert_leaves_equal(_port_leaves(got), want)
    assert got.step.dtype == torch.int32 and got.stale_age.shape == (2,)
    bank.save(str(tmp_path / "port"), 1, got)
    assert (store.checkpoint_metadata(str(tmp_path / "port"), 1)
            == jstore.checkpoint_metadata(str(tmp_path / "jax"), 1))
    back = jbank.restore(str(tmp_path / "port"), 1)
    _assert_leaves_equal([np.asarray(l) for l in jax.tree.leaves(back)],
                         want)


def test_restored_bank_continues_bit_for_bit(states, tmp_path):
    _, _, _, _, bank, jbst = states
    st = bank_state_from_numpy(jax.tree.map(np.asarray, jbst))
    xb, yb = _batch(1)
    key = rng.PRNGKey(11)
    want, wm = bank.step(st, xb, yb, key)
    bank.save(str(tmp_path), 5, st)
    got, m = bank.step(bank.restore(str(tmp_path), 5), xb, yb, key)
    _assert_leaves_equal(_port_leaves(got), _port_leaves(want))
    for k in wm:
        assert torch.equal(m[k], wm[k]), k


def test_bank_restore_pins_layout_and_scenario_count(states, tmp_path):
    _, sim, _, _, bank, jbst = states
    st = bank_state_from_numpy(jax.tree.map(np.asarray, jbst))
    bank.save(str(tmp_path), 1, st)
    with pytest.raises(ValueError, match="2-scenario bank"):
        ScenarioBank(sim, SCENARIOS + [dict()]).restore(str(tmp_path), 1)
    _, sim_tail = _sims(dict(FL, ota_sections="tail"))
    with pytest.raises(ValueError, match="packed-layout mismatch"):
        ScenarioBank(sim_tail, SCENARIOS).restore(str(tmp_path), 1)
    with pytest.raises(ValueError, match="leaf 0"):
        store.restore_checkpoint(str(tmp_path), 1, sim.abstract_state())


def test_save_is_atomic_under_a_crash(tmp_path, monkeypatch):
    """A crash before the manifest is written leaves no directory that
    ``latest_step`` or a restore would read; the next save reuses the
    temporary directory."""
    d = str(tmp_path / "ck")
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    store.save_checkpoint(d, 1, tree)

    def boom(*a, **kw):
        raise RuntimeError("simulated crash before the manifest")
    monkeypatch.setattr(store, "packb", boom)
    with pytest.raises(RuntimeError, match="simulated crash"):
        store.save_checkpoint(d, 2, {"w": tree["w"] * 2})
    assert not os.path.isdir(os.path.join(d, "step_00000002"))
    assert store.latest_step(d) == 1
    assert torch.equal(store.restore_checkpoint(d, 1, tree)["w"], tree["w"])
    monkeypatch.undo()
    store.save_checkpoint(d, 2, {"w": tree["w"] * 2})
    assert store.latest_step(d) == 2
    assert torch.equal(store.restore_checkpoint(d, 2, tree)["w"],
                       tree["w"] * 2)


def test_latest_step_skips_manifestless_dirs(tmp_path):
    d = str(tmp_path / "ck")
    assert store.latest_step(d) is None
    store.save_checkpoint(d, 3, {"w": torch.zeros(2)})
    os.makedirs(os.path.join(d, "step_00000009"))
    os.makedirs(os.path.join(d, ".tmp-step_00000011"))
    assert store.latest_step(d) == 3


def test_restore_checks_the_layout_pin(tmp_path):
    d = str(tmp_path)
    md = {"layout": {"engine": "slab", "sections": "toplevel",
                     "min_section_rows": 0}}
    store.save_checkpoint(d, 1, {"w": torch.ones(3)}, md)
    like = {"w": torch.empty(3, device="meta")}
    assert store.restore_checkpoint(d, 1, like,
                                    expected_layout=md["layout"])["w"].sum() \
        == 3
    with pytest.raises(ValueError, match="packed-layout mismatch"):
        store.restore_checkpoint(d, 1, like, expected_layout=dict(
            md["layout"], sections="tail"))


# --------------------------------------------------------------------------
# the round guard
# --------------------------------------------------------------------------

def test_round_guard_restores_after_patience(tmp_path):
    """A wedged run (the spike guard trips every round) rolls back to the
    newest checkpoint after ``patience`` skipped rounds in a row."""
    _, sim = _sims(dict(FL, spike_norm=0.0))
    st0 = sim.init(rng.PRNGKey(0))
    xb, yb = _batch()
    ckpt = str(tmp_path / "ck")
    store.save_checkpoint(ckpt, 0, st0)
    guard = RoundGuard(ckpt, sim.abstract_state(), patience=3)
    st, restores = st0, []
    for r in range(4):
        st, m = sim.step(st, xb, yb, rng.PRNGKey(2 + r))
        assert float(m["skipped"]) == 1.0
        st, restored = guard.observe(m["skipped"], st)
        restores.append(restored)
    assert restores == [False, False, True, False]
    assert guard.n_restores == 1
    want, _ = sim.step(st0, xb, yb, rng.PRNGKey(5))
    _assert_leaves_equal(_port_leaves(st), _port_leaves(want))


def test_round_guard_clean_round_resets_streak(tmp_path):
    guard = RoundGuard(str(tmp_path / "none"), {"a": torch.zeros(2)},
                       patience=2)
    s = {"a": torch.ones(2)}
    for skipped in (1.0, 0.0, 1.0):
        out, restored = guard.observe(torch.tensor(skipped), s)
        assert out is s and not restored
    assert guard.streak == 1
    out, restored = guard.observe(1.0, s)       # no checkpoint on disk
    assert out is s and not restored and guard.streak == 0
    with pytest.raises(ValueError, match="patience"):
        RoundGuard(str(tmp_path), {}, patience=0)


@pytest.mark.parametrize("fl_kw", [
    FL, dict(FL, faults=False), dict(FL, use_pallas_ota=False)],
    ids=["faults_slab", "no_faults", "faults_tree_adam"])
def test_abstract_state_matches_the_references(fl_kw):
    """The state a restore checks against has the reference's leaves, in
    its flatten order, shape for shape and dtype for dtype."""
    jsim, sim = _sims(fl_kw)
    got = store.flatten(sim.abstract_state())
    want = jax.tree.leaves(jax.eval_shape(jsim.init, jax.random.PRNGKey(0)))
    assert [(tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for t in got] == [(tuple(w.shape), str(w.dtype)) for w in want]
    assert all(t.device.type == "meta" for t in got)


# --------------------------------------------------------------------------
# transmit power and the small optimisers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("sigma2", [0.05, 0.5, 1.0, 2.0])
def test_power_matches(sigma2):
    for h in (1e-4, 0.032, 0.5):
        for fn in (jpower.inv_h2_truncated_mean, jpower.pass_rate):
            np.testing.assert_allclose(
                float(getattr(power, fn.__name__)(h, sigma2)),
                float(fn(h, sigma2)), rtol=1e-5)
    args = ([1.0, 0.5, 1.5], [1.0, 2.0, 0.5], 0.032, sigma2, 1000)
    np.testing.assert_allclose(float(power.expected_transmit_power(*args)),
                               float(jpower.expected_transmit_power(*args)),
                               rtol=1e-5)
    np.testing.assert_allclose(
        float(power.expected_entry_power(1.3, 0.7, 0.032, sigma2)),
        float(jpower.expected_entry_power(1.3, 0.7, 0.032, sigma2)),
        rtol=1e-5)
    budget = float(jpower.expected_transmit_power(
        args[0], args[1], 0.1, sigma2, 1000))
    got = float(power.calibrate_h_threshold(budget, args[0], args[1],
                                            sigma2, 1000))
    np.testing.assert_allclose(got, float(jpower.calibrate_h_threshold(
        budget, args[0], args[1], sigma2, 1000)), rtol=1e-4)
    np.testing.assert_allclose(got, 0.1, rtol=1e-3)


def test_clip_and_sgd_match():
    r = np.random.default_rng(7)
    tree = {"a": r.normal(size=(4, 3)).astype(np.float32) * 3,
            "b": r.normal(size=5).astype(np.float32)}
    params = {"a": r.normal(size=(4, 3)).astype(np.float32),
              "b": r.normal(size=5).astype(np.float32)}
    t = {k: torch.from_numpy(v) for k, v in tree.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    for max_norm in (0.5, 1e3):
        got, norm = clip.clip_by_global_norm(t, max_norm)
        want, jnorm = jclip.clip_by_global_norm(tree, max_norm)
        np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
        for k in tree:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6)
    got = sgd.sgd_update(t, tp, 0.1)
    want = jsgd.sgd_update(tree, params, 0.1)
    for k in tree:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_schedules_match():
    cases = [(schedules.constant(3e-4), jsched.constant(3e-4)),
             (schedules.cosine_decay(1e-3, 100), jsched.cosine_decay(1e-3,
                                                                     100)),
             (schedules.linear_warmup_cosine(1e-3, 10, 100, 0.2),
              jsched.linear_warmup_cosine(1e-3, 10, 100, 0.2))]
    for got_fn, want_fn in cases:
        for step in (0, 1, 5, 10, 50, 100, 150):
            np.testing.assert_allclose(
                float(got_fn(torch.tensor(step, dtype=torch.int32))),
                float(want_fn(jnp.asarray(step, jnp.int32))), rtol=1e-6,
                atol=1e-12)
