"""The port's ScenarioBank and figure runner against the JAX package's, at
narrow width.

The JAX package's ``PAPER_MLP_DIMS`` is monkeypatched to narrow dims for
this module only, and the port is given the same dims. Both banks start
from the JAX bank's state (carried across by
``repro_torch.convert.bank_state_from_numpy``) and see the same batches
and round keys for 3 rounds; the port's threefry mode is set to the live
JAX mode.

Tolerances: loss, p, F_grad and the masked norms per round to rtol 1e-4
(float32 matmul and reduction order differ between XLA and PyTorch, and
three rounds compound them, as in ``test_torch_sim``'s trajectory). At
σ² = 0.05 the two libraries' float32 ``erfc`` differ by one ulp, so masks
are compared under the 1-ulp rule: they must agree wherever the uniform
lies more than one ulp from p_pass.
"""
import json

import jax
import numpy as np
import pytest
import torch

import repro.models.model as jmodel
from repro.common.config import (
    FLConfig as JFLConfig, ModelConfig as JModelConfig,
    TrainConfig as JTrainConfig,
)
from repro.common.flatpack import packer_for as jpacker_for
from repro.core import ota as jota
from repro.core.channel import channel_params as jchannel_params
from repro.core.sim import HotaSim as JHotaSim
from repro.core.sweep import ScenarioBank as JScenarioBank
from repro.data import federated as jfed
from repro.data import radcom as jradcom
from repro.kernels.ota_channel import ref as jref
from repro_torch import rng
from repro_torch.common.config import FLConfig, ModelConfig, TrainConfig
from repro_torch.common.tree import tree_leaves
from repro_torch.convert import bank_state_from_numpy
from repro_torch.core import ota
from repro_torch.core.channel import ChannelParams, channel_params
from repro_torch.core.sim import HotaSim
from repro_torch.core.sweep import ScenarioBank
from repro_torch.data.federated import FederatedBatcher
from repro_torch.experiments import fig4_diverse_sigma, paper_common
from repro_torch.kernels.ota_channel.ref import pass_probability
from repro_torch.models.model import build_model

DIMS = (32, 64, 128, 64, 32, 16)
C, N, B = 3, 2, 8
N_CLS = [jradcom.N_CLASSES[jradcom.TASKS[i]] for i in range(N)]
ROUNDS = 3
RTOL = 1e-4
HARSH = {"fig3b_harsh_hota_fgn": dict(weighting="fedgradnorm",
                                      sigma2=(0.05, 1.0, 1.0)),
         "fig3b_harsh_equal": dict(weighting="equal",
                                   sigma2=(0.05, 1.0, 1.0))}


@pytest.fixture(autouse=True, scope="module")
def _narrow_reference():
    """One intra-op thread (the suite runs several worker processes at
    once), the JAX package at narrow dims, and the port's threefry layout
    set to the live JAX mode."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    mp.setattr(jmodel, "PAPER_MLP_DIMS", DIMS)
    prev_mode = rng.set_threefry_partitionable(
        jax.config.jax_threefry_partitionable)
    yield
    rng.set_threefry_partitionable(prev_mode)
    mp.undo()
    torch.set_num_threads(prev)


def _sims(**fl):
    jsim = JHotaSim(jmodel.Model(JModelConfig(family="mlp")),
                    JFLConfig(n_clusters=C, n_clients=N, **fl),
                    JTrainConfig(lr=3e-4), N_CLS)
    sim = HotaSim(build_model(ModelConfig(family="mlp"), DIMS),
                  FLConfig(n_clusters=C, n_clients=N, **fl),
                  TrainConfig(lr=3e-4), N_CLS, device="cpu")
    return jsim, sim


def _batches(n):
    data = jradcom.make_radcom_dataset(
        jradcom.RadComConfig(n_points=600, feature_dim=DIMS[0]))
    batcher = jfed.FederatedBatcher(
        jradcom.client_partition(data, C, N, seed=0), B, seed=1)
    return [batcher.next_stacked() for _ in range(n)]


def _run_both(specs):
    """ROUNDS rounds of the JAX bank and the port's from one state;
    returns the per-round metrics of both and the round keys."""
    jsim, sim = _sims()
    jbank, bank = JScenarioBank(jsim, specs), ScenarioBank(sim, specs)
    jstates = jbank.init(jax.random.PRNGKey(0))
    states = bank_state_from_numpy(jax.tree.map(np.asarray, jstates))
    keys = [jax.random.fold_in(jax.random.PRNGKey(9), r)
            for r in range(ROUNDS)]
    jms, ms = [], []
    for (xb, yb), key in zip(_batches(ROUNDS), keys):
        jstates, jm = jbank.step(jstates, xb, yb, key)
        states, m = bank.step(states, xb, yb, np.asarray(key))
        jms.append(jm)
        ms.append(m)
    return jms, ms, keys, (jstates, states)


def _compare(jms, ms, s_count):
    for r, (jm, m) in enumerate(zip(jms, ms)):
        for name in ("loss", "p", "fgrad", "grad_norms"):
            assert tuple(m[name].shape) == np.shape(jm[name])
            assert m[name].shape[:2] == (s_count, C)
            np.testing.assert_allclose(m[name].numpy(), np.asarray(jm[name]),
                                       rtol=RTOL, err_msg=f"{name} r{r}")


def test_fig4_bank_matches_jax_bank():
    specs = list(fig4_diverse_sigma.experiments().values())
    jms, ms, _, (jstates, states) = _run_both(specs)
    _compare(jms, ms, len(specs))
    assert torch.equal(states.step,
                       torch.full((len(specs),), ROUNDS, dtype=torch.int32))
    for got, want in zip(tree_leaves(states.omega),
                         jax.tree.leaves(jstates.omega)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=1e-6)


def test_harsh_bank_matches_jax_under_the_ulp_rule():
    """Fig. 3b's harsh cluster, σ² = 0.05, where the two libraries' erfc
    differ by one ulp: masks agree outside the one-ulp window, and the
    metrics agree to the stated tolerance."""
    specs = list(HARSH.values())
    jms, ms, keys, _ = _run_both(specs)
    _compare(jms, ms, len(specs))
    sigma2 = HARSH["fig3b_harsh_equal"]["sigma2"]
    fl = dict(n_clusters=C, n_clients=N, sigma2=sigma2)
    jchan, chan = jchannel_params(JFLConfig(**fl)), channel_params(
        FLConfig(**fl))
    tp = pass_probability(chan.sigma2, chan.h_threshold).numpy()
    jp = np.asarray(jref.pass_probability(jchan.sigma2, jchan.h_threshold))
    assert np.all(np.abs(tp - jp) <= np.spacing(jp))
    sim = _sims()[1]
    omega = sim.init(rng.PRNGKey(0)).omega
    pk = sim.packer(omega)
    jpk = jpacker_for(jax.tree.map(lambda t: t.numpy(), omega),
                      tail="final", sections="toplevel")
    tail = pk.sections[-1]
    assert tail.name == "final"
    for key in keys:
        ck = jota.sim_channel_key(key)
        got = tree_leaves(ota.final_layer_masks_packed(np.asarray(ck), chan,
                                                       pk))
        want = jax.tree.leaves(jota.final_layer_masks_packed(ck, jchan, jpk))
        gain = ota.section_streams(np.asarray(ck), pk, C).gain[tail.index]
        u = ((gain.to(torch.int64) & 0xFFFFFFFF).to(torch.float32)
             * 2.0 ** -32).numpy()
        ulp = np.spacing(jp)[:, None]
        window = ((u >= np.minimum(tp, jp)[:, None] - ulp)
                  & (u <= np.maximum(tp, jp)[:, None] + ulp))
        for run in pk.leaf_runs():
            if run.section != tail.index:
                continue
            near = window[:, run.offset:run.offset + run.size].reshape(
                got[run.leaf].shape)
            assert np.array_equal(got[run.leaf].numpy()[~near],
                                  np.asarray(want[run.leaf])[~near])


def test_bank_equals_sequential_single_scenario_runs():
    """Each scenario of the bank follows the trajectory of a single sim
    run with that scenario's channel (the reference's bank contract)."""
    specs = list(HARSH.values())
    _, sim = _sims()
    bank = ScenarioBank(sim, specs)
    states = bank.init(rng.PRNGKey(0))
    batches = _batches(2)
    keys = [rng.PRNGKey(20 + r) for r in range(2)]
    states, hist = bank.run(states, batches, keys)
    assert hist["loss"].shape == (2, len(specs), C, N)
    for s, spec in enumerate(specs):
        one = HotaSim(sim.model, FLConfig(n_clusters=C, n_clients=N, **spec),
                      sim.tcfg, N_CLS, device="cpu")
        st = one.init(rng.PRNGKey(0))
        for r, ((xb, yb), key) in enumerate(zip(batches, keys)):
            st, m = one.step(st, xb, yb, key)
            for name in m:
                assert torch.equal(hist[name][r, s], m[name]), (s, r, name)
        for a, b in zip(tree_leaves(bank.scenario_state(states, s).omega),
                        tree_leaves(st.omega)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("engine", [
    dict(ota_streaming=True), dict(ota_sectioned=True),
    dict(ota_sectioned=True, ota_streaming=True)],
    ids=["streaming", "sectioned", "sectioned_streaming"])
def test_bank_runs_on_each_engine(engine):
    """The bank on the engines that draw inside the step: sectioned equals
    the client-folded bank bit for bit, the streaming engines match it to
    float rounding."""
    specs = list(HARSH.values())
    batches = _batches(2)
    keys = [rng.PRNGKey(30 + r) for r in range(2)]
    out = []
    for kw in (engine, {}):
        sim = HotaSim(build_model(ModelConfig(family="mlp"), DIMS),
                      FLConfig(n_clusters=C, n_clients=N, **kw),
                      TrainConfig(lr=3e-4), N_CLS, device="cpu")
        bank = ScenarioBank(sim, specs)
        out.append(bank.run(bank.init(rng.PRNGKey(0)), batches, keys))
    (st, hist), (st0, hist0) = out
    if engine.get("ota_streaming"):
        np.testing.assert_allclose(st.ps_opt.mu.numpy(),
                                   st0.ps_opt.mu.numpy(), rtol=1e-4,
                                   atol=1e-7)
        np.testing.assert_allclose(hist["loss"].numpy(),
                                   hist0["loss"].numpy(), rtol=1e-5)
    else:
        assert torch.equal(st.ps_opt.mu, st0.ps_opt.mu)
        for name in hist:
            assert torch.equal(hist[name], hist0[name])


def test_bank_refusals():
    _, sim = _sims()
    with pytest.raises(ValueError, match="'tau_h' differs from the bank's"):
        ScenarioBank(sim, [dict(weighting="equal"), dict(tau_h=2)])
    with pytest.raises(ValueError, match="fault knob 'dropout_rate'"):
        ScenarioBank(sim, [dict(dropout_rate=0.1)])
    with pytest.raises(TypeError, match=r"\| FaultParams \| dict"):
        ScenarioBank(sim, [("not", "a", "scenario")])
    with pytest.raises(ValueError, match="sigma2 shape"):
        ScenarioBank(sim, [ChannelParams(*[torch.ones(C + 1)] * 5)])
    with pytest.raises(ValueError, match="empty scenario list"):
        ScenarioBank(sim, [])
    bank = ScenarioBank(sim, [channel_params(sim.fl), dict(noise_std=0.5)])
    assert bank.n_scenarios == 2
    assert float(bank.chan_bank.noise_std[1]) == 0.5
    with pytest.raises(ValueError, match="no batches"):
        bank.run(bank.init(rng.PRNGKey(0)), [], [])


def test_run_sweep_smoke(monkeypatch, tmp_path):
    """The port's run_sweep end to end on the CPU at narrow width, with
    its results directory in tmp_path; a second call reads the cache."""
    def narrow_setup(fl, batch=24, seed=0, device="cuda"):
        sim = HotaSim(build_model(ModelConfig(family="mlp"), DIMS), fl,
                      TrainConfig(lr=3e-4), N_CLS, device=device)
        data = jradcom.make_radcom_dataset(
            jradcom.RadComConfig(n_points=600, feature_dim=DIMS[0]))
        parts = jradcom.client_partition(data, fl.n_clusters, fl.n_clients,
                                         seed=seed)
        return sim, FederatedBatcher(parts, batch, seed=seed + 1)

    monkeypatch.setattr(paper_common, "RESULTS_DIR", str(tmp_path))
    monkeypatch.setattr(paper_common, "paper_mlp_setup", narrow_setup)
    exps = {"a_fgn": dict(weighting="fedgradnorm", sigma2=[0.5, 1.0, 1.0]),
            "a_equal": dict(weighting="equal", sigma2=[0.5, 1.0, 1.0])}
    kw = dict(steps=3, n_clusters=C, n_clients=N, batch=4, log_every=1,
              ota_streaming=True, device="cpu")
    res = paper_common.run_sweep(exps, **kw)
    assert sorted(res) == sorted(exps)
    for name, r in res.items():
        assert (tmp_path / f"{name}.json").exists()
        assert r["steps"] == 3 and r["sweep_size"] == 2
        assert np.isfinite(r["loss_mean_tasks"]).all()
        assert len(r["tasks"]) == N and r["sigma2"] == [0.5, 1.0, 1.0]
    assert res["a_equal"]["p_mean"][-1] == [1.0, 1.0]
    assert paper_common.run_sweep(exps, **kw) == json.loads(json.dumps(res))
    assert "a_fgn" in paper_common.summarize(res, "smoke")


def test_runners_raise_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(paper_common, "RESULTS_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fig4_diverse_sigma.run(steps=1, force=True)
    _, sim = _sims()
    assert sim.device.type == "cpu"


def test_runner_command_line():
    """``python -m repro_torch.experiments.<fig> [steps] [flags]`` hands
    its steps, engine flags and device to the runner."""
    seen = {}

    def fake_run(**kw):
        seen.update(kw)
        return "done"
    argv = ["20", "--streaming", "--sectioned", "--max-section-rows", "64",
            "--device", "cpu", "--force"]
    assert paper_common.main(fake_run, argv) == "done"
    assert seen == dict(steps=20, force=True, ota_streaming=True,
                        ota_sectioned=True, max_section_rows=64,
                        device="cpu")
    paper_common.main(fake_run, [])
    assert seen == dict(steps=800, force=False, ota_streaming=False,
                        ota_sectioned=False, max_section_rows=0,
                        device="cuda")
