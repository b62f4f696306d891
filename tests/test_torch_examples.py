"""The port's two examples against the JAX package's computations.

- ``experiments.serve_batched`` (``examples/serve_batched.py``) on the
  starcoder2 (dense) and zamba2 (hybrid) smoke configs at batch 2, a
  16-token prompt and 4 new tokens: the prompt equal to the example's
  ``randint(fold_in(key, 1), ...)`` bit for bit, the prefill logits within
  rtol 1e-4 (atol 1e-5) of the example's jitted prefill on the weights of
  its keys (``fold_in(key, 7)`` and ``fold_in(key, 9)``: drawn by each
  package, so they differ by the last-place ``erfinv`` rounding), and the
  greedy tokens equal to the example's jitted decode loop. The port
  serves with ``attn_impl="pallas"`` (K8's plain version here), the
  example with its smoke config's ``blocked`` attention;
- ``experiments.quickstart``: ``main`` for 3 rounds and ``sweep``'s
  3-scenario bank for 2 rounds against the reference's ``HotaSim`` and
  ``ScenarioBank`` at the example's settings (C=4, N=3, batch 32,
  FedGradNorm, γ=0.6, α=8e-3, lr 3e-4, the same keys and batches), cut to
  1,000 data points for the CPU's time: per-round loss and p within rtol
  1e-4, the final ω within relative L2 1e-4. ``main`` runs the Table-I
  MLP; the bank, three times its work, runs a narrow MLP (32, 64, 128,
  64, 32, 16), its setup monkeypatched on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.model as jmodel
from repro.common.config import FLConfig as JFL
from repro.common.config import ModelConfig as JMC
from repro.common.config import TrainConfig as JTC
from repro.configs import get_smoke_config as jget_smoke
from repro.core.sim import HotaSim as JSim
from repro.core.sweep import ScenarioBank as JBank
from repro.data.federated import FederatedBatcher as JBatcher
from repro.data.radcom import (
    N_CLASSES, TASKS, RadComConfig, client_partition, make_radcom_dataset,
)
from repro.launch.steps import make_decode_step, make_prefill_step
from repro.models.params import init_params as jinit
from repro_torch import rng
from repro_torch.common.config import ModelConfig, TrainConfig
from repro_torch.common.tree import tree_leaves
from repro_torch.core.sim import HotaSim
from repro_torch.data.federated import FederatedBatcher
from repro_torch.experiments import quickstart, serve_batched
from repro_torch.models.model import build_model
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

RTOL = 1e-4
DIMS = (32, 64, 128, 64, 32, 16)
N_POINTS = 1000


@pytest.fixture(autouse=True, scope="module")
def _same_threefry_mode():
    prev = rng.set_threefry_partitionable(
        bool(jax.config.jax_threefry_partitionable))
    yield
    rng.set_threefry_partitionable(prev)


def _example_serve(arch, batch, prefill_len, new_tokens):
    """``examples/serve_batched.py``'s computation: (prompts, prefill
    logits, greedy tokens)."""
    cfg = jget_smoke(arch)
    model = jmodel.build_model(cfg)
    key = jax.random.PRNGKey(0)
    backbone = {"trunk": jinit(model.trunk_specs(), key),
                "final": jinit(model.final_specs(),
                               jax.random.fold_in(key, 7))}
    head = jinit(model.head_specs(), jax.random.fold_in(key, 9))
    prefill = jax.jit(make_prefill_step(
        model, cache_len=prefill_len + new_tokens + 1))
    decode = jax.jit(make_decode_step(model))
    prompts = jax.random.randint(jax.random.fold_in(key, 1),
                                 (batch, prefill_len), 0, cfg.vocab_size)
    logits, cache = prefill(backbone, head, prompts)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    pos = jnp.full((batch,), prefill_len, jnp.int32)
    out = [tok]
    for _ in range(new_tokens - 1):
        tok, _, cache = decode(backbone, head, cache, tok[:, None], pos)
        out.append(tok)
        pos = pos + 1
    return (np.asarray(prompts), np.asarray(logits),
            np.stack([np.asarray(t) for t in out], 1))


@pytest.mark.parametrize("arch", ["starcoder2-3b", "zamba2-1.2b"])
def test_serve_batched_matches_the_example(arch, capsys):
    from repro.configs import ALIASES
    batch, prefill_len, new = 2, 16, 4
    prompts, logits, tokens = _example_serve(ALIASES[arch], batch,
                                             prefill_len, new)
    res = serve_batched.main(["--arch", arch, "--device", "cpu", "--batch",
                              str(batch), "--prefill-len", str(prefill_len),
                              "--new-tokens", str(new)])
    cfg = jget_smoke(ALIASES[arch])
    assert np.array_equal(serve_batched.example_prompt(
        cfg, batch, prefill_len, 0).numpy(), prompts)
    np.testing.assert_allclose(res.prefill_logits.numpy(), logits,
                               rtol=RTOL, atol=1e-5)
    assert np.array_equal(res.tokens.numpy(), tokens)
    out = capsys.readouterr().out
    assert f"| batch={batch} prefill={prefill_len} ==" in out
    assert f"decode: {new - 1} tokens x {batch} reqs in" in out
    assert "  req1: " in out


def _jax_quickstart(steps):
    """``examples/quickstart.py``'s ``main`` at the test's cut."""
    data = make_radcom_dataset(RadComConfig(n_points=N_POINTS))
    batcher = JBatcher(client_partition(data, n_clusters=4, n_clients=3),
                       batch=32)
    n_cls = [N_CLASSES[TASKS[i % 3]] for i in range(3)]
    fl = JFL(n_clusters=4, n_clients=3, weighting="fedgradnorm",
             h_threshold=3.2e-2, noise_std=1.0, gamma=0.6, alpha=8e-3)
    sim = JSim(jmodel.Model(JMC(family="mlp")), fl, JTC(lr=3e-4), n_cls)
    state = sim.init(jax.random.PRNGKey(0))
    ms = []
    for step in range(steps):
        x, y = batcher.next_stacked()
        state, m = sim.step(state, jnp.asarray(x), jnp.asarray(y),
                            jax.random.PRNGKey(step))
        ms.append({k: np.asarray(v) for k, v in m.items()})
    return ms, state


def _rel_l2(got, want):
    got = np.concatenate([np.ravel(x) for x in got])
    want = np.concatenate([np.ravel(x) for x in want])
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_quickstart_matches_the_reference(capsys):
    want, jstate = _jax_quickstart(3)
    got = quickstart.main(3, "cpu", N_POINTS)
    for g, w in zip(got, want):
        for k in ("loss", "p"):
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL)
    omega = got[-1]["state"].omega
    assert _rel_l2([t.numpy() for t in tree_leaves(omega)],
                   jax.tree.leaves(jstate.omega)) < RTOL
    out = capsys.readouterr().out
    assert "round   0 | loss per task mod=" in out
    assert "round   2 | loss per task" in out


def test_quickstart_sweep_matches_the_reference(monkeypatch, capsys):
    # the reference's paper_mlp_setup(fl, batch=32, n_points=...), its
    # features cut to the narrow MLP's input
    monkeypatch.setattr(jmodel, "PAPER_MLP_DIMS", DIMS)
    data = make_radcom_dataset(RadComConfig(n_points=N_POINTS,
                                            feature_dim=DIMS[0]))
    batcher = JBatcher(client_partition(data, 4, 3, seed=0), 32, seed=1)
    sim = JSim(jmodel.Model(JMC(family="mlp")),
               JFL(n_clusters=4, n_clients=3), JTC(lr=3e-4),
               [N_CLASSES[TASKS[i % 3]] for i in range(3)])
    bank = JBank(sim, list(quickstart.SWEEP_SCENARIOS.values()))
    states = bank.init(jax.random.PRNGKey(0))
    _, want = bank.run(states, (batcher.next_stacked() for _ in range(2)),
                       [jax.random.PRNGKey(s) for s in range(2)])

    def narrow_setup(fl, batch, n_points, device):
        """``paper_mlp_setup``'s construction at the narrow MLP."""
        data = make_radcom_dataset(RadComConfig(n_points=n_points,
                                                feature_dim=DIMS[0]))
        parts = client_partition(data, fl.n_clusters, fl.n_clients, seed=0)
        return HotaSim(build_model(ModelConfig(family="mlp"), DIMS), fl,
                       TrainConfig(lr=3e-4),
                       [N_CLASSES[TASKS[i % 3]] for i in range(3)],
                       device=device), FederatedBatcher(parts, batch, seed=1)
    monkeypatch.setattr(quickstart, "paper_mlp_setup", narrow_setup)
    got = quickstart.sweep(2, "cpu", N_POINTS)
    for k in ("loss", "p"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=RTOL)
    out = capsys.readouterr().out
    for lbl in quickstart.SWEEP_SCENARIOS:
        assert f"  scenario {lbl:12s} mean loss after 2 rounds:" in out
