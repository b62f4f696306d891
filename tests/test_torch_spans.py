"""The port's program spans (``repro_torch.common.spans``).

- with no profiler running, ``span`` returns one shared no-op context;
- under ``torch.profiler`` (CPU activity) a 4-scenario bank round at a
  tiny width records the batcher's, the bank's, each scenario round's
  and its four phases' ranges, nested and in order;
- a 2-layer prefill records one ``repro.prefill`` holding each layer's
  ``repro.tf.attn`` and ``repro.tf.mlp``;
- the bank's states and metrics, the batches and the prefill's logits
  and cache are bit for bit the same with the profiler on and off;
- ``device_work`` keeps a profile's kernels and copies and leaves out
  host ranges and their device-side copies.
"""
from contextlib import nullcontext
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import rng
from repro_torch.common.config import FLConfig, ModelConfig, TrainConfig
from repro_torch.common.spans import device_work, span
from repro_torch.common.tree import state_map
from repro_torch.core.sim import HotaSim
from repro_torch.core.sweep import ScenarioBank
from repro_torch.data import radcom
from repro_torch.data.federated import FederatedBatcher
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models.model import build_model
from repro_torch.models.params import init_params

DIMS = (8, 16, 16, 8)
C, N, B = 2, 3, 4
SPECS = [dict(weighting=w, sigma2=(s1, 0.75))
         for s1 in (2.0, 0.25) for w in ("fedgradnorm", "equal")]
PHASES = ["repro.sim.client_update", "repro.sim.fgn", "repro.sim.aggregate",
          "repro.sim.adam"]
SIM_NAMES = {"repro.data.next_stacked", "repro.bank.step",
             "repro.sim.round", *PHASES}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ranges(prof):
    """The profile's ``repro.*`` ranges as (name, start_ns, end_ns), in
    order of their start."""
    evs = prof.profiler.kineto_results.events()
    return sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in evs if e.name().startswith("repro.")),
                  key=lambda r: r[1])


def _inside(outer, rs, name=None):
    return [r for r in rs if outer[1] <= r[1] and r[2] <= outer[2]
            and r is not outer and (name is None or r[0] == name)]


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _ranges(prof)


def test_off_is_one_shared_no_op():
    assert not torch.autograd.profiler._is_profiler_enabled
    assert span("a") is span("b")
    assert isinstance(span("a"), nullcontext)
    with span("a"), span("b"):
        pass


def _bank():
    sim = HotaSim(build_model(ModelConfig(family="mlp"), DIMS),
                  FLConfig(n_clusters=C, n_clients=N), TrainConfig(lr=3e-4),
                  [radcom.N_CLASSES[radcom.TASKS[i]] for i in range(N)],
                  device="cpu")
    bank = ScenarioBank(sim, SPECS)
    return bank, bank.init(rng.PRNGKey(0))


def _batcher():
    data = radcom.make_radcom_dataset(
        radcom.RadComConfig(n_points=200, feature_dim=DIMS[0]))
    return FederatedBatcher(radcom.client_partition(data, C, N, seed=0), B,
                            seed=1)


def _bank_round(bank, states, batcher):
    xb, yb = batcher.next_stacked()
    return xb, yb, bank.step(states, xb, yb, rng.PRNGKey(7))


def test_bank_round_spans_nest_in_order():
    bank, states = _bank()
    _, rs = _traced(lambda: _bank_round(bank, states, _batcher()))
    assert {n for n, _, _ in rs} == SIM_NAMES
    assert [n for n, _, _ in rs if n == "repro.data.next_stacked"] == [
        "repro.data.next_stacked"]
    steps = [r for r in rs if r[0] == "repro.bank.step"]
    assert len(steps) == 1
    rounds = _inside(steps[0], rs, "repro.sim.round")
    assert len(rounds) == len(SPECS)
    assert len(_inside(steps[0], rs)) == len(SPECS) * (1 + len(PHASES))
    for rnd in rounds:
        phases = _inside(rnd, rs)
        assert [n for n, _, _ in phases] == PHASES
        ends = [e for _, _, e in phases]
        starts = [s for _, s, _ in phases]
        assert all(e <= s for e, s in zip(ends, starts[1:]))


def _leaves(state):
    """Every tensor of a state (named tuples, dicts, lists)."""
    out = []
    state_map(out.append, state)
    return out


def _clone(state):
    return [t.clone() for t in _leaves(state)]


def test_bank_round_is_the_same_traced_and_not():
    bank, states = _bank()
    init = _clone(states)
    (x1, y1, (st1, m1)) = _bank_round(bank, states, _batcher())
    assert all(torch.equal(a, b) for a, b in zip(_clone(states), init))
    (x2, y2, (st2, m2)), _ = _traced(
        lambda: _bank_round(bank, states, _batcher()))
    np.testing.assert_array_equal(x1, x2)
    np.testing.assert_array_equal(y1, y2)
    assert len(_leaves(st1)) == len(_leaves(st2)) > 0
    for a, b in zip(_leaves(st1), _leaves(st2)):
        assert torch.equal(a, b)
    assert sorted(m1) == sorted(m2)
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k


def _prefill():
    cfg = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=32,
                      n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64,
                      vocab_size=128, sliding_window=8, mlp_act="gelu",
                      compute_dtype="float32")
    model = build_model(cfg)
    k_trunk, k_final, k_head, k_tok = rng.split(rng.PRNGKey(3), 4)
    backbone = {"trunk": init_params(model.trunk_specs(), k_trunk),
                "final": init_params(model.final_specs(), k_final)}
    head = init_params(model.head_specs(), k_head)
    tokens = rng.randint(k_tok, (2, 12), 0, cfg.vocab_size).to(torch.int64)
    step = make_prefill_step(model)
    return lambda: step(backbone, head, tokens)


def test_prefill_spans_hold_each_layer():
    run = _prefill()
    _, rs = _traced(run)
    assert {n for n, _, _ in rs} == {"repro.prefill", "repro.tf.attn",
                                     "repro.tf.mlp"}
    top = [r for r in rs if r[0] == "repro.prefill"]
    assert len(top) == 1
    assert [n for n, _, _ in _inside(top[0], rs)] == [
        "repro.tf.attn", "repro.tf.mlp"] * 2


def test_prefill_is_the_same_traced_and_not():
    run = _prefill()
    logits1, cache1 = run()
    (logits2, cache2), _ = _traced(run)
    assert torch.equal(logits1, logits2)
    assert len(_leaves(cache1)) == len(_leaves(cache2)) > 0
    for a, b in zip(_leaves(cache1), _leaves(cache2)):
        assert torch.equal(a, b)


def _avg(key, device, **kw):
    return SimpleNamespace(key=key, device_type=device, **kw)


def test_device_work_leaves_out_the_spans_device_copies():
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    averages = [
        _avg("k2_masked_gradnorm", cuda, is_user_annotation=False),
        _avg("Memcpy HtoD (Pageable -> Device)", cuda,
             is_user_annotation=False),
        _avg("repro.sim.round", cuda, is_user_annotation=True),
        _avg("bench.step", cuda, is_user_annotation=True),
        _avg("repro.sim.fgn", cpu, is_user_annotation=True),
        _avg("aten::mm", cpu, is_user_annotation=False),
    ]
    assert [e.key for e in device_work(averages)] == [
        "k2_masked_gradnorm", "Memcpy HtoD (Pageable -> Device)"]


def test_a_spanned_cpu_round_has_no_device_work():
    bank, states = _bank()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _bank_round(bank, states, _batcher())
    keys = {e.key for e in prof.key_averages()}
    assert SIM_NAMES <= keys
    assert device_work(prof.key_averages()) == []
