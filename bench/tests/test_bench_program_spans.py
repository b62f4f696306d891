"""The readers of the program's spans (``bench/lib/program_spans.py`` and
the ten metrics that use it).

- On hand-built traces (known device ops and host ranges) each reader
  gives the value worked out by hand: sums per scenario round, the median
  per request, idle time at the window's edges and across back-to-back
  ops, stall counts, None with no device op, and None from a program
  without spans.
- On the small CPU cells a traced ``harness.execute`` reports the six
  host-time metrics; the four phases of a round sum to no more than
  ``step_enqueue_ms.sim``; in every request the attention and MLP spans
  lie inside the request's ``repro.prefill`` and take no more than it;
  and every ``repro.*`` range lies inside the ``bench.*`` range of the
  call that made it, in the same trace.
"""
import statistics
import time
from types import SimpleNamespace

import pytest
import torch

from bench.lib import harness, program_spans, registry
from bench.lib.trace import DeviceTrace
from bench.tests.cells import small_cell

SIM = ["client_update_ms.sim", "fgn_ms.sim", "ota_aggregate_ms.sim",
       "adam_ms.sim", "batcher_idle_share.sim", "host_stalls.sim"]
SERVE = ["attn_ms.serve", "mlp_ms.serve", "attn_idle_share.serve",
         "host_stalls.serve"]
HOST_TIME = {"sim": SIM[:4], "serve": SERVE[:2]}
DEVICE_READ = {"batcher_idle_share.sim", "host_stalls.sim",
               "attn_idle_share.serve", "host_stalls.serve"}


def reader(name):
    return registry.load_module(registry.BENCH_DIR / "metrics" / f"{name}.py",
                                "test_metric_" + name.replace(".", "_"))


def sim_trace(ops=True):
    """Window 1000-11000 ns; two scenario rounds in one bank step."""
    host = [("bench.window", 1000, 11000),
            ("repro.data.next_stacked", 1000, 3500),
            ("repro.bank.step", 3500, 10800),
            ("repro.sim.round", 3600, 6000),
            ("repro.sim.client_update", 3600, 4200),
            ("repro.sim.fgn", 4200, 4500),
            ("repro.sim.aggregate", 4500, 5200),
            ("repro.sim.adam", 5200, 5900),
            ("cudaStreamSynchronize", 5000, 5100),
            ("repro.sim.round", 6000, 10700),
            ("repro.sim.client_update", 6000, 7000),
            ("cudaMalloc", 7000, 7050),
            ("repro.sim.fgn", 7000, 7100),
            ("cudaLaunchKernel", 7100, 7110),
            ("repro.sim.aggregate", 7100, 8000),
            ("repro.sim.adam", 8000, 10600),
            ("cudaDeviceSynchronize", 10900, 10950),      # outside the step
            ("repro.sim.client_update", 11500, 12500)]    # outside the window
    dev = [("k", 500, 2000), ("k", 3000, 4000), ("k", 4000, 5000),
           ("k", 10500, 12000)] if ops else []
    return DeviceTrace(dev, host, (1000, 11000))


def serve_trace(ops=True):
    """Window 0-10000 ns; three requests of two layers."""
    host = [("bench.window", 0, 10000),
            ("repro.prefill", 100, 4000),
            ("repro.tf.attn", 200, 1000), ("repro.tf.mlp", 1000, 1500),
            ("cudaStreamSynchronize", 2000, 2100),
            ("repro.tf.attn", 1500, 2500), ("repro.tf.mlp", 2500, 3900),
            ("repro.prefill", 5000, 9000),
            ("repro.tf.attn", 5100, 5500), ("repro.tf.mlp", 5500, 6000),
            ("cudaFree", 5600, 5700), ("cudaEventSynchronize", 7000, 7100),
            ("repro.tf.attn", 6000, 6200), ("repro.tf.mlp", 6200, 8000),
            ("repro.prefill", 9100, 9900),
            ("repro.tf.attn", 9200, 9300), ("repro.tf.mlp", 9300, 9400),
            ("cudaMemcpyAsync", 9400, 9450)]
    dev = [("k", -50, 150), ("k", 300, 800), ("k", 800, 900),
           ("k", 5200, 5300), ("k", 9950, 10100)] if ops else []
    return DeviceTrace(dev, host, (0, 10000))


def ctx(trace, **counts):
    return SimpleNamespace(trace=trace, counts=counts, spans={})


SIM_WANT = {
    # ns per scenario round over 2 rounds, in ms
    "client_update_ms.sim": (600 + 1000) / 2 * 1e-6,
    "fgn_ms.sim": (300 + 100) / 2 * 1e-6,
    "ota_aggregate_ms.sim": (700 + 900) / 2 * 1e-6,
    "adam_ms.sim": (700 + 2600) / 2 * 1e-6,
    # inside the batcher 1000-3500: busy 1000-2000 (an op clipped at the
    # window's start) and 3000-3500, idle 1000 of the window's 10000
    "batcher_idle_share.sim": 10.0,
    # a synchronize and a malloc inside the one bank step
    "host_stalls.sim": 2.0,
}
SERVE_WANT = {
    # per request: attention 1800, 600, 100 ns; MLP 1900, 2300, 100 ns
    "attn_ms.serve": 600e-6,
    "mlp_ms.serve": 1900e-6,
    # idle inside attention: 200 (ops 300-800-900 back to back), 1000,
    # 300, 200, 100 of 10000
    "attn_idle_share.serve": 18.0,
    # a synchronize; a free and a synchronize; none: 3 over 3 requests
    "host_stalls.serve": 1.0,
}


@pytest.mark.parametrize("name", SIM)
def test_sim_readers_on_a_hand_built_trace(name):
    got = reader(name).read(ctx(sim_trace(), scenario_rounds=2))
    assert got == pytest.approx(SIM_WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", SERVE)
def test_serve_readers_on_a_hand_built_trace(name):
    got = reader(name).read(ctx(serve_trace()))
    assert got == pytest.approx(SERVE_WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", SIM + SERVE)
def test_without_device_ops_only_the_host_readers_read(name):
    trace = sim_trace(ops=False) if name in SIM else serve_trace(ops=False)
    got = reader(name).read(ctx(trace, scenario_rounds=2))
    if name in DEVICE_READ:
        assert got is None
    else:
        want = SIM_WANT.get(name, SERVE_WANT.get(name))
        assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", SIM + SERVE)
def test_a_program_without_spans_reads_nothing(name):
    """The parent's program marks no ``repro.*`` range: every reader
    returns None and raises nothing."""
    trace = sim_trace() if name in SIM else serve_trace()
    trace.host = [h for h in trace.host if not h[0].startswith("repro.")]
    assert reader(name).read(ctx(trace, scenario_rounds=2)) is None


def test_stall_names():
    for name in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                 "cudaEventSynchronize", "cudaMalloc", "cudaFree"):
        assert program_spans.is_stall(name), name
    for name in ("cudaLaunchKernel", "cudaMemcpyAsync", "cuLaunchKernel",
                 "cudaStreamIsCapturing", "aten::synchronize",
                 "repro.sim.fgn"):
        assert not program_spans.is_stall(name), name


def _traced_execute(workload, monkeypatch):
    """A traced run of the small CPU cell; returns the result line and
    the ``DeviceTrace`` its readers read."""
    kept = []
    build = DeviceTrace.from_profiler

    def keep(prof):
        kept.append(build(prof))
        return kept[-1]
    monkeypatch.setattr(harness.DeviceTrace, "from_profiler", keep)
    result, _ = harness.execute(small_cell(workload), 2 ** 31 + 29, 0.4,
                                True, torch.device("cpu"),
                                time.perf_counter())
    assert result["correct"] is True and len(kept) == 1
    return result, kept[0]


def _caller_holds(trace, caller, name):
    """Every ``name`` range lies inside a ``caller`` range."""
    outer = sorted((s, e) for n, s, e in trace.host if n == caller)
    inner = [(s, e) for n, s, e in trace.host if n == name]
    assert inner
    assert sum(len(k) for k in program_spans.inside(outer, inner)) == len(
        inner)


def test_traced_bank_cell_reads_its_phases(monkeypatch):
    result, trace = _traced_execute("mlp-fig4-c100", monkeypatch)
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(HOST_TIME["sim"]) <= set(m)
    assert all(m[k] > 0 for k in HOST_TIME["sim"])
    assert sum(m[k] for k in HOST_TIME["sim"]) <= m["step_enqueue_ms.sim"]
    _caller_holds(trace, "bench.batch", "repro.data.next_stacked")
    _caller_holds(trace, "bench.step", "repro.bank.step")
    _caller_holds(trace, "repro.bank.step", "repro.sim.round")
    for phase in ("client_update", "fgn", "aggregate", "adam"):
        _caller_holds(trace, "repro.sim.round", "repro.sim." + phase)


@pytest.mark.parametrize("workload", ["sc2-repo-prefill", "sc2-chat-batch"])
def test_traced_serve_cell_reads_its_layers(workload, monkeypatch):
    result, trace = _traced_execute(workload, monkeypatch)
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(HOST_TIME["serve"]) <= set(m)
    _caller_holds(trace, "bench.step", "repro.prefill")
    reqs = program_spans.ranges(trace, "repro.prefill")
    assert reqs
    attn = program_spans.per_parent_s(trace, "repro.prefill", "repro.tf.attn")
    mlp = program_spans.per_parent_s(trace, "repro.prefill", "repro.tf.mlp")
    n_layers = small_cell(workload).config["n_layers"]
    for (s, e), kids in zip(reqs, program_spans.inside(
            reqs, [(s, e) for n, s, e in trace.host
                   if n in ("repro.tf.attn", "repro.tf.mlp")])):
        assert len(kids) == 2 * n_layers
    for (s, e), a, f in zip(reqs, attn, mlp):
        assert 0 < a + f <= (e - s) * 1e-9
    assert m["attn_ms.serve"] == pytest.approx(statistics.median(attn) * 1e3)
    assert m["mlp_ms.serve"] == pytest.approx(statistics.median(mlp) * 1e3)
