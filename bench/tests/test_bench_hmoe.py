"""The Granite-4.0-H cell (``granite-hs-rag-prefill``) on the CPU at a
small size of its own: a sound run through ``harness.execute`` is
correct, traced too, each fault of ``bench/lib/faults_hmoe.py`` makes it
not correct, and the cost file's counts equal a hand count at one
shape."""
import json
import time

import pytest
import torch

from bench.lib import faults_hmoe, harness, registry
from bench.tests.cells import ROOT

CELL = "granite-hs-rag-prefill"
SMALL_CONFIG = {
    "hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2,
    "intermediate_size": 32, "shared_intermediate_size": 48,
    "num_local_experts": 8, "num_experts_per_tok": 3, "mamba_n_heads": 8,
    "mamba_d_head": 16, "mamba_d_state": 16, "mamba_chunk_size": 16,
    "vocab_size": 512, "num_hidden_layers": 4,
    "layer_types": ["mamba", "mamba", "attention", "mamba"],
    "attention_multiplier": 1 / 16,
}
SMALL_TRAFFIC = {"length_min": 32, "length_max": 96, "length_quantum": 16,
                 "cycle": 8}
COST = registry.load_module(ROOT / "bench" / "cost" /
                            "granite-4.0-h-small.py", "cost_granite")


def small_cell():
    cell = registry.Cell(json.loads((ROOT / "BENCHMARK.json").read_text()),
                         CELL)
    cell.config = dict(cell.config, **SMALL_CONFIG)
    cell.traffic = dict(cell.traffic, **SMALL_TRAFFIC)
    return cell


def _run(trace=False):
    return harness.execute(small_cell(), 2 ** 31 + 29, 0.3, trace,
                           torch.device("cpu"), time.perf_counter())


@pytest.mark.parametrize("trace", [0, 1])
def test_sound_run_is_correct(trace):
    result, checks = _run(bool(trace))
    assert result["correct"] is True and result["attempted"] > 0, checks
    names = {m["name"] for m in small_cell().per_layer}
    if trace:
        # no device op is traced on the CPU: the device readers stay silent
        assert set(result["metrics"]) <= names and result["metrics"]
    else:
        assert set(result["metrics"]) == {"ttft_ms_p95", "tokens_per_s",
                                          "setup_s"}


@pytest.mark.parametrize("fault", sorted(faults_hmoe.FAULTS))
def test_planted_fault_is_not_correct(fault):
    with faults_hmoe.FAULTS[fault]():
        result, checks = _run()
    assert result["correct"] is False, checks


def test_cost_by_hand():
    c = json.loads((ROOT / "bench" / "configs" /
                    "granite-4.0-h-small.json").read_text())
    # 18 Mamba2 and 2 attention layers of the 20, at d 4096
    mamba = 4096 * (2 * 8192 + 2 * 128 + 128) + 8192 * 4096
    attn = 2 * 4096 * 4096 + 2 * 4096 * 1024
    moe = 4096 * 72 + 10 * 3 * 4096 * 768 + 3 * 4096 * 1536
    assert (mamba, attn, moe) == (102_236_160, 41_943_040, 113_541_120)
    seq = 2048
    gemm = 2 * ((18 * mamba + 2 * attn + 20 * moe) * seq + 4096 * 100352)
    assert COST.gemm_flops(c, 1, seq) == gemm
    assert COST.attention_flops(c, 1, seq) == \
        4 * 128 * 32 * 2 * seq * (seq + 1) // 2
    assert COST.ssd_flops(c, 1, seq) == 6 * 18 * seq * 128 * 64 * 128
    assert COST.prefill_flops(c, 1, seq) == gemm + \
        COST.attention_flops(c, 1, seq) + COST.ssd_flops(c, 1, seq)
    assert COST.routed_expert_flops(c, 1, seq) == \
        2 * seq * 10 * 3 * 4096 * 768
    assert COST.routed_expert_bytes(c, 1, seq) == \
        2 * (72 * 3 * 4096 * 768 + 2 * seq * 10 * 4096)
    # memory-bound at 2048 tokens, compute-bound at 32768
    bound = COST.expert_gemm_bound_s(c, 1, seq, 989e12, 3.35e12)
    assert bound == 20 * COST.routed_expert_bytes(c, 1, seq) / 3.35e12
    long = COST.expert_gemm_bound_s(c, 1, 32768, 989e12, 3.35e12)
    assert long == 20 * COST.routed_expert_flops(c, 1, 32768) / 989e12
    # K8 on the 2 attention layers: q and o of 32 heads, k and v of 8, at
    # D 128 in bfloat16; compute-bound at 2048 tokens
    pairs = seq * (seq + 1) // 2
    assert COST.attention_bound_s(c, 1, seq, 989e12, 3.35e12) == \
        2 * max(4 * 128 * 32 * pairs / 989e12,
                2 * seq * 128 * (2 * 32 + 2 * 8) / 3.35e12)
    assert 4 * 128 * 32 * pairs / 989e12 > \
        2 * seq * 128 * (2 * 32 + 2 * 8) / 3.35e12


@pytest.mark.parametrize("seconds, served", [(5, 5), (20, 16), (24, 24)])
def test_window_ends_at_a_cycle_end(monkeypatch, seconds, served):
    """Cycles of 8 one-second requests: a window shorter than a cycle
    ends at ``seconds``; after a whole cycle it ends at the end of the
    first cycle whose next would end past ``seconds``."""
    import types

    import numpy as np

    from bench.drivers import hybrid_moe_prefill as D
    clock = [0.0]
    monkeypatch.setattr(D, "time", types.SimpleNamespace(
        perf_counter=lambda: clock[0]))

    def request(toks):
        clock[0] += 1.0
        return {"shape": toks.shape}
    run = D.HybridMoEPrefillRun.__new__(D.HybridMoEPrefillRun)
    run.cycle = [np.zeros((1, 16 * (i + 1)), dtype=np.int64)
                 for i in range(8)]
    run.k, run._request = 0, request
    run.window(seconds)
    assert len(run.done) == served and run.elapsed == served
    if served >= 8:
        assert sorted(r["index"] for r in run.done) == \
            sorted(list(range(8)) * (served // 8))
