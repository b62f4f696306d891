"""The harness drives each cell end to end (on the CPU, at a small size)
and prints the contract's result line; a run that finds no card fails
and prints no result, as does one in a checkout without the program."""
import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from bench.lib import harness
from bench.tests.cells import ROOT, small_cell

TOP_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload", ["mlp-fig4-c100", "sc2-repo-prefill",
                                      "sc2-chat-batch"])
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_has_the_contract_keys(workload, trace):
    cell = small_cell(workload)
    result, checks = harness.execute(cell, 2 ** 31 + 17, 0.3, bool(trace),
                                     torch.device("cpu"),
                                     time.perf_counter())
    keys = list(result)
    assert keys[:5] == TOP_KEYS and keys[-1] == "checks"
    assert set(keys) == set(TOP_KEYS) | {"checks"} | (
        {"breakdown"} if trace else set())
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] > 0
    dev = result["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    want = ({m["name"] for m in cell.per_layer} if trace
            else {m["name"] for m in cell.end_to_end})
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        got = set(result["metrics"])
        # on the CPU no device op is traced: the device readers stay silent
        assert got <= want and got
    else:
        assert set(result["metrics"]) == want
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(result["checks"]) == set(checks) == set(cell.traffic["limits"])
    json.dumps(result)


def _run(cwd, workload="mlp-fig4-c100"):
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", workload, "--seed",
         "7", "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True,
        text=True, timeout=300, env={"PATH": "/usr/bin:/bin",
                                     "CUDA_VISIBLE_DEVICES": ""})


def _no_result(out):
    lines = out.stdout.strip().splitlines()
    return not lines or not lines[-1].startswith("{")


def test_run_without_a_card_fails():
    out = _run(ROOT)
    assert out.returncode != 0 and _no_result(out)
    assert "no CUDA device" in out.stderr


def test_run_in_a_checkout_of_only_the_benchmark_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and _no_result(out)
    assert "not in this checkout" in out.stderr
