"""The benchmark finds every cell, configuration, traffic mix, metric
and work count by name from files, and ``BENCHMARK.json`` keeps to the
names and shapes its contract allows."""
import json
import re

import pytest

from bench.lib import registry
from bench.tests.cells import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(workload):
    cell = registry.Cell(BENCH, workload)
    assert cell.config["name"] == cell.workload["config"]
    assert callable(cell.driver().make)
    assert cell.cost().__doc__
    assert "limits" in cell.traffic
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    readers = cell.metric_readers()
    assert readers
    for entry, mod in readers:
        assert callable(mod.read) and entry["moves"] in names


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        registry.Cell(BENCH, "no-such-cell")


def test_benchmark_names_and_files():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for entry in (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
                  + BENCH["per_layer"]):
        assert NAME.match(entry["name"]), entry["name"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith(BENCH["paths"][0] + "/")
    for w in BENCH["workloads"]:
        assert (ROOT / "bench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["per_layer"]:
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").is_file()
        assert m["workloads"]       # a per-layer metric names its cells
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
