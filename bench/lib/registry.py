"""Finds a cell's pieces by the names in ``BENCHMARK.json``.

A configuration is ``bench/configs/<config>.json`` (its ``driver`` names
``bench/drivers/<driver>.py``), a traffic mix ``bench/traffic/<traffic>
.json``, a per-layer metric ``bench/metrics/<metric>.py`` and a
configuration's closed-form work counts ``bench/cost/<config>.py``. A
later cell, metric or configuration is a new file and a new entry; no
file here names one.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    return json.loads(path.read_text())


def load_module(path: Path, name: str) -> ModuleType:
    """The Python file at ``path`` as a module (file names may hold '-'
    and '.', which an import statement cannot name)."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of the benchmark with everything it names."""

    def __init__(self, bench: Dict[str, Any], workload: str,
                 bench_dir: Path = BENCH_DIR):
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"unknown workload {workload!r}; known: "
                           f"{sorted(cells)}")
        self.workload = cells[workload]
        self.name = workload
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = json.loads(
            (bench_dir.parent / self.config_entry["file"]).read_text())
        self.traffic_name = self.workload["traffic"]
        self.traffic = json.loads(
            (bench_dir / "traffic" / f"{self.traffic_name}.json").read_text())
        self.chips = int(self.workload["chips"])
        self.end_to_end = [m for m in bench["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        self.per_layer = [m for m in bench["per_layer"]
                          if workload in m["workloads"]]
        self.bench_dir = bench_dir

    def driver(self) -> ModuleType:
        name = self.config["driver"]
        return load_module(self.bench_dir / "drivers" / f"{name}.py",
                           f"bench_driver_{name}")

    def cost(self) -> ModuleType:
        name = self.config_entry["name"]
        return load_module(self.bench_dir / "cost" / f"{name}.py",
                           f"bench_cost_{name}")

    def metric_readers(self) -> List:
        """(metric entry, its module) for each per-layer metric of the
        cell."""
        return [(m, load_module(self.bench_dir / "metrics" / f"{m['name']}.py",
                                "bench_metric_" + m["name"].replace(".", "_")))
                for m in self.per_layer]
