"""The run of one cell: set-up, the measured window, the comparison with
the plain reference, and the result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

A cell's driver (``bench/drivers/<driver>.py``, named by its
configuration) builds the inputs from the seed, the program and its
warm-up (``setup``), runs the closed loop for the window (``window``),
reports its end-to-end numbers and the counts the per-layer readers take,
frees the program's state (``release``) and compares what the timed path
produced with the reference (``check``: name -> (value, limit)). With
``--trace 1`` the window runs under ``torch.profiler`` for at most
``TRACE_SECONDS`` and the line carries the per-layer metrics,
the device's busy seconds and a breakdown; with ``--trace 0`` it carries
the end-to-end metrics. The result is the last line of standard output;
the compared numbers with their limits are the last lines of standard
error and the last key of the line.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import subprocess
import sys
import time
from types import SimpleNamespace
from typing import Dict, List

from bench.lib import peaks, registry
from bench.lib.trace import DeviceTrace, Spans

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")
TRACE_SECONDS = 4.0      # the longest traced window: its trace stays small


def parse(argv: List[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_loaded() -> List[str]:
    """Top-level names of loaded modules that the port's run must not load
    (compared whole: ``repro_torch`` is not ``repro``)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def _card_info() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main(argv: List[str], t_start: float) -> int:
    args = parse(argv)
    cell = registry.Cell(registry.load_benchmark(), args.workload)
    if importlib.util.find_spec("repro_torch") is None:
        print("bench: the program (src/repro_torch) is not in this checkout",
              file=sys.stderr)
        return 3
    import torch
    if not torch.cuda.is_available():
        print("bench: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"bench: {cell.name} needs {cell.chips} devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    print(f"bench: card {_card_info()}", file=sys.stderr)
    torch.set_num_threads(1)
    result, checks = execute(cell, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda", 0), t_start)
    bad = forbidden_loaded()
    if bad:
        print(f"bench: modules {bad} were loaded by the run", file=sys.stderr)
        return 4
    for name, (value, limit) in checks.items():
        print(f"check {name} = {value!r} (limit {limit!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


def execute(cell, seed: int, seconds: float, trace: bool, device,
            t_start: float):
    """One run of ``cell`` on ``device``: returns (result line dict,
    checks)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = device.type == "cuda"
    spans = Spans()
    run = cell.driver().make(cell, seed, device, spans)
    run.setup()
    if on_card:
        torch.cuda.synchronize(device)
    dtrace = None
    spans.times.clear()
    if trace:
        window = min(seconds, TRACE_SECONDS)
        setup_s = time.perf_counter() - t_start
        spans.tracing = True
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else [])
        with profile(activities=acts) as prof:
            with record_function("bench.window"):
                run.window(window)
        spans.tracing = False
        dtrace = DeviceTrace.from_profiler(prof)
        del prof
        for name, sec in dtrace.top_ops(40):
            print(f"trace op {sec:.6f} s  {name[:160]}", file=sys.stderr)
    else:
        setup_s = time.perf_counter() - t_start
        run.window(seconds)
    if on_card:
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
    else:
        peak = 0
    e2e = dict(run.end_to_end())
    e2e["setup_s"] = setup_s
    inputs = run.layer_inputs()
    attempted, failed = run.attempted, run.failed
    run.release()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = run.check()
    print(f"bench: setup {setup_s:.1f} s, comparison with the reference "
          f"{time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    correct = (attempted > 0 and failed == 0 and all(
        math.isfinite(v) and v <= lim for v, lim in checks.values()))
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card
           else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(failed)}
    if trace:
        ctx = SimpleNamespace(trace=dtrace, spans=dict(spans.times),
                              counts=inputs, cost=cell.cost(),
                              config=cell.config, traffic=cell.traffic,
                              peaks=peaks)
        metrics = {}
        for entry, reader in cell.metric_readers():
            value = reader.read(ctx)
            if value is not None:
                metrics[entry["name"]] = {"value": float(value),
                                          "unit": entry["unit"]}
        dev["busy_s"] = dtrace.busy_s
        dev["window_s"] = dtrace.window_s
        result["metrics"] = metrics
        result["device"] = dev
        result["breakdown"] = {"device_ops": dtrace.top_ops(10),
                               "idle_gaps": dtrace.idle_gaps(10)}
    else:
        result["metrics"] = {m["name"]: {"value": float(e2e[m["name"]]),
                                         "unit": m["unit"]}
                             for m in cell.end_to_end}
        result["device"] = dev
    result["checks"] = {k: {"value": v if math.isfinite(v) else None,
                            "limit": lim} for k, (v, lim) in checks.items()}
    return result, checks


def limits(cell) -> Dict[str, float]:
    """The traffic's limit of each compared number."""
    return {k: float(v) for k, v in cell.traffic["limits"].items()}
