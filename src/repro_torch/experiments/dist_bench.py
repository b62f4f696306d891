"""Distributed-step benchmark: the slab engine, the per-leaf oracle and the
sectioned schedule (DESIGN.md §3.10, §3.16).

Port of ``benchmarks/dist_bench.py``'s slab and per-leaf rows, with a
sectioned row. Each row times the full Algorithm-1 round of
``core.hota_step.make_hota_train_step`` on the ranks of
``launch.mesh.run_ranks`` (a 2 clusters × 2 clients mesh; on one card the
four ranks share it over gloo):

* ``slab``: ``use_pallas_ota=True``, the whole model in one multi-section
  slab gather, one kernel per leaf in place (K6 in count mode "local",
  K5 in "psum"), the slab Adam;
* ``perleaf_scatter`` / ``perleaf_naive``: ``use_pallas_ota=False``, the
  oracle: a gather per leaf, Gaussian gains and AWGN per leaf from the
  stream kernel, three collectives per leaf (``ota_mode`` "scatter"
  reduce-scatters the LAN sum into client regions, "naive" sums at full
  size), the tree Adam;
* ``sectioned``: the slab engine walking the layout's sections
  (``ota_sectioned=True``), the same values one section at a time;
* ``bank_S4_paperMLP_step`` (``bank_row``): the reference's bank row, a
  ``DistScenarioBank`` of its four scenarios (σ² 0.5, σ² 2, equal
  weighting, OTA off) on 2 scenario rows × (1 cluster × 2 clients), its
  own world of four ranks: each rank steps its row's two scenarios one
  after the other, so a bank step runs every collective of the step
  twice per rank.

Per row: the step's host time barrier to barrier (every rank
synchronized, the median over ``steps``), one more step split by
``MeshStats`` into collectives, stream draws (on the per-leaf rows, the
gain and mask draw) and the rest, and each rank's peak device memory.
The Table-I MLP at full width, 24 examples per client::

    PYTHONPATH=src python -m repro_torch.experiments.dist_bench
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch import rng
from repro_torch.common.config import FLConfig, ModelConfig, TrainConfig
from repro_torch.common.device import resolve_device

SHAPE = (2, 2)              # (cluster, client)
BATCH = 24                  # examples per client
N_OUT = 8                   # head width
SEED = 0
ENGINES = {
    "slab": {},
    "perleaf_scatter": dict(use_pallas_ota=False, ota_mode="scatter"),
    "perleaf_naive": dict(use_pallas_ota=False, ota_mode="naive"),
    "sectioned": dict(ota_sectioned=True),
}
BANK_SHAPE = (2, 1, 2)      # (scenario, cluster, client)
BANK_SCENARIOS = [dict(sigma2=(0.5,)), dict(sigma2=(2.0,)),
                  dict(weighting="equal"), dict(ota=False)]


def _sync(mesh) -> None:
    import torch.distributed as dist
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    dist.barrier()


def _bench_rank(mesh, steps: int):
    """One rank: per engine, a warm-up step, ``steps`` timed steps and one
    step under ``MeshStats``."""
    from repro_torch.core.hota_step import make_hota_train_step
    from repro_torch.models.model import build_model
    dev = mesh.device
    model = build_model(ModelConfig(family="mlp", compute_dtype="float32"))
    x, y = _rank_batch(mesh, model)
    keys = [rng.fold_in(rng.PRNGKey(SEED), s) for s in range(steps + 2)]
    out = {}
    for name, kw in ENGINES.items():
        fl = FLConfig(n_clusters=mesh.shape["cluster"],
                      n_clients=mesh.shape["client"], noise_std=0.1,
                      tau_h=1, **kw)
        init_fn, step_fn, _, _ = make_hota_train_step(
            model, mesh, fl, TrainConfig(lr=1e-3), loss_kind="cls",
            n_out=N_OUT)
        st = init_fn(rng.PRNGKey(SEED))
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        st, times, rec, m = _timed_steps(
            mesh, lambda st, k: step_fn(st, x, y, k), st, keys, steps)
        out[name] = dict(rec, step_ms=times, loss=float(m["loss"]),
                         peak_bytes=(torch.cuda.max_memory_allocated(dev)
                                     if dev.type == "cuda" else None))
    return out


def _rank_batch(mesh, model):
    """This rank's examples of the global (C, N, BATCH) batch."""
    c, n = mesh.shape["cluster"], mesh.shape["client"]
    r = np.random.default_rng(SEED)
    x = r.standard_normal((c, n, BATCH, model.dims[0])).astype(np.float32)
    y = r.integers(0, N_OUT, (c, n, BATCH))
    i, j = mesh.coords["cluster"], mesh.coords["client"]
    return x[i, j], y[i, j]


def _bank_rank(mesh, steps: int):
    """One rank of the bank row: a warm-up bank step, ``steps`` timed
    ones and one under ``MeshStats``."""
    from repro_torch.core.sweep import DistScenarioBank
    from repro_torch.models.model import build_model
    dev = mesh.device
    model = build_model(ModelConfig(family="mlp", compute_dtype="float32"))
    x, y = _rank_batch(mesh, model)
    keys = [rng.fold_in(rng.PRNGKey(SEED), s) for s in range(steps + 2)]
    fl = FLConfig(n_clusters=mesh.shape["cluster"],
                  n_clients=mesh.shape["client"], noise_std=0.1, tau_h=1)
    bank = DistScenarioBank(model, fl, TrainConfig(lr=1e-3), BANK_SCENARIOS,
                            mesh, loss_kind="cls", n_out=N_OUT)
    st = bank.init(rng.PRNGKey(SEED))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    st, times, rec, m = _timed_steps(
        mesh, lambda st, k: bank.step(st, x, y, k), st, keys, steps)
    return dict(rec, step_ms=times, loss=float(m["loss"].mean()),
                peak_bytes=(torch.cuda.max_memory_allocated(dev)
                            if dev.type == "cuda" else None))


def _timed_steps(mesh, step, st, keys, steps: int):
    """A warm-up step, ``steps`` steps barrier to barrier and one more
    under ``MeshStats``: (state, step ms, the split step's rank-0 record,
    last metrics)."""
    from repro_torch.sharding.collectives import MeshStats
    st, _ = step(st, keys[0])
    times = []
    for s in range(steps):
        _sync(mesh)
        t0 = time.perf_counter()
        st, m = step(st, keys[1 + s])
        _sync(mesh)
        times.append((time.perf_counter() - t0) * 1e3)
    mesh.stats = MeshStats()
    _sync(mesh)
    t0 = time.perf_counter()
    st, m = step(st, keys[-1])
    _sync(mesh)
    split_ms = (time.perf_counter() - t0) * 1e3
    stats, mesh.stats = mesh.stats, None
    return st, times, {"split_step_ms": split_ms,
                       "seconds": dict(stats.seconds),
                       "calls": dict(stats.calls),
                       "bytes": dict(stats.bytes)}, m


def _row(name: str, r0: Dict, peaks) -> Dict:
    """A row from rank 0's record: the step times and the split step's
    collectives, stream draws and the rest."""
    coll = r0["seconds"].get("collective", 0.0) * 1e3
    draw = r0["seconds"].get("draw", 0.0) * 1e3
    return {"name": name, "step_ms": r0["step_ms"],
            "step_ms_median": statistics.median(r0["step_ms"]),
            "split_step_ms": r0["split_step_ms"], "collective_ms": coll,
            "collective_calls": r0["calls"].get("collective", 0),
            "collective_bytes": r0["bytes"].get("collective", 0),
            "draw_ms": draw, "draw_calls": r0["calls"].get("draw", 0),
            "rest_ms": r0["split_step_ms"] - coll - draw,
            "loss": r0["loss"], "peak_bytes_per_rank": peaks}


def dist_rows(device="cuda", steps: int = 5) -> List[Dict]:
    """The benchmark's rows, one dict per engine of ``ENGINES``: ``name``,
    ``step_ms`` (rank 0's view, barrier to barrier), ``step_ms_median``,
    ``split_step_ms`` and its split (``collective_ms``,
    ``collective_calls``, ``collective_bytes``, ``draw_ms``,
    ``draw_calls``, ``rest_ms``), the last step's ``loss`` and
    ``peak_bytes_per_rank``. The slab rows count |M| in the device's
    default mode ("local" on the card). On the card the kernels are
    built before the ranks start."""
    from repro_torch.launch.mesh import run_ranks
    dev = resolve_device(device)
    if dev.type == "cuda":
        from repro_torch.kernels import _build
        _build.library()
    res = run_ranks(_bench_rank, (steps,), shape=SHAPE, device=dev.type,
                    timeout_s=900)
    return [_row(f"dist_{name}", res[0][name],
                 [r[name]["peak_bytes"] for r in res]) for name in ENGINES]


def bank_row(device="cuda", steps: int = 5) -> Dict:
    """The bank row (``dist_bank_S4_paperMLP_step``), as ``dist_rows``'s
    rows, with ``ms_per_scenario``: the bank step over the scenarios."""
    from repro_torch.launch.mesh import run_ranks
    dev = resolve_device(device)
    if dev.type == "cuda":
        from repro_torch.kernels import _build
        _build.library()
    res = run_ranks(_bank_rank, (steps,), shape=BANK_SHAPE,
                    axes=("scenario", "cluster", "client"), device=dev.type,
                    timeout_s=900)
    row = _row(f"dist_bank_S{len(BANK_SCENARIOS)}_paperMLP_step", res[0],
               [r["peak_bytes"] for r in res])
    row["ms_per_scenario"] = row["step_ms_median"] / len(BANK_SCENARIOS)
    return row


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)
    for row in dist_rows(device=args.device, steps=args.steps):
        print(json.dumps(row))
    print(json.dumps(bank_row(device=args.device, steps=args.steps)))


if __name__ == "__main__":
    main()
