"""Shared runner for the paper-reproduction experiments (Figs. 2-4).

Port of ``benchmarks/paper_common.py``. Faithful setting (paper Sec. IV):
C clusters x N=3 clients, tasks (modulation-6, signal-8, anomaly-2),
synthetic RadComDynamic, Table-I MLP, γ=0.6, α=0.008, β=3e-4, Adam
everywhere, H_th=3.2e-2, z ~ N(0,1). "Epoch" on the x-axis =
EPOCH_STEPS global iterations.

Each figure runs as ONE ``ScenarioBank`` sweep (``run_sweep``): all of its
scenarios share one data stream and common random numbers. The sweep runs
on the card unless ``device="cpu"`` is asked for, on the layout the
autotuner picks for the model (``common.layout_tune``, cached per device
in ``build/layout_tune.json``) unless an engine flag is given, and writes
its JSON results under ``results/repro_torch/`` at the checkout's root
(or ``results_dir``). Each result records the sweep's settings (``run``)
and the layout it ran on; a cached result is reused only for the same
settings, so a short sweep never stands in for a longer one.

``run_sweep(..., scenario_ranks=R)`` splits the bank's scenarios over R
rank processes (``launch.mesh.run_ranks`` on a ("scenario",) mesh; on
one card the ranks share it), each running a ``ShardedScenarioBank`` of
its S/R scenarios on the same data and keys; rank 0 writes the same
results as the one-process sweep. ``make_bank`` picks the bank for the
caller's scenario mesh, as the reference's picks it for the visible
devices; a rank count that does not divide S is refused, before any
rank starts, rather than run as R copies of the whole bank.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np

from repro_torch import rng
from repro_torch.common.config import FLConfig
from repro_torch.common.device import resolve_device
from repro_torch.common.layout_tune import layout_of, tuned_fl
from repro_torch.common.tree import tree_map
from repro_torch.core.paper_setup import paper_mlp_setup
from repro_torch.core.sim import HotaSim
from repro_torch.core.sweep import (
    ScenarioBank, ShardedScenarioBank, check_scenario_split,
)
from repro_torch.data.radcom import TASKS
from repro_torch.launch.mesh import run_ranks
from repro_torch.sharding.mesh_utils import SCENARIO_AXIS, scenario_axis_size

RESULTS_DIR = str(Path(__file__).resolve().parents[3] / "results"
                  / "repro_torch")
EPOCH_STEPS = 10


def make_bank(sim, specs, mesh=None):
    """Pick the bank for a scenario list: the one-process bank without a
    scenario mesh or on a mesh of one rank, else a ``ShardedScenarioBank``
    over the mesh (the scenario axis goes on the mesh, DESIGN.md §3.8),
    which refuses a mesh whose size does not divide S."""
    if mesh is None or scenario_axis_size(mesh) == 1:
        return ScenarioBank(sim, specs)
    return ShardedScenarioBank(sim, specs, mesh)


def _scenario_result(name: str, spec: Dict, losses: np.ndarray,
                     ps: np.ndarray, steps: int, n_clients: int,
                     wall_s: float, sweep_size: int, run: Dict,
                     layout: str) -> Dict:
    """Per-scenario JSON payload from (steps, C, N) loss/p trajectories.
    ``wall_s`` is the measured wall time of the WHOLE sweep this scenario
    ran in (shared across its ``sweep_size`` scenarios — divide to
    estimate a per-scenario share). ``run`` holds the sweep's settings
    (what a cached result must match, with ``spec``) and ``layout`` the
    layout it ran."""
    return {
        "name": name,
        "spec": json.loads(json.dumps(spec)),
        "weighting": spec.get("weighting", "fedgradnorm"),
        "sigma2": list(spec.get("sigma2", ())),
        "steps": steps, "epoch_steps": EPOCH_STEPS,
        "tasks": TASKS[:n_clients],
        "loss_cluster0": losses[:, 0, :].tolist(),
        "loss_mean_tasks": losses.mean(axis=1).tolist(),
        "p_cluster0": ps[:, 0, :].tolist(),
        "p_mean": ps.mean(axis=1).tolist(),
        "final_loss_per_task": losses[-EPOCH_STEPS:].mean(axis=(0, 1)).tolist(),
        "auc_loss_per_task": losses.mean(axis=(0, 1)).tolist(),
        "wall_s": wall_s,
        "sweep_size": sweep_size,
        "run": run,
        "layout": layout,
    }


def _cached_results(paths: Dict[str, str], experiments: Dict[str, Dict],
                    run: Dict) -> Optional[Dict]:
    """The cached results of a sweep with settings ``run``, or None when
    any scenario's file is missing, unreadable, or from other settings or
    overrides."""
    out = {}
    for n, p in paths.items():
        try:
            with open(p) as f:
                out[n] = json.load(f)
        except (OSError, ValueError):
            return None
        if (out[n].get("run") != run or out[n].get("spec")
                != json.loads(json.dumps(experiments[n]))):
            return None
    return out


def _engine_name(ota_streaming: bool, ota_sectioned: bool,
                 max_section_rows: int) -> str:
    parts = [n for n, on in (("sectioned", ota_sectioned),
                             ("streaming", ota_streaming)) if on]
    return (" + ".join(parts) or "client-folded") + (
        f", max_section_rows={max_section_rows}" if max_section_rows else "")


def run_sweep(
    experiments: Dict[str, Dict],
    steps: int = 800,
    n_clusters: int = 10,
    n_clients: int = 3,
    batch: int = 24,
    seed: int = 0,
    force: bool = False,
    log_every: int = 50,
    tune: bool = True,
    ota_streaming: bool = False,
    ota_sectioned: bool = False,
    max_section_rows: int = 0,
    device="cuda",
    results_dir: Optional[str] = None,
    scenario_ranks: int = 1,
) -> Dict[str, Dict]:
    """Run ALL experiments as one ScenarioBank sweep.

    ``experiments`` maps result-name -> FLConfig channel overrides
    (``weighting``, ``sigma2``, ``noise_std``, ``ota``). Every scenario sees
    the same data stream and per-step keys (common random numbers).
    Results are cached per scenario under ``results_dir`` (default
    RESULTS_DIR) with the sweep's settings and the scenario's overrides,
    and reused only by a sweep of the same; ``force`` runs again. ``tune``
    runs the section-layout autotuner on the model's template before the
    sweep (its calibration persists per device, so
    only the first sweep on a machine pays for it). ``ota_streaming`` /
    ``ota_sectioned`` / ``max_section_rows`` select the engine for the
    whole bank (engines are static; ``HotaSim`` raises by name when a
    flag's prerequisites are off); setting any of them skips the tuner,
    which would otherwise override the explicit choice. The weights start
    from ``bank.init(rng.PRNGKey(seed))``, as the reference's sweep does,
    so a sweep of the same seed starts from the reference's weights and
    sees its data, keys and channel streams. ``scenario_ranks`` > 1 runs
    the bank on that many rank processes (see the module docstring); the
    results do not depend on it, and a count that does not divide the
    number of experiments raises before anything runs."""
    if scenario_ranks > 1:
        check_scenario_split(len(experiments), scenario_ranks)
    results_dir = results_dir or RESULTS_DIR
    os.makedirs(results_dir, exist_ok=True)
    paths = {n: os.path.join(results_dir, n + ".json") for n in experiments}
    explicit_engine = ota_streaming or ota_sectioned or bool(max_section_rows)
    run = {"steps": steps, "n_clusters": n_clusters, "n_clients": n_clients,
           "batch": batch, "seed": seed,
           "tune": bool(tune and not explicit_engine),
           "ota_streaming": bool(ota_streaming),
           "ota_sectioned": bool(ota_sectioned),
           "max_section_rows": int(max_section_rows)}
    if not force:
        cached = _cached_results(paths, experiments, run)
        if cached is not None:
            return cached

    base_fl = FLConfig(n_clusters=n_clusters, n_clients=n_clients,
                       ota_streaming=ota_streaming,
                       ota_sectioned=ota_sectioned,
                       max_section_rows=max_section_rows)
    names = list(experiments)
    specs = [dict(experiments[n]) for n in names]
    for sp in specs:
        if "sigma2" in sp:
            sp["sigma2"] = tuple(sp["sigma2"])
    args = (specs, base_fl, steps, batch, seed, log_every,
            bool(run["tune"]), explicit_engine)
    if scenario_ranks > 1:
        dev = resolve_device(device)
        if dev.type == "cuda":      # built once, before the ranks start
            from repro_torch.kernels import _build
            _build.library()
        losses, ps, wall_s, layout = run_ranks(
            _sweep, args, shape=(scenario_ranks,), axes=(SCENARIO_AXIS,),
            device=dev.type)[0]
    else:
        losses, ps, wall_s, layout = _sweep(None, *args, device=device)

    out = {}
    for s, name in enumerate(names):
        out[name] = _scenario_result(
            name, specs[s], losses[:, s], ps[:, s], steps, n_clients,
            wall_s, len(specs), run, layout)
        with open(paths[name], "w") as f:
            json.dump(out[name], f)
    return out


def _sweep(mesh, specs, base_fl, steps, batch, seed, log_every, tune,
           explicit_engine, device=None):
    """The sweep's rounds in this process: the only one (``mesh`` None),
    or a rank of a scenario mesh, whose rank 0 tunes the layout for all.
    Returns the (steps, S, C, N) losses and loss weights, the wall
    seconds and the layout's name."""
    import torch.distributed as dist
    first = mesh is None or mesh.rank == 0
    sim, batcher = paper_mlp_setup(
        base_fl, batch=batch, seed=seed,
        device=device if mesh is None else mesh.device)
    if tune:
        fl = [None]
        if first:
            model = sim.model
            template = tree_map(lambda spec: spec.shape,
                                {"final": model.final_specs(),
                                 "trunk": model.trunk_specs()})
            fl[0] = tuned_fl(base_fl, template, device=sim.device)
        if mesh is not None and mesh.size > 1:
            dist.broadcast_object_list(fl, src=0)
        if first:
            print(f"  layout: {layout_of(fl[0]).describe()} (tuned on "
                  f"{sim.device})", flush=True)
        sim = HotaSim(sim.model, fl[0], sim.tcfg, sim.n_classes.tolist(),
                      max_classes=sim.max_classes, device=sim.device)
    elif first:
        why = ("explicit engine flags, autotuner skipped" if explicit_engine
               else "autotuner off")
        engine = _engine_name(base_fl.ota_streaming, base_fl.ota_sectioned,
                              base_fl.max_section_rows)
        print(f"  layout: {base_fl.ota_sections} ({why}), engine: {engine}",
              flush=True)
    bank = make_bank(sim, specs, mesh)
    states = bank.init(rng.PRNGKey(seed))

    losses, ps = [], []
    t0 = time.time()
    for step in range(steps):
        x, y = batcher.next_stacked()
        states, m = bank.step(states, x, y,
                              rng.PRNGKey(seed * 7919 + step))
        losses.append(m["loss"].cpu().numpy())    # (S, C, N)
        ps.append(m["p"].cpu().numpy())
        if first and step % log_every == 0:
            print(f"  [sweep x{bank.n_scenarios} on {sim.device}] step "
                  f"{step}/{steps} loss {losses[-1].mean():.4f} "
                  f"({(time.time()-t0)/(step+1):.2f}s/step)", flush=True)
    wall_s = time.time() - t0
    return (np.stack(losses), np.stack(ps), wall_s,
            layout_of(sim.fl).describe())


def summarize(results: Dict[str, Dict], label: str) -> str:
    lines = [f"== {label} =="]
    for name, r in results.items():
        fl = r["final_loss_per_task"]
        auc = r["auc_loss_per_task"]
        lines.append(
            f"{name:34s} final per task: "
            + " ".join(f"{x:.4f}" for x in fl)
            + "  | auc: " + " ".join(f"{x:.4f}" for x in auc))
    return "\n".join(lines)


def main(run: Callable, argv=None):
    """Command line of a figure runner: ``[steps] [--streaming]
    [--sectioned] [--max-section-rows R] [--device D]
    [--scenario-ranks R] [--force]``."""
    ap = argparse.ArgumentParser(description=run.__module__)
    ap.add_argument("steps", nargs="?", type=int, default=800)
    ap.add_argument("--streaming", action="store_true",
                    help="fold one cluster at a time (FLConfig.ota_streaming)")
    ap.add_argument("--sectioned", action="store_true",
                    help="one section at a time (FLConfig.ota_sectioned)")
    ap.add_argument("--max-section-rows", type=int, default=0,
                    help="split trunk sections above this many 128-rows")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--scenario-ranks", type=int, default=1,
                    help="split the bank's scenarios over this many rank "
                         "processes (ShardedScenarioBank)")
    ap.add_argument("--force", action="store_true",
                    help="run again even if cached results exist")
    a = ap.parse_args(argv)
    return run(steps=a.steps, force=a.force, ota_streaming=a.streaming,
               ota_sectioned=a.sectioned,
               max_section_rows=a.max_section_rows, device=a.device,
               scenario_ranks=a.scenario_ranks)
