"""Fault-injection benchmark: the round's time against the fault rates.

Port of ``benchmarks/faults_bench.py`` (DESIGN.md §3.14). Two claims:

* the fault path's overhead at zero rates: the participation draw, the
  |M∩P| estimator and the guard's selects ride the same round, so the
  gate should cost a few percent, not a reformulation;
* the round's time is flat in the rates: the rates are tensors compared
  with shared uniforms inside the round, so a faultier channel costs the
  same (the work is masked, not skipped on the host).

``fault_rows`` times ``HotaSim.step`` (host clock around rounds that end
in a device synchronize, the median over ``rounds``) for the unfaulted
sim, the faulted sim at dropout 0, 0.25 and 0.5, and a full-blackout
row where every round is the identity. The rows run interleaved, one
round of each in turn (the order rotating from round to round), so a
drift of the host's clock over the run spreads over every row alike. At
the paper's width (Table-I MLP, C=10 clusters, N=3 clients, batch 24) on
the card::

    PYTHONPATH=src python -m repro_torch.experiments.faults_bench
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch import rng
from repro_torch.common.config import FLConfig, ModelConfig, TrainConfig
from repro_torch.common.device import resolve_device
from repro_torch.core.channel import fault_params
from repro_torch.core.sim import HotaSim
from repro_torch.models.model import build_model

N_CLASSES = 4
N_CLUSTERS = 10
N_CLIENTS = 3
BATCH = 24
SEED = 0


def fault_rows(device="cuda", rounds: int = 10) -> List[Dict]:
    """The benchmark's rows, one dict each (``name``, ``round_ms``,
    ``round_ms_median``, and on the faulted rows the last round's
    ``n_participants`` and ``skipped``). Each row runs one untimed round,
    then ``rounds`` timed ones interleaved with the other rows' (round r
    keyed ``fold_in(key, r)``); the batch is Gaussian features and
    uniform labels from ``SEED``."""
    dev = resolve_device(device)
    model = build_model(ModelConfig(family="mlp"))
    r = np.random.default_rng(SEED)
    x = torch.as_tensor(r.standard_normal(
        (N_CLUSTERS, N_CLIENTS, BATCH, model.dims[0])).astype(np.float32))
    y = torch.as_tensor(r.integers(0, N_CLASSES,
                                   (N_CLUSTERS, N_CLIENTS, BATCH)))
    init_key, key = rng.split(rng.PRNGKey(SEED))
    tcfg = TrainConfig(lr=3e-4)
    n_cls = [N_CLASSES] * N_CLIENTS
    fl0 = FLConfig(n_clusters=N_CLUSTERS, n_clients=N_CLIENTS,
                   noise_std=0.1)
    sim0 = HotaSim(model, fl0, tcfg, n_cls, device=dev)
    fl = dataclasses.replace(fl0, faults=True)
    sim = HotaSim(model, fl, tcfg, n_cls, device=dev)
    st0 = sim.init(init_key)
    # (name, sim, state, faults) per row
    runs = [["faults_off_baseline", sim0, sim0.init(init_key), None]]
    for rate in (0.0, 0.25, 0.5):
        runs.append([f"faults_dropout_{rate:g}", sim, st0, fault_params(
            dataclasses.replace(fl, dropout_rate=rate), device=dev)])
    runs.append(["faults_blackout_identity", sim, st0, fault_params(
        dataclasses.replace(fl, blackout_rate=1.0), device=dev)])
    times = {name: [] for name, *_ in runs}
    metrics = {}
    for rd in range(rounds + 1):
        for i in range(len(runs)):
            run = runs[(i + rd) % len(runs)]
            name, s, state, faults = run
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            run[2], metrics[name] = s.step(state, x, y, rng.fold_in(key, rd),
                                           faults=faults)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            if rd:                      # round 0 is the untimed warm-up
                times[name].append((time.perf_counter() - t0) * 1e3)
    rows = []
    for name, *_ in runs:
        m = metrics[name]
        row = {"name": name, "round_ms": times[name],
               "round_ms_median": statistics.median(times[name])}
        if "skipped" in m:
            row.update(n_participants=float(m["n_participants"]),
                       skipped=float(m["skipped"]))
        rows.append(row)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args(argv)
    for row in fault_rows(device=args.device, rounds=args.rounds):
        print(json.dumps(row))


if __name__ == "__main__":
    main()
