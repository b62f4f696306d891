"""Client-sampling benchmark: the round's time against the population.

Port of ``benchmarks/sample_bench.py`` (DESIGN.md §3.15). Two claims:

* the round's time is flat in the population size: a round's compute is
  the C·N slot view whatever the ``ClientBank`` holds, and the only work
  that touches the bank is the gather and the in-place scatter of C·N
  rows;
* the streaming engine trades the all-C stream buffer for a cluster loop
  (its gain is peak memory, not speed): its row states what turning it
  on costs.

``sample_rows`` times the plain ``HotaSim`` round, the
``SampledHotaSim`` round at each population and the streaming engine's
round (host clock around rounds that end in a device synchronize, the
median over ``rounds``). The rows run interleaved, one round of each in
turn with the order rotating from round to round, so a drift of the
host's clock spreads over every row alike. Each row also gives the
device-busy ms and the device launches of ``TRACED`` traced rounds
(``torch.profiler``, the rows in turn): the host clock's spread is
wider than a "flat" claim can resolve, the device's time is not. At the
paper's width (Table-I MLP, C=10 clusters, N=3 clients, batch 24) on the
card::

    PYTHONPATH=src python -m repro_torch.experiments.sample_bench
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch import rng
from repro_torch.common.config import FLConfig, ModelConfig, TrainConfig
from repro_torch.common.device import resolve_device
from repro_torch.common.spans import device_work
from repro_torch.core.sampling import SampledHotaSim
from repro_torch.core.sim import HotaSim
from repro_torch.models.model import build_model

N_CLASSES = 4
N_CLUSTERS = 10
N_CLIENTS = 3
BATCH = 24
SEED = 0
POPULATIONS = (1, 256, 4096, 32768)     # per (cluster, slot)
TRACED = 3               # traced rounds per row

TRACE_MARGIN_S = 0.1     # idle host time before and after a traced round
TRACE_SPACERS = 256      # 1-cycle spacer kernels that open every trace
SPACER_KERNEL = "spin_kernel"


def traced_round(fn: Callable[[], None]) -> Tuple[Dict[str, int], float]:
    """({device kernel name: launches}, device-busy ms) of one traced call
    of ``fn`` on the card: the busy time sums its device records. The
    trace opens with spacer kernels and idle host time, without which the
    profiler drops records of short traces (``kernels.trace_probe``)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        time.sleep(TRACE_MARGIN_S)
        for _ in range(TRACE_SPACERS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
        time.sleep(TRACE_MARGIN_S)
    events = [e for e in device_work(prof.key_averages())
              if SPACER_KERNEL not in e.key]
    return ({e.key: e.count for e in events},
            sum(e.self_device_time_total for e in events) / 1e3)


def bank_bytes(state) -> int:
    """Bytes of a sampled state's ``ClientBank``."""
    from repro_torch.common.tree import state_map
    sizes = []
    state_map(lambda t: sizes.append(t.numel() * t.element_size()),
              state.bank)
    return sum(sizes)


def sample_rows(device="cuda", rounds: int = 10) -> List[Dict]:
    """The benchmark's rows, one dict each: ``name``, ``population`` (M
    per slot of ``POPULATIONS``, None on the unsampled rows),
    ``clients`` (C·N·M), ``bank_bytes``, ``init_s``, ``round_ms``,
    ``round_ms_median``, ``device_busy_ms``, ``device_busy_ms_median``
    and ``device_launches`` (of the traced rounds; the card only). Each
    row runs one untimed round, then ``rounds`` timed ones interleaved
    with the other rows' (round r keyed ``fold_in(key, r)``), then
    ``TRACED`` traced rounds (``traced_round``), the rows in turn. The
    batch is Gaussian features and uniform labels from ``SEED``; every
    row's model starts from the same key. All the banks are alive at
    once: 27.5 GB of card memory at the paper's width."""
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
    fl = FLConfig(n_clusters=N_CLUSTERS, n_clients=N_CLIENTS, noise_std=0.1)
    sims = [("sample_off_baseline", None,
             HotaSim(model, fl, tcfg, n_cls, device=dev))]
    for m in POPULATIONS:
        sims.append((f"sample_population_{m * N_CLUSTERS * N_CLIENTS}", m,
                     SampledHotaSim(model, fl, tcfg, n_cls, m, device=dev)))
    sims.append(("sample_streaming_agg", None, HotaSim(
        model, dataclasses.replace(fl, ota_streaming=True), tcfg, n_cls,
        device=dev)))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rows, runs = [], []
    for name, m, sim in sims:
        sync()
        t0 = time.perf_counter()
        state = sim.init(init_key)
        sync()
        row = {"name": name, "population": m,
               "clients": None if m is None else m * N_CLUSTERS * N_CLIENTS,
               "init_s": time.perf_counter() - t0,
               "bank_bytes": bank_bytes(state) if m is not None else 0,
               "round_ms": []}
        rows.append(row)
        runs.append([sim, state])
    for rd in range(rounds + 1):
        for i in range(len(runs)):
            j = (i + rd) % len(runs)
            sim, state = runs[j]
            sync()
            t0 = time.perf_counter()
            runs[j][1], _ = sim.step(state, x, y, rng.fold_in(key, rd))
            sync()
            if rd:                      # round 0 is the untimed warm-up
                rows[j]["round_ms"].append((time.perf_counter() - t0) * 1e3)
    for row in rows:
        row["round_ms_median"] = statistics.median(row["round_ms"])
        row["device_busy_ms"], row["device_launches"] = [], []
    if dev.type == "cuda":
        for p in range(TRACED):
            for j, (sim, _) in enumerate(runs):
                def one(j=j, sim=sim):
                    runs[j][1], _ = sim.step(runs[j][1], x, y,
                                             rng.fold_in(key, 1000 + p))
                launches, busy = traced_round(one)
                rows[j]["device_busy_ms"].append(busy)
                rows[j]["device_launches"].append(sum(launches.values()))
        for row in rows:
            row["device_busy_ms_median"] = statistics.median(
                row["device_busy_ms"])
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args(argv)
    for row in sample_rows(device=args.device, rounds=args.rounds):
        print(json.dumps(row))


if __name__ == "__main__":
    main()
