#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one card.

Usage: ``python3 chip_smoke.py`` from the root of a checkout, on a machine
with one NVIDIA H100 (sm_90a), ``nvcc`` and a CUDA build of PyTorch. It
imports only ``repro_torch`` (never ``jax`` or the JAX package) and runs:

1. build: compile the CUDA kernels from ``src/repro_torch/kernels/**/csrc``;
2. the card's name and power limit (``nvidia-smi``);
3. K1 ``ota_client_fold`` against its plain PyTorch version on the card,
   at the round's largest leaf (trunk fc2.w, C=10, N=3, 2,097,152 entries)
   and a ragged bias leaf, in the default, ``ota_on=0``, dead-cluster and
   N_eff cases (rtol 1e-5, atol 1e-6: FMA contraction moves the last bit);
4. K2 ``masked_gradnorm`` against its plain version at (C=10, N=3,
   P̃=131328) (rtol 1e-5: summation order);
5. the main path: ``paper_mlp_setup`` at the paper's full width (Table-I
   MLP, C=10 clusters, N=3 clients, batch 24; the dataset cut to
   ``N_POINTS`` points for host-side set-up time) for ``ROUNDS`` rounds,
   with every launch counter set to 0 just before and read just after
   (10 K1 launches and 1 K2 launch per round), finite losses, and one
   round on the card held against the same round on the CPU with the
   plain versions (loss/p/grad_norms rtol 1e-4; ω and the PS Adam moment
   (0.1·ĝ) by relative L2 error 1e-3, since a first Adam step maps
   |ĝ| ≈ 0 entries to ±lr, where last-bit differences flip a sign);
   TF32 is off for matmul and cuDNN on both sides;
6. timings: the round (host clock, tracing off); K1 and K2 at the round's
   shapes as device time (``torch.profiler`` kernel events) beside their
   bounds, their plain versions, K2's ``torch.linalg.vector_norm``
   yardstick and their back-to-back launch time (CUDA events); the
   threefry stream draw and the client update; and the device-time
   breakdown of ``TRACED_ROUNDS`` traced rounds;
7. K5 ``ota_mask_weight`` against its plain version on the card at trunk
   fc2.w (2,097,152 entries) and the ragged final/b leaf, in the default,
   ``ota_on=0`` and ``w=0.37`` cases and as a strided (C, n) column slice
   (exact equality: one compare and one multiply);
8. the four aggregation engines (client-folded, streaming, sectioned,
   sectioned + streaming) on one full-width round's gradients: sectioned
   must equal client-folded bit for bit, sectioned + streaming must equal
   streaming bit for bit, streaming must match client-folded to rtol 1e-5,
   atol 1e-6 (cluster order of the float sum); the peak device memory of
   one aggregation call on each;
9. the sweep path: a full-width ``ScenarioBank`` of Fig. 4's four
   scenarios for ``BANK_ROUNDS`` rounds on each engine, counters set to 0
   just before and read just after each engine's run (per scenario round:
   K5 C x 10 leaves = 100 on the two streaming engines, 0 elsewhere; K1 10
   on client-folded and sectioned, 0 on the streaming engines; K2 1),
   finite metrics, and the engines' banks against the client-folded bank
   (loss/p rtol 1e-4, ω relative L2 1e-3); then per engine the median
   bank round over ``TIMED_BANK_ROUNDS`` rounds (host clock), one traced
   bank round, and K5's device time per scenario round at the round's
   shapes beside its bound and its plain version.

Any failure exits non-zero. The line before last is the card's name and
power limit, the one before it the kernels' JSON (K1, K2 and K5; each
kernel's ``launches`` sums its counts over the main-path runs of phases 5
and 9); the last line is
``{"ok": true, "device": {...}}``. An earlier ``[record]`` line holds every
number measured, as JSON.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

N_POINTS = 12_000         # RadComDynamic cut from 125,000 (data set-up time)
ROUNDS = 3                # main-path rounds with the counters on
TIMED_ROUNDS = 10         # rounds for the median round time
TRACED_ROUNDS = 3         # profiled rounds for the device-time breakdown
BANK_ROUNDS = 3           # bank rounds per engine with the counters on
TIMED_BANK_ROUNDS = 5     # bank rounds per engine for the median round
ENGINES = {"client_folded": {}, "streaming": {"ota_streaming": True},
           "sectioned": {"ota_sectioned": True},
           "sectioned_streaming": {"ota_sectioned": True,
                                   "ota_streaming": True}}
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, published
F32_FLOPS_PER_S = 67e12       # H100 SXM, float32 outside the tensor cores
RTOL, ATOL = 1e-5, 1e-6


def _profile_acts():
    import torch
    return [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_events(prof):
    """The profiler's device-side events (kernels and copies), by name."""
    import torch
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def device_ms(fn, iters: int, match: str = "") -> float:
    """Device time per call of ``fn``: the kernel time CUPTI records over
    ``iters`` calls (only kernels whose name holds ``match``), without the
    host's launch gaps."""
    import torch
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=_profile_acts()) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in device_events(prof)
               if match in e.key) / 1e3 / iters


def host_ms(fn) -> float:
    """Host wall time of one call that ends in a device synchronize."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def check_close(name, got, want, rtol=RTOL, atol=ATOL) -> float:
    import torch
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite kernel output")
    if bool(bad.any()):
        fail(f"{name}: {int(bad.sum())} entries outside rtol {rtol} atol "
             f"{atol}; max abs err {float(err.max()):.3e}")
    return float(err.max())


def rel_l2(got, want) -> float:
    import torch
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))


def to_cpu(x):
    """A copy of a state (tensors, dicts, named tuples) on the host."""
    if isinstance(x, dict):
        return {k: to_cpu(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return type(x)(*[to_cpu(v) for v in x])
    return x.cpu()


def check_k5(dev, runs, names, gbits, chan, gen) -> float:
    """Phase 7: K5 against its plain version on the card, exact."""
    import torch
    from repro_torch.kernels.ota_channel.ops import ota_mask_weight_apply
    from repro_torch.kernels.ota_channel.ref import ota_mask_weight_ref
    biggest = max(runs, key=lambda r: r.size)
    ragged = next(r for r in runs if names[r.leaf] == "final/b")
    sig0 = chan.sigma2[0]
    cases = {"default": (sig0, 1.0, 1.0), "ota_off": (sig0, 0.0, 1.0),
             "w0.37": (sig0, 1.0, 0.37), "sigma0.05": (0.05, 1.0, 0.37)}
    c = gbits[0].shape[0]
    err = 0.0
    for run in (biggest, ragged):
        stream = gbits[run.section][:, run.offset:run.offset + run.size]
        x = torch.randn(run.size, generator=gen, device=dev) * 1e-3
        x2 = torch.randn((c, run.size), generator=gen, device=dev)
        for cname, (sig, ota_on, w) in cases.items():
            args = (sig, chan.h_threshold, ota_on, w)
            for xx, bb, form in ((x, stream[c - 1], "row"),
                                 (x2, stream, "strided (C, n)")):
                got = ota_mask_weight_apply(xx, bb, *args)
                torch.cuda.synchronize()
                want = ota_mask_weight_ref(xx, bb, *args)
                for g_t, w_t, what in zip(got, want, ("out", "mask")):
                    if not torch.isfinite(g_t).all():
                        fail(f"K5 {names[run.leaf]} {cname}: non-finite")
                    if not torch.equal(g_t, w_t):
                        n_bad = int((g_t != w_t).sum())
                        fail(f"K5 {names[run.leaf]} {cname} {form} {what}: "
                             f"{n_bad} entries differ from the plain version")
                    err = max(err, float((g_t - w_t).abs().max()))
            log(f"[K5] {names[run.leaf]} n={run.size} {cname}: equal to the "
                f"plain version (row and strided (C, n) forms)")
    return err


def engine_sims(sim, fl, dev):
    """One HotaSim per aggregation engine, sharing ``sim``'s model."""
    import dataclasses
    from repro_torch.core.sim import HotaSim
    return {name: HotaSim(sim.model, dataclasses.replace(fl, **kw), sim.tcfg,
                          sim.n_classes.tolist(), device=dev)
            for name, kw in ENGINES.items()}


def check_engines(sims, state, batch, key, dev, record) -> None:
    """Phase 8: the four engines on one round's gradients and weights."""
    import torch
    from repro_torch.common.tree import tree_leaves
    from repro_torch.core import ota
    x = torch.as_tensor(batch[0]).to(dev)
    y = torch.as_tensor(batch[1]).to(device=dev, dtype=torch.int64)
    sim0 = sims["client_folded"]
    _, _, g, _ = sim0._client_update(state.omega, state.heads,
                                     state.head_opt, x, y)
    p = torch.rand(state.p.shape, device=dev) + 0.5
    chan_key = ota.sim_channel_key(key)
    packer = sim0.packer(state.omega)
    out, peak = {}, {}
    for name, esim in sims.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        ghat = esim.aggregate(chan_key, g, p, esim.chan, packer)
        torch.cuda.synchronize()
        peak[name] = torch.cuda.max_memory_allocated(dev) - base
        out[name] = torch.cat([l.reshape(-1) for l in tree_leaves(ghat)])
    if not all(bool(torch.isfinite(v).all()) for v in out.values()):
        fail("non-finite aggregation output")
    for a, b in (("sectioned", "client_folded"),
                 ("sectioned_streaming", "streaming")):
        if not torch.equal(out[a], out[b]):
            fail(f"{a} differs from {b}: "
                 f"{int((out[a] != out[b]).sum())} entries")
    err = check_close("streaming vs client-folded", out["streaming"],
                      out["client_folded"])
    record["engines"] = {
        "sectioned_equals_client_folded": True,
        "sectioned_streaming_equals_streaming": True,
        "streaming_vs_client_folded_max_abs": err,
        "aggregation_peak_bytes": peak}
    log(f"[engines] sectioned == client-folded and sectioned+streaming == "
        f"streaming bit for bit; streaming vs client-folded max abs err "
        f"{err:.3e}; peak bytes of one aggregation call {peak}")


def bank_runs(sims, specs, batches, keys, counters):
    """Phase 9's counted runs: each engine's bank for len(keys) rounds from
    the same initial state, counters set to 0 just before each run and
    read just after. Returns {engine: (bank, states, history, launches)}."""
    import torch
    from repro_torch.core.sweep import ScenarioBank
    out = {}
    for name, esim in sims.items():
        bank = ScenarioBank(esim, specs)
        states = bank.init(0)
        torch.cuda.synchronize()
        for ctr in counters:
            ctr.reset()
        states, hist = bank.run(states, batches, keys)
        torch.cuda.synchronize()
        out[name] = (bank, states, hist,
                     {ctr.name: ctr.count for ctr in counters})
    return out


def k5_round_timing(dev, runs, gbits, chan, gen):
    """K5 at one scenario round's shapes of the streaming engines (one
    launch per (cluster, leaf)): device time, plain version, bound."""
    import torch
    from repro_torch.kernels.ota_channel import ops as kc
    from repro_torch.kernels.ota_channel.ref import (
        ota_mask_weight_ref, pass_probability,
    )
    c = gbits[0].shape[0]
    calls = []
    for run in runs:
        x = torch.randn((1, run.size), generator=gen, device=dev)
        out = torch.empty_like(x)
        mask = torch.empty_like(x)
        for l in range(c):
            b = gbits[run.section][l:l + 1, run.offset:run.offset + run.size]
            params = kc.mask_weight_params(chan.sigma2[l], chan.h_threshold,
                                           chan.ota_on, 1.0, device=dev)
            pp = pass_probability(params[0], params[1]).reshape(1)
            calls.append((x, b, params, pp, out, mask))

    def raw():
        for a in calls:
            kc.launch_mask_weight(*a)

    def plain():
        for x, b, params, pp, _, _ in calls:
            ota_mask_weight_ref(x, b, params[0], params[1], params[2],
                                params[3], p_pass=pp)
    n_total = sum(r.size for r in runs) * c
    nbytes = 16 * n_total + 20 * len(calls)
    nops = 3 * n_total
    return {"launches_per_round": len(calls),
            "ms": device_ms(raw, 10, "ota_mask_weight"),
            "launch_ms": cuda_ms(raw, 10),
            "plain_ms": device_ms(plain, 2),
            "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                  nops / F32_FLOPS_PER_S),
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= nops / F32_FLOPS_PER_S else "operations")}


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a card")
    try:
        from repro_torch.common.config import FLConfig
        from repro_torch.common.tree import tree_leaves
        from repro_torch.core import ota
        from repro_torch.core.paper_setup import paper_mlp_setup
        from repro_torch.core.sim import HotaSim
        from repro_torch.experiments.fig4_diverse_sigma import (
            experiments as fig4_experiments,
        )
        from repro_torch.kernels import _build
        from repro_torch.kernels.masked_gradnorm import ops as k2
        from repro_torch.kernels.masked_gradnorm.ref import masked_gradnorm_ref
        from repro_torch.kernels.ota_channel import ops as k1
        from repro_torch.kernels.ota_channel.ref import (
            ota_aggregate_client_ref, pass_probability,
        )
        from repro_torch import rng
    except ImportError as e:
        fail(f"cannot import the port (run from a checkout): {e}")
    if "jax" in sys.modules or "repro" in sys.modules:
        fail("the JAX package was imported")

    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    record = {"tf32": False}
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; TF32 off for "
        f"matmul and cuDNN")

    # --- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build(verbose=True)
    _build.library()
    record["build_s"] = time.perf_counter() - t0
    log(f"[build] {lib_path.name} in {record['build_s']:.1f} s "
        f"(nvcc {_build.build_seconds():.1f} s)")
    for line in _build.ptxas_log().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(f"  {line.strip()}")

    # --- 2. the card --------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[card] {card}")

    # --- the paper round's shapes ------------------------------------------
    fl = FLConfig(n_clusters=10, n_clients=3)
    c, n_cl = fl.n_clusters, fl.n_clients
    sim, batcher = paper_mlp_setup(fl, batch=24, n_points=N_POINTS, seed=0,
                                   device=dev)
    state = sim.init(0)
    packer = sim.packer(state.omega)
    runs = packer.leaf_runs()
    key0 = rng.PRNGKey(2024)
    chan_key = ota.sim_channel_key(key0)
    gbits, nbits = ota.section_streams(chan_key, packer, c, dev)
    torch.cuda.synchronize()
    gen = torch.Generator(device=dev).manual_seed(1)
    p_w = torch.rand((c, n_cl), generator=gen, device=dev) + 0.5
    chan = sim.chan

    def leaf_inputs(run):
        """Gradients viewed (C, N, n) and the leaf's stream slices."""
        g = torch.randn((c, n_cl, run.size), generator=gen, device=dev) * 1e-3
        b = gbits[run.section][:, run.offset:run.offset + run.size]
        nb = nbits[run.section][run.offset:run.offset + run.size]
        return g, b, nb

    # --- 3. K1 against its plain version ------------------------------------
    names = ["/".join(p) for p in packer.paths]
    biggest = max(runs, key=lambda r: r.size)
    ragged = next(r for r in runs if names[r.leaf] == "final/b")
    cases = {"default": {}, "ota_off": {"ota_on": 0.0},
             "dead_cluster": {"live": [1.0] * (c - 1) + [0.0]},
             "n_eff": {"live": [0.0, 1.0] + [1.0] * (c - 2), "n_eff": 2.5}}
    k1_err = 0.0
    for run in (biggest, ragged):
        g, b, nb = leaf_inputs(run)
        for cname, kw in cases.items():
            ota_on = torch.tensor(kw.get("ota_on", 1.0), device=dev)
            live = (None if "live" not in kw
                    else torch.tensor(kw["live"], device=dev))
            n_eff = (None if "n_eff" not in kw
                     else torch.tensor(kw["n_eff"], device=dev))
            got = k1.ota_client_fold_apply(
                g, p_w, b, nb, chan.sigma2, chan.h_threshold, chan.noise_std,
                ota_on, n_cl, live=live, n_eff=n_eff)
            torch.cuda.synchronize()
            want = ota_aggregate_client_ref(
                g, p_w, b, nb, chan.sigma2, chan.h_threshold, chan.noise_std,
                ota_on, n_cl, live=live, n_eff=n_eff)
            err = check_close(f"K1 {names[run.leaf]} {cname}", got, want)
            k1_err = max(k1_err, err)
            log(f"[K1] {names[run.leaf]} n={run.size} {cname}: max abs err "
                f"{err:.3e}")
    record["k1_max_abs_err"] = k1_err

    # --- 4. K2 against its plain version ------------------------------------
    p_tail = sum(packer.slots[i].size for i in packer.tail_indices)
    gm = torch.randn((c, n_cl, p_tail), generator=gen, device=dev) * 1e-2
    mm = (torch.rand((c, p_tail), generator=gen, device=dev) < 0.86).float()
    got = k2.masked_gradnorm(gm, mm)
    torch.cuda.synchronize()
    k2_err = check_close("K2", got, masked_gradnorm_ref(gm, mm), atol=0.0)
    record["k2_max_abs_err"] = k2_err
    log(f"[K2] (C={c}, N={n_cl}, P={p_tail}): max abs err {k2_err:.3e}")

    # --- 7. K5 against its plain version ------------------------------------
    k5_err = check_k5(dev, runs, names, gbits, chan, gen)
    record["k5_max_abs_err"] = k5_err

    # --- 5. the main path ---------------------------------------------------
    batches = [batcher.next_stacked() for _ in range(ROUNDS + 1)]
    keys = [rng.fold_in(key0, r) for r in range(ROUNDS + 1)]
    counters = (k1.client_fold_counter, k2.counter, k1.mask_weight_counter)
    for ctr in counters:
        ctr.reset()
    losses = []
    st = state
    for r in range(ROUNDS):
        st, m = sim.step(st, *batches[r], keys[r])
        losses.append(m["loss"])
    torch.cuda.synchronize()
    launches = {ctr.name: ctr.count for ctr in counters}
    want = {"ota_client_fold": len(runs) * ROUNDS,
            "masked_gradnorm": ROUNDS, "ota_mask_weight": 0}
    if launches != want:
        fail(f"main-path launches {launches}, expected {want}")
    loss = torch.stack(losses)
    if not torch.isfinite(loss).all():
        fail("non-finite loss on the main path")
    record["launches"] = launches
    record["round_loss_mean"] = [float(l.mean()) for l in losses]
    log(f"[path] {ROUNDS} rounds, launches {launches}, mean loss per round "
        f"{record['round_loss_mean']}")

    # the same round on the CPU with the plain versions
    cpu_sim = HotaSim(sim.model, fl, sim.tcfg, sim.n_classes.tolist(),
                      device="cpu")
    st_cpu = to_cpu(st)
    new_gpu, m_gpu = sim.step(st, *batches[ROUNDS], keys[ROUNDS])
    new_cpu, m_cpu = cpu_sim.step(st_cpu, *batches[ROUNDS], keys[ROUNDS])
    cmp = {}
    for name in ("loss", "p", "grad_norms", "fgrad"):
        err = check_close(f"round {name}", m_gpu[name].cpu(), m_cpu[name],
                          rtol=1e-4, atol=1e-6)
        cmp[name] = err
    w_gpu = torch.cat([l.reshape(-1).cpu() for l in tree_leaves(new_gpu.omega)])
    w_cpu = torch.cat([l.reshape(-1) for l in tree_leaves(new_cpu.omega)])
    cmp["omega_rel_l2"] = rel_l2(w_gpu, w_cpu)
    cmp["omega_max_abs"] = float((w_gpu - w_cpu).abs().max())
    mu_gpu, mu_cpu = new_gpu.ps_opt.mu.cpu(), new_cpu.ps_opt.mu
    cmp["ghat_rel_l2"] = rel_l2(mu_gpu, mu_cpu)
    # entries where ĝ differs beyond float noise (a mask flipped by a
    # last-place difference of erfc between the two devices' libraries)
    cmp["ghat_entries_off"] = int(((mu_gpu - mu_cpu).abs()
                                   > 1e-4 * mu_cpu.abs() + 1e-7).sum())
    if cmp["omega_rel_l2"] > 1e-3 or cmp["ghat_rel_l2"] > 1e-3:
        fail(f"card round vs CPU round: {cmp}")
    record["card_vs_cpu"] = cmp
    log(f"[path] card round vs CPU round: {cmp}")

    # --- 6. timings ---------------------------------------------------------
    # the end-to-end round time: host clock around a step that ends in a
    # synchronize, tracing off
    round_ms = []
    st_t = new_gpu
    for r in range(TIMED_ROUNDS):
        b_r = batcher.next_stacked()
        k_r = rng.fold_in(key0, 100 + r)

        def one():
            nonlocal st_t
            st_t, _ = sim.step(st_t, *b_r, k_r)
        round_ms.append(host_ms(one))
    record["round_ms"] = round_ms
    record["round_ms_median"] = statistics.median(round_ms)

    def draw():    # what a client-folded round draws: once, masks read it
        streams = ota.section_streams(chan_key, packer, c, dev)
        ota.final_layer_masks_packed(chan_key, chan, packer,
                                     gain=streams.gain)
    record["stream_draw_ms"] = statistics.median(host_ms(draw)
                                                 for _ in range(3))
    record["stream_draw_device_ms"] = device_ms(draw, 2)

    x_b, y_b = batcher.next_stacked()
    x_t = torch.as_tensor(x_b).to(dev)
    y_t = torch.as_tensor(y_b).to(device=dev, dtype=torch.int64)

    def client_update():
        sim._client_update(st_t.omega, st_t.heads, st_t.head_opt, x_t, y_t)
    record["client_update_ms"] = statistics.median(
        host_ms(client_update) for _ in range(3))
    record["client_update_device_ms"] = device_ms(client_update, 3)
    log(f"[time] round median {record['round_ms_median']:.2f} ms "
        f"(all {['%.2f' % t for t in round_ms]}); stream draw "
        f"{record['stream_draw_ms']:.2f} ms (device "
        f"{record['stream_draw_device_ms']:.2f}); client update "
        f"{record['client_update_ms']:.2f} ms (device "
        f"{record['client_update_device_ms']:.2f})")

    # K1 at the round's shapes, every leaf once per round. "ms" is device
    # time (profiler kernel events); "launch_ms" is back-to-back calls of
    # the raw launch on CUDA events, which small leaves spend waiting for
    # the host; "wrapper_ms" adds the params row the wrapper builds
    k1_ms = k1_plain_ms = k1_launch_ms = k1_path_ms = 0.0
    k1_bytes = k1_ops = 0
    per_leaf = []
    for run in runs:
        g, b, nb = leaf_inputs(run)
        n = run.size
        params = k1.client_params(p_w, chan.sigma2, chan.h_threshold,
                                  chan.noise_std, chan.ota_on, c, n_cl,
                                  device=dev)
        pp = pass_probability(params[:c], params[c * (n_cl + 1)])
        out = torch.empty(n, device=dev)
        iters = 20 if n > 100_000 else 100

        def raw():
            k1.launch(g, b, nb, params, pp, out)

        def plain():
            ota_aggregate_client_ref(g, p_w, b, nb, chan.sigma2,
                                     chan.h_threshold, chan.noise_std,
                                     chan.ota_on, n_cl)
        leaf = {"leaf": names[run.leaf], "n": n,
                "ms": device_ms(raw, iters, "ota_client_fold"),
                "launch_ms": cuda_ms(raw, iters),
                "wrapper_ms": cuda_ms(lambda: k1.ota_client_fold_apply(
                    g, p_w, b, nb, chan.sigma2, chan.h_threshold,
                    chan.noise_std, chan.ota_on, n_cl), iters),
                "plain_ms": device_ms(plain, 3)}
        nbytes = 4 * n * (c * n_cl + c + 2) + 4 * (c * (n_cl + 3) + 4)
        nops = n * (2 * c * n_cl + 4 * c + 30)
        leaf["bound_ms"] = 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                     nops / F32_FLOPS_PER_S)
        k1_ms += leaf["ms"]
        k1_launch_ms += leaf["launch_ms"]
        k1_path_ms += leaf["wrapper_ms"]
        k1_plain_ms += leaf["plain_ms"]
        k1_bytes += nbytes
        k1_ops += nops
        per_leaf.append(leaf)
    record["k1_per_leaf"] = per_leaf
    k1_bound = 1e3 * max(k1_bytes / HBM_BYTES_PER_S,
                         k1_ops / F32_FLOPS_PER_S)
    record.update(k1_launch_ms=k1_launch_ms, k1_wrapper_ms=k1_path_ms)

    # K2 at the round's shape; the yardstick is one vector_norm over the
    # masked product (the multiply and the norm)
    out2 = torch.empty((c, n_cl), device=dev)
    k2_ms = device_ms(lambda: k2.launch(gm, mm, out2), 100,
                      "masked_gradnorm")
    record["k2_launch_ms"] = cuda_ms(lambda: k2.launch(gm, mm, out2), 100)
    k2_plain = device_ms(lambda: masked_gradnorm_ref(gm, mm), 20)
    k2_lib = device_ms(lambda: torch.linalg.vector_norm(
        gm * mm.unsqueeze(1), dim=-1), 20)
    if min(k1_ms, k2_ms, k1_plain_ms, k2_plain, k2_lib) <= 0.0:
        fail("the profiler recorded no device time for a timed kernel")
    k2_bytes = 4 * (c * n_cl * p_tail + c * p_tail + c * n_cl)
    k2_ops = 3 * c * n_cl * p_tail
    k2_bound = 1e3 * max(k2_bytes / HBM_BYTES_PER_S,
                         k2_ops / F32_FLOPS_PER_S)
    log(f"[time] K1 per round {k1_ms:.4f} ms device (launch "
        f"{k1_launch_ms:.4f}, wrapper {k1_path_ms:.4f}, plain "
        f"{k1_plain_ms:.4f}, bound {k1_bound:.4f}); K2 {k2_ms:.4f} ms "
        f"device (launch {record['k2_launch_ms']:.4f}, plain "
        f"{k2_plain:.4f}, vector_norm {k2_lib:.4f}, bound {k2_bound:.4f})")
    for leaf in per_leaf:
        log(f"  K1 {leaf['leaf']:>12} n={leaf['n']:>8}: {leaf['ms']:.4f} ms "
            f"(launch {leaf['launch_ms']:.4f}, bound {leaf['bound_ms']:.4f}, "
            f"plain {leaf['plain_ms']:.4f})")
    if not all(bool(torch.isfinite(v).all()) for v in m_gpu.values()):
        fail("non-finite metrics")

    # where a round's device time goes: TRACED_ROUNDS traced rounds
    rounds_p = [(batcher.next_stacked(), rng.fold_in(key0, 900 + r))
                for r in range(TRACED_ROUNDS)]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=_profile_acts()) as prof:
        t0 = time.perf_counter()
        for (xb_p, yb_p), k_p in rounds_p:
            st_t, _ = sim.step(st_t, xb_p, yb_p, k_p)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3 / TRACED_ROUNDS
    rows = sorted(((e.self_device_time_total / 1e3 / TRACED_ROUNDS, e.key,
                    e.count // TRACED_ROUNDS) for e in device_events(prof)),
                  reverse=True)
    busy_ms = sum(r[0] for r in rows)
    record["profile"] = {
        "traced_round_ms": traced_ms, "device_busy_ms": busy_ms,
        "k1_ms": sum(t for t, k, _ in rows if "ota_client_fold" in k),
        "k2_ms": sum(t for t, k, _ in rows if "masked_gradnorm" in k),
        "top": [{"kernel": k[:100], "ms": t, "per_round": n}
                for t, k, n in rows[:15]]}
    log(f"[trace] per traced round: {traced_ms:.2f} ms wall, device busy "
        f"{busy_ms:.2f} ms ({100 * busy_ms / traced_ms:.1f} %); K1 "
        f"{record['profile']['k1_ms']:.4f} ms, K2 "
        f"{record['profile']['k2_ms']:.4f} ms")
    for t, k, n in rows[:15]:
        log(f"  {t:9.4f} ms  x{n:<4} {k[:100]}")

    # --- 8. the four engines on one round's gradients ----------------------
    sims = engine_sims(sim, fl, dev)
    check_engines(sims, st_t, batcher.next_stacked(),
                  rng.fold_in(key0, 2000), dev, record)

    # --- 9. the sweep path: Fig. 4's bank on every engine -------------------
    specs = list(fig4_experiments().values())
    n_sc = len(specs)
    bank_batches = [batcher.next_stacked() for _ in range(BANK_ROUNDS)]
    bank_keys = [rng.PRNGKey(r) for r in range(BANK_ROUNDS)]
    banks = bank_runs(sims, specs, bank_batches, bank_keys, counters)
    per = n_sc * BANK_ROUNDS          # scenario rounds per engine
    streaming_engines = ("streaming", "sectioned_streaming")
    total = dict(launches)
    ref_hist = banks["client_folded"][2]
    ref_w = torch.cat([l.reshape(-1) for l in
                       tree_leaves(banks["client_folded"][1].omega)])
    bank_rec = {}
    for name, (bank, states_b, hist, got) in banks.items():
        streams = name in streaming_engines
        want = {"ota_client_fold": 0 if streams else len(runs) * per,
                "masked_gradnorm": per,
                "ota_mask_weight": c * len(runs) * per if streams else 0}
        if got != want:
            fail(f"bank on {name}: launches {got}, expected {want}")
        for k_name, v in got.items():
            total[k_name] += v
        if not all(bool(torch.isfinite(v).all()) for v in hist.values()):
            fail(f"bank on {name}: non-finite metrics")
        cmp = {m: check_close(f"bank {name} {m}", hist[m], ref_hist[m],
                              rtol=1e-4, atol=1e-6) for m in ("loss", "p")}
        w_b = torch.cat([l.reshape(-1)
                         for l in tree_leaves(states_b.omega)])
        cmp["omega_rel_l2"] = rel_l2(w_b, ref_w)
        if cmp["omega_rel_l2"] > 1e-3:
            fail(f"bank on {name} vs client-folded: {cmp}")
        cmp["bits_equal"] = (torch.equal(w_b, ref_w) and all(
            torch.equal(hist[m], ref_hist[m]) for m in hist))
        bank_rec[name] = {"launches": got, "vs_client_folded": cmp,
                          "loss_mean_per_round": hist["loss"].mean(
                              dim=(1, 2, 3)).tolist()}
        log(f"[bank] {name}: {BANK_ROUNDS} rounds x {n_sc} scenarios, "
            f"launches {got}; vs client-folded {cmp}")

    # per engine: the median bank round (host clock, tracing off) and one
    # traced bank round
    for name, (bank, states_b, _, _) in banks.items():
        holder = [states_b]
        times = []
        for r in range(TIMED_BANK_ROUNDS + 1):
            b_r = batcher.next_stacked()
            k_r = rng.PRNGKey(100 + r)

            def one():
                holder[0], _ = bank.step(holder[0], *b_r, k_r)
            if r == TIMED_BANK_ROUNDS:
                acts = _profile_acts()
                with torch.profiler.profile(activities=acts) as prof:
                    traced = host_ms(one)
            else:
                times.append(host_ms(one))
        ev = [(e.self_device_time_total / 1e3, e.key, e.count)
              for e in device_events(prof)]
        busy = sum(t for t, _, _ in ev)
        rec = bank_rec[name]
        rec.update(
            round_ms=times, round_ms_median=statistics.median(times),
            traced_round_ms=traced, device_busy_ms=busy,
            k5_in_round_ms_per_scenario=sum(
                t for t, k, _ in ev if "ota_mask_weight" in k) / n_sc,
            k1_in_round_ms_per_scenario=sum(
                t for t, k, _ in ev if "ota_client_fold" in k) / n_sc,
            device_launches_traced=sum(n for _, _, n in ev),
            top=[{"kernel": k[:80], "ms": t, "count": n}
                 for t, k, n in sorted(ev, reverse=True)[:6]])
        log(f"[bank time] {name}: median {rec['round_ms_median']:.2f} ms per "
            f"bank round of {n_sc} scenarios (all "
            f"{['%.2f' % t for t in times]}); traced {traced:.2f} ms, device "
            f"busy {busy:.2f} ms, {rec['device_launches_traced']} device "
            f"launches; K5 {rec['k5_in_round_ms_per_scenario']:.4f} ms and "
            f"K1 {rec['k1_in_round_ms_per_scenario']:.4f} ms per scenario "
            f"round in the trace")
    record["bank"] = bank_rec

    k5 = k5_round_timing(dev, runs, gbits, chan, gen)
    record["k5_round"] = k5
    log(f"[time] K5 per scenario round ({k5['launches_per_round']} "
        f"launches): {k5['ms']:.4f} ms device (launch {k5['launch_ms']:.4f}, "
        f"plain {k5['plain_ms']:.4f}, bound {k5['bound_ms']:.4f} "
        f"({k5['bound_by']}))")
    if min(k5["ms"], k5["plain_ms"]) <= 0.0:
        fail("the profiler recorded no device time for K5")

    kernels = [
        {"name": "ota_client_fold", "route": "cuda",
         "source": "src/repro_torch/kernels/ota_channel/csrc/"
                   "ota_client_fold.cu",
         "replaces": "src/repro/kernels/ota_channel/kernel.py:370",
         "launches": total["ota_client_fold"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": ("bytes" if k1_bytes / HBM_BYTES_PER_S
                      >= k1_ops / F32_FLOPS_PER_S else "operations"),
         "library_ms": None},
        {"name": "masked_gradnorm", "route": "cuda",
         "source": "src/repro_torch/kernels/masked_gradnorm/csrc/"
                   "masked_gradnorm.cu",
         "replaces": "src/repro/kernels/masked_gradnorm/kernel.py:41",
         "launches": total["masked_gradnorm"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound,
         "bound_by": ("bytes" if k2_bytes / HBM_BYTES_PER_S
                      >= k2_ops / F32_FLOPS_PER_S else "operations"),
         "library_ms": k2_lib},
        {"name": "ota_mask_weight", "route": "cuda",
         "source": "src/repro_torch/kernels/ota_channel/csrc/"
                   "ota_mask_weight.cu",
         "replaces": "src/repro/kernels/ota_channel/kernel.py:142",
         "launches": total["ota_mask_weight"], "max_abs_err": k5_err,
         "ms": k5["ms"], "plain_ms": k5["plain_ms"],
         "bound_ms": k5["bound_ms"], "bound_by": k5["bound_by"],
         "library_ms": None},
    ]
    record["launches_main_path"] = total
    record.update(card=card, kind=kind)
    log("[record] " + json.dumps(record))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
