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
   P̃=131328) and at ragged (C, T, P) (P = 1, P not a multiple of 4, one
   row) (rtol 1e-5: summation order), and two launches equal bit for bit
   (its rows are split over blocks and the partials added in a fixed
   order);
5. the main path: ``paper_mlp_setup`` at the paper's full width (Table-I
   MLP, C=10 clusters, N=3 clients, batch 24; the dataset cut to
   ``N_POINTS`` points for host-side set-up time) for ``ROUNDS`` rounds,
   with every launch counter set to 0 just before and read just after
   (10 K1 launches and 1 K2 launch per round; every stream word drawn on
   the card, none by the plain draw), finite losses, and one
   round on the card held against the same round on the CPU with the
   plain versions (loss/p/grad_norms rtol 1e-4; ω and the PS Adam moment
   (0.1·ĝ) by relative L2 error 1e-3, since a first Adam step maps
   |ĝ| ≈ 0 entries to ±lr, where last-bit differences flip a sign);
   TF32 is off for matmul and cuDNN on both sides;
6. timings: the round (host clock, tracing off); K1 and K2 at the round's
   shapes as their own device time (profiler kernel records, scaled up
   for the records the profiler drops) and as queued time (CUDA events
   around calls queued behind a spacer kernel: no host launch gaps, but
   the device's gaps between launches) beside their
   bounds, their plain versions and K2's ``torch.linalg.vector_norm``
   yardstick (``torch.profiler`` kernel events), K2's one-block-per-row
   design that its split rows replaced, and their back-to-back
   launch time (CUDA events); the
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
   on client-folded and sectioned, 0 on the streaming engines; K2 1; the
   stream draws on the card, none plain),
   finite metrics, and the engines' banks against the client-folded bank
   (loss/p rtol 1e-4, ω relative L2 1e-3); then per engine the median
   bank round over ``TIMED_BANK_ROUNDS`` rounds (host clock), one traced
   bank round, and K5's device time per scenario round at the round's
   shapes beside its bound and its plain version;
10. the stream draws (``csrc/threefry_stream.cu``) against the plain
   draws word for word in both ``jax_threefry_partitionable`` layouts:
   (C, 2) and (S, C, 2) key tables, chunk ranges from j0 > 0, ranges
   starting inside a chunk, the first P = 3,938,304 words, and the flat
   form at n = 1, CHUNK - 1, CHUNK + 1 and P; their time for one round's
   words and for one slab's flat words beside their INT32 bound and the
   plain draw. Then K3 ``ota_aggregate`` (supplied words) and K4
   ``ota_aggregate_fused`` (threefry2x32 in the kernel) against their
   plain versions on the card, in both layouts, at trunk fc2.w width
   (2,097,152 entries), the fc2 section (2,099,200: a partial last chunk)
   and a small odd width, in the default, ``ota_on=0``, σ²=0.05 and
   all-blocked cases (rtol 1e-5, atol 1e-6; all-blocked exactly 0); K3
   equal to K4 bit for bit on the same words;
11. the packed path at full width (3,938,304 entries, C=10, N=3) on one
   round's gradients, counters set to 0 just before and read just after:
   ``ota_aggregate_packed`` fused (one K4 launch per section) equal to
   supplied (one K3 launch per section) bit for bit, the client-folded
   engine against ``ota_aggregate_packed`` of the einsum-weighted tree
   (rtol 1e-5, atol 1e-6), and an S=8 bank with the words drawn once (one
   whole-slab K3 launch per scenario); then the device time of the packed
   call and bank beside the per-leaf engine's, and K3's and K4's device
   time beside their bounds, their plain versions and the int64 torch
   draw K4 replaces;
12. the per-leaf oracle round (``use_pallas_ota=False``) at full width for
   ``PERLEAF_ROUNDS`` rounds (K2 once per round, no other kernel), one card
   round against the CPU round (loss/p rtol 1e-4, ω relative L2 1e-3, the
   eq.-7 masks equal except where |h² − H_th| is within ``MASK_ULPS`` ulp
   of H_th), and its median round time;
13. the layout tuner: ``calibrate_layout`` on the paper template on the
   card with the layout cache off (every candidate's µs and estimated
   peak bytes, and the winner); one Fig. 4 bank round on the winning
   layout against the same round on the CPU (loss/p rtol 1e-4, ω
   relative L2 1e-3); then ``run_sweep`` with the tuner on for
   ``SWEEP_ROUNDS`` rounds of Fig. 4's bank, reading the winner from a
   temporary cache file and writing its results to a temporary directory
   (never to the checkout's ``results/``), counters set to 0 just before
   and read just after (per scenario round: K1 once per leaf run on the
   slab and sectioned engines, K2 once, nothing else), every scenario on
   the winner's layout;
14. K8 ``flash_attention`` against its plain version on the card: small
   shapes in float32 (rtol/atol 2e-5, the reference's own test) and
   bfloat16 (2e-2) covering D 64/128/240, 1/2/12 query heads per KV head,
   no window and windows under a key tile, ragged S, S = 8193 with no
   window at D 64 and 128 (bfloat16 at D 64 and 128 runs the Hopper
   kernel, TMA + wgmma; D 240 the mma.sync one); then StarCoder2-3B's
   layer at the serve's B=4 (S=8192, 24 heads over 2, D=128, window 4096,
   bfloat16), each batch element against the plain version (a 6.4 GB
   score matrix each) within 2e-2 and every (s, h) row within relative
   L2 ``K8_ROW_LIMIT``. On those inputs, its time per launch beside its
   bound (tensor core operations), the mma.sync design it replaced at this
   shape (timed in turns with it), the plain version's (one batch element
   at a time) and ``scaled_dot_product_attention`` with ``enable_gqa``
   (the window as a boolean mask, and causal only) as the library
   yardstick;
15. a ``CUT_LAYERS``-layer cut of StarCoder2-3B at full width (d_model
   3072, d_ff 12288, vocab 49152; only the depth is cut), B=1, S=1024:
   prefill and 4 decode steps on the card against the same on the CPU
   (the card fed the CPU's greedy tokens), TF32 off: float32 compute
   within relative L2 1e-4 of the logits, bfloat16 within
   ``CUT_BF16_LIMIT``, and the same argmax wherever the top-2 gap exceeds
   the row's largest difference;
16. ``launch.serve.serve`` at StarCoder2-3B's full depth and width
   (3,180,518,400 float32 parameters drawn on the card, bfloat16
   compute), B=4, a prefill of 8192 tokens and 32 decode steps, counters
   set to 0 just before and read just after (30 K8 launches: one per layer
   in the prefill, none in decode, no other kernel), finite logits; a
   second run for the prefill time (time to first token) and the decode
   time per step (host clock ending in a synchronize) and the peak device
   memory; one traced prefill and decode step; and at B=1 prefill(8192) +
   decode(1) against prefill(8193) (relative L2 of the logits 2e-2, the
   argmax rule above).

17. K6 ``ota_mask_count`` against its plain version on the card at the
   Table-I MLP's 3,936,512 entries, at C = 2 and C = 10 clusters, in the
   default, dead-cluster, ``ota_on=0`` and both cases, for the first and
   the last cluster (``out`` and ``cnt`` equal bit for bit); its time
   beside the byte bound (12 + 4C) B per entry and its plain version's;
18. K7 ``ota_channel`` (``ops.ota_channel``: the padded slab's words drawn
   on the card) against its plain version at the same width for σ² 0.5,
   1 and 2 and ``ota_on=0``: masks equal except within ``MASK_ULPS`` ulp
   of H_th, ``out`` equal where they agree; its time beside its bound
   (16 B per entry against one log, cos and sqrt per entry on the SFUs);
19. the distributed step (``core.hota_step.make_hota_train_step``) at full
   width: the Table-I MLP on a (2 clusters x 2 clients) mesh of four
   ranks sharing ``cuda:0`` (``launch.mesh.run_ranks``: spawned processes,
   gloo on the ranks' CUDA tensors; first a probe that gloo runs
   all-gather and reduce-scatter on CUDA tensors and right, each timed
   beside the same call staged through host tensors),
   default ``FLConfig`` (σ² = 1, H_th = 0.032, FedGradNorm), ``DIST_STEPS``
   steps in each count mode with every counter set to 0 just before and
   read just after in every rank (``DIST_LEAVES`` K6 launches per rank per
   step in "local", as many K5 in "psum", nothing else); the two modes
   equal bit for bit; both against the same steps on four CPU ranks
   (metrics and each rank's p rtol 1e-4, ω relative L2 1e-3); the slab
   backward on shared keys against ``packed_omega_aggregate_ref`` (rtol
   2e-5, atol 1e-6);
   the median step (host clock, every rank synchronized and at a
   barrier), and one step's split into collectives, stream draws and the
   rest (``MeshStats``), and each rank's peak device memory;
20. the packed ω̃ gather (``make_packed_final_gather``) and
   ``packed_final_norm`` on the same ranks, counters set to 0 just before
   and read just after (2 K7 launches per rank), ĝ against the CPU ranks'
   (relative L2 1e-4, at most 16 entries off by more than rtol 1e-4: K7's
   masks may flip within a few ulp of H_th between the two devices' log
   and cos), the masked norms rtol 1e-5;
21. the faulted paper round at full width (``FAULT_RATES``: dropout 0.25,
   blackout 0.1, stragglers 0.25, staleness 2), ``FAULT_ROUNDS`` rounds
   counted (10 K1 and 1 K2 per round, the participation drawn by 2
   ``threefry_flat`` launches per round, 0 plain draws); one card round
   against the CPU round (metrics rtol 1e-4, ω, its stale copy and ĝ
   relative L2 1e-3); blackout 1 and ``spike_norm`` 1e-30 rounds the
   identity bit for bit on the card; traced rounds at dropout 0, 0.25,
   0.5 and blackout 1 (``FAULT_TRACE_PASSES`` passes taking the rates in
   turn): their device launches, equal in every trace, and their
   device-busy time; K2 on the faulted round's inputs and K5 with
   ``live_c`` 0 and 1 against their plain versions (their fault-mode
   errors); ``experiments.faults_bench.fault_rows`` (faults off, dropout
   0, 0.25, 0.5, blackout: medians of 10 rounds, the rows interleaved);
22. a Fig. 4-width fault bank (S=4: dropout 0, 0.25, 0.5, blackout 1) on
   the client-folded and streaming engines, ``FAULT_BANK_ROUNDS`` rounds
   counted (K1 10 or K5 100 per scenario round, K2 1), per-scenario
   ``skipped`` and ``n_participants``, each scenario against its own
   ``HotaSim`` rounds (rtol 1e-4, ω relative L2 1e-3), the median bank
   round and one traced bank round;
23. the client-folded fault bank saved, restored onto the card and run
   one more round: equal bit for bit to the uninterrupted round;
24. the faulted distributed step (phase 19's mesh and ``FAULT_RATES``) in
   both count modes, counted as phase 19 (and the participation drawn
   on the card), the modes bit for bit, a blackout step the identity on
   every rank, both against four CPU ranks (metrics rtol 1e-4, ω and the
   stale copy relative L2 1e-3), and the step's split beside phase 19's.

Every counted run also counts the stream draws: the card's two draw
kernels and the plain draw, which must stay at 0 on the card.

Any failure exits non-zero. The line before last is the card's name and
power limit, the one before it the kernels' JSON (K1, K2, K5, K3, K4, K8,
K6, K7 and the two stream draws; each kernel's ``launches`` sums its
counts over the main-path runs of phases 5, 9, 11, 12, 13, 16, 19, 20,
21, 22 and 24, over all ranks, and a kernel never launched there fails
the run; K1, K2, K5 and K6 also carry their fault-mode error); the last
line is
``{"ok": true, "device": {...}}``. An earlier ``[record]`` line holds every
number measured, as JSON.
"""
from __future__ import annotations

import contextlib
import functools
import json
import math
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
INT32_LANES_PER_SM = 64       # Hopper: INT32 units per SM (x SMs x clock)
# INT32-pipe instructions of one threefry2x32 as nvcc builds it for
# sm_90a: 20 rotates (SHF), 21 xors (LOP3) and 7 three-input adds (IADD3),
# from the SASS of a one-chunk generator that ran 4 hashes (80 SHF, 85
# LOP3, 27 IADD3; ``python -m repro_torch.kernels.sass_mix threefry``). The
# hash's other adds issue as IMAD, which Hopper runs on the FMA pipe.
HASH_INT_OPS = 48
HASH_LOGIC_OPS = 41     # the floor: rotates and xors alone
RTOL, ATOL = 1e-5, 1e-6
K34_WIDTHS = (2_097_152, 2_099_200, 135_245)   # fc2.w, fc2 section, small
BANK_S = 8                # scenarios of the packed and per-leaf banks
PERLEAF_ROUNDS = 3        # per-leaf rounds with the counters on
TIMED_PERLEAF_ROUNDS = 5  # per-leaf rounds for the median round time
MASK_ULPS = 16            # per-leaf mask rule: |h² − H_th| within this
SWEEP_ROUNDS = 2          # run_sweep rounds with the tuner on

# phases 14-16: StarCoder2-3B at full width (configs/starcoder2_3b.py)
BF16_FLOPS_PER_S = 989e12     # H100 SXM, dense bf16 tensor cores
K8_SEQ = 8192                 # prefill length: crosses the 4096 window
SERVE_BATCH = 4
SERVE_DECODE_STEPS = 32       # decode-step calls after the prefill
CUT_LAYERS = 2                # phase 15's depth cut (widths unchanged)
CUT_SEQ, CUT_STEPS = 1024, 4
CUT_F32_LIMIT = 1e-4          # card vs CPU logits, relative L2
CUT_BF16_LIMIT = 1e-2         # measured 2.7e-3 to 3.1e-3 on an H100
PREFILL_DECODE_LIMIT = 2e-2   # prefill(S)+decode(1) vs prefill(S+1), bf16
K8_ROW_LIMIT = 1e-2           # bf16 K8 vs plain, relative L2 of each (s, h)
                              # row over D; bf16 output rounding is ~2e-3

# phases 17-20: the distributed step (Table-I MLP, 2 clusters x 2 clients)
TABLE_I_PARAMS = 3_936_512    # the MLP's parameters, 10 leaves
SFU_LANES_PER_SM = 16         # Hopper: transcendental results per SM clock
DIST_SHAPE = (2, 2)           # (cluster, client): four ranks on one card
DIST_BATCH = 24               # examples per client
DIST_CLASSES = 8              # head width
DIST_STEPS = 3                # counted steps per count mode
DIST_TIMED_STEPS = 5          # timed steps per count mode
DIST_LEAVES = 10              # K6 (or K5) launches per rank per step
CPU_RANK_THREADS = 2          # intra-op threads of each CPU rank

# phases 21-24: fault injection (paper round, bank, distributed step)
FAULT_RATES = dict(faults=True, dropout_rate=0.25, blackout_rate=0.1,
                   straggler_rate=0.25, staleness_rounds=2)
FAULT_ROUNDS = 3              # counted faulted rounds
FAULT_TRACE_RATES = {"dropout_0": dict(dropout_rate=0.0),
                     "dropout_0.25": dict(dropout_rate=0.25),
                     "dropout_0.5": dict(dropout_rate=0.5),
                     "blackout_1": dict(blackout_rate=1.0)}
FAULT_TRACE_PASSES = 3        # traced rounds per rate, the rates in turn
FAULT_BANK = [dict(dropout_rate=0.0), dict(dropout_rate=0.25),
              dict(dropout_rate=0.5), dict(blackout_rate=1.0)]
FAULT_BANK_ROUNDS = 2         # counted fault-bank rounds per engine

# the stream draws (phase 10): the card's kernel and the plain draw
DRAW_NAMES = ("threefry_chunked", "threefry_flat", "stream_draw_plain")
DRAW_TOTAL = {}               # device draws over the main-path runs


def _profile_acts():
    import torch
    return [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]


TRACE_MARGIN_S = 0.1     # idle host time before and after a traced body
TRACE_SPACERS = 256      # 1-cycle spacer kernels that open every trace
SPACER_KERNEL = "spin_kernel"    # the kernel of ``torch.cuda._sleep``


@contextlib.contextmanager
def device_trace():
    """A ``torch.profiler`` trace (host and CUDA activity) of the body,
    opened by ``TRACE_SPACERS`` spacer kernels and with ``TRACE_MARGIN_S``
    of idle host time before and after the body.

    On an H100 the profiler dropped kernel records of short traces. In a
    fresh process one trace in 40 placed its kernels up to 2.2 ms before
    their launches and lost the first ones (``python -m
    repro_torch.kernels.trace_probe``); the margins keep such records
    inside the trace. Late in this script, traces of 50 launches kept
    58-72 % of their records with or without the margins, and one kept
    none in 3 tries; opened by the spacers, every trace kept them all.
    ``device_events`` leaves the spacers out.
    """
    import torch
    with torch.profiler.profile(activities=_profile_acts()) as prof:
        time.sleep(TRACE_MARGIN_S)
        for _ in range(TRACE_SPACERS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        yield prof
        torch.cuda.synchronize()
        time.sleep(TRACE_MARGIN_S)


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
    """The profiler's device-side events (kernels and copies), by name,
    without ``device_trace``'s spacers."""
    import torch
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and SPACER_KERNEL not in e.key]


def device_ms(fn, iters: int) -> float:
    """Device time per call of ``fn``: the kernel and copy time the
    profiler records over ``iters`` calls, without the host's launch gaps.
    For a plain version or a whole call; a kernel's own time comes from
    ``kernel_ms``."""
    import torch
    fn()
    torch.cuda.synchronize()
    for _ in range(3):   # a trace that kept no record is taken again
        with device_trace() as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in device_events(prof))
        if total > 0.0:
            return total / 1e3 / iters
    fail("the profiler recorded no device time of a timed call in 3 traces")


SLEEP_CYCLES = 40_000_000   # first spacer kernel: ~20 ms at 1.98 GHz


def kernel_ms(launches, iters: int):
    """Device time per call of a sequence of raw kernel launches (a list
    of callables that never wait for the card), as ``(ms, queued_ms,
    recorded)``.

    ``ms`` is the kernels' own time: the profiler's kernel records over
    ``iters`` traced calls of the sequence (``device_trace``). The
    profiler drops some records late in this script, so the sum over the
    records kept is scaled by launches over records kept (``recorded``,
    the share kept): the mean duration of a kept record stands in for a
    dropped one. A trace that lost records prints which launches lost
    them; one that kept none is taken again with 4 times the calls, up to
    3 times. (Other ways read high: CUDA event pairs around each launch
    put K5's 3.3 µs launches at 7.8 µs, the events' own device time, and
    per-launch traces after a warm-up step read every kernel about twice
    as long as a plain trace.)

    ``queued_ms`` is CUDA events around ``iters`` calls of the sequence
    queued behind a spacer kernel (``torch.cuda._sleep``) that keeps the
    card busy until the host has queued them all: no host launch gaps,
    but the device's gaps between consecutive launches. The spacer grows
    until the queueing fits in it."""
    import torch
    from repro_torch.kernels.trace_probe import format_runs, record_runs
    for fn in launches:
        fn()
    torch.cuda.synchronize()
    traced = iters
    for _ in range(3):
        with device_trace() as prof:
            for _ in range(traced):
                for fn in launches:
                    fn()
            torch.cuda.synchronize()
        ev = device_events(prof)
        n = sum(e.count for e in ev)
        if n < traced * len(launches):
            log(f"[trace] kept {n} of {traced * len(launches)} kernel "
                f"records; launches in host order, {TRACE_SPACERS} spacers "
                f"first: {format_runs(record_runs(prof))}")
        if n > 0:
            break
        traced *= 4
    if n == 0:
        fail("the profiler recorded no kernel of a timed launch in 3 "
             "traces")
    recorded = n / (traced * len(launches))
    ms = sum(e.self_device_time_total for e in ev) / 1e3 / traced / recorded
    cycles = SLEEP_CYCLES
    for _ in range(5):
        e0, e1, e2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        e0.record()
        torch.cuda._sleep(cycles)
        e1.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            for fn in launches:
                fn()
        queued_host_ms = (time.perf_counter() - t0) * 1e3
        e2.record()
        torch.cuda.synchronize()
        if queued_host_ms < e0.elapsed_time(e1):
            return ms, e1.elapsed_time(e2) / iters, recorded
        cycles *= 4
    fail(f"the host needed {queued_host_ms:.1f} ms to queue {iters} calls, "
         f"longer than the largest spacer kernel")


def draw_counters():
    """The stream draws' counters: the card's two kernels and the plain
    draw (``ref.plain_draw_counter``)."""
    from repro_torch.kernels.ota_channel import ops, ref
    return (ops.stream_counter, ops.bits_counter, ref.plain_draw_counter)


def take_draws(where: str, launches: dict, draws_words: bool = True):
    """Move the stream-draw counts out of a run's launch counts and check
    them: a run on the card draws no word with the plain draw, and one that
    draws channel words (``draws_words``) draws them on the card. Adds the
    device draws to ``DRAW_TOTAL``; returns the draw counts."""
    d = {k: launches.pop(k) for k in DRAW_NAMES if k in launches}
    if d.get("stream_draw_plain", 0):
        fail(f"{where}: {d['stream_draw_plain']} plain stream draws on the "
             f"card")
    if draws_words and not d.get("threefry_chunked", 0) + d.get(
            "threefry_flat", 0):
        fail(f"{where}: no stream word drawn on the card")
    for k in DRAW_NAMES[:2]:
        DRAW_TOTAL[k] = DRAW_TOTAL.get(k, 0) + d.get(k, 0)
    return d


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
    if x is None:             # a fault field of an unfaulted state
        return None
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
    from repro_torch import rng
    from repro_torch.core.sweep import ScenarioBank
    out = {}
    for name, esim in sims.items():
        bank = ScenarioBank(esim, specs)
        states = bank.init(rng.PRNGKey(0))
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
    ms, queued_ms, recorded = kernel_ms(
        [functools.partial(kc.launch_mask_weight, *a) for a in calls], 10)
    return {"launches_per_round": len(calls),
            "ms": ms, "queued_ms": queued_ms, "recorded": recorded,
            "launch_ms": cuda_ms(raw, 10),
            "plain_ms": device_ms(plain, 2),
            "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                  nops / F32_FLOPS_PER_S),
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= nops / F32_FLOPS_PER_S else "operations")}


def int32_ops_per_s(dev) -> float:
    """The card's int32 rate: SMs x INT32 lanes x the maximum SM clock
    (``nvidia-smi``'s clocks.max.sm)."""
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    mhz = float(smi.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return sms * INT32_LANES_PER_SM * mhz * 1e6


def k4_hashes(lens, c: int, partitionable: bool) -> int:
    """threefry2x32 hashes K4 runs for sections of ``lens`` entries: one
    per word of each gain stream and of the noise (one per word pair in
    the original layout), plus each block's 2C + 1 key derivations."""
    from repro_torch.kernels.ota_channel.ref import CHUNK
    half, per_block = CHUNK // 2, 512
    hashes = 0
    for n in lens:
        for j0 in range(0, n, CHUNK):
            ln = min(CHUNK, n - j0)
            pairs = min(ln, half)
            hashes += ((c + 1) * (ln if partitionable else pairs)
                       + (2 * c + 1) * (-(-pairs // per_block)))
    return hashes


def check_k34(dev, c, record):
    """Phase 10: K3 and K4 against their plain versions and K3 against
    K4, in both threefry layouts."""
    import torch
    from repro_torch import rng
    from repro_torch.kernels.ota_channel import ops
    from repro_torch.kernels.ota_channel.ref import (
        chunked_stream, ota_aggregate_fused_ref, ota_aggregate_slab_ref,
    )
    gen = torch.Generator(device=dev).manual_seed(10)
    sig = torch.linspace(0.25, 2.5, c, device=dev)
    cases = {"default": (sig, 0.032, 1.0, 1.0), "ota_off": (sig, 0.032, 1.0,
                                                             0.0),
             "sigma0.05": (torch.full_like(sig, 0.05), 0.032, 1.0, 1.0),
             "all_blocked": (sig, 1e9, 5.0, 1.0)}
    errs = {"k3": 0.0, "k4": 0.0}
    prev = rng.threefry_partitionable()
    try:
        for part in (True, False):
            rng.set_threefry_partitionable(part)
            for n in K34_WIDTHS:
                # a column slice of a wider slab, as the packed path reads
                wg = torch.randn((c, n + 1024), generator=gen,
                                 device=dev)[:, 512:512 + n]
                skeys = torch.stack([rng.fold_in(rng.PRNGKey(1), n),
                                     rng.fold_in(rng.PRNGKey(2), n)])
                ckeys = rng.fold_in(skeys[0].unsqueeze(0), torch.arange(c))
                bits = chunked_stream(ckeys, n, dev)
                nbits = chunked_stream(skeys[1], n, dev)
                for cname, (s2, h_th, z, on) in cases.items():
                    args = (s2, h_th, z, on, 3)
                    k3 = ops.ota_aggregate(wg, bits, nbits, *args)
                    k4 = ops._ota_aggregate_fused_impl(
                        wg, skeys.unsqueeze(0), [n], *args)
                    torch.cuda.synchronize()
                    want3 = ota_aggregate_slab_ref(wg, bits, nbits, *args)
                    want4 = ota_aggregate_fused_ref(wg, skeys, *args)
                    what = f"partitionable={part} n={n} {cname}"
                    errs["k3"] = max(errs["k3"], check_close(
                        f"K3 {what}", k3, want3))
                    errs["k4"] = max(errs["k4"], check_close(
                        f"K4 {what}", k4, want4))
                    if not torch.equal(k3, k4):
                        fail(f"K3 != K4 ({what}): "
                             f"{int((k3 != k4).sum())} entries")
                    if cname == "all_blocked" and bool((k4 != 0).any()):
                        fail(f"K4 {what}: nonzero entries")
                log(f"[K3/K4] partitionable={part} n={n}: default, ota_off, "
                    f"sigma0.05, all_blocked within rtol {RTOL} atol {ATOL}; "
                    f"K3 == K4 bit for bit")
    finally:
        rng.set_threefry_partitionable(prev)
    record["k34_check"] = errs
    return errs["k3"], errs["k4"]


def check_draws(dev, c, packer, chan_key, record):
    """Phase 10: the card's stream draws against the plain draws, word for
    word in both threefry layouts, then their time for one round's words
    (the chunk-quantized kernel) and one slab's flat words (K7's gather)
    beside their INT32 bound and the plain draw."""
    import torch
    from repro_torch import rng
    from repro_torch.core import ota
    from repro_torch.kernels.ota_channel import ops, ref
    from repro_torch.kernels.slab import LANE, slab_rows
    chunk, p_total = ref.CHUNK, sum(sec.length for sec in packer.sections)
    prev = rng.threefry_partitionable()
    words, err = 0, 0
    try:
        for part in (True, False):
            rng.set_threefry_partitionable(part)
            keys = rng.fold_in(rng.PRNGKey(7).unsqueeze(0), torch.arange(c))
            table = keys.reshape(-1, 2, 2)      # an (S, C) key table
            cases = []
            for j0, j1 in ((0, 0), (3, 5), (29, 30)):
                cases.append((f"(C, 2) keys, chunks {j0}..{j1}",
                              functools.partial(ops.chunk_stream, keys, j0,
                                                j1, dev),
                              functools.partial(ref.chunk_stream, keys, j0,
                                                j1, dev)))
            for start, length in ((5, 100), (chunk - 7, 20),
                                  (2 * chunk + 3, chunk + 5), (0, p_total)):
                cases.append((f"{tuple(table.shape[:-1])} keys, words "
                              f"[{start}, {start} + {length})",
                              functools.partial(ops.stream_range, table,
                                                start, length, dev),
                              functools.partial(ref.stream_range, table,
                                                start, length, dev)))
            cases.append(("(C, 2) keys, the first P words",
                          functools.partial(ops.chunked_stream, keys,
                                            p_total, dev),
                          functools.partial(ref.chunked_stream, keys,
                                            p_total, dev)))
            for n in (1, chunk - 1, chunk + 1, p_total):
                cases.append((f"flat n={n}",
                              functools.partial(ops.bits, keys[:3], n, dev),
                              functools.partial(rng.bits, keys[:3], n,
                                                device=dev)))
            for what, got_fn, want_fn in cases:
                got = got_fn()
                torch.cuda.synchronize()
                want = want_fn()
                if got.shape != want.shape or not torch.equal(got, want):
                    fail(f"stream draw (partitionable={part}) {what}: "
                         f"{int((got != want).sum())} words differ from "
                         f"the plain draw")
                words += got.numel()
                err = max(err, int((got.long() - want.long()).abs().max()))
                del got, want
            log(f"[draw] partitionable={part}: the card's words equal the "
                f"plain draw's in {len(cases)} cases (chunk ranges, offsets "
                f"inside a chunk, flat n = 1, CHUNK - 1, CHUNK + 1, "
                f"{p_total})")
    finally:
        rng.set_threefry_partitionable(prev)

    # one round's words: every section's (C, len) gain and (len,) noise
    # stream, the launches a client-folded round makes, keys staged first
    folds = torch.tensor(ota.packed_section_folds(packer), dtype=torch.int64)
    skeys = rng.fold_in(rng.as_key(chan_key).unsqueeze(0), folds)
    nkeys = rng.fold_in(ota.noise_key(chan_key).unsqueeze(0), folds)
    launches, plains, n_words = [], [], 0
    for sec in packer.sections:
        gkeys = rng.fold_in(skeys[sec.index].unsqueeze(0), torch.arange(c))
        for kk in (gkeys, nkeys[sec.index:sec.index + 1]):
            kd = rng.to_bit_pattern(kk).to(dev)
            out = torch.empty((kd.shape[0], sec.length), dtype=torch.int32,
                              device=dev)
            launches.append(functools.partial(ops.launch_chunked, kd, 0, out))
            plains.append(functools.partial(ref.chunked_stream, kk,
                                            sec.length, dev))
            n_words += kd.shape[0] * sec.length
    ms, queued, kept = kernel_ms(launches, 20)
    plain_ms = device_ms(lambda: [f() for f in plains], 2)
    # one hash per word (partitionable) and one chunk key per block of
    # 2048 words; 4 bytes written per word
    hashes = n_words + -(-n_words // 2048)
    int_rate = int32_ops_per_s(dev)
    t_ops = hashes * HASH_INT_OPS / int_rate
    t_bytes = 4 * n_words / HBM_BYTES_PER_S
    chunked = {"words": n_words, "launches_per_round": len(launches),
               "ms": ms, "queued_ms": queued, "recorded": kept,
               "plain_ms": plain_ms, "bound_ms": 1e3 * max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "max_abs_err": float(err)}

    # one slab's flat words (K7's packed ω̃ gather: the Table-I slab padded
    # to whole rows)
    n_flat = slab_rows(TABLE_I_PARAMS) * LANE
    fkey = rng.fold_in(rng.PRNGKey(78), 1)
    kd = rng.to_bit_pattern(fkey.reshape(1, 2)).to(dev)
    out = torch.empty((1, n_flat), dtype=torch.int32, device=dev)
    fms, fqueued, fkept = kernel_ms(
        [functools.partial(ops.launch_flat, kd, out)], 50)
    fplain = device_ms(lambda: rng.bits(fkey, n_flat, device=dev), 3)
    t_ops = (n_flat + -(-n_flat // 1024)) * HASH_INT_OPS / int_rate
    t_bytes = 4 * n_flat / HBM_BYTES_PER_S
    flat = {"words": n_flat, "ms": fms, "queued_ms": fqueued,
            "recorded": fkept, "plain_ms": fplain,
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "max_abs_err": float(err)}
    if min(ms, plain_ms, fms, fplain) <= 0.0:
        fail("no device time measured for the stream draws")
    record["draws"] = {"words_checked": words, "chunked": chunked,
                       "flat": flat}
    log(f"[time] stream draw of one round's words ({n_words:,} words, "
        f"{len(launches)} launches): {ms:.4f} ms device (queued "
        f"{queued:.4f}, records kept {kept:.0%}), plain draw "
        f"{plain_ms:.4f} ms, bound {chunked['bound_ms']:.4f} ms "
        f"({chunked['bound_by']}); flat draw of {n_flat:,} words: "
        f"{fms:.4f} ms (plain {fplain:.4f}, bound {flat['bound_ms']:.4f})")
    return chunked, flat


def packed_path(sim, state, batch, key, dev, record, counters):
    """Phase 11: the packed engine at full width on one round's gradients,
    counted; the S=8 bank with the words drawn once; device times."""
    import torch
    from repro_torch import rng
    from repro_torch.common.config import FLConfig
    from repro_torch.common.tree import tree_leaves, tree_map
    from repro_torch.core import ota
    from repro_torch.core.channel import (
        channel_params, scenario_channel, stack_channel_params,
    )
    from repro_torch.kernels.ota_channel import ops
    from repro_torch.kernels.ota_channel.ref import (
        ota_aggregate_fused_ref, ota_aggregate_slab_ref,
    )
    fl = sim.fl
    c, n_cl = fl.n_clusters, fl.n_clients
    x = torch.as_tensor(batch[0]).to(dev)
    y = torch.as_tensor(batch[1]).to(device=dev, dtype=torch.int64)
    _, _, g, _ = sim._client_update(state.omega, state.heads, state.head_opt,
                                    x, y)
    p = torch.rand(state.p.shape, device=dev) + 0.5
    wt = tree_map(lambda l: torch.einsum("cn,cn...->c...", p, l), g)
    chan, chan_key = sim.chan, ota.sim_channel_key(key)
    packer = sim.packer(state.omega)
    n_sec = len(packer.sections)
    bank = stack_channel_params([channel_params(FLConfig(
        n_clusters=c, n_clients=n_cl, sigma2=(0.25 + 0.25 * (s % 8),),
        ota=(s % 4 != 3)), device=dev) for s in range(BANK_S)])

    def flat(tree):
        return torch.cat([l.reshape(-1) for l in tree_leaves(tree)])

    def packed_bank():
        """Draw once, then one whole-slab K3 estimate per scenario."""
        wg = packer.pack(wt)
        bits = ota.packed_gain_bits(chan_key, packer, c, dev)
        nbits = ota.packed_noise_bits(chan_key, packer, dev)
        return [packer.unpack(ops.ota_aggregate(
            wg, bits, nbits, *scenario_channel(bank, s)[:4], n_cl))
            for s in range(BANK_S)]

    def perleaf_bank():
        return [ota.ota_aggregate_tree(chan_key, wt, scenario_channel(bank, s),
                                       n_cl) for s in range(BANK_S)]

    torch.cuda.synchronize()
    for ctr in counters:
        ctr.reset()
    fused = flat(ota.ota_aggregate_packed(chan_key, wt, chan, n_cl, packer))
    supplied = flat(ota.ota_aggregate_packed(chan_key, wt, chan, n_cl, packer,
                                             bits_mode="supplied"))
    banked = [flat(t) for t in packed_bank()]
    torch.cuda.synchronize()
    launches = {ctr.name: ctr.count for ctr in counters}
    record["packed_draws"] = take_draws("packed path", launches)
    want = {"ota_client_fold": 0, "masked_gradnorm": 0, "ota_mask_weight": 0,
            "ota_aggregate": n_sec + BANK_S, "ota_aggregate_fused": n_sec}
    if launches != want:
        fail(f"packed path launches {launches}, expected {want}")
    if not torch.isfinite(fused).all():
        fail("packed path: non-finite estimate")
    if not torch.equal(fused, supplied):
        fail(f"packed fused != supplied: {int((fused != supplied).sum())} "
             f"entries")
    s0 = flat(ota.ota_aggregate_packed(chan_key, wt, scenario_channel(bank, 0),
                                       n_cl, packer, bits_mode="supplied"))
    if not torch.equal(banked[0], s0):
        fail("packed bank scenario 0 differs from its single packed call")
    cf = flat(ota.ota_aggregate_client_folded(chan_key, g, p, chan, n_cl,
                                              packer))
    cf_err = check_close("client-folded vs einsum + packed", cf, fused)
    log(f"[packed] {packer.size} slab entries, {n_sec} sections: fused == "
        f"supplied bit for bit; client-folded vs einsum + packed max abs "
        f"err {cf_err:.3e}; S={BANK_S} bank scenario 0 == its single call; "
        f"launches {launches}")

    # device and host time of one call and of the S=8 bank, against the
    # per-leaf engine on the same weighted tree
    times = {}
    for name, fn, iters in (
            ("packed", lambda: ota.ota_aggregate_packed(
                chan_key, wt, chan, n_cl, packer), 5),
            ("perleaf", lambda: ota.ota_aggregate_tree(
                chan_key, wt, chan, n_cl), 2),
            (f"packed_S{BANK_S}", packed_bank, 2),
            (f"perleaf_S{BANK_S}", perleaf_bank, 1)):
        times[name] = {"device_ms": device_ms(fn, iters),
                       "host_ms": statistics.median(host_ms(fn)
                                                    for _ in range(3))}
    log(f"[packed time] device ms (host ms): " + "; ".join(
        f"{k} {v['device_ms']:.3f} ({v['host_ms']:.3f})"
        for k, v in times.items()))

    # K3 and K4 at the packed call's shapes: one launch per section
    wg = packer.pack(wt)
    bits = ota.packed_gain_bits(chan_key, packer, c, dev)
    nbits = ota.packed_noise_bits(chan_key, packer, dev)
    skeys = ota.packed_section_keys(chan_key, packer)
    params = ops.aggregate_params(*chan[:4], c, device=dev)
    pp = ops._slab_p_pass(params, c)
    out = torch.empty(packer.size, device=dev)
    secs = []
    off = 0
    for sec in packer.sections:
        secs.append((slice(off, off + sec.length), skeys[sec.index]))
        off += sec.length
    part = rng.threefry_partitionable()
    k3_launches = [functools.partial(
        ops.launch_aggregate, wg[:, cols], bits[:, cols], nbits[cols], params,
        pp, n_cl, out[cols]) for cols, _ in secs]

    def k4_launches(partitionable):
        return [functools.partial(
            ops.launch_aggregate_fused, wg[:, cols], k, params, pp, n_cl,
            out[cols], partitionable) for cols, k in secs]

    def run_all(launches):
        for fn in launches:
            fn()

    def k3_plain():
        for cols, _ in secs:
            ota_aggregate_slab_ref(wg[:, cols], bits[:, cols], nbits[cols],
                                   *chan[:4], n_cl, p_pass=pp)

    def k4_plain():
        for cols, k in secs:
            ota_aggregate_fused_ref(wg[:, cols], k, *chan[:4], n_cl,
                                    p_pass=pp)

    def draw():
        ota.packed_gain_bits(chan_key, packer, c, dev)
        ota.packed_noise_bits(chan_key, packer, dev)
    n = packer.size
    lens = [s.length for s in packer.sections]
    rate = int32_ops_per_s(dev)
    k3_bytes = 4 * n * (2 * c + 2) + 4 * n_sec * (2 * c + 3)
    k3_ops = n * (3 * c + 30)
    k4_bytes = 4 * n * (c + 1) + 4 * n_sec * (2 * c + 3)

    def k4_bound(partitionable, per_hash=HASH_INT_OPS):
        ops_ = k4_hashes(lens, c, partitionable) * per_hash
        return ops_, 1e3 * max(k4_bytes / HBM_BYTES_PER_S, ops_ / rate)
    k4_ops, k4_bound_ms = k4_bound(part)
    k3_ms, k3_queued, k3_rec = kernel_ms(k3_launches, 20)
    k4_ms, k4_queued, k4_rec = kernel_ms(k4_launches(part), 20)
    k3 = {"launches_per_call": n_sec,
          "ms": k3_ms, "queued_ms": k3_queued, "recorded": k3_rec,
          "launch_ms": cuda_ms(lambda: run_all(k3_launches), 20),
          "plain_ms": device_ms(k3_plain, 3),
          "bound_ms": 1e3 * max(k3_bytes / HBM_BYTES_PER_S,
                                k3_ops / F32_FLOPS_PER_S),
          "bound_by": ("bytes" if k3_bytes / HBM_BYTES_PER_S
                       >= k3_ops / F32_FLOPS_PER_S else "operations")}
    k4 = {"launches_per_call": n_sec,
          "ms": k4_ms, "queued_ms": k4_queued, "recorded": k4_rec,
          "launch_ms": cuda_ms(lambda: run_all(k4_launches(part)), 20),
          "plain_ms": device_ms(k4_plain, 2),
          "bound_ms": k4_bound_ms,
          "bound_by": ("bytes" if k4_bytes / HBM_BYTES_PER_S
                       >= k4_ops / rate else "operations"),
          "int32_ops": k4_ops, "int32_ops_per_s": rate,
          "logic_floor_ms": k4_bound(part, HASH_LOGIC_OPS)[1],
          "partitionable": part}
    # the other bits layout halves the hashes (one hash per word pair)
    other = not part
    k4["other_layout"] = {
        "partitionable": other,
        "ms": kernel_ms(k4_launches(other), 20)[0],
        "bound_ms": k4_bound(other)[1],
        "logic_floor_ms": k4_bound(other, HASH_LOGIC_OPS)[1]}
    draw_ms = device_ms(draw, 2)
    if min(k3["ms"], k4["ms"], k3["plain_ms"], k4["plain_ms"], draw_ms) <= 0:
        fail("no device time measured for K3 or K4")
    k4["torch_draw_ms"] = draw_ms
    k4["draw_over_k4"] = draw_ms / k4["ms"]
    log(f"[time] K3 ({n_sec} launches, {n} entries): {k3['ms']:.4f} ms device "
        f"(queued {k3['queued_ms']:.4f}, launch {k3['launch_ms']:.4f}, plain "
        f"{k3['plain_ms']:.4f}, bound {k3['bound_ms']:.4f} "
        f"({k3['bound_by']})); K4: {k4['ms']:.4f} ms device (queued "
        f"{k4['queued_ms']:.4f}, launch {k4['launch_ms']:.4f}, plain "
        f"{k4['plain_ms']:.4f}, bound {k4['bound_ms']:.4f} ({k4['bound_by']}: "
        f"{k4_ops:.3e} int32 ops at {rate:.3e}/s; rotates and xors alone "
        f"{k4['logic_floor_ms']:.4f}); partitionable={other}: "
        f"{k4['other_layout']['ms']:.4f} ms, bound "
        f"{k4['other_layout']['bound_ms']:.4f}); the int64 torch draw it "
        f"replaces {draw_ms:.3f} ms device, {k4['draw_over_k4']:.1f}x K4; "
        f"profiler records kept: K3 {k3_rec:.0%}, K4 {k4_rec:.0%}")
    record["packed"] = {"launches": launches, "client_folded_max_abs": cf_err,
                        "times": times, "k3": k3, "k4": k4}
    return launches, k3, k4


def perleaf_phase(sim, batcher, key0, dev, record, counters):
    """Phase 12: the per-leaf oracle's round at full width on the card,
    counted, against the CPU round, and timed."""
    import dataclasses
    import torch
    from repro_torch import rng
    from repro_torch.common.tree import tree_flatten_with_path, tree_leaves
    from repro_torch.core import ota
    from repro_torch.core.sim import HotaSim
    fl = dataclasses.replace(sim.fl, use_pallas_ota=False)
    n_cls = sim.n_classes.tolist()
    psim = HotaSim(sim.model, fl, sim.tcfg, n_cls, device=dev)
    st = psim.init(rng.PRNGKey(0))
    batches = [batcher.next_stacked() for _ in range(PERLEAF_ROUNDS + 1)]
    keys = [rng.fold_in(key0, 3000 + r) for r in range(PERLEAF_ROUNDS + 1)]
    torch.cuda.synchronize()
    for ctr in counters:
        ctr.reset()
    losses = []
    for r in range(PERLEAF_ROUNDS):
        st, m = psim.step(st, *batches[r], keys[r])
        losses.append(m["loss"])
    torch.cuda.synchronize()
    launches = {ctr.name: ctr.count for ctr in counters}
    record["perleaf_draws"] = take_draws("per-leaf round", launches,
                                         draws_words=False)
    want = {ctr.name: 0 for ctr in counters if ctr.name not in DRAW_NAMES}
    want["masked_gradnorm"] = PERLEAF_ROUNDS
    if launches != want:
        fail(f"per-leaf launches {launches}, expected {want}")
    if not torch.isfinite(torch.stack(losses)).all():
        fail("per-leaf round: non-finite loss")

    cpu_sim = HotaSim(sim.model, fl, sim.tcfg, n_cls, device="cpu")
    st_cpu = to_cpu(st)
    new_gpu, m_gpu = psim.step(st, *batches[-1], keys[-1])
    new_cpu, m_cpu = cpu_sim.step(st_cpu, *batches[-1], keys[-1])
    cmp = {name: check_close(f"per-leaf round {name}", m_gpu[name].cpu(),
                             m_cpu[name], rtol=1e-4, atol=1e-6)
           for name in ("loss", "p")}
    w_gpu = torch.cat([l.reshape(-1).cpu() for l in tree_leaves(new_gpu.omega)])
    w_cpu = torch.cat([l.reshape(-1) for l in tree_leaves(new_cpu.omega)])
    cmp["omega_rel_l2"] = rel_l2(w_gpu, w_cpu)
    if cmp["omega_rel_l2"] > 1e-3:
        fail(f"per-leaf card round vs CPU round: {cmp}")
    # the round's eq.-7 masks on both devices: a flip counts only where
    # |h² − H_th| is within MASK_ULPS ulp of H_th (erfinv's last place)
    chan_key = ota.sim_channel_key(keys[-1])
    h_th = float(psim.chan.h_threshold)
    tol = MASK_ULPS * float(torch.finfo(torch.float32).eps) * h_th
    flips = near = total = 0
    for i, (_, leaf) in enumerate(tree_flatten_with_path(st.omega)):
        ks = ota.leaf_key(chan_key, i)
        shape = tuple(leaf.shape)
        h_g = ota._cluster_gains(ks, shape, psim.chan, dev).cpu()
        h_c = ota._cluster_gains(ks, shape, cpu_sim.chan, "cpu")
        diff = (h_g * h_g >= h_th) != (h_c * h_c >= h_th)
        close = (h_c * h_c - h_th).abs() <= tol
        flips += int(diff.sum())
        near += int((diff & close).sum())
        total += diff.numel()
        if bool((diff & ~close).any()):
            fail(f"per-leaf masks: leaf {i} flips "
                 f"{int((diff & ~close).sum())} entries away from H_th")
    cmp.update(mask_flips=flips, mask_entries=total)
    record_round = []
    st_t = new_gpu
    for r in range(TIMED_PERLEAF_ROUNDS):
        b_r = batcher.next_stacked()
        k_r = rng.fold_in(key0, 3100 + r)

        def one():
            nonlocal st_t
            st_t, _ = psim.step(st_t, *b_r, k_r)
        record_round.append(host_ms(one))
    record["perleaf"] = {"launches": launches, "card_vs_cpu": cmp,
                         "round_ms": record_round,
                         "round_ms_median": statistics.median(record_round),
                         "loss_mean_per_round": [float(l.mean())
                                                 for l in losses]}
    log(f"[per-leaf] {PERLEAF_ROUNDS} rounds, launches {launches}; card vs "
        f"CPU {cmp}; median round "
        f"{record['perleaf']['round_ms_median']:.2f} ms (all "
        f"{['%.2f' % t for t in record_round]})")
    return launches


def tuner_phase(sim, batcher, dev, record, counters):
    """Phase 13: calibrate the paper template on the card with the layout
    cache off; one bank round on the winning layout against the same round
    on the CPU; then a short tuned Fig. 4 sweep, counted, that reads the
    winner from a cache file of its own and writes its results to a
    directory of its own (both temporary)."""
    import shutil
    import tempfile
    import torch
    from repro_torch import rng
    from repro_torch.common import layout_tune
    from repro_torch.common.tree import tree_leaves, tree_map
    from repro_torch.core.sim import HotaSim
    from repro_torch.core.sweep import ScenarioBank
    from repro_torch.experiments import paper_common
    from repro_torch.experiments.fig4_diverse_sigma import (
        experiments as fig4_experiments,
    )
    fl = sim.fl
    c, n_cl = fl.n_clusters, fl.n_clients
    template = tree_map(lambda spec: spec.shape,
                        {"final": sim.model.final_specs(),
                         "trunk": sim.model.trunk_specs()})
    t0 = time.perf_counter()
    choice, report = layout_tune.calibrate_layout(template, c, n_cl,
                                                  device=dev)
    cal_s = time.perf_counter() - t0
    for r in report:
        log(f"[tune] {r['layout']:>44}: {r['us']:12.1f} us, "
            f"{r['peak_bytes']:>11} estimated peak bytes")
    log(f"[tune] winner {choice.describe()} ({cal_s:.1f} s to calibrate)")

    # one bank round on the winning layout, card against CPU
    fl_t = layout_tune.apply_layout(fl, choice)
    n_cls = sim.n_classes.tolist()
    specs = list(fig4_experiments().values())
    tbank = ScenarioBank(HotaSim(sim.model, fl_t, sim.tcfg, n_cls,
                                 device=dev), specs)
    cbank = ScenarioBank(HotaSim(sim.model, fl_t, sim.tcfg, n_cls,
                                 device="cpu"), specs)
    states = tbank.init(rng.PRNGKey(0))
    x, y = batcher.next_stacked()
    key = rng.PRNGKey(4000)
    st_g, m_g = tbank.step(states, x, y, key)
    st_c, m_c = cbank.step(to_cpu(states), x, y, key)
    cmp = {m: check_close(f"tuned bank round {m}", m_g[m].cpu(), m_c[m],
                          rtol=1e-4, atol=1e-6) for m in ("loss", "p")}
    cmp["omega_rel_l2"] = rel_l2(
        torch.cat([l.reshape(-1).cpu() for l in tree_leaves(st_g.omega)]),
        torch.cat([l.reshape(-1) for l in tree_leaves(st_c.omega)]))
    if cmp["omega_rel_l2"] > 1e-3:
        fail(f"tuned bank round, card vs CPU: {cmp}")
    log(f"[tune] one {choice.describe()} bank round of {len(specs)} "
        f"scenarios, card vs CPU: {cmp}")

    # the tuned sweep, counted: the winner from a cache file of its own
    # (so the sweep does not calibrate again), results in a directory of
    # its own (so 2 rounds never stand in for a figure's results)
    per = SWEEP_ROUNDS * len(specs)       # scenario rounds of the sweep
    packer = tbank.sim.packer(tbank.scenario_state(states, 0).omega)
    n_runs = 0 if packer is None else len(packer.leaf_runs())  # K1 each
    want = {ctr.name: 0 for ctr in counters if ctr.name not in DRAW_NAMES}
    want.update(ota_client_fold=n_runs * per, masked_gradnorm=per)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    cache_prev = os.environ.get(layout_tune.CACHE_ENV)
    try:
        cache = os.path.join(tmp, "layout_tune.json")
        with open(cache, "w") as f:
            json.dump({layout_tune.template_hash(template, c, n_cl,
                                                 device=dev):
                       choice.to_metadata()}, f)
        os.environ[layout_tune.CACHE_ENV] = cache
        torch.cuda.synchronize()
        for ctr in counters:
            ctr.reset()
        t0 = time.perf_counter()
        res = paper_common.run_sweep(
            fig4_experiments(), steps=SWEEP_ROUNDS, n_clusters=c,
            n_clients=n_cl, force=True, log_every=1, tune=True, device=dev,
            results_dir=os.path.join(tmp, "results"))
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
        launches = {ctr.name: ctr.count for ctr in counters}
    finally:
        if cache_prev is None:
            os.environ.pop(layout_tune.CACHE_ENV, None)
        else:
            os.environ[layout_tune.CACHE_ENV] = cache_prev
        shutil.rmtree(tmp, ignore_errors=True)
    record["tuned_sweep_draws"] = take_draws("tuned sweep", launches)
    if launches != want:
        fail(f"tuned sweep on {choice.describe()}: launches {launches}, "
             f"expected {want}")
    for name, r in res.items():
        if r["layout"] != choice.describe():
            fail(f"tuned sweep ran {name} on {r['layout']}, not on the "
                 f"winner {choice.describe()}")
        if not all(math.isfinite(v) for v in r["loss_mean_tasks"][-1]):
            fail(f"tuned sweep: non-finite loss in {name}")
    record["tune"] = {"winner": choice.describe(), "calibrate_s": cal_s,
                      "report": [{k: v for k, v in r.items() if k != "choice"}
                                 for r in report],
                      "bank_round_vs_cpu": cmp, "sweep_launches": launches,
                      "sweep_s": sweep_s}
    log(f"[tune] tuned sweep: {SWEEP_ROUNDS} rounds x {len(res)} scenarios on "
        f"{choice.describe()} in {sweep_s:.1f} s (set-up included), "
        f"launches {launches}")
    return launches


def attention_pairs(s: int, window) -> int:
    """Unmasked (query, key) pairs of causal self-attention over s
    positions, with an optional sliding window."""
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def k8_bound(b, s, h, n_kv, d, window, elt):
    """K8's bound at these shapes: (ms, bound_by, flops, bytes)."""
    flops = 4 * d * attention_pairs(s, window) * b * h
    nbytes = elt * b * s * d * (2 * h + 2 * n_kv)   # q, o; k, v
    peak = BF16_FLOPS_PER_S if elt == 2 else F32_FLOPS_PER_S
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def sdpa_ms(q, k, v, window, causal_only: bool) -> float:
    """One ``scaled_dot_product_attention`` call (the library yardstick,
    never used by the port) on K8's inputs, GQA by ``enable_gqa``."""
    import torch
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if causal_only:
        def call():
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                           enable_gqa=True)
    else:
        s = q.shape[1]
        pos = torch.arange(s, device=q.device)
        diff = pos[:, None] - pos[None, :]
        mask = (diff >= 0) & (diff < window)

        def call():
            F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                           enable_gqa=True)
    return cuda_ms(call, 3, warmup=1)


def max_row_rel_l2(got, want) -> float:
    """Largest relative L2 over the last axis of (..., D) outputs: one
    dropped or repeated key tile moves every row of its query tile by
    ~10 %, far above bf16 rounding, though it stays under an elementwise
    atol that must admit one bf16 step at |o| of a few units."""
    import torch
    got, want = got.float(), want.float()
    num = torch.linalg.vector_norm(got - want, dim=-1)
    den = torch.linalg.vector_norm(want, dim=-1).clamp_min(1e-30)
    return float((num / den).max())


def k8_compare(name, got, want, tol, record):
    """K8's output against its plain version: elementwise within ``tol``
    and, in bf16, every row within ``K8_ROW_LIMIT`` relative L2."""
    import torch
    err = check_close(name, got.float(), want.float(), rtol=tol, atol=tol)
    row = None
    if want.dtype == torch.bfloat16:
        row = max_row_rel_l2(got, want)
        if row > K8_ROW_LIMIT:
            fail(f"{name}: a row's relative L2 {row:.3e} is over "
                 f"{K8_ROW_LIMIT:g}")
    record[name] = {"max_abs_err": err, "max_row_rel_l2": row}
    return err


def k8_phase(dev, record):
    """Phase 14: K8 against its plain version on the card, then its time at
    the full-width prefill shape (the serve's B=4) beside its bound, its
    plain version and SDPA on the same inputs."""
    import torch
    from repro_torch.kernels.flash_attention import ops as k8
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    gen = torch.Generator(device=dev).manual_seed(14)
    cfg = sc2_config()
    h, n_kv, d, w = (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
                     cfg.sliding_window)

    def inputs(b, s, hh, kv, dd, dtype):
        return tuple(torch.randn((b, s, n, dd), generator=gen, device=dev
                                 ).to(dtype) for n in (hh, kv, kv))

    # (B, S, H, KV, D, window): D 64/128/240, G 1/2/12, no window and
    # windows under a key tile, ragged S, and S = 8193 (one row past a
    # 128-row tile) with no window at D 64 and 128. In bfloat16, D 64 and
    # 128 run the Hopper kernel (TMA + wgmma), D 240 the mma.sync one;
    # float32 runs the FMA kernel (ops.kernel_for)
    cases = [(2, 256, 4, 4, 64, None), (2, 256, 4, 2, 128, 64),
             (1, 300, 24, 2, 128, 5), (1, 129, 4, 2, 240, 17),
             (2, 77, 12, 1, 64, None), (1, 1, 24, 2, 128, None),
             (1, 1000, 8, 4, 240, 100), (1, 8193, 4, 2, 64, None),
             (1, 8193, 4, 2, 128, None)]
    tols = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
    checks = {}
    for dtype, tol in tols.items():
        for case in cases:
            q, k, v = inputs(*case[:5], dtype)
            got = k8.flash_attention(q, k, v, window=case[5])
            torch.cuda.synchronize()
            want = flash_attention_ref(q, k, v, window=case[5])
            name = (f"{case} {str(dtype)[6:]} "
                    f"{k8.kernel_for(dtype, case[4])}")
            k8_compare(name, got, want, tol, checks)
            del q, k, v, got, want
    log(f"[K8] small shapes, float32 within 2e-5, bfloat16 within 2e-2 "
        f"and rows within relative L2 {K8_ROW_LIMIT:g}: {json.dumps(checks)}")

    # full width at the serve's B=4: the plain version runs one batch
    # element at a time (its score matrix is 6.4 GB per element)
    s, b = K8_SEQ, SERVE_BATCH
    q, k, v = inputs(b, s, h, n_kv, d, torch.bfloat16)
    got = k8.flash_attention(q, k, v, window=w)
    torch.cuda.synchronize()

    def plain():
        return [flash_attention_ref(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                    window=w) for i in range(b)]
    full = {}
    for i, want in enumerate(plain()):
        k8_compare(f"b{i}", got[i:i + 1], want, 2e-2, full)
    del want
    full_err = max(c["max_abs_err"] for c in full.values())
    full_row = max(c["max_row_rel_l2"] for c in full.values())
    log(f"[K8] full-width layer (B={b}, S={s}, H={h}, KV={n_kv}, D={d}, "
        f"W={w}, bf16), each batch element against the plain version: "
        f"max abs err {full_err:.3e} (limit 2e-2), max row relative L2 "
        f"{full_row:.3e} (limit {K8_ROW_LIMIT:g})")

    # times, all on these B=4 inputs. K8's "ms" is CUDA events around 5
    # back-to-back launches: a launch lasts milliseconds, so the events'
    # microseconds do not count, and the profiler's records (kernel_ms)
    # can all be dropped for so few. B=1 readings slice element 0.
    # The mma.sync design this shape ran on before the Hopper kernel is
    # timed in the same run, in turns: new, old, old, new.
    out = torch.empty_like(q)

    def new():
        k8.launch(q, k, v, out, w)

    def old():
        k8.launch(q, k, v, out, w, kernel="mma_sync")
    turns = [cuda_ms(new, 5, warmup=1), cuda_ms(old, 5, warmup=1),
             cuda_ms(old, 5, warmup=1), cuda_ms(new, 5, warmup=1)]
    ms = (turns[0] + turns[3]) / 2
    ms_mma_sync = (turns[1] + turns[2]) / 2
    plain_ms = cuda_ms(plain, 2, warmup=1)
    bound, bound_by, flops, nbytes = k8_bound(b, s, h, n_kv, d, w, 2)
    torch.cuda.empty_cache()
    causal = sdpa_ms(q, k, v, w, causal_only=True)
    try:
        lib = sdpa_ms(q, k, v, w, causal_only=False)
    except torch.cuda.OutOfMemoryError:
        lib = None
    torch.cuda.empty_cache()
    q1, k1, v1, out1 = q[:1], k[:1], v[:1], out[:1]
    ms_b1 = cuda_ms(lambda: k8.launch(q1, k1, v1, out1, w), 5, warmup=1)
    bound_b1 = k8_bound(1, s, h, n_kv, d, w, 2)[0]
    lib_b1 = sdpa_ms(q1, k1, v1, w, causal_only=False)
    causal_b1 = sdpa_ms(q1, k1, v1, w, causal_only=True)
    del q, k, v, out, got, q1, k1, v1, out1
    torch.cuda.empty_cache()
    if min(ms, plain_ms, lib or 1.0) <= 0.0:
        fail("no device time measured for K8")
    rec = {"small": checks, "full": full, "max_abs_err_full": full_err,
           "max_row_rel_l2_full": full_row, "batch": b,
           "ms": ms, "bound_ms": bound, "bound_by": bound_by,
           "ms_turns_new_old_old_new": turns, "ms_mma_sync": ms_mma_sync,
           "flops": flops, "bytes": nbytes, "tflops_per_s": flops / ms / 1e9,
           "plain_ms": plain_ms, "sdpa_window_mask_ms": lib,
           "sdpa_causal_ms": causal, "ms_b1": ms_b1, "bound_ms_b1": bound_b1,
           "sdpa_window_mask_ms_b1": lib_b1, "sdpa_causal_ms_b1": causal_b1}
    record["k8"] = rec
    lib_txt = "out of memory" if lib is None else f"{lib:.4f}"
    log(f"[time] K8 (B={b}, S={s}, H={h}, KV={n_kv}, D={d}, W={w}, bf16): "
        f"{ms:.4f} ms per launch, {flops / ms / 1e9:.1f} TFLOP/s, bound "
        f"{bound:.4f} ms ({bound_by}); the mma.sync design it replaced "
        f"{ms_mma_sync:.4f} (turns new/old/old/new "
        f"{['%.4f' % t for t in turns]}); plain version {plain_ms:.4f} "
        f"({b} calls at B=1); SDPA causal-only {causal:.4f}, SDPA with the "
        f"window mask {lib_txt}. At B=1: K8 {ms_b1:.4f}, bound "
        f"{bound_b1:.4f}, SDPA window mask {lib_b1:.4f}, causal-only "
        f"{causal_b1:.4f}")
    err = [c["max_abs_err"] for c in list(checks.values())
           + list(full.values())]
    return max(err), rec


def lm_logit_check(name, got, want, limit, record):
    """Relative L2 of (B, V) logits within ``limit``, and the same argmax
    wherever the top-2 gap exceeds the row's largest difference."""
    import torch
    got, want = got.float().cpu(), want.float().cpu()
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite logits")
    rel = rel_l2(got, want)
    top2 = want.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    diff = (got - want).abs().max(dim=-1).values
    decided = gap > diff
    same = got.argmax(-1) == want.argmax(-1)
    record[name] = {"rel_l2": rel, "max_abs": float(diff.max()),
                    "argmax_decided": int(decided.sum()),
                    "argmax_equal": int(same.sum())}
    if rel > limit or bool((decided & ~same).any()):
        fail(f"{name}: {record[name]} (relative L2 limit {limit})")
    return rel


def cut_phase(dev, record):
    """Phase 15: a 2-layer cut of full-width StarCoder2-3B, prefill and 4
    decode steps on the card against the same on the CPU, in float32 and
    in bfloat16 compute; the card is fed the CPU's greedy tokens."""
    import torch
    from repro_torch.common.tree import tree_map
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    rec = {}
    s, steps = CUT_SEQ, CUT_STEPS

    def run(model, wts, d, prompt, forced=None):
        """Logits of the prefill and each decode step, (B, V) each."""
        lg, cache = make_prefill_step(model, cache_len=s + steps + 1)(
            *wts, prompt.to(d))
        out = [lg]
        for i in range(steps):
            tok = (lg.argmax(-1) if forced is None else forced[i]).to(d)
            pos = torch.full((1,), s + i, dtype=torch.int32, device=d)
            _, lg, cache = make_decode_step(model)(*wts, cache,
                                                   tok[:, None].long(), pos)
            out.append(lg)
        return out

    for cdt, limit in (("float32", CUT_F32_LIMIT),
                       ("bfloat16", CUT_BF16_LIMIT)):
        cfg = sc2_config().replace(n_layers=CUT_LAYERS, compute_dtype=cdt)
        model = serve_mod.serving_model(cfg)
        w_dev = serve_mod.init_weights(model, 0, dev)
        w_cpu = tuple(tree_map(lambda t: t.cpu(), w) for w in w_dev)
        prompt = serve_mod.draw_prompt(cfg, 1, s, 0)
        t0 = time.perf_counter()
        cpu = run(model, w_cpu, torch.device("cpu"), prompt)
        rec[f"{cdt}_cpu_s"] = time.perf_counter() - t0
        card = run(model, w_dev, dev, prompt,
                   forced=[lg.argmax(-1) for lg in cpu])
        torch.cuda.synchronize()
        rels = [lm_logit_check(f"cut_{cdt}_step{i}", g, c, limit, rec)
                for i, (g, c) in enumerate(zip(card, cpu))]
        rec[f"{cdt}_rel_l2"] = rels
        log(f"[cut] {CUT_LAYERS}-layer StarCoder2-3B at full width, B=1, "
            f"S={s}, {cdt} compute: card vs CPU relative L2 of the logits "
            f"(prefill, then {steps} decode steps) "
            f"{['%.3e' % r for r in rels]} (limit {limit:g}); CPU "
            f"{rec[f'{cdt}_cpu_s']:.1f} s")
        del w_dev, w_cpu, card
        torch.cuda.empty_cache()
    record["cut"] = rec


def serve_phase(dev, record, counters):
    """Phase 16: ``serve`` at full depth and width, B=4 x 8192 + 32 decode
    steps, counted; timings, a traced prefill and decode step, peak memory;
    prefill(8192) + decode(1) against prefill(8193) at B=1."""
    import torch
    from repro_torch.kernels.flash_attention import ops as k8
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.params import param_count
    cfg, b, s, n_dec = (sc2_config(), SERVE_BATCH, K8_SEQ,
                        SERVE_DECODE_STEPS)
    model = serve_mod.serving_model(cfg)
    n_params = (param_count(model.backbone_specs())
                + param_count(model.head_specs()))
    t0 = time.perf_counter()
    weights = serve_mod.init_weights(model, 0, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rec = {"params": n_params, "init_s": init_s,
           "allocated_after_init_bytes": torch.cuda.memory_allocated(dev)}
    log(f"[serve] StarCoder2-3B full width: {n_params:,} parameters, "
        f"float32 weights drawn on the card in {init_s:.2f} s")

    def run():
        return serve_mod.serve(cfg, b, s, n_dec + 1, seed=0, device=dev,
                               weights=weights, log=lambda m: None)
    for ctr in counters:
        ctr.reset()
    res = run()
    torch.cuda.synchronize()
    launches = {ctr.name: ctr.count for ctr in counters}
    take_draws("serve", launches, draws_words=False)
    want = {ctr.name: 0 for ctr in counters if ctr.name not in DRAW_NAMES}
    want["flash_attention"] = cfg.n_layers
    if launches != want:
        fail(f"serve launches {launches}, expected {want} (one prefill, "
             f"{n_dec} decode steps)")
    if not (torch.isfinite(res.prefill_logits).all()
            and torch.isfinite(res.last_logits).all()):
        fail("serve: non-finite logits")
    rec.update(launches=launches, first_prefill_s=res.prefill_s,
               first_decode_ms=[1e3 * t for t in res.decode_s],
               tokens=res.tokens[:, :8].tolist())
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    res = run()
    rec["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    rec["peak_bytes_above_weights"] = rec["peak_bytes"] - base
    rec["prefill_ms"] = 1e3 * res.prefill_s
    rec["decode_ms"] = [1e3 * t for t in res.decode_s]
    rec["decode_ms_median"] = statistics.median(rec["decode_ms"])
    log(f"[serve] B={b}, prefill {s}, {n_dec} decode steps: launches "
        f"{launches}; prefill (time to first token) {rec['prefill_ms']:.1f} "
        f"ms (first call {1e3 * rec['first_prefill_s']:.1f}), decode median "
        f"{rec['decode_ms_median']:.2f} ms per step (min "
        f"{min(rec['decode_ms']):.2f}, max {max(rec['decode_ms']):.2f}); "
        f"peak device memory {rec['peak_bytes'] / 1e9:.2f} GB")

    # where the time goes: one traced prefill and one traced decode step
    prefill = make_prefill_step(model, cache_len=s + n_dec + 2)
    decode = make_decode_step(model)
    prompt = serve_mod.draw_prompt(cfg, b, s, 0).to(dev)
    for what in ("prefill", "decode"):
        torch.cuda.synchronize()
        with device_trace() as prof:
            t0 = time.perf_counter()
            if what == "prefill":
                lg, cache = prefill(*weights, prompt)
            else:
                pos = torch.full((b,), s, dtype=torch.int32, device=dev)
                decode(*weights, cache, lg.argmax(-1)[:, None], pos)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        rows = sorted(((e.self_device_time_total / 1e3, e.key, e.count)
                       for e in device_events(prof)), reverse=True)
        busy = sum(r[0] for r in rows)
        rec[f"trace_{what}"] = {
            "wall_ms": wall, "device_busy_ms": busy,
            "k8_ms": sum(t for t, k_, _ in rows if "flash_" in k_),
            "top": [{"kernel": k_[:90], "ms": t, "count": n}
                    for t, k_, n in rows[:10]]}
        log(f"[trace] one {what}: {wall:.2f} ms wall, device busy "
            f"{busy:.2f} ms ({100 * busy / wall:.1f} %), K8 "
            f"{rec[f'trace_{what}']['k8_ms']:.2f} ms")
        for t, k_, n in rows[:8]:
            log(f"  {t:9.3f} ms  x{n:<4} {k_[:90]}")
    del cache, lg

    # prefill(S) + decode(1) against prefill(S + 1), B=1
    prompt = serve_mod.draw_prompt(cfg, 1, s + 1, 1).to(dev)
    before = k8.counter.count
    _, cache = make_prefill_step(model, cache_len=s + 2)(*weights,
                                                         prompt[:, :s])
    pos = torch.full((1,), s, dtype=torch.int32, device=dev)
    _, dec, _ = decode(*weights, cache, prompt[:, s:], pos)
    full, _ = make_prefill_step(model)(*weights, prompt)
    torch.cuda.synchronize()
    if k8.counter.count - before != 2 * cfg.n_layers:
        fail("prefill(S) and prefill(S + 1) did not run K8 once per layer")
    rel = lm_logit_check("prefill_decode_vs_prefill", dec, full,
                         PREFILL_DECODE_LIMIT, rec)
    log(f"[serve] B=1: prefill({s}) + decode(1) vs prefill({s + 1}): "
        f"relative L2 {rel:.3e} (limit {PREFILL_DECODE_LIMIT:g}), "
        f"{rec['prefill_decode_vs_prefill']}")
    del weights, cache
    torch.cuda.empty_cache()
    record["serve"] = rec
    return launches


# --------------------------------------------------------------------------
# phases 17-20: the distributed step on ranks sharing the card
# --------------------------------------------------------------------------

def check_k6(dev, gen, record):
    """K6 at the full Table-I slab against its plain version (bit for bit)
    at C = 2 and C = 10, with a dead cluster and ota_on = 0; its time at
    both beside the byte bound (12 + 4C) B per entry. Returns the timings
    by C and the largest |got − want| over every ``out`` and ``cnt``."""
    import torch
    from repro_torch.kernels.ota_channel import ops as k1
    from repro_torch.kernels.ota_channel.ref import (
        ota_mask_count_ref, pass_probability,
    )
    n = TABLE_I_PARAMS
    x = torch.randn(n, generator=gen, device=dev) * 1e-3
    out = {}
    err = fault_err = 0.0
    for c in (2, 10):
        bits = torch.randint(-2 ** 31, 2 ** 31, (c, n), generator=gen,
                             device=dev, dtype=torch.int64).to(torch.int32)
        sig = torch.linspace(0.5, 2.0, c, device=dev)
        for cname, kw in (("default", {}),
                          ("dead_cluster", {"live": [1.0] * (c - 1) + [0.0]}),
                          ("ota_off", {"ota_on": 0.0}),
                          ("ota_off_dead", {"ota_on": 0.0,
                                            "live": [0.0] + [1.0] * (c - 1)})):
            live = (None if "live" not in kw
                    else torch.tensor(kw["live"], device=dev))
            ota_on = kw.get("ota_on", 1.0)
            for me in (0, c - 1):
                got = k1.ota_mask_count_apply(x, bits, me, sig, 0.032, ota_on,
                                              0.37, live_all=live)
                torch.cuda.synchronize()
                want = ota_mask_count_ref(x, bits, me, sig, 0.032, ota_on,
                                          0.37, live_all=live)
                e = max(float((got[0] - want[0]).abs().max()),
                        float((got[1] - want[1]).abs().max()))
                err = max(err, e)
                if live is not None:     # the fault mode
                    fault_err = max(fault_err, e)
                if not (torch.equal(got[0], want[0])
                        and torch.equal(got[1], want[1])):
                    fail(f"K6 C={c} {cname} me={me}: out or cnt differs from "
                         f"its plain version")
        params = k1.mask_count_params(sig, 0.032, 1.0, 0.37, 0, None, c,
                                      device=dev)
        pp = pass_probability(params[:c], params[c])
        o = torch.empty(n, device=dev)
        cn = torch.empty(n, device=dev)
        ms, queued, recorded = kernel_ms(
            [lambda: k1.launch_mask_count(x, bits, params, pp, o, cn)], 50)
        plain = device_ms(lambda: ota_mask_count_ref(
            x, bits, 0, sig, 0.032, 1.0, 0.37), 5)
        nbytes = (12 + 4 * c) * n
        out[c] = {"ms": ms, "queued_ms": queued, "recorded": recorded,
                  "plain_ms": plain,
                  "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S}
        log(f"[K6] C={c} n={n}: equal to its plain version in 4 cases x 2 "
            f"clusters; {ms:.4f} ms (queued {queued:.4f}, records kept "
            f"{recorded:.0%}), plain {plain:.4f}, byte bound "
            f"{out[c]['bound_ms']:.4f}")
    record["k6"] = out
    record.update(k6_max_abs_err=err, k6_fault_max_abs_err=fault_err)
    return out, err


def sfu_ops_per_s(dev) -> float:
    """The card's transcendental rate: SMs x SFU lanes x the maximum SM
    clock (``int32_ops_per_s``'s clock)."""
    return int32_ops_per_s(dev) / INT32_LANES_PER_SM * SFU_LANES_PER_SM


def check_k7(dev, gen, record):
    """K7 (``ops.ota_channel``) at the full Table-I slab against its plain
    version: masks equal except within MASK_ULPS ulp of H_th, ``out``
    equal where they agree; its time beside its bound. ``max_abs_err`` is
    the largest |got − want| over ``out`` and the mask on every entry, so
    a mask flip near H_th shows in it, beside the count of flips."""
    import torch
    from repro_torch import rng
    from repro_torch.kernels.ota_channel import ops as k1
    from repro_torch.kernels.ota_channel.ref import (
        bits_to_gaussian, ota_channel_ref,
    )
    n = TABLE_I_PARAMS
    x = torch.randn(n, generator=gen, device=dev)
    worst = 0
    err = 0.0
    for sigma2, ota_on in ((1.0, 1.0), (0.5, 1.0), (2.0, 1.0), (1.0, 0.0)):
        key = rng.fold_in(rng.PRNGKey(77), int(sigma2 * 4))
        got_o, got_m = k1.ota_channel(x, key, sigma2, 0.032, ota_on)
        torch.cuda.synchronize()
        want_o, want_m = k1.ota_channel_reference(x, key, sigma2, 0.032,
                                                  ota_on)
        agree = got_m == want_m
        err = max(err, float((got_o - want_o).abs().max()),
                  float((got_m - want_m).abs().max()))
        if not bool(agree.all()):
            bits = k1._padded_bits(key, n, dev)
            h = bits_to_gaussian(bits, sigma2).double()
            ulp = float(torch.finfo(torch.float32).eps) * 0.032
            near = (h * h - 0.032).abs() <= MASK_ULPS * ulp
            if bool((~agree & ~near).any()):
                fail(f"K7 sigma2={sigma2} ota_on={ota_on}: masks differ away "
                     f"from the threshold")
        worst = max(worst, int((~agree).sum()))
        if not torch.equal(got_o[agree], want_o[agree]):
            fail(f"K7 sigma2={sigma2}: out differs where the masks agree")
        if ota_on == 0.0 and not bool(got_m.all()):
            fail("K7 with ota_on = 0 blocked an entry")
    bits = rng.bits(rng.PRNGKey(78), n, device=dev)
    params = k1.channel_params_row(1.0, 0.032, 1.0, device=dev)
    o = torch.empty(n, device=dev)
    m = torch.empty(n, device=dev)
    ms, queued, recorded = kernel_ms(
        [lambda: k1.launch_channel(x, bits, params, o, m)], 50)
    plain = device_ms(lambda: ota_channel_ref(x, bits, 1.0, 0.032, 1.0), 5)
    nbytes = 16 * n
    nsfu = 3 * n         # one log, one cos and one sqrt an entry
    rec = {"ms": ms, "queued_ms": queued, "recorded": recorded,
           "plain_ms": plain, "mask_mismatches": worst, "max_abs_err": err,
           "bytes_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
           "sfu_ms": 1e3 * nsfu / sfu_ops_per_s(dev)}
    rec["bound_ms"] = max(rec["bytes_ms"], rec["sfu_ms"])
    rec["bound_by"] = ("bytes" if rec["bytes_ms"] >= rec["sfu_ms"]
                       else "operations")
    record["k7"] = rec
    log(f"[K7] n={n}: masks equal in 4 cases (largest mismatch count "
        f"{worst}, all within {MASK_ULPS} ulp of H_th), out equal where they "
        f"agree, max abs err {err:.3e} over out and mask; {ms:.4f} ms (queued {queued:.4f}, records kept "
        f"{recorded:.0%}), plain {plain:.4f}, bound {rec['bound_ms']:.4f} "
        f"({rec['bound_by']}: bytes {rec['bytes_ms']:.4f}, SFU "
        f"{rec['sfu_ms']:.4f})")
    return rec


def _dist_setup(mesh):
    """The full-width model, config and this rank's batch and keys."""
    import numpy as np
    from repro_torch import rng
    from repro_torch.common.config import FLConfig, ModelConfig, TrainConfig
    from repro_torch.models.model import build_model
    model = build_model(ModelConfig(family="mlp", compute_dtype="float32"))
    c, n = mesh.shape["cluster"], mesh.shape["client"]
    fl = FLConfig(n_clusters=c, n_clients=n)     # σ² = 1, H_th = 0.032, FGN
    r = np.random.default_rng(2026)
    x = r.standard_normal((c, n, DIST_BATCH, model.dims[0])).astype(
        np.float32)
    y = r.integers(0, DIST_CLASSES, (c, n, DIST_BATCH))
    i, j = mesh.coords["cluster"], mesh.coords["client"]
    keys = [rng.fold_in(rng.PRNGKey(3030), s)
            for s in range(DIST_STEPS + DIST_TIMED_STEPS + 1)]
    return model, fl, TrainConfig(lr=1e-3), x[i, j], y[i, j], keys


def _dist_counters():
    from repro_torch.kernels.masked_gradnorm import ops as k2
    from repro_torch.kernels.ota_channel import ops as k1
    return (k1.mask_count_counter, k1.mask_weight_counter,
            k1.channel_counter, k1.client_fold_counter, k1.aggregate_counter,
            k1.fused_counter, k2.counter) + draw_counters()


def _sync(mesh):
    import torch
    import torch.distributed as dist
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    dist.barrier()


def _dist_rank(mesh, modes, timed: bool):
    """One rank of phases 19-20: ``DIST_STEPS`` counted steps per count
    mode (and, when ``timed``, the step's time and its split), the slab
    backward against the oracle, and the packed ω̃ gather."""
    import torch
    from repro_torch import rng
    from repro_torch.common.tree import tree_leaves, tree_map, tree_unflatten
    from repro_torch.core.channel import channel_params, cluster_channel
    from repro_torch.core.hota import (
        OTACtx, make_packed_final_gather, packed_final_key,
        packed_final_norm,
    )
    from repro_torch.core.hota_slab import (
        make_packed_omega_gather, packed_omega_aggregate_ref,
        packed_omega_key,
    )
    from repro_torch.core.hota_step import make_hota_train_step
    from repro_torch.models.params import abstract_params, logical_axes
    from repro_torch.sharding.collectives import MeshStats
    from repro_torch.sharding.mesh_utils import shard_slices
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.device
    if dev.type == "cpu":
        torch.set_num_threads(CPU_RANK_THREADS)
    model, fl, tcfg, x, y, keys = _dist_setup(mesh)
    counters = _dist_counters()
    c, n = mesh.shape["cluster"], mesh.shape["client"]
    cidx, cli = mesh.coords["cluster"], mesh.coords["client"]
    out = {"device": str(dev), "backend": mesh.backend}
    for mode in modes:
        init_fn, step_fn, specs, _ = make_hota_train_step(
            model, mesh, fl, tcfg, loss_kind="cls", n_out=DIST_CLASSES,
            count_mode=mode)
        st = init_fn(rng.PRNGKey(0))
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        _sync(mesh)
        for ctr in counters:
            ctr.reset()
        metrics = []
        for s in range(DIST_STEPS):
            st, m = step_fn(st, x, y, keys[s])
            metrics.append({k: float(v) for k, v in m.items()})
        _sync(mesh)
        rec = {"launches": {ctr.name: ctr.count for ctr in counters},
               "metrics": metrics,
               "omega": [l.cpu() for l in tree_leaves(st.omega)],
               "mu": st.opt.mu.cpu(), "p": st.p.cpu()}
        if dev.type == "cuda":
            rec["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        if timed:
            times = []
            for s in range(DIST_TIMED_STEPS):
                _sync(mesh)
                t0 = time.perf_counter()
                st, _ = step_fn(st, x, y, keys[DIST_STEPS + s])
                _sync(mesh)
                times.append((time.perf_counter() - t0) * 1e3)
            mesh.stats = MeshStats()
            _sync(mesh)
            t0 = time.perf_counter()
            st, _ = step_fn(st, x, y, keys[-1])
            _sync(mesh)
            rec["stats_step_ms"] = (time.perf_counter() - t0) * 1e3
            rec["stats"] = {"seconds": mesh.stats.seconds,
                            "calls": mesh.stats.calls,
                            "bytes": mesh.stats.bytes}
            mesh.stats = None
            rec["step_ms"] = times
        out[mode] = rec

    # the slab backward on shared keys against the single-process oracle
    specs_o = {"final": model.final_specs(), "trunk": model.trunk_specs()}
    template = abstract_params(specs_o)
    axes = tree_leaves(logical_axes(specs_o))
    chan = channel_params(fl, device=dev, n_clusters=c)
    gen = torch.Generator().manual_seed(99)
    g_full = tree_map(lambda l: torch.randn((c, n) + tuple(l.shape),
                                            generator=gen) * 1e-3, template)
    p_dev = torch.rand((c, n), generator=gen) + 0.5
    slab_key = packed_omega_key(rng.PRNGKey(42))
    out["bwd"] = {}
    want = None
    layout = tree_leaves(specs.omega)
    for mode in modes:
        gather, packer = make_packed_omega_gather(
            mesh, ("client", "cluster"), ("cluster",), n, c * n,
            torch.float32, template, axes, n_clusters=c, count_mode=mode)
        if want is None:
            wg = tree_map(lambda l: torch.einsum(
                "cn,cn...->c...", p_dev, l).to(dev), g_full)
            want = [w[shard_slices(w.shape, spec, mesh)] for w, spec in
                    zip(tree_leaves(packed_omega_aggregate_ref(
                        wg, slab_key, chan, n, packer)), layout)]
            del wg
        ctx = OTACtx(p_weight=p_dev[cidx, cli].to(dev), key=slab_key,
                     sigma2=chan.sigma2, h_th=chan.h_threshold,
                     noise_std=chan.noise_std, ota_on=chan.ota_on)
        shard = [torch.zeros(w.shape, device=dev, requires_grad=True)
                 for w in want]
        full = gather(tree_unflatten(template, shard), ctx)
        torch.autograd.backward(
            tree_leaves(full),
            [g[cidx, cli].to(dev) for g in tree_leaves(g_full)])
        errs = [float(((s.grad - w).abs() - 2e-5 * w.abs()).max())
                for s, w in zip(shard, want)]
        out["bwd"][mode] = {"excess": max(errs), "max_abs": max(
            float((s.grad - w).abs().max()) for s, w in zip(shard, want))}

    # the packed ω̃ gather and its masked norm (K7), counted
    fin_axes = tree_leaves(logical_axes(model.final_specs()))
    fin_tpl = abstract_params(model.final_specs())
    gather_f = make_packed_final_gather(
        mesh, ("client", "cluster"), ("cluster",), n, c * n, torch.float32,
        fin_axes, template=fin_tpl)
    chan_c = cluster_channel(chan, cidx)
    g_fin = tree_map(lambda l: torch.randn((c, n) + tuple(l.shape),
                                           generator=gen), fin_tpl)
    g_loc = tree_map(lambda l: l[cidx, cli].to(dev), g_fin)
    fkey = rng.PRNGKey(4242)
    ctx = OTACtx(p_weight=p_dev[cidx, cli].to(dev),
                 key=packed_final_key(fkey), sigma2=chan_c.sigma2,
                 h_th=chan.h_threshold, noise_std=chan.noise_std,
                 ota_on=chan.ota_on)
    fin_layout = tree_leaves(specs.omega["final"])
    shard = [torch.zeros(l[shard_slices(l.shape, spec, mesh)].shape,
                         device=dev, requires_grad=True)
             for l, spec in zip(tree_leaves(fin_tpl), fin_layout)]
    _sync(mesh)
    for ctr in counters:
        ctr.reset()
    full = gather_f(tree_unflatten(fin_tpl, shard), ctx)
    torch.autograd.backward(tree_leaves(full), tree_leaves(g_loc))
    nrm = packed_final_norm(g_loc, fkey, chan_c, cidx)
    _sync(mesh)
    out["final"] = {"launches": {ctr.name: ctr.count for ctr in counters},
                    "ghat": [s.grad.cpu() for s in shard],
                    "norm": float(nrm)}
    return out


def _gloo_probe_rank(mesh):
    """One rank of the probe: whether gloo runs ``all_gather_into_tensor``
    and ``reduce_scatter_tensor`` on CUDA tensors (and right), and, where
    it does, their median time beside the same call staged through host
    tensors, at a quarter of the Table-I slab per rank."""
    import torch
    import torch.distributed as dist
    dev, k, n = mesh.device, mesh.size, TABLE_I_PARAMS // 4
    res = {}
    cases = {
        "all_gather": (
            lambda d: torch.full((n,), float(mesh.rank + 1), device=d),
            lambda d: torch.empty(k * n, device=d),
            dist.all_gather_into_tensor,
            torch.arange(1, k + 1, dtype=torch.float32).repeat_interleave(n)),
        "reduce_scatter": (
            lambda d: torch.full((k * n,), float(mesh.rank + 1), device=d),
            lambda d: torch.empty(n, device=d),
            dist.reduce_scatter_tensor,
            torch.full((n,), float(k * (k + 1) // 2))),
    }
    for name, (make_src, make_out, call, want) in cases.items():
        src, out = make_src(dev), make_out(dev)
        try:
            call(out, src)
            torch.cuda.synchronize(dev)
        except Exception as e:   # the probe's answer, not a phase failure
            res[name] = {"runs": False,
                         "error": f"{type(e).__name__}: {e}"[:300]}
            dist.barrier()
            continue
        rec = {"runs": True, "correct": torch.equal(out.cpu(), want)}

        def staged():
            o = make_out("cpu")
            call(o, src.cpu())
            return o.to(dev)
        for label, fn in (("cuda_ms", lambda: call(out, src)),
                          ("staged_ms", staged)):
            times = []
            for _ in range(5):
                _sync(mesh)
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize(dev)
                times.append((time.perf_counter() - t0) * 1e3)
            rec[label] = statistics.median(times)
        res[name] = rec
    return res


def gloo_probe_phase(dev, record):
    """Whether gloo runs all-gather and reduce-scatter on CUDA tensors, on
    four ranks sharing the card: ``sharding.collectives`` hands them the
    ranks' CUDA tensors, so this fails unless both run and are right.
    Records each call's time beside the same call staged through host
    tensors."""
    from repro_torch.launch.mesh import pick_backend, run_ranks
    world = DIST_SHAPE[0] * DIST_SHAPE[1]
    backend = pick_backend(dev, world)
    if backend != "gloo":
        log(f"[gloo probe] backend {backend}: nothing to probe")
        return
    res = run_ranks(_gloo_probe_rank, shape=DIST_SHAPE, device="cuda",
                    timeout_s=120)
    record["gloo_cuda_probe"] = res
    for name in ("all_gather", "reduce_scatter"):
        ranks = [r[name] for r in res]
        usable = all(r["runs"] and r["correct"] for r in ranks)
        log(f"[gloo probe] {name} on CUDA tensors under gloo, rank 0: "
            f"{ranks[0]}")
        if not usable:
            fail(f"gloo does not run {name} on CUDA tensors right: {ranks}")


def dist_phase(dev, record):
    """Phases 19-20: the full-width 2 x 2 step on four ranks sharing the
    card (gloo), in both count modes, against each other and against the
    same steps on four CPU ranks; the slab backward against the oracle;
    the packed ω̃ gather. Returns the launches of the counted runs, summed
    over the ranks."""
    import torch
    from repro_torch.launch.mesh import pick_backend, run_ranks
    torch.cuda.empty_cache()
    world = DIST_SHAPE[0] * DIST_SHAPE[1]
    backend = pick_backend(dev, world)
    t0 = time.perf_counter()
    gpu = run_ranks(_dist_rank, (("local", "psum"), True), shape=DIST_SHAPE,
                    device="cuda", timeout_s=600)
    gpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = run_ranks(_dist_rank, (("psum",), False), shape=DIST_SHAPE,
                    device="cpu", timeout_s=600)
    cpu_s = time.perf_counter() - t0
    log(f"[dist] {world} ranks on {gpu[0]['device']} x{world}, backend "
        f"{gpu[0]['backend']} (chosen {backend}), every collective on the "
        f"ranks' CUDA tensors; card ranks {gpu_s:.1f} s, CPU ranks "
        f"{cpu_s:.1f} s (spawn and set-up included)")
    rec = {"backend": gpu[0]["backend"], "card_run_s": gpu_s,
           "cpu_run_s": cpu_s}
    per = {"local": "ota_mask_count", "psum": "ota_mask_weight"}
    total = {}
    for mode in ("local", "psum"):
        want = {ctr: 0 for ctr in ("ota_mask_count", "ota_mask_weight",
                                   "ota_channel", "ota_client_fold",
                                   "ota_aggregate", "ota_aggregate_fused",
                                   "masked_gradnorm")}
        want[per[mode]] = DIST_LEAVES * DIST_STEPS
        for r, res in enumerate(gpu):
            res[mode]["draws"] = take_draws(f"dist {mode} rank {r}",
                                            res[mode]["launches"])
            if res[mode]["launches"] != want:
                fail(f"dist {mode} rank {r}: launches "
                     f"{res[mode]['launches']}, expected {want}")
            for k, v in res[mode]["launches"].items():
                total[k] = total.get(k, 0) + v
            for m in res[mode]["metrics"]:
                if not all(math.isfinite(v) for v in m.values()):
                    fail(f"dist {mode} rank {r}: non-finite metrics {m}")
    rec["draws_per_rank_per_step"] = {
        mode: {k: v / DIST_STEPS for k, v in gpu[0][mode]["draws"].items()}
        for mode in ("local", "psum")}
    # the two count modes bit for bit, on every rank
    for r, res in enumerate(gpu):
        a, b = res["local"], res["psum"]
        if a["metrics"] != b["metrics"] or not all(
                torch.equal(u, v) for u, v in zip(a["omega"], b["omega"])) \
                or not torch.equal(a["mu"], b["mu"]):
            fail(f"dist rank {r}: the count modes differ")
    # the card against the CPU ranks
    cmp = {}
    for mode in ("local", "psum"):
        for r in range(world):
            for s in range(DIST_STEPS):
                for k in ("loss", "p_mean", "p_min", "p_max", "gnorm_mean"):
                    g_v = gpu[r][mode]["metrics"][s][k]
                    c_v = cpu[r]["psum"]["metrics"][s][k]
                    if abs(g_v - c_v) > 1e-4 * abs(c_v) + 1e-7:
                        fail(f"dist {mode} rank {r} step {s} {k}: card "
                             f"{g_v} vs CPU {c_v}")
        for r in range(world):
            g_p, c_p = gpu[r][mode]["p"], cpu[r]["psum"]["p"]
            if not torch.allclose(g_p, c_p, rtol=1e-4, atol=0.0):
                fail(f"dist {mode} rank {r}: p on the card {g_p.tolist()} "
                     f"vs the CPU {c_p.tolist()}")
        w_g = torch.cat([l.reshape(-1) for res in gpu
                         for l in res[mode]["omega"]])
        w_c = torch.cat([l.reshape(-1) for res in cpu
                         for l in res["psum"]["omega"]])
        cmp[mode] = {"omega_rel_l2": rel_l2(w_g, w_c),
                     "mu_rel_l2": rel_l2(
                         torch.cat([res[mode]["mu"] for res in gpu]),
                         torch.cat([res["psum"]["mu"] for res in cpu]))}
        if cmp[mode]["omega_rel_l2"] > 1e-3:
            fail(f"dist {mode}: card vs CPU {cmp[mode]}")
    rec["card_vs_cpu"] = cmp
    bwd = {mode: max(res["bwd"][mode]["max_abs"] for res in gpu)
           for mode in ("local", "psum")}
    for mode in ("local", "psum"):
        if max(res["bwd"][mode]["excess"] for res in gpu) > 1e-6:
            fail(f"dist slab backward ({mode}) vs packed_omega_aggregate_ref:"
                 f" max abs err {bwd[mode]:.3e}")
    rec["bwd_vs_oracle_max_abs"] = bwd
    # the packed ω̃ gather: K7 once in the backward, once in the norm
    fin_want = {k: 0 for k in want}
    fin_want["ota_channel"] = 2
    g_f = torch.cat([g.reshape(-1) for res in gpu
                     for g in res["final"]["ghat"]])
    c_f = torch.cat([g.reshape(-1) for res in cpu
                     for g in res["final"]["ghat"]])
    off = int(((g_f - c_f).abs() > 1e-4 * c_f.abs() + 1e-6).sum())
    for r, res in enumerate(gpu):
        res["final"]["draws"] = take_draws(f"packed final gather rank {r}",
                                           res["final"]["launches"])
        rec["final_gather_draws_per_rank"] = res["final"]["draws"]
        if res["final"]["launches"] != fin_want:
            fail(f"packed final gather rank {r}: launches "
                 f"{res['final']['launches']}, expected {fin_want}")
        for k, v in res["final"]["launches"].items():
            total[k] = total.get(k, 0) + v
        if abs(res["final"]["norm"] - cpu[r]["final"]["norm"]) > \
                1e-5 * abs(cpu[r]["final"]["norm"]):
            fail(f"packed final norm rank {r}: card {res['final']['norm']} "
                 f"vs CPU {cpu[r]['final']['norm']}")
    rec["final_gather"] = {"ghat_rel_l2": rel_l2(g_f, c_f),
                           "ghat_entries_off": off,
                           "entries": g_f.numel()}
    if rec["final_gather"]["ghat_rel_l2"] > 1e-4 or off > 16:
        fail(f"packed final gather card vs CPU: {rec['final_gather']}")
    # timings: rank 0's view of the synchronized step, and its split
    for mode in ("local", "psum"):
        g0 = gpu[0][mode]
        st = {k: g0["stats"]["seconds"].get(k, 0.0) * 1e3
              for k in ("collective", "draw")}
        rec[mode] = {
            "step_ms": g0["step_ms"],
            "step_ms_median": statistics.median(g0["step_ms"]),
            "stats_step_ms": g0["stats_step_ms"],
            "collective_ms": st["collective"], "draw_ms": st["draw"],
            "collective_calls": g0["stats"]["calls"].get("collective", 0),
            "collective_bytes": g0["stats"]["bytes"].get("collective", 0),
            "rest_ms": g0["stats_step_ms"] - st["collective"] - st["draw"],
            "peak_bytes_per_rank": [res[mode]["peak_bytes"] for res in gpu]}
        log(f"[dist {mode}] step median {rec[mode]['step_ms_median']:.2f} ms "
            f"(all {['%.2f' % t for t in g0['step_ms']]}); a timed step "
            f"{g0['stats_step_ms']:.2f} ms: collectives "
            f"{st['collective']:.2f} ms in {rec[mode]['collective_calls']} "
            f"calls ({rec[mode]['collective_bytes'] / 1e6:.1f} MB, "
            f"{100 * st['collective'] / g0['stats_step_ms']:.1f} %), stream "
            f"draws {st['draw']:.2f} ms, the rest {rec[mode]['rest_ms']:.2f} "
            f"ms; peak bytes per rank {rec[mode]['peak_bytes_per_rank']}")
    log(f"[dist] launches per rank: local {gpu[0]['local']['launches']}, "
        f"psum {gpu[0]['psum']['launches']}; card vs CPU {cmp}; slab "
        f"backward vs oracle {bwd}; packed final gather "
        f"{rec['final_gather']}")
    record["dist"] = rec
    return total


# --------------------------------------------------------------------------
# phases 21-24: fault injection, the fault bank, checkpoints, the faulted
# distributed step
# --------------------------------------------------------------------------

def _state_pairs(a, b):
    """(leaf of a, leaf of b) over two states of one structure."""
    from repro_torch.common.tree import state_map
    pairs = []
    state_map(lambda u, v: pairs.append((u, v)), a, b)
    return pairs


def _same_but_step(a, b) -> bool:
    """Every leaf of two states equal bit for bit, ``step`` aside."""
    import torch
    pairs = _state_pairs(a._replace(step=None), b._replace(step=None))
    return bool(pairs) and all(torch.equal(u, v) for u, v in pairs)


def _leaf_cat(tree):
    import torch
    from repro_torch.common.tree import tree_leaves
    return torch.cat([l.reshape(-1).cpu() for l in tree_leaves(tree)])


def _trace_round(fn):
    """({device kernel name: launches}, device-busy ms) of one traced
    call of ``fn``: the busy time is the sum of its device records."""
    import torch
    with device_trace() as prof:
        fn()
        torch.cuda.synchronize()
    events = device_events(prof)
    return ({e.key: e.count for e in events},
            sum(e.self_device_time_total for e in events) / 1e3)


def faults_phase(sim, batcher, key0, dev, record, counters):
    """Phase 21: the faulted paper round at full width. Returns the
    launches of its counted run and the fault-mode errors of K2 and K5."""
    import dataclasses
    import torch
    from repro_torch import rng
    from repro_torch.core import ota
    from repro_torch.core.channel import fault_params
    from repro_torch.core.sim import HotaSim
    from repro_torch.common.tree import tree_leaves
    from repro_torch.experiments.faults_bench import fault_rows
    from repro_torch.kernels.masked_gradnorm import ops as k2
    from repro_torch.kernels.masked_gradnorm.ref import masked_gradnorm_ref
    from repro_torch.kernels.ota_channel.ops import ota_stream_fold_apply
    from repro_torch.kernels.ota_channel.ref import ota_stream_fold_ref
    fl = dataclasses.replace(sim.fl, **FAULT_RATES)
    c, n = fl.n_clusters, fl.n_clients
    n_cls = sim.n_classes.tolist()
    fsim = HotaSim(sim.model, fl, sim.tcfg, n_cls, device=dev)
    st = fsim.init(rng.PRNGKey(0))
    n_leaves = len(fsim.packer(st.omega).leaf_runs())
    batches = [batcher.next_stacked() for _ in range(FAULT_ROUNDS + 1)]
    keys = [rng.fold_in(key0, 3000 + r) for r in range(FAULT_ROUNDS + 1)]
    rec = {"rates": FAULT_RATES}
    torch.cuda.synchronize()
    for ctr in counters:
        ctr.reset()
    metrics = []
    for r in range(FAULT_ROUNDS):
        st, m = fsim.step(st, *batches[r], keys[r])
        metrics.append(m)
    torch.cuda.synchronize()
    launches = {ctr.name: ctr.count for ctr in counters}
    draws = take_draws("faulted round", launches)
    want = {k: 0 for k in launches}
    want.update(ota_client_fold=n_leaves * FAULT_ROUNDS,
                masked_gradnorm=FAULT_ROUNDS)
    if launches != want:
        fail(f"faulted round: launches {launches}, expected {want}")
    if draws.get("threefry_flat", 0) != 2 * FAULT_ROUNDS:
        fail(f"faulted round: {draws.get('threefry_flat', 0)} flat draws, "
             f"expected 2 per round (the participation draw)")
    if not all(bool(torch.isfinite(v).all()) for m in metrics
               for v in m.values()):
        fail("faulted round: non-finite metrics")
    parts = [ota.draw_participation(k, fsim.faults, c, n, dev)
             for k in keys]
    rec.update(launches=launches, draws_per_round={
        k: v / FAULT_ROUNDS for k, v in draws.items()},
        skipped=[float(m["skipped"]) for m in metrics],
        n_participants=[float(m["n_participants"]) for m in metrics],
        stragglers=[float(p.stale.sum()) for p in parts],
        dead_clusters=[c - float(p.n_live) for p in parts])
    log(f"[faults] {FAULT_ROUNDS} faulted rounds {FAULT_RATES}: launches "
        f"{launches}, draws per round {rec['draws_per_round']}; per round "
        f"participants {rec['n_participants']}, stragglers "
        f"{rec['stragglers']}, dead clusters {rec['dead_clusters']}, "
        f"skipped {rec['skipped']}")

    # the card round against the CPU round
    cpu_sim = HotaSim(sim.model, fl, sim.tcfg, n_cls, device="cpu")
    new_g, m_g = fsim.step(st, *batches[-1], keys[-1])
    new_c, m_c = cpu_sim.step(to_cpu(st), *batches[-1], keys[-1])
    cmp = {name: check_close(f"faulted round {name}", m_g[name].cpu(),
                             m_c[name], rtol=1e-4, atol=1e-6)
           for name in ("loss", "p", "grad_norms", "fgrad", "skipped",
                        "n_participants")}
    cmp["omega_rel_l2"] = rel_l2(_leaf_cat(new_g.omega), _leaf_cat(new_c.omega))
    cmp["stale_rel_l2"] = rel_l2(_leaf_cat(new_g.omega_stale),
                                 _leaf_cat(new_c.omega_stale))
    cmp["ghat_rel_l2"] = rel_l2(new_g.ps_opt.mu.cpu(), new_c.ps_opt.mu)
    if max(cmp["omega_rel_l2"], cmp["stale_rel_l2"], cmp["ghat_rel_l2"]) \
            > 1e-3:
        fail(f"faulted card round vs CPU round: {cmp}")
    rec["card_vs_cpu"] = cmp
    log(f"[faults] card round vs CPU round: {cmp}")

    # identity rounds on the card: no participant, and a tripped guard
    ident = {}
    for name, knob in (("blackout", dict(blackout_rate=1.0)),
                       ("spike", dict(spike_norm=1e-30))):
        fp = fault_params(dataclasses.replace(fl, **knob), device=dev)
        after, m_i = fsim.step(new_g, *batches[0], keys[0], faults=fp)
        torch.cuda.synchronize()
        ident[name] = (_same_but_step(after, new_g)
                       and float(m_i["skipped"]) == 1.0
                       and int(after.step) == int(new_g.step) + 1)
        if not ident[name]:
            fail(f"faulted round: the {name} round is not the identity")
    rec["identity_bit_exact"] = ident

    # device launches and busy time of one traced round at each rate:
    # each rate warmed once, then traced in FAULT_TRACE_PASSES passes
    # that take the rates in turn; every trace must hold the same launches
    fps = {name: fault_params(dataclasses.replace(fl, **knob), device=dev)
           for name, knob in FAULT_TRACE_RATES.items()}
    for fp in fps.values():
        fsim.step(new_g, *batches[0], keys[0], faults=fp)
    traces = {name: [] for name in fps}
    for _ in range(FAULT_TRACE_PASSES):
        for name, fp in fps.items():
            traces[name].append(_trace_round(
                lambda: fsim.step(new_g, *batches[0], keys[0], faults=fp)))
    launches_per = {name: [sum(cnt.values()) for cnt, _ in t]
                    for name, t in traces.items()}
    busy = {name: [ms for _, ms in t] for name, t in traces.items()}
    rec.update(traced_device_launches=launches_per, traced_busy_ms=busy,
               traced_busy_ms_median={k: statistics.median(v)
                                      for k, v in busy.items()})
    first = traces[next(iter(traces))][0][0]
    if any(cnt != first for t in traces.values() for cnt, _ in t):
        fail(f"faulted round: device launches depend on the rates: "
             f"{launches_per}")

    # K2 and K5 in fault mode: the faulted round's own inputs
    x_t = torch.as_tensor(batches[0][0]).to(dev)
    y_t = torch.as_tensor(batches[0][1]).to(device=dev, dtype=torch.int64)
    part = parts[0]
    _, _, g, _ = fsim._client_update(new_g.omega, new_g.heads,
                                     new_g.head_opt, x_t, y_t,
                                     omega_stale=new_g.omega_stale,
                                     stale=part.stale)
    packer = fsim.packer(new_g.omega)
    ck = ota.sim_channel_key(keys[0])
    masks = ota.final_layer_masks_packed(ck, fsim.chan, packer)
    gm = torch.cat([l.reshape(c, n, -1) for l in tree_leaves(g["final"])],
                   dim=-1)
    mm = torch.cat([m.reshape(c, -1).float() for m in tree_leaves(masks)],
                   dim=-1)
    k2_err = check_close("K2 faulted round", k2.masked_gradnorm(gm, mm),
                         masked_gradnorm_ref(gm, mm), atol=0.0)
    w_tx = new_g.p * part.part
    folds = ota.packed_section_folds(packer)
    run = max(packer.leaf_runs(), key=lambda r_: r_.size)
    leaf = tree_leaves(g)[run.leaf]
    k5_err = 0.0
    for cl in (0, c - 1):
        bits = ota.stream_range_bits(
            ota.section_gain_key(ck, folds[run.section], cl), run.offset,
            run.size, dev)
        for live in (0.0, 1.0):
            lv = torch.tensor(live, device=dev)
            args = (w_tx[cl], bits, fsim.chan.sigma2[cl],
                    fsim.chan.h_threshold, fsim.chan.ota_on)
            got = ota_stream_fold_apply(leaf[cl], *args, live_c=lv)
            want_k5 = ota_stream_fold_ref(leaf[cl].reshape(n, -1), *args,
                                          live_c=lv)
            k5_err = max(k5_err, check_close(
                f"K5 faulted live={live}", got[0].reshape(-1), want_k5[0]))
            if not torch.equal(got[1].reshape(-1), want_k5[1]):
                fail(f"K5 faulted live={live}: masks differ")
    rec.update(k2_fault_max_abs_err=k2_err, k5_fault_max_abs_err=k5_err)

    # fault_rows: the round's time against the rates
    rows = fault_rows(device=dev)
    rec["fault_rows"] = rows
    base = rows[0]["round_ms_median"]
    for row in rows:
        log(f"[faults time] {row['name']}: median "
            f"{row['round_ms_median']:.2f} ms ({row['round_ms_median'] / base - 1:+.1%} "
            f"vs faults off); participants {row.get('n_participants')}, "
            f"skipped {row.get('skipped')}")
    log(f"[faults] identity rounds bit for bit {ident}; traced device "
        f"launches per rate {launches_per}; device-busy ms per traced round "
        f"{busy}; K2 fault-mode "
        f"max abs err {k2_err:.3e}, K5 {k5_err:.3e}")
    record["faults"] = rec
    return launches, k2_err, k5_err


def fault_bank_phase(sim, batcher, dev, record, counters):
    """Phases 22-23: a Fig. 4-width fault bank (S=4: dropout 0, 0.25, 0.5
    and blackout 1) on the client-folded and streaming engines, counted,
    against per-scenario ``HotaSim`` rounds and timed; then save, restore
    and one more round, bit for bit. Returns the counted launches."""
    import dataclasses
    import tempfile
    import torch
    from repro_torch import rng
    from repro_torch.core.channel import scenario_faults
    from repro_torch.core.sim import HotaSim
    from repro_torch.core.sweep import ScenarioBank
    fl = dataclasses.replace(sim.fl, faults=True)
    n_cls = sim.n_classes.tolist()
    c = fl.n_clusters
    s_n = len(FAULT_BANK)
    batches = [batcher.next_stacked() for _ in range(FAULT_BANK_ROUNDS)]
    keys = [rng.fold_in(rng.PRNGKey(77), r) for r in range(FAULT_BANK_ROUNDS)]
    total, rec = {}, {}
    for name in ("client_folded", "streaming"):
        esim = HotaSim(sim.model, dataclasses.replace(fl, **ENGINES[name]),
                       sim.tcfg, n_cls, device=dev)
        bank = ScenarioBank(esim, FAULT_BANK)
        states0 = bank.init(rng.PRNGKey(0))
        n_leaves = len(esim.packer(states0.omega).leaf_runs())
        torch.cuda.synchronize()
        for ctr in counters:
            ctr.reset()
        states, hist = bank.run(states0, batches, keys)
        torch.cuda.synchronize()
        launches = {ctr.name: ctr.count for ctr in counters}
        draws = take_draws(f"fault bank on {name}", launches)
        per = s_n * FAULT_BANK_ROUNDS
        want = {k: 0 for k in launches}
        want["masked_gradnorm"] = per
        if name == "streaming":
            want["ota_mask_weight"] = c * n_leaves * per
        else:
            want["ota_client_fold"] = n_leaves * per
        if launches != want:
            fail(f"fault bank on {name}: launches {launches}, expected "
                 f"{want}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        skipped = hist["skipped"][-1].tolist()
        n_part = hist["n_participants"][-1].tolist()
        if skipped != [0.0, 0.0, 0.0, 1.0] or n_part[0] != c * fl.n_clients \
                or n_part[3] != 0.0 or not n_part[0] > n_part[2]:
            fail(f"fault bank on {name}: skipped {skipped}, participants "
                 f"{n_part}")
        # each scenario against its own HotaSim rounds
        cmp = {"bits_equal": True}
        for s in range(s_n):
            st_s = esim.init(rng.PRNGKey(0))
            for r in range(FAULT_BANK_ROUNDS):
                st_s, m_s = esim.step(st_s, *batches[r], keys[r],
                                      faults=scenario_faults(
                                          bank.fault_bank, s))
                for k in ("loss", "p", "skipped", "n_participants"):
                    check_close(f"fault bank {name} s={s} {k}",
                                hist[k][r, s], m_s[k], rtol=1e-4,
                                atol=1e-6)
                    cmp["bits_equal"] &= torch.equal(hist[k][r, s], m_s[k])
            w_b = _leaf_cat(bank.scenario_state(states, s).omega)
            w_s = _leaf_cat(st_s.omega)
            cmp[f"omega_rel_l2_s{s}"] = rel_l2(w_b, w_s)
            cmp["bits_equal"] &= torch.equal(w_b, w_s)
            if cmp[f"omega_rel_l2_s{s}"] > 1e-3:
                fail(f"fault bank on {name} s={s} vs HotaSim: {cmp}")
        # the median bank round and one traced bank round
        holder = [states]
        times = []
        for r in range(TIMED_BANK_ROUNDS + 1):
            b_r = batcher.next_stacked()
            k_r = rng.fold_in(rng.PRNGKey(78), r)

            def one():
                holder[0], _ = bank.step(holder[0], *b_r, k_r)
            if r == TIMED_BANK_ROUNDS:
                with device_trace() as prof:
                    traced = host_ms(one)
            else:
                times.append(host_ms(one))
        ev = [(e.self_device_time_total / 1e3, e.count)
              for e in device_events(prof)]
        rec[name] = {"launches": launches, "draws_per_bank_round": {
            k: v / FAULT_BANK_ROUNDS for k, v in draws.items()},
            "skipped": skipped, "n_participants": n_part,
            "vs_hotasim": cmp, "round_ms": times,
            "round_ms_median": statistics.median(times),
            "traced_round_ms": traced,
            "device_busy_ms": sum(t for t, _ in ev),
            "device_launches_traced": sum(k for _, k in ev)}
        log(f"[fault bank] {name}: launches {launches}; skipped {skipped}, "
            f"participants {n_part}; vs per-scenario HotaSim {cmp}; median "
            f"{rec[name]['round_ms_median']:.2f} ms per bank round of "
            f"{s_n} (all {['%.2f' % t for t in times]}); traced "
            f"{traced:.2f} ms, device busy {rec[name]['device_busy_ms']:.2f}"
            f" ms, {rec[name]['device_launches_traced']} device launches")
        if name == "client_folded":
            keep = (bank, holder[0])

    # phase 23: save, restore, one more round, bit for bit
    bank, states = keep
    x_r, y_r = batcher.next_stacked()
    k_r = rng.PRNGKey(79)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        path = bank.save(d, 7, states)
        save_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(path, f))
                     for f in os.listdir(path))
        t0 = time.perf_counter()
        restored = bank.restore(d, 7)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    if not _same_but_step(restored, states) or not torch.equal(
            restored.step, states.step):
        fail("bank restore: the restored state differs from the saved one")
    a, ma = bank.step(states, x_r, y_r, k_r)
    b, mb = bank.step(restored, x_r, y_r, k_r)
    same = (all(torch.equal(u, v) for u, v in _state_pairs(a, b))
            and all(torch.equal(ma[k], mb[k]) for k in ma))
    if not same:
        fail("bank restore: the round after the restore differs from the "
             "uninterrupted round")
    rec["checkpoint"] = {"save_s": save_s, "restore_s": restore_s,
                         "bytes": nbytes, "continues_bit_for_bit": same}
    log(f"[checkpoint] bank saved ({nbytes / 1e6:.1f} MB) in {save_s:.3f} s, "
        f"restored onto the card in {restore_s:.3f} s; the next round equal "
        f"bit for bit to the uninterrupted one")
    record["fault_bank"] = rec
    return total


def _dist_fault_rank(mesh, modes, timed: bool):
    """One rank of phase 24: ``DIST_STEPS`` counted faulted steps per count
    mode, a blackout step (the identity), and, when ``timed``, the step's
    time and its split."""
    import dataclasses
    import torch
    from repro_torch import rng
    from repro_torch.common.tree import tree_leaves
    from repro_torch.core.channel import fault_params
    from repro_torch.core.hota_step import make_hota_train_step
    from repro_torch.sharding.collectives import MeshStats
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.device
    if dev.type == "cpu":
        torch.set_num_threads(CPU_RANK_THREADS)
    model, fl0, tcfg, x, y, keys = _dist_setup(mesh)
    fl = dataclasses.replace(fl0, **FAULT_RATES)
    counters = _dist_counters()
    out = {}
    for mode in modes:
        init_fn, step_fn, _, _ = make_hota_train_step(
            model, mesh, fl, tcfg, loss_kind="cls", n_out=DIST_CLASSES,
            count_mode=mode)
        st = init_fn(rng.PRNGKey(0))
        _sync(mesh)
        for ctr in counters:
            ctr.reset()
        metrics = []
        for s in range(DIST_STEPS):
            st, m = step_fn(st, x, y, keys[s])
            metrics.append({k: float(v) for k, v in m.items()})
        _sync(mesh)
        rec = {"launches": {ctr.name: ctr.count for ctr in counters},
               "metrics": metrics,
               "omega": [l.cpu() for l in tree_leaves(st.omega)],
               "stale": [l.cpu() for l in tree_leaves(st.omega_stale)],
               "mu": st.opt.mu.cpu(), "p": st.p.cpu()}
        black = fault_params(dataclasses.replace(fl, blackout_rate=1.0),
                             device=dev)
        after, m_b = step_fn(st, x, y, keys[DIST_STEPS], None, black)
        _sync(mesh)
        rec["identity"] = (_same_but_step(after, st)
                           and float(m_b["skipped"]) == 1.0)
        if timed:
            times = []
            for s in range(DIST_TIMED_STEPS):
                _sync(mesh)
                t0 = time.perf_counter()
                st, _ = step_fn(st, x, y, keys[DIST_STEPS + s])
                _sync(mesh)
                times.append((time.perf_counter() - t0) * 1e3)
            mesh.stats = MeshStats()
            _sync(mesh)
            t0 = time.perf_counter()
            st, _ = step_fn(st, x, y, keys[-1])
            _sync(mesh)
            rec["stats_step_ms"] = (time.perf_counter() - t0) * 1e3
            rec["stats"] = {"seconds": mesh.stats.seconds,
                            "calls": mesh.stats.calls,
                            "bytes": mesh.stats.bytes}
            mesh.stats = None
            rec["step_ms"] = times
        out[mode] = rec
    return out


def dist_fault_phase(dev, record):
    """Phase 24: the faulted distributed step at full width on four ranks
    sharing the card, both count modes, against each other and against
    four CPU ranks; the blackout step's identity; the step's split beside
    phase 19's unfaulted step. Returns the counted launches over the
    ranks."""
    import torch
    from repro_torch.launch.mesh import run_ranks
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gpu = run_ranks(_dist_fault_rank, (("local", "psum"), True),
                    shape=DIST_SHAPE, device="cuda", timeout_s=600)
    gpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = run_ranks(_dist_fault_rank, (("psum",), False), shape=DIST_SHAPE,
                    device="cpu", timeout_s=600)
    cpu_s = time.perf_counter() - t0
    world = len(gpu)
    rec = {"card_run_s": gpu_s, "cpu_run_s": cpu_s}
    per = {"local": "ota_mask_count", "psum": "ota_mask_weight"}
    total = {}
    for mode in ("local", "psum"):
        for r, res in enumerate(gpu):
            got = res[mode]["launches"]
            draws = take_draws(f"faulted dist {mode} rank {r}", got)
            if draws.get("threefry_flat", 0) < 2 * DIST_STEPS:
                fail(f"faulted dist {mode} rank {r}: the participation was "
                     f"not drawn on the card ({draws})")
            want = {k: 0 for k in got}
            want[per[mode]] = DIST_LEAVES * DIST_STEPS
            if got != want:
                fail(f"faulted dist {mode} rank {r}: launches {got}, "
                     f"expected {want}")
            for k, v in got.items():
                total[k] = total.get(k, 0) + v
            if not res[mode]["identity"]:
                fail(f"faulted dist {mode} rank {r}: the blackout step is "
                     f"not the identity")
        rec[f"draws_per_rank_per_step_{mode}"] = {
            k: v / DIST_STEPS for k, v in draws.items()}
    for r, res in enumerate(gpu):
        a, b = res["local"], res["psum"]
        if a["metrics"] != b["metrics"] or not all(
                torch.equal(u, v) for u, v in zip(a["omega"], b["omega"])):
            fail(f"faulted dist rank {r}: the count modes differ")
    cmp = {}
    for mode in ("local", "psum"):
        for r in range(world):
            for s in range(DIST_STEPS):
                for k in ("loss", "p_mean", "p_min", "p_max", "gnorm_mean",
                          "skipped", "n_participants"):
                    g_v = gpu[r][mode]["metrics"][s][k]
                    c_v = cpu[r]["psum"]["metrics"][s][k]
                    if abs(g_v - c_v) > 1e-4 * abs(c_v) + 1e-7:
                        fail(f"faulted dist {mode} rank {r} step {s} {k}: "
                             f"card {g_v} vs CPU {c_v}")
        cmp[mode] = {
            "omega_rel_l2": rel_l2(
                torch.cat([l.reshape(-1) for res in gpu
                           for l in res[mode]["omega"]]),
                torch.cat([l.reshape(-1) for res in cpu
                           for l in res["psum"]["omega"]])),
            "stale_rel_l2": rel_l2(
                torch.cat([l.reshape(-1) for res in gpu
                           for l in res[mode]["stale"]]),
                torch.cat([l.reshape(-1) for res in cpu
                           for l in res["psum"]["stale"]]))}
        if max(cmp[mode].values()) > 1e-3:
            fail(f"faulted dist {mode}: card vs CPU {cmp[mode]}")
    rec["card_vs_cpu"] = cmp
    rec["participants_per_step"] = [m["n_participants"]
                                    for m in gpu[0]["local"]["metrics"]]
    rec["skipped_per_step"] = [m["skipped"]
                               for m in gpu[0]["local"]["metrics"]]
    for mode in ("local", "psum"):
        g0 = gpu[0][mode]
        st = {k: g0["stats"]["seconds"].get(k, 0.0) * 1e3
              for k in ("collective", "draw")}
        unf = record.get("dist", {}).get(mode, {})
        rec[mode] = {
            "step_ms": g0["step_ms"],
            "step_ms_median": statistics.median(g0["step_ms"]),
            "stats_step_ms": g0["stats_step_ms"],
            "collective_ms": st["collective"], "draw_ms": st["draw"],
            "collective_calls": g0["stats"]["calls"].get("collective", 0),
            "collective_bytes": g0["stats"]["bytes"].get("collective", 0),
            "rest_ms": g0["stats_step_ms"] - st["collective"] - st["draw"]}
        log(f"[dist faults {mode}] step median "
            f"{rec[mode]['step_ms_median']:.2f} ms (unfaulted, phase 19: "
            f"{unf.get('step_ms_median', float('nan')):.2f}); a timed step "
            f"{g0['stats_step_ms']:.2f} ms: collectives "
            f"{st['collective']:.2f} ms in {rec[mode]['collective_calls']} "
            f"calls ({rec[mode]['collective_bytes'] / 1e6:.1f} MB; "
            f"unfaulted {unf.get('collective_ms', float('nan')):.2f} ms in "
            f"{unf.get('collective_calls')} calls, "
            f"{unf.get('collective_bytes', 0) / 1e6:.1f} MB), draws "
            f"{st['draw']:.2f} ms, the rest {rec[mode]['rest_ms']:.2f} ms")
    log(f"[dist faults] launches per rank: local "
        f"{gpu[0]['local']['launches']}, psum {gpu[0]['psum']['launches']}; "
        f"participants per step {rec['participants_per_step']}, skipped "
        f"{rec['skipped_per_step']}; blackout step the identity on every "
        f"rank; card vs CPU {cmp}; card ranks {gpu_s:.1f} s, CPU ranks "
        f"{cpu_s:.1f} s")
    record["dist_faults"] = rec
    return total


def sc2_config():
    """StarCoder2-3B's full-size config (30 layers, d_model 3072)."""
    from repro_torch.configs import get_config
    return get_config("starcoder2_3b")


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
    state = sim.init(rng.PRNGKey(0))
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
    k1_err = k1_fault_err = 0.0
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
            if "live" in kw:        # the fault mode: live ≠ 1, N_eff ≠ N
                k1_fault_err = max(k1_fault_err, err)
            log(f"[K1] {names[run.leaf]} n={run.size} {cname}: max abs err "
                f"{err:.3e}")
    record.update(k1_max_abs_err=k1_err, k1_fault_max_abs_err=k1_fault_err)

    # --- 4. K2 against its plain version ------------------------------------
    p_tail = sum(packer.slots[i].size for i in packer.tail_indices)
    gm = torch.randn((c, n_cl, p_tail), generator=gen, device=dev) * 1e-2
    mm = (torch.rand((c, p_tail), generator=gen, device=dev) < 0.86).float()
    got = k2.masked_gradnorm(gm, mm)
    again = k2.masked_gradnorm(gm, mm)
    torch.cuda.synchronize()
    k2_err = check_close("K2", got, masked_gradnorm_ref(gm, mm), atol=0.0)
    if not torch.equal(got, again):
        fail("K2: two launches on the same inputs differ")
    # ragged rows: P = 1, P not a multiple of 4 (scalar loads), one row
    for shape in ((1, 1, 1), (3, 2, 1001), (1, 1, 4099), (2, 3, 7)):
        g_r = torch.randn(shape, generator=gen, device=dev)
        m_r = (torch.rand((shape[0], shape[2]), generator=gen, device=dev)
               < 0.7).float()
        got_r = k2.masked_gradnorm(g_r, m_r)
        torch.cuda.synchronize()
        k2_err = max(k2_err, check_close(f"K2 {shape}", got_r,
                                         masked_gradnorm_ref(g_r, m_r),
                                         atol=0.0))
    record["k2_max_abs_err"] = k2_err
    record["k2_splits"] = k2.splits(c * n_cl, p_tail, _build.sm_count(dev))
    log(f"[K2] (C={c}, N={n_cl}, P={p_tail}) split {record['k2_splits']} "
        f"ways, and ragged (C, T, P) = (1, 1, 1), (3, 2, 1001), (1, 1, "
        f"4099), (2, 3, 7): max abs err {k2_err:.3e} (rtol {RTOL}); two "
        f"launches equal bit for bit")

    # --- 7. K5 against its plain version ------------------------------------
    k5_err = check_k5(dev, runs, names, gbits, chan, gen)
    record["k5_max_abs_err"] = k5_err

    # --- 5. the main path ---------------------------------------------------
    batches = [batcher.next_stacked() for _ in range(ROUNDS + 1)]
    keys = [rng.fold_in(key0, r) for r in range(ROUNDS + 1)]
    counters = (k1.client_fold_counter, k2.counter, k1.mask_weight_counter,
                k1.aggregate_counter, k1.fused_counter) + draw_counters()
    for ctr in counters:
        ctr.reset()
    losses = []
    st = state
    for r in range(ROUNDS):
        st, m = sim.step(st, *batches[r], keys[r])
        losses.append(m["loss"])
    torch.cuda.synchronize()
    launches = {ctr.name: ctr.count for ctr in counters}
    draws = take_draws("paper round", launches)
    record["draws_per_round"] = {k: v / ROUNDS for k, v in draws.items()}
    want = {"ota_client_fold": len(runs) * ROUNDS,
            "masked_gradnorm": ROUNDS, "ota_mask_weight": 0,
            "ota_aggregate": 0, "ota_aggregate_fused": 0}
    if launches != want:
        fail(f"main-path launches {launches}, expected {want}")
    loss = torch.stack(losses)
    if not torch.isfinite(loss).all():
        fail("non-finite loss on the main path")
    record["launches"] = launches
    record["round_loss_mean"] = [float(l.mean()) for l in losses]
    log(f"[path] {ROUNDS} rounds, launches {launches}, stream draws per "
        f"round {record['draws_per_round']}, mean loss per round "
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

    # K1 at the round's shapes, every leaf once per round. "ms" is the
    # kernel's own device time (kernel_ms), "queued_ms" adds the device's
    # gaps between launches; "launch_ms" is
    # back-to-back calls of the raw launch on CUDA events, which small
    # leaves spend waiting for the host; "wrapper_ms" adds the params row
    # the wrapper builds
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
        ms, queued_ms, recorded = kernel_ms([raw], iters)
        leaf = {"leaf": names[run.leaf], "n": n,
                "ms": ms, "queued_ms": queued_ms, "recorded": recorded,
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
    k2_ms, record["k2_queued_ms"], record["k2_recorded"] = kernel_ms(
        [lambda: k2.launch(gm, mm, out2)], 100)
    record["k2_launch_ms"] = cuda_ms(lambda: k2.launch(gm, mm, out2), 100)
    # the design it replaced (one block per row), in the same run, and the
    # new one again after it
    record["k2_rowblock_ms"], _, _ = kernel_ms(
        [lambda: k2._launch_rowblock(gm, mm, out2)], 100)
    record["k2_ms_again"], _, _ = kernel_ms(
        [lambda: k2.launch(gm, mm, out2)], 100)
    k2_plain = device_ms(lambda: masked_gradnorm_ref(gm, mm), 20)
    k2_lib = device_ms(lambda: torch.linalg.vector_norm(
        gm * mm.unsqueeze(1), dim=-1), 20)
    if min(k1_ms, k2_ms, k1_plain_ms, k2_plain, k2_lib) <= 0.0:
        fail(f"no device time measured for a timed kernel: K1 {k1_ms}, "
             f"K2 {k2_ms}, K1 plain {k1_plain_ms}, K2 plain {k2_plain}, "
             f"K2 library {k2_lib}")
    k2_bytes = 4 * (c * n_cl * p_tail + c * p_tail + c * n_cl)
    k2_ops = 3 * c * n_cl * p_tail
    k2_bound = 1e3 * max(k2_bytes / HBM_BYTES_PER_S,
                         k2_ops / F32_FLOPS_PER_S)
    k1_queued = sum(leaf["queued_ms"] for leaf in per_leaf)
    k1_rec = min(leaf["recorded"] for leaf in per_leaf)
    record.update(k1_queued_ms=k1_queued, k1_recorded=k1_rec)
    log(f"[time] K1 per round {k1_ms:.4f} ms device (queued {k1_queued:.4f}, "
        f"records kept {k1_rec:.0%}, launch "
        f"{k1_launch_ms:.4f}, wrapper {k1_path_ms:.4f}, plain "
        f"{k1_plain_ms:.4f}, bound {k1_bound:.4f}); K2 {k2_ms:.4f} ms "
        f"device (queued {record['k2_queued_ms']:.4f}, records kept "
        f"{record['k2_recorded']:.0%}, launch "
        f"{record['k2_launch_ms']:.4f}, plain "
        f"{k2_plain:.4f}, vector_norm {k2_lib:.4f}, bound {k2_bound:.4f}; "
        f"the one-block-per-row design {record['k2_rowblock_ms']:.4f}, "
        f"then this one again {record['k2_ms_again']:.4f})")
    for leaf in per_leaf:
        log(f"  K1 {leaf['leaf']:>12} n={leaf['n']:>8}: {leaf['ms']:.4f} ms "
            f"(queued {leaf['queued_ms']:.4f}, launch "
            f"{leaf['launch_ms']:.4f}, bound {leaf['bound_ms']:.4f}, "
            f"plain {leaf['plain_ms']:.4f})")
    if not all(bool(torch.isfinite(v).all()) for v in m_gpu.values()):
        fail("non-finite metrics")

    # where a round's device time goes: TRACED_ROUNDS traced rounds
    rounds_p = [(batcher.next_stacked(), rng.fold_in(key0, 900 + r))
                for r in range(TRACED_ROUNDS)]
    torch.cuda.synchronize()
    with device_trace() as prof:
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
        bank_draws = take_draws(f"bank on {name}", got)
        streams = name in streaming_engines
        want = {"ota_client_fold": 0 if streams else len(runs) * per,
                "masked_gradnorm": per,
                "ota_mask_weight": c * len(runs) * per if streams else 0,
                "ota_aggregate": 0, "ota_aggregate_fused": 0}
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
                          "draws_per_bank_round": {
                              k: v / BANK_ROUNDS
                              for k, v in bank_draws.items()},
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
                with device_trace() as prof:
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
        f"launches): {k5['ms']:.4f} ms device (queued {k5['queued_ms']:.4f}, "
        f"records kept {k5['recorded']:.0%}, launch {k5['launch_ms']:.4f}, "
        f"plain {k5['plain_ms']:.4f}, bound {k5['bound_ms']:.4f} "
        f"({k5['bound_by']}))")
    if min(k5["ms"], k5["plain_ms"]) <= 0.0:
        fail("no device time measured for K5")

    # --- 10. the stream draws, K3 and K4 against their plain versions ------
    draw_chunked, draw_flat = check_draws(dev, c, packer, chan_key, record)
    k3_err, k4_err = check_k34(dev, c, record)

    # --- 11. the packed path at full width ----------------------------------
    got, k3, k4 = packed_path(sim, st_t, batcher.next_stacked(),
                              rng.fold_in(key0, 2500), dev, record, counters)
    for k_name, v in got.items():
        total[k_name] += v

    # --- 12. the per-leaf oracle's round ------------------------------------
    got = perleaf_phase(sim, batcher, key0, dev, record, counters)
    for k_name, v in got.items():
        total[k_name] += v

    # --- 13. the layout tuner and a tuned sweep -----------------------------
    got = tuner_phase(sim, batcher, dev, record, counters)
    for k_name, v in got.items():
        total[k_name] += v

    # --- 14-16. serving StarCoder2-3B at full width on K8 -------------------
    from repro_torch.kernels.flash_attention import ops as k8
    k8_err, k8_rec = k8_phase(dev, record)
    cut_phase(dev, record)
    got = serve_phase(dev, record, counters + (k8.counter,))
    for k_name, v in got.items():
        total[k_name] = total.get(k_name, 0) + v

    # --- 17-18. K6 and K7 against their plain versions ----------------------
    gen_d = torch.Generator(device=dev).manual_seed(17)
    k6, k6_err = check_k6(dev, gen_d, record)
    k7 = check_k7(dev, gen_d, record)

    # --- 19-20. gloo on CUDA tensors, the distributed step, the ω̃ gather ---
    gloo_probe_phase(dev, record)
    got = dist_phase(dev, record)
    for k_name, v in got.items():
        total[k_name] = total.get(k_name, 0) + v

    # --- 21-24. faults, the fault bank, checkpoints, the faulted step ------
    got, k2_fault_err, k5_fault_err = faults_phase(sim, batcher, key0, dev,
                                                   record, counters)
    for k_name, v in got.items():
        total[k_name] += v
    got = fault_bank_phase(sim, batcher, dev, record, counters)
    for k_name, v in got.items():
        total[k_name] += v
    got = dist_fault_phase(dev, record)
    for k_name, v in got.items():
        total[k_name] = total.get(k_name, 0) + v
    if "jax" in sys.modules or "repro" in sys.modules:
        fail("the JAX package was imported")

    kernels = [
        {"name": "ota_client_fold", "route": "cuda",
         "source": "src/repro_torch/kernels/ota_channel/csrc/"
                   "ota_client_fold.cu",
         "replaces": "src/repro/kernels/ota_channel/kernel.py:370",
         "launches": total["ota_client_fold"], "max_abs_err": k1_err,
         "fault_max_abs_err": k1_fault_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": ("bytes" if k1_bytes / HBM_BYTES_PER_S
                      >= k1_ops / F32_FLOPS_PER_S else "operations"),
         "library_ms": None},
        {"name": "masked_gradnorm", "route": "cuda",
         "source": "src/repro_torch/kernels/masked_gradnorm/csrc/"
                   "masked_gradnorm.cu",
         "replaces": "src/repro/kernels/masked_gradnorm/kernel.py:41",
         "launches": total["masked_gradnorm"], "max_abs_err": k2_err,
         "fault_max_abs_err": k2_fault_err,
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound,
         "bound_by": ("bytes" if k2_bytes / HBM_BYTES_PER_S
                      >= k2_ops / F32_FLOPS_PER_S else "operations"),
         "library_ms": k2_lib},
        {"name": "ota_mask_weight", "route": "cuda",
         "source": "src/repro_torch/kernels/ota_channel/csrc/"
                   "ota_mask_weight.cu",
         "replaces": "src/repro/kernels/ota_channel/kernel.py:142",
         "launches": total["ota_mask_weight"], "max_abs_err": k5_err,
         "fault_max_abs_err": k5_fault_err,
         "ms": k5["ms"], "plain_ms": k5["plain_ms"],
         "bound_ms": k5["bound_ms"], "bound_by": k5["bound_by"],
         "library_ms": None},
        {"name": "ota_aggregate", "route": "cuda",
         "source": "src/repro_torch/kernels/ota_channel/csrc/"
                   "ota_aggregate.cu",
         "replaces": "src/repro/kernels/ota_channel/kernel.py:782",
         "launches": total["ota_aggregate"], "max_abs_err": k3_err,
         "ms": k3["ms"], "plain_ms": k3["plain_ms"],
         "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
         "library_ms": None},
        {"name": "ota_aggregate_fused", "route": "cuda",
         "source": "src/repro_torch/kernels/ota_channel/csrc/"
                   "ota_aggregate_fused.cu",
         "replaces": "src/repro/kernels/ota_channel/kernel.py:695",
         "launches": total["ota_aggregate_fused"], "max_abs_err": k4_err,
         "ms": k4["ms"], "plain_ms": k4["plain_ms"],
         "bound_ms": k4["bound_ms"], "bound_by": k4["bound_by"],
         "library_ms": None},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:92",
         "launches": total["flash_attention"], "max_abs_err": k8_err,
         "ms": k8_rec["ms"], "plain_ms": k8_rec["plain_ms"],
         "bound_ms": k8_rec["bound_ms"], "bound_by": k8_rec["bound_by"],
         "library_ms": k8_rec["sdpa_window_mask_ms"]},
        {"name": "ota_mask_count", "route": "cuda",
         "source": "src/repro_torch/kernels/ota_channel/csrc/"
                   "ota_mask_count.cu",
         "replaces": "src/repro/kernels/ota_channel/kernel.py:208",
         "launches": total["ota_mask_count"], "max_abs_err": k6_err,
         "fault_max_abs_err": record["k6_fault_max_abs_err"],
         "ms": k6[2]["ms"], "plain_ms": k6[2]["plain_ms"],
         "bound_ms": k6[2]["bound_ms"], "bound_by": "bytes",
         "library_ms": None},
        {"name": "ota_channel", "route": "cuda",
         "source": "src/repro_torch/kernels/ota_channel/csrc/ota_channel.cu",
         "replaces": "src/repro/kernels/ota_channel/kernel.py:451",
         "launches": total["ota_channel"], "max_abs_err": k7["max_abs_err"],
         "mask_mismatches": k7["mask_mismatches"],
         "ms": k7["ms"], "plain_ms": k7["plain_ms"],
         "bound_ms": k7["bound_ms"], "bound_by": k7["bound_by"],
         "library_ms": None},
        # the stream draws: no TPU kernel, the reference draws with XLA
        {"name": "threefry_chunked", "route": "cuda",
         "source": "src/repro_torch/kernels/ota_channel/csrc/"
                   "threefry_stream.cu",
         "replaces": "src/repro/core/ota.py:389",
         "launches": DRAW_TOTAL.get("threefry_chunked", 0),
         "max_abs_err": draw_chunked["max_abs_err"],
         "ms": draw_chunked["ms"], "plain_ms": draw_chunked["plain_ms"],
         "bound_ms": draw_chunked["bound_ms"],
         "bound_by": draw_chunked["bound_by"], "library_ms": None},
        {"name": "threefry_flat", "route": "cuda",
         "source": "src/repro_torch/kernels/ota_channel/csrc/"
                   "threefry_stream.cu",
         "replaces": "src/repro/kernels/ota_channel/ops.py:345",
         "launches": DRAW_TOTAL.get("threefry_flat", 0),
         "max_abs_err": draw_flat["max_abs_err"],
         "ms": draw_flat["ms"], "plain_ms": draw_flat["plain_ms"],
         "bound_ms": draw_flat["bound_ms"],
         "bound_by": draw_flat["bound_by"], "library_ms": None},
    ]
    record["draws_main_path"] = dict(DRAW_TOTAL)
    record["launches_main_path"] = total
    idle = [kn["name"] for kn in kernels if kn["launches"] <= 0]
    if idle:
        fail(f"kernels of the path never launched on it: {idle}")
    record.update(card=card, kind=kind)
    log("[record] " + json.dumps(record))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
