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
   bfloat16 (2e-2, every (s, h) row within ``K8_ROW_LIMIT``) covering D
   64/128/240, 1/2/12 query heads per KV head, no window and windows
   under a key tile, ragged S, S = 8193 with no window at D 64 and 128;
   in bfloat16 also every head dim the rule sends to the Hopper kernel
   (64, 80, ..., 256) at S = 300 with window 37, S = 8193 at D 96 and 240,
   S = 1000 with no window at D 112 and 176, and D 72 at S = 300 and 1000
   (bfloat16 at a multiple of 16 from 64 to 256 runs the Hopper
   kernel, TMA + wgmma: 128-key tiles up to D 128, 64-key tiles above;
   D 72 the mma.sync one, ``k8_small_cases``); then StarCoder2-3B's
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
   compute), B=4, a prefill of 8192 tokens and 16 decode steps, counters
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
   ranks sharing ``cuda:0`` (``launch.mesh.run_ranks``: one process per rank,
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
   stale copy relative L2 1e-3), and the step's split beside phase 19's;
25. the sampled paper round (``core.sampling.SampledHotaSim``, phase 5's
   config): the id draw on the card equal to the host's; banks of
   ``sample_bench.POPULATIONS`` clients per slot (1 to 32,768: 30 to
   983,040 clients), each with
   its bytes, init seconds and init peak memory, the round's channel
   words equal at every population, ``ROUNDS`` counted rounds (10 K1,
   1 K2 and one flat draw per round, 0 plain draws; the ids the host's)
   and the peak memory while stepping; one card round against the CPU
   round at ``SAMPLE_CPU_POP`` (metrics rtol 1e-4, ω and the heads
   relative L2 1e-3); a faulted blackout-1 round the bank's identity
   bit for bit, in place; ``experiments.sample_bench.sample_rows``
   (interleaved round medians and traced device-busy ms and launches per
   population, the launches equal at every population);
26. Fig. 4's S=4 bank over ``SampledHotaSim`` at ``SAMPLE_BANK_POP`` on
   the client-folded and streaming engines: counted (K1 10 or K5 100 and
   K2 1 per scenario round), the same ids in every scenario, each
   scenario against its own sampled rounds (rtol 1e-4, ω relative L2
   1e-3), the median and one traced bank round, the peak memory over the
   stacked states; then at ``SAMPLE_CKPT_POP`` a bank saved, restored
   and run one more round, bit for bit;
27. the per-leaf distributed step (``use_pallas_ota=False``, ``ota_mode``
   "scatter" and "naive") on phase 19's four ranks sharing the card,
   ``DIST_STEPS`` counted steps (no kernel of the slab path, the gains
   and AWGN on the stream kernel, 0 plain draws) against four CPU ranks
   (metrics rtol 1e-4, ω relative L2 1e-3); ``experiments.dist_bench``'s
   rows (slab, per-leaf scatter and naive, sectioned), each step split
   by ``MeshStats``;
28. the sectioned distributed step (``ota_sectioned``) at
   ``max_section_rows`` 0 and ``SPLIT_SECTION_ROWS`` in both count
   modes, bit for bit against the full-slab step of the same layout on
   the same ranks (at 0, phase 19's step), ``DIST_LEAVES`` K6 or K5
   launches per rank per step as the full-slab step, and each one's peak
   memory per rank;
29. LM training's pieces at ``lm-100m``'s width
   (``experiments/train_lm_federated.LM_100M``: B=4, S=128, 8 heads over
   4, D=80, attention blocks 64/64), each on the card against the CPU,
   float32, TF32 off: ``blocked`` and ``folded`` attention forward and
   backward (rtol ``LM_RTOL`` with an atol of rtol times the largest
   entry), StarCoder2-3B's smoke window (32 in blocks of 16: whole key
   blocks masked) with finite gradients, ``chunked_lm_loss`` in one piece
   (S=128) and in recomputed chunks (S=1024; loss rtol ``LM_RTOL``,
   gradients relative L2 1e-4), Mixtral-8x22B's smoke config (4 experts
   top-2) in train mode at capacity factor 1.25 and 0.1 (tokens drop)
   forward and backward (loss and aux rtol ``LM_RTOL``, gradient relative
   L2 1e-4), and one ``lm-100m`` train-mode forward and backward with no
   FL (loss rtol ``LM_RTOL``, gradient relative L2 1e-3) and its time;
30. the distributed LM step at ``lm-100m``'s full depth and width on
   phase 19's four ranks sharing the card, the example's FL settings
   (FedGradNorm, noise std 0.5, lr 3e-4), 4 sequences of 128 tokens per
   client from the example's skewed streams: per count mode
   ``LM_WARMUP`` warm-up and ``LM_STEPS`` counted steps (``LM_LEAVES``
   K6 launches per rank per step and microbatch in "local", as many K5
   in "psum", nothing else, 0 plain draws; finite metrics, the loss lower at the end
   than at the first step, p_mean·N within 1e-3 of N; the modes bit for
   bit), one 2-microbatch step and one per-leaf ("scatter") step, each
   step's time barrier to barrier and tokens per second, a "local" step
   split by ``MeshStats``, the peak memory per rank; then one step of an
   ``LM_CUT``-layer cut at the same width on the card ranks against four
   CPU ranks from the same initial state (metrics and p rtol ``LM_RTOL``,
   ω relative L2 1e-3); K6 and K5 at the model's 11 leaves (one rank's
   launches of one step) equal to their plain versions, timed beside
   their byte bounds and plain versions;
31. ``python -m repro_torch.launch.train --arch starcoder2-3b --steps 3
   --mesh 2,2,1`` as a subprocess, once with the layout tuner (its cache
   in a temporary directory) and once with ``--faults --ckpt-dir <tmp>
   --ckpt-every 1``: finite loss lines for steps 0 and 2, the layout
   line, the participation in the faulted lines, the full state of step
   2 and the final ω of step 3 restored from its checkpoints; then
   ``--arch zamba2-1.2b --steps 2 --mesh 2,2,1`` (the hybrid's smoke
   config: Mamba2 layers and the shared block in the distributed LM
   step): finite loss lines for steps 0 and 1;
32. phase 9's Fig. 4 bank as a ``ShardedScenarioBank`` on 4 and on 2
   scenario ranks sharing ``cuda:0`` (the first 4 and 2 ranks of phase
   33's world of processes over gloo: one start for both
   phases), client-folded and streaming:
   ``BANK_ROUNDS`` counted rounds (per scenario round 10 K1 or 100 K5 and
   1 K2; per rank the round's chunked draws once on client-folded, its
   scenarios' on streaming; 0 plain draws), every scenario's state and
   every round's metrics bit for bit phase 9's one-process bank's (sha256
   of each leaf); per rank the median bank round barrier to barrier
   (beside phase 9's one-process median and the one-process bank timed
   again just before the ranks start), one traced round (device-busy ms
   and launches) and the peak memory; a 4-rank save, a 2-rank restore
   and one more round, bit for bit; ``run_sweep(scenario_ranks=2)`` of
   ``SWEEP_ROUNDS`` rounds into a temporary directory equal to the
   one-process sweep (the wall time aside);
33. ``DistScenarioBank`` on phase 19's mesh and config, S=4 (σ² 0.5 and
   2.0 in every cluster, equal weighting, OTA off) on
   ``DIST_BANK_ROWS`` = 2 scenario rows (8 ranks) and on the first row
   (4 ranks), all sharing ``cuda:0`` over gloo: ``DIST_STEPS`` counted
   bank steps (``DIST_LEAVES`` K6 launches per scenario per rank per
   step in "local", 0 plain draws), 2 rows bit for bit 1 row, each
   scenario bit for bit phase 19's step given its ``chan``, the fault
   bank (dropout 0/0.25/0.5, blackout 1: ``skipped``, ``n_participants``,
   the blackout scenario the identity), a 2-row save restored into the
   row and stepped once bit for bit, the median bank step and a
   ``MeshStats`` split per placement beside phase 19's, the peak memory
   per rank and the time to build the 3-axis mesh's groups;
34. the MoE layer and the audio and vision stub frontends: (d) K8 against
   its plain version at Mixtral-8x22B's layer (B=1, S=8192, 48 heads over
   8, D=128, window 4096), Phi-3-vision-4.2B's (B=1, S=4096, 32 over 32,
   D=96, causal), StableLM-3B's (D=80, otherwise Phi-3-vision's) and
   Gemma-3-12B's local and global layers (B=1, S=8192, 16 over 8, D=240,
   window 1024 and none), all on the Hopper kernel, each batch element
   within 2e-2 and every row within ``K8_ROW_LIMIT``, its time beside its
   bound, the mma.sync design (checked against the plain version in the
   same way, then timed in turns with it: new, old, old, new), the plain
   version and SDPA; (b) one full-width
   Mixtral layer (8 experts of 6144 x 16384) drawn on the card, float32,
   B=1 S=64 prefill and 2 decode steps on the card against the CPU within
   ``CUT_F32_LIMIT``; (a) ``serve`` on Mixtral-8x22B at full width cut to
   ``MOE_LAYERS`` layers (bf16, B=2 x 8192 + 16 decode steps: exactly 4 K8
   launches, 0 plain draws, finite logits; init s and peak, prefill and
   decode ms, peak memory, a traced prefill and decode step;
   prefill(8192) + decode(1) against prefill(8193) within
   ``PREFILL_DECODE_LIMIT``); (c) ``serve`` on Phi-3-vision-4.2B at full
   depth and width from a (1, 4096, 3072) embedding prompt (32 K8
   launches on the Hopper kernel, the embeddings' prefill equal to the
   tokens' bit for bit, 8 finite decode steps, the same timings); (f)
   ``serve`` on Gemma-3-12B at full width (d_model 3840, 16/8 heads of
   240, vocab 262,144) cut to ``GEMMA_LAYERS`` = 6 layers, one 5:1
   local:global group (bf16, B=1 x 8192 + 8 decode steps: exactly 6 K8
   launches on the Hopper kernel, 0 plain draws, finite logits; init s
   and peak, prefill and decode ms, peak memory, a traced prefill and
   decode step; prefill(8192) + decode(1) against prefill(8193) within
   ``PREFILL_DECODE_LIMIT``); (e) the four
   new smoke configs (Mixtral, Phi-3.5-MoE, MusicGen, Phi-3-vision) with
   seeded weights through ``convert``, B=2 prefill of 40 and 4 decode
   steps, card against CPU within ``CUT_F32_LIMIT``; (g) the MoE block's
   dropless inference (``moe.moe_branch(train=False)``: the slots grouped
   by expert, the grouped GEMMs, the float32 combine and the shared
   expert) in bf16 against a per-expert loop on the same inputs and the
   same routing, at Granite-4.0-H-Small's layer (72 experts of 4096 x
   768, top-10, a shared expert of 1536) and Mixtral-8x22B's (8 of 6144 x
   16384, top-2), each at prefill size (B=1, S=8192 and 4096) and at
   decode size (B=2, S=1: most experts get no row), relative L2 within
   ``MOE_GROUPED_LIMIT`` and every token's row within
   ``MOE_GROUPED_ROW_LIMIT``, both paths timed;
35. the Mamba2, xLSTM and Zamba2-hybrid families: (a) K8 at Zamba2-1.2B's
   shared attention (B=1, S=8192, 32 heads over 32, D=64, window 4096) on
   the Hopper kernel, as phase 34's layers; (b) ``serve`` on Zamba2-1.2B
   at full depth and width (38 Mamba2 layers, the shared block applied 6
   times; bf16, B=1 x 8192 + 16 decode steps: exactly 6 K8 launches, 0
   plain draws, finite logits; init s and peak, prefill and decode ms,
   peak memory, a traced prefill and decode step), prefill(2047) +
   decode(1) against prefill(2048) within ``PREFILL_DECODE_LIMIT``, and a
   full-width 6-layer cut (one segment, one shared application) card
   against CPU in float32 at S = 4352, past the window, + 4 decode steps;
   (c) ``serve`` on xLSTM-1.3B at full depth and width (48 blocks; bf16,
   B=1 x 2048 + 8 decode steps, no K8 launch, the same timings, the
   traced prefill on the prompt's first 256 positions) with the sLSTM's
   share of the prefill, and a full-width 8-layer cut (one super-block)
   card against CPU at S = 512 (two mLSTM chunks) + 4 decode steps; (d)
   the zamba2 and xlstm smoke configs and the pure Mamba2 stack of
   ``tests/test_models.py``, card against CPU in serve (B=2, 40 tokens, 4
   decode steps) and in a train-mode forward and backward (loss, whole
   gradient). The card-vs-CPU decode steps of (b), (c) and (d) after the
   first (which reads the card's own prefill cache) each start from the
   CPU's cache: the state is rounded to bf16 in the cache, and the two
   devices' rounding flips would otherwise compound;
36. the examples on the card: ``experiments.serve_batched`` for each of
   the ten ``--arch`` smoke configs at its defaults (batch 4, 32-token
   prompt, 24 new tokens), counted (one K8 launch per attention layer per
   prefill, per application of zamba2's shared block, none for xlstm; no
   other kernel; 0 plain draws), the prefill logits against the same run
   on the CPU within ``CUT_F32_LIMIT`` (relative L2); then
   ``experiments.quickstart.main`` for ``QS_ROUNDS`` rounds at the
   example's full width (counted: 10 K1 and 1 K2 per round), each task's
   loss falling from the first round to the last, and the same run's
   first ``QS_CHECK_ROUNDS`` rounds against the CPU's (loss and p rtol
   1e-4, ω after them, copied to the host in the run, relative L2 1e-3);
   then ``quickstart.sweep``'s 3-scenario bank for
   ``QS_SWEEP_ROUNDS`` rounds (counted, finite);
37. the dry run's cost model against the card: on a one-rank mesh the dry
   run's own serve step (``launch.dryrun.serve_setup``) on StarCoder2-3B
   at full width with bf16 weights, prefill at B=1 x 8192 and one decode
   step against a cache of 8192, traced by ``launch.op_cost`` twice: on
   ``meta`` (the dry run) and for real on the card. The ``meta`` trace's
   argument bytes must equal the real inputs' exactly, its FLOPs the
   card trace's exactly, and its argument + temp bytes be within
   ``COST_PEAK_TOL`` of ``torch.cuda.max_memory_allocated`` over the step
   (the step's own peak above what was resident, plus its arguments); the
   step's measured ms is printed beside the compute and memory terms, as
   shares (not gated). Then the dry run's train step (``count_mode``
   "local") on a one-rank mesh at ``COST_TRAIN_ARCH``'s smoke config,
   traced on ``meta`` and run on the card under the same mode: the FLOPs
   equal, and each kernel's launches equal on both and to its wrapper's
   count on the card (every wrapper reports its launches to a running
   trace, and on ``meta`` runs its card path's torch ops around the
   kernel it records).

Every counted run also counts the stream draws: the card's two draw
kernels and the plain draw, which must stay at 0 on the card.

Before the last lines it stops the ranks' fork server and its resource
tracker and fails if a process it started still runs.

Any failure exits non-zero. The line before last is the card's name and
power limit, the one before it the kernels' JSON (K1, K2, K5, K3, K4, K8,
K6, K7 and the two stream draws, K5 and K6 also with one rank's step of
``lm-100m``, ``lm100m_step_ms``, K8 also at phase 34's five layer shapes
and phase 35's;
each kernel's ``launches`` sums its counts over the main-path runs of
phases 5, 9, 11, 12, 13, 16, 19, 20, 21, 22, 24-28, 30, 32-36,
over all ranks, and a kernel never launched there fails the run; K1, K2,
K5 and K6 also carry their fault-mode error); the last line is
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
TIMED_BANK_ROUNDS = 3     # bank rounds per engine for the median round
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
TIMED_PERLEAF_ROUNDS = 3  # per-leaf rounds for the median round time
MASK_ULPS = 16            # per-leaf mask rule: |h² − H_th| within this
SWEEP_ROUNDS = 2          # run_sweep rounds with the tuner on

# phases 14-16: StarCoder2-3B at full width (configs/starcoder2_3b.py)
BF16_FLOPS_PER_S = 989e12     # H100 SXM, dense bf16 tensor cores
K8_SEQ = 8192                 # prefill length: crosses the 4096 window
SERVE_BATCH = 4
SERVE_DECODE_STEPS = 16       # decode-step calls after the prefill
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
DIST_TIMED_STEPS = 3          # timed steps per count mode
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

# phases 25-28: client sampling, the sampled bank, the per-leaf and the
# sectioned distributed steps
SAMPLE_CPU_POP = 4            # the card round held against the CPU's
SAMPLE_BANK_POP = 4096        # phase 26's sampled Fig. 4 bank (S=4)
SAMPLE_CKPT_POP = 256         # phase 26's save/restore (disk I/O kept small)
SAMPLE_BENCH_ROUNDS = 6       # sample_bench rounds per row, interleaved
PERLEAF_MODES = ("scatter", "naive")
SPLIT_SECTION_ROWS = 4096     # phase 28: splits the Table-I fc2 section
DIST_BENCH_STEPS = 3          # dist_bench timed steps per engine

# phases 29-31: LM training (experiments/train_lm_federated.py's lm-100m)
LM_BATCH = 4                  # sequences per client
LM_SEQ = 128                  # tokens per sequence
LM_RTOL = 1e-4                # card against CPU, float32, TF32 off
LM_WARMUP = 1                 # warm-up steps per count mode
LM_STEPS = 2                  # counted steps per count mode
LM_LEAVES = 11                # K6 (or K5) launches per rank per step
LM_CUT = 2                    # layers of the cut held against CPU ranks
LAUNCH_STEPS = 3              # launch.train steps (the smoke config)
HYBRID_LAUNCH_STEPS = 2       # launch.train steps of zamba2's smoke config

# phases 32-33: the scenario banks spread over ranks sharing the card
SHARDED_RANKS = (4, 2)        # phase 32's placements (the world first)
DIST_BANK_ROWS = 2            # phase 33: scenario rows of phase 19's mesh
DIST_BANK_SCENARIOS = [dict(sigma2=(0.5,) * DIST_SHAPE[0]),   # phase 33:
                       dict(sigma2=(2.0,) * DIST_SHAPE[0]),   # the reference
                       dict(weighting="equal"), dict(ota=False)]  # program's

# phase 34: the MoE layer and the stub frontends
MOE_LAYERS = 4                # Mixtral-8x22B's depth cut (widths unchanged)
MOE_BATCH = 2
MOE_DECODE_STEPS = 16         # decode-step calls after the prefill
MOE_CUT_SEQ, MOE_CUT_STEPS = 64, 2   # one full-width layer, card vs CPU
VISION_SEQ = 4096             # Phi-3-vision's embedding prompt
VISION_DECODE_STEPS = 8
NEW_SMOKE = ("mixtral_8x22b", "phi3_5_moe_42b", "musicgen_medium",
             "phi3_vision_4_2b")
NEW_SMOKE_BATCH, NEW_SMOKE_SEQ, NEW_SMOKE_STEPS = 2, 40, 4
# phase 34g: the grouped dropless MoE against a per-expert loop, bf16:
# (d_model, experts, expert width, top-k, shared width, prefill B x S)
MOE_GROUPED_SHAPES = {"granite_h_small": (4096, 72, 768, 10, 1536, 8192),
                      "mixtral_8x22b": (6144, 8, 16384, 2, 0, 4096)}
MOE_GROUPED_LIMIT = 1e-2      # bf16 products summed in other orders; one
MOE_GROUPED_ROW_LIMIT = 3e-2  # dropped expert moves its token's row ~10 %
# K8 at the new layers' shapes: (B, S, H, KV, D, window)
K8_NEW_SHAPES = {"mixtral_layer": (1, 8192, 48, 8, 128, 4096),
                 "phi3_vision_layer": (1, 4096, 32, 32, 96, None),
                 "stablelm_layer": (1, 4096, 32, 32, 80, None),
                 "gemma3_local_layer": (1, 8192, 16, 8, 240, 1024),
                 "gemma3_global_layer": (1, 8192, 16, 8, 240, None)}
# phase 34f: Gemma-3-12B at full width, one 5:1 local:global group
GEMMA_LAYERS = 6
GEMMA_DECODE_STEPS = 8
# phase 35: the Mamba2, xLSTM and Zamba2-hybrid families
ZAMBA_K8_SHAPE = (1, 8192, 32, 32, 64, 4096)   # the shared attention block
ZAMBA_DECODE_STEPS = 16
ZAMBA_CUT_LAYERS = 6          # one segment of 6 Mamba2 layers, one shared
ZAMBA_CUT_SEQ = 4352          # past the 4096 window, 17 SSD chunks of 256
ZAMBA_CHECK_SEQ = 2047        # prefill(S) + decode(1) vs prefill(S + 1):
                              # S + 1 a multiple of 256, S one whole chunk
XLSTM_SEQ = 2048
XLSTM_DECODE_STEPS = 8
XLSTM_TRACE_SEQ = 256         # the traced prefill: one mLSTM chunk
XLSTM_CUT_LAYERS = 8          # one super-block: 7 mLSTM + 1 sLSTM
XLSTM_CUT_SEQ = 512           # two mLSTM chunks of 256

# phases 36-37: the examples and the dry run's cost model
EXAMPLE_ARCHS = ("starcoder2-3b", "stablelm-3b", "musicgen-medium",
                 "phi-3-vision-4.2b", "gemma3-12b", "zamba2-1.2b",
                 "phi3.5-moe-42b-a6.6b", "xlstm-1.3b", "mixtral-8x22b",
                 "qwen2.5-14b")
QS_ROUNDS = 60                # quickstart.main's rounds (the example's)
QS_CHECK_ROUNDS = 3           # its first rounds held against the CPU
QS_SWEEP_ROUNDS = 20          # quickstart.sweep's rounds (the example's)
# meta argument + temp against the card's peak: measured within 0.03 %
# on an H100 80GB HBM3
COST_PEAK_TOL = 0.01
COST_TRAIN_ARCH = "stablelm_3b"   # phase 37's train step: its smoke config
COST_TRAIN_SHAPE = (2, 64, 2)     # (batch, sequence, microbatches)
COST_PREFILL_ITERS = 2        # timed prefills (median)
COST_DECODE_ITERS = 5         # timed decode steps (median)
STATE_CUT_STEPS = 4           # decode steps of the card-vs-CPU cuts
FAMILY_SMOKE = ("zamba2_1_2b", "xlstm_1_3b", "mamba2")

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
    without ``device_trace``'s spacers and without the device-side copies
    of the program's spans (``common.spans.device_work``)."""
    from repro_torch.common.spans import device_work
    return [e for e in device_work(prof.key_averages())
            if SPACER_KERNEL not in e.key]


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
    draws = record["tuned_sweep_draws"] = take_draws("tuned sweep", launches)
    if launches != want:
        fail(f"tuned sweep on {choice.describe()}: launches {launches}, "
             f"expected {want}")
    # one gain and one noise draw per section per round: the count follows
    # the winner's layout, which the calibration's timings pick
    n_draws = 0 if packer is None else 2 * len(packer.sections) * SWEEP_ROUNDS
    if packer is not None and draws.get("threefry_chunked") != n_draws:
        fail(f"tuned sweep on {choice.describe()}: {draws} stream draws, "
             f"expected {n_draws} chunked ones")
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


def k8_small_cases():
    """Phase 14's small cases, (dtype, (B, S, H, KV, D, window)).

    In both dtypes: D 64/128/240, G 1/2/12, no window and windows under a
    key tile, ragged S, and S = 8193 (one row past a 128-row tile) with no
    window at D 64 and 128. In bfloat16 alone: every head dim the rule
    sends to the Hopper kernel (64, 80, ..., 256: tiling A up to 128,
    tiling B above) at a ragged S with a window under a key tile (37 < 64),
    S = 8193 at D 96 and 240, S = 1000 with no window at D 112 (tiling A)
    and 176 (tiling B), so that the key-tile ring refills at head dims no
    config uses, and D 72, which stays on mma.sync, at S = 300 and at
    S = 1000 over several key tiles. bfloat16
    at a Hopper head dim runs the Hopper kernel (TMA + wgmma), other
    bfloat16 head dims the mma.sync one, float32 the FMA kernel
    (ops.kernel_for)."""
    import torch
    from repro_torch.kernels.flash_attention import ops as k8
    both = [(2, 256, 4, 4, 64, None), (2, 256, 4, 2, 128, 64),
            (1, 300, 24, 2, 128, 5), (1, 129, 4, 2, 240, 17),
            (2, 77, 12, 1, 64, None), (1, 1, 24, 2, 128, None),
            (1, 1000, 8, 4, 240, 100), (1, 8193, 4, 2, 64, None),
            (1, 8193, 4, 2, 128, None)]
    bf16 = [(1, 300, 4, 2, d, 37)
            for d in range(k8.HOPPER_MIN_HEAD_DIM, k8.MAX_HEAD_DIM + 1,
                           k8.HOPPER_HEAD_DIM_STEP)]
    bf16 += [(1, 8193, 4, 2, 96, None), (1, 8193, 4, 2, 240, None),
             (1, 1000, 4, 2, 112, None), (1, 1000, 4, 2, 176, None),
             (1, 300, 4, 2, 72, 37), (1, 1000, 8, 4, 72, 100)]
    return ([(torch.float32, c) for c in both]
            + [(torch.bfloat16, c) for c in both + bf16])


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

    tols = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
    checks = {}
    for dtype, case in k8_small_cases():
        q, k, v = inputs(*case[:5], dtype)
        got = k8.flash_attention(q, k, v, window=case[5])
        torch.cuda.synchronize()
        want = flash_attention_ref(q, k, v, window=case[5])
        name = f"{case} {str(dtype)[6:]} {k8.kernel_for(dtype, case[4])}"
        k8_compare(name, got, want, tols[dtype], checks)
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


def serve_logits(model, wts, d, prompt, steps, cache_len, forced=None,
                 caches=None):
    """Logits (B, V) of a prefill of ``prompt`` and of each of ``steps``
    decode steps on device ``d``, greedy or fed ``forced`` tokens; with
    ``caches`` (a list to fill, or one filled by an earlier call), the
    cache each decode step after the first starts from is recorded, or
    taken from the list in place of this run's own."""
    import torch
    from repro_torch.common.tree import state_map
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    s = prompt.shape[1]
    lg, cache = make_prefill_step(model, cache_len=cache_len)(
        *wts, prompt.to(d))
    out = [lg]
    decode = make_decode_step(model)
    feed = caches is not None and len(caches) == steps - 1
    for i in range(steps):
        if i and caches is not None:
            if feed:
                cache = state_map(lambda t: t.to(d), caches[i - 1])
            else:
                caches.append(state_map(lambda t: t.clone(), cache))
        tok = (lg.argmax(-1) if forced is None else forced[i]).to(d)
        pos = torch.full((prompt.shape[0],), s + i, dtype=torch.int32,
                         device=d)
        _, lg, cache = decode(*wts, cache, tok[:, None].long(), pos)
        out.append(lg)
    return out


def card_vs_cpu(name, model, w_dev, w_cpu, prompt, steps, limit, rec, dev,
                feed_cache=False):
    """A prefill and ``steps`` decode steps on the card against the same
    on the CPU, the card fed the CPU's greedy tokens (and with
    ``feed_cache`` each decode step after the first, which reads the
    card's own prefill cache, the CPU's cache: a model whose prefill and
    decode round their state to bf16 in the cache would otherwise
    compound the two devices' rounding flips from step to step): every
    step's logits within ``limit`` relative L2 (``lm_logit_check``).
    Returns the relative L2 per step."""
    import torch
    cache_len = prompt.shape[1] + steps + 1
    caches = [] if feed_cache else None
    t0 = time.perf_counter()
    cpu = serve_logits(model, w_cpu, torch.device("cpu"), prompt, steps,
                       cache_len, caches=caches)
    rec[f"{name}_cpu_s"] = time.perf_counter() - t0
    card = serve_logits(model, w_dev, dev, prompt, steps, cache_len,
                        forced=[lg.argmax(-1) for lg in cpu], caches=caches)
    torch.cuda.synchronize()
    rels = [lm_logit_check(f"{name}_step{i}", g, c, limit, rec)
            for i, (g, c) in enumerate(zip(card, cpu))]
    rec[f"{name}_rel_l2"] = rels
    return rels


def cut_phase(dev, record):
    """Phase 15: a 2-layer cut of full-width StarCoder2-3B, prefill and 4
    decode steps on the card against the same on the CPU, in float32 and
    in bfloat16 compute; the card is fed the CPU's greedy tokens."""
    import torch
    from repro_torch.common.tree import tree_map
    from repro_torch.launch import serve as serve_mod
    rec = {}
    s, steps = CUT_SEQ, CUT_STEPS
    for cdt, limit in (("float32", CUT_F32_LIMIT),
                       ("bfloat16", CUT_BF16_LIMIT)):
        cfg = sc2_config().replace(n_layers=CUT_LAYERS, compute_dtype=cdt)
        model = serve_mod.serving_model(cfg)
        w_dev = serve_mod.init_weights(model, 0, dev)
        w_cpu = tuple(tree_map(lambda t: t.cpu(), w) for w in w_dev)
        prompt = serve_mod.draw_prompt(cfg, 1, s, 0)
        rels = card_vs_cpu(f"cut_{cdt}", model, w_dev, w_cpu, prompt, steps,
                           limit, rec, dev)
        log(f"[cut] {CUT_LAYERS}-layer StarCoder2-3B at full width, B=1, "
            f"S={s}, {cdt} compute: card vs CPU relative L2 of the logits "
            f"(prefill, then {steps} decode steps) "
            f"{['%.3e' % r for r in rels]} (limit {limit:g}); CPU "
            f"{rec[f'cut_{cdt}_cpu_s']:.1f} s")
        del w_dev, w_cpu
        torch.cuda.empty_cache()
    record["cut"] = rec


def serve_cell(dev, label, model, weights, b, s, n_dec, counters, rec,
               prompt=None, k8_launches=None, trace_len=None):
    """``serve`` of (b, s) + ``n_dec`` decode steps, counted (one K8
    launch per attention layer in the prefill, ``k8_launches`` when given
    else one per layer, none in decode, no other kernel, 0 plain draws;
    finite logits); a second run for the prefill time (time to first
    token), the decode time per step (host clock ending in a synchronize)
    and the peak device memory; one traced prefill (of the prompt's first
    ``trace_len`` positions when given: a trace of many thousand host
    steps takes minutes to read back) and one traced decode step.
    ``prompt`` defaults to ``serve``'s draw from seed 0. Returns the
    counted run's launches."""
    import torch
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    cfg = model.cfg

    def run():
        return serve_mod.serve(cfg, b, s, n_dec + 1, seed=0, device=dev,
                               weights=weights, prompt=prompt,
                               log=lambda m: None)
    for ctr in counters:
        ctr.reset()
    res = run()
    torch.cuda.synchronize()
    launches = {ctr.name: ctr.count for ctr in counters}
    take_draws(label, launches, draws_words=False)
    want = {ctr.name: 0 for ctr in counters if ctr.name not in DRAW_NAMES}
    want["flash_attention"] = (cfg.n_layers if k8_launches is None
                               else k8_launches)
    if launches != want:
        fail(f"{label}: launches {launches}, expected {want} (one prefill, "
             f"{n_dec} decode steps)")
    if not (torch.isfinite(res.prefill_logits).all()
            and torch.isfinite(res.last_logits).all()):
        fail(f"{label}: non-finite logits")
    rec.update(launches=launches, first_prefill_s=res.prefill_s,
               first_decode_ms=[1e3 * t for t in res.decode_s],
               tokens=res.tokens[:, :8].tolist(),
               prefill_logits=res.prefill_logits)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    res = run()
    rec["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    rec["peak_bytes_above_weights"] = rec["peak_bytes"] - base
    rec["prefill_ms"] = 1e3 * res.prefill_s
    rec["decode_ms"] = [1e3 * t for t in res.decode_s]
    rec["decode_ms_median"] = statistics.median(rec["decode_ms"])
    log(f"[{label}] B={b}, prefill {s}, {n_dec} decode steps: launches "
        f"{launches}; prefill (time to first token) {rec['prefill_ms']:.1f} "
        f"ms (first call {1e3 * rec['first_prefill_s']:.1f}), decode median "
        f"{rec['decode_ms_median']:.2f} ms per step (min "
        f"{min(rec['decode_ms']):.2f}, max {max(rec['decode_ms']):.2f}); "
        f"peak device memory {rec['peak_bytes'] / 1e9:.2f} GB")

    # where the time goes: one traced prefill and one traced decode step
    prefill = make_prefill_step(model, cache_len=s + n_dec + 2)
    decode = make_decode_step(model)
    if prompt is None:
        prompt = serve_mod.draw_prompt(cfg, b, s, 0)
    prompt = prompt.to(dev)[:, :trace_len]
    s = prompt.shape[1]
    rec["trace_prefill_len"] = s
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
        log(f"[trace] {label}, one {what} (S={s}): {wall:.2f} ms wall, "
            f"device busy "
            f"{busy:.2f} ms ({100 * busy / wall:.1f} %), K8 "
            f"{rec[f'trace_{what}']['k8_ms']:.2f} ms")
        for t, k_, n in rows[:8]:
            log(f"  {t:9.3f} ms  x{n:<4} {k_[:90]}")
    del cache, lg
    torch.cuda.empty_cache()
    return launches


def prefill_decode_check(dev, label, model, weights, s, rec,
                         k8_launches=None):
    """At B=1, prefill(s) + decode(1) against prefill(s + 1): relative L2
    of the logits within ``PREFILL_DECODE_LIMIT`` and the argmax rule of
    ``lm_logit_check``, K8 once per attention layer in each prefill
    (``k8_launches`` when given, else once per layer)."""
    import torch
    from repro_torch.kernels.flash_attention import ops as k8
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    prompt = serve_mod.draw_prompt(model.cfg, 1, s + 1, 1).to(dev)
    before = k8.counter.count
    _, cache = make_prefill_step(model, cache_len=s + 2)(*weights,
                                                         prompt[:, :s])
    pos = torch.full((1,), s, dtype=torch.int32, device=dev)
    _, dec, _ = make_decode_step(model)(*weights, cache, prompt[:, s:], pos)
    full, _ = make_prefill_step(model)(*weights, prompt)
    torch.cuda.synchronize()
    per = model.cfg.n_layers if k8_launches is None else k8_launches
    if k8.counter.count - before != 2 * per:
        fail(f"{label}: prefill(S) and prefill(S + 1) did not run K8 once "
             f"per attention layer")
    rel = lm_logit_check("prefill_decode_vs_prefill", dec, full,
                         PREFILL_DECODE_LIMIT, rec)
    log(f"[{label}] B=1: prefill({s}) + decode(1) vs prefill({s + 1}): "
        f"relative L2 {rel:.3e} (limit {PREFILL_DECODE_LIMIT:g}), "
        f"{rec['prefill_decode_vs_prefill']}")
    del cache
    torch.cuda.empty_cache()
    return rel


def serve_phase(dev, record, counters):
    """Phase 16: ``serve`` at full depth and width, B=4 x 8192 +
    ``SERVE_DECODE_STEPS`` decode steps, counted; timings, a traced prefill and decode step, peak memory;
    prefill(8192) + decode(1) against prefill(8193) at B=1."""
    import torch
    from repro_torch.launch import serve as serve_mod
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
    launches = serve_cell(dev, "serve", model, weights, b, s, n_dec,
                          counters, rec)
    del rec["prefill_logits"]
    prefill_decode_check(dev, "serve", model, weights, s, rec)
    del weights
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


# --------------------------------------------------------------------------
# phases 25-28: client sampling, the sampled bank, the per-leaf and the
# sectioned distributed steps
# --------------------------------------------------------------------------

def _bank_leaves(bank):
    from repro_torch.common.tree import state_map
    out = []
    state_map(out.append, bank)
    return out


def _clone_state(state):
    import torch
    from repro_torch.common.tree import state_map
    return state_map(torch.clone, state)


def sampled_phase(sim, batcher, key0, dev, record, counters):
    """Phase 25: the sampled paper round at full width. Returns the
    launches of its counted runs."""
    import dataclasses
    import torch
    from repro_torch import rng
    from repro_torch.common.tree import tree_leaves
    from repro_torch.core import ota
    from repro_torch.core.sampling import SampledHotaSim
    from repro_torch.experiments.sample_bench import (
        POPULATIONS, bank_bytes, sample_rows,
    )
    fl = sim.fl
    c, n = fl.n_clusters, fl.n_clients
    n_cls = sim.n_classes.tolist()
    rec = {"populations_per_slot": list(POPULATIONS)}

    # the id draw on the card against the host's
    for i in range(8):
        k = rng.fold_in(key0, 5000 + i)
        for m in POPULATIONS + (2 ** 31 - 1,):
            got = ota.draw_client_sample(k, c, n, m, dev).cpu()
            if not torch.equal(got, ota.draw_client_sample(k, c, n, m)):
                fail(f"sample draw at M={m}: the card's ids differ from "
                     f"the host's")
    batches = [batcher.next_stacked() for _ in range(ROUNDS + 1)]
    keys = [rng.fold_in(key0, 6000 + r) for r in range(ROUNDS + 1)]
    total, per_m, words0 = {}, {}, None
    for m in POPULATIONS:
        samp = SampledHotaSim(sim.model, fl, sim.tcfg, n_cls, m, device=dev)
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        st = samp.init(rng.PRNGKey(0))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        init_peak = torch.cuda.max_memory_allocated(dev) - base
        nbytes = bank_bytes(st)
        n_leaves = len(samp.sim.packer(st.sim.omega).leaf_runs())
        # position determinism: the round's channel words at every M
        words = samp.round_streams(keys[0], st.sim.omega)
        if words0 is None:
            words0 = words
        elif not all(torch.equal(a, b) for a, b in zip(
                words.gain + words.noise, words0.gain + words0.noise)):
            fail(f"sampled round at M={m}: the channel words depend on the "
                 f"population")
        del words
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        for ctr in counters:
            ctr.reset()
        metrics = []
        for r in range(ROUNDS):
            st, mt = samp.step(st, *batches[r], keys[r])
            metrics.append(mt)
        torch.cuda.synchronize()
        launches = {ctr.name: ctr.count for ctr in counters}
        step_peak = torch.cuda.max_memory_allocated(dev)
        draws = take_draws(f"sampled round M={m}", launches)
        want = {k: 0 for k in launches}
        want.update(ota_client_fold=n_leaves * ROUNDS,
                    masked_gradnorm=ROUNDS)
        if launches != want:
            fail(f"sampled round M={m}: launches {launches}, expected {want}")
        if draws.get("threefry_flat", 0) != ROUNDS:
            fail(f"sampled round M={m}: {draws.get('threefry_flat', 0)} flat "
                 f"draws, expected 1 per round (the ids)")
        for r, mt in enumerate(metrics):
            if not all(bool(torch.isfinite(v.float()).all())
                       for v in mt.values()):
                fail(f"sampled round M={m}: non-finite metrics")
            if not torch.equal(mt["sample_ids"].cpu(), ota.draw_client_sample(
                    keys[r], c, n, m)):
                fail(f"sampled round M={m}: ids differ from the host's draw")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        per_m[m] = {"clients": c * n * m, "bank_bytes": nbytes,
                    "init_s": init_s, "init_peak_bytes": init_peak,
                    "launches": launches,
                    "draws_per_round": {k: v / ROUNDS
                                        for k, v in draws.items()},
                    "allocated_before_step": before,
                    "step_peak_bytes": step_peak,
                    "step_peak_minus_bank": step_peak - nbytes,
                    "step_extra_bytes": step_peak - before}
        log(f"[sample] M={m} per slot ({c * n * m:,} clients): bank "
            f"{nbytes / 1e9:.3f} GB, init {init_s:.2f} s (peak "
            f"{init_peak / 1e9:.3f} GB); {ROUNDS} rounds, launches "
            f"{launches}, draws per round {per_m[m]['draws_per_round']}; "
            f"peak while stepping {step_peak / 1e9:.3f} GB, "
            f"{(step_peak - before) / 1e6:.1f} MB above the state")
        del st, samp, metrics
    rec["per_population"] = per_m
    del words0
    torch.cuda.empty_cache()

    # one card round against the CPU round at a small population
    samp = SampledHotaSim(sim.model, fl, sim.tcfg, n_cls, SAMPLE_CPU_POP,
                          device=dev)
    cpu_samp = SampledHotaSim(sim.model, fl, sim.tcfg, n_cls, SAMPLE_CPU_POP,
                              device="cpu")
    st = samp.init(rng.PRNGKey(0))
    st, _ = samp.step(st, *batches[0], keys[0])
    # the CPU first: a step consumes its state (the bank is written in
    # place)
    new_c, m_c = cpu_samp.step(to_cpu(st), *batches[-1], keys[-1])
    new_g, m_g = samp.step(st, *batches[-1], keys[-1])
    cmp = {name: check_close(f"sampled round {name}", m_g[name].cpu(),
                             m_c[name], rtol=1e-4, atol=1e-6)
           for name in ("loss", "p", "grad_norms", "fgrad")}
    if not torch.equal(m_g["sample_ids"].cpu(), m_c["sample_ids"]):
        fail("sampled round: the card's ids differ from the CPU's")
    cmp["omega_rel_l2"] = rel_l2(_leaf_cat(new_g.sim.omega),
                                 _leaf_cat(new_c.sim.omega))
    cmp["heads_rel_l2"] = rel_l2(_leaf_cat(new_g.sim.heads),
                                 _leaf_cat(new_c.sim.heads))
    cmp["bank_heads_rel_l2"] = rel_l2(_leaf_cat(new_g.bank.heads),
                                      _leaf_cat(new_c.bank.heads))
    if max(cmp["omega_rel_l2"], cmp["heads_rel_l2"],
           cmp["bank_heads_rel_l2"]) > 1e-3:
        fail(f"sampled card round vs CPU round: {cmp}")
    rec["card_vs_cpu"] = cmp
    log(f"[sample] card round vs CPU round at M={SAMPLE_CPU_POP}: {cmp}")
    del st, new_g, new_c, samp, cpu_samp

    # a faulted blackout round is the bank's identity, bit for bit
    fsamp = SampledHotaSim(sim.model, dataclasses.replace(
        fl, faults=True, blackout_rate=1.0), sim.tcfg, n_cls, POPULATIONS[1],
        device=dev)
    st = fsamp.init(rng.PRNGKey(0))
    before = _clone_state(st.bank)
    ptrs = [l.data_ptr() for l in _bank_leaves(st.bank)]
    new, m_b = fsamp.step(st, *batches[0], keys[0])
    torch.cuda.synchronize()
    ident = (float(m_b["skipped"]) == 1.0
             and [l.data_ptr() for l in _bank_leaves(new.bank)] == ptrs
             and all(torch.equal(a, b) for a, b in zip(
                 _bank_leaves(new.bank), _bank_leaves(before))))
    if not ident:
        fail("sampled blackout round: the bank is not its identity")
    rec["blackout_bank_identity"] = ident
    del st, new, before, fsamp
    torch.cuda.empty_cache()

    # sample_bench: interleaved round medians and traced device-busy ms
    rows = sample_rows(device=dev, rounds=SAMPLE_BENCH_ROUNDS)
    rec["sample_rows"] = rows
    base = rows[0]["round_ms_median"]
    sampled = [r for r in rows if r["population"] is not None]
    launch_sets = {tuple(r["device_launches"]) for r in sampled}
    busy = [r["device_busy_ms_median"] for r in sampled]
    rec["busy_spread"] = (max(busy) - min(busy)) / min(busy)
    rec["busy_m1_vs_mmax"] = (sampled[-1]["device_busy_ms_median"]
                              / sampled[0]["device_busy_ms_median"] - 1)
    rec["sampled_launches_equal"] = len(launch_sets) == 1
    for row in rows:
        log(f"[sample time] {row['name']}: median "
            f"{row['round_ms_median']:.2f} ms ({row['round_ms_median'] / base - 1:+.1%}"
            f" vs unsampled); traced device busy {row['device_busy_ms']} ms, "
            f"launches {row['device_launches']}; bank "
            f"{row['bank_bytes'] / 1e9:.3f} GB, init {row['init_s']:.2f} s")
    log(f"[sample] device busy M=1 vs M={POPULATIONS[-1]}: "
        f"{rec['busy_m1_vs_mmax']:+.2%}, spread over the populations "
        f"{rec['busy_spread']:.2%}; device launches equal at every M: "
        f"{rec['sampled_launches_equal']}")
    if not rec["sampled_launches_equal"]:
        fail(f"sampled rounds: device launches depend on the population: "
             f"{[r['device_launches'] for r in sampled]}")
    record["sampled"] = rec
    torch.cuda.empty_cache()
    return total


def sampled_bank_phase(sim, batcher, dev, record, counters):
    """Phase 26: Fig. 4's S=4 bank over ``SampledHotaSim`` at M=4096 on
    the client-folded and streaming engines: counted, each scenario
    against its own sampled rounds, timed, traced, its peak memory over
    the stacked states; then (at a smaller M) save, restore and one more
    round bit for bit. Returns the counted launches."""
    import dataclasses
    import tempfile
    import torch
    from repro_torch import rng
    from repro_torch.core.channel import scenario_channel
    from repro_torch.core.sampling import SampledHotaSim
    from repro_torch.core.sweep import ScenarioBank
    from repro_torch.experiments.fig4_diverse_sigma import (
        experiments as fig4_experiments,
    )
    from repro_torch.experiments.sample_bench import bank_bytes
    specs = list(fig4_experiments().values())
    s_n = len(specs)
    fl = sim.fl
    c = fl.n_clusters
    n_cls = sim.n_classes.tolist()
    batches = [batcher.next_stacked() for _ in range(FAULT_BANK_ROUNDS)]
    keys = [rng.fold_in(rng.PRNGKey(88), r) for r in range(FAULT_BANK_ROUNDS)]
    total, rec = {}, {"population_per_slot": SAMPLE_BANK_POP}
    for name in ("client_folded", "streaming"):
        samp = SampledHotaSim(sim.model, dataclasses.replace(
            fl, **ENGINES[name]), sim.tcfg, n_cls, SAMPLE_BANK_POP,
            device=dev)
        bank = ScenarioBank(samp, specs)
        torch.cuda.empty_cache()
        states = bank.init(rng.PRNGKey(0))
        stacked = bank_bytes(states)
        n_leaves = len(samp.sim.packer(states.sim.omega).leaf_runs())
        torch.cuda.synchronize()
        for ctr in counters:
            ctr.reset()
        states, hist = bank.run(states, batches, keys)
        torch.cuda.synchronize()
        launches = {ctr.name: ctr.count for ctr in counters}
        draws = take_draws(f"sampled bank on {name}", launches)
        per = s_n * FAULT_BANK_ROUNDS
        want = {k: 0 for k in launches}
        want["masked_gradnorm"] = per
        if name == "streaming":
            want["ota_mask_weight"] = c * n_leaves * per
        else:
            want["ota_client_fold"] = n_leaves * per
        if launches != want:
            fail(f"sampled bank on {name}: launches {launches}, expected "
                 f"{want}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        ids = hist["sample_ids"]
        if not all(torch.equal(ids[:, s], ids[:, 0]) for s in range(s_n)):
            fail(f"sampled bank on {name}: scenarios drew different ids")
        # each scenario against its own sampled rounds (one at a time: a
        # scenario's state holds a whole bank)
        cmp = {"bits_equal": True}
        for s in range(s_n):
            st_s = samp.init(rng.PRNGKey(0))
            ch = scenario_channel(bank.chan_bank, s)
            for r in range(FAULT_BANK_ROUNDS):
                st_s, m_s = samp.step(st_s, *batches[r], keys[r], chan=ch)
                for k in ("loss", "p", "grad_norms", "fgrad"):
                    check_close(f"sampled bank {name} s={s} {k}",
                                hist[k][r, s], m_s[k], rtol=1e-4,
                                atol=1e-6)
                    cmp["bits_equal"] &= torch.equal(hist[k][r, s], m_s[k])
            view = bank.scenario_state(states, s)
            w_b, w_s = _leaf_cat(view.sim.omega), _leaf_cat(st_s.sim.omega)
            cmp[f"omega_rel_l2_s{s}"] = rel_l2(w_b, w_s)
            cmp["bits_equal"] &= torch.equal(w_b, w_s) and all(
                torch.equal(a, b) for a, b in zip(
                    _bank_leaves(view.bank), _bank_leaves(st_s.bank)))
            if cmp[f"omega_rel_l2_s{s}"] > 1e-3:
                fail(f"sampled bank on {name} s={s} vs its sampled sim: "
                     f"{cmp}")
            del st_s, view
        torch.cuda.empty_cache()
        # the median bank round, one traced round, peak over the stack
        holder = [states]
        del states
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        times = []
        for r in range(TIMED_BANK_ROUNDS + 1):
            b_r = batcher.next_stacked()
            k_r = rng.fold_in(rng.PRNGKey(89), r)

            def one():
                holder[0], _ = bank.step(holder[0], *b_r, k_r)
            if r == TIMED_BANK_ROUNDS:
                with device_trace() as prof:
                    traced = host_ms(one)
            else:
                times.append(host_ms(one))
        peak = torch.cuda.max_memory_allocated(dev)
        ev = [(e.self_device_time_total / 1e3, e.count)
              for e in device_events(prof)]
        rec[name] = {
            "launches": launches, "draws_per_bank_round": {
                k: v / FAULT_BANK_ROUNDS for k, v in draws.items()},
            "vs_sampled_sim": cmp, "stacked_bank_bytes": stacked,
            "allocated_before": before, "peak_bytes": peak,
            "peak_over_stacked_bank": peak / stacked - 1,
            "step_extra_bytes": peak - before,
            "round_ms": times, "round_ms_median": statistics.median(times),
            "traced_round_ms": traced,
            "device_busy_ms": sum(t for t, _ in ev),
            "device_launches_traced": sum(k for _, k in ev)}
        log(f"[sampled bank] {name}: S={s_n} at M={SAMPLE_BANK_POP}, "
            f"launches {launches}; vs per-scenario SampledHotaSim {cmp}; "
            f"median {rec[name]['round_ms_median']:.2f} ms per bank round "
            f"(all {['%.2f' % t for t in times]}); traced {traced:.2f} ms, "
            f"device busy {rec[name]['device_busy_ms']:.2f} ms, "
            f"{rec[name]['device_launches_traced']} device launches; stacked "
            f"bank {stacked / 1e9:.3f} GB, peak {peak / 1e9:.3f} GB "
            f"({rec[name]['peak_over_stacked_bank']:+.1%} over the stacked "
            f"bank, {(peak - before) / 1e6:.1f} MB above the state)")
        if peak - before > 0.1 * stacked:
            log(f"[sampled bank] {name}: stepping took more than 10 % of the "
                f"stacked bank above the state")
        del holder, bank, samp
        torch.cuda.empty_cache()

    # save, restore onto the card, one more round: bit for bit
    samp = SampledHotaSim(sim.model, fl, sim.tcfg, n_cls, SAMPLE_CKPT_POP,
                          device=dev)
    bank = ScenarioBank(samp, specs)
    states, _ = bank.step(bank.init(rng.PRNGKey(0)), *batches[0], keys[0])
    x_r, y_r = batcher.next_stacked()
    k_r = rng.PRNGKey(90)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        path = bank.save(d, 3, states)
        save_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(path, f))
                     for f in os.listdir(path))
        t0 = time.perf_counter()
        restored = bank.restore(d, 3)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    if not all(torch.equal(u, v) for u, v in _state_pairs(restored, states)):
        fail("sampled bank restore: the restored state differs")
    a, ma = bank.step(states, x_r, y_r, k_r)
    b, mb = bank.step(restored, x_r, y_r, k_r)
    same = (all(torch.equal(u, v) for u, v in _state_pairs(a, b))
            and all(torch.equal(ma[k], mb[k]) for k in ma))
    if not same:
        fail("sampled bank restore: the round after the restore differs")
    rec["checkpoint"] = {"population_per_slot": SAMPLE_CKPT_POP,
                         "save_s": save_s, "restore_s": restore_s,
                         "bytes": nbytes, "continues_bit_for_bit": same}
    log(f"[sampled bank] checkpoint at M={SAMPLE_CKPT_POP}: saved "
        f"{nbytes / 1e6:.1f} MB in {save_s:.3f} s, restored in "
        f"{restore_s:.3f} s; the next round equal bit for bit")
    record["sampled_bank"] = rec
    del a, b, states, restored, bank, samp
    torch.cuda.empty_cache()
    return total


def _dist_sched_rank(mesh, runs):
    """One rank of phases 27-28: ``DIST_STEPS`` counted steps of each
    (name, FLConfig overrides, count mode) run, its metrics, state and
    peak memory."""
    import dataclasses
    import torch
    from repro_torch import rng
    from repro_torch.common.tree import tree_leaves
    from repro_torch.core.hota_step import make_hota_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.device
    if dev.type == "cpu":
        torch.set_num_threads(CPU_RANK_THREADS)
    model, fl0, tcfg, x, y, keys = _dist_setup(mesh)
    counters = _dist_counters()
    out = {}
    for name, kw, mode in runs:
        init_fn, step_fn, _, _ = make_hota_train_step(
            model, mesh, dataclasses.replace(fl0, **kw), tcfg,
            loss_kind="cls", n_out=DIST_CLASSES, count_mode=mode)
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
               "mu": [l.cpu() for l in tree_leaves(st.opt.mu)],
               "p": st.p.cpu()}
        if dev.type == "cuda":
            rec["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        out[name] = rec
    return out


PERLEAF_RUNS = tuple((f"perleaf_{m}", dict(use_pallas_ota=False,
                                           ota_mode=m), None)
                     for m in PERLEAF_MODES)
SECTIONED_RUNS = tuple(
    (f"{kind}_{mode}_rows{rows}", dict(ota_sectioned=kind == "sectioned",
                                       max_section_rows=rows), mode)
    for mode in ("local", "psum") for rows in (0, SPLIT_SECTION_ROWS)
    for kind in ("slab", "sectioned"))


def dist_perleaf_phase(dev, record):
    """Phase 27: the per-leaf distributed step on four ranks sharing the
    card, "scatter" and "naive", against four CPU ranks, with no kernel
    of the slab path and no plain draw; then ``experiments.dist_bench``'s
    rows. Returns the counted launches over the ranks."""
    import torch
    from repro_torch.experiments.dist_bench import dist_rows
    from repro_torch.launch.mesh import run_ranks
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gpu = run_ranks(_dist_sched_rank, (PERLEAF_RUNS,),
                    shape=DIST_SHAPE, device="cuda", timeout_s=600)
    gpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = run_ranks(_dist_sched_rank, (PERLEAF_RUNS,),
                    shape=DIST_SHAPE, device="cpu", timeout_s=600)
    cpu_s = time.perf_counter() - t0
    rec = {"card_run_s": gpu_s, "cpu_run_s": cpu_s}
    total = {}
    for name, _, _ in PERLEAF_RUNS:
        for r, res in enumerate(gpu):
            got = dict(res[name]["launches"])
            draws = take_draws(f"per-leaf dist {name} rank {r}", got)
            if any(got.values()):
                fail(f"per-leaf dist {name} rank {r}: kernel launches {got}, "
                     f"expected none (gains and AWGN come from the stream "
                     f"kernel)")
            for k, v in got.items():
                total[k] = total.get(k, 0) + v
            for s in range(DIST_STEPS):
                for k in ("loss", "p_mean", "p_min", "p_max", "gnorm_mean",
                          "fgrad"):
                    g_v = res[name]["metrics"][s][k]
                    c_v = cpu[r][name]["metrics"][s][k]
                    if not math.isfinite(g_v) or abs(g_v - c_v) > \
                            1e-4 * abs(c_v) + 1e-7:
                        fail(f"per-leaf dist {name} rank {r} step {s} {k}: "
                             f"card {g_v} vs CPU {c_v}")
        cmp = {"omega_rel_l2": rel_l2(
            torch.cat([l.reshape(-1) for res in gpu
                       for l in res[name]["omega"]]),
            torch.cat([l.reshape(-1) for res in cpu
                       for l in res[name]["omega"]])),
            "mu_rel_l2": rel_l2(
                torch.cat([l.reshape(-1) for res in gpu
                           for l in res[name]["mu"]]),
                torch.cat([l.reshape(-1) for res in cpu
                           for l in res[name]["mu"]]))}
        if cmp["omega_rel_l2"] > 1e-3:
            fail(f"per-leaf dist {name}: card vs CPU {cmp}")
        rec[name] = {"card_vs_cpu": cmp,
                     "draws_per_rank_per_step": {
                         k: v / DIST_STEPS for k, v in draws.items()},
                     "peak_bytes_per_rank": [res[name]["peak_bytes"]
                                             for res in gpu]}
        log(f"[dist per-leaf] {name}: {DIST_STEPS} steps on {len(gpu)} ranks, "
            f"draws per rank per step {rec[name]['draws_per_rank_per_step']}"
            f", no kernel of the slab path, 0 plain draws; card vs CPU {cmp};"
            f" peak bytes per rank {rec[name]['peak_bytes_per_rank']}")
    rows = dist_rows(device=dev, steps=DIST_BENCH_STEPS)
    rec["dist_bench"] = rows
    for row in rows:
        log(f"[dist bench] {row['name']}: median "
            f"{row['step_ms_median']:.2f} ms (all "
            f"{['%.2f' % t for t in row['step_ms']]}); a split step "
            f"{row['split_step_ms']:.2f} ms: collectives "
            f"{row['collective_ms']:.2f} ms in {row['collective_calls']} "
            f"calls ({row['collective_bytes'] / 1e6:.1f} MB), draws "
            f"{row['draw_ms']:.2f} ms in {row['draw_calls']}, the rest "
            f"{row['rest_ms']:.2f} ms; peak bytes per rank "
            f"{row['peak_bytes_per_rank']}")
    log(f"[dist per-leaf] card ranks {gpu_s:.1f} s, CPU ranks {cpu_s:.1f} s")
    record["dist_perleaf"] = rec
    return total


def dist_sectioned_phase(dev, record):
    """Phase 28: the sectioned distributed step at ``max_section_rows`` 0
    and ``SPLIT_SECTION_ROWS``, both count modes, bit for bit against the
    full-slab step of the same layout on the card, with the same K6/K5
    launches; the peak memory per rank of each. Returns the counted
    launches over the ranks."""
    import torch
    from repro_torch.launch.mesh import run_ranks
    torch.cuda.empty_cache()
    gpu = run_ranks(_dist_sched_rank, (SECTIONED_RUNS,),
                    shape=DIST_SHAPE, device="cuda", timeout_s=600)
    per = {"local": "ota_mask_count", "psum": "ota_mask_weight"}
    rec, total = {}, {}
    for name, kw, mode in SECTIONED_RUNS:
        for r, res in enumerate(gpu):
            got = dict(res[name]["launches"])
            take_draws(f"sectioned dist {name} rank {r}", got)
            want = {k: 0 for k in got}
            want[per[mode]] = DIST_LEAVES * DIST_STEPS
            if got != want:
                fail(f"dist {name} rank {r}: launches {got}, expected {want}")
            for k, v in got.items():
                total[k] = total.get(k, 0) + v
        rec[name] = {"peak_bytes_per_rank": [res[name]["peak_bytes"]
                                             for res in gpu]}
    for mode in ("local", "psum"):
        for rows in (0, SPLIT_SECTION_ROWS):
            full, sec = f"slab_{mode}_rows{rows}", f"sectioned_{mode}_rows{rows}"
            for r, res in enumerate(gpu):
                a, b = res[full], res[sec]
                if a["metrics"] != b["metrics"] or not all(
                        torch.equal(u, v) for u, v in zip(
                            a["omega"] + a["mu"], b["omega"] + b["mu"])):
                    fail(f"dist rank {r}: {sec} differs from {full}")
            log(f"[dist sectioned] {sec} == {full} bit for bit on every "
                f"rank; peak bytes per rank {rec[sec]['peak_bytes_per_rank']}"
                f" (full slab {rec[full]['peak_bytes_per_rank']})")
    record["dist_sectioned"] = rec
    return total


# --------------------------------------------------------------------------
# phases 29-31: LM training: the pieces, the distributed LM step at full
# size, the training launcher
# --------------------------------------------------------------------------

def _close_scaled(name, got, want, rtol) -> float:
    """Elementwise rtol with an atol of rtol times the largest entry (the
    two devices sum in other orders); the max abs error."""
    import torch
    got, want = got.float().cpu(), want.float().cpu()
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite values on the card")
    err = (got - want).abs()
    lim = rtol * want.abs() + rtol * float(want.abs().max())
    if bool((err > lim).any()):
        fail(f"{name}: {int((err > lim).sum())} entries outside rtol {rtol};"
             f" max abs err {float(err.max()):.3e}")
    return float(err.max())


def _attention_case(dev, name, impl, shape, window, blocks, record):
    """Training attention forward and backward on the card against the
    CPU (float32, rtol ``LM_RTOL`` scaled as ``_close_scaled``)."""
    import torch
    from repro_torch.models import layers as L
    b, s, h, kv, d = shape
    gen = torch.Generator().manual_seed(sum(shape) + (window or 0))
    q, k, v, ct = (torch.randn(sz, generator=gen) for sz in (
        (b, s, h, d), (b, s, kv, d), (b, s, kv, d), (b, s, h, d)))

    def run(device):
        ts = [t.detach().to(device).requires_grad_(True) for t in (q, k, v)]
        pos = torch.arange(s, device=device)
        out = L.attention(*ts, pos_q=pos, pos_kv=pos, impl=impl,
                          window=window, block_q=blocks[0],
                          block_kv=blocks[1])
        (out * ct.to(device)).sum().backward()
        return [out.detach()] + [t.grad for t in ts]
    got, want = run(dev), run("cpu")
    errs = [_close_scaled(f"{name} {part}", g, w, LM_RTOL)
            for part, g, w in zip(("out", "dq", "dk", "dv"), got, want)]
    ms = host_ms(lambda: run(dev))
    record[name] = {"shape": list(shape), "window": window,
                    "blocks": list(blocks), "max_abs_err": max(errs),
                    "fwd_bwd_ms": ms}
    log(f"[lm attention] {name} {impl} B,S,H,KV,D={shape} window {window} "
        f"blocks {blocks}: card vs CPU max abs err {max(errs):.3e} (out, dq,"
        f" dk, dv finite); forward + backward {ms:.2f} ms")


def lm_pieces_phase(dev, record):
    """Phase 29: the training pieces on the card at ``lm-100m``'s width,
    each against the CPU, TF32 off."""
    import torch
    from repro_torch import configs, rng
    from repro_torch.core.hota_step import LOSS_CHUNK, chunked_lm_loss
    from repro_torch.data.lm import synthetic_lm_batches
    from repro_torch.experiments.train_lm_federated import LM_100M
    from repro_torch.models.model import build_model
    from repro_torch.models.params import init_params
    rec = {}
    cfg = LM_100M
    shape = (LM_BATCH, LM_SEQ, cfg.n_heads, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    blocks = (cfg.attn_block_q, cfg.attn_block_kv)
    _attention_case(dev, "blocked", "blocked", shape, None, blocks, rec)
    _attention_case(dev, "folded", "folded", shape, None, blocks, rec)
    sc2 = configs.get_smoke_config("starcoder2_3b")
    # window 32 in blocks of 16: the band's first key block is masked whole
    # for the last half of each query block
    _attention_case(dev, "blocked_sc2_window", "blocked",
                    (LM_BATCH, LM_SEQ, sc2.n_heads, sc2.n_kv_heads,
                     sc2.resolved_head_dim), sc2.sliding_window,
                    (sc2.attn_block_q, sc2.attn_block_kv), rec)

    # chunked_lm_loss: one piece at S = 128, two recomputed chunks at 1024
    gen = torch.Generator().manual_seed(29)
    w = torch.randn((cfg.d_model, cfg.vocab_size), generator=gen) \
        / math.sqrt(cfg.d_model)
    model = build_model(cfg)
    for b, s in ((LM_BATCH, LM_SEQ), (1, 2 * LOSS_CHUNK)):
        feats = torch.randn((b, s, cfg.d_model), generator=gen)
        labels = torch.randint(0, cfg.vocab_size, (b, s), generator=gen)

        def run(device):
            hd = {"w": w.detach().to(device).requires_grad_(True)}
            f = feats.detach().to(device).requires_grad_(True)
            loss = chunked_lm_loss(hd, model.head_apply, f,
                                   labels.to(device))
            loss.backward()
            return loss.detach().cpu(), hd["w"].grad.cpu(), f.grad.cpu()
        got, want = run(dev), run("cpu")
        if abs(float(got[0]) - float(want[0])) > LM_RTOL * abs(
                float(want[0])):
            fail(f"chunked_lm_loss S={s}: card {float(got[0])} vs CPU "
                 f"{float(want[0])}")
        errs = [rel_l2(g, w_) for g, w_ in zip(got[1:], want[1:])]
        if max(errs) > 1e-4 or not all(torch.isfinite(g).all()
                                       for g in got[1:]):
            fail(f"chunked_lm_loss S={s}: gradients card vs CPU relative L2 "
                 f"{errs}")
        rec[f"chunked_lm_loss_S{s}"] = {"loss": float(got[0]),
                                        "loss_cpu": float(want[0]),
                                        "grad_rel_l2": errs}
        log(f"[lm loss] chunked_lm_loss B={b} S={s} "
            f"({'chunks of %d' % LOSS_CHUNK if s > LOSS_CHUNK else 'whole'}"
            f"): card {float(got[0]):.6f} vs CPU {float(want[0]):.6f}; "
            f"gradient relative L2 (head, feats) {errs}")

    moe_train_cases(dev, rec)

    # one lm-100m train-mode forward and backward, no FL
    keys = rng.split(rng.PRNGKey(29), 3)
    backbone = {"trunk": init_params(model.trunk_specs(), keys[0],
                                     device=dev),
                "final": init_params(model.final_specs(), keys[1],
                                     device=dev)}
    head = init_params(model.head_specs(), keys[2], device=dev)
    toks, labs = next(synthetic_lm_batches(cfg.vocab_size, LM_BATCH,
                                           LM_SEQ, seed=29))

    def fwd_bwd(device):
        loss, _, grads = train_fwd_bwd(model, backbone, head, toks, labs,
                                       device)
        return loss, grads
    loss_g, grads_g = fwd_bwd(dev)
    card_ms = host_ms(lambda: fwd_bwd(dev))
    loss_c, grads_c = fwd_bwd("cpu")
    g_g = torch.cat([g.reshape(-1).cpu() for g in grads_g])
    g_c = torch.cat([g.reshape(-1) for g in grads_c])
    err = rel_l2(g_g, g_c)
    if abs(loss_g - loss_c) > LM_RTOL * abs(loss_c) or err > 1e-3 \
            or not bool(torch.isfinite(g_g).all()):
        fail(f"lm-100m train forward/backward: loss card {loss_g} vs CPU "
             f"{loss_c}, gradient relative L2 {err:.3e}")
    rec["lm100m_fwd_bwd"] = {"loss": loss_g, "loss_cpu": loss_c,
                             "grad_rel_l2": err, "card_ms": card_ms}
    log(f"[lm train] lm-100m (12 layers, d_model 640, vocab 32000) B="
        f"{LM_BATCH} S={LM_SEQ} train-mode forward + backward: loss card "
        f"{loss_g:.6f} vs CPU {loss_c:.6f}, gradient relative L2 "
        f"{err:.3e} over {g_g.numel()} entries; {card_ms:.2f} ms on the card")
    record["lm_pieces"] = rec


def train_fwd_bwd(model, backbone, head, toks, labs, device):
    """One train-mode forward and backward of ``lm_loss + aux`` on
    ``device`` from copies of the weights: (loss, aux, the gradient of
    every backbone and head leaf)."""
    import torch
    from repro_torch.common.tree import tree_leaves, tree_unflatten
    from repro_torch.models.model import lm_loss
    leaves = [t.detach().to(device).requires_grad_(True)
              for t in tree_leaves(backbone) + tree_leaves(head)]
    n_bb = len(tree_leaves(backbone))
    bb = tree_unflatten(backbone, leaves[:n_bb])
    hd = tree_unflatten(head, leaves[n_bb:])
    logits, aux, _ = model.forward_logits(
        bb, hd, torch.from_numpy(toks).long().to(device), mode="train")
    loss = lm_loss(logits, torch.from_numpy(labs).to(device)) + aux
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), float(aux.detach()), grads


def moe_train_cases(dev, rec):
    """Phase 29, the MoE layer: Mixtral-8x22B's smoke config (4 experts
    top-2, 2 layers, d_model 96) in train mode, B=4 S=128 (one group of
    128), forward and backward on the card against the CPU, float32:
    loss and aux rtol ``LM_RTOL``, the whole gradient relative L2 1e-4;
    at capacity factor 1.25 (the config's) and 0.1, where each expert
    keeps 7 of a group's 256 routed slots."""
    import dataclasses

    import torch
    from repro_torch import configs, rng
    from repro_torch.data.lm import synthetic_lm_batches
    from repro_torch.models.model import build_model
    from repro_torch.models.moe import capacity
    from repro_torch.models.params import init_params
    base = configs.get_smoke_config("mixtral_8x22b")
    for cf in (base.moe.capacity_factor, 0.1):
        cfg = base.replace(moe=dataclasses.replace(base.moe,
                                                   capacity_factor=cf))
        model = build_model(cfg)
        keys = rng.split(rng.PRNGKey(29), 3)
        backbone = {"trunk": init_params(model.trunk_specs(), keys[0]),
                    "final": init_params(model.final_specs(), keys[1])}
        head = init_params(model.head_specs(), keys[2])
        toks, labs = next(synthetic_lm_batches(cfg.vocab_size, LM_BATCH,
                                               LM_SEQ, seed=29))
        loss_g, aux_g, grads_g = train_fwd_bwd(model, backbone, head, toks,
                                               labs, dev)
        loss_c, aux_c, grads_c = train_fwd_bwd(model, backbone, head, toks,
                                               labs, "cpu")
        g_g = torch.cat([g.reshape(-1).cpu() for g in grads_g])
        g_c = torch.cat([g.reshape(-1) for g in grads_c])
        err = rel_l2(g_g, g_c)
        name = f"mixtral_smoke_train_cf{cf:g}"
        if (abs(loss_g - loss_c) > LM_RTOL * abs(loss_c)
                or abs(aux_g - aux_c) > LM_RTOL * abs(aux_c) or err > 1e-4
                or not bool(torch.isfinite(g_g).all())):
            fail(f"{name}: loss card {loss_g} vs CPU {loss_c}, aux {aux_g} "
                 f"vs {aux_c}, gradient relative L2 {err:.3e}")
        cap = capacity(cfg.moe.top_k, LM_SEQ, cfg.moe.n_experts, cf)
        rec[name] = {"loss": loss_g, "loss_cpu": loss_c, "aux": aux_g,
                     "aux_cpu": aux_c, "grad_rel_l2": err, "capacity": cap}
        log(f"[lm train] {name}: capacity {cap} tokens per expert per "
            f"group of {LM_SEQ} ({cfg.moe.n_experts} x {cap} expert slots "
            f"for {cfg.moe.top_k * LM_SEQ} routed tokens); loss "
            f"card {loss_g:.6f} vs CPU {loss_c:.6f}, aux {aux_g:.6e} vs "
            f"{aux_c:.6e}, gradient relative L2 {err:.3e} over "
            f"{g_g.numel()} entries")


def _lm_setup(mesh, n_layers):
    """``lm-100m`` (cut to ``n_layers`` when given), its FL config, and
    the client streams' batches for this rank."""
    from repro_torch.common.config import FLConfig, TrainConfig
    from repro_torch.experiments.train_lm_federated import (
        FL, LM_100M, LR, client_streams, next_batch,
    )
    from repro_torch.models.model import build_model
    cfg = LM_100M if n_layers is None else LM_100M.replace(
        n_layers=n_layers)
    streams = client_streams(cfg, LM_BATCH, LM_SEQ)
    me = mesh.axis_index(("cluster", "client"))
    rows = slice(me * LM_BATCH, (me + 1) * LM_BATCH)
    batches = [tuple(x[rows] for x in next_batch(streams))
               for _ in range(LM_WARMUP + LM_STEPS)]
    return build_model(cfg), FLConfig(**FL), TrainConfig(lr=LR), batches


def _lm_dist_rank(mesh, plans, init_states=None):
    """One rank of phase 30: for each (depth cut, runs) plan, each run's
    steps (``(name, FLConfig overrides, count mode, warm-up steps, counted
    steps)``), counted and timed barrier to barrier; the count modes held
    bit for bit in the rank; the peak memory; one "local" step split by
    ``MeshStats``. ``init_states`` (the card ranks' initial states of the
    cut) start the CPU ranks where the card's started."""
    import dataclasses
    import torch
    from repro_torch import rng
    from repro_torch.common.tree import tree_leaves
    from repro_torch.core.hota_step import make_hota_train_step
    from repro_torch.experiments.train_lm_federated import (
        ROUND_KEY, SEED_KEY,
    )
    from repro_torch.sharding.collectives import MeshStats
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.device
    if dev.type == "cpu":
        torch.set_num_threads(CPU_RANK_THREADS)
    counters = _dist_counters()
    key = rng.PRNGKey(ROUND_KEY)
    out = {"device": str(dev)}
    for n_layers, runs in plans:
        model, fl0, tcfg, batches = _lm_setup(mesh, n_layers)
        kept = {}
        for name, kw, mode, warm, steps in runs:
            init_fn, step_fn, _, _ = make_hota_train_step(
                model, mesh, dataclasses.replace(fl0, **kw), tcfg,
                loss_kind="lm", count_mode=mode)
            if init_states is not None:
                st = to_device_state(init_states[mesh.rank], dev)
            else:
                st = init_fn(rng.PRNGKey(SEED_KEY))
            rec = {}
            if n_layers is not None and init_states is None:
                rec["init"] = to_cpu(st)
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            metrics, times = [], []
            for s, (toks, labs) in enumerate(batches[:warm + steps]):
                if s == warm:
                    _sync(mesh)
                    for ctr in counters:
                        ctr.reset()
                _sync(mesh)
                t0 = time.perf_counter()
                st, m = step_fn(st, toks, labs, key)
                _sync(mesh)
                if s >= warm:
                    times.append((time.perf_counter() - t0) * 1e3)
                metrics.append({k: float(v) for k, v in m.items()})
            rec.update(launches={ctr.name: ctr.count for ctr in counters},
                       metrics=metrics, step_ms=times,
                       p=float(st.p[0]))
            if dev.type == "cuda":
                rec["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
            if n_layers is not None:
                rec["omega"] = [l.cpu() for l in tree_leaves(st.omega)]
            if name in ("local", "psum"):
                kept[name] = (metrics, [t.clone() for t in tree_leaves(
                    st.omega) + [st.opt.mu]])
            if name == "local":
                mesh.stats = MeshStats()
                _sync(mesh)
                t0 = time.perf_counter()
                step_fn(st, *batches[0], key)
                _sync(mesh)
                rec["stats_step_ms"] = (time.perf_counter() - t0) * 1e3
                rec["stats"] = {"seconds": mesh.stats.seconds,
                                "calls": mesh.stats.calls,
                                "bytes": mesh.stats.bytes}
                mesh.stats = None
            out[name] = rec
            del st
        if len(kept) == 2:
            (ma, la), (mb, lb) = kept["local"], kept["psum"]
            out["modes_equal"] = ma == mb and all(
                torch.equal(a, b) for a, b in zip(la, lb))
        del kept
    return out


def to_device_state(state, dev):
    """A copy of a state (tensors, dicts, named tuples) on ``dev``."""
    if state is None:
        return None
    if isinstance(state, dict):
        return {k: to_device_state(v, dev) for k, v in state.items()}
    if isinstance(state, tuple):
        return type(state)(*[to_device_state(v, dev) for v in state])
    return state.to(dev)


LM_RUNS = (("local", {}, "local", LM_WARMUP, LM_STEPS),
           ("psum", {}, "psum", LM_WARMUP, LM_STEPS),
           ("mb2", {"microbatches": 2}, "local", 0, 1),
           ("perleaf", {"use_pallas_ota": False, "ota_mode": "scatter"},
            None, 0, 1))
LM_CUT_RUNS = (("cut", {}, None, 0, 1),)


def lm_dist_phase(dev, record):
    """Phase 30: ``lm-100m`` at full depth and width on four ranks sharing
    the card (2 clusters × 2 clients), the example's FL settings: each
    count mode 1 warm-up and ``LM_STEPS`` counted steps, a 2-microbatch
    step, a per-leaf step, and a ``LM_CUT``-layer cut's step against four
    CPU ranks. Returns the counted launches over the ranks."""
    import torch
    from repro_torch.launch.mesh import run_ranks
    torch.cuda.empty_cache()
    world = DIST_SHAPE[0] * DIST_SHAPE[1]
    t0 = time.perf_counter()
    gpu = run_ranks(_lm_dist_rank, ([(None, LM_RUNS), (LM_CUT,
                                                        LM_CUT_RUNS)],),
                    shape=DIST_SHAPE, device="cuda", timeout_s=900)
    gpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = run_ranks(_lm_dist_rank, ([(LM_CUT, LM_CUT_RUNS)],
                                    [res["cut"]["init"] for res in gpu]),
                    shape=DIST_SHAPE, device="cpu", timeout_s=900)
    cpu_s = time.perf_counter() - t0
    rec = {"card_run_s": gpu_s, "cpu_run_s": cpu_s,
           "tokens_per_step": world * LM_BATCH * LM_SEQ}
    per = {"local": "ota_mask_count", "psum": "ota_mask_weight"}
    total = {}
    for name, kw, mode, warm, steps in LM_RUNS + LM_CUT_RUNS:
        for r, res in enumerate(gpu):
            got = dict(res[name]["launches"])
            draws = take_draws(f"lm dist {name} rank {r}", got)
            want = {k: 0 for k in got}
            if name != "perleaf":     # one launch per leaf per microbatch
                want[per[mode or "local"]] = LM_LEAVES * steps * kw.get(
                    "microbatches", 1)
            if got != want:
                fail(f"lm dist {name} rank {r}: launches {got}, expected "
                     f"{want}")
            for k, v in got.items():
                total[k] = total.get(k, 0) + v
            ms = res[name]["metrics"]
            if not all(math.isfinite(v) for m in ms for v in m.values()):
                fail(f"lm dist {name} rank {r}: non-finite metrics {ms}")
            if abs(ms[-1]["p_mean"] * DIST_SHAPE[1] - DIST_SHAPE[1]) > 1e-3:
                fail(f"lm dist {name} rank {r}: p_mean·N = "
                     f"{ms[-1]['p_mean'] * DIST_SHAPE[1]}")
        g0 = gpu[0][name]
        rec[name] = {
            "launches_per_rank": {k: v for k, v in g0["launches"].items()
                                  if v},
            "draws_per_rank_per_step": {k: v / steps for k, v in
                                        draws.items()},
            "losses": [m["loss"] for m in g0["metrics"]],
            "step_ms": g0["step_ms"],
            "step_ms_median": statistics.median(g0["step_ms"]),
            "peak_bytes_per_rank": [res[name].get("peak_bytes") for res in gpu]}
        rec[name]["tokens_per_s"] = rec["tokens_per_step"] / (
            rec[name]["step_ms_median"] / 1e3)
        log(f"[lm dist {name}] {warm} warm-up + {steps} counted steps: "
            f"losses {['%.4f' % v for v in rec[name]['losses']]}; step "
            f"median {rec[name]['step_ms_median']:.2f} ms (all "
            f"{['%.2f' % t for t in g0['step_ms']]}), "
            f"{rec[name]['tokens_per_s']:.1f} tokens/s; launches per rank "
            f"{rec[name]['launches_per_rank']}, draws per rank per step "
            f"{rec[name]['draws_per_rank_per_step']}; peak bytes per rank "
            f"{rec[name]['peak_bytes_per_rank']}")
    for mode in ("local", "psum"):
        losses = rec[mode]["losses"]
        if not losses[-1] < losses[0]:
            fail(f"lm dist {mode}: the loss did not fall: {losses}")
    for r, res in enumerate(gpu):
        if not res["modes_equal"]:
            fail(f"lm dist rank {r}: the count modes differ")
    st = gpu[0]["local"]
    split = {k: st["stats"]["seconds"].get(k, 0.0) * 1e3
             for k in ("collective", "draw")}
    rec["split"] = {
        "step_ms": st["stats_step_ms"], "collective_ms": split["collective"],
        "draw_ms": split["draw"],
        "rest_ms": st["stats_step_ms"] - split["collective"]
        - split["draw"],
        "collective_calls": st["stats"]["calls"].get("collective", 0),
        "collective_bytes": st["stats"]["bytes"].get("collective", 0),
        "draw_calls": st["stats"]["calls"].get("draw", 0)}
    log(f"[lm dist split] a local step {st['stats_step_ms']:.2f} ms: "
        f"collectives {split['collective']:.2f} ms in "
        f"{rec['split']['collective_calls']} calls "
        f"({rec['split']['collective_bytes'] / 1e6:.1f} MB per rank), "
        f"stream draws {split['draw']:.2f} ms, the rest "
        f"{rec['split']['rest_ms']:.2f} ms")
    # the cut: card ranks against CPU ranks from the same initial state
    for r in range(world):
        for k in ("loss", "p_mean", "p_min", "p_max", "gnorm_mean"):
            g_v = gpu[r]["cut"]["metrics"][0][k]
            c_v = cpu[r]["cut"]["metrics"][0][k]
            if abs(g_v - c_v) > LM_RTOL * abs(c_v) + 1e-7:
                fail(f"lm dist cut rank {r} {k}: card {g_v} vs CPU {c_v}")
        if abs(gpu[r]["cut"]["p"] - cpu[r]["cut"]["p"]) > \
                LM_RTOL * abs(cpu[r]["cut"]["p"]):
            fail(f"lm dist cut rank {r}: p card {gpu[r]['cut']['p']} vs CPU "
                 f"{cpu[r]['cut']['p']}")
    w_rel = rel_l2(torch.cat([l.reshape(-1) for res in gpu
                              for l in res["cut"]["omega"]]),
                   torch.cat([l.reshape(-1) for res in cpu
                              for l in res["cut"]["omega"]]))
    if w_rel > 1e-3:
        fail(f"lm dist cut: ω card vs CPU relative L2 {w_rel:.3e}")
    rec["cut_card_vs_cpu"] = {"omega_rel_l2": w_rel, "loss": [
        gpu[0]["cut"]["metrics"][0]["loss"],
        cpu[0]["cut"]["metrics"][0]["loss"]]}
    log(f"[lm dist cut] {LM_CUT}-layer cut, one step: card vs CPU ranks "
        f"metrics within rtol {LM_RTOL}, ω relative L2 {w_rel:.3e}; card "
        f"ranks {gpu_s:.1f} s, CPU ranks {cpu_s:.1f} s (spawn and set-up "
        f"included)")
    record["lm_dist"] = rec
    return total


def lm_kernel_timing(dev, record):
    """K6 and K5 at ``lm-100m``'s 11 leaves, one rank's launches of one
    step ("local": K6 on each whole leaf with both clusters' words;
    "psum": K5 on each whole leaf): each launch equal to its plain
    version, and the step's launches timed beside their byte bound and
    their plain versions."""
    import torch
    from repro_torch.common.tree import tree_leaves
    from repro_torch.experiments.train_lm_federated import LM_100M
    from repro_torch.kernels.ota_channel import ops as kc
    from repro_torch.kernels.ota_channel.ref import (
        ota_mask_count_ref, ota_mask_weight_ref, pass_probability,
    )
    from repro_torch.models.model import build_model
    from repro_torch.models.params import abstract_params
    model = build_model(LM_100M)
    sizes = [l.numel() for l in tree_leaves(abstract_params(
        {"final": model.final_specs(), "trunk": model.trunk_specs()}))]
    c = DIST_SHAPE[0]
    gen = torch.Generator(device=dev).manual_seed(30)
    sig = torch.tensor([0.5, 2.0], device=dev)
    k6_p = kc.mask_count_params(sig, 0.032, 1.0, 0.37, 0, None, c,
                                device=dev)
    k6_pp = pass_probability(k6_p[:c], k6_p[c])
    k5_p = kc.mask_weight_params(sig[0], 0.032, 1.0, 0.37, device=dev)
    k5_pp = pass_probability(k5_p[0], k5_p[1]).reshape(1)
    k6_calls, k5_calls, err = [], [], 0.0
    for n in sizes:
        x = torch.randn(n, generator=gen, device=dev) * 1e-3
        bits = torch.randint(-2 ** 31, 2 ** 31, (c, n), generator=gen,
                             device=dev, dtype=torch.int64).to(torch.int32)
        o6, cn = torch.empty(n, device=dev), torch.empty(n, device=dev)
        kc.launch_mask_count(x, bits, k6_p, k6_pp, o6, cn)
        w6 = ota_mask_count_ref(x, bits, 0, sig, 0.032, 1.0, 0.37)
        o5, m5 = (torch.empty((1, n), device=dev) for _ in range(2))
        kc.launch_mask_weight(x.reshape(1, n), bits[:1], k5_p, k5_pp, o5, m5)
        w5 = ota_mask_weight_ref(x.reshape(1, n), bits[:1], sig[0], 0.032,
                                 1.0, 0.37)
        torch.cuda.synchronize()
        if not (torch.equal(o6, w6[0]) and torch.equal(cn, w6[1])
                and torch.equal(o5, w5[0]) and torch.equal(m5, w5[1])):
            fail(f"K6/K5 at an lm-100m leaf of {n} entries: not equal to "
                 f"the plain version")
        k6_calls.append((x, bits, k6_p, k6_pp, o6, cn))
        k5_calls.append((x.reshape(1, n), bits[:1], k5_p, k5_pp, o5, m5))
    n_all = sum(sizes)
    rec = {"leaves": len(sizes), "entries": n_all}
    for name, launch, calls, ref, nbytes in (
            ("k6", kc.launch_mask_count, k6_calls,
             lambda a: ota_mask_count_ref(a[0], a[1], 0, sig, 0.032, 1.0,
                                          0.37), (12 + 4 * c) * n_all),
            ("k5", kc.launch_mask_weight, k5_calls,
             lambda a: ota_mask_weight_ref(a[0], a[1], sig[0], 0.032, 1.0,
                                           0.37), 16 * n_all)):
        ms, queued, recorded = kernel_ms(
            [functools.partial(launch, *a) for a in calls], 10)
        plain = device_ms(lambda: [ref(a) for a in calls], 2)
        rec[name] = {"ms": ms, "queued_ms": queued, "recorded": recorded,
                     "plain_ms": plain,
                     "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
                     "bound_by": "bytes"}
        log(f"[{name.upper()} lm-100m] {len(sizes)} launches over {n_all} "
            f"entries (one rank's step): equal to the plain version; "
            f"{ms:.4f} ms (queued {queued:.4f}, records kept "
            f"{recorded:.0%}), plain {plain:.4f}, byte bound "
            f"{rec[name]['bound_ms']:.4f}")
    record["lm_kernels"] = rec
    del k6_calls, k5_calls
    torch.cuda.empty_cache()


def _launcher(args, env):
    """Run ``python -m repro_torch.launch.train`` with ``args``; its
    standard output, or a failure with its last lines."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train"] + args,
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        fail(f"launch.train {' '.join(args)} exited {proc.returncode}: "
             f"{(proc.stdout + proc.stderr)[-3000:]}")
    return proc.stdout


def _check_step_lines(out, steps, what):
    import re
    lines = re.findall(r"^step +(\d+) loss (\S+) p \[.*$", out, re.M)
    if [int(s) for s, _ in lines] != [0, steps - 1] or not all(
            math.isfinite(float(v)) for _, v in lines):
        fail(f"launch.train {what}: expected finite step lines 0 and "
             f"{steps - 1}, got: {out[-2000:]}")
    return [float(v) for _, v in lines]


def launcher_phase(dev, record):
    """Phase 31: ``python -m repro_torch.launch.train --arch starcoder2-3b
    --steps 3 --mesh 2,2,1`` in a subprocess, once with the layout tuner
    (its cache in a temporary directory) and once with ``--faults
    --ckpt-dir <tmp> --ckpt-every 1``; the printed lines, and the
    checkpoints restored (the full state and the final ω); then ``--arch
    zamba2-1.2b --steps 2 --mesh 2,2,1`` (the hybrid's smoke config) and
    its step lines."""
    import re
    import tempfile
    import torch
    from repro_torch import rng
    from repro_torch.checkpoint.store import (
        checkpoint_metadata, latest_step, restore_checkpoint,
    )
    from repro_torch.common.config import FLConfig, TrainConfig
    from repro_torch.common.tree import tree_leaves
    from repro_torch.core.hota_step import global_like, make_hota_step_parts
    from repro_torch.launch import train as launch_train
    from repro_torch.sharding.mesh_utils import Mesh
    rec = {}
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    base = ["--arch", "starcoder2-3b", "--steps", str(LAUNCH_STEPS),
            "--mesh", "2,2,1"]
    with tempfile.TemporaryDirectory() as tmp:
        cache = os.path.join(tmp, "layout_tune.json")
        t0 = time.perf_counter()
        out = _launcher(base + ["--layout-cache", cache], env)
        rec["tuned_s"] = time.perf_counter() - t0
        layout = re.findall(r"^layout: (\S+)$", out, re.M)
        if len(layout) != 1 or not os.path.isfile(cache):
            fail(f"launch.train with the tuner: no layout line or no cache "
                 f"file: {out[-2000:]}")
        rec["tuned"] = {"layout": layout[0],
                        "losses": _check_step_lines(out, LAUNCH_STEPS,
                                                    "tuned")}
        ckpt = os.path.join(tmp, "ckpt")
        t0 = time.perf_counter()
        out = _launcher(base + ["--layout-cache", cache, "--faults",
                                "--ckpt-dir", ckpt, "--ckpt-every", "1"],
                        env)
        rec["faults_s"] = time.perf_counter() - t0
        losses = _check_step_lines(out, LAUNCH_STEPS, "faults")
        if not re.search(r"^step +0 loss .* part 4 skip 0 ", out, re.M):
            fail(f"launch.train --faults: no participation in its lines: "
                 f"{out[-2000:]}")
        if latest_step(ckpt) != LAUNCH_STEPS or not re.search(
                r"^checkpoint: .*step_%08d$" % LAUNCH_STEPS, out, re.M):
            fail(f"launch.train --ckpt-dir: no final checkpoint: "
                 f"{out[-2000:]}")
        # the full state of step LAUNCH_STEPS - 1 and the final ω restore
        model = launch_train._model("starcoder2-3b")
        mesh = Mesh((2, 2, 1), launch_train.MESH_AXES)
        parts = make_hota_step_parts(
            model, mesh, FLConfig(n_clusters=2, n_clients=2, noise_std=0.1,
                                  faults=True), TrainConfig(),
            loss_kind="lm")
        like = global_like(parts.init_fn(rng.PRNGKey(0)), parts.state_specs,
                           mesh)
        full = restore_checkpoint(ckpt, LAUNCH_STEPS - 1, like)
        omega = restore_checkpoint(ckpt, LAUNCH_STEPS, like.omega)
        meta = (checkpoint_metadata(ckpt, LAUNCH_STEPS - 1),
                checkpoint_metadata(ckpt, LAUNCH_STEPS))
        if int(full.step) != LAUNCH_STEPS - 1 or meta[0].get("kind") != \
                "full_state" or not all(
                    bool(torch.isfinite(l).all())
                    for l in tree_leaves(omega) + tree_leaves(full.omega)):
            fail(f"launch.train checkpoints: step {int(full.step)}, "
                 f"metadata {meta}")
        rec["faults"] = {"losses": losses, "metadata": list(meta),
                         "restored_full_step": int(full.step)}
        # the hybrid family's smoke config: Mamba2 layers and the shared
        # block through the distributed LM step
        t0 = time.perf_counter()
        out = _launcher(["--arch", "zamba2-1.2b", "--steps",
                         str(HYBRID_LAUNCH_STEPS), "--mesh", "2,2,1",
                         "--layout-cache", cache], env)
        rec["zamba2_s"] = time.perf_counter() - t0
        rec["zamba2"] = {"losses": _check_step_lines(
            out, HYBRID_LAUNCH_STEPS, "zamba2-1.2b")}
    log(f"[launcher] launch.train --arch starcoder2-3b --steps "
        f"{LAUNCH_STEPS} --mesh 2,2,1: tuned layout {rec['tuned']['layout']}"
        f", losses {rec['tuned']['losses']} ({rec['tuned_s']:.1f} s); with "
        f"--faults --ckpt-every 1: losses {losses} ({rec['faults_s']:.1f} "
        f"s), full state of step {LAUNCH_STEPS - 1} and ω of step "
        f"{LAUNCH_STEPS} restored, metadata {list(meta)}; --arch zamba2-1.2b "
        f"--steps {HYBRID_LAUNCH_STEPS}: losses {rec['zamba2']['losses']} "
        f"({rec['zamba2_s']:.1f} s)")
    record["launcher"] = rec


# --------------------------------------------------------------------------
# phases 32-33: the scenario banks spread over ranks sharing the card
# --------------------------------------------------------------------------

def _mesh_sync(mesh):
    """Every rank of ``mesh`` synchronized and at a barrier of the mesh's
    own group (a mesh on the first ranks of a world leaves the others
    out)."""
    import torch
    import torch.distributed as dist
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    dist.barrier(group=mesh.group(mesh.axis_names)[0])


def _digests(states, n_rows):
    """Per row of a banked state, the sha256 of each leaf's bytes (bit for
    bit comparisons across processes without moving the states)."""
    import hashlib
    from repro_torch.checkpoint.store import flatten
    leaves = [t.detach().cpu().contiguous() for t in flatten(states)]
    return [[hashlib.sha256(t[s].numpy().tobytes()).hexdigest()
             for t in leaves] for s in range(n_rows)]


def _timed_rounds(mesh, step, state, inputs, traced: bool):
    """Bank rounds barrier to barrier on ``mesh`` (host ms each), and,
    when ``traced``, one more under the profiler: (state, times, {device
    busy ms, device launches, traced ms})."""
    import torch
    times = []
    for x, y, k in inputs:
        _mesh_sync(mesh)
        t0 = time.perf_counter()
        state = step(state, x, y, k)
        _mesh_sync(mesh)
        times.append((time.perf_counter() - t0) * 1e3)
    trace = None
    if traced:
        x, y, k = inputs[-1]
        _mesh_sync(mesh)
        with device_trace() as prof:
            t0 = time.perf_counter()
            state = step(state, x, y, k)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        ev = device_events(prof)
        trace = {"traced_ms": wall, "device_launches": sum(e.count
                                                           for e in ev),
                 "device_busy_ms": sum(e.self_device_time_total
                                       for e in ev) / 1e3}
        _mesh_sync(mesh)
    return state, times, trace


def _sharded_rank(meshes, fl, lr, n_cls, specs, batches, keys, timed,
                  extra, ckpt_dir):
    """One rank of phase 32: Fig. 4's bank split over each scenario mesh
    of ``meshes`` that holds this rank (``SHARDED_RANKS``: 4 ranks, then
    the first 2), on the client-folded and streaming engines: counted
    rounds, the rows' digests, timed and traced rounds and the peak
    memory; the 4-rank client-folded bank saves, the 2-rank one restores,
    and both run one more round."""
    import dataclasses
    import torch
    from repro_torch import rng
    from repro_torch.common.config import ModelConfig, TrainConfig
    from repro_torch.core.sim import HotaSim
    from repro_torch.core.sweep import ShardedScenarioBank
    from repro_torch.models.model import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    model = build_model(ModelConfig(family="mlp"))
    counters = _dist_counters()
    first, pair = meshes
    out = {"seconds": {}}
    for m in meshes:
        if m is None:
            continue
        rec = out[m.size] = {}
        out["seconds"][f"{m.size}_set_up"] = time.perf_counter() - t_start
        t_start = time.perf_counter()
        for name in ("client_folded", "streaming"):
            sim = HotaSim(model, dataclasses.replace(fl, **ENGINES[name]),
                          TrainConfig(lr=lr), n_cls, device=m.device)
            bank = ShardedScenarioBank(sim, specs, m)
            if m is pair and name == "client_folded":
                _mesh_sync(m)
                restored = bank.restore(ckpt_dir, BANK_ROUNDS)
                nxt, _ = bank.step(restored, *extra)
                out["restored_next"] = _digests(nxt, bank.n_local)
            st = bank.init(rng.PRNGKey(0))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(m.device)
            _mesh_sync(m)
            for ctr in counters:
                ctr.reset()
            st, hist = bank.run(st, batches, keys)
            _mesh_sync(m)
            r = {"launches": {ctr.name: ctr.count for ctr in counters},
                 "hist": {k: v.cpu() for k, v in hist.items()},
                 "rows": _digests(st, bank.n_local)}
            if m is first and name == "client_folded":
                bank.save(ckpt_dir, BANK_ROUNDS, st)
                nxt, _ = bank.step(st, *extra)
                out["saved_next"] = _digests(nxt, bank.n_local)
            t1 = time.perf_counter()
            _, r["round_ms"], r["trace"] = _timed_rounds(
                m, lambda s, x, y, k: bank.step(s, x, y, k)[0], st, timed,
                traced=True)
            r["peak_bytes"] = torch.cuda.max_memory_allocated(m.device)
            out["seconds"][f"{m.size}_{name}_counted"] = t1 - t_start
            out["seconds"][f"{m.size}_{name}_timed"] = time.perf_counter() - t1
            t_start = time.perf_counter()
            rec[name] = r
            del bank, st
            torch.cuda.empty_cache()
    return out


def _sharded_inputs(banks, batcher):
    """Phase 32's timed and extra rounds, and phase 9's one-process banks
    timed again on those rounds just before the ranks start (host speed
    drifts over a call): (timed, extra, {engine: median ms})."""
    from repro_torch import rng
    timed = [batcher.next_stacked() + (rng.PRNGKey(200 + r),)
             for r in range(TIMED_BANK_ROUNDS)]
    extra = batcher.next_stacked() + (rng.PRNGKey(300),)
    again = {}
    for name in ("client_folded", "streaming"):
        bank, st1 = banks[name][:2]
        again[name] = statistics.median(host_ms(
            lambda: bank.step(st1, x, y, k)) for x, y, k in timed)
    return timed, extra, again


def _check_sharded(res, sim, banks, record, n_leaves, again):
    """Phase 32's checks on its ranks' results: the counts, every scenario
    and every round's metrics against phase 9's one-process bank, the
    4-rank save restored into 2 ranks. Returns the counted launches,
    summed over the ranks."""
    import torch
    s_n = banks["client_folded"][0].n_scenarios
    c = sim.fl.n_clusters
    total, rec = {}, {"rank0_seconds": res[0]["seconds"]}
    for name in ("client_folded", "streaming"):
        _, st1, hist1, _ = banks[name]
        want_rows = _digests(st1, s_n)
        # phase 9's chunked draws per bank round: the round's streams once
        # (client-folded), or per scenario inside its step (streaming)
        draws1 = record["bank"][name]["draws_per_bank_round"][
            "threefry_chunked"] * BANK_ROUNDS
        for n_r in SHARDED_RANKS:
            s_loc = s_n // n_r
            ranks = [r[n_r][name] for r in res if n_r in r]
            per = s_loc * BANK_ROUNDS
            want = {k: 0 for k in ranks[0]["launches"]
                    if k not in DRAW_NAMES}
            want["masked_gradnorm"] = per
            if name == "streaming":
                want["ota_mask_weight"] = c * n_leaves * per
                want_draws = draws1 * s_loc // s_n
            else:
                want["ota_client_fold"] = n_leaves * per
                want_draws = draws1
            row = {"round_ms_per_rank": [], "peak_bytes_per_rank": [],
                   "traced_per_rank": []}
            for r, got in enumerate(ranks):
                launches = dict(got["launches"])
                draws = take_draws(f"sharded bank {name} on {n_r} ranks, "
                                   f"rank {r}", launches)
                if launches != want or draws["threefry_chunked"] \
                        != want_draws or draws["threefry_flat"]:
                    fail(f"sharded bank {name} on {n_r} ranks, rank {r}: "
                         f"launches {launches}, draws {draws}, expected "
                         f"{want} and {want_draws} chunked draws")
                for k, v in launches.items():
                    total[k] = total.get(k, 0) + v
                for k in hist1:
                    if not torch.equal(got["hist"][k], hist1[k].cpu()):
                        fail(f"sharded bank {name} on {n_r} ranks, rank "
                             f"{r}: metric {k} differs from the one-process "
                             f"bank's")
                if got["rows"] != want_rows[r * s_loc:(r + 1) * s_loc]:
                    fail(f"sharded bank {name} on {n_r} ranks, rank {r}: "
                         f"its scenarios' states differ from the "
                         f"one-process bank's")
                row["round_ms_per_rank"].append(got["round_ms"])
                row["peak_bytes_per_rank"].append(got["peak_bytes"])
                row["traced_per_rank"].append(got["trace"])
            row.update(launches_per_rank=ranks[0]["launches"],
                       chunked_draws_per_rank=want_draws,
                       round_ms_median=statistics.median(
                           ranks[0]["round_ms"]),
                       one_process_round_ms_median=record["bank"][name][
                           "round_ms_median"],
                       one_process_again_ms_median=again[name],
                       one_process_device_busy_ms=record["bank"][name][
                           "device_busy_ms"],
                       bits_equal=True)
            rec[f"{name}_{n_r}_ranks"] = row
            log(f"[sharded bank] {name} on {n_r} ranks sharing the card: "
                f"every scenario bit for bit the one-process bank's; "
                f"launches per rank {ranks[0]['launches']}; median bank "
                f"round {row['round_ms_median']:.2f} ms (one process "
                f"{row['one_process_round_ms_median']:.2f} in phase 9, "
                f"{again[name]:.2f} just before the ranks); traced per "
                f"rank {row['traced_per_rank']}; peak bytes per rank "
                f"{row['peak_bytes_per_rank']}")
    log(f"[sharded bank] rank 0's seconds: {res[0]['seconds']}")
    saved = [d for r in res for d in r["saved_next"]]
    restored = [d for r in res if "restored_next" in r
                for d in r["restored_next"]]
    if saved != restored:
        fail("sharded bank: the 2-rank restore of the 4-rank checkpoint "
             "continued differently")
    rec["checkpoint_4_to_2_bit_for_bit"] = True
    record["sharded_bank"] = rec
    return total


def _check_sweep_on_ranks(sim, dev, record):
    """Phase 32's last check: ``run_sweep(scenario_ranks=2)`` of
    ``SWEEP_ROUNDS`` rounds against the one-process sweep, both into a
    temporary directory (the results' wall time aside)."""
    import tempfile
    from repro_torch.experiments import paper_common
    from repro_torch.experiments.fig4_diverse_sigma import (
        experiments as fig4_experiments,
    )
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        kw = dict(steps=SWEEP_ROUNDS, n_clusters=sim.fl.n_clusters,
                  n_clients=sim.fl.n_clients, force=True, log_every=1,
                  tune=False, device=dev)
        one = paper_common.run_sweep(fig4_experiments(),
                                     results_dir=os.path.join(d, "one"),
                                     **kw)
        t1 = time.perf_counter()
        two = paper_common.run_sweep(fig4_experiments(),
                                     results_dir=os.path.join(d, "two"),
                                     scenario_ranks=2, **kw)
        t2 = time.perf_counter()
    for n in one:
        a, b = dict(one[n]), dict(two[n])
        a.pop("wall_s"), b.pop("wall_s")
        if a != b:
            fail(f"run_sweep(scenario_ranks=2): {n} differs from the "
                 f"one-process sweep")
    record["sharded_bank"]["run_sweep"] = {
        "rounds": SWEEP_ROUNDS, "equal": True, "one_process_s": t1 - t0,
        "two_ranks_s": t2 - t1}
    log(f"[sharded bank] 4-rank save, 2-rank restore, one more round: bit "
        f"for bit; run_sweep(scenario_ranks=2) of {SWEEP_ROUNDS} rounds "
        f"equal to the one-process sweep ({t2 - t1:.1f} s against "
        f"{t1 - t0:.1f} s, set-up included)")


def _dist_bank_rank(mesh, ckpt_dir):
    """One rank of phase 33: ``DistScenarioBank`` on the world's 2 rows
    and on its first row, counted, against each other and (on the first
    row) the 1-D step given each scenario's ``chan``; the fault bank; a
    2-row save restored into the row; timed and split steps; the peak
    memory and the cost of building a 3-axis mesh's groups."""
    import torch
    from repro_torch import rng
    from repro_torch.common.config import FLConfig
    from repro_torch.core.channel import channel_params
    from repro_torch.core.hota_step import make_hota_train_step
    from repro_torch.core.sweep import DistScenarioBank
    from repro_torch.launch.mesh import make_dist_scenario_mesh
    from repro_torch.sharding.collectives import MeshStats
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, _, tcfg, x, y, keys = _dist_setup(mesh)
    scenarios = DIST_BANK_SCENARIOS
    fl_kw = dict(n_clusters=DIST_SHAPE[0], n_clients=DIST_SHAPE[1])
    fl = FLConfig(**fl_kw)
    c, n = fl.n_clusters, fl.n_clients
    counters = _dist_counters()
    t0 = time.perf_counter()
    row = make_dist_scenario_mesh(c, n, 1, "cuda")
    out = {"prefix_mesh_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    make_dist_scenario_mesh(c, n, mesh.shape["scenario"], "cuda")
    out["world_mesh_s"] = time.perf_counter() - t0
    s_n = len(scenarios)
    states = {}
    for m in (mesh, row):
        if m is None:
            continue
        bank = DistScenarioBank(model, fl, tcfg, scenarios, m,
                                loss_kind="cls", n_out=DIST_CLASSES,
                                count_mode="local")
        st = bank.init(rng.PRNGKey(0))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(m.device)
        _mesh_sync(m)
        for ctr in counters:
            ctr.reset()
        ms = []
        for s in range(DIST_STEPS):
            st, mt = bank.step(st, x, y, keys[s])
            ms.append({k: v.cpu() for k, v in mt.items()})
        _mesh_sync(m)
        rec = {"launches": {ctr.name: ctr.count for ctr in counters},
               "metrics": ms}
        # every scenario's state on every rank (a collective of the mesh)
        rec["scenarios"] = [_digests(_one_row(
            bank.scenario_state(st, s)), 1)[0] for s in range(s_n)]
        if m is mesh:
            bank.save(ckpt_dir, DIST_STEPS, st)
        else:
            st_r = bank.restore(ckpt_dir, DIST_STEPS)
            rec["restored_equal"] = _digests(st_r, bank.n_local) == \
                _digests(st, bank.n_local)
        nxt, _ = bank.step(st if m is mesh else st_r, x, y,
                           keys[DIST_STEPS])
        rec["next"] = [_digests(_one_row(bank.scenario_state(nxt, s)),
                                1)[0] for s in range(s_n)]
        times = []
        for s in range(DIST_TIMED_STEPS):
            _mesh_sync(m)
            t0 = time.perf_counter()
            st, _ = bank.step(st, x, y, keys[DIST_STEPS + s])
            _mesh_sync(m)
            times.append((time.perf_counter() - t0) * 1e3)
        m.stats = MeshStats()
        _mesh_sync(m)
        t0 = time.perf_counter()
        st, _ = bank.step(st, x, y, keys[-1])
        _mesh_sync(m)
        rec["stats_step_ms"] = (time.perf_counter() - t0) * 1e3
        rec["stats"] = {"seconds": m.stats.seconds, "calls": m.stats.calls,
                        "bytes": m.stats.bytes}
        m.stats = None
        rec["step_ms"] = times
        rec["peak_bytes"] = torch.cuda.max_memory_allocated(m.device)
        out[m.shape["scenario"]] = rec
        del bank, st
    if row is not None:
        # the 1-D step (phase 19's) given each scenario's chan
        init_fn, step_fn, _, _ = make_hota_train_step(
            model, row, fl, tcfg, loss_kind="cls", n_out=DIST_CLASSES,
            count_mode="local")
        out["oracle"] = []
        for sc in scenarios:
            chan = channel_params(FLConfig(**dict(fl_kw, **sc)),
                                  device=row.device)
            so = init_fn(rng.PRNGKey(0))
            for s in range(DIST_STEPS):
                so, _ = step_fn(so, x, y, keys[s], chan)
            out["oracle"].append(_digests(_one_row(so), 1)[0])
    # the fault bank on the 2 rows
    fbank = DistScenarioBank(model, FLConfig(**dict(fl_kw, faults=True)),
                             tcfg, FAULT_BANK, mesh, loss_kind="cls",
                             n_out=DIST_CLASSES, count_mode="local")
    st0 = fbank.init(rng.PRNGKey(0))
    st = st0
    fm = []
    for s in range(FAULT_BANK_ROUNDS):
        st, mt = fbank.step(st, x, y, keys[s])
        fm.append({k: v.cpu() for k, v in mt.items()})
    out["faults"] = {"metrics": fm, "identity": [
        _digests(st._replace(step=st0.step), fbank.n_local)[i]
        == _digests(st0, fbank.n_local)[i] for i in range(fbank.n_local)]}
    return out


def _one_row(state):
    """An unbatched state with a leading axis of one row."""
    from repro_torch.common.tree import state_map
    return state_map(lambda t: t.unsqueeze(0), state)


def _check_dist(res, record):
    """Phase 33's checks on its ranks' results: the counts, 2 rows against
    1 row and the 1-D step, the 2-row checkpoint into the row, the fault
    bank; its timings beside phase 19's step. Returns the counted
    launches, summed over the ranks."""
    import torch
    rows = DIST_BANK_ROWS
    scenarios = DIST_BANK_SCENARIOS
    s_n = len(scenarios)
    per_row = DIST_SHAPE[0] * DIST_SHAPE[1]
    total, rec = {}, {"ranks": rows * per_row,
                      "prefix_mesh_s": res[0]["prefix_mesh_s"],
                      "world_mesh_s": res[0]["world_mesh_s"]}
    for n_rows in (rows, 1):
        ranks = [r[n_rows] for r in res if n_rows in r]
        s_loc = s_n // n_rows
        for r, got in enumerate(ranks):
            launches = dict(got["launches"])
            take_draws(f"dist bank on {n_rows} rows, rank {r}", launches)
            want = {k: 0 for k in launches}
            want["ota_mask_count"] = DIST_LEAVES * s_loc * DIST_STEPS
            if launches != want:
                fail(f"dist bank on {n_rows} rows, rank {r}: launches "
                     f"{launches}, expected {want}")
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            for mt in got["metrics"]:
                if not all(bool(torch.isfinite(v).all()) for v in mt.values()):
                    fail(f"dist bank on {n_rows} rows: non-finite metrics")
        g0 = ranks[0]
        st = {k: g0["stats"]["seconds"].get(k, 0.0) * 1e3
              for k in ("collective", "draw")}
        rec[f"{n_rows}_rows"] = {
            "launches_per_rank": g0["launches"],
            "step_ms": g0["step_ms"],
            "step_ms_median": statistics.median(g0["step_ms"]),
            "stats_step_ms": g0["stats_step_ms"],
            "collective_ms": st["collective"], "draw_ms": st["draw"],
            "collective_calls": g0["stats"]["calls"].get("collective", 0),
            "collective_bytes": g0["stats"]["bytes"].get("collective", 0),
            "rest_ms": g0["stats_step_ms"] - st["collective"] - st["draw"],
            "peak_bytes_per_rank": [g["peak_bytes"] for g in ranks]}
    # 2 rows against 1 row, and against the 1-D step, on the first row
    for r in range(per_row):
        two, one = res[r][rows], res[r][1]
        if two["scenarios"] != one["scenarios"] or any(
                not torch.equal(a[k], b[k]) for a, b in zip(
                    two["metrics"], one["metrics"]) for k in a):
            fail(f"dist bank rank {r}: 2 rows differ from 1 row")
        if one["scenarios"] != res[r]["oracle"]:
            fail(f"dist bank rank {r}: a scenario differs from the 1-D step "
                 f"given its chan")
        if not one["restored_equal"] or one["next"] != two["next"]:
            fail(f"dist bank rank {r}: the 1-row restore of the 2-row "
                 f"checkpoint continued differently")
    fm = res[0]["faults"]["metrics"][-1]
    skipped, n_part = fm["skipped"].tolist(), fm["n_participants"].tolist()
    # the blackout scenario (the last) on its row's ranks: the identity
    blk_row, blk_i = divmod(len(FAULT_BANK) - 1, len(FAULT_BANK) // rows)
    black = [r["faults"]["identity"][blk_i]
             for i, r in enumerate(res) if i // per_row == blk_row]
    if skipped[0] != 0.0 or skipped[-1] != 1.0 or n_part[0] != per_row \
            or n_part[-1] != 0.0 or not all(black):
        fail(f"dist fault bank: skipped {skipped}, participants {n_part}, "
             f"blackout identity on its row's ranks {black}")
    rec.update(faults={"skipped": skipped, "n_participants": n_part,
                       "blackout_identity": True},
               two_rows_equal_one_row=True, scenarios_equal_1d_step=True,
               checkpoint_2_to_1_bit_for_bit=True,
               phase19_step_ms_median=record["dist"]["local"][
                   "step_ms_median"],
               phase19_collective_calls=record["dist"]["local"][
                   "collective_calls"],
               phase19_collective_bytes=record["dist"]["local"][
                   "collective_bytes"])
    for n_rows in (rows, 1):
        r = rec[f"{n_rows}_rows"]
        log(f"[dist bank] {n_rows} row(s), {n_rows * per_row} ranks: launches "
            f"per rank {r['launches_per_rank']}; bank step median "
            f"{r['step_ms_median']:.2f} ms (all "
            f"{['%.2f' % t for t in r['step_ms']]}); a split step "
            f"{r['stats_step_ms']:.2f} ms: collectives "
            f"{r['collective_ms']:.2f} ms in {r['collective_calls']} calls "
            f"({r['collective_bytes'] / 1e6:.1f} MB per rank), draws "
            f"{r['draw_ms']:.2f}, the rest {r['rest_ms']:.2f}; peak bytes "
            f"per rank {r['peak_bytes_per_rank']}")
    log(f"[dist bank] 2 rows == 1 row and each scenario == the 1-D step, bit "
        f"for bit; 2-row save -> 1-row restore -> one step bit for bit; "
        f"fault bank skipped {skipped}, participants {n_part}, blackout the "
        f"identity; phase 19's step {rec['phase19_step_ms_median']:.2f} ms; "
        f"groups of the 3-axis mesh on {rows * per_row} ranks "
        f"{rec['world_mesh_s']:.2f} s (the 1-row prefix "
        f"{rec['prefix_mesh_s']:.2f} s)")
    record["dist_bank"] = rec
    return total




def _scenario_banks_rank(mesh, t_spawn, sharded_args, dist_ckpt):
    """One rank of phases 32-33's world (``DIST_BANK_ROWS`` x 2 x 2 ranks
    sharing the card): phase 32 on the world's first ``SHARDED_RANKS``
    ranks (every rank builds those meshes' groups), then phase 33 on all
    of it. Records the seconds from the call to this rank's start."""
    from repro_torch.launch.mesh import make_scenario_mesh
    out = {"spawn_s": time.time() - t_spawn}
    meshes = tuple(make_scenario_mesh(n, "cuda") for n in SHARDED_RANKS)
    t0 = time.perf_counter()
    if meshes[0] is not None:
        out["sharded"] = _sharded_rank(meshes, *sharded_args)
    out["sharded_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["dist"] = _dist_bank_rank(mesh, dist_ckpt)
    out["dist_s"] = time.perf_counter() - t0
    return out


def scenario_banks_phase(sim, banks, batches, keys, batcher, dev, record,
                         n_leaves):
    """Phases 32-33, in one world of ``DIST_BANK_ROWS`` x 2 x 2 ranks
    sharing ``cuda:0`` over gloo (one start for both).

    32: Fig. 4's S=4 bank of phase 9 as a ``ShardedScenarioBank`` on 4
    and on 2 scenario ranks, client-folded and streaming: counted rounds
    (per scenario round 10 K1 or 100 K5 and 1 K2, the round's stream
    draws once per rank, 0 plain draws), every scenario bit for bit phase
    9's one-process bank; the median bank round barrier to barrier beside
    phase 9's one-process median and the one-process bank timed again
    just before the ranks start, one traced round per rank and the peak
    memory per rank; a 4-rank save, a 2-rank restore and one more round,
    bit for bit; and ``run_sweep(scenario_ranks=2)`` against the
    one-process sweep.

    33: ``DistScenarioBank`` on phase 19's FL mesh (2 clusters x 2
    clients, 24 examples per client, the Table-I MLP): S=4 (σ² 0.5 and
    2.0 in every cluster, equal weighting, OTA off) on 2 scenario rows (8
    ranks) and on 1 row (the first 4). Counted steps (``DIST_LEAVES`` K6
    launches per scenario per rank per bank step, 0 plain draws), 2 rows
    bit for bit 1 row, each scenario bit for bit phase 19's step given its
    ``chan``, the fault bank (``skipped`` and ``n_participants``;
    blackout the identity), a 2-row save restored into the row and
    continued bit for bit, the median bank step and a ``MeshStats`` split
    beside phase 19's step, the peak memory per rank.

    Returns the counted launches of both, summed over the ranks."""
    import tempfile
    import torch
    from repro_torch.experiments.fig4_diverse_sigma import (
        experiments as fig4_experiments,
    )
    from repro_torch.launch.mesh import run_ranks
    timed, extra, again = _sharded_inputs(banks, batcher)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as ck32, \
            tempfile.TemporaryDirectory() as ck33:
        sharded_args = (sim.fl, sim.tcfg.lr, sim.n_classes.tolist(),
                        list(fig4_experiments().values()), batches, keys,
                        timed, extra, ck32)
        res = run_ranks(_scenario_banks_rank,
                        (time.time(), sharded_args, ck33),
                        shape=(DIST_BANK_ROWS,) + DIST_SHAPE,
                        axes=("scenario", "cluster", "client"),
                        device="cuda", timeout_s=900)
    world_s = time.perf_counter() - t0
    total = _check_sharded([r["sharded"] for r in res if "sharded" in r],
                           sim, banks, record, n_leaves, again)
    for k, v in _check_dist([r["dist"] for r in res], record).items():
        total[k] = total.get(k, 0) + v
    record["scenario_banks_world"] = {
        "world_s": world_s, "spawn_s": [r["spawn_s"] for r in res],
        "phase32_s": res[0]["sharded_s"], "phase33_s": res[0]["dist_s"]}
    log(f"[scenario banks] the world of {len(res)} ranks {world_s:.1f} s: "
        f"the call to each rank's start "
        f"{['%.1f' % r['spawn_s'] for r in res]} s, phase 32 {res[0]['sharded_s']:.1f} s and phase 33 "
        f"{res[0]['dist_s']:.1f} s on rank 0")
    _check_sweep_on_ranks(sim, dev, record)
    return total


# --------------------------------------------------------------------------
# phase 34: the MoE layer and the audio and vision stub frontends
# --------------------------------------------------------------------------

def k8_layer_case(dev, name, shape, gen, record):
    """K8 at one layer's shape (bf16, which ``kernel_for`` must send to
    the Hopper kernel) and the mma.sync design, each batch element against
    the plain version (``k8_compare``); its time (CUDA events over 5
    launches) beside its
    bound, the mma.sync design's (timed in turns with it: new, old, old,
    new, as phase 14 does at D = 128), the plain version's and SDPA's
    (with the window as a mask, or causal)."""
    import torch
    from repro_torch.kernels.flash_attention import ops as k8
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    b, s, h, kv, d, w = shape
    route = k8.kernel_for(torch.bfloat16, d)
    if route != "hopper":
        fail(f"{name}: D={d} takes K8's {route} kernel, not the Hopper one")
    q, k, v = (torch.randn((b, s, n, d), generator=gen, device=dev
                           ).to(torch.bfloat16) for n in (h, kv, kv))
    got = k8.flash_attention(q, k, v, window=w)
    torch.cuda.synchronize()

    def plain():
        return [flash_attention_ref(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                    window=w) for i in range(b)]
    checks, checks_mma_sync = {}, {}
    wants = plain()
    for i, want in enumerate(wants):
        k8_compare(f"{name} b{i}", got[i:i + 1], want, 2e-2, checks)
    out = torch.empty_like(q)
    k8.launch(q, k, v, out, w, kernel="mma_sync")
    torch.cuda.synchronize()
    for i, want in enumerate(wants):
        k8_compare(f"{name} mma_sync b{i}", out[i:i + 1], want, 2e-2,
                   checks_mma_sync)
    del wants, want
    torch.cuda.empty_cache()

    def new():
        k8.launch(q, k, v, out, w)

    def old():
        k8.launch(q, k, v, out, w, kernel="mma_sync")
    turns = [cuda_ms(new, 5, warmup=1), cuda_ms(old, 5, warmup=1),
             cuda_ms(old, 5, warmup=1), cuda_ms(new, 5, warmup=1)]
    ms, ms_mma_sync = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    plain_ms = cuda_ms(plain, 2, warmup=1)
    torch.cuda.empty_cache()
    bound, bound_by, flops, nbytes = k8_bound(b, s, h, kv, d, w, 2)
    try:
        lib = sdpa_ms(q, k, v, w, causal_only=w is None)
    except torch.cuda.OutOfMemoryError:
        lib = None
    rec = {"shape": list(shape), "kernel": route, "checks": checks,
           "max_abs_err": max(c["max_abs_err"] for c in checks.values()),
           "max_row_rel_l2": max(c["max_row_rel_l2"]
                                 for c in checks.values()),
           "ms": ms, "ms_mma_sync": ms_mma_sync,
           "checks_mma_sync": checks_mma_sync,
           "ms_turns_new_old_old_new": turns,
           "bound_ms": bound, "bound_by": bound_by,
           "bound_share": bound / ms, "flops": flops, "bytes": nbytes,
           "tflops_per_s": flops / ms / 1e9, "plain_ms": plain_ms,
           "sdpa_ms": lib,
           "sdpa_mask": "causal" if w is None else "window mask"}
    record[name] = rec
    del q, k, v, out, got
    torch.cuda.empty_cache()
    lib_txt = "out of memory" if lib is None else f"{lib:.4f}"
    log(f"[K8] {name} (B, S, H, KV, D, W) = {shape}, bf16, {route}: "
        f"max abs err {rec['max_abs_err']:.3e}, max row relative L2 "
        f"{rec['max_row_rel_l2']:.3e}; {ms:.4f} ms per launch "
        f"({rec['tflops_per_s']:.1f} TFLOP/s, {100 * bound / ms:.1f} % of "
        f"the bound {bound:.4f} ms, {bound_by}), the mma.sync design "
        f"{ms_mma_sync:.4f} (max abs err "
        f"{max(c['max_abs_err'] for c in checks_mma_sync.values()):.3e}; "
        f"turns new/old/old/new "
        f"{['%.4f' % t for t in turns]}), plain version {plain_ms:.4f}, "
        f"SDPA ({rec['sdpa_mask']}) {lib_txt}")
    return rec


def moe_layer_phase(dev, record):
    """Phase 34b: one full-width Mixtral-8x22B layer drawn on the card and
    copied to the host, float32 compute, B=1 S=64 prefill and 2 decode
    steps on the card against the CPU (the card fed the CPU's tokens)."""
    import torch
    from repro_torch.common.tree import tree_map
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_mod
    rec = {}
    cfg = get_config("mixtral_8x22b").replace(n_layers=1,
                                              compute_dtype="float32")
    model = serve_mod.serving_model(cfg)
    w_dev = serve_mod.init_weights(model, 0, dev)
    w_cpu = tuple(tree_map(lambda t: t.cpu(), w) for w in w_dev)
    prompt = serve_mod.draw_prompt(cfg, 1, MOE_CUT_SEQ, 0)
    rels = card_vs_cpu("mixtral_layer_f32", model, w_dev, w_cpu, prompt,
                       MOE_CUT_STEPS, CUT_F32_LIMIT, rec, dev)
    log(f"[moe] one full-width Mixtral-8x22B layer (8 experts of 6144 x "
        f"16384, top-2), B=1, S={MOE_CUT_SEQ}, float32: card vs CPU "
        f"relative L2 of the logits (prefill, then {MOE_CUT_STEPS} decode "
        f"steps) {['%.3e' % r for r in rels]} (limit {CUT_F32_LIMIT:g}); "
        f"CPU {rec['mixtral_layer_f32_cpu_s']:.1f} s")
    del w_dev, w_cpu
    torch.cuda.empty_cache()
    record["moe_layer"] = rec


def moe_serve_phase(dev, record, counters):
    """Phase 34a: ``serve`` on Mixtral-8x22B at full width cut to
    ``MOE_LAYERS`` layers, bf16 compute, B=2 x 8192 + 16 decode steps,
    counted (``serve_cell``), the weights' init time and peak; then
    prefill(8192) + decode(1) against prefill(8193) at B=1."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_mod
    cfg = get_config("mixtral_8x22b").replace(n_layers=MOE_LAYERS)
    model = serve_mod.serving_model(cfg)
    rec = {}
    weights = init_on_card(dev, model, "moe serve", f"Mixtral-8x22B at full "
                           f"width, {MOE_LAYERS} layers", rec)
    launches = serve_cell(dev, "moe serve", model, weights, MOE_BATCH,
                          K8_SEQ, MOE_DECODE_STEPS, counters, rec)
    del rec["prefill_logits"]
    prefill_decode_check(dev, "moe serve", model, weights, K8_SEQ, rec)
    del weights
    torch.cuda.empty_cache()
    record["moe_serve"] = rec
    return launches


def vision_phase(dev, record, counters):
    """Phase 34c: ``serve`` on Phi-3-vision-4.2B at full depth and width,
    bf16, B=1, from a (1, 4096, 3072) embedding prompt (the stub vision
    frontend's patch embeddings: rows of the embedding table), counted:
    32 K8 launches on the Hopper route (D = 96); the prefill of the
    embeddings equal to the prefill of their tokens bit for bit; 8
    decode steps, finite."""
    import torch
    from repro_torch.common.tree import tree_flatten_with_path
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as k8
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.params import param_count
    cfg = get_config("phi3_vision_4_2b")
    model = serve_mod.serving_model(cfg)
    route = k8.kernel_for(torch.bfloat16, cfg.resolved_head_dim)
    if route != "hopper":
        fail(f"Phi-3-vision's D={cfg.resolved_head_dim} takes K8's {route} "
             f"kernel, not the Hopper one")
    n_params = (param_count(model.backbone_specs())
                + param_count(model.head_specs()))
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    weights = serve_mod.init_weights(model, 0, dev)
    torch.cuda.synchronize()
    rec = {"params": n_params, "init_s": time.perf_counter() - t0,
           "init_peak_bytes": torch.cuda.max_memory_allocated(dev) - before,
           "k8_kernel": route}
    tokens = serve_mod.draw_prompt(cfg, 1, VISION_SEQ, 0).to(dev)
    embeds = weights[0]["trunk"]["embed"][tokens]      # (1, S, 3072) f32
    log(f"[vision] Phi-3-vision-4.2B full depth and width: {n_params:,} "
        f"parameters drawn on the card in {rec['init_s']:.2f} s; an "
        f"embedding prompt {tuple(embeds.shape)}")
    launches = serve_cell(dev, "vision serve", model, weights, 1, VISION_SEQ,
                          VISION_DECODE_STEPS, counters, rec, prompt=embeds)
    prefill = make_prefill_step(model,
                                cache_len=VISION_SEQ + VISION_DECODE_STEPS + 1)
    lg_e, c_e = prefill(*weights, embeds)
    lg_t, c_t = prefill(*weights, tokens)
    torch.cuda.synchronize()
    same = torch.equal(lg_e, lg_t) and torch.equal(
        lg_e, rec.pop("prefill_logits")) and all(
        torch.equal(a, b_) for (_, a), (_, b_) in zip(
            tree_flatten_with_path(c_e), tree_flatten_with_path(c_t)))
    if not same:
        fail("Phi-3-vision: the prefill of embed[tokens] differs from the "
             "prefill of the tokens")
    rec["embeds_equal_tokens_bit_for_bit"] = True
    log(f"[vision] prefill of embed[tokens] equal to the prefill of the "
        f"tokens bit for bit (logits and every cache leaf); "
        f"{VISION_DECODE_STEPS} decode steps finite")
    del weights, embeds, c_e, c_t
    torch.cuda.empty_cache()
    record["vision_serve"] = rec
    return launches


def gemma_serve_phase(dev, record, counters):
    """Phase 34f: ``serve`` on Gemma-3-12B at full width (d_model 3840,
    16/8 heads of 240, d_ff 15360, vocab 262,144) cut to ``GEMMA_LAYERS``
    layers, one 5:1 local:global group: bf16, B=1 x 8192 +
    ``GEMMA_DECODE_STEPS`` decode steps, counted (``serve_cell``: exactly 6
    K8 launches, all on the Hopper route, 5 with window 1024 and 1
    without), the weights' init time and peak; then prefill(8192) +
    decode(1) against prefill(8193) at B=1."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as k8
    from repro_torch.launch import serve as serve_mod
    cfg = get_config("gemma3_12b").replace(n_layers=GEMMA_LAYERS)
    route = k8.kernel_for(torch.bfloat16, cfg.resolved_head_dim)
    if route != "hopper":
        fail(f"Gemma-3's D={cfg.resolved_head_dim} takes K8's {route} "
             f"kernel, not the Hopper one")
    model = serve_mod.serving_model(cfg)
    rec = {"k8_kernel": route}
    weights = init_on_card(
        dev, model, "gemma serve", f"Gemma-3-12B at full width, "
        f"{GEMMA_LAYERS} layers (5 local with window {cfg.local_window}, 1 "
        f"global; K8 on {route})", rec)
    launches = serve_cell(dev, "gemma serve", model, weights, 1, K8_SEQ,
                          GEMMA_DECODE_STEPS, counters, rec)
    del rec["prefill_logits"]
    prefill_decode_check(dev, "gemma serve", model, weights, K8_SEQ, rec)
    del weights
    torch.cuda.empty_cache()
    record["gemma_serve"] = rec
    return launches


def new_smoke_phase(dev, record):
    """Phase 34e: the four new smoke configs (Mixtral, Phi-3.5-MoE,
    MusicGen, Phi-3-vision), the reference's seeded weights carried
    through ``convert.lm_params_from_numpy`` onto the card and the CPU,
    float32, B=2 prefill of 40 tokens (past the smoke window of 32) and 4
    decode steps, card against CPU within ``CUT_F32_LIMIT``."""
    import torch
    from repro_torch.common.tree import tree_map
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.launch import serve as serve_mod
    rec = {}
    for arch in NEW_SMOKE:
        cfg = get_smoke_config(arch)
        model = serve_mod.serving_model(cfg)
        as_np = [tree_map(lambda t: t.numpy(), w)
                 for w in serve_mod.init_weights(model, 0, "cpu")]
        w_cpu = tuple(lm_params_from_numpy(w) for w in as_np)
        w_dev = tuple(lm_params_from_numpy(w, dev) for w in as_np)
        prompt = serve_mod.draw_prompt(cfg, NEW_SMOKE_BATCH, NEW_SMOKE_SEQ, 0)
        rels = card_vs_cpu(arch, model, w_dev, w_cpu, prompt,
                           NEW_SMOKE_STEPS, CUT_F32_LIMIT, rec, dev)
        log(f"[smoke] {arch} smoke config, B={NEW_SMOKE_BATCH}, "
            f"S={NEW_SMOKE_SEQ}, float32: card vs CPU relative L2 "
            f"{['%.3e' % r for r in rels]} (limit {CUT_F32_LIMIT:g})")
    record["new_smoke"] = rec


def moe_grouped_phase(dev, record):
    """Phase 34g: ``moe_branch(train=False)`` in bf16 against a loop over
    the experts, each on the rows that chose it, combined in float32 in
    the same routing (``moe.router_logits``, ``moe._route``), at each
    ``MOE_GROUPED_SHAPES`` layer at prefill and at decode size."""
    import torch
    from repro_torch.common.config import ModelConfig, MoEConfig
    from repro_torch.models import layers as L
    from repro_torch.models import moe as M
    rec = {}
    gen = torch.Generator(device=dev).manual_seed(347)

    def normal(shape, std):
        return (torch.randn(shape, generator=gen, device=dev)
                * std).to(torch.bfloat16)

    for name, (d, e, f, k, fs, s) in MOE_GROUPED_SHAPES.items():
        cfg = ModelConfig(name=name, family="dense", n_layers=1, d_model=d,
                          n_heads=1, n_kv_heads=1, d_ff=f, vocab_size=2,
                          moe=MoEConfig(n_experts=e, top_k=k),
                          compute_dtype="bfloat16")
        p = {"norm": normal((d,), 0.05), "router": normal((d, e), d ** -0.5),
             "w_gate": normal((e, d, f), d ** -0.5),
             "w_up": normal((e, d, f), d ** -0.5),
             "w_down": normal((e, f, d), f ** -0.5)}
        if fs:
            p["shared"] = {"w_gate": normal((d, fs), d ** -0.5),
                           "w_up": normal((d, fs), d ** -0.5),
                           "w_down": normal((fs, d), fs ** -0.5)}

        def loop(x):
            b_, s_, _ = x.shape
            h = L.rms_norm(x, p["norm"], 1e-6).reshape(b_ * s_, d)
            gates, mask, _ = M._route(M.router_logits(p, h), k)
            gates = gates.to(h.dtype).float()
            out = torch.zeros((b_ * s_, d), dtype=torch.float32, device=dev)
            for j in range(e):
                tok = mask[:, j].nonzero().squeeze(1)
                if tok.numel():
                    out.index_add_(0, tok, gates[tok, j, None]
                                   * M._expert(p, j, h[tok]).float())
            if fs:
                out = out + L.mlp_apply(p["shared"], h).float()
            return out.reshape(b_, s_, d), mask

        for size, (b, sq) in (("prefill", (1, s)), ("decode", (2, 1))):
            x = normal((b, sq, d), 1.0)
            got = M.moe_branch(p, x, cfg, train=False)[0]
            want, mask = loop(x)
            empty = int((mask.sum(dim=0) == 0).sum())
            err, row = rel_l2(got, want), max_row_rel_l2(got, want)
            key = f"{name}_{size}"
            if (err > MOE_GROUPED_LIMIT or row > MOE_GROUPED_ROW_LIMIT
                    or not bool(torch.isfinite(got).all())):
                fail(f"moe grouped {key}: relative L2 {err:.3e} (limit "
                     f"{MOE_GROUPED_LIMIT:g}), worst row {row:.3e} (limit "
                     f"{MOE_GROUPED_ROW_LIMIT:g})")
            iters = 3 if size == "prefill" else 20
            ms = cuda_ms(lambda: M.moe_branch(p, x, cfg, train=False), iters)
            ms_loop = cuda_ms(lambda: loop(x), iters)
            rec[key] = {"rel_l2": err, "max_row_rel_l2": row,
                        "empty_experts": empty, "tokens": b * sq,
                        "grouped_ms": ms, "loop_ms": ms_loop}
            log(f"[moe grouped] {key}: B={b} S={sq}, {e} experts of {d} x "
                f"{f} top-{k}{f', shared {fs}' if fs else ''}; {empty} "
                f"experts without a row; relative L2 {err:.3e}, worst row "
                f"{row:.3e}; block {ms:.3f} ms grouped, {ms_loop:.3f} ms "
                f"as a loop over the experts")
            del x, got, want
        del p
        torch.cuda.empty_cache()
    record["moe_grouped"] = rec


def moe_phase(dev, record, counters):
    """Phase 34: K8 at the new layers' shapes (d), one full-width Mixtral
    layer card vs CPU (b), Mixtral-8x22B served at full width cut in
    depth (a), Phi-3-vision-4.2B served from embeddings (c), Gemma-3-12B
    served at full width cut in depth (f), the new smoke configs card vs
    CPU (e) and the grouped MoE block against a loop over the experts
    (g). Returns the counted runs' launches."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(34)
    k8_new = {name: k8_layer_case(dev, name, shape, gen, record)
              for name, shape in K8_NEW_SHAPES.items()}
    moe_layer_phase(dev, record)
    total = {}
    for got in (moe_serve_phase(dev, record, counters),
                vision_phase(dev, record, counters),
                gemma_serve_phase(dev, record, counters)):
        for k_name, v in got.items():
            total[k_name] = total.get(k_name, 0) + v
    new_smoke_phase(dev, record)
    moe_grouped_phase(dev, record)
    return total, k8_new


# --------------------------------------------------------------------------
# phase 35: the Mamba2, xLSTM and Zamba2-hybrid families
# --------------------------------------------------------------------------

def family_smoke_config(name):
    """A phase-35d config: an arch's smoke config, or ``mamba2``, the pure
    Mamba2 stack of ``tests/test_models.py``'s ``FAMILY_CONFIGS``."""
    from repro_torch.common.config import ModelConfig, SSMConfig
    from repro_torch.configs import get_smoke_config
    if name != "mamba2":
        return get_smoke_config(name)
    return ModelConfig(family="ssm", ssm=SSMConfig(d_state=16, head_dim=16,
                                                   chunk_size=8),
                       n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                       d_ff=128, vocab_size=128, attn_block_q=16,
                       attn_block_kv=16, remat_policy="none",
                       compute_dtype="float32")


def init_on_card(dev, model, label, what, rec):
    """``serve``'s seeded weights of ``model`` drawn on the card: the init
    seconds, the init peak and the weights' bytes into ``rec``, logged
    under ``label`` with ``what`` naming the model."""
    import torch
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models.params import param_count
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)   # earlier phases' tensors
    t0 = time.perf_counter()
    weights = serve_mod.init_weights(model, 0, dev)
    torch.cuda.synchronize()
    rec.update(params=(param_count(model.backbone_specs())
                       + param_count(model.head_specs())),
               init_s=time.perf_counter() - t0,
               allocated_before_init_bytes=before,
               init_peak_bytes=torch.cuda.max_memory_allocated(dev) - before,
               weights_bytes=torch.cuda.memory_allocated(dev) - before)
    log(f"[{label}] {what}: {rec['params']:,} parameters, float32 weights "
        f"({rec['weights_bytes'] / 1e9:.2f} GB) drawn on the card in "
        f"{rec['init_s']:.2f} s, init peak "
        f"{rec['init_peak_bytes'] / 1e9:.2f} GB above the "
        f"{before / 1e9:.2f} GB the card held before")
    return weights


def state_cut(dev, name, cfg, n_layers, seq, rec):
    """A depth cut of ``cfg`` at full width, float32 compute, drawn on the
    card and copied to the host: B=1 prefill of ``seq`` and
    ``STATE_CUT_STEPS`` decode steps on the card against the CPU (the
    card fed the CPU's tokens and, from the second decode step on, the
    CPU's cache: the state is rounded to bf16 in the cache) within
    ``CUT_F32_LIMIT``."""
    import torch
    from repro_torch.common.tree import tree_map
    from repro_torch.launch import serve as serve_mod
    cfg = cfg.replace(n_layers=n_layers, compute_dtype="float32")
    model = serve_mod.serving_model(cfg)
    w_dev = serve_mod.init_weights(model, 0, dev)
    w_cpu = tuple(tree_map(lambda t: t.cpu(), w) for w in w_dev)
    prompt = serve_mod.draw_prompt(cfg, 1, seq, 0)
    rels = card_vs_cpu(name, model, w_dev, w_cpu, prompt, STATE_CUT_STEPS,
                       CUT_F32_LIMIT, rec, dev, feed_cache=True)
    log(f"[{name}] {cfg.name} cut to {n_layers} layers at full width, B=1, "
        f"S={seq}, float32: card vs CPU relative L2 of the logits "
        f"(prefill, then {STATE_CUT_STEPS} decode steps) "
        f"{['%.3e' % r for r in rels]} (limit {CUT_F32_LIMIT:g}); CPU "
        f"{rec[f'{name}_cpu_s']:.1f} s")
    del w_dev, w_cpu
    torch.cuda.empty_cache()


def zamba_phase(dev, record, counters):
    """Phase 35b: ``serve`` on Zamba2-1.2B at full depth and width (38
    Mamba2 layers, the shared block applied 6 times), bf16, B=1 x 8192 +
    ``ZAMBA_DECODE_STEPS`` decode steps, counted (``serve_cell``: exactly
    6 K8 launches, all on the Hopper route at D=64), init s and peak,
    prefill and decode ms, peak memory, a traced prefill and decode step;
    prefill(2047) + decode(1) against prefill(2048) at B=1 (2047 is one
    whole-sequence SSD chunk); then the full-width 6-layer cut (one
    segment, one shared application) against the CPU at S = 4352, past
    the 4096 window, its 4 decode steps through the ring."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as k8
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models.hybrid import n_shared_applications
    cfg = get_config("zamba2_1_2b")
    route = k8.kernel_for(torch.bfloat16, cfg.resolved_head_dim)
    if route != "hopper":
        fail(f"Zamba2's D={cfg.resolved_head_dim} takes K8's {route} "
             f"kernel, not the Hopper one")
    model = serve_mod.serving_model(cfg)
    apps = n_shared_applications(cfg)
    rec = {"k8_kernel": route, "shared_applications": apps}
    weights = init_on_card(dev, model, "zamba2 serve",
                           "Zamba2-1.2B at full depth and width", rec)
    launches = serve_cell(dev, "zamba2 serve", model, weights, 1, K8_SEQ,
                          ZAMBA_DECODE_STEPS, counters, rec,
                          k8_launches=apps)
    del rec["prefill_logits"]
    prefill_decode_check(dev, "zamba2 serve", model, weights,
                         ZAMBA_CHECK_SEQ, rec, k8_launches=apps)
    del weights
    torch.cuda.empty_cache()
    state_cut(dev, "zamba2_cut", cfg, ZAMBA_CUT_LAYERS, ZAMBA_CUT_SEQ, rec)
    record["zamba2_serve"] = rec
    return launches


def xlstm_phase(dev, record, counters):
    """Phase 35c: ``serve`` on xLSTM-1.3B at full depth and width (48
    blocks: 6 super-blocks of 7 mLSTM + 1 sLSTM), bf16, B=1 x 2048 +
    ``XLSTM_DECODE_STEPS`` decode steps, counted (``serve_cell``: no K8
    launch), init s and peak, prefill and decode ms, peak memory, a traced
    prefill of the prompt's first 256 positions and a traced decode step;
    the sLSTM's share of one more prefill, of the traced prefill's
    ``XLSTM_TRACE_SEQ`` positions (each of its 6 sLSTM blocks timed on the
    host clock between two synchronizes); then the
    full-width 8-layer cut (one super-block) against the CPU at S = 512,
    two mLSTM chunks."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import xlstm as XL
    cfg = get_config("xlstm_1_3b")
    model = serve_mod.serving_model(cfg)
    rec = {}
    weights = init_on_card(dev, model, "xlstm serve",
                           "xLSTM-1.3B at full depth and width", rec)
    launches = serve_cell(dev, "xlstm serve", model, weights, 1, XLSTM_SEQ,
                          XLSTM_DECODE_STEPS, counters, rec, k8_launches=0,
                          trace_len=XLSTM_TRACE_SEQ)
    del rec["prefill_logits"]
    # the sLSTM's share of one prefill: each sLSTM block's host time
    # (synchronized before and after) inside a prefill timed whole
    spans = []
    plain_slstm = XL.slstm_apply

    def timed_slstm(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = plain_slstm(*args, **kw)
        torch.cuda.synchronize()
        spans.append(1e3 * (time.perf_counter() - t0))
        return out
    prefill = make_prefill_step(model, cache_len=XLSTM_TRACE_SEQ + 1)
    prompt = serve_mod.draw_prompt(cfg, 1, XLSTM_SEQ, 0)[
        :, :XLSTM_TRACE_SEQ].to(dev)
    XL.slstm_apply = timed_slstm
    try:
        wall = host_ms(lambda: prefill(*weights, prompt))
    finally:
        XL.slstm_apply = plain_slstm
    rec.update(slstm_block_ms=spans, slstm_prefill_ms=wall,
               slstm_share_of_prefill=sum(spans) / wall)
    log(f"[xlstm serve] inside one prefill of {XLSTM_TRACE_SEQ} ({wall:.1f} "
        f"ms, "
        f"each sLSTM block synchronized): the {len(spans)} sLSTM blocks "
        f"{sum(spans):.1f} ms ({100 * sum(spans) / wall:.1f} %; "
        f"{sum(spans) * 1e3 / (len(spans) * XLSTM_TRACE_SEQ):.1f} us per "
        f"block "
        f"per token)")
    del weights, prompt
    torch.cuda.empty_cache()
    state_cut(dev, "xlstm_cut", cfg, XLSTM_CUT_LAYERS, XLSTM_CUT_SEQ, rec)
    record["xlstm_serve"] = rec
    return launches


def family_smoke_phase(dev, record):
    """Phase 35d: the zamba2 and xlstm smoke configs and the pure Mamba2
    stack (``family_smoke_config``), seeded weights through ``convert``:
    B=2 prefill of 40 tokens (past the zamba2 smoke window of 32) and 4
    decode steps card against CPU within ``CUT_F32_LIMIT``, each decode
    step after the first from the CPU's cache (``card_vs_cpu``); then a
    train-mode forward and backward of ``lm_loss`` at B=4 S=128 on the
    card against the CPU (loss rtol ``LM_RTOL``, the whole gradient
    relative L2 1e-4), float32."""
    import torch
    from repro_torch import rng
    from repro_torch.common.tree import tree_map
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.data.lm import synthetic_lm_batches
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models.model import build_model
    from repro_torch.models.params import init_params
    rec = {}
    for name in FAMILY_SMOKE:
        cfg = family_smoke_config(name)
        model = serve_mod.serving_model(cfg)
        as_np = [tree_map(lambda t: t.numpy(), w)
                 for w in serve_mod.init_weights(model, 0, "cpu")]
        w_cpu = tuple(lm_params_from_numpy(w) for w in as_np)
        w_dev = tuple(lm_params_from_numpy(w, dev) for w in as_np)
        prompt = serve_mod.draw_prompt(cfg, NEW_SMOKE_BATCH, NEW_SMOKE_SEQ, 0)
        rels = card_vs_cpu(name, model, w_dev, w_cpu, prompt,
                           NEW_SMOKE_STEPS, CUT_F32_LIMIT, rec, dev,
                           feed_cache=True)

        model = build_model(cfg)
        keys = rng.split(rng.PRNGKey(35), 3)
        backbone = {"trunk": init_params(model.trunk_specs(), keys[0]),
                    "final": init_params(model.final_specs(), keys[1])}
        head = init_params(model.head_specs(), keys[2])
        toks, labs = next(synthetic_lm_batches(cfg.vocab_size, LM_BATCH,
                                               LM_SEQ, seed=35))
        loss_g, _, grads_g = train_fwd_bwd(model, backbone, head, toks,
                                           labs, dev)
        loss_c, _, grads_c = train_fwd_bwd(model, backbone, head, toks,
                                           labs, "cpu")
        g_g = torch.cat([g.reshape(-1).cpu() for g in grads_g])
        g_c = torch.cat([g.reshape(-1) for g in grads_c])
        err = rel_l2(g_g, g_c)
        if (abs(loss_g - loss_c) > LM_RTOL * abs(loss_c) or err > 1e-4
                or not bool(torch.isfinite(g_g).all())):
            fail(f"{name} train: loss card {loss_g} vs CPU {loss_c}, "
                 f"gradient relative L2 {err:.3e}")
        rec[f"{name}_train"] = {"loss": loss_g, "loss_cpu": loss_c,
                                "grad_rel_l2": err}
        log(f"[smoke] {name} ({cfg.family}), B={NEW_SMOKE_BATCH}, "
            f"S={NEW_SMOKE_SEQ}, float32: card vs CPU relative L2 "
            f"{['%.3e' % r for r in rels]} (limit {CUT_F32_LIMIT:g}); train "
            f"B={LM_BATCH} S={LM_SEQ}: loss card {loss_g:.6f} vs CPU "
            f"{loss_c:.6f}, gradient relative L2 {err:.3e} over "
            f"{g_g.numel()} entries")
    record["family_smoke"] = rec


def state_families_phase(dev, record, counters):
    """Phase 35: K8 at Zamba2's layer (a), Zamba2-1.2B served at full
    depth and width and its cut against the CPU (b), xLSTM-1.3B the same
    (c), the three smoke configs card vs CPU in serve and training (d).
    Returns the counted runs' launches and (a)'s record."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(35)
    k8_zamba = k8_layer_case(dev, "zamba2_layer", ZAMBA_K8_SHAPE, gen,
                             record)
    total = {}
    for got in (zamba_phase(dev, record, counters),
                xlstm_phase(dev, record, counters)):
        for k_name, v in got.items():
            total[k_name] = total.get(k_name, 0) + v
    family_smoke_phase(dev, record)
    return total, k8_zamba

def _quiet(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with its standard output kept back."""
    import io
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


def _counted(counters, where, fn, draws_words):
    """``fn()`` with every counter set to 0 just before and read just
    after: (result, launches without the draws)."""
    import torch
    for ctr in counters:
        ctr.reset()
    res = fn()
    torch.cuda.synchronize()
    launches = {ctr.name: ctr.count for ctr in counters}
    take_draws(where, launches, draws_words=draws_words)
    return res, launches


def examples_phase(dev, record, counters):
    """Phase 36: ``serve_batched`` for every smoke config and the
    quickstart's training run and sweep, counted, against the CPU.
    Returns the counted runs' launches."""
    import torch
    from repro_torch.configs import ALIASES, get_smoke_config
    from repro_torch.experiments import quickstart, serve_batched
    from repro_torch.models.hybrid import n_shared_applications
    rec, total = {"serve_batched": {}}, {}

    def add(launches):
        for k_name, v in launches.items():
            total[k_name] = total.get(k_name, 0) + v

    for arch in EXAMPLE_ARCHS:
        cfg = get_smoke_config(ALIASES[arch])
        k8_want = (0 if cfg.family == "xlstm" else n_shared_applications(cfg)
                   if cfg.family == "hybrid" else cfg.n_layers)
        argv = ["--arch", arch]
        t0 = time.perf_counter()
        res, launches = _counted(counters, f"serve_batched {arch}", lambda:
                                 _quiet(serve_batched.main,
                                        argv + ["--device", "cuda"]), False)
        card_s = time.perf_counter() - t0
        want = {ctr.name: 0 for ctr in counters if ctr.name not in DRAW_NAMES}
        want["flash_attention"] = k8_want
        if launches != want:
            fail(f"serve_batched {arch}: launches {launches}, expected {want}")
        cpu = _quiet(serve_batched.main, argv + ["--device", "cpu"])
        err = rel_l2(res.prefill_logits.cpu(), cpu.prefill_logits)
        finite = bool(torch.isfinite(res.last_logits).all())
        if not (err <= CUT_F32_LIMIT and finite):
            fail(f"serve_batched {arch}: prefill logits card vs CPU relative "
                 f"L2 {err:.3g} > {CUT_F32_LIMIT}, or non-finite logits")
        add(launches)
        rec["serve_batched"][arch] = {
            "k8_launches": launches["flash_attention"], "rel_l2": err,
            "wall_s": card_s, "prefill_ms": 1e3 * res.prefill_s,
            "decode_ms_median": 1e3 * statistics.median(res.decode_s),
            "tokens_equal_cpu": bool(torch.equal(res.tokens, cpu.tokens))}
        log(f"[serve_batched] {arch}: {launches['flash_attention']} K8 "
            f"launches, prefill logits card vs CPU relative L2 {err:.2e}, "
            f"tokens {'equal' if rec['serve_batched'][arch]['tokens_equal_cpu'] else 'differ'}; "
            f"prefill {1e3 * res.prefill_s:.1f} ms, decode "
            f"{rec['serve_batched'][arch]['decode_ms_median']:.2f} ms a step")

    # the quickstart's training run, counted; ω kept after its first
    # QS_CHECK_ROUNDS rounds (a copy to the host, no launch)
    from repro_torch.common.tree import tree_leaves
    make_sim, snap = quickstart.quickstart_sim, {"rounds": 0}

    def snapshot_sim(*args):
        sim, batcher = make_sim(*args)
        step = sim.step

        def snapshot_step(state, *step_args):
            state, m = step(state, *step_args)
            snap["rounds"] += 1
            if snap["rounds"] == QS_CHECK_ROUNDS:
                snap["omega"] = [t.detach().cpu().clone()
                                 for t in tree_leaves(state.omega)]
            return state, m
        sim.step = snapshot_step
        return sim, batcher
    quickstart.quickstart_sim = snapshot_sim
    try:
        t0 = time.perf_counter()
        hist, launches = _counted(counters, "quickstart", lambda: _quiet(
            quickstart.main, QS_ROUNDS, "cuda"), True)
        qs_s = time.perf_counter() - t0
    finally:
        quickstart.quickstart_sim = make_sim
    want = {ctr.name: 0 for ctr in counters if ctr.name not in DRAW_NAMES}
    want.update(ota_client_fold=10 * QS_ROUNDS, masked_gradnorm=QS_ROUNDS)
    if launches != want:
        fail(f"quickstart: launches {launches}, expected {want}")
    add(launches)
    first = hist[0]["loss"].mean(axis=0)
    last = hist[-1]["loss"].mean(axis=0)
    if not (np_all_finite([h["loss"] for h in hist]) and (last < first).all()):
        fail(f"quickstart: per-task loss {first} -> {last} does not fall")
    # the counted run's first rounds against the CPU's, ω after them
    t0 = time.perf_counter()
    cpu = _quiet(quickstart.main, QS_CHECK_ROUNDS, "cpu")
    cpu_s = time.perf_counter() - t0
    worst = 0.0
    for r, (a, b) in enumerate(zip(hist[:QS_CHECK_ROUNDS], cpu)):
        for k_name in ("loss", "p"):
            e = float(abs(a[k_name] - b[k_name]).max()
                      / max(abs(b[k_name]).max(), 1e-30))
            worst = max(worst, e)
            if not all_close(a[k_name], b[k_name], 1e-4):
                fail(f"quickstart round {r} {k_name}: card vs CPU beyond "
                     f"rtol 1e-4")
    om = rel_l2(torch.cat([t.reshape(-1) for t in snap["omega"]]),
                torch.cat([t.reshape(-1) for t in tree_leaves(
                    cpu[-1]["state"].omega)]))
    if om > 1e-3:
        fail(f"quickstart: ω card vs CPU relative L2 {om:.3g} > 1e-3")
    # the sweep, counted
    t0 = time.perf_counter()
    sweep, launches = _counted(counters, "quickstart sweep", lambda: _quiet(
        quickstart.sweep, QS_SWEEP_ROUNDS, "cuda"), True)
    sweep_s = time.perf_counter() - t0
    if not (launches["ota_client_fold"] and torch.isfinite(
            sweep["loss"]).all()):
        fail(f"quickstart sweep: launches {launches} or non-finite losses")
    add(launches)
    rec.update(quickstart={
        "rounds": QS_ROUNDS, "launches": dict(want), "wall_s": qs_s,
        "loss_first": first.tolist(), "loss_last": last.tolist(),
        "check_rounds": QS_CHECK_ROUNDS, "max_rel_err": worst,
        "omega_rel_l2": om, "cpu_s": cpu_s},
        sweep={"rounds": QS_SWEEP_ROUNDS, "launches": launches,
               "wall_s": sweep_s,
               "loss_last": sweep["loss"][-1].mean(dim=(1, 2)).tolist()})
    log(f"[quickstart] {QS_ROUNDS} rounds in {qs_s:.1f} s (counted: "
        f"{want['ota_client_fold']} K1, {want['masked_gradnorm']} K2); loss "
        f"per task {[round(float(v), 3) for v in first]} -> "
        f"{[round(float(v), 3) for v in last]}; first {QS_CHECK_ROUNDS} "
        f"rounds card vs CPU within {worst:.2e} (loss, p), ω relative L2 "
        f"{om:.2e}; sweep {QS_SWEEP_ROUNDS} rounds x 3 scenarios in "
        f"{sweep_s:.1f} s, last mean losses "
        f"{[round(v, 3) for v in rec['sweep']['loss_last']]}")
    record["examples"] = rec
    return total


def np_all_finite(arrays) -> bool:
    import numpy as np
    return all(bool(np.isfinite(a).all()) for a in arrays)


def all_close(a, b, rtol) -> bool:
    import numpy as np
    return bool(np.allclose(a, b, rtol=rtol, atol=0.0))


def cost_model_phase(dev, record):
    """Phase 37: the dry run's serve step on a one-rank mesh, traced on
    ``meta`` and run for real on the card, StarCoder2-3B at full width in
    bf16: prefill B=1 x ``K8_SEQ`` and one decode step against a cache of
    ``K8_SEQ``; then its train step (``cost_model_train``)."""
    import torch
    from repro_torch import rng
    from repro_torch.common.config import InputShape
    from repro_torch.common.tree import tree_cast
    from repro_torch.launch import cost_analysis, dryrun, op_cost
    from repro_torch.models.model import build_model
    from repro_torch.models.params import init_params
    from repro_torch.sharding.mesh_utils import Mesh
    cfg = sc2_config()
    mesh = Mesh((1, 1), ("data", "model"), device=dev)
    model = build_model(cfg.replace(**dryrun.SERVE_ARCH_OVERRIDES))
    key = rng.PRNGKey(37)
    weights = tree_cast({"trunk": init_params(model.trunk_specs(), key,
                                              device=dev),
                         "final": init_params(model.final_specs(), key,
                                              device=dev),
                         "head": init_params(model.head_specs(), key,
                                             device=dev)}, torch.bfloat16)
    torch.cuda.empty_cache()
    backbone = {"trunk": weights["trunk"], "final": weights["final"]}
    out = {}
    for shape in (InputShape("prefill_8k", K8_SEQ, 1, "prefill"),
                  InputShape("decode_8k", K8_SEQ, 1, "decode")):
        step, meta_args, _ = dryrun.serve_setup(cfg, mesh, shape)
        _, want = op_cost.trace(step, *meta_args, device="meta")
        if shape.kind == "prefill":
            args = (backbone, weights["head"], rng.randint(
                key, (1, K8_SEQ), 0, cfg.vocab_size).to(dev))
        else:
            args = (backbone, weights["head"],
                    model.init_cache(1, K8_SEQ, torch.bfloat16, device=dev),
                    torch.ones((1, 1), dtype=torch.int32, device=dev),
                    torch.full((1,), K8_SEQ - 1, dtype=torch.int32,
                               device=dev))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        _, got = op_cost.trace(step, *args, device="cuda")
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - base
        measured = got.argument_bytes + peak
        iters = (COST_PREFILL_ITERS if shape.kind == "prefill"
                 else COST_DECODE_ITERS)
        times = []
        for _ in range(iters):
            times.append(host_ms(lambda: step(*args)))
        ms = statistics.median(times)
        roof = cost_analysis.extract_roofline(want)
        rec = {"argument_bytes": want.argument_bytes,
               "argument_bytes_card": got.argument_bytes,
               "flops": want.flops, "flops_card": got.flops,
               "temp_bytes": want.temp_bytes,
               "temp_bytes_card_trace": got.temp_bytes,
               "predicted_bytes": want.total_bytes,
               "measured_bytes": measured, "peak_above_resident": peak,
               "bytes_major": want.bytes_major, "bytes_all": want.bytes,
               "n_ops": want.n_ops, "n_ops_card": got.n_ops,
               "ms": ms, "ms_all": times,
               "compute_s": roof.compute_s, "memory_s": roof.memory_s,
               "compute_share": roof.compute_s / (ms / 1e3),
               "memory_share": roof.memory_s / (ms / 1e3)}
        rec["peak_rel_err"] = (want.total_bytes - measured) / measured
        out[shape.name] = rec
        log(f"[cost model] {shape.name}: argument bytes meta "
            f"{want.argument_bytes} card {got.argument_bytes}; FLOPs meta "
            f"{want.flops:.6e} card {got.flops:.6e}; argument + temp "
            f"{want.total_bytes / 1e9:.4f} GB against the card's "
            f"{measured / 1e9:.4f} GB ({100 * rec['peak_rel_err']:+.2f} %); "
            f"{ms:.3f} ms, compute term {1e3 * roof.compute_s:.3f} ms "
            f"({100 * rec['compute_share']:.1f} %), memory term "
            f"{1e3 * roof.memory_s:.3f} ms ({100 * rec['memory_share']:.1f} "
            f"%)")
        if got.argument_bytes != want.argument_bytes:
            fail(f"cost model {shape.name}: argument bytes meta "
                 f"{want.argument_bytes} != card {got.argument_bytes}")
        if got.flops != want.flops:
            fail(f"cost model {shape.name}: FLOPs meta {want.flops} != card "
                 f"{got.flops}")
        if abs(rec["peak_rel_err"]) > COST_PEAK_TOL:
            fail(f"cost model {shape.name}: argument + temp "
                 f"{want.total_bytes} vs the card's {measured}, beyond "
                 f"{COST_PEAK_TOL:.0%}")
        del args
    del weights, backbone
    torch.cuda.empty_cache()
    out["train_step"] = cost_model_train(dev)
    record["cost_model"] = out


def cost_model_train(dev):
    """Phase 37's train step: the dry run's train step (``count_mode``
    "local", bf16 compute) on a one-rank mesh at ``COST_TRAIN_ARCH``'s
    smoke config, traced on ``meta`` and run on the card under the same
    mode. The two must count the same FLOPs and the same launches of
    every kernel, and the card's launches must be its wrappers' counts."""
    import torch
    from repro_torch import rng
    from repro_torch.common.config import FLConfig, TrainConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.hota_step import make_hota_step_parts
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as k8
    from repro_torch.kernels.masked_gradnorm import ops as k2
    from repro_torch.kernels.ota_channel import ops as k1
    from repro_torch.kernels.ota_channel import ref as k1_ref
    from repro_torch.launch import dryrun, op_cost
    from repro_torch.models.model import build_model
    from repro_torch.sharding.mesh_utils import Mesh
    ctrs = [v for mod in (k1, k2, k8, k1_ref) for v in vars(mod).values()
            if isinstance(v, _build.LaunchCounter)]
    cfg = get_smoke_config(COST_TRAIN_ARCH).replace(
        **dryrun.TRAIN_ARCH_OVERRIDES)
    model = build_model(cfg)
    b, s, n_mb = COST_TRAIN_SHAPE
    fl = FLConfig(n_clients=1, ota_mode="scatter", microbatches=n_mb)
    tcfg = TrainConfig(lr=3e-4, global_batch=b, seq_len=s, fl=fl)
    got = {}
    for d in ("meta", dev):
        mesh = Mesh((1, 1, 1), ("cluster", "client", "model"), device=d)
        parts = make_hota_step_parts(model, mesh, fl, tcfg, loss_kind="lm",
                                     count_mode="local")
        if d == "meta":
            state = parts.abstract_fn()._replace(
                step=torch.zeros((), dtype=torch.int32))
            tokens = torch.empty(b, s, dtype=torch.int32, device="meta")
        else:
            state = parts.init_fn(rng.PRNGKey(37))
            tokens = rng.randint(rng.PRNGKey(38), (b, s), 0,
                                 cfg.vocab_size).to(dev)
            torch.cuda.synchronize()
        for ctr in ctrs:
            ctr.reset()
        _, tot = op_cost.trace(
            lambda st, x, y, k: parts.step(st, x, y, k, parts.chan_all, None),
            state, tokens, tokens, rng.PRNGKey(0), device=d)
        counted = {c.name: c.count for c in ctrs if c.count}
        got["meta" if d == "meta" else "card"] = (tot, counted)
    (want, _), (card, counted) = got["meta"], got["card"]
    rec = {"arch": COST_TRAIN_ARCH, "shape": list(COST_TRAIN_SHAPE),
           "flops": want.flops, "flops_card": card.flops,
           "dot_flops": want.dot_flops, "kernel_flops": want.kernel_flops,
           "launches": want.kernels, "launches_card": card.kernels,
           "counted_card": counted}
    log(f"[cost model] train step ({COST_TRAIN_ARCH} smoke, B, S, "
        f"microbatches = {COST_TRAIN_SHAPE}): FLOPs meta {want.flops:.6e} "
        f"card {card.flops:.6e}; launches meta {want.kernels}, card "
        f"{card.kernels}, counted {counted}")
    if card.flops != want.flops:
        fail(f"cost model train step: FLOPs meta {want.flops} != card "
             f"{card.flops}")
    if not (want.kernels == card.kernels == counted and counted):
        fail(f"cost model train step: launches meta {want.kernels}, card "
             f"{card.kernels}, counted {counted}")
    return rec


def _stop_children() -> None:
    """Stop the ranks' fork server and its resource tracker (they would
    otherwise outlive the script by a second or more), then fail if any
    process this script started still runs."""
    from repro_torch.launch.mesh import stop_fork_server
    stop_fork_server()
    task = f"/proc/{os.getpid()}/task"
    left = [c for t in os.listdir(task)
            for c in open(f"{task}/{t}/children").read().split()]
    if left:
        fail(f"processes still running at the end: {left}")
    log("[processes] the fork server and resource tracker stopped; no "
        "child process left")


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
    record = {"tf32": False, "phase_s": {}}
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; TF32 off for "
        f"matmul and cuDNN")
    t_lap = [time.perf_counter()]

    def lap(phases: str) -> None:
        """Record the wall seconds since the last lap under ``phases``."""
        now = time.perf_counter()
        record["phase_s"][phases] = now - t_lap[0]
        log(f"[phase time] {phases}: {now - t_lap[0]:.1f} s")
        t_lap[0] = now

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

    lap("1-7")

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

    lap("8-9")

    # --- 10. the stream draws, K3 and K4 against their plain versions ------
    draw_chunked, draw_flat = check_draws(dev, c, packer, chan_key, record)
    k3_err, k4_err = check_k34(dev, c, record)

    # --- 11. the packed path at full width ----------------------------------
    got, k3, k4 = packed_path(sim, st_t, batcher.next_stacked(),
                              rng.fold_in(key0, 2500), dev, record, counters)
    for k_name, v in got.items():
        total[k_name] += v

    lap("10-11")

    # --- 12. the per-leaf oracle's round ------------------------------------
    got = perleaf_phase(sim, batcher, key0, dev, record, counters)
    for k_name, v in got.items():
        total[k_name] += v

    lap("12")

    # --- 13. the layout tuner and a tuned sweep -----------------------------
    got = tuner_phase(sim, batcher, dev, record, counters)
    for k_name, v in got.items():
        total[k_name] += v

    lap("13")

    # --- 14-16. serving StarCoder2-3B at full width on K8 -------------------
    from repro_torch.kernels.flash_attention import ops as k8
    k8_err, k8_rec = k8_phase(dev, record)
    lap("14")
    cut_phase(dev, record)
    lap("15")
    got = serve_phase(dev, record, counters + (k8.counter,))
    for k_name, v in got.items():
        total[k_name] = total.get(k_name, 0) + v

    lap("16")

    # --- 17-18. K6 and K7 against their plain versions ----------------------
    gen_d = torch.Generator(device=dev).manual_seed(17)
    k6, k6_err = check_k6(dev, gen_d, record)
    k7 = check_k7(dev, gen_d, record)

    lap("17-18")

    # --- 19-20. gloo on CUDA tensors, the distributed step, the ω̃ gather ---
    gloo_probe_phase(dev, record)
    got = dist_phase(dev, record)
    for k_name, v in got.items():
        total[k_name] = total.get(k_name, 0) + v

    lap("19-20")

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

    lap("21-24")

    # --- 25-28. sampling, the sampled bank, per-leaf and sectioned steps ---
    for got in (sampled_phase(sim, batcher, key0, dev, record, counters),
                sampled_bank_phase(sim, batcher, dev, record, counters),
                dist_perleaf_phase(dev, record),
                dist_sectioned_phase(dev, record)):
        for k_name, v in got.items():
            total[k_name] = total.get(k_name, 0) + v

    lap("25-28")

    # --- 29-31. LM training: the pieces, the lm-100m step, the launcher ----
    lm_pieces_phase(dev, record)
    lap("29")
    for k_name, v in lm_dist_phase(dev, record).items():
        total[k_name] = total.get(k_name, 0) + v
    lm_kernel_timing(dev, record)
    lap("30")
    launcher_phase(dev, record)
    lap("31")

    # --- 32-33. the scenario banks spread over ranks sharing the card -------
    for k_name, v in scenario_banks_phase(sim, banks, bank_batches,
                                          bank_keys, batcher, dev, record,
                                          len(runs)).items():
        total[k_name] = total.get(k_name, 0) + v
    lap("32-33")

    # --- 34. the MoE layer and the audio and vision stub frontends ---------
    got, k8_new = moe_phase(dev, record, counters + (k8.counter,))
    for k_name, v in got.items():
        total[k_name] = total.get(k_name, 0) + v
    lap("34")

    # --- 35. the Mamba2, xLSTM and Zamba2-hybrid families ------------------
    got, k8_zamba = state_families_phase(dev, record,
                                         counters + (k8.counter,))
    for k_name, v in got.items():
        total[k_name] = total.get(k_name, 0) + v
    k8_new["zamba2_layer"] = k8_zamba
    lap("35")

    # --- 36. the examples on the card ---------------------------------------
    got = examples_phase(dev, record, counters + (k8.counter,))
    for k_name, v in got.items():
        total[k_name] = total.get(k_name, 0) + v
    lap("36")

    # --- 37. the dry run's cost model against the card ----------------------
    cost_model_phase(dev, record)
    lap("37")
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
         "library_ms": None,
         "lm100m_step_ms": record["lm_kernels"]["k5"]["ms"],
         "lm100m_step_bound_ms": record["lm_kernels"]["k5"]["bound_ms"]},
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
         "launches": total["flash_attention"],
         "max_abs_err": max([k8_err] + [r["max_abs_err"]
                                        for r in k8_new.values()]),
         "ms": k8_rec["ms"], "plain_ms": k8_rec["plain_ms"],
         "bound_ms": k8_rec["bound_ms"], "bound_by": k8_rec["bound_by"],
         "library_ms": k8_rec["sdpa_window_mask_ms"],
         **{f"{name}_{key}": rec[key] for name, rec in k8_new.items()
            for key in ("kernel", "max_abs_err", "ms", "ms_mma_sync",
                        "plain_ms", "bound_ms", "bound_by", "sdpa_ms")}},
        {"name": "ota_mask_count", "route": "cuda",
         "source": "src/repro_torch/kernels/ota_channel/csrc/"
                   "ota_mask_count.cu",
         "replaces": "src/repro/kernels/ota_channel/kernel.py:208",
         "launches": total["ota_mask_count"], "max_abs_err": k6_err,
         "fault_max_abs_err": record["k6_fault_max_abs_err"],
         "ms": k6[2]["ms"], "plain_ms": k6[2]["plain_ms"],
         "bound_ms": k6[2]["bound_ms"], "bound_by": "bytes",
         "library_ms": None,
         "lm100m_step_ms": record["lm_kernels"]["k6"]["ms"],
         "lm100m_step_bound_ms": record["lm_kernels"]["k6"]["bound_ms"]},
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
    _stop_children()
    record.update(card=card, kind=kind)
    log("[record] " + json.dumps(record))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
