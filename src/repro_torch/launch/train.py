"""The training launcher, and divergence recovery (``RoundGuard``).

Port of ``repro.launch.train``: HOTA-FedGradNorm training of any
``--arch``'s reduced (smoke) config (the dense family, the MoE pair,
the stub frontends, zamba2-1.2b's Mamba2 hybrid and xlstm-1.3b) on a
(clusters, clients, model) mesh, with the LM loss, checkpointing and metric logging; the same flags,
defaults and printed lines as the reference, on the card unless
``--device cpu``::

    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \\
        --steps 50 --mesh 2,2,1

One process per mesh position runs the distributed step
(``launch.mesh.run_ranks``; on one card the ranks share it over gloo).
No layout names the "model" axis, so its ranks are replicas of the FL
ranks: they run the same step on the same batch, with the FL process
groups built per model index. Before the ranks start, the section
layout is tuned on the device (default on: ``--no-tune-layout``,
``--layout-cache``). Rank 0 prints and writes the checkpoints, in the
reference's format: with ``--ckpt-every K`` the whole global state every
K rounds (``kind: full_state``), and at the end the global ω gathered
from the ranks' FSDP shards, so either restores in the reference's
``restore_checkpoint``. With ``--faults`` and ``--ckpt-dir`` a
``RoundGuard`` restores the newest full-state checkpoint after
``--guard-patience`` skipped rounds in a row, and each rank takes its
piece of it again.
"""
from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from repro_torch import rng
from repro_torch.checkpoint.store import (
    latest_step, restore_checkpoint, save_checkpoint,
)
from repro_torch.common.config import FLConfig, TrainConfig
from repro_torch.common.device import resolve_device
from repro_torch.configs import ALIASES, get_smoke_config
from repro_torch.convert import hota_state_to_numpy
from repro_torch.core.hota_step import (
    global_like, make_hota_train_step, shard_state,
)
from repro_torch.data.lm import synthetic_lm_batches
from repro_torch.launch.mesh import run_ranks
from repro_torch.models.model import build_model
from repro_torch.sharding.mesh_utils import shard_slices

MESH_AXES = ("cluster", "client", "model")


class RoundGuard:
    """Host-side divergence recovery (DESIGN.md §3.14).

    The guard inside a faulted round already turns a non-finite or
    spiking round into a bit-exact skip (the state frozen, the
    ``skipped`` metric set). This class watches that metric across
    rounds: after ``patience`` skipped rounds in a row it restores the
    state from the newest complete checkpoint in ``ckpt_dir`` (the skip
    handles transients, the restore a wedged run). A clean round resets
    the streak. ``abstract_state`` is the state's structure (tensors or
    ``meta`` tensors, e.g. ``HotaSim.abstract_state()``); restored leaves
    go to ``device`` (default: their like leaf's)."""

    def __init__(self, ckpt_dir: str, abstract_state, device=None,
                 patience: int = 3):
        if patience < 1:
            raise ValueError(f"patience must be >= 1, got {patience}")
        self.ckpt_dir = ckpt_dir
        self.abstract_state = abstract_state
        self.device = device
        self.patience = patience
        self.streak = 0
        self.n_restores = 0

    def observe(self, skipped, state):
        """Feed one round's ``skipped`` metric; returns ``(state,
        restored)``: the restored state when the streak reached
        ``patience`` and a complete checkpoint exists, else ``state``
        untouched. Reads ``skipped`` on the host (one synchronization per
        round)."""
        if float(skipped) < 0.5:
            self.streak = 0
            return state, False
        self.streak += 1
        if self.streak < self.patience:
            return state, False
        self.streak = 0
        step = None if not self.ckpt_dir else latest_step(self.ckpt_dir)
        if step is None:          # nothing to restore from: keep going
            return state, False
        self.n_restores += 1
        return restore_checkpoint(self.ckpt_dir, step, self.abstract_state,
                                  device=self.device), True


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch-per-client", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--mesh", default="2,2,2",
                    help="clusters,clients,model (one process per position)")
    ap.add_argument("--weighting", default="fedgradnorm",
                    choices=["fedgradnorm", "equal"])
    ap.add_argument("--ota-mode", default="scatter",
                    choices=["scatter", "naive"])
    ap.add_argument("--no-ota", action="store_true")
    ap.add_argument("--ota-streaming", action="store_true",
                    help="simulator-only cluster-scan engine; the "
                         "distributed round rejects it with the reason "
                         "named (use --ota-sectioned here)")
    ap.add_argument("--ota-sectioned", action="store_true",
                    help="section-streaming slab aggregation: peak live "
                         "channel memory is one section, not the slab")
    ap.add_argument("--max-section-rows", type=int, default=0,
                    help="split packed sections above this many 128-lane "
                         "slab rows (0 = off); bounds --ota-sectioned's "
                         "peak section size")
    ap.add_argument("--memory-budget-mb", type=int, default=0,
                    help="aggregation working-set budget for the layout "
                         "autotuner (MB, 0 = unconstrained)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="save the FULL train state every K rounds "
                         "(0 = only the final omega snapshot)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--faults", action="store_true",
                    help="enable the fault-injection round path")
    ap.add_argument("--dropout", type=float, default=0.0,
                    help="per-client dropout rate")
    ap.add_argument("--blackout", type=float, default=0.0,
                    help="per-cluster blackout rate")
    ap.add_argument("--straggler", type=float, default=0.0,
                    help="per-client straggler rate")
    ap.add_argument("--staleness", type=int, default=1,
                    help="straggler staleness depth in rounds")
    ap.add_argument("--spike-norm", type=float, default=float("inf"),
                    help="skip a round whose aggregate grad norm exceeds "
                         "this")
    ap.add_argument("--guard-patience", type=int, default=3,
                    help="consecutive skipped rounds before the RoundGuard "
                         "restores from the latest checkpoint")
    ap.add_argument("--no-tune-layout", action="store_true",
                    help="skip the layout autotuner and keep FLConfig's "
                         "default packed layout")
    ap.add_argument("--layout-cache", default=None,
                    help="path of the persisted calibration cache "
                         "(default build/layout_tune.json or "
                         "$REPRO_TORCH_LAYOUT_CACHE; pass '' to disable "
                         "persistence)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: every rank on the card) or cpu")
    return ap


def _model(arch: str):
    return build_model(get_smoke_config(ALIASES.get(arch, arch)))


def _train_rank(mesh, args, fl: FLConfig, tcfg: TrainConfig):
    """One rank's run; returns its metrics per step, its final state and
    the checkpoint paths rank 0 wrote."""
    dev = mesh.device
    if dev.type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // mesh.size))
    lead = mesh.rank == 0
    model = _model(args.arch)
    cfg = model.cfg
    init_fn, step_fn, specs, batch_spec = make_hota_train_step(
        model, mesh, fl, tcfg, loss_kind="lm")
    state = init_fn(rng.PRNGKey(args.seed))
    guard = None
    if args.faults and args.ckpt_dir:
        guard = RoundGuard(args.ckpt_dir, global_like(state, specs, mesh),
                           device="cpu", patience=args.guard_patience)
    n_clients_total = mesh.shape["cluster"] * mesh.shape["client"]
    batch = n_clients_total * args.batch_per_client
    rows = shard_slices((batch,), batch_spec[0], mesh)
    batches = synthetic_lm_batches(cfg.vocab_size, batch, args.seq_len,
                                   seed=args.seed)
    key = rng.PRNGKey(args.seed + 1)
    out = {"metrics": [], "paths": []}
    t0 = time.time()
    for step in range(args.steps):
        toks, labs = next(batches)
        state, m = step_fn(state, toks[rows], labs[rows], key)
        m = {k: float(v) for k, v in m.items()}
        out["metrics"].append(m)
        if guard is not None:
            full, restored = guard.observe(m["skipped"], state)
            if restored:
                state = shard_state(full, specs, mesh, device=dev)
                if lead:
                    print(f"step {step:4d} RoundGuard: {args.guard_patience}"
                          f" consecutive skipped rounds — restored from "
                          f"checkpoint step {latest_step(args.ckpt_dir)}",
                          flush=True)
        if args.ckpt_dir and args.ckpt_every \
                and (step + 1) % args.ckpt_every == 0:
            full = hota_state_to_numpy(state, specs, mesh)
            if lead:
                out["paths"].append(save_checkpoint(
                    args.ckpt_dir, int(state.step), full,
                    {"arch": args.arch, "kind": "full_state"}))
            dist.barrier()      # every rank sees the complete checkpoint
        if lead and (step % 10 == 0 or step == args.steps - 1):
            faulty = (f" part {m['n_participants']:.0f}"
                      f" skip {m['skipped']:.0f}" if args.faults else "")
            print(f"step {step:4d} loss {m['loss']:.4f} "
                  f"p [{m['p_min']:.3f},{m['p_max']:.3f}] "
                  f"fgrad {m['fgrad']:.4f}{faulty} "
                  f"({(time.time() - t0) / (step + 1):.2f}s/step)",
                  flush=True)
    if args.ckpt_dir:
        omega = hota_state_to_numpy(state.omega, specs.omega, mesh)
        if lead:
            path = save_checkpoint(args.ckpt_dir, args.steps, omega,
                                   {"arch": args.arch})
            out["paths"].append(path)
            print("checkpoint:", path, flush=True)
    out["state"] = state
    return out


def main(argv=None):
    """Parse the flags, tune the layout, train on one process per mesh
    position; returns the ranks' results in rank order (each: its
    ``metrics`` per step, its final ``state`` and the checkpoint
    ``paths`` rank 0 wrote)."""
    args = parser().parse_args(argv)
    shape = tuple(int(x) for x in args.mesh.split(","))
    if len(shape) != len(MESH_AXES):
        raise SystemExit(f"--mesh takes clusters,clients,model, got "
                         f"{args.mesh!r}")
    dev = resolve_device(args.device)
    model = _model(args.arch)
    fl = FLConfig(n_clusters=shape[0], n_clients=shape[1],
                  weighting=args.weighting, ota=not args.no_ota,
                  ota_mode=args.ota_mode, noise_std=0.1,
                  ota_streaming=args.ota_streaming,
                  ota_sectioned=args.ota_sectioned,
                  max_section_rows=args.max_section_rows,
                  faults=args.faults, dropout_rate=args.dropout,
                  blackout_rate=args.blackout,
                  straggler_rate=args.straggler,
                  staleness_rounds=args.staleness,
                  spike_norm=args.spike_norm)
    tcfg = TrainConfig(lr=args.lr)
    if dev.type == "cuda":      # built once, before the ranks start
        from repro_torch.kernels import _build
        _build.library()
    explicit_layout = (args.ota_streaming or args.ota_sectioned
                       or bool(args.max_section_rows))
    if not args.no_tune_layout and not explicit_layout:
        # the {final, trunk} template the step builds its packer from, so
        # the tuned folds are the streams the run draws
        from repro_torch.common.layout_tune import layout_of, tuned_fl
        from repro_torch.models.params import abstract_params
        template = {"final": abstract_params(model.final_specs()),
                    "trunk": abstract_params(model.trunk_specs())}
        budget = args.memory_budget_mb * (1 << 20) or None
        fl = tuned_fl(fl, template, cache_path=args.layout_cache,
                      memory_budget_bytes=budget, device=dev)
        print(f"layout: {layout_of(fl).describe()}", flush=True)
    elif explicit_layout:
        from repro_torch.common.layout_tune import layout_of
        print(f"layout: {layout_of(fl).describe()} (explicit; "
              "autotuner skipped)", flush=True)
    return run_ranks(_train_rank, (args, fl, tcfg), shape=shape,
                     axes=MESH_AXES, device=str(dev))


if __name__ == "__main__":
    main()
