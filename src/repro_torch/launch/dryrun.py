"""Production-mesh dry run (port of ``repro.launch.dryrun``).

For every (architecture x input shape x mesh) combination, trace rank 0's
real step on the production mesh (``launch.mesh.make_production_mesh``:
256 or 512 H100s) with ``meta`` tensors, then record:

* memory per device: the rank's arguments, outputs, the aliased state or
  cache, and the peak of what the step allocates (``launch.cost_analysis
  .memory_summary``), against the card's 80 GB;
* FLOPs, bytes and collective bytes per device (``launch.op_cost``);
* the roofline terms and the dominant one (``launch.cost_analysis``).

It runs on ``meta`` and allocates nothing: storage-free stand-ins go
through the real step, its collectives are recorded and not run
(``sharding.collectives``), and a call into a kernel is recorded as one
launch. That is how the reference's dry run works too (``jax.jit(...)
.lower`` on ``ShapeDtypeStruct``s, then XLA's analyses), not a CPU
fallback: every number is a prediction for the cluster, not a
measurement.

The port's train step (``core.hota_step``) shards ω over the FL data axes
(FSDP) and runs the "model" axis's ranks as replicas; its serve step runs
a rank's piece of the batch (the rules' "batch" layout) against whole
weights. Beside what the rank holds, each result gives the bytes per
device the reference's rule-based layout would hold (``state_bytes_rules``:
``hota_state_shardings`` or ``launch.steps.param_specs_tree`` and
``cache_specs_tree``).

Usage:
    python -m repro_torch.launch.dryrun --arch starcoder2-3b --shape train_4k
    python -m repro_torch.launch.dryrun --arch all --shape all \
        [--multi-pod both]
Results land in results/dryrun_torch/<arch>__<shape>__<mesh>.json.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch

from repro_torch import rng
from repro_torch.common.config import (
    INPUT_SHAPES, FLConfig, InputShape, TrainConfig,
)
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.configs import ALIASES, ARCH_IDS, get_config
from repro_torch.core.hota_step import HotaState, make_hota_step_parts
from repro_torch.launch import cost_analysis, op_cost
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import (
    abstract_serve_state, cache_specs_tree, input_specs, make_decode_step,
    make_prefill_step, param_specs_tree, serve_rules_for,
)
from repro_torch.models.model import build_model
from repro_torch.models.params import logical_axes, param_count, spec_shapes
from repro_torch.optim.adam import AdamState
from repro_torch.sharding.collectives import MeshStats
from repro_torch.sharding.mesh_utils import Mesh, fl_view
from repro_torch.sharding.rules import TRAIN_RULES, spec_for

N_CLIENTS = 4
RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

SERVE_ARCH_OVERRIDES = dict(compute_dtype="bfloat16", remat_policy="none")
TRAIN_ARCH_OVERRIDES = dict(compute_dtype="bfloat16",
                            remat_policy="nothing_saveable")


def _mesh_tag(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def active_params(cfg) -> float:
    """Parameter count with MoE experts scaled to top-k/E (6·N_active·D)."""
    model = build_model(cfg)
    total = param_count({"t": model.trunk_specs(), "f": model.final_specs()})
    if cfg.moe is not None:
        from repro_torch.models.moe import moe_specs
        expert_per_layer = sum(
            math.prod(s.shape) for k, s in moe_specs(cfg).items()
            if k.startswith("w_"))
        inactive = expert_per_layer * cfg.n_layers * (
            1.0 - cfg.moe.top_k / cfg.moe.n_experts)
        total -= inactive
    return float(total)


def _pick_microbatches(cfg, shape: InputShape, n_total_clients: int) -> int:
    """Smallest power-of-2 microbatch count keeping saved layer-boundary
    activations (L x B_mb x S x d x 2B) under ~4 GiB per device (the
    reference's rule, kept for parity)."""
    b_loc = shape.global_batch // n_total_clients
    budget = 4 * 2**30
    act = cfg.n_layers * b_loc * shape.seq_len * cfg.d_model * 2
    mb = 1
    while act / mb > budget and mb < b_loc:
        mb *= 2
    return mb


def _client_axes(mesh: Mesh):
    return tuple(a for a in mesh.axis_names
                 if a in ("pod", "cluster", "client"))


def hota_state_shardings(model, mesh: Mesh, n_out=None) -> HotaState:
    """The reference's full (FL + model axes) layout of the HotaState, as
    layout tuples: ω by ``TRAIN_RULES`` with its FSDP pieces client-major,
    the Adam moments as ω, the heads with a leading "clients" dim, the
    client-indexed scalars over the client axes."""
    client_axes = _client_axes(mesh)

    def omega_spec(axes, shape):
        sp = spec_for(axes, TRAIN_RULES, shape, mesh)
        # client-major FSDP piece order (the scatter regions' alignment)
        return tuple(("client", "cluster") if p == ("cluster", "client")
                     else p for p in sp)

    def tree_spec(specs):
        return tree_map(omega_spec, logical_axes(specs), spec_shapes(specs))

    omega = {"final": tree_spec(model.final_specs()),
             "trunk": tree_spec(model.trunk_specs())}
    n_cl = mesh.axis_size(client_axes)
    head_specs = model.head_specs(n_out)
    heads = tree_map(
        lambda a, s: spec_for(("clients",) + a, TRAIN_RULES, (n_cl,) + s,
                              mesh),
        logical_axes(head_specs), spec_shapes(head_specs))
    sc = (client_axes,)
    return HotaState(
        omega=omega, opt=AdamState(step=(), mu=omega, nu=omega),
        heads=heads, head_opt=AdamState(step=(), mu=heads, nu=heads),
        p=sc, fgn_mu=sc, fgn_nu=sc, fgn_t=(), f0=sc, step=())


def _piece_bytes(shape, elt: int, spec, mesh: Mesh) -> int:
    """Bytes of one rank's piece of a global array laid out by ``spec``."""
    n = math.prod(shape)
    for axes in spec:
        if axes is not None:
            n //= mesh.axis_size(axes)
    return n * elt


def _rules_bytes(shapes_tree, layouts_tree, elt: int, mesh: Mesh) -> int:
    return sum(_piece_bytes(s, elt, l, mesh) for s, l in zip(
        tree_leaves(shapes_tree), tree_leaves(layouts_tree)))


def _n_total_clients(mesh: Mesh) -> int:
    return mesh.axis_size(_client_axes(mesh))


def train_setup(cfg, mesh_prod: Mesh, shape: InputShape, seed: int = 0):
    """(step, (state, tokens, labels, key), info) of rank 0's train step on
    the FL view of ``mesh_prod``, on the mesh's device (``meta``: the
    rank's state from the step's ``abstract_fn``); the round key of
    ``seed`` is a host key, as the step takes it."""
    cfg = cfg.replace(**TRAIN_ARCH_OVERRIDES)
    model = build_model(cfg)
    mesh = fl_view(mesh_prod, N_CLIENTS)
    n_cl = _n_total_clients(mesh)
    fl = FLConfig(n_clients=N_CLIENTS, ota_mode="scatter",
                  microbatches=_pick_microbatches(cfg, shape, n_cl))
    tcfg = TrainConfig(lr=3e-4, global_batch=shape.global_batch,
                       seq_len=shape.seq_len, fl=fl)
    # the card's count mode (``hota_slab.default_count_mode``)
    parts = make_hota_step_parts(model, mesh, fl, tcfg, loss_kind="lm",
                                 count_mode="local")
    # the step counter is a host integer the step reads (its round key)
    state = parts.abstract_fn()._replace(
        step=torch.zeros((), dtype=torch.int32))
    ins = input_specs(cfg, shape)
    b_loc = shape.global_batch // n_cl
    tokens = ins["tokens"][:b_loc]
    labels = ins["labels"][:b_loc]
    key = rng.PRNGKey(seed)

    def step(state, tokens, labels, key):
        return parts.step(state, tokens, labels, key, parts.chan_all, None,
                          fast=parts.has_fast)

    omega_shapes = {"final": spec_shapes(model.final_specs()),
                    "trunk": spec_shapes(model.trunk_specs())}
    lay = hota_state_shardings(model, mesh)
    # ω and its two Adam moments in float32, under the reference's layout
    rules_bytes = 3 * _rules_bytes(omega_shapes, lay.omega, 4, mesh)
    info = {"mesh_view": dict(zip(mesh.axis_names, mesh.sizes)),
            "microbatches": fl.microbatches, "local_batch": b_loc,
            "state_bytes_rules": rules_bytes, "mesh": mesh}
    return step, (state, tokens, labels, key), info


def serve_setup(cfg, mesh: Mesh, shape: InputShape, batch=None):
    """(step, args, info) of a rank's serve step: prefill or one decode
    step on the rank's piece of the batch (``batch`` overrides it), the
    arguments as ``meta`` tensors (``abstract_serve_state``)."""
    cfg = cfg.replace(**SERVE_ARCH_OVERRIDES)
    model = build_model(cfg)
    rules = serve_rules_for(shape)
    b_spec = spec_for(("batch",), rules, (shape.global_batch,), mesh)[0]
    if batch is None:
        batch = shape.global_batch // (
            1 if b_spec is None else mesh.axis_size(b_spec))
    local = InputShape(shape.name, shape.seq_len, batch, shape.kind)
    backbone, head, cache = abstract_serve_state(model, local)
    ins = input_specs(cfg, local)
    pspecs = param_specs_tree(model, rules, mesh, include_head=True)
    shapes = {"backbone": {"trunk": spec_shapes(model.trunk_specs()),
                           "final": spec_shapes(model.final_specs())},
              "head": spec_shapes(model.head_specs())}
    rules_bytes = _rules_bytes(shapes, pspecs, 2, mesh)
    if shape.kind == "prefill":
        step = make_prefill_step(model, cache_len=shape.seq_len + 1)
        args = (backbone, head, ins["tokens"])
    else:
        step = make_decode_step(model)
        args = (backbone, head, cache, ins["tokens"], ins["positions"])
        # the reference's cache layout holds the global batch's cache
        gcache = abstract_serve_state(model, shape)[2]
        csp = cache_specs_tree(model, gcache, rules, mesh)
        rules_bytes += sum(
            _piece_bytes(tuple(t.shape), t.element_size(), l, mesh)
            for t, l in zip(tree_leaves(gcache), tree_leaves(csp)))
    info = {"local_batch": batch, "state_bytes_rules": rules_bytes,
            "mesh": mesh}
    return step, args, info


def trace_train(cfg, mesh_prod: Mesh, shape: InputShape):
    """(CostTotals, info) of rank 0's train step traced on ``meta`` (the
    reference's ``lower_train``)."""
    step, args, info = train_setup(cfg, mesh_prod, shape)
    info.pop("mesh").stats = MeshStats()
    return op_cost.trace(step, *args, device="meta")[1], info


def trace_serve(cfg, mesh: Mesh, shape: InputShape):
    """(CostTotals, info) of a rank's serve step traced on ``meta`` (the
    reference's ``lower_serve``)."""
    step, args, info = serve_setup(cfg, mesh, shape)
    info.pop("mesh").stats = MeshStats()
    return op_cost.trace(step, *args, device="meta")[1], info


def run_pair(arch: str, shape_name: str, multi_pod: bool,
             out_dir: str = RESULTS_DIR, force: bool = False) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{arch}__{shape_name}__{_mesh_tag(multi_pod)}"
    out_path = os.path.join(out_dir, tag + ".json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)

    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    result = {"arch": arch, "shape": shape_name,
              "mesh": _mesh_tag(multi_pod), "status": "?"}

    if shape_name == "long_500k" and not cfg.is_subquadratic:
        result["status"] = "skipped"
        result["reason"] = ("pure full-attention arch; long_500k requires "
                            "sub-quadratic attention (DESIGN.md §3.6)")
        _write(out_path, result)
        return result

    t0 = time.time()
    try:
        mesh_prod = make_production_mesh(multi_pod=multi_pod)
        n_dev = mesh_prod.size
        trace = trace_train if shape.kind == "train" else trace_serve
        totals, info = trace(cfg, mesh_prod, shape)
        t_trace = time.time() - t0

        mem = cost_analysis.memory_summary(totals)
        roof = cost_analysis.extract_roofline(totals)
        n_tok = shape.global_batch * (shape.seq_len
                                      if shape.kind != "decode" else 1)
        mf = cost_analysis.model_flops(active_params(cfg), n_tok,
                                       shape.kind == "train")
        terms = {"compute_s": roof.compute_s, "memory_s": roof.memory_s,
                 "collective_s": roof.collective_s}
        result.update({
            "status": "ok",
            "n_devices": n_dev,
            "trace_s": round(t_trace, 1),
            **info,
            "memory": mem,
            "fits_80gb": mem["total_bytes"] <= cost_analysis.H100_HBM_BYTES,
            "flops_per_device": totals.flops,
            "dot_flops_per_device": totals.dot_flops,
            "kernel_flops_per_device": totals.kernel_flops,
            "bytes_per_device": totals.bytes_major,
            "bytes_per_device_upper": totals.bytes,
            "memory_s_upper": totals.bytes / cost_analysis.HBM_BW,
            "collective_bytes": dict(totals.coll_bytes),
            "collective_calls": dict(totals.coll_calls),
            "kernel_launches": dict(totals.kernels),
            "n_ops": totals.n_ops,
            "roofline": {**terms, "dominant": max(
                terms, key=terms.get).replace("_s", "")},
            "model_flops_global": mf,
            "traced_flops_global": totals.flops * n_dev,
            "useful_flops_ratio": mf / max(totals.flops * n_dev, 1.0),
        })
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        result["status"] = "error"
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-4000:]
    _write(out_path, result)
    return result


def _write(path: str, obj: dict):
    with open(path, "w") as f:
        json.dump(obj, f, indent=2, default=float)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", choices=["on", "off", "both"],
                    default="off")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out-dir", default=RESULTS_DIR)
    args = ap.parse_args(argv)

    archs = ([a for a in ARCH_IDS if a != "paper_mlp"]
             if args.arch == "all" else [ALIASES.get(args.arch, args.arch)])
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    pods = {"on": [True], "off": [False],
            "both": [False, True]}[args.multi_pod]

    for arch in archs:
        for shape in shapes:
            for mp in pods:
                r = run_pair(arch, shape, mp, args.out_dir, args.force)
                dom = r.get("roofline", {}).get("dominant", "-")
                mem = r.get("memory", {}).get("total_bytes", 0) / 2**30
                print(f"{arch:20s} {shape:12s} {_mesh_tag(mp):10s} "
                      f"{r['status']:8s} dom={dom} mem={mem:.2f}GiB "
                      f"trace={r.get('trace_s', 0)}s", flush=True)


if __name__ == "__main__":
    main()
