"""The FL mesh of the distributed step, one process per mesh position.

Port of ``repro.launch.mesh.make_debug_mesh``: where the reference lays a
small (cluster × client) mesh over forced host devices, the port starts
one process per position and ``make_debug_mesh`` joins it to the process
group and builds the mesh's axis groups. ``run_ranks`` starts the
processes, runs a function on the mesh in each and returns their results.

Backend: NCCL only when every rank has a card of its own; several ranks
sharing one card, and ranks on the CPU, use gloo (``pick_backend``). On
one card every rank runs its kernels on ``cuda:0`` with its own CUDA
context. A mesh may carry axes besides the FL ones (the training
launcher's "model" axis): every axis subset gets its groups, so a
collective over the FL axes stays inside one slice of the others. The
scenario meshes (``make_dist_scenario_mesh``, ``make_scenario_mesh``)
wait with the distributed scenario banks.
"""
from __future__ import annotations

import datetime
import itertools
import math
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.common.device import resolve_device
from repro_torch.sharding.mesh_utils import Mesh

DEFAULT_TIMEOUT_S = 300


def pick_backend(device, world_size: int) -> str:
    dev = torch.device(device)
    if (dev.type == "cuda" and dist.is_nccl_available()
            and torch.cuda.device_count() >= world_size):
        return "nccl"
    return "gloo"


def _build_groups(mesh: Mesh):
    """One process group per (axis subset, slice). Every rank creates
    every group in the same order, as ``new_group`` requires, and keeps
    the ones that hold it; the whole mesh is the world group."""
    names = mesh.axis_names
    groups = {}
    for k in range(1, len(names) + 1):
        for axes in itertools.combinations(names, k):
            if k == len(names):
                groups[frozenset(axes)] = (dist.group.WORLD,
                                           list(range(mesh.size)))
                continue
            rest = [a for a in names if a not in axes]
            for vals in itertools.product(*[range(mesh.shape[a])
                                            for a in rest]):
                fixed = dict(zip(rest, vals))
                ranks = sorted(
                    mesh.rank_of({**fixed, **dict(zip(axes, free))})
                    for free in itertools.product(
                        *[range(mesh.shape[a]) for a in axes]))
                g = dist.new_group(ranks)
                if mesh.rank in ranks:
                    groups[frozenset(axes)] = (g, ranks)
    return groups


def make_debug_mesh(shape=(2, 2), axes=("cluster", "client"), device="cuda",
                    *, rank=None, init_method=None,
                    timeout_s: int = DEFAULT_TIMEOUT_S) -> Mesh:
    """Join this process to a world of ``prod(shape)`` ranks (unless it
    already is in one) and return its view of the mesh. ``rank`` and
    ``init_method`` (e.g. ``file://<path>`` or ``tcp://localhost:<port>``)
    go to ``init_process_group`` with a ``timeout_s`` timeout, so a dead
    rank fails the run instead of hanging it."""
    world = math.prod(shape)
    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group(
            pick_backend(dev, world), init_method=init_method, rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
    if dist.get_world_size() != world:
        raise ValueError(f"a {shape} mesh needs {world} ranks, the process "
                         f"group has {dist.get_world_size()}")
    backend = dist.get_backend()
    r = dist.get_rank()
    if dev.type == "cuda":
        dev = torch.device("cuda", r if backend == "nccl" else 0)
        torch.cuda.set_device(dev)
    mesh = Mesh(shape, axes, rank=r, device=dev, backend=backend)
    mesh.groups = _build_groups(mesh)
    # no rank may leave set-up (and perhaps exit) while another still
    # connects to it for a group
    dist.barrier()
    return mesh


def _rank_main(rank, fn, args, shape, axes, device, tmp, timeout_s):
    mesh = make_debug_mesh(shape, axes, device, rank=rank,
                           init_method="file://" + os.path.join(tmp, "rdv"),
                           timeout_s=timeout_s)
    try:
        result = fn(mesh, *args)
        torch.save(result, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, args=(), shape=(2, 2), axes=("cluster", "client"),
              device="cuda", timeout_s: int = DEFAULT_TIMEOUT_S):
    """Run ``fn(mesh, *args)`` in one spawned process per mesh position
    and return the per-rank results in rank order (``fn`` must be a
    module-level function and its result hold tensors, numbers, lists and
    dicts). A rank that raises makes this raise; ``timeout_s`` bounds
    every collective. Build the CUDA kernels before calling it, or
    the ranks race to build them."""
    world = math.prod(shape)
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.spawn(
            _rank_main, args=(fn, args, tuple(shape), tuple(axes), device,
                              tmp, timeout_s),
            nprocs=world, join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
