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
collective over the FL axes stays inside one slice of the others.

``make_production_mesh`` is the reference's (16, 16) or (2, 16, 16)
mesh of 256 or 512 cards as an abstract mesh on the ``meta`` device,
which the dry run (``launch.dryrun``) traces one rank's step on.

The scenario meshes: ``make_scenario_mesh`` lays a 1-D ("scenario",) mesh
over the world (``ShardedScenarioBank``), ``make_dist_scenario_mesh`` a
("scenario", "cluster", "client") one (``DistScenarioBank``), both on the
first ranks of the world as the reference takes the first devices: every
rank of the world calls them (group creation is collective), and a rank
past the mesh gets None. ``run_ranks(fn, shape=(R, C, N),
axes=("scenario", "cluster", "client"))`` starts a world on the whole
mesh.
"""
from __future__ import annotations

import atexit
import datetime
import itertools
import math
import multiprocessing
import multiprocessing.forkserver
import multiprocessing.reduction
import multiprocessing.resource_tracker
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.common.device import resolve_device
from repro_torch.sharding.mesh_utils import SCENARIO_AXIS, Mesh

DEFAULT_TIMEOUT_S = 300
# what every rank imports, loaded once in the fork server that starts
# the ranks
_PRELOAD = ("torch", "repro_torch.core.sweep", "repro_torch.core.paper_setup")


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production meshes as an abstract ``Mesh`` (rank 0's
    view, no process groups): (16, 16) ("data", "model") = 256 H100s, or
    with ``multi_pod`` (2, 16, 16) ("pod", "data", "model") = 512. Its
    device is ``meta``: the dry run traces one rank's step on it without
    storage, its collectives recorded and not run
    (``sharding.collectives``). ``sharding.fl_view`` refines its "data"
    axis into ("cluster", "client") over the same ranks in the same
    order."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, rank=0, device="meta")


def pick_backend(device, world_size: int) -> str:
    dev = torch.device(device)
    if (dev.type == "cuda" and dist.is_nccl_available()
            and torch.cuda.device_count() >= world_size):
        return "nccl"
    return "gloo"


def _build_groups(mesh: Mesh, member: bool = True):
    """One process group per (axis subset, slice). Every rank of the
    world creates every group in the same order, as ``new_group``
    requires, and keeps the ones that hold it (none where it is not a
    ``member`` of the mesh); a mesh on the whole world uses the world
    group for all its axes."""
    names = mesh.axis_names
    groups = {}
    for k in range(1, len(names) + 1):
        for axes in itertools.combinations(names, k):
            if k == len(names) and mesh.size == dist.get_world_size():
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
                if member and mesh.rank in ranks:
                    groups[frozenset(axes)] = (g, ranks)
    return groups


def _rank_device(dev: torch.device, backend: str, r: int) -> torch.device:
    """Rank ``r``'s device: its own card under NCCL, else ``cuda:0``."""
    if dev.type == "cuda":
        dev = torch.device("cuda", r if backend == "nccl" else 0)
        torch.cuda.set_device(dev)
    return dev


def _mesh_on_world(shape, axes, dev: torch.device):
    """This rank's view of a mesh laid on the first ``prod(shape)`` ranks
    of the world (None past them), its groups built on every rank."""
    r = dist.get_rank()
    size = math.prod(shape)
    member = r < size
    backend = dist.get_backend()
    mesh = Mesh(shape, axes, rank=r if member else 0,
                device=_rank_device(dev, backend, r), backend=backend)
    mesh.groups = _build_groups(mesh, member)
    # no rank may leave set-up (and perhaps exit) while another still
    # connects to it for a group
    dist.barrier()
    return mesh if member else None


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
    return _mesh_on_world(tuple(shape), axes, dev)


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_scenario_mesh(n_ranks=None, device="cuda"):
    """1-D ("scenario",) mesh for sharded sweep banks (DESIGN.md §3.8),
    on the first ``n_ranks`` ranks of this process's world (default: all
    of it). ``ShardedScenarioBank`` splits its (S,)-batched states and
    knob banks over it while batch and key stay whole on every rank.
    Without a world, this process alone is the mesh."""
    world = _world_size()
    n = world if n_ranks is None else int(n_ranks)
    if n < 1 or n > world:
        raise ValueError(
            f"make_scenario_mesh needs {n} ranks, but only {world} ranks "
            f"are in the world")
    dev = resolve_device(device)
    if not dist.is_initialized():
        return Mesh((1,), (SCENARIO_AXIS,), device=_rank_device(
            dev, "gloo", 0))
    return _mesh_on_world((n,), (SCENARIO_AXIS,), dev)


def make_dist_scenario_mesh(n_clusters: int, n_clients: int,
                            n_scenario_rows=None, device="cuda"):
    """2-D (scenario × client) mesh for distributed sweep banks
    (DESIGN.md §3.10): axes ("scenario", "cluster", "client"), row-major,
    so rank r is scenario row r // (C·N) and a row's FL groups are
    consecutive ranks. ``DistScenarioBank`` runs its rows' scenarios on
    the trailing FL axes. Takes ``n_scenario_rows`` rows (default: the
    world's ranks // (C·N)) on the first ranks of the world."""
    world = _world_size()
    per_row = n_clusters * n_clients
    rows = world // per_row if n_scenario_rows is None else n_scenario_rows
    need = rows * per_row
    if rows < 1 or need > world:
        raise ValueError(
            f"make_dist_scenario_mesh needs {per_row} ranks per scenario "
            f"row × {rows} rows = {need}, but only {world} ranks are in "
            f"the world")
    dev = resolve_device(device)
    shape, axes = (rows, n_clusters, n_clients), (SCENARIO_AXIS, "cluster",
                                                  "client")
    if not dist.is_initialized():
        return Mesh(shape, axes, device=_rank_device(dev, "gloo", 0))
    return _mesh_on_world(shape, axes, dev)


def _start_fork_server() -> None:
    """Start this process's fork server (once; later calls find it
    running) with ``_PRELOAD`` imported. It starts without
    ``OMP_NUM_THREADS``: the OpenMP runtime reads that once, when torch
    loads, so a rank forked from the server starts at the default thread
    count, and ``_rank_main`` applies the caller's value as a spawned
    process would have read it."""
    multiprocessing.set_forkserver_preload(list(_PRELOAD))
    omp = os.environ.pop("OMP_NUM_THREADS", None)
    try:
        multiprocessing.forkserver.ensure_running()
    finally:
        if omp is not None:
            os.environ["OMP_NUM_THREADS"] = omp
    atexit.unregister(stop_fork_server)
    atexit.register(stop_fork_server)


def stop_fork_server() -> None:
    """Stop the fork server and its resource tracker, and wait for both
    to exit (a no-op where none runs). Left alone, each exits only once
    this process has gone, the server after unloading torch, a second or
    more later; ``run_ranks`` registers this to run at exit, so no process
    it started outlives its caller."""
    multiprocessing.forkserver._forkserver._stop()
    multiprocessing.resource_tracker._resource_tracker._stop()


class _CallerFd:
    """One of the caller's file descriptors at the call, handed to a rank
    that the fork server starts (whose own are those of its start)."""

    def __init__(self, fd: int):
        self.fd = fd

    def __reduce__(self):
        # pickled while the rank starts: the descriptor travels with it
        return (_detach, (multiprocessing.reduction.DupFd(self.fd),))


def _detach(dup) -> int:
    return dup.detach()


def _rank_main(rank, fn, shape, axes, device, tmp, timeout_s, environ,
               out_fds):
    # the caller's environment and standard output and error at the call,
    # not the fork server's
    os.environ.clear()
    os.environ.update(environ)
    if environ.get("OMP_NUM_THREADS"):
        torch.set_num_threads(int(environ["OMP_NUM_THREADS"]))
    for target, fd in zip((1, 2), out_fds):
        os.dup2(fd, target)
        os.close(fd)
    mesh = make_debug_mesh(shape, axes, device, rank=rank,
                           init_method="file://" + os.path.join(tmp, "rdv"),
                           timeout_s=timeout_s)
    try:
        args = torch.load(os.path.join(tmp, "args.pt"), weights_only=False)
        result = fn(mesh, *args)
        torch.save(result, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, args=(), shape=(2, 2), axes=("cluster", "client"),
              device="cuda", timeout_s: int = DEFAULT_TIMEOUT_S):
    """Run ``fn(mesh, *args)`` in one process per mesh position
    and return the per-rank results in rank order (``fn`` must be a
    module-level function and its result hold tensors, numbers, lists and
    dicts). A rank that raises makes this raise; ``timeout_s`` bounds
    every collective. Build the CUDA kernels before calling it, or
    the ranks race to build them.

    The ranks are forked from a fork server that has imported torch and
    the port once (``_start_fork_server``), and each takes the caller's
    environment, standard output and error at the call; spawned afresh,
    each would import them again (``PERF.md`` has the start times of
    both)."""
    world = math.prod(shape)
    _start_fork_server()
    with tempfile.TemporaryDirectory() as tmp:
        # the args reach the ranks through a file: sent through the start
        # pipe, args larger than its buffer hold each start until the
        # previous rank has read them, so the ranks would start one after
        # another
        torch.save(tuple(args), os.path.join(tmp, "args.pt"))
        torch.multiprocessing.start_processes(
            _rank_main, args=(fn, tuple(shape), tuple(axes), device, tmp,
                              timeout_s, dict(os.environ),
                              (_CallerFd(1), _CallerFd(2))),
            nprocs=world, join=True, start_method="forkserver")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
