"""The FL mesh over the processes of one ``torch.distributed`` world.

Port of ``repro.sharding.mesh_utils`` for the distributed HOTA step. A
JAX mesh lays devices out on named axes and ``shard_map`` runs one
program per device; here one process per mesh position runs the step,
and ``Mesh`` is what each process knows of the layout: the axis names
and sizes, its own rank and coordinates, its device, and one process
group per axis slice that holds it (``collectives`` reduces over them).

Ranks follow the reference's device order, row-major over the axis
names: on a ("cluster", "client") mesh rank r is cluster r // N, client
r % N, as ``np.array(devs).reshape(C, N)`` lays devices out.

A leaf's layout across the mesh is written like a ``PartitionSpec``: a
tuple with one entry per leading dim, each None (not split) or an axis
name or tuple of names (split over those axes, major to minor);
``shard_slices`` cuts a rank's piece of a global array by it.

``fl_view`` refines a production mesh's "data" axis into ("cluster",
"client") over the same ranks in the same order, as the reference's does
over the same devices (``launch.mesh.make_production_mesh``).

The scenario axis (DESIGN.md §3.8) is orthogonal to the FL axes: a sweep
bank's (S,) leading dim lies on a ("scenario",) axis
(``launch.mesh.make_scenario_mesh``, or ahead of the FL axes in
``make_dist_scenario_mesh``). ``bank_sharding`` and
``replicated_sharding`` are the two layouts a sharded bank uses: its
(S, ...) leaves split over the scenario axis, and the batch and key
whole on every rank (common random numbers).
"""
from __future__ import annotations

import math
from typing import Dict, FrozenSet, Optional, Tuple

import numpy as np
import torch

FL_AXES = ("pod", "cluster", "client")
SCENARIO_AXIS = "scenario"


class Mesh:
    """Named axes over ``prod(shape)`` ranks, seen from rank ``rank``.

    ``groups`` maps a set of axis names to (process group, member ranks in
    ascending order) for the slice of the mesh that varies along those
    axes and holds this rank; ``launch.mesh.make_debug_mesh`` builds them.
    A mesh without groups knows the layout but runs no collective.
    ``stats``, when set to a ``collectives.MeshStats``, times every
    collective and stream draw (with a device synchronize on each side)."""

    def __init__(self, shape, axis_names, rank: int = 0, device="cpu",
                 backend: Optional[str] = None,
                 groups: Optional[Dict[FrozenSet[str], tuple]] = None):
        self.axis_names = tuple(axis_names)
        self.sizes = tuple(int(s) for s in shape)
        if len(self.sizes) != len(self.axis_names):
            raise ValueError(f"shape {shape} does not match axes {axis_names}")
        self.shape = dict(zip(self.axis_names, self.sizes))
        self.size = math.prod(self.sizes)
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} is not on a mesh of {self.size}")
        self.rank = int(rank)
        self.coords = dict(zip(self.axis_names, (
            int(i) for i in np.unravel_index(self.rank, self.sizes))))
        self.device = torch.device(device)
        self.backend = backend
        self.groups = groups
        self.stats = None

    def rank_of(self, coords: Dict[str, int]) -> int:
        return int(np.ravel_multi_index(
            [coords[a] for a in self.axis_names], self.sizes))

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in _names(axes))

    def axis_index(self, axes, rank: Optional[int] = None) -> int:
        """This rank's (or ``rank``'s) index along ``axes``, mixed radix in
        the order given (``lax.axis_index`` over a tuple of axes)."""
        coords = self.coords if rank is None else dict(zip(
            self.axis_names, np.unravel_index(rank, self.sizes)))
        idx = 0
        for a in _names(axes):
            idx = idx * self.shape[a] + int(coords[a])
        return idx

    def group(self, axes):
        """(process group, ascending member ranks) of the slice along
        ``axes`` that holds this rank."""
        if self.groups is None:
            raise RuntimeError("this mesh has no process groups (build it "
                               "with launch.mesh.make_debug_mesh)")
        return self.groups[frozenset(_names(axes))]


def _names(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def fl_view(mesh: Mesh, n_clients: int) -> Mesh:
    """A production mesh's 'data' axis refined into ('cluster', 'client'):
    the same ranks in the same order (a rank keeps its place in the
    row-major order, so a global layout is unchanged; only the scope of a
    collective differs). The view knows the layout and carries no
    process groups: a world that runs the refined mesh builds its own
    (``launch.mesh.make_debug_mesh`` with the refined shape)."""
    names = list(mesh.axis_names)
    if "data" not in names or "model" not in names:
        raise ValueError(f"fl_view needs 'data' and 'model' axes, got "
                         f"{mesh.axis_names}")
    if mesh.groups is not None:
        raise ValueError("fl_view refines a mesh without process groups")
    i = names.index("data")
    data = mesh.sizes[i]
    if data % n_clients:
        raise ValueError(f"a data axis of {data} does not split into "
                         f"clusters of {n_clients} clients")
    shape = list(mesh.sizes)
    view = Mesh(shape[:i] + [data // n_clients, n_clients] + shape[i + 1:],
                names[:i] + ["cluster", "client"] + names[i + 1:],
                rank=mesh.rank, device=mesh.device, backend=mesh.backend)
    view.stats = mesh.stats
    return view


def data_axes_of(mesh: Mesh) -> Tuple[str, ...]:
    """All batch-like axes of a mesh, in major-to-minor order."""
    return tuple(a for a in mesh.axis_names
                 if a in ("pod", "data", "cluster", "client"))


def flat_client_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Axes that enumerate FL clients (cluster x client, plus pod)."""
    return tuple(a for a in mesh.axis_names if a in FL_AXES)


def cluster_axes_of(mesh: Mesh) -> Tuple[str, ...]:
    """Axes that enumerate clusters (the OTA MAC sums over these)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "cluster"))


def total_clients(mesh: Mesh) -> int:
    n = 1
    for a in FL_AXES:
        n *= mesh.shape.get(a, 1)
    return n


def shard_slices(shape, spec, mesh: Mesh, rank: Optional[int] = None):
    """The index of ``rank``'s piece of a global array of ``shape`` laid
    out by ``spec`` (see the module docstring)."""
    out = []
    for d, size in enumerate(shape):
        axes = spec[d] if d < len(spec) else None
        if axes is None:
            out.append(slice(None))
            continue
        k = mesh.axis_size(axes)
        if size % k:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"into {k} pieces")
        i = mesh.axis_index(axes, rank)
        out.append(slice(i * (size // k), (i + 1) * (size // k)))
    return tuple(out)


# --------------------------------------------------------------------------
# the scenario axis (sharded sweep banks, DESIGN.md §3.8)
# --------------------------------------------------------------------------

def scenario_axis_size(mesh: Mesh) -> int:
    """Ranks along the scenario axis of a sweep mesh."""
    if SCENARIO_AXIS not in mesh.axis_names:
        raise ValueError(f"a sweep mesh needs a {SCENARIO_AXIS!r} axis, got "
                         f"{mesh.axis_names}")
    return mesh.shape[SCENARIO_AXIS]


def scenario_banked_spec(spec) -> tuple:
    """A single-scenario layout with the scenario axis prepended: the
    bank leaf (S, *dims) of an FL-sharded leaf laid out by ``spec``."""
    return (SCENARIO_AXIS,) + tuple(spec)


def prepend_axis(specs, axes):
    """A state's layout tree (dicts and named tuples of layout tuples; a
    None field stays None) with ``axes`` (an axis name, a tuple of them,
    or None for a dim no axis splits) laid on a new leading dim."""
    if specs is None:
        return None
    if isinstance(specs, dict):
        return {k: prepend_axis(v, axes) for k, v in specs.items()}
    if isinstance(specs, tuple) and hasattr(specs, "_fields"):
        return type(specs)(*[prepend_axis(v, axes) for v in specs])
    return (axes,) + tuple(specs)


def scenario_banked_tree(specs):
    """``scenario_banked_spec`` over a state's layout tree."""
    return prepend_axis(specs, SCENARIO_AXIS)


def bank_sharding(mesh: Mesh) -> tuple:
    """Layout of an (S, ...) bank leaf: its leading dim split over the
    scenario axis (each rank holds the rows of its S/n scenarios)."""
    scenario_axis_size(mesh)
    return (SCENARIO_AXIS,)


def replicated_sharding(mesh: Mesh) -> tuple:
    """Layout of the shared batch and key: every rank holds all of it,
    so every scenario shard reads the same data and keys."""
    return ()


def bank_rows(n_scenarios: int, mesh: Mesh) -> slice:
    """The rows of an (S, ...) bank leaf that this rank holds."""
    return shard_slices((n_scenarios,), bank_sharding(mesh), mesh)[0]
