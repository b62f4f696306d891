"""Collectives over the named axes of a ``Mesh``: the port's ``lax.psum``,
``pmean``, ``pmax``, ``psum_scatter(tiled=True)`` and
``all_gather(tiled=True)``, written on ``torch.distributed``
(``lax.axis_index`` is ``Mesh.axis_index``).

Each reduces over the process group of the mesh slice along the named
axes. Where several axes are named, a piece's place follows the axes'
order (major to minor), not the ranks' order, as in JAX: an all-gather
over ("client", "cluster") is client-major.

Every collective takes the rank's tensors where they lie: NCCL (one card
per rank) and gloo (ranks sharing a card, or on the CPU) both run
all-reduce, all-gather, reduce-scatter and broadcast on CUDA tensors,
gloo through its own host buffers (``chip_smoke.py`` checks that gloo
does). ``gather_to_host`` stages through the host under gloo, whose
gather takes host tensors only.

On a mesh without process groups whose device is ``meta`` (the dry
run's ``launch.mesh.make_production_mesh``), a collective runs nothing:
it records its kind, calls and result bytes in ``mesh.stats`` (when set)
and in the running cost trace (``common.cost_trace``), and returns a
``meta`` tensor of its result's shape, so one rank's step traces without
its peers.

The sweep banks' collectives over the "scenario" axis:
``all_gather_rows`` gathers a rank's (S/n, ...) metric rows of any
dtypes into the global (S, ...) ones in one call, ``broadcast`` hands one
scenario's state from its owner to every rank (``scenario_state``) and
``gather_to_host`` collects a banked state on one rank for a checkpoint.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.common import cost_trace
from repro_torch.sharding.mesh_utils import Mesh, _names


class MeshStats:
    """Wall seconds, calls and bytes of a rank's timed work, by kind:
    "collective" (every collective here) and "draw" (the stream draws of
    the slab backward, ``core.hota_slab``); on a dry mesh the calls and
    result bytes of each collective by its kind ("all-reduce",
    "all-gather", "reduce-scatter", "broadcast", "gather")."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}
        self.bytes: Dict[str, int] = {}


def timed(mesh: Mesh, kind: str, nbytes: int, fn):
    """``fn()``, timed into ``mesh.stats`` under ``kind`` when the mesh
    has stats (a device synchronize on each side, so the time is the
    work's own); with no stats, just ``fn()``."""
    st = mesh.stats
    if st is None:
        return fn()
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    t0 = time.perf_counter()
    out = fn()
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    st.seconds[kind] = st.seconds.get(kind, 0.0) + time.perf_counter() - t0
    st.calls[kind] = st.calls.get(kind, 0) + 1
    st.bytes[kind] = st.bytes.get(kind, 0) + nbytes
    return out


def _dry(mesh: Mesh) -> bool:
    """Whether collectives on ``mesh`` are recorded, not run (see the
    module docstring)."""
    return mesh.groups is None and mesh.device.type == "meta"


def _dry_run(mesh: Mesh, kind: str, src: torch.Tensor, shape=None,
             dtype=None) -> torch.Tensor:
    out = cost_trace.collective_on_meta(kind, src, shape, dtype)
    st = mesh.stats
    if st is not None:
        st.calls[kind] = st.calls.get(kind, 0) + 1
        st.bytes[kind] = st.bytes.get(kind, 0) + out.numel() * \
            out.element_size()
    return out


def psum(x: torch.Tensor, mesh: Mesh, axes, op=None) -> torch.Tensor:
    """Sum of ``x`` over the ranks along ``axes``: reduces the contiguous
    tensor ``x`` in place and returns it."""
    if not _names(axes) or mesh.axis_size(axes) == 1:
        return x
    if not x.is_contiguous():
        raise ValueError("psum reduces in place: pass a contiguous tensor")
    if _dry(mesh):
        return _dry_run(mesh, "all-reduce", x)
    group, _ = mesh.group(axes)
    op = dist.ReduceOp.SUM if op is None else op
    timed(mesh, "collective", x.numel() * x.element_size(),
           lambda: dist.all_reduce(x, op=op, group=group))
    return x


def pmean(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    return psum(x, mesh, axes) / mesh.axis_size(axes)


def pmax(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    return psum(x, mesh, axes, op=dist.ReduceOp.MAX)


def _order(mesh: Mesh, axes, members):
    """Group positions in the axes' order: entry i is the group position
    of the member whose index along ``axes`` is i."""
    pos = [0] * len(members)
    for p, r in enumerate(members):
        pos[mesh.axis_index(axes, r)] = p
    return pos


def all_gather(x: torch.Tensor, mesh: Mesh, axes, dim: int) -> torch.Tensor:
    """``lax.all_gather(x, axes, axis=dim, tiled=True)``: the pieces of
    every rank along ``axes`` concatenated along ``dim`` in the axes'
    order."""
    if not _names(axes) or mesh.axis_size(axes) == 1:
        return x
    if _dry(mesh):
        shape = list(x.shape)
        shape[dim] *= mesh.axis_size(axes)
        return _dry_run(mesh, "all-gather", x, shape)
    group, members = mesh.group(axes)
    k = len(members)
    src = x.contiguous().reshape(-1)
    buf = torch.empty(k * src.numel(), dtype=src.dtype, device=src.device)
    timed(mesh, "collective", buf.numel() * buf.element_size(),
           lambda: dist.all_gather_into_tensor(buf, src, group=group))
    pieces = buf.reshape((k,) + tuple(x.shape))[_order(mesh, axes, members)]
    shape = list(x.shape)
    shape[dim] *= k
    return pieces.movedim(0, dim).reshape(shape)


def reduce_scatter(x: torch.Tensor, mesh: Mesh, axes,
                   dim: int) -> torch.Tensor:
    """``lax.psum_scatter(x, axes, scatter_dimension=dim, tiled=True)``:
    the sum over the ranks along ``axes``, of which this rank keeps the
    piece along ``dim`` at its index along ``axes``."""
    if not _names(axes) or mesh.axis_size(axes) == 1:
        return x
    k = mesh.axis_size(axes)
    shape = list(x.shape)
    if shape[dim] % k:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"into {k} pieces")
    shape[dim] //= k
    if _dry(mesh):
        return _dry_run(mesh, "reduce-scatter", x, shape)
    group, members = mesh.group(axes)
    pieces = x.movedim(dim, 0).reshape((k, shape[dim]) + tuple(
        s for d, s in enumerate(x.shape) if d != dim))
    # group position p receives the piece at its member's axes index
    idx = [mesh.axis_index(axes, r) for r in members]
    if idx != list(range(k)):
        pieces = pieces[idx]
    src = pieces.contiguous().reshape(-1)
    out = torch.empty(src.numel() // k, dtype=src.dtype, device=src.device)
    timed(mesh, "collective", src.numel() * src.element_size(),
           lambda: dist.reduce_scatter_tensor(out, src, group=group))
    moved = (shape[dim],) + tuple(s for d, s in enumerate(shape) if d != dim)
    return out.reshape(moved).movedim(0, dim)


def all_gather_rows(xs: List[torch.Tensor], mesh: Mesh,
                    axes) -> List[torch.Tensor]:
    """``all_gather(x, mesh, axes, 0)`` of every tensor of ``xs`` (leading
    dims equal, any dtypes) in one call: the rows travel as bytes, so
    every value comes back bit for bit."""
    if not _names(axes) or mesh.axis_size(axes) == 1:
        return list(xs)
    rows = xs[0].shape[0]
    raw = [x.contiguous().reshape(rows, -1).view(torch.uint8) for x in xs]
    got = all_gather(torch.cat(raw, dim=1), mesh, axes, 0)
    out, at = [], 0
    for x, r in zip(xs, raw):
        piece = got[:, at:at + r.shape[1]].contiguous()
        out.append(piece.view(x.dtype).reshape(
            (got.shape[0],) + tuple(x.shape[1:])))
        at += r.shape[1]
    return out


def broadcast(x: torch.Tensor, mesh: Mesh, axes, index: int) -> torch.Tensor:
    """The tensor of the rank at ``index`` along ``axes`` (``x``'s shape
    and dtype on every rank), on every rank of the slice."""
    if not _names(axes) or mesh.axis_size(axes) == 1:
        return x
    if _dry(mesh):
        return _dry_run(mesh, "broadcast", x, x.shape)
    group, members = mesh.group(axes)
    src = next(r for r in members if mesh.axis_index(axes, r) == index)
    buf = x.contiguous().clone() if mesh.rank == src else torch.empty_like(
        x, memory_format=torch.contiguous_format)
    timed(mesh, "collective", buf.numel() * buf.element_size(),
          lambda: dist.broadcast(buf, src=src, group=group))
    return buf


def gather_to_host(x: torch.Tensor, mesh: Mesh, axes, dim: int,
                   root: int = 0) -> Optional[torch.Tensor]:
    """The pieces of every rank along ``axes`` concatenated along ``dim``
    in the axes' order, as a host tensor on the rank at index ``root``
    (None on the others): a banked state collected for a checkpoint."""
    if not _names(axes) or mesh.axis_size(axes) == 1:
        return x.detach().cpu()
    if _dry(mesh):
        shape = list(x.shape)
        shape[dim] *= mesh.axis_size(axes)
        return _dry_run(mesh, "gather", x, shape)
    group, members = mesh.group(axes)
    dst = next(r for r in members if mesh.axis_index(axes, r) == root)
    src = x.detach().contiguous()
    if mesh.backend != "nccl":
        src = src.cpu()
    bufs = ([torch.empty_like(src) for _ in members] if mesh.rank == dst
            else None)
    timed(mesh, "collective", src.numel() * src.element_size() * len(members),
          lambda: dist.gather(src, gather_list=bufs, dst=dst, group=group))
    if bufs is None:
        return None
    pieces = [bufs[p].cpu() for p in _order(mesh, axes, members)]
    return torch.cat(pieces, dim=dim)
