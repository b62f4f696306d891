"""Per-rank cost of one step from the aten ops it dispatches (the port's
counterpart of ``repro.launch.hlo_cost``).

``OpCost`` is a ``TorchDispatchMode``: run a step under it (``trace``)
and it counts, over every op the step dispatches on the step's device:

* FLOPs of the matmul family (mm, bmm, addmm, baddbmm, addbmm, mv, addmv,
  dot: what ``torch.matmul``, ``F.linear`` and ``torch.einsum`` lower
  to; ``_grouped_mm``, the MoE's routed experts on the card), 2 x result
  elements x contracting size, as ``hlo_cost._dot_flops``
  counts a dot; other ops' FLOPs are not counted (matmul-dominated
  models), except a port kernel's (below);
* ``bytes``: operand plus result bytes of every op that moves data (a
  view, an ``empty`` and a ``detach`` move none), the all-ops upper bound;
* ``bytes_major``: the same over the op classes ``hlo_cost`` counts as
  major (dot, convolution, reduce, gather, scatter, sort, reduce-window,
  collectives, and the port's kernels, which are fused ops as an XLA
  fusion is), the fusion-optimistic count the memory term uses. Eager
  PyTorch runs each elementwise op as its own kernel, so ``bytes`` is
  what the card moves, where XLA would fuse the chain;
* collective bytes by kind (result bytes, as ``hlo_cost`` counts them),
  from the dry collectives of ``sharding.collectives``;
* memory: the bytes of the step's arguments (their storages, each once),
  of its outputs, of the outputs that alias an argument (a cache or state
  updated in place: ``alias_bytes``), and the peak of live storage the
  step allocated (``temp_bytes``; by storage, so a view counts once, and
  the outputs are in it while they are alive, since eager PyTorch
  allocates them during the step as it does any intermediate).

Eager PyTorch runs every layer of a model, so there is no while-loop
trip count to multiply by: every op is seen as often as it runs.

A launch of one of the port's kernels (``kernels/*/ops.py``) reaches the
trace through ``common.cost_trace.kernel_launch`` and is recorded as ONE
op with the kernel's operand and result bytes and the FLOPs of the
formula its bound uses (K1, K5 and K8; the byte-bound others count
none), on the card and on ``meta`` alike. The torch ops around it in its
wrapper dispatch under the trace on both. That is the fusion boundary
``hlo_cost`` counts. On ``meta`` (the dry run: no storage, nothing
computed) the kernel is not run, and its wrapper's allocated outputs
stand for its results; so a step traced on ``meta`` and on the card
counts the same FLOPs and the same launches.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Dict, Iterable, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.common import cost_trace


DOT_OPS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv", "dot",
           "matmul", "_grouped_mm"}
# the op classes hlo_cost.py counts as major, by aten name
MAJOR_OPS = DOT_OPS | {
    # convolution
    "convolution", "_convolution", "convolution_backward",
    # reduce
    "sum", "mean", "amax", "amin", "max", "min", "prod", "var", "var_mean",
    "std", "norm", "linalg_vector_norm", "logsumexp", "_softmax",
    "_log_softmax", "_softmax_backward_data", "_log_softmax_backward_data",
    "argmax", "argmin", "all", "any", "nll_loss_forward",
    "nll_loss_backward", "nll_loss2d_forward",
    # gather
    "index", "index_select", "gather", "embedding", "take_along_dim",
    # scatter (and the dynamic update slices)
    "scatter", "scatter_", "scatter_add", "scatter_add_", "scatter_reduce",
    "index_put", "index_put_", "_index_put_impl_", "index_add",
    "index_add_", "index_copy", "index_copy_", "masked_scatter",
    "slice_scatter", "select_scatter", "embedding_dense_backward",
    # sort
    "sort", "topk", "argsort",
    # reduce-window
    "cumsum", "cumsum_", "cumprod", "_cummax_helper",
}
# ops that move no data: allocation, aliasing, autograd bookkeeping
NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
            "new_empty_strided", "_unsafe_view", "detach", "alias",
            "lift_fresh", "set_", "resize_", "_local_scalar_dense"}


def _tensors(tree, out=None) -> List[torch.Tensor]:
    """The tensors of nested tuples, lists, dicts (and named tuples)."""
    if out is None:
        out = []
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _dot_flops(name: str, args, out) -> float:
    """2 x result elements x contracting size of a matmul-family op."""
    if name in ("addmm", "baddbmm", "addbmm", "addmv"):
        lhs = args[1]
    else:
        lhs = args[0]
    contracted = lhs.shape[-1] if lhs.dim() else 1
    res = out.numel()
    if name == "addbmm":          # sums the batch of products
        res *= lhs.shape[0]
    return 2.0 * res * contracted


@dataclass
class CostTotals:
    flops: float = 0.0         # dot FLOPs + the port's kernels' FLOPs
    dot_flops: float = 0.0     # the matmul family alone
    kernel_flops: float = 0.0  # the port's kernels (their bound formulas)
    bytes: float = 0.0         # every data-moving op (upper bound)
    bytes_major: float = 0.0   # the major op classes (memory term)
    n_ops: int = 0
    coll_bytes: Dict[str, float] = field(default_factory=dict)
    coll_calls: Dict[str, int] = field(default_factory=dict)
    kernels: Dict[str, int] = field(default_factory=dict)  # launches
    argument_bytes: int = 0
    output_bytes: int = 0
    alias_bytes: int = 0
    temp_bytes: int = 0        # peak live storage the step allocated

    @property
    def total_bytes(self) -> int:
        """The step's peak footprint: its arguments and the peak of what
        it allocated (the outputs included)."""
        return self.argument_bytes + self.temp_bytes


class OpCost(TorchDispatchMode):
    """Counts the ops dispatched on ``device`` (see the module docstring);
    ``trace`` runs a step under it."""

    def __init__(self, device):
        super().__init__()
        self.device = torch.device(device)
        self._type = self.device.type
        self.totals = CostTotals()
        self._known: set = set()       # storages alive outside the step
        self._live: Dict[int, int] = {}  # storage key -> bytes, allocated
        self._live_bytes = 0

    # ---------------- storage tracking ----------------
    def _track(self, outs: Iterable[torch.Tensor], ins) -> None:
        """Count the storages ``outs`` hold that no input, argument or
        earlier op's output holds: the step allocated them."""
        inputs = None
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._known or key in self._live:
                continue
            if inputs is None:
                inputs = {i.untyped_storage()._cdata for i in ins}
            if key in inputs:
                continue
            nb = st.nbytes()
            self._live[key] = nb
            self._live_bytes += nb
            self.totals.temp_bytes = max(self.totals.temp_bytes,
                                         self._live_bytes)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self._live_bytes -= self._live.pop(key, 0)

    # ---------------- recording ----------------
    def _record(self, ins, outs, flops: float, major: bool) -> None:
        """One op: ``ins`` and ``outs`` are the tensors on the device."""
        tot = self.totals
        nb = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        tot.n_ops += 1
        tot.bytes += nb
        if major:
            tot.bytes_major += nb
        tot.flops += flops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        dev = self._type
        ins = [t for t in _tensors((args, kwargs)) if t.device.type == dev]
        outs = [t for t in _tensors(out) if t.device.type == dev]
        if not ins and not outs:
            return out
        name = func.overloadpacket.__name__
        flops = 0.0
        if name in DOT_OPS:
            flops = _dot_flops(name, args, _tensors(out)[0])
            self.totals.dot_flops += flops
        if not (func.is_view or name in NO_BYTES):
            self._record(ins, outs, flops, name in MAJOR_OPS)
        self._track(outs, ins)
        return out

    def kernel(self, name: str, flops: float, ins, outs) -> None:
        """One launch of the port's kernel ``name``."""
        self.totals.kernel_flops += flops
        self.totals.kernels[name] = self.totals.kernels.get(name, 0) + 1
        self._record(ins, outs, flops, True)

    def collective(self, kind: str, src: torch.Tensor,
                   out: torch.Tensor) -> None:
        tot = self.totals
        tot.coll_bytes[kind] = tot.coll_bytes.get(kind, 0.0) + _nbytes(out)
        tot.coll_calls[kind] = tot.coll_calls.get(kind, 0) + 1
        self._record([src], [out], 0.0, True)

    def __enter__(self):
        self._prev = cost_trace.set_active(self)
        return super().__enter__()

    def __exit__(self, *exc):
        cost_trace.set_active(self._prev)
        return super().__exit__(*exc)


def _storages(tensors, device) -> Dict[int, int]:
    out = {}
    for t in tensors:
        if t.device.type == torch.device(device).type:
            st = t.untyped_storage()
            out[st._cdata] = st.nbytes()
    return out


def trace(fn, *args, device="meta", **kwargs):
    """(fn(*args, **kwargs), CostTotals) with the step run under
    ``OpCost(device)``. The arguments' storages on ``device`` (each once)
    are the argument bytes; the result's storages the output bytes, and
    those of them that are an argument's the alias bytes."""
    arg_st = _storages(_tensors((args, kwargs)), device)
    mode = OpCost(device)
    mode._known = set(arg_st)
    with mode:
        out = fn(*args, **kwargs)
    tot = mode.totals
    tot.argument_bytes = sum(arg_st.values())
    out_st = _storages(_tensors(out), device)
    tot.output_bytes = sum(out_st.values())
    tot.alias_bytes = sum(b for k, b in out_st.items() if k in arg_st)
    return out, tot

