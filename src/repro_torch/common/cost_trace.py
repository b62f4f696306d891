"""The hook through which kernel wrappers and collectives report to a
running cost trace (``launch.op_cost.OpCost``).

A trace of one step sees every aten op the step dispatches, but not a
kernel of the port, which a wrapper launches through ``ctypes``, nor a
collective on the dry mesh, which has no process group. Those report
here instead. A wrapper runs the same torch ops on ``meta`` tensors as on
the card's (its parameter rows, the products around its kernel, the
allocation of its outputs) and calls ``kernel_launch`` where it launches
its kernel: the running trace records one launch with the kernel's
operand and result bytes and FLOPs, on the card and on ``meta`` alike,
and on ``meta`` the kernel is not run (there is none to run; the outputs
the wrapper allocated stand for its results). ``collective_on_meta``
records a collective and returns a ``meta`` result. Outside a trace a
``meta`` tensor reaching either raises, as any device but the card's and
the CPU's does.
"""
from __future__ import annotations

from typing import Optional

import torch

_ACTIVE = None   # the OpCost mode tracing a step, else None


def active():
    return _ACTIVE


def set_active(trace) -> Optional[object]:
    """Make ``trace`` (or None) the running trace; returns the previous."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, trace
    return prev


def kernel_launch(name: str, flops: float, ins, outs) -> bool:
    """Report one launch of kernel ``name`` on operands ``ins`` and results
    ``outs`` doing ``flops`` to the running trace, if any. Returns whether
    the caller launches it: False on ``meta`` tensors."""
    meta = outs[0].device.type == "meta"
    if meta and _ACTIVE is None:
        raise ValueError(f"unsupported device meta for kernel {name} "
                         f"outside a cost trace")
    if _ACTIVE is not None:
        _ACTIVE.kernel(name, flops, ins, outs)
    return not meta


def collective_on_meta(kind: str, src: torch.Tensor, shape=None,
                       dtype=None) -> torch.Tensor:
    """The result of a collective on ``meta`` tensors: ``src`` itself for
    an in-place one (``shape`` None), else a new ``meta`` tensor of
    ``shape``; the collective (``kind``: "all-reduce", "all-gather",
    "reduce-scatter", "broadcast", "gather") recorded with its operand and
    result by the running trace."""
    if _ACTIVE is None:
        raise ValueError(f"unsupported device meta for a {kind} outside a "
                         f"cost trace")
    out = src if shape is None else torch.empty(
        tuple(shape), dtype=dtype or src.dtype, device="meta")
    _ACTIVE.collective(kind, src, out)
    return out
