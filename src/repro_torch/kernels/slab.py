"""Slab-layout constants and helpers shared with the JAX package's kernels.

The stream layout (section and leaf offsets, chunk quanta) is defined in
units of the TPU's (8, 128) tile, so the port keeps the same constants:
they fix where every parameter entry sits in its random stream, not how a
Hopper kernel tiles its work. ``pad_to_lanes``, ``flat_to_slab``,
``slab_to_flat`` and ``pad_axis`` are the reference's ravel, pad and
reshape helpers on tensors. The reference's ``on_tpu`` has no
counterpart: it only chooses Pallas's interpret mode, and a wrapper here
picks its kernel or its plain version by the device its tensors lie on.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

LANE = 128            # lane width: last dim of every slab
SUBLANE = 8           # f32 sublane packing: row-count multiple
ROW_QUANTUM = LANE * SUBLANE   # smallest lane-aligned flat section (1024)


def round_up(n: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``n`` (0 stays 0)."""
    return -(-n // m) * m


def slab_rows(n: int) -> int:
    """Rows of the (rows, LANE) slab that holds ``n`` flat entries (>= 8):
    the reference draws a padded slab's words for an arbitrary-shape
    tensor, so the port draws as many to get the same stream."""
    return max(SUBLANE, round_up(-(-n // LANE), SUBLANE))


def pad_to_lanes(x: torch.Tensor):
    """Ravel ``x`` into a zero-padded (rows, LANE) slab.

    Returns (slab, n) where ``n`` is the original element count:
    ``slab.reshape(-1)[:n].reshape(x.shape)`` round-trips exactly."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    flat = F.pad(flat, (0, slab_rows(n) * LANE - n))
    return flat.reshape(-1, LANE), n


def flat_to_slab(flat: torch.Tensor) -> torch.Tensor:
    """View a lane-aligned (..., P) flat tensor as (..., rows, LANE).

    ``P`` must be a multiple of ROW_QUANTUM (the flat packer guarantees
    it); leading batch dims (cluster or scenario axes) pass through."""
    p = flat.shape[-1]
    if p % ROW_QUANTUM:
        raise ValueError(f"a flat tensor of {tuple(flat.shape)} is not a "
                         f"multiple of {ROW_QUANTUM} entries")
    return flat.reshape(tuple(flat.shape[:-1]) + (p // LANE, LANE))


def slab_to_flat(slab: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`flat_to_slab`."""
    return slab.reshape(tuple(slab.shape[:-2])
                        + (slab.shape[-2] * slab.shape[-1],))


def pad_axis(x: torch.Tensor, axis: int, multiple: int) -> torch.Tensor:
    """Zero-pad one axis of ``x`` up to a multiple of ``multiple``."""
    pad = -x.shape[axis] % multiple
    if pad == 0:
        return x
    widths = [0, 0] * x.dim()
    # F.pad lists (left, right) pairs from the last dim backwards
    widths[2 * (x.dim() - 1 - axis % x.dim()) + 1] = pad
    return F.pad(x, widths)
