"""Slab-layout constants shared with the JAX package's kernels.

The stream layout (section and leaf offsets, chunk quanta) is defined in
units of the TPU's (8, 128) tile, so the port keeps the same constants:
they fix where every parameter entry sits in its random stream, not how a
Hopper kernel tiles its work.
"""
from __future__ import annotations

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
