"""The program's own spans in a traced window.

While ``torch.profiler`` records, the port marks its layers as
``repro.<name>`` ranges (``repro_torch/common/spans.py``). They land in
the trace beside the benchmark's ``bench.*`` ranges and the device's
ops, on the same clock, and ``DeviceTrace`` keeps them in ``host``.
This module reads them from a ``DeviceTrace``'s ``host``, ``ops`` and
``window``: the ranges of a name inside the window, the ranges of one
name inside each range of another (a span's parent is the range that
encloses it), the stretches with no device op while the host is inside
a span, and the runtime calls that block the host.

On a program without spans every reader finds no range and its metric
returns None.
"""
from __future__ import annotations

import bisect
import statistics
from typing import Iterable, List, Optional, Tuple

from bench.lib.trace import _merge

Range = Tuple[int, int]

# runtime calls that hold the host until the device catches up (a
# synchronize) or that may (an allocation or a free); kineto records them
# as host events (on an H100: cudaStreamSynchronize, cudaDeviceSynchronize
# and cudaMalloc in the cells' traces)
STALL_CALLS = ("cudaMalloc", "cudaFree")


def is_stall(name: str) -> bool:
    return name in STALL_CALLS or (name.startswith("cuda")
                                   and name.endswith("Synchronize"))


def ranges(trace, name: str) -> List[Range]:
    """The host ranges called ``name`` that lie inside the window, in
    order of their start."""
    t0, t1 = trace.window
    return sorted((s, e) for n, s, e in trace.host
                  if n == name and s >= t0 and e <= t1)


def inside(outer: List[Range], inner: Iterable[Range]) -> List[List[Range]]:
    """For each range of ``outer`` (sorted, disjoint: one thread's
    top-level spans), the ranges of ``inner`` that lie inside it."""
    starts = [s for s, _ in outer]
    out: List[List[Range]] = [[] for _ in outer]
    for s, e in inner:
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and e <= outer[i][1]:
            out[i].append((s, e))
    return out


def total_s(trace, name: str) -> Optional[float]:
    """Seconds the host spent inside ``name`` over the window; None when
    the trace holds no such range."""
    rs = ranges(trace, name)
    if not rs:
        return None
    return sum(e - s for s, e in rs) * 1e-9


def per_parent_s(trace, parent: str, child: str) -> List[float]:
    """Seconds of ``child`` ranges inside each ``parent`` range."""
    return [sum(e - s for s, e in kids) * 1e-9
            for kids in inside(ranges(trace, parent), ranges(trace, child))]


def ms_per_scenario_round(ctx, name: str) -> Optional[float]:
    """Host milliseconds inside ``name`` per scenario round of the
    window; None without rounds or ranges."""
    n = ctx.counts.get("scenario_rounds", 0)
    t = total_s(ctx.trace, name)
    if not n or t is None:
        return None
    return t / n * 1e3


def median_ms_per_request(ctx, name: str) -> Optional[float]:
    """Median over ``repro.prefill`` ranges of the host milliseconds
    inside their ``name`` ranges; None without requests."""
    per = per_parent_s(ctx.trace, "repro.prefill", name)
    if not per:
        return None
    return statistics.median(per) * 1e3


def _overlap(a: List[Range], b: List[Range]) -> int:
    """Length of the intersection of two merged, sorted interval lists."""
    i = j = tot = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            tot += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def idle_share(trace, name: str) -> Optional[float]:
    """Per cent of the window in which the host is inside ``name`` and no
    device op runs; None when the trace holds no device op or no such
    range."""
    t0, t1 = trace.window
    if not trace.ops or t1 <= t0:
        return None
    spans = _merge(ranges(trace, name))
    if not spans:
        return None
    busy = _merge((max(s, t0), min(e, t1)) for _, s, e in trace.ops)
    held = sum(e - s for s, e in spans)
    return 100.0 * (held - _overlap(spans, busy)) / (t1 - t0)


def stalls_per_range(trace, name: str) -> Optional[float]:
    """Mean count of blocking runtime calls inside each ``name`` range;
    None when the trace holds no device op or no such range."""
    if not trace.ops:
        return None
    outer = ranges(trace, name)
    if not outer:
        return None
    calls = [(s, e) for n, s, e in trace.host if is_stall(n)]
    return sum(len(c) for c in inside(outer, calls)) / len(outer)
