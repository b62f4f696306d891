"""Host spans and the reading of a profiler trace.

``Spans`` times the benchmark's own calls into the program's layers on
the host clock and, while a trace runs, marks them in it as
``bench.<name>`` ranges. ``DeviceTrace`` reads a ``torch.profiler``
trace: the device's kernels, copies and fills (``ops``), the host's
events, the traced window (the ``bench.window`` range), the device's busy
time (the union of its op intervals inside the window), the time of
kernels by name, the operations that took most time and the longest idle
gaps with what the host was doing in them.
"""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from typing import Dict, Iterable, List, Optional, Tuple

DEVICE_ACTIVITIES = ("kernel", "memcpy", "memset")


class Spans:
    def __init__(self):
        self.times: Dict[str, List[float]] = defaultdict(list)
        self.tracing = False

    @contextmanager
    def __call__(self, name: str):
        mark = nullcontext()
        if self.tracing:
            from torch.profiler import record_function
            mark = record_function("bench." + name)
        with mark:
            t0 = time.perf_counter()
            yield
            self.times[name].append(time.perf_counter() - t0)


def _device_op(ev) -> bool:
    """A kernel, copy or fill (not a range the host marked)."""
    if ev.is_user_annotation() or ev.name().startswith("bench."):
        return False
    try:
        act = str(ev.activity_type()).lower()
    except (AttributeError, TypeError, RuntimeError):   # builds without it
        return True
    return any(a in act for a in DEVICE_ACTIVITIES)


class DeviceTrace:
    """What one traced window shows. ``ops`` are (name, start_ns, end_ns)
    device intervals, ``host`` (name, start_ns, end_ns) host events."""

    def __init__(self, ops, host, window: Tuple[int, int]):
        self.window = window
        t0, t1 = window
        self.ops = [o for o in ops if o[2] > t0 and o[1] < t1]
        self.host = host
        self._merged = _merge([(max(s, t0), min(e, t1))
                               for _, s, e in self.ops])

    @classmethod
    def from_profiler(cls, prof) -> "DeviceTrace":
        from torch.autograd import DeviceType
        ops, host, window = [], [], None
        for ev in prof.profiler.kineto_results.events():
            start, dur = ev.start_ns(), ev.duration_ns()
            if ev.device_type() == DeviceType.CUDA:
                if _device_op(ev):
                    ops.append((ev.name(), start, start + dur))
                continue
            if ev.name() == "bench.window":
                window = (start, start + dur)
            host.append((ev.name(), start, start + dur))
        if window is None:
            raise RuntimeError("the trace holds no bench.window range")
        return cls(ops, host, window)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self._merged) * 1e-9

    def kernel_s(self, patterns: Iterable[str]) -> float:
        """Seconds of device ops whose name holds any of ``patterns``."""
        pats = tuple(patterns)
        return sum(e - s for n, s, e in self.ops
                   if any(p in n for p in pats)) * 1e-9

    def top_ops(self, k: int = 10) -> List[Tuple[str, float]]:
        tot: Dict[str, float] = defaultdict(float)
        for n, s, e in self.ops:
            tot[n] += (e - s) * 1e-9
        return sorted(tot.items(), key=lambda kv: -kv[1])[:k]

    def idle_gaps(self, k: int = 10) -> List[Tuple[str, float]]:
        """The ``k`` longest stretches of the window with no device op,
        each named by the benchmark span and the innermost host event
        that cover it (or overlap it most)."""
        t0, t1 = self.window
        edges = [t0] + [x for iv in self._merged for x in iv] + [t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        return [(self._host_label(a, b), (b - a) * 1e-9)
                for a, b in gaps[:k]]

    def _host_label(self, a: int, b: int) -> str:
        best_span = self._cover(a, b, lambda n: n.startswith("bench.")
                                and n != "bench.window")
        best_op = self._cover(a, b, lambda n: not n.startswith("bench."))
        return " / ".join(x for x in (best_span, best_op) if x) or "no host event"

    def _cover(self, a: int, b: int, keep) -> Optional[str]:
        best, best_key = None, None
        for n, s, e in self.host:
            if e <= a or s >= b or not keep(n):
                continue
            covers = s <= a and e >= b
            key = (covers, min(e, b) - max(s, a), -(e - s))
            if best_key is None or key > best_key:
                best, best_key = n, key
        return best


def _merge(ivs: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(ivs):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]
