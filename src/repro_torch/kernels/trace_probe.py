"""Where ``torch.profiler`` places a short trace's kernel records.

Usage, on a machine with a card (the kernels are built first)::

    python -m repro_torch.kernels.trace_probe [PAIRS]

runs PAIRS (default 40) pairs of traces of ``LAUNCHES`` K6 launches over
the Table-I slab (C = 2): one trace as the launches come, one with
``MARGIN_S`` of idle host time before and after them, as ``chip_smoke.py``
traces. Between pairs it traces ``FILLER`` small launches, as the smoke's
longer traces do. For each trace it prints the K6 records kept and where
the first and the last record lie from the first and the last launch on
the host, in µs (a negative offset is a kernel placed before the host
launched it), and which launches lost their record, in host order
(``record_runs``, which ``chip_smoke.py`` prints for a trace that lost
records).
"""
from __future__ import annotations

import sys
import time

import torch

LAUNCHES = 50
FILLER = 4000
MARGIN_S = 0.1
TABLE_I_PARAMS = 3_936_512


def record_runs(prof):
    """The kernel launches of a finished trace in host order, as runs of
    ``(kept, count)``: whether each launch's device record survived (its
    CUDA runtime launch and its kernel record share a correlation id)."""
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    kept = {e.correlation_id() for e in events if e.device_type() == cuda}
    launches = sorted((e.start_ns(), e.correlation_id()) for e in events
                      if e.device_type() != cuda
                      and "LaunchKernel" in e.name())
    runs = []
    for _, corr in launches:
        flag = corr in kept
        if runs and runs[-1][0] == flag:
            runs[-1][1] += 1
        else:
            runs.append([flag, 1])
    return [tuple(r) for r in runs]


def format_runs(runs) -> str:
    return ", ".join(f"{'kept' if k else 'lost'} {n}" for k, n in runs)


def _trace(launch, margin_s: float):
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        time.sleep(margin_s)
        for _ in range(LAUNCHES):
            launch()
        torch.cuda.synchronize()
        time.sleep(margin_s)
    cuda = torch.autograd.DeviceType.CUDA
    kern = [e for e in prof.events()
            if e.device_type == cuda and "mask_count" in e.name]
    host = [e for e in prof.events()
            if e.device_type != cuda and "LaunchKernel" in e.name]
    runs = format_runs(record_runs(prof))
    if not kern or not host:
        return len(kern), None, None, runs
    first = min(e.time_range.start for e in kern) - min(
        e.time_range.start for e in host)
    last = max(e.time_range.end for e in kern) - max(
        e.time_range.end for e in host)
    return len(kern), first, last, runs


def main(argv=None) -> None:
    from repro_torch.kernels import _build
    from repro_torch.kernels.ota_channel import ops as k1
    from repro_torch.kernels.ota_channel.ref import pass_probability
    args = sys.argv[1:] if argv is None else argv
    pairs = int(args[0]) if args else 40
    _build.library()
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    n, c = TABLE_I_PARAMS, 2
    x = torch.randn(n, generator=gen, device=dev)
    bits = torch.randint(-2 ** 31, 2 ** 31, (c, n), generator=gen,
                         device=dev, dtype=torch.int64).to(torch.int32)
    sig = torch.linspace(0.5, 2.0, c, device=dev)
    params = k1.mask_count_params(sig, 0.032, 1.0, 0.37, 0, None, c,
                                  device=dev)
    pp = pass_probability(params[:c], params[c])
    out, cnt = torch.empty(n, device=dev), torch.empty(n, device=dev)
    small = torch.zeros(1024, device=dev)

    def launch():
        k1.launch_mask_count(x, bits, params, pp, out, cnt)

    launch()
    torch.cuda.synchronize()
    short = {0.0: [], MARGIN_S: []}
    for i in range(pairs):
        row = []
        for margin in short:
            kept, first, last, runs = _trace(launch, margin)
            short[margin].append(kept)
            at = ("no record" if first is None
                  else f"first {first:+.1f} us, last {last:+.1f} us")
            at += f" ({runs})"
            row.append(f"margin {margin:.1f} s: {kept}/{LAUNCHES} kept, {at}")
        print(f"pair {i}: " + "; ".join(row), flush=True)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]):
            for _ in range(FILLER):
                small.add_(1.0)
            torch.cuda.synchronize()
    for margin, kept in short.items():
        print(f"margin {margin:.1f} s: {sum(k < LAUNCHES for k in kept)} of "
              f"{pairs} traces lost records, fewest kept {min(kept)}")


if __name__ == "__main__":
    main()
