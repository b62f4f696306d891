"""Runtime calls that block the host (a synchronize, an allocation or a
free: ``bench/lib/program_spans.STALL_CALLS``) inside the MoE blocks'
routing (``repro.moe.route``: router logits, ranking, grouping and the
experts' offsets), per request: their count over the traced window's
``repro.prefill`` spans."""

from bench.lib import program_spans


def read(ctx):
    trace = ctx.trace
    if not trace.ops:
        return None
    requests = program_spans.ranges(trace, "repro.prefill")
    routes = program_spans.ranges(trace, "repro.moe.route")
    if not requests or not routes:
        return None
    calls = [(s, e) for n, s, e in trace.host if program_spans.is_stall(n)]
    inside = program_spans.inside(routes, calls)
    return sum(len(c) for c in inside) / len(requests)
