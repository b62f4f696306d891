"""Median host milliseconds from the call into the prefill step
(``launch/steps.make_prefill_step``) to its return, before the first
token is read back, from the benchmark's ``step`` span."""

import statistics


def read(ctx):
    spans = ctx.spans.get("step")
    if not spans:
        return None
    return statistics.median(spans) * 1e3
