"""Median over requests of the host milliseconds spent in the MoE blocks
(``models/moe.moe_branch``: norm, routing, the routed experts' grouped
GEMMs and combine, the shared expert), the program's ``repro.moe`` spans
summed inside each ``repro.prefill`` span."""

from bench.lib import program_spans


def read(ctx):
    return program_spans.median_ms_per_request(ctx, "repro.moe")
