"""Median over requests of the host milliseconds spent in the Mamba2
mixers (``models/mamba2.mamba2_mixer``: norm, in-projection, conv, the
SSD, gated norm, out-projection), the program's ``repro.mamba`` spans
summed inside each ``repro.prefill`` span."""

from bench.lib import program_spans


def read(ctx):
    return program_spans.median_ms_per_request(ctx, "repro.mamba")
