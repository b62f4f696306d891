"""Median over requests of the host milliseconds spent in the MLP
blocks (``models/transformer.mlp_block_apply``: norm, the weights'
casts, up, GELU, down), the program's ``repro.tf.mlp`` spans summed
inside each ``repro.prefill`` span."""

from bench.lib import program_spans


def read(ctx):
    return program_spans.median_ms_per_request(ctx, "repro.tf.mlp")
