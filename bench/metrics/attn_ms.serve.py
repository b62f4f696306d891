"""Median over requests of the host milliseconds spent in the attention
blocks (``models/transformer.attn_apply``: norm, Q/K/V with their
casts, RoPE, K8, the cache build, O), the program's ``repro.tf.attn``
spans summed inside each ``repro.prefill`` span."""

from bench.lib import program_spans


def read(ctx):
    return program_spans.median_ms_per_request(ctx, "repro.tf.attn")
