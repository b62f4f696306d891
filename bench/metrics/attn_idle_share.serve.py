"""Share of the traced window in which the host is inside an attention
block (the program's ``repro.tf.attn`` spans) and no kernel, copy or
fill runs on the card."""

from bench.lib import program_spans


def read(ctx):
    return program_spans.idle_share(ctx.trace, "repro.tf.attn")
