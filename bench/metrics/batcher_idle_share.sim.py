"""Share of the traced window in which the host is inside the batcher's
draw (``data/federated.FederatedBatcher.next_stacked``, the program's
``repro.data.next_stacked`` spans) and no kernel, copy or fill runs on
the card."""

from bench.lib import program_spans


def read(ctx):
    return program_spans.idle_share(ctx.trace, "repro.data.next_stacked")
