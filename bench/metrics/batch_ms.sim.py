"""Host milliseconds per scenario round of the batcher's draw and the
batch's copy to the card (``data/federated.FederatedBatcher.next_stacked``
and the host-to-device copy), from the benchmark's ``batch`` span."""


def read(ctx):
    n = ctx.counts.get("scenario_rounds", 0)
    if not n or "batch" not in ctx.spans:
        return None
    return sum(ctx.spans["batch"]) / n * 1e3
