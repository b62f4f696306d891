"""The whole prefill step's share of the bfloat16 peak: the closed-form
model FLOPs of the requests in the traced window (projections, attention
in its window, the head on the last position) over their summed wall
time (issue to first token) times 989 TFLOP/s."""


def read(ctx):
    reqs = ctx.counts.get("requests", [])
    if not reqs:
        return None
    flops = sum(ctx.cost.prefill_flops(ctx.config, b, s) for b, s, _ in reqs)
    wall = sum(t for _, _, t in reqs)
    return 100.0 * flops / (wall * ctx.peaks.BF16_FLOPS)
