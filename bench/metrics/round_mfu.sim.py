"""The scenario rounds' share of the float32 peak outside the tensor
cores (TF32 is off): the closed-form FLOPs of the rounds in the traced
window over the window's time times 67 TFLOP/s."""


def read(ctx):
    c = ctx.counts
    n = c.get("scenario_rounds", 0)
    if not n or ctx.trace.window_s <= 0:
        return None
    flops = ctx.cost.round_flops(c["n_clusters"], c["n_clients"],
                                 c["batch"], c["dims"], c["n_classes"]) * n
    return 100.0 * flops / (ctx.trace.window_s * ctx.peaks.FP32_FLOPS)
