"""K8 (``kernels/flash_attention``) as a share of its roofline: the
closed-form least time of the windowed causal attention of the requests
in the traced window (the larger of FLOPs over the bfloat16 peak and
bytes over the HBM bandwidth, layer by layer) over the device time of
the kernels named here."""

KERNELS = ("flash_hopper_kernel", "flash_bf16_kernel", "flash_f32_kernel")


def read(ctx):
    t = ctx.trace.kernel_s(KERNELS)
    reqs = ctx.counts.get("requests", [])
    if t <= 0 or not reqs:
        return None
    bound = sum(ctx.cost.attention_bound_s(ctx.config, b, s,
                                           ctx.peaks.BF16_FLOPS,
                                           ctx.peaks.HBM_BYTES_PER_S)
                for b, s, _ in reqs)
    return 100.0 * bound / t
