"""The layers' matrix products (``models/transformer``: Q, K, V, O and
the MLP, with the head on the last position) as a share of their
roofline: the closed-form least time of the requests in the traced
window over the device time of the GEMM kernels named here."""

KERNELS = ("gemm", "Gemm", "GEMM", "nvjet", "xmma", "cutlass", "gemv")


def read(ctx):
    t = ctx.trace.kernel_s(KERNELS)
    reqs = ctx.counts.get("requests", [])
    if t <= 0 or not reqs:
        return None
    bound = sum(ctx.cost.gemm_bound_s(ctx.config, b, s, ctx.peaks.BF16_FLOPS,
                                      ctx.peaks.HBM_BYTES_PER_S)
                for b, s, _ in reqs)
    return 100.0 * bound / t
