"""The routed experts' grouped GEMMs (``models/moe._grouped_swiglu``:
``torch._grouped_mm``, CUTLASS's grouped kernel for sm90) as a share of
their roofline: the closed-form least time of the routed experts'
products of the requests in the traced window (per layer the larger of
their FLOPs over the bfloat16 peak and all experts' weights and the
routed rows over the HBM bandwidth) over the device time of the kernels
named here (the grouped GEMM and the setup kernel that lays out its
problem list)."""

KERNELS = ("GroupProblemShape", "prepare_grouped_gemm_data")


def read(ctx):
    t = ctx.trace.kernel_s(KERNELS)
    reqs = ctx.counts.get("requests", [])
    if t <= 0 or not reqs:
        return None
    bound = sum(ctx.cost.expert_gemm_bound_s(ctx.config, b, s,
                                             ctx.peaks.BF16_FLOPS,
                                             ctx.peaks.HBM_BYTES_PER_S)
                for b, s, _ in reqs)
    return 100.0 * bound / t
