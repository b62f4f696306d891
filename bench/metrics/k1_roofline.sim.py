"""K1 (``kernels/ota_channel`` ``ota_client_fold``) as a share of its
byte bound: the closed-form bytes of the fold in the traced window over
the device time of its kernels times the HBM bandwidth."""

KERNELS = ("ota_client_fold_kernel",)


def read(ctx):
    t = ctx.trace.kernel_s(KERNELS)
    n = ctx.counts.get("scenario_rounds", 0)
    if t <= 0 or not n:
        return None
    c = ctx.counts
    nbytes = ctx.cost.k1_bytes(c["n_clusters"], c["n_clients"], c["dims"]) * n
    return 100.0 * nbytes / ctx.peaks.HBM_BYTES_PER_S / t
