"""moe_fwd_ms_per_step.train: device milliseconds a step of the kernels
launched under the span around ``parallel.moe.switch_moe`` (route,
dispatch, the experts' products, combine; the forward and its remat
recompute)."""


def read(ctx):
    if (ctx.kind != "train" or not ctx.trace.device
            or not ctx.trace.span_count("bench.moe")):
        return None
    return 1e3 * ctx.trace.device_seconds_under("bench.moe") / (
        ctx.work["steps"])
