"""optimizer_ms_per_step.train: device milliseconds a step of the kernels
launched under the span around ``models.optim.AdamW.update_``."""


def read(ctx):
    if (ctx.kind != "train" or not ctx.trace.device
            or not ctx.trace.span_count("bench.optimizer")):
        return None
    return 1e3 * ctx.trace.device_seconds_under("bench.optimizer") / (
        ctx.work["steps"])
