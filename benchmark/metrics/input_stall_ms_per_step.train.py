"""input_stall_ms_per_step.train: milliseconds a step in which the device
ran nothing while the training thread waited for its next batch (the
program's span ``ompi.data.wait`` around the prefetch queue's get),
clipped to the traced window."""

from benchmark.metrics import _program_spans


def read(ctx):
    if ctx.kind != "train" or not ctx.trace.device:
        return None
    seconds = _program_spans.idle_seconds(ctx.trace, "ompi.data.wait")
    return None if seconds is None else 1e3 * seconds / ctx.work["steps"]
