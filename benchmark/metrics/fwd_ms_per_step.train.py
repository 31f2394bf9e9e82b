"""fwd_ms_per_step.train: device milliseconds a step of the work launched
under the program's span ``ompi.train.forward`` (the loss's forward: the
layers, the unembed and the chunked cross-entropy), on the thread that
opened it."""

from benchmark.metrics import _program_spans


def read(ctx):
    if ctx.kind != "train" or not ctx.trace.device:
        return None
    seconds = _program_spans.device_seconds(ctx.trace, "ompi.train.forward")
    return None if seconds is None else 1e3 * seconds / ctx.work["steps"]
