"""cached_step_ms.decode: device milliseconds a cached decode step, the
work launched under the program's span ``ompi.decode.step`` (every
layer's step and the unembed and pick: one token for each request of the
batch) over the steps."""

from benchmark.metrics import _program_spans

SPAN = "ompi.decode.step"


def read(ctx):
    if ctx.kind != "decode" or not ctx.trace.device:
        return None
    seconds = _program_spans.device_seconds(ctx.trace, SPAN)
    if seconds is None:
        return None
    return 1e3 * seconds / _program_spans.count(ctx.trace, SPAN)
