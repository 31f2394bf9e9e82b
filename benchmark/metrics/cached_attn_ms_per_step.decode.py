"""cached_attn_ms_per_step.decode: device milliseconds a cached decode step
of the work launched under the program's span ``ompi.decode.attend``, in
every layer: the cache write, the cache's f32 cast and layout copies,
the mask, the softmax and both einsums."""

from benchmark.metrics import _program_spans


def read(ctx):
    if ctx.kind != "decode" or not ctx.trace.device:
        return None
    seconds = _program_spans.device_seconds(ctx.trace, "ompi.decode.attend")
    steps = _program_spans.count(ctx.trace, "ompi.decode.step")
    if seconds is None or not steps:
        return None
    return 1e3 * seconds / steps
