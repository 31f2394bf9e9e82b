"""prefill_ms_per_call.decode: device milliseconds a decode call of the
work launched under the program's span ``ompi.decode.prefill`` (the
backbone over the prompts, the KV cache's allocation and fill, the first
token's unembed and pick)."""

from benchmark.metrics import _program_spans

SPAN = "ompi.decode.prefill"


def read(ctx):
    if ctx.kind != "decode" or not ctx.trace.device:
        return None
    seconds = _program_spans.device_seconds(ctx.trace, SPAN)
    if seconds is None:
        return None
    return 1e3 * seconds / _program_spans.count(ctx.trace, SPAN)
