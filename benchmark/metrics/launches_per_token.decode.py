"""launches_per_token.decode: kernel launches a cached decode step.

The kernels launched on the window's thread from the start of the first
cached step's first layer (the span around ``models.decode._step_layer``)
to the end of the call, over the call's cached steps.  A step makes one
token for each request of the batch.  A count, not a time.
"""


def read(ctx):
    spans = ctx.trace.spans.get("bench.step_layer")
    if ctx.kind != "decode" or not spans or not ctx.trace.device:
        return None
    _, end, thread = ctx.trace.window()
    start = min(s for lst in spans.values() for s, _ in lst)
    n = ctx.trace.kernels_launched_between(thread, start, end)
    return n / (ctx.work["calls"] * ctx.work["cached_steps"])
