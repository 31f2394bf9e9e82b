"""mfu.decode: the decode window's share of the card's bf16 peak.

Model FLOPs of the window's calls (the prefill's products and causal
attention, the cached steps' 2·N a token and attention over the keys
cached so far) over the window's seconds times the peak.
"""

from benchmark import roofline


def read(ctx):
    if ctx.kind != "decode" or ctx.peak is None:
        return None
    mix = ctx.mix
    flops = ctx.work["calls"] * roofline.decode_flops(
        ctx.model, int(mix["batch"]), int(mix["prompt"]),
        int(mix["new_tokens"]))
    return 100.0 * flops / (ctx.trace.window_seconds() * ctx.peak[0])
