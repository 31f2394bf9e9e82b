"""mfu.train: the whole training step's share of the card's bf16 peak.

Model FLOPs of the traced window's tokens, (6·N + 12·L·D·S) a token (N
the parameters a token uses), over the window's seconds times the peak.
"""

from benchmark import roofline


def read(ctx):
    if ctx.kind != "train" or ctx.peak is None:
        return None
    seconds = ctx.trace.window_seconds()
    flops = ctx.work["tokens"] * roofline.train_flops_per_token(
        ctx.model, int(ctx.mix["seq"]))
    return 100.0 * flops / (seconds * ctx.peak[0])
