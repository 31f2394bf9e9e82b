"""attn_fwd_roofline.decode: causal attention's forward against its roofline.

The least time of the work of every call of
``parallel.attention.local_attention`` in the traced window (the larger
of its FLOPs over the bf16 peak and its q, k, v, o and logsumexp bytes
over the HBM rate, from the call's shapes), over the device time of
every kernel launched under the span around it (the forward and any
remat recompute).  Whatever kernels do the work, the work counted is
the same.
"""

from benchmark import roofline


def read(ctx):
    calls = ctx.records.get("attention") or []
    seconds = ctx.trace.device_seconds_under("bench.attention")
    if ctx.kind != "decode" or ctx.peak is None or not calls or seconds <= 0:
        return None
    least = 0.0
    for c in calls:
        (b, t_q, h, d), (_, t_k, _, _) = c["shapes"][0], c["shapes"][1]
        flops, nbytes = roofline.attention_fwd(b, h, t_q, t_k, d,
                                               c["causal"], c["itemsize"])
        least += roofline.least_seconds(flops, nbytes, ctx.peak)
    return 100.0 * least / seconds
