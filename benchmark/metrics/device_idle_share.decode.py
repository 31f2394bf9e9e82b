"""device_idle_share.decode: the share of the traced window in which no
operation ran on the device: 1 − (the union of the device's kernel, copy
and set intervals ÷ the window)."""


def read(ctx):
    if ctx.kind != "decode" or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_seconds()
                    / ctx.trace.window_seconds())
