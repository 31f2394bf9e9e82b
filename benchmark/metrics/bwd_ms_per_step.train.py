"""bwd_ms_per_step.train: device milliseconds a step of the work launched,
on any thread, while the program's span ``ompi.train.backward`` (the
``torch.autograd.grad`` call) is open: the autograd engine's device
thread launches the backward's kernels and the remat recompute.  HtoD
copies (the input pipeline's) are left out."""

from benchmark.metrics import _program_spans


def read(ctx):
    if ctx.kind != "train" or not ctx.trace.device:
        return None
    seconds = _program_spans.device_seconds(
        ctx.trace, "ompi.train.backward", any_thread=True)
    return None if seconds is None else 1e3 * seconds / ctx.work["steps"]
