"""optimizer_phase_ms_per_step.train: device milliseconds a step of the
work launched under the program's span ``ompi.train.optimizer``: AdamW's
update and its application to the parameters (and to a master copy,
where the program keeps one)."""

from benchmark.metrics import _program_spans


def read(ctx):
    if ctx.kind != "train" or not ctx.trace.device:
        return None
    seconds = _program_spans.device_seconds(ctx.trace,
                                            "ompi.train.optimizer")
    return None if seconds is None else 1e3 * seconds / ctx.work["steps"]
