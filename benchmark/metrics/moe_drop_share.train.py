"""moe_drop_share.train: the share of the tokens the MoE switch routed
that were over their expert's capacity, from the program's counters
``moe_tokens_dropped_total`` and ``moe_tokens_routed_total``
(``mpi.trace.counters_snapshot()``), remat recomputes counted on both
sides.  The counters count while a profiler records or the flight
recorder is armed, and this reads their totals since the process
started, not a difference across the window: the share is the traced
window's only while the recorder is disarmed (no ``OMPI_TPU_TRACE=1``),
as the harness leaves it, so that nothing counts before the window.
Set-up's steps would count too with the recorder armed."""


def read(ctx):
    if ctx.kind != "train":
        return None
    from ompi_tpu_torch.mpi import trace

    snap = trace.counters_snapshot()
    routed = snap.get("moe_tokens_routed_total")
    dropped = snap.get("moe_tokens_dropped_total")
    if not routed or dropped is None:
        return None
    return 100.0 * dropped / routed
