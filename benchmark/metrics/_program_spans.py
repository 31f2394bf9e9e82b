"""The program's own spans in a traced run: ``record_function("ompi.<name>")``,
opened by the port's ``mpi.trace.model_span``, and the device work under
them.

Read from ``Trace.host``, which holds every ``user_annotation`` whatever
its prefix, and ``Trace.launch``.  A device event counts under a span
when the host call that launched it lies inside the span on the same
thread; for a span whose work another thread launches (the backward's:
the autograd engine's device thread), inside the span on any thread, an
HtoD copy apart (the input pipeline's, launched meanwhile).  A program
that opens no such span gives nothing (None), so the readers report
nothing for it.
"""

from __future__ import annotations

import bisect

from benchmark.trace import clip, union

#: the input pipeline's copies, which no span of the step launches
HTOD = "Memcpy HtoD"


def spans(trace, name: str) -> dict:
    """{host thread: sorted [(start, end)]} of the spans named ``name``."""
    out: dict = {}
    for thread, start, end, n in trace.host:
        if n == name:
            out.setdefault(thread, []).append((start, end))
    for lst in out.values():
        lst.sort()
    return out


def count(trace, name: str) -> int:
    return sum(len(lst) for lst in spans(trace, name).values())


def device_seconds(trace, name: str, any_thread: bool = False):
    """Device seconds of the work launched under the spans ``name``; None
    where the trace has none."""
    by_thread = spans(trace, name)
    if not by_thread:
        return None
    if any_thread:
        by_thread = {None: union(iv for lst in by_thread.values()
                                 for iv in lst)}
    starts = {t: [s for s, _ in lst] for t, lst in by_thread.items()}
    total = 0.0
    for start, end, op, corr in trace.device:
        hit = trace.launch.get(corr)
        if hit is None or (any_thread and op.startswith(HTOD)):
            continue
        thread, ts = hit
        key = None if any_thread else thread
        if key not in by_thread:
            continue
        i = bisect.bisect_right(starts[key], ts) - 1
        if i >= 0 and by_thread[key][i][1] >= ts:
            total += end - start
    return total * 1e-6


def idle_seconds(trace, name: str):
    """Seconds inside the spans ``name``, clipped to the window, in which
    the device ran nothing; None where the trace has none."""
    by_thread = spans(trace, name)
    if not by_thread:
        return None
    start, end, _ = trace.window()
    inside = clip(union(iv for lst in by_thread.values() for iv in lst),
                  start, end)
    busy = trace.busy_intervals()
    idle, j = 0.0, 0
    for s, e in inside:
        idle += e - s
        while j < len(busy) and busy[j][1] <= s:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < e:
            idle -= min(e, busy[k][1]) - max(s, busy[k][0])
            k += 1
    return idle * 1e-6
