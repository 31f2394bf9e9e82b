"""Reading a ``torch.profiler`` Chrome trace: device intervals, the host
spans the harness opened (``record_function`` names that start with
``bench.``), and which span launched each kernel.

A device event (a kernel, a memcpy or a memset) carries the correlation
id of the host call that launched it; that call carries its thread and
host time.  A kernel is "under" a span when its launch lies inside a
span of that name on the same host thread, so work that the autograd
engine's thread launches (a remat recompute) is found under the span
that thread opened.
"""

from __future__ import annotations

import bisect
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation") + LAUNCH_CATS
SPAN_PREFIX = "bench."
WINDOW = "bench.window"
#: how many of the longest idle gaps the breakdown names
GAPS_LABELLED = 200


def union(intervals) -> list:
    """Sorted, merged (start, end) intervals of the given ones."""
    out: list = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, start: float, end: float) -> list:
    return [(max(s, start), min(e, end)) for s, e in intervals
            if e > start and s < end]


class Trace:
    """The events of one trace; times in microseconds, as the trace has
    them."""

    def __init__(self, events: list):
        self.device = []     # (start, end, name, correlation)
        self.launch = {}     # correlation → ((pid, tid), ts)
        self.spans = {}      # name → {(pid, tid): sorted [(start, end)]}
        self.host = []       # (thread, start, end, name)
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = str(e.get("cat", "")).lower()
            ts, dur = float(e["ts"]), float(e["dur"])
            corr = (e.get("args") or {}).get("correlation")
            thread = (e.get("pid"), e.get("tid"))
            if cat in DEVICE_CATS:
                self.device.append((ts, ts + dur, e.get("name", ""), corr))
                continue
            if cat in LAUNCH_CATS and corr is not None:
                self.launch[corr] = (thread, ts)
            if cat == "user_annotation" and str(e.get("name", "")).startswith(
                    SPAN_PREFIX):
                self.spans.setdefault(e["name"], {}).setdefault(
                    thread, []).append((ts, ts + dur))
            if cat in HOST_CATS:
                self.host.append((thread, ts, ts + dur, e.get("name", "")))
        for by_thread in self.spans.values():
            for lst in by_thread.values():
                lst.sort()

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            return cls(json.load(f).get("traceEvents", []))

    def window(self):
        """(start, end, host thread) of the traced window's span."""
        by_thread = self.spans.get(WINDOW)
        if not by_thread:
            raise ValueError("the trace has no window span")
        thread, lst = next(iter(by_thread.items()))
        return lst[0][0], lst[-1][1], thread

    def window_seconds(self) -> float:
        start, end, _ = self.window()
        return (end - start) * 1e-6

    def busy_intervals(self) -> list:
        start, end, _ = self.window()
        return clip(union((s, e) for s, e, _, _ in self.device), start, end)

    def busy_seconds(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def kernels_under(self, span: str) -> list:
        """Device events launched inside a span named ``span``."""
        by_thread = self.spans.get(span, {})
        starts = {t: [s for s, _ in lst] for t, lst in by_thread.items()}
        out = []
        for ev in self.device:
            hit = self.launch.get(ev[3])
            if hit is None or hit[0] not in by_thread:
                continue
            thread, ts = hit
            i = bisect.bisect_right(starts[thread], ts) - 1
            if i >= 0 and by_thread[thread][i][1] >= ts:
                out.append(ev)
        return out

    def device_seconds_under(self, span: str) -> float:
        return sum(e - s for s, e, _, _ in self.kernels_under(span)) * 1e-6

    def span_count(self, span: str) -> int:
        return sum(len(v) for v in self.spans.get(span, {}).values())

    def kernels_launched_between(self, thread, start: float,
                                 end: float) -> int:
        """Kernels (not copies or sets) whose launch on ``thread`` lies in
        [start, end]."""
        n = 0
        for s, e, name, corr in self.device:
            hit = self.launch.get(corr)
            if hit and hit[0] == thread and start <= hit[1] <= end:
                n += 1
        return n

    def top_device_ops(self, n: int = 10) -> list:
        """[name, seconds] of the device operations that took most time in
        the window."""
        start, end, _ = self.window()
        per: dict = {}
        for s, e, name, _ in self.device:
            s, e = max(s, start), min(e, end)
            if e > s:
                per[name] = per.get(name, 0.0) + (e - s) * 1e-6
        top = sorted(per.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:96], sec] for name, sec in top]

    def idle_gaps(self, n: int = 10) -> list:
        """[what the host was doing, seconds] over the longest idle gaps of
        the device in the window: each gap named by the innermost host
        event of the window's thread open at its middle."""
        start, end, thread = self.window()
        busy = self.busy_intervals()
        gaps, prev = [], start
        for s, e in busy:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if end > prev:
            gaps.append((prev, end))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:GAPS_LABELLED]
        mids = sorted(((a + b) / 2, b - a) for a, b in gaps)
        host = sorted(((s, -(e - s), e, name) for t, s, e, name in self.host
                       if t == thread), key=lambda h: (h[0], h[1]))
        per: dict = {}
        stack: list = []     # (end, name), innermost last
        j = 0
        for mid, length in mids:
            while j < len(host) and host[j][0] <= mid:
                s, _, e, name = host[j]
                while stack and stack[-1][0] <= s:
                    stack.pop()
                stack.append((e, name))
                j += 1
            while stack and stack[-1][0] <= mid:
                stack.pop()
            label = stack[-1][1] if stack else "(no host event)"
            per[label] = per.get(label, 0.0) + length * 1e-6
        top = sorted(per.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:96], sec] for name, sec in top]
