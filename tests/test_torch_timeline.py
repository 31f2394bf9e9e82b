"""The port's timeline merge (``ompi_tpu_torch.runtime.timeline``), clock
offset estimator (``runtime/clocksync.py``), metrics plane
(``runtime/metrics.py``: ``merge_hop``, the UDP collector, the
aggregate's Prometheus rendering, the straggler panel) and the rank-side
pusher (``mpi/trace.py``) against the JAX package's.

Each case mirrors one of ``tests/runtime/test_timeline.py`` or one of
the cases of ``tests/runtime/test_obs_plane.py`` that need no orted or
DVM (the orted's are in ``tests/test_torch_rml.py``, the DVM's
``scrape_hnp`` cases in ``tests/test_torch_obs_scrape.py``).  Pure
functions get
the same inputs in both packages and must give the same output: merged
timelines, estimator offsets, merged hop payloads, Prometheus text,
straggler panels.  The pusher's datagrams are read by the other
package's collector, so the wire shape is held too.

The pusher meters itself: ``_MetricsPusher.push`` counts
``metrics_push_datagrams_total`` and ``metrics_push_bytes_total`` after
each datagram, so a second push "with nothing changed" still carries
those two counters in both packages (why the JAX package's
``test_pusher_delta_compresses_and_full_heals`` fails).  The mirror here
asserts what both packages do: that second datagram holds exactly those
two counters.
"""

from __future__ import annotations

import copy
import json
import random
import socket
import time
import types

import pytest

from ompi_tpu.core import dss as jdss
from ompi_tpu.core.config import var_registry as jvars
from ompi_tpu.mpi import trace as jtrace
from ompi_tpu.runtime import metrics as jmetrics
from ompi_tpu.runtime import timeline as jtimeline
from ompi_tpu.runtime.clocksync import OffsetEstimator as JEstimator
from ompi_tpu_torch.core import dss as pdss
from ompi_tpu_torch.core.config import var_registry as pvars
from ompi_tpu_torch.mpi import trace as ptrace
from ompi_tpu_torch.runtime import metrics as pmetrics
from ompi_tpu_torch.runtime import timeline as ptimeline
from ompi_tpu_torch.runtime.clocksync import OffsetEstimator

J = types.SimpleNamespace(name="jax", trace=jtrace, metrics=jmetrics,
                          vars=jvars, dss=jdss)
P = types.SimpleNamespace(name="port", trace=ptrace, metrics=pmetrics,
                          vars=pvars, dss=pdss)
BOTH = (J, P)


@pytest.fixture(autouse=True)
def _trace_off_after():
    yield
    for M in BOTH:
        M.trace.disable()
        M.trace.stop_metrics_push(flush=False)


# ---------------------------------------------------------------------------
# offset estimator
# ---------------------------------------------------------------------------

def _pingpongs(seed):
    rng = random.Random(seed)
    true_offset = 7_300_000_000
    local = 50_000_000
    out = []
    for _ in range(64):
        up = rng.randrange(40_000, 900_000)
        down = rng.randrange(40_000, 2_500_000)
        t0 = local
        out.append((t0, t0 + up + true_offset, t0 + up + down))
        local = t0 + up + down + rng.randrange(1_000_000, 3_000_000)
    return true_offset, out


@pytest.mark.parametrize("seed", [0xC10C, 1, 2])
def test_offset_estimator_error_bound(seed):
    true_offset, samples = _pingpongs(seed)
    got = []
    for cls in (JEstimator, OffsetEstimator):
        est = cls(window=16)
        for s in samples:
            est.observe(*s)
        got.append((est.offset_ns(), est.rtt_ns(), est.sample_count()))
    assert got[1] == got[0]
    off, rtt, n = got[1]
    assert abs(off - true_offset) <= rtt // 2 and n == 64


def test_offset_estimator_rejects_stale_and_resets():
    est = OffsetEstimator(window=4)
    est.observe(100, 1100, 90)
    assert est.offset_ns() is None
    est.observe(100, 1150, 200)
    assert est.offset_ns() == 1000
    est.reset()
    assert est.offset_ns() is None and est.sample_count() == 1


# ---------------------------------------------------------------------------
# the merge and its flow edges
# ---------------------------------------------------------------------------

def _two_rank_captures():
    """Rank 1's raw clock runs 5ms behind the root: pre-correction its
    recv appears BEFORE the matching send ended."""
    return [
        {"rank": 0, "trace_id": "t-abc", "clock_to_root_ns": 0,
         "clock_offset_ns": 1_000, "events_total": 3, "dropped": 0,
         "capacity": 4096, "counters": {}, "collrec": [],
         "events": [
             {"ph": "X", "ts": 100.0, "dur": 10.0, "tid": 0,
              "cat": "pml", "name": "eager_send",
              "args": {"fl": 123, "tc": 777}},
             {"ph": "X", "ts": 200.0, "dur": 50.0, "tid": 2,
              "cat": "coll", "name": "bcast",
              "args": {"cid": 1, "seq": 5}},
             {"ph": "i", "ts": 150.0, "tid": 7, "s": "t",
              "cat": "runtime", "name": "rml_send",
              "args": {"tc": [777, 9]}},
         ]},
        {"rank": 1, "trace_id": "t-abc", "clock_to_root_ns": 5_000_000,
         "clock_offset_ns": 2_000, "events_total": 3, "dropped": 0,
         "capacity": 4096, "counters": {}, "collrec": [],
         "events": [
             {"ph": "X", "ts": 100.0, "dur": 10.0, "tid": 0,
              "cat": "pml", "name": "eager_recv",
              "args": {"fl": 123, "tc": 777}},
             {"ph": "X", "ts": 150.0, "dur": 60.0, "tid": 2,
              "cat": "coll", "name": "bcast",
              "args": {"cid": 1, "seq": 5}},
             {"ph": "i", "ts": 120.0, "tid": 7, "s": "t",
              "cat": "runtime", "name": "rml_recv",
              "args": {"tc": [777, 9]}},
         ]},
    ]


def _variants():
    caps = _two_rank_captures()
    wall = _two_rank_captures()
    wall[1]["clock_to_root_ns"] = None
    dead = _two_rank_captures()
    dead[0]["clock_to_root_ns"] = -1_000_000
    dead.append({"rank": 2, "no_response": True})
    return {"measured": caps, "wall": wall, "no_response": dead,
            "reversed": _two_rank_captures()[::-1]}


@pytest.mark.parametrize("variant", ["measured", "wall", "no_response",
                                     "reversed"])
def test_merge_captures_equals_the_jax_package(variant):
    caps = _variants()[variant]
    got = ptimeline.merge_captures(copy.deepcopy(caps), jobid=42)
    want = jtimeline.merge_captures(copy.deepcopy(caps), jobid=42)
    assert json.dumps(got, sort_keys=True) == \
        json.dumps(want, sort_keys=True)


def test_merge_captures_stitches_all_three_flow_planes():
    doc = ptimeline.merge_captures(_two_rank_captures(), jobid=42)
    other = doc["otherData"]
    assert other["clock_domain"] == "root_monotonic"
    assert other["jobid"] == 42 and other["ranks"] == [0, 1]
    assert other["causality_problems"] == []
    by_name: dict = {}
    for e in doc["traceEvents"]:
        if e.get("cat") == "flow":
            by_name.setdefault(e["name"], []).append(e)
    msg = sorted(by_name["msg"], key=lambda e: e["ts"])
    assert [e["ph"] for e in msg] == ["s", "f"]
    assert (msg[0]["pid"], msg[1]["pid"]) == (0, 1)
    assert msg[1]["bp"] == "e" and msg[0]["id"] == "777:123"
    coll = sorted(by_name["coll_round"], key=lambda e: e["ts"])
    assert [e["ph"] for e in coll] == ["s", "f"]
    assert coll[0]["id"] == "coll:1:5"
    rml = sorted(by_name["rml"], key=lambda e: e["ts"])
    assert rml[0]["id"] == "rml:777:9"
    assert other["flow_edges"] == 3


def test_merge_captures_is_deterministic():
    caps = _two_rank_captures()
    a = ptimeline.merge_captures(copy.deepcopy(caps), jobid=7)
    b = ptimeline.merge_captures(copy.deepcopy(caps), jobid=7)
    c = ptimeline.merge_captures(copy.deepcopy(caps)[::-1], jobid=7)
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True) \
        == json.dumps(c, sort_keys=True)


def test_merge_captures_measured_correction_restores_causality():
    doc = ptimeline.merge_captures(_two_rank_captures())
    spans = {(e["pid"], e["name"]): e for e in doc["traceEvents"]
             if e.get("ph") == "X"}
    send, recv = spans[(0, "eager_send")], spans[(1, "eager_recv")]
    assert recv["ts"] + recv["dur"] >= send["ts"] + send["dur"]
    assert ptimeline.causality_problems(doc["traceEvents"]) == []


def test_merge_captures_falls_back_to_wall_without_full_offsets():
    doc = ptimeline.merge_captures(_variants()["wall"])
    assert doc["otherData"]["clock_domain"] == "wall"
    spans = {(e["pid"], e["name"]): e for e in doc["traceEvents"]
             if e.get("ph") == "X"}
    assert spans[(1, "eager_recv")]["ts"] == pytest.approx(102.0)


def test_merge_captures_no_response_and_negative_rebase():
    doc = ptimeline.merge_captures(_variants()["no_response"])
    other = doc["otherData"]
    assert other["clock_domain"] == "root_monotonic"
    assert other["per_rank"]["2"]["no_response"] is True
    assert other["ranks"] == [0, 1, 2]
    assert min(e["ts"] for e in doc["traceEvents"]
               if e.get("ph") != "M") >= 0.0


def test_flow_events_of_a_live_host_job_pass_causality():
    """A traced 2-rank job of the port's host plane: its timeline
    capture merges with its send→recv arrows and no causality problem
    (one clock, so the merge's wall domain is exact)."""
    import numpy as np

    from tests.torch_host_harness import run_ranks

    rec = ptrace.enable(capacity=8192, rank=0)

    def body(comm):
        ptrace.attach_pml(comm.pml)
        peer, left = (comm.rank + 1) % 2, (comm.rank - 1) % 2
        for tag, n in ((1, 16), (2, 40_000)):
            r = comm.irecv(source=left, tag=tag)
            comm.send(np.ones(n), dest=peer, tag=tag)
            r.wait()
        comm.allreduce(np.ones(4))
        return True

    assert all(run_ranks(2, body))
    caps = []
    for rank in (0, 1):
        cap = ptrace.timeline_capture(8192)
        cap["rank"] = rank
        cap["events"] = [e for e in cap["events"] if e["pid"] == rank]
        caps.append(cap)
    doc = ptimeline.merge_captures(caps, jobid=1)
    assert doc["otherData"]["causality_problems"] == []
    assert sum(1 for e in doc["traceEvents"]
               if e.get("cat") == "flow" and e["ph"] == "s"
               and e["name"] == "msg") >= 4
    assert rec.events_total > 0


# ---------------------------------------------------------------------------
# native span drain parity and the record-path budget
# ---------------------------------------------------------------------------

def test_native_span_drain_parity():
    from ompi_tpu_torch import _native

    rec = ptrace.enable(capacity=1024, rank=0)
    try:
        if _native.arena() is not None:
            import ctypes

            flags = (ctypes.c_uint64 * 1)(0)
            _native.arena().ompi_tpu_arena_wait(
                ctypes.addressof(flags), 0, 1, 64, 2_000_000)
            assert ptrace.drain_native_spans() >= 1
            assert "native_arena_wait" in [e[3] for e in rec.snapshot()]
            cap = ptrace.timeline_capture()
            assert any(e["name"] == "native_arena_wait"
                       for e in cap["events"])
            assert cap["counters"]["trace_native_spans_total"] >= 1
        _native.spans_enable(-1)
        before = len(rec.snapshot())
        assert ptrace.drain_native_spans() == 0
        cap = ptrace.timeline_capture()
        assert len(rec.snapshot()) == before
        assert {"rank", "events", "clock_offset_ns", "dropped"} <= set(cap)
        assert set(cap) == set(jtrace.timeline_capture())
    finally:
        _native.spans_enable(-1)


def test_record_path_overhead_budget():
    """≤2µs per span on the hot add path, best of 5 batches (the JAX
    package's budget, unchanged)."""
    rec = ptrace.FlightRecorder(capacity=4096, rank=0)
    n = 2000
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter_ns()
        for i in range(n):
            rec.add(i, 10, "pml", "eager_send", 0, None)
        best = min(best, (time.perf_counter_ns() - t0) / n)
    assert best <= 2000, f"record path costs {best:.0f}ns/span (>2us)"


# ---------------------------------------------------------------------------
# the metrics plane: merge_hop, vectors, the aggregate, the panel
# ---------------------------------------------------------------------------

def _vec(marker: str, *pairs, total: int = 0) -> list:
    ints = [0] * ptrace.HIST_VLEN
    for bucket, count in pairs:
        ints[bucket] = count
    ints[ptrace.HIST_NBUCKETS] = total
    return [marker] + ints


_HOPS = [
    [{7: {0: [100.0, {"a": 1, "b": 2}]}},
     {7: {0: [200.0, {"b": 5, "c": 9}], 2: [150.0, {"a": 4}]}},
     {7: {0: [50.0, {"b": 5}]}}],
    [{7: {0: [1.0, {"x": 1}]}}, {8: {0: [1.0, {"x": 100}]}}],
    [None, {"not-int-keyed": "nope"}, {7: {0: "not-a-row"}}],
    [{7: {0: [100.0, {"coll_dispatch_ns": _vec("d", (3, 2), total=200),
                      "x": 5}]}},
     {7: {0: [200.0, {"coll_dispatch_ns": _vec("d", (3, 1), total=90),
                      "x": 9}]}},
     {7: {0: [300.0, {"coll_dispatch_ns": _vec("a", (3, 10),
                                                total=900)}]}}],
]


@pytest.mark.parametrize("i", range(len(_HOPS)))
def test_merge_hop_equals_the_jax_package(i):
    got = []
    for M in BOTH:
        pending: dict = {}
        for payload in copy.deepcopy(_HOPS[i]):
            M.metrics.merge_hop(pending, payload)
        got.append(pending)
    assert got[1] == got[0]
    if i == 0:
        assert got[1][7][0] == [200.0, {"a": 1, "b": 5, "c": 9}]
    if i == 2:
        assert got[1] == {}


def test_vec_merge_algebra():
    d1 = _vec("d", (2, 1), total=100)
    d2 = _vec("d", (2, 2), (5, 1), total=300)
    a = _vec("a", (2, 10), total=5000)
    a2 = _vec("a", (2, 8), (4, 3), total=4000)
    pairs = [(d1, d2), (d1, a), (a, d1), (a, a2), (["d", 1, 2], d1)]
    got = [pmetrics.vec_merge(copy.deepcopy(x), copy.deepcopy(y))
           for x, y in pairs]
    assert got == [jmetrics.vec_merge(copy.deepcopy(x), copy.deepcopy(y))
                   for x, y in pairs]
    assert got[0][3] == 3 and got[1] == a and got[4] == d1
    assert got[3][3] == 10 and got[3][5] == 3


def test_push_period_clamp():
    old = pvars.get("trace_metrics_push_period")
    try:
        for v, want in ((0.0, 0.0), (0.05, ptrace.PUSH_PERIOD_FLOOR),
                        (2.5, 2.5), (-1.0, 0.0)):
            pvars.set("trace_metrics_push_period", v)
            assert ptrace.push_period() == want
    finally:
        pvars.set("trace_metrics_push_period", old)


def _agg_payload(now):
    b = ptrace.hist_bucket_index(5000)
    key = 'coll_dispatch_ns{slot="bcast",provider="shm",szb="10"}'
    return {7: {0: [now, {key: _vec("a", (b, 3), (b + 2, 1), total=20000),
                          "pml_zero_copy_sends_total": 2,
                          "coll_arena_wait_ns": _vec("a", (20, 5),
                                                     total=9_000_000_000)}],
                1: [now, {key: _vec("a", (b, 1), total=5000),
                          "pml_zero_copy_sends_total": 5,
                          "coll_arena_wait_ns": _vec("a", (20, 5),
                                                     total=400_000_000)}]},
            9: {0: [now, {"pml_zero_copy_sends_total": 11}]}}


def test_aggregate_prometheus_equals_the_jax_package():
    now = time.time()
    texts = []
    for M in BOTH:
        agg = M.metrics.MetricsAggregate()
        agg.merge(copy.deepcopy(_agg_payload(now)))
        texts.append(agg.prometheus())
    assert texts[1] == texts[0]
    text = texts[1]
    assert 'ompi_tpu_pml_zero_copy_sends_total{job="7",rank="0"} 2' in text
    assert 'ompi_tpu_job_pml_zero_copy_sends_total{job="7"} 7' in text
    assert "# TYPE ompi_tpu_coll_dispatch_ns histogram" in text
    pre = 'job="7",rank="0",slot="bcast",provider="shm",szb="10"'
    assert f'ompi_tpu_coll_dispatch_ns_bucket{{{pre},le="+Inf"}} 4' in text
    typed = [ln.split()[2] for ln in text.splitlines()
             if ln.startswith("# TYPE")]
    assert len(typed) == len(set(typed))


def test_aggregate_panels_and_quantiles_equal_the_jax_package():
    now = time.time()
    got = []
    for M in BOTH:
        agg = M.metrics.MetricsAggregate(max_jobs=4)
        agg.merge(copy.deepcopy(_agg_payload(now)))
        got.append((agg.straggler(7), agg.straggler(9),
                    agg.rank_hist_quantile(7, 0, "coll_dispatch_ns", 0.99),
                    agg.job_hist_quantiles(7, "coll_dispatch_ns", 0.5),
                    sorted(agg.ages(7, now=now).items())))
    for a, b in zip(got[1], got[0]):
        if isinstance(a, dict):
            a = {k: v for k, v in a.items() if k != "window_s"}
            b = {k: v for k, v in b.items() if k != "window_s"}
        assert a == b
    panel = got[1][0]
    assert panel["signal"] == "arena_wait" and panel["suspect"] == 1


def test_straggler_panel_names_the_slowest_rank():
    waits = {0: 9e9, 1: 8e9, 2: 0.4e9, 3: 8.5e9}
    pubs = {r: 1e8 for r in waits}
    for M in BOTH:
        assert M.metrics.straggler_panel({0: 5.0}, {}, "arena_wait",
                                         1.0)["suspect"] is None
        assert M.metrics.straggler_panel({}, {}, "arena_wait", 1.0) is None
    got = pmetrics.straggler_panel(waits, pubs, "arena_wait", window_s=30.0)
    assert got == jmetrics.straggler_panel(waits, pubs, "arena_wait",
                                           window_s=30.0)
    assert got["suspect"] == 2
    assert got["max_wait_ms"] == pytest.approx(9000.0)


def test_agg_families_name_real_counters_and_histograms():
    assert pmetrics.AGG_METRICS == jmetrics.AGG_METRICS
    assert pmetrics.AGG_HISTS == jmetrics.AGG_HISTS
    assert set(pmetrics.AGG_METRICS) <= {n for n, _u, _d in
                                         ptrace._COUNTER_SPECS}
    assert set(pmetrics.AGG_HISTS) <= {n for n, _u, _d in
                                       ptrace._HIST_SPECS}


# ---------------------------------------------------------------------------
# the collector and the rank pusher
# ---------------------------------------------------------------------------

def _drain_until(col, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        p = col.drain()
        if p:
            return p
        time.sleep(0.02)
    return {}


def test_collector_udp_roundtrip_and_fences():
    col = pmetrics.MetricsCollector(period=30.0, send_fn=lambda p: None)
    try:
        host, port = col.uri.rsplit(":", 1)
        addr = (host, int(port))
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sock.sendto(pdss.pack(("m1", 7, 0, 9, {"a": 9})), addr)
        assert _drain_until(col)[7][0][1] == {"a": 9}
        # an older datagram of the same life must not regress it
        sock.sendto(pdss.pack(("m1", 7, 0, 5, {"a": 5})), addr)
        sock.sendto(pdss.pack(("m1", 7, "zero", 1, {"a": 1})), addr)
        sock.sendto(pdss.pack(("m1", 8, 1, 1, {"b": 2})), addr)
        p = _drain_until(col)
        assert 7 not in p and p[8][1][1] == {"b": 2}
        col.on_child_payload({7: {1: [time.time(), {"c": 4}]}})
        assert col.drain()[7][1][1] == {"c": 4}
        sock.close()
    finally:
        col.close()


def _collect_pushes(M, col, jobid, bump):
    """Three pushes from M's pusher into ``col``: full, unchanged, after
    ``bump``; the value dicts the collector saw for each."""
    old = M.vars.get("trace_metrics_push_period")
    M.vars.set("trace_metrics_push_period", 30.0)
    seen = []
    try:
        pusher = M.trace.start_metrics_push(jobid, 0, uri=col.uri)
        assert pusher is not None
        for step in range(3):
            if step == 2:
                bump(M)
            pusher.push()
            p = _drain_until(col, 2.0)
            seen.append(p.get(jobid, {}).get(0, [0, {}])[1])
    finally:
        M.trace.stop_metrics_push(flush=False)
        M.vars.set("trace_metrics_push_period", old)
    return seen


def test_pusher_delta_compresses_and_full_heals():
    """Push 1 is a full snapshot; push 2, with nothing changed, carries
    exactly the pusher's own two self-metering counters in both
    packages; push 3 carries a bumped counter beside them.  Each
    package's datagrams are read by the OTHER package's collector."""
    keys = ("metrics_push_datagrams_total", "metrics_push_bytes_total")
    got = {}
    for M, col_mod in ((J, pmetrics), (P, jmetrics)):
        col = col_mod.MetricsCollector(period=30.0, send_fn=lambda p: None)
        try:
            got[M.name] = _collect_pushes(
                M, col, 77, lambda M: M.trace.count(
                    "btl_shm_publish_total", 3))
        finally:
            col.close()
    for name in ("jax", "port"):
        full, second, third = got[name]
        assert "pml_zero_copy_sends_total" in full, name
        assert set(second) == set(keys), (name, sorted(second))
        assert set(third) == set(keys) | {"btl_shm_publish_total"}, name
    counters = {n for n, _u, _d in ptrace._COUNTER_SPECS}
    assert counters <= set(got["port"][0]) and counters <= set(got["jax"][0])


def test_pusher_rides_vector_deltas():
    key = 'coll_dispatch_ns{slot="t",provider="shm",szb="4"}'
    lab = 'slot="t",provider="shm",szb="4"'
    got = []
    for M in BOTH:
        M.trace.hists.pop(key, None)
        M.trace.record_hist("coll_dispatch_ns", 5000, labels=lab)
        col = pmetrics.MetricsCollector(period=30.0, send_fn=lambda p: None)
        try:
            seen = _collect_pushes(M, col, 78, lambda M: M.trace.record_hist(
                "coll_dispatch_ns", 5000, labels=lab))
        finally:
            col.close()
            M.trace.hists.pop(key, None)
        got.append((seen[0][key], seen[2][key]))
    assert got[1] == got[0]
    b = ptrace.hist_bucket_index(5000)
    (full, delta) = got[1]
    assert full[0] == "a" and full[1 + b] == 1
    assert delta[0] == "d" and delta[1 + b] == 1


def test_start_metrics_push_disabled_without_uri_or_period():
    old = pvars.get("trace_metrics_push_period")
    try:
        pvars.set("trace_metrics_push_period", 1.0)
        assert ptrace.start_metrics_push(1, 0, uri=None) is None
        pvars.set("trace_metrics_push_period", 0.0)
        assert ptrace.start_metrics_push(1, 0, uri="127.0.0.1:1") is None
    finally:
        pvars.set("trace_metrics_push_period", old)
