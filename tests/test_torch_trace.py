"""The port's flight recorder (``ompi_tpu_torch.mpi.trace``), its emit
sites across the host plane and the offline exporter
(``ompi_tpu_torch.tools.trace_export``) against the JAX package's.

Each case mirrors one of ``tests/mpi/test_trace.py``.  Where the result
is data — a recorder snapshot, a flushed dump, a counter delta, a
decision instant's arguments — both packages get the same inputs (the
same rank bodies through each package's in-process harness) and the
port's result must equal the JAX package's; timestamps and pids are
left out of the comparison.  The exporter is the port's own copy: its
cases check what the JAX package's tests check of the repo's tool.

The counter-parity workload runs p2p eager and rendezvous, a committed
derived datatype, every arena collective, a fallback past the arena
size, an ``i*`` collective, a persistent plan's Starts and a partitioned
exchange over proc, the shm rings and tcp, with the native executors on
and off, in both packages on the same transport, and compares every
counter whose count does not depend on thread timing.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from ompi_tpu.core.config import var_registry as jvars
from ompi_tpu.mpi import datatype as jdt
from ompi_tpu.mpi import io as jio
from ompi_tpu.mpi import mpit as jmpit
from ompi_tpu.mpi import op as jop
from ompi_tpu.mpi import trace as jtrace
from ompi_tpu_torch.core.config import var_registry as pvars
from ompi_tpu_torch.mpi import datatype as pdt
from ompi_tpu_torch.mpi import io as pio
from ompi_tpu_torch.mpi import mpit as pmpit
from ompi_tpu_torch.mpi import op as pop
from ompi_tpu_torch.mpi import trace as ptrace
from ompi_tpu_torch.tools import trace_export
from tests.mpi.harness import run_ranks as jrun
from tests.test_torch_host_p2p import _same
from tests.torch_host_harness import run_ranks as prun

ROOT = Path(__file__).resolve().parents[1]

J = types.SimpleNamespace(name="jax", trace=jtrace, dt=jdt, op=jop,
                          mpit=jmpit, vars=jvars, run=jrun, io=jio)
P = types.SimpleNamespace(name="port", trace=ptrace, dt=pdt, op=pop,
                          mpit=pmpit, vars=pvars, run=prun, io=pio)
BOTH = (J, P)


@pytest.fixture(scope="module", autouse=True)
def _components_registered():
    """coll/shm and coll/host register their variables when the
    framework first opens (a collective on more than one rank) — before
    a test sets them."""
    jrun(2, lambda c: c.barrier())
    prun(2, lambda c: c.barrier())


@pytest.fixture(autouse=True)
def _trace_off_after():
    """Every test leaves both packages' recorders disarmed."""
    yield
    jtrace.disable()
    ptrace.disable()


def both(n, body):
    """(JAX package's per-rank results, port's)."""
    return jrun(n, lambda c: body(c, J)), prun(n, lambda c: body(c, P))


def _events(rec):
    """A recorder's events without their timestamps and durations:
    (is-span, category, name, rank, args)."""
    return [(dur is not None, cat, name, rank, args)
            for _ts, dur, cat, name, rank, args in rec.snapshot()]


# ---------------------------------------------------------------------------
# ring buffer and arming
# ---------------------------------------------------------------------------

def test_ring_buffer_wraps_oldest_first():
    snaps = []
    for M in BOTH:
        rec = M.trace.FlightRecorder(capacity=32, rank=0)
        for i in range(100):
            rec.add(i, None, "pml", f"e{i}", 0, None)
        assert (rec.events_total, rec.dropped) == (100, 68)
        snaps.append(rec.snapshot())
    assert snaps[1] == snaps[0]
    assert [e[0] for e in snaps[1]] == list(range(68, 100))


def test_disabled_emit_is_noop():
    assert ptrace.recorder is None and not ptrace.active
    ptrace.instant("pml", "nope")
    ptrace.complete("pml", "nope", ptrace.begin())
    with ptrace.span("pml", "nope"):
        pass
    assert ptrace.recorder is None


def test_enable_disable_cycle():
    got = []
    for M in BOTH:
        rec = M.trace.enable(capacity=64, rank=3, jobid=9)
        assert M.trace.active and M.trace.enabled()
        M.trace.instant("runtime", "hello", rank=3, k=1)
        with M.trace.span("coll", "s", rank=3, n=2):
            pass
        out = M.trace.disable()
        assert out is rec and not M.trace.active
        got.append((_events(out), M.trace.trace_id()))
    assert got[1] == got[0]


def test_reenable_adopts_later_identity(monkeypatch, tmp_path):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    paths = []
    for M in BOTH:
        rec = M.trace.enable(capacity=64)
        assert (rec.rank, rec.jobid) == (-1, 0)
        assert M.trace.enable(rank=3, jobid=7) is rec
        assert (rec.rank, rec.jobid) == (3, 7)
        paths.append(M.trace.default_path())
    assert paths[1] == paths[0] == str(tmp_path /
                                       "ompi_tpu_trace_7_rank3.json")


def test_disable_detaches_pml_listener():
    def body(comm, M):
        M.trace.attach_pml(comm.pml)
        assert comm.pml._listeners
        comm.barrier()
        if comm.rank == 0:
            M.trace.disable()
        comm.barrier()
        return len(comm.pml._listeners)

    for M in BOTH:
        M.trace.enable(capacity=64)
    jax_res, port_res = both(2, body)
    assert port_res == jax_res == [0, 0]


def test_detach_pml_scoped_to_one_pml():
    def body(comm, M):
        M.trace.attach_pml(comm.pml)
        comm.barrier()
        if comm.rank == 0:
            M.trace.detach_pml(comm.pml)
        comm.barrier()
        return len(comm.pml._listeners)

    for M in BOTH:
        M.trace.enable(capacity=64)
    jax_res, port_res = both(2, body)
    assert sorted(port_res) == sorted(jax_res) == [0, 1]


# ---------------------------------------------------------------------------
# end to end: the host plane feeds the timeline
# ---------------------------------------------------------------------------

def _stack_body(comm, M):
    """eager + rendezvous p2p, a collective, a derived-datatype send (the
    JAX test's body without its MPI-IO part, which
    ``test_io_spans_end_to_end`` adds)."""
    M.trace.attach_pml(comm.pml)
    peer, left = (comm.rank + 1) % comm.size, (comm.rank - 1) % comm.size
    r = comm.irecv(source=left, tag=1)
    comm.send(np.arange(32, dtype=np.float64), dest=peer, tag=1)
    r.wait()
    big = np.ones(128 * 1024, dtype=np.float32)
    r = comm.irecv(np.empty_like(big), source=left, tag=2)
    comm.send(big, dest=peer, tag=2)
    r.wait()
    total = comm.allreduce(np.ones(4))
    comm.barrier()
    vec = M.dt.INT32.vector(count=8, blocklength=2, stride=4).commit()
    r = comm.irecv(np.empty(16, np.int32), source=left, tag=3,
                   datatype=M.dt.INT32, count=16)
    comm.send(np.arange(32, dtype=np.int32), dest=peer, tag=3,
              datatype=vec, count=1)
    got = r.wait()
    return float(total[0]), got


def test_stack_categories_end_to_end():
    for M in BOTH:
        M.trace.enable(capacity=16384)
    jax_res, port_res = both(2, _stack_body)
    _same(jax_res, port_res)
    seen = []
    for M in BOTH:
        events = M.trace.recorder.snapshot()
        spans = {(e[2], e[3]) for e in events if e[1] is not None}
        insts = {(e[2], e[3]) for e in events if e[1] is None}
        seen.append((spans, insts))
    (jspans, jinsts), (pspans, pinsts) = seen
    assert {c for c, _ in pspans} == {c for c, _ in jspans} \
        >= {"pml", "coll", "datatype"}
    assert "btl" in {c for c, _ in pinsts}
    names = {n for _, n in pspans | pinsts}
    assert {"send_post", "recv_post", "match", "deliver", "rndv_send",
            "rndv_recv", "eager_send", "eager_recv", "allreduce",
            "barrier", "pack:strided", "commit:strided"} <= names
    # every span and instant name the JAX package recorded, the port did
    assert {n for _, n in jspans} <= {n for _, n in pspans}


def _stack_io_body(comm, M, path):
    """The JAX test's whole body: ``_stack_body`` and then a per-rank
    write and read-back of a shared file through MPI-IO."""
    res = _stack_body(comm, M)
    fh = M.io.File(comm, path, M.io.MODE_RDWR | M.io.MODE_CREATE)
    fh.set_view(etype=M.dt.FLOAT64)
    fh.write_at(comm.rank * 8, np.full(8, 1.0 + comm.rank))
    out = fh.read_at(comm.rank * 8, 8)
    fh.close()
    return res, float(out[0])


def test_io_spans_end_to_end(tmp_path):
    """tests/mpi/test_trace.py's stack case whole (its io part included):
    spans from pml, coll, io and datatype and btl instants, at least five
    categories, in both packages, and the io spans' names and arguments
    (offset, nbytes, rank) equal."""
    for M in BOTH:
        M.trace.enable(capacity=16384)
    jax_res = jrun(2, lambda c: _stack_io_body(
        c, J, str(tmp_path / "jax_io.bin")))
    port_res = prun(2, lambda c: _stack_io_body(
        c, P, str(tmp_path / "port_io.bin")))
    _same(jax_res, port_res)
    assert [v for _, v in port_res] == [1.0, 2.0]
    io_spans = []
    for M in BOTH:
        events = M.trace.recorder.snapshot()
        span_cats = {e[2] for e in events if e[1] is not None}
        assert {"pml", "coll", "io", "datatype"} <= span_cats, M.name
        inst_cats = {e[2] for e in events if e[1] is None}
        assert "btl" in inst_cats, M.name
        assert len(span_cats | inst_cats) >= 5, M.name
        names = {e[3] for e in events}
        assert {"send_post", "recv_post", "match", "deliver"} <= names
        assert "rndv_send" in names and "rndv_recv" in names
        io_spans.append(sorted((name, rank, sorted(args.items()))
                               for _ts, dur, cat, name, rank, args in events
                               if cat == "io" and dur is not None))
    assert io_spans[0] == io_spans[1]
    assert {n for n, _, _ in io_spans[1]} == {"write_at", "read_at"}
    assert len(io_spans[1]) == 4


def _flows(events):
    by_name: dict[str, set] = {}
    for _ts, dur, _cat, name, _rank, args in events:
        if dur is not None and name in ("eager_send", "eager_recv",
                                        "rndv_send", "rndv_recv"):
            fl = (args or {}).get("fl")
            if fl:
                by_name.setdefault(name, set()).add(fl)
    return by_name


def _flow_body(comm, M):
    M.trace.attach_pml(comm.pml)   # listeners: off the eager fast lane
    peer, left = (comm.rank + 1) % comm.size, (comm.rank - 1) % comm.size
    r = comm.irecv(source=left, tag=1)
    comm.send(np.arange(32, dtype=np.float64), dest=peer, tag=1)
    r.wait()
    big = np.ones(128 * 1024, dtype=np.float32)
    r = comm.irecv(np.empty_like(big), source=left, tag=2)
    comm.send(big, dest=peer, tag=2)
    r.wait()
    return 0


def test_flow_ids_pair_send_and_recv_spans():
    for M in BOTH:
        M.trace.enable(capacity=65536)
    jax_res, port_res = both(2, _flow_body)
    assert port_res == jax_res == [0, 0]
    jfl, pfl = (_flows(M.trace.recorder.snapshot()) for M in BOTH)
    assert sorted(pfl) == sorted(jfl) == ["eager_recv", "eager_send",
                                          "rndv_recv", "rndv_send"]
    assert pfl["eager_send"] & pfl["eager_recv"]
    assert pfl["rndv_send"] & pfl["rndv_recv"]
    # the same flow ids: rank-strided namespaces, one counter per PML
    assert pfl == jfl
    assert any(f >= 1 << 40 for s in pfl.values() for f in s)


_TRANSPORTS = {"shm": ("^proc", True), "shm-python": ("^proc", False),
               "tcp": ("^proc,shm", True),
               "tcp-python": ("^proc,shm", False)}
_TRANSPORT_VARS = ("btl_", "btl_shm_native", "btl_tcp_native",
                   "pml_native_match", "coll_shm_native")


@pytest.fixture(params=["proc", *_TRANSPORTS])
def transport(request):
    """One transport for BOTH packages' harnesses (the JAX package's
    in-process ranks take the same btl selection)."""
    import ompi_tpu.mpi.btl  # noqa: F401 — registers btl_
    import ompi_tpu.mpi.btl_shm  # noqa: F401
    import ompi_tpu.mpi.coll.shm  # noqa: F401
    import ompi_tpu_torch.mpi.btl  # noqa: F401
    import ompi_tpu_torch.mpi.btl_shm  # noqa: F401
    import ompi_tpu_torch.mpi.coll.shm  # noqa: F401

    old = [(reg, n, reg.get(n)) for reg in (jvars, pvars)
           for n in _TRANSPORT_VARS]
    sel, native = _TRANSPORTS.get(request.param, ("", True))
    for reg in (jvars, pvars):
        reg.set("btl_", sel)
        for n in _TRANSPORT_VARS[1:]:
            reg.set(n, native)
    yield request.param
    for reg, n, v in old:
        reg.set(n, v)


def test_flow_ids_ride_every_transport(transport):
    """Every header codec carries the flow id: the dss dict, the native
    engine's fused drain, the shm and tcp frames — each send span's id
    shows up on the receiver's span."""
    for M in BOTH:
        M.trace.enable(capacity=65536)
    jax_res, port_res = both(2, _flow_body)
    assert port_res == jax_res
    pfl = _flows(ptrace.recorder.snapshot())
    assert pfl == _flows(jtrace.recorder.snapshot())
    assert pfl["eager_send"] == pfl["eager_recv"]
    assert pfl["rndv_send"] == pfl["rndv_recv"]


def test_flow_ids_cost_nothing_when_tracing_off():
    def body(comm, M):
        assert not M.trace.active
        peer = (comm.rank + 1) % comm.size
        seen = []
        orig = comm.pml._enqueue_frame

        def spy(p, hdr, payload, req):
            seen.append(dict(hdr))
            return orig(p, hdr, payload, req)

        comm.pml._enqueue_frame = spy
        try:
            r = comm.irecv(source=(comm.rank - 1) % comm.size, tag=1)
            comm.send(np.ones(4096, dtype=np.float64), dest=peer, tag=1)
            r.wait()
        finally:
            comm.pml._enqueue_frame = orig
        return sum(1 for h in seen if "fl" in h)

    jax_res, port_res = both(2, body)
    assert port_res == jax_res == [0, 0]


def test_coll_span_records_rules_decision(tmp_path):
    import ompi_tpu.mpi.coll.host  # noqa: F401 — registers its vars
    import ompi_tpu_torch.mpi.coll.host  # noqa: F401

    rules = tmp_path / "rules.conf"
    rules.write_text("allreduce 0 0 ring\n")
    old = [(reg, reg.get(n)) for reg in (jvars, pvars)
           for n in ("coll_host_dynamic_rules", "coll_shm_enable")]

    def body(comm, M):
        return comm.allreduce(np.ones(8, dtype=np.float64))

    got = []
    try:
        for reg in (jvars, pvars):
            reg.set("coll_host_dynamic_rules", str(rules))
            reg.set("coll_shm_enable", False)
        for M in BOTH:
            M.trace.enable(capacity=4096)
        jax_res, port_res = both(2, body)
        _same(jax_res, port_res)
        for M in BOTH:
            events = M.trace.recorder.snapshot()
            dec = [e[5] for e in events if e[3] == "decision:allreduce"]
            assert dec, "rules decision never hit the timeline"
            assert any(e[3] == "allreduce" and e[1] is not None
                       for e in events)
            got.append(dec)
    finally:
        for (reg, v), n in zip(old, ("coll_host_dynamic_rules",
                                     "coll_shm_enable") * 2):
            reg.set(n, v)
    assert got[1] == got[0]
    assert got[1][-1]["algorithm"] == "ring"
    assert "rules.conf" in got[1][-1]["source"]


# ---------------------------------------------------------------------------
# flushed dumps and the exporter
# ---------------------------------------------------------------------------

def _fake_rank_dump(M, tmp_path, rank: int) -> str:
    rec = M.trace.FlightRecorder(capacity=128, rank=rank, jobid=7)
    t0 = 1_000_000 + rank          # deterministic, distinct timestamps
    rec.add(t0, 500, "pml", "send_post", rank, {"peer": 1 - rank})
    rec.add(t0 + 1000, None, "btl", "send", rank, None)
    rec.add(t0 + 2000, 300, "coll", "allreduce", rank, None)
    d = tmp_path / M.name
    d.mkdir(exist_ok=True)
    path = str(d / f"ompi_tpu_trace_7_rank{rank}.json")
    assert M.trace.flush(path=path, rec=rec) == path
    return path


def _comparable(doc):
    """A flushed dump without what is this process's own state: the
    clock anchor, and the counter, histogram and recorder snapshots
    (held to each other by the counter tests)."""
    other = dict(doc["otherData"])
    for key in ("clock_offset_ns", "counters", "hists", "collrec",
                "collrec_total"):
        other.pop(key)
    return {**doc, "otherData": other}


def test_flush_documents_equal_the_jax_package(tmp_path):
    docs = [[json.load(open(_fake_rank_dump(M, tmp_path, r)))
             for r in (0, 1)] for M in BOTH]
    assert [_comparable(d) for d in docs[1]] == \
        [_comparable(d) for d in docs[0]]
    for jd, pd in zip(*docs):
        # every JAX counter, and the port's model counters besides
        assert set(pd["otherData"]["counters"]) == \
            set(jd["otherData"]["counters"]) | set(ptrace.MODEL_COUNTERS)


def test_export_merges_ranks_into_chrome_trace(tmp_path):
    merged = []
    for M in BOTH:
        paths = [_fake_rank_dump(M, tmp_path, r) for r in (0, 1)]
        doc = trace_export.merge(paths)
        assert doc["displayTimeUnit"] == "ns"
        assert trace_export.validate(doc) == []
        merged.append(doc)
    doc = merged[1]
    evs = [e for e in doc["traceEvents"] if e.get("ph") != "M"]
    assert {e["pid"] for e in evs} == {0, 1}
    meta = [e for e in doc["traceEvents"] if e.get("ph") == "M"]
    names = {(m["pid"], m["args"]["name"]) for m in meta
             if m["name"] == "thread_name"}
    assert (0, "pml") in names and (1, "coll") in names
    ts = [e["ts"] for e in evs]
    assert ts == sorted(ts)
    assert all("dur" in e for e in evs if e["ph"] == "X")
    assert merged[1]["traceEvents"] == merged[0]["traceEvents"]


def test_export_flow_events_synthesized():
    evs = [
        {"ph": "X", "name": "eager_send", "cat": "pml", "ts": 100.0,
         "dur": 5.0, "pid": 0, "tid": 0, "args": {"fl": 42}},
        {"ph": "X", "name": "eager_recv", "cat": "pml", "ts": 110.0,
         "dur": 3.0, "pid": 1, "tid": 0, "args": {"fl": 42}},
        {"ph": "X", "name": "rndv_send", "cat": "pml", "ts": 200.0,
         "dur": 5.0, "pid": 0, "tid": 0, "args": {"fl": 7}},
        {"ph": "X", "name": "eager_send", "cat": "pml", "ts": 300.0,
         "dur": 1.0, "pid": 0, "tid": 0, "args": {"fl": 8}},
        {"ph": "X", "name": "eager_recv", "cat": "pml", "ts": 302.0,
         "dur": 1.0, "pid": 0, "tid": 0, "args": {"fl": 8}},
        {"ph": "X", "name": "eager_send", "cat": "pml", "ts": 400.0,
         "dur": 10.0, "pid": 0, "tid": 0, "args": {"fl": 9}},
        {"ph": "X", "name": "eager_recv", "cat": "pml", "ts": 395.0,
         "dur": 2.0, "pid": 1, "tid": 0, "args": {"fl": 9}},
    ]
    flows = trace_export.flow_events(evs)
    assert len(flows) == 2
    s, f = flows
    assert s["ph"] == "s" and f["ph"] == "f" and f["bp"] == "e"
    assert s["id"] == f["id"] == 42
    assert (s["pid"], f["pid"]) == (0, 1)
    assert 100.0 <= s["ts"] <= 105.0 and 110.0 <= f["ts"] <= 113.0
    doc = {"displayTimeUnit": "ns",
           "traceEvents": sorted(evs + flows, key=lambda e: e["ts"])}
    assert trace_export.validate(doc) == []


def test_export_merge_emits_flow_arrows(tmp_path):
    def dump(rank, name, ts, fl):
        doc = {"displayTimeUnit": "ns",
               "otherData": {"rank": rank, "jobid": 5,
                             "clock_offset_ns": 0},
               "traceEvents": [
                   {"ph": "X", "name": name, "cat": "pml", "ts": ts,
                    "dur": 4.0, "pid": rank, "tid": 0,
                    "args": {"fl": fl}}]}
        p = tmp_path / f"ompi_tpu_trace_5_rank{rank}.json"
        p.write_text(json.dumps(doc))
        return str(p)

    doc = trace_export.merge([dump(0, "eager_send", 10.0, 99),
                              dump(1, "eager_recv", 20.0, 99)])
    phases = [e["ph"] for e in doc["traceEvents"]]
    assert "s" in phases and "f" in phases
    assert trace_export.validate(doc) == []


def test_export_cli_writes_and_validates(tmp_path):
    for r in (0, 1):
        _fake_rank_dump(P, tmp_path, r)
    src = tmp_path / P.name
    out = str(tmp_path / "merged.json")
    assert trace_export.main(["--dir", str(src), "--jobid", "7",
                              "-o", out]) == 0
    assert trace_export.validate(json.load(open(out))) == []
    assert trace_export.main(["--validate-file", out]) == 0
    assert trace_export.main(["--dir", str(tmp_path / "empty")]) == 2


def test_export_warns_on_mixed_job_dumps(tmp_path, capsys):
    paths = []
    for jobid in (1, 2):
        rec = ptrace.FlightRecorder(capacity=8, rank=0, jobid=jobid)
        rec.add(1000, None, "pml", "x", 0, None)
        p = str(tmp_path / f"ompi_tpu_trace_{jobid}_rank0.json")
        ptrace.flush(path=p, rec=rec)
        paths.append(p)
    trace_export.merge(paths)
    err = capsys.readouterr().err
    assert "WARNING" in err and "--jobid" in err


def test_validator_rejects_broken_traces():
    bad = {"displayTimeUnit": "parsec", "traceEvents": [
        {"ph": "X", "ts": -5, "pid": 0, "tid": 0, "name": "x"},
        {"ph": "X", "ts": 1.0, "pid": 0, "tid": 0, "name": "y"},
    ]}
    problems = trace_export.validate(bad)
    assert any("displayTimeUnit" in p for p in problems)
    assert any("bad ts" in p for p in problems)
    assert any("without dur" in p for p in problems)


def test_flush_coerces_non_json_args(tmp_path):
    argss = []
    for M in BOTH:
        rec = M.trace.FlightRecorder(capacity=16, rank=0, jobid=0)
        rec.add(10, None, "osc", "post", 0,
                {"origins": [np.int32(1)], "odd": None, "f": np.float32(2)})
        path = str(tmp_path / f"coerce_{M.name}.json")
        assert M.trace.flush(path=path, rec=rec) == path
        argss.append(json.load(open(path))["traceEvents"][-1]["args"])
    assert argss[1] == argss[0]
    assert argss[1]["origins"] == [1] and argss[1]["f"] == 2.0


def test_crash_dump_writes_default_path(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    docs = []
    for M in BOTH:
        M.trace.enable(capacity=256, rank=4, jobid=12)
        M.trace.instant("runtime", "before_the_end", rank=4)
        path = M.trace.crash_dump(reason="test")
        assert path == str(tmp_path / "ompi_tpu_trace_12_rank4.json")
        docs.append(json.load(open(path)))
        M.trace.disable()
    # (the flush drains the native span rings too: parks an earlier test
    # of this process left there ride along as native_* spans)
    evs = [[e for e in doc["traceEvents"]
            if not e["name"].startswith("native_")] for doc in docs]
    for doc, ev in zip(docs, evs):
        assert [e["name"] for e in ev] == ["before_the_end",
                                           "crash_dump:test"]
        assert doc["otherData"]["rank"] == 4
    assert [e.get("args") for e in evs[1]] == [e.get("args")
                                               for e in evs[0]]


def test_default_path_uses_tmpdir(monkeypatch):
    monkeypatch.setenv("TMPDIR", "/tmp/some-dir")
    for M in BOTH:
        assert M.trace.default_path(3, 1) == \
            "/tmp/some-dir/ompi_tpu_trace_3_rank1.json"


# ---------------------------------------------------------------------------
# the SIGTERM flush
# ---------------------------------------------------------------------------

def test_sigterm_flush_handler_installs_once():
    old = signal.getsignal(signal.SIGTERM)
    saved = ptrace._sigterm_installed, ptrace._old_sigterm
    try:
        ptrace._sigterm_installed = False
        ptrace._install_sigterm_flush()
        h1 = signal.getsignal(signal.SIGTERM)
        assert h1 is not old
        ptrace._install_sigterm_flush()      # second arm: no re-chain
        assert signal.getsignal(signal.SIGTERM) is h1
        assert ptrace._old_sigterm is not h1
    finally:
        signal.signal(signal.SIGTERM, old)
        ptrace._sigterm_installed, ptrace._old_sigterm = saved


def test_sigterm_chain_preserves_sig_ign():
    old = signal.getsignal(signal.SIGTERM)
    saved = ptrace._sigterm_installed, ptrace._old_sigterm
    try:
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        ptrace._sigterm_installed = False
        ptrace._install_sigterm_flush()
        handler = signal.getsignal(signal.SIGTERM)
        handler(signal.SIGTERM, None)   # must return, not kill us
    finally:
        signal.signal(signal.SIGTERM, old)
        ptrace._sigterm_installed, ptrace._old_sigterm = saved


_CHAINED = """
import os, signal, sys
from ompi_tpu_torch.mpi import trace
seen = []
signal.signal(signal.SIGTERM, lambda s, f: seen.append(s))
trace.enable(rank=2, jobid=5, install_signal=True)
trace.instant("runtime", "armed", rank=2)
os.kill(os.getpid(), signal.SIGTERM)
print(seen, os.path.exists(trace.default_path()))
"""


def test_sigterm_flush_chains_the_previous_handler(tmp_path):
    """A handler installed before the recorder (the abort path's, or one
    torch/NCCL installs in a --gpu rank) still runs after the flush."""
    out = subprocess.run(
        [sys.executable, "-c", _CHAINED], cwd=ROOT, capture_output=True,
        text=True, timeout=60, env={**os.environ, "TMPDIR": str(tmp_path)},
        check=True)
    assert out.stdout.strip() == f"[{int(signal.SIGTERM)}] True"
    doc = json.load(open(tmp_path / "ompi_tpu_trace_5_rank2.json"))
    assert [e["name"] for e in doc["traceEvents"]] == [
        "armed", "crash_dump:sigterm"]


def test_timeout_kill_leaves_every_rank_dump(tmp_path):
    """tpurun --trace --timeout: the launcher's SIGTERM reaches ranks
    parked in a collective, and each flushes its dump before dying."""
    prog = ("import time, numpy as np, ompi_tpu_torch\n"
            "c = ompi_tpu_torch.init()\n"
            "c.allreduce(np.ones(4))\n"
            "if c.rank == 1:\n"
            "    time.sleep(60)\n"
            "c.allreduce(np.ones(4))\n")
    out = subprocess.run(
        [sys.executable, "-m", "ompi_tpu_torch.tools.tpurun", "-np", "2",
         "--trace", "--timeout", "6", "--no-tag-output", "--",
         sys.executable, "-c", prog],
        cwd=ROOT, capture_output=True, text=True, timeout=90,
        env={**os.environ, "TMPDIR": str(tmp_path)})
    assert out.returncode == 124, out.stderr[-2000:]
    dumps = sorted(p.name for p in tmp_path.glob("ompi_tpu_trace_*.json"))
    assert len(dumps) == 2 and dumps[0].endswith("_rank0.json"), dumps
    for p in tmp_path.glob("ompi_tpu_trace_*.json"):
        doc = json.load(open(p))
        names = [e["name"] for e in doc["traceEvents"]]
        assert names[-1] == "crash_dump:sigterm", names[-4:]
        kinds = [r[4] for r in doc["otherData"]["collrec"]
                 if r[5] == "post"]
        assert kinds[-1] == "allreduce"


# ---------------------------------------------------------------------------
# the always-on counters and their pvars
# ---------------------------------------------------------------------------

def _deltas(M, before):
    return {k: v - before[k] for k, v in M.trace.counters.items()
            if v != before[k]}


def test_commit_counts_plan_classes():
    deltas = []
    for M in BOTH:
        before = dict(M.trace.counters)
        M.dt.FLOAT64.contiguous(4).commit()                       # single
        M.dt.INT32.vector(count=8, blocklength=2, stride=4).commit()
        M.dt.INT64.indexed([1, 1], [0, 5]).commit()               # runs
        M.dt.INT32.hvector(3, 2, 20).commit()                     # strided
        M.dt.create_struct([1, 2], [0, 8],
                           [M.dt.INT32, M.dt.FLOAT32]).commit()   # runs
        deltas.append(_deltas(M, before))
    assert deltas[1] == deltas[0] == {
        "convertor_plan_single_total": 1,
        "convertor_plan_strided_total": 2,
        "convertor_plan_runs_total": 2}


def test_recommit_does_not_double_count():
    deltas = []
    for M in BOTH:
        before = dict(M.trace.counters)
        v = M.dt.INT32.vector(count=4, blocklength=1, stride=2).commit()
        v.commit()
        v.commit()
        deltas.append(_deltas(M, before))
    assert deltas[1] == deltas[0] == {"convertor_plan_strided_total": 1}


def test_zero_copy_vs_packed_send_counters():
    def body(comm, M):
        peer, left = (comm.rank + 1) % comm.size, (comm.rank - 1) % comm.size
        r = comm.irecv(source=left, tag=1)
        comm.send(np.arange(16, dtype=np.float64), dest=peer, tag=1)
        a = r.wait()
        vec = M.dt.INT32.vector(count=4, blocklength=1, stride=2).commit()
        r = comm.irecv(np.empty(4, np.int32), source=left, tag=2,
                       datatype=M.dt.INT32, count=4)
        comm.send(np.arange(8, dtype=np.int32), dest=peer, tag=2,
                  datatype=vec, count=1)
        return a, r.wait()

    keys = ("pml_zero_copy_sends_total", "pml_packed_sends_total")
    j0 = [jtrace.counters[k] for k in keys]
    p0 = [ptrace.counters[k] for k in keys]
    jax_res, port_res = both(2, body)
    _same(jax_res, port_res)
    jd = [jtrace.counters[k] - v for k, v in zip(keys, j0)]
    pd = [ptrace.counters[k] - v for k, v in zip(keys, p0)]
    assert pd == jd and pd[0] >= 2 and pd[1] >= 2


def test_counters_snapshot_carries_convertor_stats():
    snap = ptrace.counters_snapshot()
    jsnap = jtrace.counters_snapshot()
    # the JAX package's counters, and the port's model counters besides
    assert set(jsnap) <= set(snap)
    assert set(snap) - set(jsnap) == set(ptrace.MODEL_COUNTERS)
    for key in ("convertor_pack_calls_total", "convertor_unpack_calls_total",
                "pml_zero_copy_sends_total", "convertor_plan_single_total"):
        assert key in snap
    json.dumps(snap)


def test_counters_readable_as_pvars():
    before = ptrace.counters["pml_zero_copy_sends_total"]
    pv = pmpit.pvar_registry.lookup("pml_zero_copy_sends_total")
    try:
        assert pv.read() == before
        ptrace.count("pml_zero_copy_sends_total")
        assert pv.read() == before + 1
    finally:
        ptrace.counters["pml_zero_copy_sends_total"] = before


def test_metrics_snapshot_prometheus_shape():
    text = ptrace.metrics_snapshot()
    lines = text.strip().splitlines()
    for name, _u, _d in ptrace._COUNTER_SPECS:
        assert f"ompi_tpu_{name}" in text
    for ln in lines:
        if not ln.startswith("#"):
            metric, val = ln.split()
            assert metric.startswith("ompi_tpu_")
            float(val)
    # the counters' HELP/TYPE lines are the JAX package's, word for word;
    # the port's model counters are its own
    jtext = jtrace.metrics_snapshot()
    for name, _u, _d in jtrace._COUNTER_SPECS:
        assert f"ompi_tpu_{name} " in text
    for name in ptrace.MODEL_COUNTERS:
        assert f"ompi_tpu_{name} " not in jtext
    for name, _u, _d in ptrace._COUNTER_SPECS:
        if name in ptrace.MODEL_COUNTERS:
            continue
        for kind in ("# HELP", "# TYPE"):
            want = [ln for ln in jtext.splitlines()
                    if ln.startswith(f"{kind} ompi_tpu_{name} ")]
            got = [ln for ln in lines
                   if ln.startswith(f"{kind} ompi_tpu_{name} ")]
            assert got == want


def test_shm_publish_counter_counts_only_successful_publishes():
    from ompi_tpu_torch.mpi.btl_shm import FrameTooBig, ShmBTL

    got = []
    a = ShmBTL(0, lambda p, h, b: got.append(b))
    b = ShmBTL(1, lambda p, h, b: got.append(b))
    try:
        assert a.connect(1, b.address)
        before = ptrace.counters["btl_shm_publish_total"]
        a.send(1, {"t": "eager", "tag": 1, "cid": 0, "seq": 0,
                   "dt": "<u1", "elems": 4, "shp": [4]}, b"\x01" * 4)
        assert ptrace.counters["btl_shm_publish_total"] == before + 1
        with pytest.raises(FrameTooBig):
            a.send(1, {"t": "eager"}, b"\x00" * (8 << 20))
        assert ptrace.counters["btl_shm_publish_total"] == before + 1
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# counter parity over one shared workload
# ---------------------------------------------------------------------------

#: the counters whose count is a function of the workload alone (those
#: left out count parks, wakeups and drains, which thread timing decides)
_PARITY_COUNTERS = (
    "convertor_plan_single_total", "convertor_plan_strided_total",
    "convertor_plan_runs_total", "convertor_plan_items_total",
    "pml_zero_copy_sends_total", "pml_packed_sends_total",
    "btl_shm_publish_total", "coll_shm_fanin_total",
    "coll_shm_fanout_total", "coll_shm_fallback_total",
    "coll_persistent_binds_total", "coll_persistent_starts_total",
    "coll_persistent_rebinds_total", "pml_partitioned_starts_total",
    "pml_partitioned_pready_total", "coll_shm_native_publishes_total",
    "coll_shm_native_folds_total", "coll_stuck_events_total")


def _workload(c, M):
    r, n = c.rank, c.size
    right, left = (r + 1) % n, (r - 1) % n
    out = {}
    req = c.irecv(source=left, tag=1)
    c.send(np.arange(64.0) + r, dest=right, tag=1)
    out["eager"] = req.wait()
    big = np.full(20000, float(r))                 # 160 KB: rendezvous
    req = c.irecv(np.empty_like(big), source=left, tag=2)
    c.send(big, dest=right, tag=2)
    out["rndv"] = req.wait()
    vec = M.dt.INT32.vector(count=8, blocklength=2, stride=4).commit()
    req = c.irecv(np.empty(16, np.int32), source=left, tag=3,
                  datatype=M.dt.INT32, count=16)
    c.send(np.arange(32, dtype=np.int32) + r, dest=right, tag=3,
           datatype=vec, count=1)
    out["vector"] = req.wait()
    x = np.arange(12.0) + r
    c.barrier()
    out["bcast"] = c.bcast(x if r == 0 else None, root=0)
    out["reduce"] = c.reduce(x, M.op.SUM, root=n - 1)
    out["allreduce"] = c.allreduce(x)
    out["allgather"] = c.allgather(x)
    out["alltoall"] = c.alltoall(np.arange(3.0 * n) + 100 * r)
    out["reduce_scatter_block"] = c.reduce_scatter_block(
        np.arange(2.0 * n) + r)
    out["scan"] = c.scan(x)
    out["exscan"] = c.exscan(x)
    out["allreduce_prod"] = c.allreduce(np.full(5, 1.0 + r), M.op.PROD)
    # past coll_shm_arena_size: coll/host's fallback
    out["fallback"] = c.allreduce(np.full(600_000, float(r)))[:4]
    out["iallreduce"] = c.iallreduce(x).wait()
    buf = np.zeros(4096)
    preq = c.allreduce_init(buf)
    outs = []
    for k in range(3):
        buf[...] = np.arange(4096.0) + r + k
        preq.start()
        outs.append(np.copy(preq.wait()))
    preq.free()
    out["persistent"] = outs
    sbuf, rbuf = np.arange(32.0) + r, np.zeros(32)
    ps = c.psend_init(sbuf, dest=right, tag=9, partitions=4)
    pr = c.precv_init(rbuf, source=left, tag=9, partitions=4)
    ps.start()
    pr.start()
    for i in (2, 0, 3, 1):
        ps.pready(i)
    ps.wait()
    pr.wait()
    out["partitioned"] = np.copy(rbuf)
    c.barrier()
    return out


def _delta(M, n, body):
    before = {k: M.trace.counters[k] for k in _PARITY_COUNTERS}
    out = M.run(n, lambda c: body(c, M))
    return out, {k: M.trace.counters[k] - v for k, v in before.items()}


def _with_setup(c, M):
    c.barrier()
    return _workload(c, M)


def test_counters_after_the_shared_workload_equal(transport):
    """Each package's counts over the whole workload, the arena build of
    its first barrier included: both builds run the coll-epoch agreement,
    an allreduce over the base p2p plane."""
    n = 3
    res, deltas = [], []
    for M in BOTH:
        out, d = _delta(M, n, _with_setup)
        res.append(out)
        deltas.append(d)
    _same(*res)
    jd, pd = deltas
    assert pd == jd
    assert pd["coll_persistent_starts_total"] == 3 * n
    assert pd["pml_partitioned_pready_total"] == 4 * n
    assert pd["coll_shm_fallback_total"] >= n
