"""The port's hang doctor (``ompi_tpu_torch.runtime.doctor``), its PMIx
port registry and the offline tool (``ompi_tpu_torch.tools.hang_doctor``)
against the JAX package's.

Each case mirrors one of ``tests/runtime/test_doctor.py``.  The analyzer
is a pure function: every synthetic capture set goes to both packages'
``analyze`` and the verdict documents must be equal.  The rank side (the
UDP responder, ``capture`` with the PML's pending summary) and the
offline tool run on the port, and the tool's captures are analysed by
both packages.  Two launched jobs close the loop: a collective mismatch
and a straggler, each ended by ``tpurun --timeout``, named from the
ranks' crash dumps.  The live modes (the orted's TAG_DOCTOR fan-out and
``--uri``) come with ROADMAP.md Queue 1 item 6.15; the PMIx revive that
drops a dead life's port comes with item 6.10.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from ompi_tpu.runtime import doctor as jdoctor
from ompi_tpu_torch.mpi import trace as ptrace
from ompi_tpu_torch.runtime import doctor, pmix
from ompi_tpu_torch.tools import hang_doctor

ROOT = Path(__file__).resolve().parents[1]


def _cap(rank, posts=(), waits=(), dones=(), cur=None, pending=None,
         **extra):
    """One synthetic capture: posts/waits/dones are (cid, seq, kind,
    sig|on) tuples appended in order."""
    t = [1000]

    def rec(cid, seq, kind, phase, sig=0, info=None):
        t[0] += 1
        return [t[0], rank, cid, seq, kind, phase, sig, info]

    recs = []
    for cid, seq, kind, sig in posts:
        recs.append(rec(cid, seq, kind, "post", sig,
                        {"prov": "shm", "nb": 0}))
    for cid, seq, kind, on in waits:
        recs.append(rec(cid, seq, kind, "wait", 0, {"on": on}))
    for cid, seq, kind in dones:
        recs.append(rec(cid, seq, kind, "done"))
    cap = {"rank": rank, "collrec": recs}
    if cur is not None:
        cap["cur"] = cur
    if pending is not None:
        cap["pending"] = pending
    cap.update(extra)
    return cap


def _inflight(cid, seq, kind):
    return {"cid": cid, "seq": seq, "kind": kind, "done": False,
            "age_s": 3.0}


def _pend(src):
    return {"recvs": [{"src": src, "tag": 7, "cid": 0, "age_s": 2.5}],
            "sends": [], "rndv": [], "unexpected": 0, "parked": {},
            "queued": {}}


def _frozen_caps():
    kid = ptrace.collrec_kind_id("allreduce")
    pushed_ts = time.time() - 4.0
    return [
        _cap(0, posts=[(0, 9, "allreduce", 5)],
             waits=[(0, 9, "allreduce", 1)],
             cur=_inflight(0, 9, "allreduce")),
        {"rank": 1, "no_response": True,
         "proc": {"pid": 1234, "state": "T"},
         "pushed": {"coll_cur_seq": 9, "coll_cur_cid": 0,
                    "coll_cur_kind_id": kid, "coll_cur_done": 0,
                    "coll_cur_posted_ts": pushed_ts}},
        _cap(2, posts=[(0, 9, "allreduce", 5)],
             waits=[(0, 9, "allreduce", 1)],
             cur=_inflight(0, 9, "allreduce")),
    ]


#: (name, captures, nranks, expected verdict kind, expected rank)
_CASES = {
    "no_data": ([], None, "no_data", None),
    "healthy": ([_cap(r, posts=[(0, 0, "barrier", 5)],
                      dones=[(0, 0, "barrier")],
                      cur={"cid": 0, "seq": 0, "kind": "barrier",
                           "done": True}) for r in range(2)],
                None, "healthy", None),
    "mismatch_kinds": ([
        _cap(0, posts=[(0, 4, "allreduce", 99)],
             cur=_inflight(0, 4, "allreduce")),
        _cap(1, posts=[(0, 4, "bcast", 12)], cur=_inflight(0, 4, "bcast")),
        _cap(2, posts=[(0, 4, "allreduce", 99)],
             cur=_inflight(0, 4, "allreduce"))], 3, "mismatch", 1),
    "mismatch_signature": ([
        _cap(0, posts=[(0, 2, "allreduce", 111)]),
        _cap(1, posts=[(0, 2, "allreduce", 222)]),
        _cap(2, posts=[(0, 2, "allreduce", 111)])], None, "mismatch", 1),
    "v_collective_sig": ([
        _cap(0, posts=[(0, 2, "gatherv", 111)], dones=[(0, 2, "gatherv")]),
        _cap(1, posts=[(0, 2, "gatherv", 222)],
             dones=[(0, 2, "gatherv")])], None, "healthy", None),
    "deadlock": ([_cap(0, pending=_pend(1)), _cap(1, pending=_pend(0))],
                 None, "deadlock", None),
    "straggler_waits": ([
        _cap(0, posts=[(0, 7, "allreduce", 5)],
             waits=[(0, 7, "allreduce", 2)],
             cur=_inflight(0, 7, "allreduce")),
        _cap(1, posts=[(0, 7, "allreduce", 5)],
             waits=[(0, 7, "allreduce", 2)],
             cur=_inflight(0, 7, "allreduce")),
        _cap(2, posts=[(0, 7, "allreduce", 5)],
             cur=_inflight(0, 7, "allreduce"),
             stacks={"MainThread": "  File 'app.py', line 3\n"})],
        3, "straggler", 2),
    "straggler_frozen": (_frozen_caps(), 3, "straggler", 1),
}


def _ageless(doc):
    """A verdict document without the ages read off the wall clock."""
    if isinstance(doc, dict):
        return {k: _ageless(v) for k, v in doc.items() if k != "age_s"}
    if isinstance(doc, list):
        return [_ageless(v) for v in doc]
    return doc


@pytest.mark.parametrize("case", sorted(_CASES))
def test_analyze_equals_the_jax_package(case):
    caps, nranks, kind, rank = _CASES[case]
    kw = {} if nranks is None else {"nranks": nranks}
    got = doctor.analyze(json.loads(json.dumps(caps)), **kw)
    want = jdoctor.analyze(json.loads(json.dumps(caps)), **kw)
    # a frozen rank's age is taken against the clock at analysis
    assert _ageless(got) == _ageless(want)
    v = got["verdict"]
    assert v["kind"] == kind
    if rank is not None:
        assert v["rank"] == rank
    if case == "mismatch_kinds":
        assert v["ranks"] == [1] and (v["cid"], v["op_seq"]) == (0, 4)
        assert v["kinds"] == {"0": "allreduce", "1": "bcast",
                              "2": "allreduce"}
    if case == "deadlock":
        assert v["cycle"][0] == v["cycle"][-1]
        assert set(v["cycle"]) == {0, 1}
    if case == "straggler_waits":
        assert (v["op_seq"], v["in"]) == (7, "allreduce")
        assert "app.py" in v.get("stack", "")
    if case == "straggler_frozen":
        assert "SIGSTOP" in v["detail"] and got["no_response"] == [1]


def test_summarize_rows_equals_the_jax_package():
    caps = [_cap(r, posts=[(0, r % 3, "allreduce", 5)],
                 cur=_inflight(0, r % 3, "allreduce")) for r in range(12)]
    caps[4]["no_response"] = True
    for limit in (0, 3, 8, 20):
        assert doctor.summarize_rows(json.loads(json.dumps(caps)), limit) \
            == jdoctor.summarize_rows(json.loads(json.dumps(caps)), limit)


# ---------------------------------------------------------------------------
# rank side: responder + capture
# ---------------------------------------------------------------------------

def test_responder_capture_round_trip():
    ptrace.collrec.reset()
    ptrace.collrec.post(0, 0, "allreduce", 42, "shm", 64)
    resp = doctor.DoctorResponder(0, jobid=3)
    try:
        cap = doctor.query_rank(resp.port, timeout=2.0)
        tl = doctor.query_timeline(resp.port, tail=16, timeout=2.0)
    finally:
        resp.close()
        ptrace.collrec.reset()
    assert cap is not None and cap["rank"] == 0 and cap["jobid"] == 3
    assert cap["cur"]["kind"] == "allreduce" and not cap["cur"]["done"]
    assert any(r[5] == "post" for r in cap["collrec"])
    assert "MainThread" in cap["stacks"]
    # the timeline is disarmed: an empty tail with the clock anchor
    assert tl is not None and tl["events"] == [] and "counters" in tl


def test_capture_includes_pml_pending():
    from ompi_tpu_torch.mpi.pml import PmlOb1

    pml = PmlOb1(0)
    try:
        req = pml.irecv(np.empty(4), source=1, tag=9, cid=0)
        time.sleep(0.01)
        cap = doctor.capture(0, pml=pml)
        pend = cap["pending"]
        assert any(rv["src"] == 1 and rv["tag"] == 9
                   for rv in pend["recvs"])
        assert pend["unexpected"] == 0
        assert set(pend) == {"recvs", "sends", "rndv", "unexpected",
                             "parked", "queued"}
        req.cancel()
    finally:
        pml.close()


def test_pending_summary_shape_equals_the_jax_package():
    from ompi_tpu.mpi.pml import PmlOb1 as JPml
    from ompi_tpu_torch.mpi.pml import PmlOb1 as PPml

    got = []
    for cls in (JPml, PPml):
        pml = cls(0)
        try:
            reqs = [pml.irecv(np.empty(4), source=s, tag=t, cid=0)
                    for s, t in ((1, 9), (2, 3))]
            summ = pml.pending_summary()
            for rv in summ["recvs"]:
                rv.pop("age_s")
            got.append(summ)
            for r in reqs:
                r.cancel()
        finally:
            pml.close()
    assert sorted(got[1]["recvs"], key=str) == \
        sorted(got[0]["recvs"], key=str)
    assert {k: v for k, v in got[1].items() if k != "recvs"} == \
        {k: v for k, v in got[0].items() if k != "recvs"}


def test_query_rank_silence_returns_none():
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    try:
        assert doctor.query_rank(s.getsockname()[1], timeout=0.2) is None
    finally:
        s.close()


def test_proc_probe_reads_own_state():
    st = doctor.proc_probe(os.getpid())
    assert st["pid"] == os.getpid() and st["state"] in ("R", "S")


def test_pmix_doctor_port_registration_and_probe():
    server = pmix.PMIxServer(size=2)
    try:
        client = pmix.PMIxClient(uri=server.uri, rank=0, size=2)
        client.register_doctor(4242)
        assert client.doctor_ports() == {0: 4242}
        assert pmix.query_doctor_ports(server.uri) == {0: 4242}
        client.finalize()
    finally:
        server.close()
    assert pmix.query_doctor_ports(server.uri, timeout=0.2) is None


# ---------------------------------------------------------------------------
# offline mode (hang_doctor over crash dumps)
# ---------------------------------------------------------------------------

def _dump(tmp_path, jobid, rank, recs, stuck=0):
    doc = {"displayTimeUnit": "ns",
           "otherData": {"rank": rank, "jobid": jobid, "collrec": recs,
                         "counters": {"coll_stuck_events_total": stuck}},
           "traceEvents": []}
    path = tmp_path / f"ompi_tpu_trace_{jobid}_rank{rank}.json"
    path.write_text(json.dumps(doc))
    return path


def _both_verdicts(tmp_path, jobid):
    doc = hang_doctor.offline_doc(str(tmp_path), jobid)
    paths = sorted(str(p) for p in
                   tmp_path.glob(f"ompi_tpu_trace_{jobid}_rank*.json"))
    caps = hang_doctor.offline_captures(paths)
    assert doctor.analyze(caps) == jdoctor.analyze(
        json.loads(json.dumps(caps)))
    return doc


def test_hang_doctor_offline_names_straggler(tmp_path, capsys):
    for r in (0, 2):
        _dump(tmp_path, 7, r, [
            [100, r, 0, 5, "allreduce", "post", 9, {}],
            [101, r, 0, 5, "allreduce", "wait", 0, {"on": 1}],
        ], stuck=1)
    _dump(tmp_path, 7, 1, [[100, 1, 0, 5, "allreduce", "post", 9, {}]])
    doc = _both_verdicts(tmp_path, 7)
    assert (doc["verdict"]["kind"], doc["verdict"]["rank"]) == \
        ("straggler", 1)
    assert hang_doctor.main(["--dir", str(tmp_path), "--jobid", "7",
                             "--expect", "straggler:1"]) == 0
    assert hang_doctor.main(["--dir", str(tmp_path), "--jobid", "7",
                             "--expect", "mismatch"]) == 1
    capsys.readouterr()


def test_hang_doctor_offline_outer_op_wedged_after_nested_done(tmp_path):
    for r in (0, 2):
        _dump(tmp_path, 9, r, [
            [100, r, 0, 0, "barrier", "post", 7, {}],
            [101, r, 0, 1, "allgather", "post", 8, {}],
            [102, r, 0, 1, "allgather", "done", 0, None],
            [103, r, 0, 0, "barrier", "wait", 0, {"on": 1}],
        ])
    _dump(tmp_path, 9, 1, [
        [100, 1, 0, 0, "barrier", "post", 7, {}],
        [101, 1, 0, 1, "allgather", "post", 8, {}],
        [102, 1, 0, 1, "allgather", "done", 0, None],
    ])
    v = _both_verdicts(tmp_path, 9)["verdict"]
    assert v["kind"] == "straggler" and v["rank"] == 1, v
    assert v["in"] == "barrier" and v["op_seq"] == 0, v


def test_hang_doctor_offline_names_mismatch(tmp_path, capsys):
    _dump(tmp_path, 8, 0, [[100, 0, 0, 3, "allreduce", "post", 9, {}]])
    _dump(tmp_path, 8, 1, [[100, 1, 0, 3, "bcast", "post", 2, {}]])
    v = _both_verdicts(tmp_path, 8)["verdict"]
    assert v["kind"] == "mismatch" and v["rank"] == 1
    assert (v["cid"], v["op_seq"]) == (0, 3)
    assert hang_doctor.main(["--dir", str(tmp_path), "--jobid", "8",
                             "--expect", "mismatch:1"]) == 0
    capsys.readouterr()


# ---------------------------------------------------------------------------
# launched jobs: a hang ended by tpurun --timeout, named from the dumps
# ---------------------------------------------------------------------------

_MISMATCH = """
import numpy as np, ompi_tpu_torch
c = ompi_tpu_torch.init()
c.barrier()
x = np.ones(1024)
if c.rank == 1:
    c.bcast(x, root=0)
else:
    c.allreduce(x)
c.barrier()
ompi_tpu_torch.finalize()
"""

_STRAGGLER = """
import time, numpy as np, ompi_tpu_torch
c = ompi_tpu_torch.init()
c.allreduce(np.ones(1024))
if c.rank == 1:
    time.sleep(120)
c.allreduce(np.ones(1024))
ompi_tpu_torch.finalize()
"""


@pytest.mark.parametrize("job,mca,expect", [
    (_MISMATCH, ["--mca", "coll_shm_enable", "0"], "mismatch:1"),
    (_STRAGGLER, [], "straggler:1")], ids=["mismatch", "straggler"])
def test_launched_hang_is_named_from_the_dumps(tmp_path, job, mca,
                                               expect):
    out = subprocess.run(
        [sys.executable, "-m", "ompi_tpu_torch.tools.tpurun", "-np", "4",
         "--trace", "--timeout", "5", "--no-tag-output", *mca, "--",
         sys.executable, "-c", job],
        cwd=ROOT, capture_output=True, text=True, timeout=90,
        env={**os.environ, "TMPDIR": str(tmp_path)})
    assert out.returncode == 124, out.stderr[-2000:]
    assert len(list(tmp_path.glob("ompi_tpu_trace_*_rank*.json"))) == 4
    jobid = int(next(tmp_path.glob("ompi_tpu_trace_*_rank0.json"))
                .name.split("_")[3])
    res = subprocess.run(
        [sys.executable, "-m", "ompi_tpu_torch.tools.hang_doctor",
         "--dir", str(tmp_path), "--jobid", str(jobid),
         "--expect", expect], cwd=ROOT, capture_output=True, text=True,
        timeout=60)
    assert res.returncode == 0, res.stdout + res.stderr
    _both_verdicts(tmp_path, jobid)
