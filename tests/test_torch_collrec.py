"""The port's collective flight recorder (``ompi_tpu_torch.mpi.trace``'s
``CollRecorder``, the dispatch choke point of ``mpi/coll/__init__.py``,
the nbc, persistent and arena-wait record sites) against the JAX
package's.

Each case mirrors one of ``tests/mpi/test_collrec.py``.  The same calls
go to both packages' recorders, and the same rank bodies through both
packages' in-process harnesses; the records must be equal but for their
timestamps.  The device route's records are the port's own: a torch
tensor's collective signs with the numpy type code and itemsize of the
dtype the JAX package signs for the same collective, bf16 included
(ml_dtypes' registration, 256), and each dtype is held against
``np.dtype(jnp.<t>)``.  The fault injector's ``@coll`` mismatch trigger
is mirrored in ``tests/test_torch_faultinject.py``.
"""

from __future__ import annotations

import threading
import time
import types
import uuid

import numpy as np
import pytest
import torch

from ompi_tpu.core.config import var_registry as jvars
from ompi_tpu.mpi import trace as jtrace
from ompi_tpu.mpi.mpit import pvar_registry as jpvars
from ompi_tpu_torch.core.config import var_registry as pvars
from ompi_tpu_torch.mpi import trace as ptrace
from ompi_tpu_torch.mpi.mpit import pvar_registry as ppvars
from tests.mpi.harness import run_ranks as jrun
from tests.torch_host_harness import run_ranks as prun

J = types.SimpleNamespace(name="jax", trace=jtrace, vars=jvars,
                          pvars=jpvars, run=jrun)
P = types.SimpleNamespace(name="port", trace=ptrace, vars=pvars,
                          pvars=ppvars, run=prun)
BOTH = (J, P)


@pytest.fixture(scope="module", autouse=True)
def _components_registered():
    """coll/shm registers its variables when the framework first opens
    (a collective on more than one rank) — before a test sets them."""
    for M in BOTH:
        M.run(2, lambda c: c.barrier())


@pytest.fixture(autouse=True)
def _fresh_recorders():
    for M in BOTH:
        M.trace.collrec.reset()
    yield
    for M in BOTH:
        M.trace.collrec.reset()


def _untimed(records):
    """Records without their timestamps: (rank, cid, seq, kind, phase,
    sig, info)."""
    return [tuple(r[1:]) for r in records]


# ---------------------------------------------------------------------------
# ring + bookkeeping
# ---------------------------------------------------------------------------

def test_ring_wraps_oldest_first():
    snaps = []
    for M in BOTH:
        rec = M.trace.CollRecorder(capacity=64)
        for _ in range(200):
            rec.post(0, 0, "barrier", 1, "shm", 0)
        assert rec.records_total == 200
        snap = rec.snapshot()
        assert len(snap) == 64
        assert snap[0][3] == 136 and snap[-1][3] == 199
        snaps.append(_untimed(snap))
    assert snaps[1] == snaps[0]


def _script(rec):
    """One call sequence for a recorder: streams, nesting, events, err."""
    out = [rec.post(0, 0, "barrier", 1, "shm", 0),
           rec.post(0, 0, "bcast", 1, "shm", 8),
           rec.post(0, 5, "bcast", 1, "shm", 8),
           rec.post(1, 0, "barrier", 1, "shm", 0)]
    outer = rec.post(0, 7, "barrier", 1, "shm", 0)
    inner = rec.post(0, 7, "allgather", 2, "host", 24)
    rec.done(0, 7, inner, "allgather")
    out.append(list(rec.head[:4]) + [rec.head[5]])
    out.append(rec.event(0, 7, "wait", {"on": 2}))
    rec.done(0, 7, outer, "barrier")
    out.append(list(rec.head[:4]) + [rec.head[5]])
    seq = rec.post(0, 9, "reduce", 7, "host", 64)
    rec.err(0, 9, seq, "reduce", "MPIException")
    out.append(((0, 9) in rec.current, rec.ops_total))
    out.append(rec.event(3, 3, "fold", {"k": 1}, seq=4, kind="pbcast"))
    return out


def test_recorder_bookkeeping_equals_the_jax_package():
    """Per-(rank, cid) seq streams, the nested-dispatch stack (a nested
    done re-exposes its parent as the head), event attribution, err
    records: the returned values and the tails are the JAX package's."""
    got = []
    for M in BOTH:
        rec = M.trace.CollRecorder()
        got.append((_script(rec), _untimed(rec.snapshot()),
                    [list(r[1:]) for r in rec.tail(5)]))
    assert got[1] == got[0]
    ret = got[1][0]
    assert ret[:4] == [0, 1, 0, 0]
    assert ret[4] == [0, 7, 0, ptrace.collrec_kind_id("barrier"), 0]
    assert ret[5] == (0, "barrier") and ret[6][4] == 1


def test_post_done_clears_current_and_marks_head():
    rec = ptrace.CollRecorder()
    seq = rec.post(0, 0, "allreduce", 7, "shm", 64)
    assert rec.current[(0, 0)][-1][0] == seq and rec.head[5] == 0
    rec.done(0, 0, seq, "allreduce")
    assert (0, 0) not in rec.current and rec.head[5] == 1


def test_tail_is_wire_safe_lists():
    rec = ptrace.CollRecorder()
    rec.post(0, 0, "barrier", 1, "shm", 0)
    tail = rec.tail(10)
    assert isinstance(tail[0], list) and tail[0][4] == "barrier"


# ---------------------------------------------------------------------------
# signature + kind table
# ---------------------------------------------------------------------------

def test_sig_is_deterministic_and_equal_the_jax_package():
    cases = [("allreduce", np.dtype("f8"), 64, -1),
             ("allreduce", np.dtype("f4"), 64, -1),
             ("allreduce", np.dtype("f8"), 128, -1),
             ("bcast", np.dtype("f8"), 64, 1), ("barrier", None, 0, -1),
             ("pallreduce", None, 4, -1), ("iallgather", None, 0, -1)]
    sigs = [ptrace.collrec_sig(k, d, n, r) for k, d, n, r in cases]
    assert sigs == [jtrace.collrec_sig(k, d, n, r) for k, d, n, r in cases]
    assert len(set(sigs)) == len(sigs)
    assert sigs[0] == ptrace.collrec_sig("allreduce", np.dtype("f8"), 64)


#: every dtype the device route takes, by its jax.numpy name
_DEVICE_DTYPES = ("bool_", "int8", "uint8", "int16", "uint16", "int32",
                  "uint32", "int64", "uint64", "float16", "bfloat16",
                  "float32", "float64", "complex64", "complex128",
                  "float8_e4m3fn", "float8_e5m2")


def _torch_dtype(name):
    return getattr(torch, "bool" if name == "bool_" else name)


@pytest.mark.parametrize("name", _DEVICE_DTYPES)
def test_torch_dtype_signs_as_the_jax_package_dtype(name):
    """Trouble spot: a torch.dtype has no ``.num``; the port signs it
    with its numpy counterpart's (num, itemsize) — held here against
    the JAX package's dtype, whose bf16 and float8 are ml_dtypes'."""
    import jax.numpy as jnp

    jd = np.dtype(getattr(jnp, name))
    td = _torch_dtype(name)
    assert ptrace._TORCH_DTYPE_NUM[str(td)] == (jd.num, jd.itemsize)
    assert td.itemsize == jd.itemsize
    for kind, nbytes in (("allreduce", 4096), ("bcast", 64 << 20)):
        assert ptrace.collrec_sig(kind, td, nbytes) == \
            jtrace.collrec_sig(kind, jd, nbytes)


def test_kind_ids_round_trip():
    for kind in ("barrier", "allreduce", "iallreduce", "pallreduce"):
        kid = ptrace.collrec_kind_id(kind)
        assert kid == jtrace.collrec_kind_id(kind) >= 0
        assert ptrace.collrec_kind_name(kid) == kind
    assert ptrace.collrec_kind_id("nope") == -1
    assert ptrace.collrec_kind_name(-1) == "?"
    assert ptrace.COLLREC_KINDS == jtrace.COLLREC_KINDS


# ---------------------------------------------------------------------------
# record sites (dispatch / nbc / persistent / arena waits / device route)
# ---------------------------------------------------------------------------

def _rank_records(M, rank):
    return [r for r in M.trace.collrec.snapshot() if r[1] == rank]


def _run_both(n, body):
    """Both packages' harnesses on ``body``; the records of every rank,
    untimed, per package, and the same records sorted.  The arena's
    ``wait`` edges are left out: a wait records one only once it
    outlives a park slice, which thread timing decides
    (``test_arena_wait_records_name_the_laggard`` holds them); and an
    nbc schedule advances a round in ``start()`` or in ``wait()`` as its
    peers' frames happen to arrive, so the sorted records are what both
    packages must share."""
    out = []
    for M in BOTH:
        M.run(n, body)
        out.append({r: [x for x in _untimed(_rank_records(M, r))
                        if x[4] != "wait"] for r in range(n)})
    return out


def _sorted(recs):
    return {r: sorted(v, key=repr) for r, v in recs.items()}


def test_dispatch_records_post_done_across_ranks():
    def body(comm):
        comm.barrier()
        comm.allreduce(np.ones(8))
        comm.bcast(np.arange(3.0) if comm.rank == 1 else None, root=1)
        comm.reduce(np.ones(4, np.int32), root=0)
        return comm.rank

    jrec, prec = _run_both(3, body)
    assert prec == jrec
    for rank in range(3):
        posts = [(c, s, k) for _r, c, s, k, ph, *_ in prec[rank]
                 if ph == "post"]
        dones = [(c, s, k) for _r, c, s, k, ph, *_ in prec[rank]
                 if ph == "done"]
        assert posts and posts[0][2] == "barrier"
        assert {(c, s) for c, s, _k in posts} == \
            {(c, s) for c, s, _k in dones}
    # the cross-rank matching invariant: identical (cid, seq) → kind, and
    # → signature where every rank passes the payload (a bcast's
    # non-roots pass None, so only its kind matches)
    for rank in (1, 2):
        for a, b in zip([r for r in prec[0] if r[4] == "post"],
                        [r for r in prec[rank] if r[4] == "post"]):
            assert a[1:4] == b[1:4]
            if a[3] in ("barrier", "allreduce", "reduce"):
                assert a[5] == b[5]


def test_nbc_records_rounds_and_done():
    def body(comm):
        comm.iallreduce(np.ones(4)).wait()
        comm.ibcast(np.ones(3) if comm.rank == 0 else None, root=0).wait()
        return comm.rank

    jrec, prec = _run_both(2, body)
    assert _sorted(prec) == _sorted(jrec)
    recs = prec[0]
    for phase in ("post", "round", "done"):
        assert any(r[3] == "iallreduce" and r[4] == phase for r in recs)


@pytest.mark.parametrize("shm", [True, False], ids=["shm", "nbc"])
def test_persistent_start_records_pstarts(shm):
    old = [(reg, reg.get("coll_shm_enable")) for reg in (jvars, pvars)]
    for reg in (jvars, pvars):
        reg.set("coll_shm_enable", shm)

    def body(comm):
        req = comm.allreduce_init(np.ones(8))
        for _ in range(3):
            req.start()
            req.wait()
        req.free()
        return comm.rank

    try:
        jrec, prec = _run_both(2, body)
    finally:
        for reg, v in old:
            reg.set("coll_shm_enable", v)
    assert _sorted(prec) == _sorted(jrec)
    recs = prec[0]
    starts = [r for r in recs if r[3] == "pallreduce" and r[4] == "post"]
    dones = [r for r in recs if r[3] == "pallreduce" and r[4] == "done"]
    # the nbc provider's Start runs a schedule that posts under the same
    # p<kind> name, in both packages
    assert len(starts) == len(dones) == (3 if shm else 6)
    if shm:
        assert any(r[4] == "pub" for r in recs)


def _two_arenas(M):
    import importlib

    shmseg = importlib.import_module(f"{M.trace.__name__.split('.')[0]}"
                                     f".core.shmseg")
    shm = importlib.import_module(f"{M.trace.__name__.split('.')[0]}"
                                  f".mpi.coll.shm")
    name = f"otpu-collrec-{uuid.uuid4().hex[:8]}"
    seg0 = shmseg.create(name, shm.Arena.nbytes_for(2, 4096))
    seg1 = shmseg.attach(seg0.path)
    seg0.unlink()
    return (shm.Arena(seg0, 2, 0, 4096, world=[0, 1]),
            shm.Arena(seg1, 2, 1, 4096, world=[0, 1]))


def _late_arrival(M, delay, wait):
    a0, a1 = _two_arenas(M)
    try:
        def late():
            time.sleep(delay)
            a1._set_arrive(1)

        t = threading.Thread(target=late, daemon=True)
        t.start()
        a0._set_arrive(1)
        wait(a0)
        t.join()
    finally:
        a0.close()
        a1.close()


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_arena_wait_records_name_the_laggard(native):
    old = [(reg, reg.get("coll_shm_native")) for reg in (jvars, pvars)]
    got = []
    try:
        for M in BOTH:
            M.vars.set("coll_shm_native", native)
            _late_arrival(M, 0.3, lambda a: a._wait_all_arrive(1, None))
            got.append([r[4:] for r in _untimed(_rank_records(M, 0))])
    finally:
        for reg, v in old:
            reg.set("coll_shm_native", v)
    assert got[1] == got[0]
    waits = [r for r in got[1] if r[0] == "wait"]
    assert waits and any((r[2] or {}).get("on") == 1 for r in waits)


def test_stuck_watchdog_records_and_counts():
    got = []
    for M in BOTH:
        before = M.trace.counters["coll_stuck_events_total"]
        old = M.vars.get("coll_stuck_timeout")
        M.vars.set("coll_stuck_timeout", 0.1)
        try:
            _late_arrival(M, 0.6, lambda a: a._wait_arrive(1, 1, None))
        finally:
            M.vars.set("coll_stuck_timeout", old)
        assert M.trace.counters["coll_stuck_events_total"] > before
        stucks = [r for r in _rank_records(M, 0) if r[5] == "stuck"]
        assert stucks and (stucks[0][7] or {}).get("on") == 1
        got.append([(r[5], (r[7] or {}).get("on")) for r in stucks])
    assert got[1] == got[0]


def test_head_gauges_ride_the_pvar_registry():
    def body(comm):
        comm.allreduce(np.ones(8))
        return comm.rank

    got = []
    for M in BOTH:
        M.run(2, body)
        vals = M.trace.metrics_values()
        assert vals["coll_cur_seq"] >= 0 and vals["coll_cur_done"] == 1
        assert M.pvars.lookup("coll_recorder_ops").read() == \
            M.trace.collrec.ops_total
        got.append({k: vals[k] for k in ("coll_cur_seq",
                                          "coll_cur_kind_id",
                                          "coll_cur_cid", "coll_cur_done",
                                          "coll_recorder_ops")})
    assert got[1] == got[0]
    assert ptrace.collrec_kind_name(int(got[1]["coll_cur_kind_id"])) \
        == "allreduce"


def test_flush_embeds_collrec_tail_and_validates(tmp_path):
    import json

    from ompi_tpu_torch.tools import trace_export

    tails = []
    for M in BOTH:
        M.trace.collrec.post(0, 0, "allreduce", 42, "shm", 64)
        M.trace.enable(capacity=64, rank=0, jobid=5)
        M.trace.instant("runtime", "x", rank=0)
        d = tmp_path / M.name
        d.mkdir()
        path = M.trace.flush(str(d / "ompi_tpu_trace_5_rank0.json"))
        M.trace.disable()
        doc = json.load(open(path))
        tail = doc["otherData"]["collrec"]
        assert tail[-1][4] == "allreduce" and tail[-1][5] == "post"
        merged = trace_export.merge([path])
        assert trace_export.validate(merged) == []
        assert merged["otherData"]["per_rank"]["0"]["collrec"] == tail
        tails.append([r[1:] for r in tail])
    assert tails[1] == tails[0]


def _device_comm():
    from ompi_tpu_torch.mpi.comm import Communicator
    from ompi_tpu_torch.mpi.device_comm import device_world
    from ompi_tpu_torch.mpi.group import Group
    from ompi_tpu_torch.parallel.mesh import make_mesh

    return Communicator(Group([0]), cid=0, my_world_rank=0).bind_device(
        device_world(make_mesh(device="cpu")))


@pytest.mark.parametrize("dtype,n", [("float32", 1024),
                                     ("bfloat16", 4096),
                                     ("float32", 16 << 10)])
def test_device_route_records_every_call(dtype, n):
    """The device route passes the choke point: one post and one done a
    call with provider ``xla`` and the tensor's bytes, the signature the
    JAX package's dispatch gives the same array, and one
    ``coll_dispatch_ns`` sample a call (a one-rank CPU mesh here; the
    card's run is chip_smoke's ``trace`` phase)."""
    import jax.numpy as jnp

    comm = _device_comm()
    t = torch.ones(n, dtype=getattr(torch, dtype))
    key = (f'coll_dispatch_ns{{slot="allreduce",provider="xla",'
           f'szb="{t.nbytes.bit_length()}"}}')
    h0 = sum(ptrace.hists.get(key, [0])[:ptrace.HIST_NBUCKETS])
    calls = 5
    for _ in range(calls):
        out = comm.allreduce(t)
    assert torch.equal(out, t)
    recs = _rank_records(P, 0)
    posts = [r for r in recs if r[5] == "post"]
    dones = [r for r in recs if r[5] == "done"]
    assert len(posts) == len(dones) == calls
    sig = jtrace.collrec_sig("allreduce", np.dtype(getattr(jnp, dtype)),
                             t.nbytes)
    for r in posts:
        assert r[4] == "allreduce" and r[6] == sig
        assert r[7] == {"prov": "xla", "nb": t.nbytes}
    assert [r[3] for r in posts] == list(range(calls))
    assert sum(ptrace.hists[key][:ptrace.HIST_NBUCKETS]) - h0 == calls
