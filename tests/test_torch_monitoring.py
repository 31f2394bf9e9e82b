"""The port's MPI_T interface (``ompi_tpu_torch.mpi.mpit``), communication
monitoring (``ompi_tpu_torch.mpi.monitoring``) and memchecker
(``ompi_tpu_torch.core.memchecker``) against the JAX package's.

Each case mirrors one of ``tests/mpi/test_monitoring.py`` or
``tests/core/test_memchecker.py``.  Where the result is data — a cvar's
description, a pvar session's reads, a monitor's totals, rows, matrices
and dump, a tag's class, a poisoned buffer — the same rank body runs
through both packages' in-process harnesses and the port's result must
equal the JAX package's.  The monitored jobs run with coll/shm off in
both packages, so their collectives move their bytes through the PML
(coll/host), where a monitor sees them.
"""

from __future__ import annotations

import time
import types

import numpy as np
import pytest

from ompi_tpu.core import memchecker as jmem
from ompi_tpu.core.config import var_registry as jvars
from ompi_tpu.mpi import monitoring as jmon
from ompi_tpu.mpi import mpit as jmpit
from ompi_tpu.mpi.constants import MPIException as JMPIException
from ompi_tpu_torch.core import memchecker as pmem
from ompi_tpu_torch.core.config import var_registry as pvars
from ompi_tpu_torch.mpi import monitoring as pmon
from ompi_tpu_torch.mpi import mpit as pmpit
from ompi_tpu_torch.mpi.constants import MPIException
from tests.mpi.harness import run_ranks as jrun
from tests.test_torch_host_p2p import _same
from tests.torch_host_harness import run_ranks as prun

J = types.SimpleNamespace(mon=jmon, mpit=jmpit, mem=jmem, vars=jvars,
                          exc=JMPIException)
P = types.SimpleNamespace(mon=pmon, mpit=pmpit, mem=pmem, vars=pvars,
                          exc=MPIException)
BOTH = (J, P)


@pytest.fixture(autouse=True)
def host_collectives():
    """coll/shm off in both packages (and the PML's var registered)."""
    import ompi_tpu.mpi.coll.shm  # noqa: F401
    import ompi_tpu.mpi.pml  # noqa: F401
    import ompi_tpu_torch.mpi.coll.shm  # noqa: F401
    import ompi_tpu_torch.mpi.pml  # noqa: F401

    jrun(2, lambda c: c.barrier())     # opens coll/shm: its vars exist
    prun(2, lambda c: c.barrier())
    old = [(reg, reg.get("coll_shm_enable")) for reg in (jvars, pvars)]
    for reg in (jvars, pvars):
        reg.set("coll_shm_enable", False)
    yield
    for reg, v in old:
        reg.set("coll_shm_enable", v)


def both(n, body):
    """(JAX package's per-rank results, port's)."""
    return jrun(n, lambda c: body(c, J)), prun(n, lambda c: body(c, P))


# ---------------------------------------------------------------------------
# MPI_T cvars and pvars
# ---------------------------------------------------------------------------

def test_cvar_enumeration_and_read():
    names = pmpit.cvar_names()
    assert pmpit.cvar_num() == len(names) > 0
    assert "pml_eager_limit" in names
    info = pmpit.cvar_get_info("pml_eager_limit")
    assert info == jmpit.cvar_get_info("pml_eager_limit")
    assert info["type"] == "size"
    assert pmpit.cvar_read("pml_eager_limit") == info["default"]
    # the trace plane's cvars are the JAX package's, word for word
    from ompi_tpu.mpi import trace as _jtrace  # noqa: F401 — its vars
    from ompi_tpu_torch.mpi import trace as _ptrace  # noqa: F401

    for name in ("trace_hist_enable", "trace_metrics_push_period",
                 "memchecker_enable", "memchecker_nan_check",
                 "memchecker_poison"):
        assert name in names
        assert pmpit.cvar_get_info(name) == jmpit.cvar_get_info(name)


def test_cvar_write_roundtrip():
    old = pmpit.cvar_read("trace_hist_enable")
    try:
        pmpit.cvar_write("trace_hist_enable", False)
        assert pmpit.cvar_read("trace_hist_enable") is False
        pmpit.cvar_write("trace_hist_enable", "1")   # parsed like the env
        assert pmpit.cvar_read("trace_hist_enable") is True
    finally:
        pmpit.cvar_write("trace_hist_enable", old)


def test_cvar_unknown_raises():
    with pytest.raises(MPIException):
        pmpit.cvar_get_info("no_such_var")


def _session_script(M, tag):
    name = f"test_counter_{tag}"
    pv = M.mpit.pvar_registry.register_or_get(
        M.mpit.Pvar(name, M.mpit.PvarClass.COUNTER, unit="ops"))
    try:
        pv.inc(5)
        s = M.mpit.PvarSession()
        h = s.handle_alloc(name)
        h.reset()
        pv.inc(3)
        got = [h.read(), pv.read()]
        s.free()
    finally:
        M.mpit.pvar_registry.unregister(name)
    hwm = M.mpit.Pvar("h", M.mpit.PvarClass.HIGHWATERMARK)
    for v in (4, 2, 9):
        hwm.watermark(v)
    lwm = M.mpit.Pvar("l", M.mpit.PvarClass.LOWWATERMARK)
    for v in (0, 7):
        lwm.watermark(v)
    lwm2 = M.mpit.Pvar("l2", M.mpit.PvarClass.LOWWATERMARK)
    for v in (5, -3):
        lwm2.watermark(v)
    return got + [hwm.read(), lwm.read(), lwm2.read()]


def test_pvar_session_and_watermarks_equal_the_jax_package():
    got = [_session_script(M, i) for i, M in enumerate(BOTH)]
    assert got[1] == got[0] == [3, 8, 9, 0, -3]


def test_pvar_timer_handle():
    pv = pmpit.pvar_registry.register_or_get(
        pmpit.Pvar("test_timer_a", pmpit.PvarClass.TIMER, unit="s"))
    try:
        s = pmpit.PvarSession()
        h = s.handle_alloc("test_timer_a")
        h.start()
        time.sleep(0.02)
        h.stop()
        assert 0.01 < h.read() < 1.0
        h.reset()
        assert h.read() == 0.0
    finally:
        pmpit.pvar_registry.unregister("test_timer_a")


def test_pvar_duplicate_register_raises():
    pmpit.pvar_registry.register(
        pmpit.Pvar("test_dup", pmpit.PvarClass.COUNTER))
    try:
        with pytest.raises(MPIException):
            pmpit.pvar_registry.register(
                pmpit.Pvar("test_dup", pmpit.PvarClass.COUNTER))
    finally:
        pmpit.pvar_registry.unregister("test_dup")


def test_the_trace_planes_pvars_are_the_jax_packages():
    """Every pvar the port's trace plane registers is the JAX package's,
    with the same class, unit and description, but for the port's own
    model counters."""
    from ompi_tpu_torch.mpi import trace as ptrace

    names = [n for n in pmpit.pvar_registry.names()
             if not n.startswith("test_")]
    assert set(names) - set(jmpit.pvar_registry.names()) == \
        set(ptrace.MODEL_COUNTERS)
    for name in names:
        if name in ptrace.MODEL_COUNTERS:
            continue
        a, b = pmpit.pvar_registry.lookup(name), \
            jmpit.pvar_registry.lookup(name)
        assert (a.klass.value, a.unit, a.description) == \
            (b.klass.value, b.unit, b.description), name


# ---------------------------------------------------------------------------
# tag classification
# ---------------------------------------------------------------------------

def test_classify_tag_equals_the_jax_package():
    tags = [0, 42, 63, 500, 10_000] + [-1000 - t for t in range(1, 892)]
    assert [pmon.classify_tag(t) for t in tags] == \
        [jmon.classify_tag(t) for t in tags]
    assert pmon.classify_tag(-1500) == "osc"
    assert pmon.classify_tag(-1700) == "coll"
    assert pmon.CLASSES == jmon.CLASSES


# ---------------------------------------------------------------------------
# monitoring end to end
# ---------------------------------------------------------------------------

def test_monitor_counts_pt2pt_and_coll():
    def body(comm, M):
        with M.mon.Monitor(comm.pml, comm.size) as m:
            peer = (comm.rank + 1) % comm.size
            rreq = comm.irecv(source=(comm.rank - 1) % comm.size, tag=7)
            comm.send(np.arange(100, dtype=np.float64), dest=peer, tag=7)
            rreq.wait()
            comm.allreduce(np.ones(4))
            comm.barrier()
            return m.totals()

    jax_res, port_res = both(3, body)
    # unexpected vs matched depends on whether a frame beat its recv
    timing = ("unexpected", "matched")
    _same([{k: v for k, v in t.items() if k not in timing}
           for t in jax_res],
          [{k: v for k, v in t.items() if k not in timing}
           for t in port_res])
    for t in port_res:
        assert t["sent_count"]["pt2pt"] == 1
        assert t["sent_bytes"]["pt2pt"] == 800
        assert t["recv_count"]["pt2pt"] == 1
        assert t["sent_count"]["coll"] > 0
        assert t["sent_count"]["osc"] == 0


def test_monitor_per_peer_rows_and_matrix():
    def body(comm, M):
        with M.mon.Monitor(comm.pml, comm.size) as m:
            if comm.rank == 0:
                reqs = [comm.isend(np.zeros(10), dest=d, tag=1)
                        for d in range(1, comm.size)]
                for r in reqs:
                    r.wait()
            else:
                comm.recv(source=0, tag=1)
            comm.barrier()
            mat = M.mon.gather_matrix(comm, m, "sent_bytes")
            row = m.row("sent_bytes", cls="pt2pt")
        return mat, row

    jax_res, port_res = both(3, body)
    _same(jax_res, port_res)
    mat = port_res[0][0]
    assert port_res[0][1][1] == 80 and port_res[0][1][2] == 80
    assert all(r[0] is None for r in port_res[1:])
    assert mat[0, 1] >= 80 and mat[0, 2] >= 80


def test_monitor_unexpected_vs_matched():
    def body(comm, M):
        with M.mon.Monitor(comm.pml, comm.size) as m:
            comm.barrier()
            if comm.rank == 0:
                comm.send(np.ones(1), dest=1, tag=3)   # arrives unmatched
                comm.recv(source=1, tag=4)
            else:
                time.sleep(0.05)
                comm.recv(source=0, tag=3)
                comm.send(np.ones(1), dest=0, tag=4)
            return m.totals()

    for t0, t1 in both(2, body):
        assert t1["unexpected"] >= 1
        assert t0["matched"] + t0["unexpected"] >= 1


def test_monitor_detach_stops_counting():
    def body(comm, M):
        m = M.mon.Monitor(comm.pml, comm.size).attach()
        comm.barrier()
        m.detach()
        before = m.totals()["sent_count"]["coll"]
        comm.barrier()
        return before, m.totals()["sent_count"]["coll"]

    jax_res, port_res = both(2, body)
    assert port_res == jax_res
    for before, after in port_res:
        assert before == after


def test_second_exporting_monitor_conflicts_loudly():
    def body(comm, M):
        m = M.mon.Monitor(comm.pml, comm.size, register_pvars=True).attach()
        try:
            try:
                M.mon.Monitor(comm.pml, comm.size,
                              register_pvars=True).attach()
            except M.exc:
                ok = True
            else:
                ok = False
            M.mpit.pvar_registry.lookup(
                f"pml_monitoring_messages_count_{comm.pml.rank}")
            return ok
        finally:
            m.detach()

    jax_res, port_res = both(2, body)
    assert port_res == jax_res == [True, True]


def test_monitor_reattach_reexports_pvars():
    def body(comm, M):
        m = M.mon.Monitor(comm.pml, comm.size, register_pvars=True)
        rank = comm.pml.rank
        names = [f"pml_monitoring_messages_count_{rank}",
                 f"pml_monitoring_messages_recv_count_{rank}",
                 f"pml_monitoring_messages_recv_size_{rank}",
                 f"pml_monitoring_matched_{rank}"]
        m.attach()
        for n in names:
            M.mpit.pvar_registry.lookup(n)
        m.detach()
        gone = 0
        for n in names:
            try:
                M.mpit.pvar_registry.lookup(n)
            except M.exc:
                gone += 1
        m.attach()
        try:
            for n in names:
                M.mpit.pvar_registry.lookup(n)
            comm.barrier()
            return gone, m.totals()["sent_count"]["coll"] > 0
        finally:
            m.detach()

    jax_res, port_res = both(2, body)
    assert port_res == jax_res == [(4, True)] * 2


def test_monitor_recv_side_pvars_match_matrices():
    def body(comm, M):
        m = M.mon.Monitor(comm.pml, comm.size, register_pvars=True).attach()
        try:
            peer = (comm.rank + 1) % comm.size
            comm.send(np.zeros(8), dest=peer, tag=1)
            comm.recv(source=(comm.rank - 1) % comm.size, tag=1)
            comm.barrier()
            rank = comm.pml.rank
            s = M.mpit.PvarSession()
            rc = s.handle_alloc(
                f"pml_monitoring_messages_recv_count_{rank}", bound=m)
            rs = s.handle_alloc(
                f"pml_monitoring_messages_recv_size_{rank}", bound=m)
            mt = s.handle_alloc(f"pml_monitoring_matched_{rank}", bound=m)
            t = m.totals()
            return (rc.read(), rs.read(), mt.read(),
                    sum(t["recv_count"].values()),
                    sum(t["recv_bytes"].values()), t["matched"])
        finally:
            m.detach()

    jax_res, port_res = both(2, body)
    for rc, rs, mt, trc, trs, tmt in port_res:
        assert rc == trc and rc >= 1
        assert rs == trs and rs >= 64
        assert mt == tmt
    assert [r[:2] for r in port_res] == [r[:2] for r in jax_res]


def test_monitor_matrices_dict():
    def body(comm, M):
        with M.mon.Monitor(comm.pml, comm.size) as m:
            peer = (comm.rank + 1) % comm.size
            comm.send(np.zeros(10), dest=peer, tag=1)
            comm.recv(source=(comm.rank - 1) % comm.size, tag=1)
            comm.barrier()
            mats = m.matrices()
        mats["sent_count"]["coll"][:] = -1     # a snapshot, not live
        return mats, int(m.totals()["sent_count"]["coll"])

    jax_res, port_res = both(2, body)
    for (pm, pl), (jm, jl) in zip(port_res, jax_res):
        assert set(pm) == set(jm) == {"sent_count", "sent_bytes",
                                      "recv_count", "recv_bytes",
                                      "unexpected", "matched"}
        for what in ("sent_bytes", "recv_count", "recv_bytes"):
            _same({k: v for k, v in pm[what].items()},
                  {k: v for k, v in jm[what].items()})
        assert pl == jl >= 0
    assert int(port_res[0][0]["sent_bytes"]["pt2pt"][1]) == 80


def test_monitor_pvar_export():
    def body(comm, M):
        m = M.mon.Monitor(comm.pml, comm.size, register_pvars=True).attach()
        try:
            comm.send(np.zeros(4), dest=(comm.rank + 1) % comm.size, tag=1)
            comm.recv(source=(comm.rank - 1) % comm.size, tag=1)
            s = M.mpit.PvarSession()
            h = s.handle_alloc(
                f"pml_monitoring_messages_count_{comm.pml.rank}", bound=m)
            return h.read()
        finally:
            m.detach()

    jax_res, port_res = both(2, body)
    assert port_res == jax_res == [1, 1]


def test_monitor_dump_format():
    def body(comm, M):
        with M.mon.Monitor(comm.pml, comm.size) as m:
            comm.send(np.zeros(2), dest=(comm.rank + 1) % comm.size, tag=1)
            comm.recv(source=(comm.rank - 1) % comm.size, tag=1)
            return m.dump()

    jax_res, port_res = both(2, body)
    assert port_res == jax_res
    assert "# monitoring rank 0" in port_res[0]
    assert "pt2pt -> 1: 1 msgs 16 B" in port_res[0]


def test_profiler_counts_and_times():
    def body(comm, M):
        p = M.mon.Profiler(comm)
        p.allreduce(np.ones(4))
        p.allreduce(np.ones(4))
        p.barrier()
        assert p.rank == comm.rank and p.size == comm.size
        return {k: n for k, (n, _t) in p.report().items()}, \
            p.report()["allreduce"][1] > 0.0

    jax_res, port_res = both(2, body)
    assert port_res == jax_res
    assert port_res[0][0] == {"allreduce": 2, "barrier": 1}


# ---------------------------------------------------------------------------
# memchecker
# ---------------------------------------------------------------------------

@pytest.fixture
def memcheck_on():
    for reg in (jvars, pvars):
        reg.set("memchecker_enable", True)
    yield
    for reg in (jvars, pvars):
        reg.set("memchecker_enable", False)


def test_memchecker_disabled_by_default():
    assert not pmem.enabled()
    assert pvars.get("memchecker_nan_check") is True
    assert pvars.get("memchecker_poison") is True


@pytest.mark.parametrize("payload", [
    np.array([1.0, np.nan]), np.array([1.0, 2.0]),
    np.array([1, 2], np.int32), np.array([np.nan], np.float32),
    np.array(["a"], object)], ids=["nan", "clean", "int", "f4nan", "obj"])
def test_memchecker_send_verdicts_equal(memcheck_on, payload):
    verdicts = []
    for M in BOTH:
        try:
            M.mem.check_send(payload)
            verdicts.append("ok")
        except M.mem.MemcheckError as e:
            verdicts.append(str(e))
    assert verdicts[1] == verdicts[0]


def test_memchecker_readonly_recv_rejected(memcheck_on):
    buf = np.zeros(4)
    buf.flags.writeable = False
    with pytest.raises(pmem.MemcheckError):
        pmem.prepare_recv(buf)


@pytest.mark.parametrize("dtype", ["f8", "f4", "i4", "u1", "c8"])
def test_memchecker_recv_poisoned_like_the_jax_package(memcheck_on, dtype):
    got = []
    for M in BOTH:
        b = np.zeros(6, dtype)
        M.mem.prepare_recv(b)
        got.append(b.tobytes())
    assert got[1] == got[0]


def test_memchecker_end_to_end_via_pml(memcheck_on):
    def body(comm, M):
        if comm.rank == 0:
            try:
                comm.send(np.array([np.nan]), dest=1, tag=1)
                raised = False
            except Exception:  # noqa: BLE001 — the memchecker's verdict
                raised = True
            comm.send(np.array([1.0]), dest=1, tag=2)
            return raised
        return float(comm.recv(source=0, tag=2)[0])

    jax_res, port_res = both(2, body)
    assert port_res == jax_res == [True, 1.0]
