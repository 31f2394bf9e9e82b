"""The port's partitioned point-to-point (``psend_init``/``precv_init``,
Pready/Parrived, ``ompi_tpu_torch.mpi.pml``) and persistent point-to-point
(``send_init``/``recv_init``) against the JAX package's.

Each case mirrors one of ``tests/mpi/test_partitioned.py`` (and the
``send_init``/``recv_init`` cases of ``tests/mpi/test_p2p_modes.py``) and
runs one rank body on in-process ranks through the JAX package's harness
and through the port's with the same seeded numpy inputs: every received
buffer, every error caught and every ``parrived`` poll must be equal.
The port's ranks run over proc, the shm rings and tcp, each with the
native executors on and off.  Partitioned wire tags are ``-1_000_000 -
tag·2^24 - (offset + i)``: at user tags 200 and 1000 they leave int32,
and every transport must carry them whole.
"""

from __future__ import annotations

import random
import time
import types

import numpy as np
import pytest
import torch

from ompi_tpu.mpi import constants as jconst
from ompi_tpu.mpi import request as jreq
from ompi_tpu_torch.core.buffer import BufferLocationError
from ompi_tpu_torch.core.config import var_registry as pvars
from ompi_tpu_torch.mpi import constants as pconst
from ompi_tpu_torch.mpi import pml as ppml
from ompi_tpu_torch.mpi import request as preq
from tests.mpi.harness import run_ranks as jrun
from tests.test_torch_host_p2p import _TRANSPORTS, _same
from tests.torch_host_harness import run_ranks as prun

J = types.SimpleNamespace(C=jconst, req=jreq)
P = types.SimpleNamespace(C=pconst, req=preq)


@pytest.fixture(params=list(_TRANSPORTS))
def btl(request):
    """The port's transports (as tests/test_torch_host_p2p.py's)."""
    import ompi_tpu_torch.mpi.btl  # noqa: F401 — registers btl_
    import ompi_tpu_torch.mpi.btl_shm  # noqa: F401 — btl_shm_native

    names = ("btl_", "btl_shm_native", "btl_tcp_native",
             "pml_native_match")
    old = [(name, pvars.get(name)) for name in names]
    sel, native = _TRANSPORTS[request.param]
    pvars.set("btl_", sel)
    for name in names[1:]:
        pvars.set(name, native)
    yield request.param
    for name, value in old:
        pvars.set(name, value)


def both(n, body):
    """(JAX package's per-rank results, port's)."""
    return jrun(n, lambda c: body(c, J)), prun(n, lambda c: body(c, P))


def _pair(nparts, n, iters, seed, trickle=False, tag=4):
    """rank 0 psends to rank 1 with a fuzzed Pready order per iter."""
    def body(comm, M):
        if comm.rank == 0:
            buf = np.zeros(n)
            req = comm.psend_init(buf, dest=1, tag=tag, partitions=nparts)
            for it in range(iters):
                buf[...] = np.arange(float(n)) + 1000.0 * it
                req.start()
                order = list(range(nparts))
                random.Random(seed + it).shuffle(order)
                for i in order:
                    req.pready(i)
                    if trickle:
                        time.sleep(0.0005)
                req.wait()
            return True
        buf = np.full(n, -1.0)
        req = comm.precv_init(buf, source=0, tag=tag, partitions=nparts)
        outs = []
        for it in range(iters):
            req.start()
            got = req.wait()
            assert got is buf                 # zero-copy landing
            outs.append(buf.copy())
        return outs
    return body


def _check_pair(res, n, iters):
    assert len(res[1]) == iters
    for it, out in enumerate(res[1]):
        assert np.array_equal(out, np.arange(float(n)) + 1000.0 * it)


@pytest.mark.parametrize("nparts,n", [(1, 8), (3, 10), (4, 64), (7, 7),
                                      (6, 4)])
def test_pready_order_fuzz_equals_the_jax_package(nparts, n):
    jax_res, port_res = both(2, _pair(nparts, n, iters=5, seed=nparts))
    _same(jax_res, port_res)
    _check_pair(port_res, n, 5)


@pytest.mark.parametrize("tag", [4, 200, 1000])
def test_partitioned_over_every_transport(tag, btl):
    """Wire tags beyond int32 (user tags 200 and 1000) over proc, shm and
    tcp, native executors on and off; 4 KiB partitions of a 64 KiB
    buffer."""
    n = 8192
    jax_res = jrun(2, lambda c: _pair(16, n, 3, seed=tag, tag=tag)(c, J))
    port_res = prun(2, lambda c: _pair(16, n, 3, seed=tag, tag=tag)(c, P))
    _same(jax_res, port_res)
    _check_pair(port_res, n, 3)


def _parrived(comm, M):
    if comm.rank == 0:
        buf = np.arange(12.0)
        req = comm.psend_init(buf, dest=1, tag=2, partitions=3)
        req.start()
        req.pready(2)                      # out of order, alone
        comm.recv(source=1, tag=77)        # wait for the ack
        req.pready_list([0, 1])
        req.wait()
        return True
    buf = np.zeros(12)
    req = comm.precv_init(buf, source=0, tag=2, partitions=3)
    req.start()
    deadline = time.monotonic() + 30
    while not req.parrived(2):
        assert time.monotonic() < deadline
        time.sleep(0.001)
    seen_early = (req.parrived(2), req.parrived(0))
    got_third = np.array_split(buf.reshape(-1), 3)[2].copy()
    comm.send(np.zeros(0), dest=0, tag=77)
    req.wait()
    return seen_early, got_third, buf.copy()


def _channel_pairing(comm, M):
    if comm.rank == 0:
        a, b = np.full(6, 1.0), np.full(6, 2.0)
        s1 = comm.psend_init(a, dest=1, tag=5, partitions=2)
        s2 = comm.psend_init(b, dest=1, tag=5, partitions=3)
        s2.start()                      # the SECOND channel first
        s2.pready_range(0, 2)
        s1.start()
        s1.pready_range(0, 1)
        s1.wait()
        s2.wait()
        return True
    r1buf, r2buf = np.zeros(6), np.zeros(6)
    r1 = comm.precv_init(r1buf, source=0, tag=5, partitions=2)
    r2 = comm.precv_init(r2buf, source=0, tag=5, partitions=3)
    r1.start()
    r2.start()
    r1.wait()
    r2.wait()
    return r1buf.copy(), r2buf.copy()


def _distinct_tags(comm, M):
    if comm.rank == 0:
        a, b = np.full(8, 1.0), np.full(8, 2.0)
        s7 = comm.psend_init(a, dest=1, tag=7, partitions=4)
        s9 = comm.psend_init(b, dest=1, tag=9, partitions=4)
        s9.start()
        s9.pready_range(0, 3)
        s7.start()
        s7.pready_range(0, 3)
        s7.wait()
        s9.wait()
        return True
    r7buf, r9buf = np.zeros(8), np.zeros(8)
    r7 = comm.precv_init(r7buf, source=0, tag=7, partitions=4)
    r9 = comm.precv_init(r9buf, source=0, tag=9, partitions=4)
    r7.start()
    r9.start()
    r7.wait()
    r9.wait()
    return r7buf.copy(), r9buf.copy()


def _mixed_counts(comm, M):
    if comm.rank == 0:
        a, b = np.arange(8.0), np.arange(8.0) * 10
        s1 = comm.psend_init(a, dest=1, tag=0, partitions=8)
        s2 = comm.psend_init(b, dest=1, tag=0, partitions=2)
        s2.start()
        s2.pready_range(0, 1)
        s1.start()
        s1.pready_range(0, 7)
        s1.wait()
        s2.wait()
        return True
    b1, b2 = np.zeros(8), np.zeros(8)
    r1 = comm.precv_init(b1, source=0, tag=0, partitions=8)
    r2 = comm.precv_init(b2, source=0, tag=0, partitions=2)
    r1.start()
    r2.start()
    r1.wait()
    r2.wait()
    return b1.copy(), b2.copy()


def _abandoned_precv(comm, M):
    if comm.rank == 1:
        buf = np.zeros(6)
        pr = comm.precv_init(buf, source=0, tag=4, partitions=3)

        def boom():
            raise M.C.MPIException("boom")

        try:
            M.req.start_all([pr, M.req.PersistentRequest(boom)])
            return "no-raise"
        except M.C.MPIException:
            pass
        if pr.active:
            return "left-active"
        comm.send(np.zeros(0), dest=0, tag=99)   # sender may go
        pr.start()                                # fresh posts
        return pr.wait().copy()
    comm.recv(source=1, tag=99)                   # post-rollback
    ps = comm.psend_init(np.arange(6.0), dest=1, tag=4, partitions=3)
    ps.start()
    ps.pready_range(0, 2)
    ps.wait()
    return True


def _restart(comm, M):
    return _pair(4, 32, iters=8, seed=3, trickle=True)(comm, M)


def _error_surface(comm, M):
    hits = {}
    if comm.rank == 0:
        buf = np.arange(6.0)
        req = comm.psend_init(buf, dest=1, tag=1, partitions=3)
        try:
            req.pready(0)                     # inactive
        except M.C.MPIException:
            hits["inactive"] = True
        req.start()
        try:
            req.wait()                        # nothing readied
        except M.C.MPIException as e:
            hits["unready"] = "unready" in str(e)
        req.pready(1)
        try:
            req.pready(1)                     # double
        except M.C.MPIException:
            hits["double"] = True
        try:
            req.pready(3)                     # out of range
        except M.C.MPIException:
            hits["range"] = True
        req.pready_list([0, 2])
        req.wait()
        try:
            comm.psend_init(buf, dest=1, tag=1, partitions=0)
        except M.C.MPIException:
            hits["zero-parts"] = True
        try:
            comm.psend_init(np.arange(16.0).reshape(4, 4).T,
                            dest=1, tag=1, partitions=2)
        except M.C.MPIException:
            hits["non-contig"] = True
        return hits
    buf = np.zeros(6)
    req = comm.precv_init(buf, source=0, tag=1, partitions=3)
    req.start()
    req.wait()
    try:
        req.parrived(5)
    except M.C.MPIException:
        hits["parrived-range"] = True
    ro = np.zeros(4)
    ro.setflags(write=False)
    try:
        comm.precv_init(ro, source=0, tag=1, partitions=2)
    except M.C.MPIException:
        hits["read-only"] = True
    try:
        comm.precv_init(np.zeros(4), source=M.C.ANY_SOURCE, tag=1)
    except M.C.MPIException:
        hits["any-source"] = True
    return hits, buf.copy()


def _proc_null(comm, M):
    s = comm.psend_init(np.arange(4.0), dest=M.C.PROC_NULL, tag=0,
                        partitions=2)
    s.start()
    s.pready(0)
    s.pready(1)
    s.wait()
    rbuf = np.full(4, -2.0)
    r = comm.precv_init(rbuf, source=M.C.PROC_NULL, tag=0, partitions=2)
    r.start()
    out = r.wait()
    return r.parrived(0), rbuf.copy(), out is not None


def _startall_rollback(comm, M):
    """tests/mpi/test_coll_persistent.py's all-or-nothing Startall: the
    survivor of a failed Startall is restartable, not wedged active."""
    if comm.rank == 0:
        ps = comm.psend_init(np.arange(4.0), dest=1, tag=9, partitions=2)

        def boom():
            raise M.C.MPIException("boom")

        try:
            M.req.start_all([ps, M.req.PersistentRequest(boom)])
            return "no-raise"
        except M.C.MPIException:
            pass
        if ps.active:
            return "left-active"
        M.req.start_all([ps])
        ps.pready_range(0, 1)
        ps.wait()
        return True
    pr = comm.precv_init(np.zeros(4), source=0, tag=9, partitions=2)
    M.req.start_all([pr])
    return pr.wait().copy()


# -- persistent point-to-point (tests/mpi/test_p2p_modes.py)

def _persistent_send_recv_restart(comm, M):
    buf = np.zeros(8, np.float32)
    if comm.rank == 0:
        sreq = comm.send_init(buf, dest=1, tag=7)
        for i in range(4):
            buf[:] = i  # persistent semantics: buffer re-read per start
            sreq.start()
            sreq.wait(timeout=10)
        return True
    rreq = comm.recv_init(source=0, tag=7)
    got = []
    for _ in range(4):
        rreq.start()
        got.append(rreq.wait(timeout=10).copy())
    return got, (rreq.status.source, rreq.status.tag, rreq.status.count)


def _persistent_start_while_active(comm, M):
    if comm.rank == 1:
        rreq = comm.recv_init(source=0, tag=8)
        rreq.start()
        try:
            rreq.start()
            hit = "no-raise"
        except M.C.MPIException as e:
            hit = "MPI_Start" in str(e)
        comm.send(np.zeros(1, np.int8), dest=0, tag=70)
        return hit, rreq.wait(timeout=10)
    comm.recv(source=1, tag=70)
    comm.send(np.ones(2, np.float32), dest=1, tag=8)
    return True


def _persistent_into_buffer_and_proc_null(comm, M):
    if comm.rank == 0:
        x = np.arange(16, dtype=np.int32)
        s = comm.send_init(x, dest=1, tag=3, mode="sync")
        n = comm.send_init(x, dest=M.C.PROC_NULL, tag=3)
        M.req.start_all([s, n])
        s.wait()
        n.wait()
        return True
    land = np.zeros(16, np.int32)
    r = comm.recv_init(land, source=0, tag=3)
    n = comm.recv_init(source=M.C.PROC_NULL, tag=3)
    M.req.start_all([r, n])
    r.wait()
    return land.copy(), n.wait()


CASES = {f.__name__[1:]: f for f in (
    _parrived, _channel_pairing, _distinct_tags, _mixed_counts,
    _abandoned_precv, _restart, _error_surface, _proc_null,
    _startall_rollback, _persistent_send_recv_restart,
    _persistent_start_while_active, _persistent_into_buffer_and_proc_null)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_partitioned_and_persistent_p2p_equal_the_jax_package(case):
    jax_res, port_res = both(2, CASES[case])
    _same(jax_res, port_res)


@pytest.mark.parametrize("case", ["channel_pairing", "mixed_counts",
                                  "persistent_send_recv_restart"])
def test_partitioned_over_the_rings_and_tcp(case, btl):
    _same(jrun(2, lambda c: CASES[case](c, J)),
          prun(2, lambda c: CASES[case](c, P)))


def test_partitioned_results_are_what_mpi_says():
    (_, (early, third, full)) = prun(2, lambda c: _parrived(c, P))
    assert early == (True, False)
    assert np.array_equal(third, np.array_split(np.arange(12.0), 3)[2])
    assert np.array_equal(full, np.arange(12.0))
    hits, _ = prun(2, lambda c: _error_surface(c, P))[1]
    assert hits == {"parrived-range": True, "read-only": True,
                    "any-source": True}
    ready, rbuf, out = prun(2, lambda c: _proc_null(c, P))[0]
    assert ready and out and np.array_equal(rbuf, np.full(4, -2.0))


def test_new_p2p_entry_points_refuse_a_tensor():
    """send_init, recv_init, psend_init and precv_init refuse a torch
    tensor with the PML's message, and the refused psend/precv take no
    partition slots: the next channel on the same (peer, tag) pairs."""
    def body(c):
        t = torch.zeros(8)
        peer = 1 - c.rank
        msgs = []
        for call in (lambda: c.send_init(t, dest=peer),
                     lambda: c.recv_init(t, source=peer),
                     lambda: c.psend_init(t, dest=peer, tag=3,
                                          partitions=2),
                     lambda: c.precv_init(t, source=peer, tag=3,
                                          partitions=2),
                     lambda: c.pml.psend_init(t, peer, 3, c.cid, 2),
                     lambda: ppml.PartitionedRecvRequest(
                         c.pml, t, peer, 3, c.cid, 2)):
            try:
                call()
                msgs.append(None)
            except BufferLocationError as e:
                msgs.append(str(e))
        chans = dict(getattr(c.pml, "_part_chan", {}))
        if c.rank == 0:
            s = c.psend_init(np.arange(4.0), dest=1, tag=3, partitions=2)
            s.start()
            s.pready_range(0, 1)
            s.wait()
            return msgs, chans, True
        buf = np.zeros(4)
        r = c.precv_init(buf, source=0, tag=3, partitions=2)
        r.start()
        return msgs, chans, r.wait().copy()

    for rank, (msgs, chans, got) in enumerate(prun(2, body)):
        assert all(m is not None and "got a device buffer" in m
                   for m in msgs), msgs
        assert [m.split(":")[0] for m in msgs] == [
            "pml.send_init", "pml.recv_init", "pml.psend_init",
            "pml.precv_init", "pml.psend_init", "pml.precv_init"]
        assert chans == {}
    assert np.array_equal(got, np.arange(4.0))


def test_partitioned_pvars_account():
    """Mirror of the JAX package's test of the same name: 4 send starts
    + 4 recv starts and 4 iters x 3 partitions readied, counted by each
    package's ``pml_partitioned_{starts,pready}_total``."""
    from ompi_tpu.mpi import trace as jtrace
    from ompi_tpu_torch.mpi import trace as ptrace

    keys = ("pml_partitioned_starts_total", "pml_partitioned_pready_total")
    j0 = [jtrace.counters[k] for k in keys]
    p0 = [ptrace.counters[k] for k in keys]
    jax_res, port_res = both(2, _pair(3, 9, iters=4, seed=0))
    _same(jax_res, port_res)
    jd = [jtrace.counters[k] - v for k, v in zip(keys, j0)]
    pd = [ptrace.counters[k] - v for k, v in zip(keys, p0)]
    assert pd == jd == [8, 12]
