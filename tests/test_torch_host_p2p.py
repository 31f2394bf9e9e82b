"""The port's host point-to-point (``ompi_tpu_torch.mpi.pml``, its BTLs and
the communicator's p2p calls) against the JAX package's.

Each case runs one rank body on n = 2, 3 and 4 in-process ranks twice
(pairwise bodies pair rank 0 with 1 and 2 with 3; an odd last rank only
joins the barriers): through
``tests.mpi.harness.run_ranks`` (the JAX package's PML and communicator)
and through ``tests.torch_host_harness.run_ranks`` (the port's), with the
same seeded numpy inputs; a body gets the package's modules as ``M``.  Data
must be equal bit for bit, and so must every ``Status`` (source, tag,
count) and every error class.  Each body is also run with the port's
proc BTL left out: over the shm rings (``--mca btl ^proc``) and over tcp
sockets (``--mca btl ^proc,shm``), each with the native executors on and
off.
"""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from ompi_tpu.core.config import var_registry as jvars
from ompi_tpu.mpi import constants as jconst
from ompi_tpu.mpi import datatype as jdt
from ompi_tpu.mpi import request as jreq
from ompi_tpu_torch.core.buffer import BufferLocationError
from ompi_tpu_torch.core.config import var_registry as pvars
from ompi_tpu_torch.mpi import constants as pconst
from ompi_tpu_torch.mpi import datatype as pdt
from ompi_tpu_torch.mpi import pml as ppml
from ompi_tpu_torch.mpi import request as preq
from tests.mpi.harness import run_ranks as jrun
from tests.torch_host_harness import run_ranks as prun

J = types.SimpleNamespace(dt=jdt, C=jconst, Status=jreq.Status)
P = types.SimpleNamespace(dt=pdt, C=pconst, Status=preq.Status)

SEED = 20261017


_TRANSPORTS = {"proc": ("", True), "tcp": ("^proc,shm", True),
               "shm": ("^proc", True), "shm-python": ("^proc", False),
               "tcp-python": ("^proc,shm", False)}


@pytest.fixture(params=list(_TRANSPORTS))
def btl(request):
    """The port's transports: proc (ranks are threads of this process),
    tcp only, or the shm rings; the ``-python`` ones with the native
    executors off (the shm framing, the tcp plane and the matching
    engine run their Python branches)."""
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
    return (jrun(n, lambda c: body(c, J)), prun(n, lambda c: body(c, P)))


def _st(st):
    return (st.source, st.tag, st.count)


def _same(a, b):
    """Recursive bitwise equality of nested results."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (a, b)
        assert a.tobytes() == b.tobytes(), (a, b)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), (a, b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    else:
        assert a == b, (a, b)


def _data(shape, dtype=np.float32):
    rng = np.random.default_rng(SEED)
    return rng.normal(size=shape).astype(dtype)


def _pair(c):
    """(peer, sender?) of this rank: ranks pair 0↔1, 2↔3, ...; at an odd
    size the last rank has no peer (peer None) and only joins barriers."""
    peer = c.rank ^ 1
    return (peer if peer < c.size else None), c.rank % 2 == 0


def _eager(c, M):
    x = _data((6, 5)) + c.rank
    peer, sender = _pair(c)
    if peer is None:
        return None
    if sender:
        c.send(x, dest=peer, tag=7)
        c.send(x.astype(np.int32), dest=peer, tag=8)
        return None
    st, st2 = M.Status(), M.Status()
    got = c.recv(source=peer, tag=7, status=st)
    into = np.zeros(30, np.int32)
    out = c.recv(into, source=peer, tag=8, status=st2)
    return got, _st(st), out, _st(st2), into


def _rendezvous(c, M):
    x = _data((3, 40_000)) + c.rank
    peer, sender = _pair(c)
    if peer is None:
        return None
    if sender:
        c.send(x, dest=peer, tag=1)
        c.send(x[0], dest=peer, tag=2)
        return None
    st, st2 = M.Status(), M.Status()
    got = c.recv(source=peer, tag=1, status=st)       # allocate on match
    buf = np.empty(40_000, np.float32)
    c.recv(buf, source=peer, tag=2, status=st2)      # lands in place
    return got, _st(st), buf, _st(st2)


def _wildcards(c, M):
    if c.rank != 0:
        c.send(np.full(3, c.rank, np.int64), dest=0, tag=10 + c.rank)
        return None
    got = []
    for _ in range(c.size - 1):
        st = M.Status()
        out = c.recv(source=M.C.ANY_SOURCE, tag=M.C.ANY_TAG, status=st)
        got.append((_st(st), out))
    return sorted(got, key=lambda g: g[0])


def _unexpected_order(c, M):
    peer, sender = _pair(c)
    if peer is None or sender:
        for tag in ((5, 6, 7, 5) if peer is not None else ()):
            c.send(np.array([tag * 10 + c.rank], np.int32), dest=peer,
                   tag=tag)
        c.barrier()
        return None
    c.barrier()                    # all four frames wait unexpected
    out = [c.recv(source=peer, tag=7)]
    for _ in range(3):
        st = M.Status()
        out.append((c.recv(source=peer, tag=M.C.ANY_TAG, status=st),
                    _st(st)))
    return out


def _truncation(c, M):
    peer, sender = _pair(c)
    if peer is None:
        return None
    if sender:
        c.send(np.arange(10, dtype=np.float64), dest=peer, tag=3)
        return None
    try:
        c.recv(np.zeros(4, np.float64), source=peer, tag=3)
    except M.C.MPIException as e:
        return e.error_class, str(e)
    return None


def _send_modes(c, M):
    x = _data(64) + c.rank
    peer, sender = _pair(c)
    if peer is None:
        c.barrier()
        c.barrier()
        return None
    if sender:
        c.ssend(x, dest=peer, tag=1)
        c.pml.bsend_pool.attach(1 << 16)
        c.bsend(x, dest=peer, tag=2)
        c.pml.bsend_pool.detach()
        c.barrier()                # the peer posted tag 3 before this
        c.rsend(x, dest=peer, tag=3)
        c.send(x, dest=peer, tag=4)
        try:
            c.rsend(x, dest=peer, tag=99)    # nothing posted: peer nacks
        except M.C.MPIException as e:
            err = e.error_class
        c.barrier()
        return err
    st = [M.Status() for _ in range(4)]
    out = [c.recv(source=peer, tag=1, status=st[0]),
           c.recv(source=peer, tag=2, status=st[1])]
    req = c.irecv(np.empty(64, np.float32), source=peer, tag=3)
    c.barrier()
    out.append(req.wait())
    out.append(c.recv(source=peer, tag=4, status=st[3]))
    c.barrier()
    return out, [_st(s) for s in st[:2]] + [_st(req.status), _st(st[3])]


def _probes(c, M):
    x = _data(12) + c.rank
    peer, sender = _pair(c)
    if peer is None or sender:
        if peer is not None:
            c.send(x, dest=peer, tag=4)
            c.send(x[:5], dest=peer, tag=5)
            c.send(x[:3], dest=peer, tag=6)
        c.barrier()
        return None
    c.barrier()
    st = c.probe(source=peer, tag=4)
    ist = c.iprobe(source=M.C.ANY_SOURCE, tag=5)
    none = c.iprobe(source=peer, tag=77)
    msg, mst = c.mprobe(source=peer, tag=M.C.ANY_TAG)
    first = c.mrecv(message=msg)
    hit = c.improbe(source=peer, tag=6)
    rreq = c.imrecv(np.zeros(3, np.float32), message=hit[0])
    third = rreq.wait()
    rest = c.recv(source=peer, tag=5)
    return (_st(st), _st(ist), none, _st(mst), first, _st(hit[1]),
            third, _st(rreq.status), rest)


def _proc_null(c, M):
    c.send(np.ones(4), dest=M.C.PROC_NULL)
    st = M.Status()
    out = c.recv(source=M.C.PROC_NULL, status=st)
    msg, mst = c.mprobe(source=M.C.PROC_NULL)
    got = c.mrecv(message=msg)
    return out, (st.source, st.tag), got, _st(mst), msg.no_proc


def _derived(c, M):
    a = np.arange(48, dtype=np.float32).reshape(6, 8) + c.rank
    vec = M.dt.FLOAT32.vector(3, 2, 4).commit()
    sub = M.dt.create_subarray([6, 8], [2, 3], [1, 4], M.dt.FLOAT32).commit()
    peer, sender = _pair(c)
    if peer is None:
        return None
    if sender:
        c.send(a, dest=peer, tag=1, datatype=vec, count=2)
        c.send(a, dest=peer, tag=2, datatype=sub, count=1)
        c.send(a, dest=peer, tag=3, datatype=vec, count=2)
        return None
    st = M.Status()
    flat = c.recv(source=peer, tag=1, status=st)
    into = np.zeros((6, 8), np.float32)
    c.recv(into, source=peer, tag=2, datatype=sub, count=1)
    scattered = np.zeros((6, 8), np.float32)
    c.recv(scattered, source=peer, tag=3, datatype=vec, count=2)
    return flat, _st(st), into, scattered


def _sendrecv(c, M):
    right, left = (c.rank + 1) % c.size, (c.rank - 1) % c.size
    st = M.Status()
    got = c.sendrecv(np.full(3, c.rank, np.int32), dest=right, source=left,
                     sendtag=9, recvtag=9, status=st)
    buf = np.full(4, c.rank * 1.5)
    c.sendrecv_replace(buf, dest=left, source=right, sendtag=2, recvtag=2)
    d = c.dup()
    d.send(np.array([c.rank]), dest=right, tag=1)
    on_dup = d.recv(source=left, tag=1)
    return got, _st(st), buf, on_dup, d.cid != c.cid


CASES = {"eager": _eager, "rendezvous": _rendezvous,
         "wildcards": _wildcards, "unexpected_order": _unexpected_order,
         "truncation": _truncation, "send_modes": _send_modes,
         "probes": _probes, "proc_null": _proc_null,
         "derived_datatype": _derived, "sendrecv_dup": _sendrecv}


@pytest.fixture
def eager_1024():
    """Rendezvous above 1 KiB, 4 KiB fragments, in both packages."""
    old = [(reg, name, reg.get(name)) for reg in (jvars, pvars)
           for name in ("pml_eager_limit", "pml_frag_size")]
    for reg in (jvars, pvars):
        reg.set("pml_eager_limit", 1024)
        reg.set("pml_frag_size", 4096)
    yield
    for reg, name, value in old:
        reg.set(name, value)


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_p2p_equals_the_jax_package(case, n, btl):
    ref, port = both(n, CASES[case])
    _same(ref, port)


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("case", ["rendezvous", "send_modes", "probes",
                                  "derived_datatype"])
def test_p2p_rendezvous_at_1024_equals_the_jax_package(case, n,
                                                       eager_1024, btl):
    ref, port = both(n, CASES[case])
    _same(ref, port)


def test_truncation_is_err_truncate():
    res = prun(2, lambda c: _truncation(c, P))
    assert res[1][0] == pconst.ERR_TRUNCATE


def test_cpu_tensor_is_refused_by_send_and_recv():
    def body(c):
        t = torch.ones(4)
        errs = []
        for call in (lambda: c.send(t, dest=1 - c.rank),
                     lambda: c.recv(t, source=1 - c.rank),
                     lambda: c.pml.isend(t, 1 - c.rank, 0, c.cid),
                     lambda: c.pml.irecv(t, 1 - c.rank, 0, c.cid)):
            try:
                call()
            except BufferLocationError as e:
                errs.append(str(e))
        return errs

    for errs in prun(2, body):
        assert len(errs) == 4
        assert all("got a device buffer" in e for e in errs)


def test_buffer_attach_needs_an_initialized_runtime():
    with pytest.raises(pconst.MPIException, match="initialized runtime"):
        ppml.buffer_attach(1024)
