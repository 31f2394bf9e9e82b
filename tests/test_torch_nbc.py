"""The port's nonblocking collectives (``ompi_tpu_torch.mpi.coll.nbc`` and
the communicator's 17 ``i*`` calls) against the JAX package's.

Each case mirrors one of ``tests/mpi/test_nbc.py`` and runs one rank body
on in-process ranks through the JAX package's harness and through the
port's (``tests/torch_host_harness.py``) with the same seeded numpy
inputs, at n = 2–5.  Both packages run the same libnbc-style schedules
over their PMLs, so every result must be equal bit for bit, with
coll/shm switched off in both packages and, in the ``*_with_the_arena``
cases, on in both (the arena carries the blocking calls a body compares
with).  Every ``i*`` entry point also refuses a torch tensor with the
PML's message before any tag is drawn.
"""

from __future__ import annotations

import time
import types

import numpy as np
import pytest
import torch

from ompi_tpu.core.config import var_registry as jvars
from ompi_tpu.mpi import op as jop
from ompi_tpu_torch.core.buffer import BufferLocationError
from ompi_tpu_torch.core.config import var_registry as pvars
from ompi_tpu_torch.mpi import datatype as pdt
from ompi_tpu_torch.mpi import op as pop
from ompi_tpu.mpi import datatype as jdt
from tests.mpi.harness import run_ranks as jrun
from tests.test_torch_host_p2p import _same
from tests.torch_host_harness import run_ranks as prun

J = types.SimpleNamespace(op=jop, dt=jdt)
P = types.SimpleNamespace(op=pop, dt=pdt)

SEED = 1313


def _set(name, value):
    for reg in (jvars, pvars):
        reg.set(name, value)


@pytest.fixture(autouse=True)
def host_only():
    """coll/shm's arena off in both packages (the arena cases turn it
    back on)."""
    import ompi_tpu.mpi.coll.shm  # noqa: F401 — registers coll_shm_enable
    import ompi_tpu_torch.mpi.coll.shm  # noqa: F401

    old = [(reg, reg.get("coll_shm_enable")) for reg in (jvars, pvars)]
    _set("coll_shm_enable", False)
    yield
    for reg, value in old:
        reg.set("coll_shm_enable", value)


def both(n, body):
    """(JAX package's per-rank results, port's)."""
    return jrun(n, lambda c: body(c, J)), prun(n, lambda c: body(c, P))


def _data(rank, shape, dtype="float64"):
    rng = np.random.default_rng(SEED + rank)
    if np.dtype(dtype).kind == "i":
        return rng.integers(-50, 50, size=shape).astype(dtype)
    return rng.normal(size=shape).astype(dtype)


# -- the cases of tests/mpi/test_nbc.py, as bodies returning their results

def _ibarrier(c, M):
    return c.ibarrier().wait()


def _ibcast(c, M):
    root = 1 % c.size
    buf = _data(0, (10,)) if c.rank == root else None
    return c.ibcast(buf, root=root).wait()


def _ireduce(c, M):
    mine = _data(c.rank, (5,))
    return (c.ireduce(mine, M.op.SUM, root=c.size - 1).wait(),
            c.ireduce(mine, M.op.MAX, root=0).wait())


def _iallreduce_matches_blocking(c, M):
    out = []
    for dtype in ("float32", "float64", "int32"):
        mine = _data(c.rank, (50,), dtype)
        nb = c.iallreduce(mine, M.op.SUM)
        blocking = c.allreduce(mine, M.op.SUM)
        out += [nb.wait(), blocking]
    return out


def _iallreduce_noncommutative(c, M):
    matmul = M.op.create_op(lambda a, b: a @ b, commutative=False)
    mat = np.array([[1.0, c.rank + 1], [0.0, 1.0]])
    return c.iallreduce(mat, op=matmul).wait()


def _iallreduce_max(c, M):
    return c.iallreduce(np.array([float(c.rank)]), M.op.MAX).wait()


def _igather_iscatter(c, M):
    mine = np.array([c.rank, c.rank * 2])
    g = c.igather(mine, root=0).wait()
    s = c.iscatter(g * 10 if c.rank == 0 else None, root=0).wait()
    return g, s


def _iallgather_ialltoall(c, M):
    ag = c.iallgather(_data(c.rank, (3,))).wait()
    a2a = c.ialltoall(np.arange(2 * c.size) + 100 * c.rank).wait()
    return ag, a2a


def _ireduce_scatter(c, M):
    arr = _data(c.rank, (c.size * 2 + 1,))
    return (c.ireduce_scatter(arr, M.op.SUM).wait(),
            c.ireduce_scatter_block(_data(c.rank, (c.size * 2, 3)),
                                    M.op.SUM).wait())


def _iscan_iexscan(c, M):
    mine = _data(c.rank, (4,))
    return c.iscan(mine, M.op.SUM).wait(), c.iexscan(mine, M.op.SUM).wait()


def _iv_forms(c, M):
    r = c.rank
    ag = c.iallgatherv(np.full(r + 1, float(r))).wait()
    parts = [np.full(r + d + 1, r * 10 + d) for d in range(c.size)]
    a2av = c.ialltoallv(parts).wait()
    gv = c.igatherv(_data(r, (r + 2,)), root=c.size - 1).wait()
    sv = c.iscatterv([_data(d, (d + 1, 2)) for d in range(c.size)]
                     if r == 0 else None, root=0).wait()
    return ag, a2av, gv, sv


def _ialltoallw(c, M):
    n, r = c.size, c.rank
    x = _data(r, (n * 3,), "float32")
    recv = [np.zeros(4, np.float32) for _ in range(n)]
    c.ialltoallw([(x, M.dt.FLOAT32, 2 + (i % 2)) for i in range(n)],
                 [(recv[i], M.dt.FLOAT32, 2 + (r % 2))
                  for i in range(n)]).wait()
    return recv


def _overlapping(c, M):
    r1 = c.iallreduce(np.array([1.0]), M.op.SUM)
    r2 = c.iallreduce(np.array([10.0 * (c.rank + 1)]), M.op.MAX)
    r3 = c.ibarrier()
    out = [r2.wait(), r1.wait()]     # out of issue order
    r3.wait()
    return out


def _ireduce_scatter_noncommutative(c, M):
    op = M.op.create_op(lambda a, b: a + b, commutative=False)
    arr = _data(c.rank, (c.size * 2,))
    req = c.ireduce_scatter(arr, op)
    # a blocking exchange between issue and wait would deadlock if the
    # constructor had blocked on the reduce phase
    nxt, prv = (c.rank + 1) % c.size, (c.rank - 1) % c.size
    got = c.sendrecv(np.array([c.rank]), nxt, source=prv)
    return int(got[0]), req.wait()


def _progress_via_test(c, M):
    req = c.iallreduce(_data(c.rank, (3,)), M.op.SUM)
    deadline = time.time() + 30
    while not req.test():
        assert time.time() < deadline, "nbc made no progress"
        time.sleep(0.001)
    return req.wait()


CASES = {f.__name__[1:]: f for f in (
    _ibarrier, _ibcast, _ireduce, _iallreduce_matches_blocking,
    _iallreduce_noncommutative, _iallreduce_max, _igather_iscatter,
    _iallgather_ialltoall, _ireduce_scatter, _iscan_iexscan, _iv_forms,
    _ialltoallw, _overlapping, _ireduce_scatter_noncommutative,
    _progress_via_test)}


@pytest.mark.parametrize("n", [2, 3, 4, 5])
@pytest.mark.parametrize("case", sorted(CASES))
def test_nbc_equals_the_jax_package(case, n):
    jax_res, port_res = both(n, CASES[case])
    _same(jax_res, port_res)


@pytest.mark.parametrize("n", [3, 4])
@pytest.mark.parametrize("case", ["iallreduce_matches_blocking",
                                  "overlapping", "iv_forms",
                                  "ireduce_scatter_noncommutative"])
def test_nbc_with_the_arena_equals_the_jax_package(case, n):
    _set("coll_shm_enable", True)
    jax_res, port_res = both(n, CASES[case])
    _same(jax_res, port_res)


def test_nbc_results_are_what_mpi_says():
    """The port's results against numpy, not only against the JAX
    package's (tests/mpi/test_nbc.py's own expectations)."""
    N = 4

    def body(c):
        r = c.rank
        return (c.iallreduce(np.arange(50.0) + r, pop.SUM).wait(),
                c.iscan(np.array([float(r + 1)]), pop.SUM).wait(),
                c.iexscan(np.array([float(r + 1)]), pop.SUM).wait(),
                c.ialltoall(np.arange(N) + 100 * r).wait())

    for r, (ar, sc, ex, a2a) in enumerate(prun(N, body)):
        np.testing.assert_array_equal(ar, np.arange(50.0) * N + 6)
        np.testing.assert_array_equal(sc, [sum(range(1, r + 2))])
        if r == 0:
            assert ex is None
        else:
            np.testing.assert_array_equal(ex, [sum(range(1, r + 1))])
        np.testing.assert_array_equal(a2a, [r + 100 * s for s in range(N)])


def test_every_i_collective_refuses_a_tensor_before_drawing_a_tag():
    """A torch tensor is refused with the PML's message; the refusal
    happens before the nbc tag sequence advances, so the next nonblocking
    collective still pairs."""
    def body(c):
        t = torch.ones(2 * c.size)
        h = np.ones(2 * c.size)
        calls = {
            "ibcast": lambda: c.ibcast(t, root=0),
            "ireduce": lambda: c.ireduce(t),
            "iallreduce": lambda: c.iallreduce(t),
            "igather": lambda: c.igather(t),
            "iscatter": lambda: c.iscatter(t, root=c.rank),
            "iallgather": lambda: c.iallgather(t),
            "ialltoall": lambda: c.ialltoall(t),
            "ireduce_scatter": lambda: c.ireduce_scatter(t),
            "iscan": lambda: c.iscan(t),
            "iexscan": lambda: c.iexscan(t),
            "iallgatherv": lambda: c.iallgatherv(t),
            "ialltoallv": lambda: c.ialltoallv([h] * (c.size - 1) + [t]),
            "igatherv": lambda: c.igatherv(t),
            "iscatterv": lambda: c.iscatterv([h, t] * c.size, root=c.rank),
            "ireduce_scatter_block": lambda: c.ireduce_scatter_block(t),
            "ialltoallw": lambda: c.ialltoallw(
                [None] * c.size,
                [None] * (c.size - 1) + [(t, pdt.FLOAT64, 1)]),
        }
        msgs = {}
        for name, call in calls.items():
            try:
                call()
                msgs[name] = None
            except BufferLocationError as e:
                msgs[name] = str(e)
        seq = c._nbc_seq
        out = c.iallreduce(h * (c.rank + 1)).wait()
        return msgs, seq, out

    for msgs, seq, out in prun(3, body):
        assert len(msgs) == 16
        for name, msg in msgs.items():
            assert msg is not None and msg.startswith(
                f"pml.{name}: got a device buffer"), (name, msg)
        assert seq == 0
        np.testing.assert_array_equal(out, np.full(6, 6.0))
