"""The port's persistent collectives (``ompi_tpu_torch.mpi.coll.persistent``,
the communicator's 10 ``*_init`` calls, coll/shm's ``PersistentSlots``
and coll/host's ``freeze_decision``) against the JAX package's.

Each case mirrors one of ``tests/mpi/test_coll_persistent.py`` and runs
one rank body on in-process ranks through the JAX package's harness and
through the port's with the same seeded numpy inputs.  A body returns
every Start's result with the plan's ``provider`` (``self``, ``shm``,
``hier``, ``host``, ``nbc``, ``topo``) and ``algorithm`` (``root_fold`` /
``segment_parallel``), and both packages must give the same, bit for
bit: the arena plans fold the pinned parity slots in rank order in both
(native executor or numpy chain), the nbc plans run the same schedules.
Cases run with coll/shm on in both packages (their default: the
``shm``/``hier`` providers) and off in both (``nbc``/``host``), and the
arena plans with the native executors on and off.  A bind is collective
and maps a segment through collectives of its own, so both packages run
the same sequence of binds.
"""

from __future__ import annotations

import random
import time
import types

import numpy as np
import pytest
import torch

from ompi_tpu.core.config import var_registry as jvars
from ompi_tpu.mpi import constants as jconst
from ompi_tpu.mpi import op as jop
from ompi_tpu.mpi import request as jreq
from ompi_tpu.mpi.coll import shm as jshm
from ompi_tpu_torch.core.buffer import BufferLocationError
from ompi_tpu_torch.core.config import var_registry as pvars
from ompi_tpu_torch.mpi import constants as pconst
from ompi_tpu_torch.mpi import op as pop
from ompi_tpu_torch.mpi import request as preq
from ompi_tpu_torch.mpi.coll import shm as pshm
from tests.mpi.harness import run_ranks as jrun
from tests.test_torch_host_p2p import _same
from tests.torch_host_harness import run_ranks as prun

J = types.SimpleNamespace(C=jconst, op=jop, req=jreq, vars=jvars)
P = types.SimpleNamespace(C=pconst, op=pop, req=preq, vars=pvars)

_VARS = ("coll_shm_enable", "coll_shm_native", "coll_shm_arena_size",
         "coll_shm_slot_size", "coll_shm_allreduce_algorithm",
         "coll_shm_segpar_min", "coll_host_dynamic_rules",
         "coll_host_allreduce_algorithm", "coll_host_allgather_algorithm")


def _set(name, value):
    for reg in (jvars, pvars):
        reg.set(name, value)


@pytest.fixture(autouse=True)
def restore_vars():
    import ompi_tpu.mpi.coll.host  # noqa: F401 — registers its vars
    import ompi_tpu_torch.mpi.coll.host  # noqa: F401

    old = [(reg, name, reg.get(name)) for reg in (jvars, pvars)
           for name in _VARS]
    _set("coll_shm_enable", True)
    yield
    for reg, name, value in old:
        reg.set(name, value)


@pytest.fixture(params=["native", "python"])
def native(request):
    """The arena plans' data plane: the native executor or numpy."""
    _set("coll_shm_native", request.param == "native")
    return request.param


@pytest.fixture
def host_only():
    _set("coll_shm_enable", False)


@pytest.fixture
def segpar_forced():
    _set("coll_shm_allreduce_algorithm", "segment_parallel")


def both(n, body):
    """(JAX package's per-rank results, port's)."""
    return jrun(n, lambda c: body(c, J)), prun(n, lambda c: body(c, P))


def _loop(req, buf, fill, iters):
    outs = []
    for k in range(iters):
        fill(buf, k)
        req.start()
        out = req.wait()
        outs.append(None if out is None else np.copy(out))
    return outs


# -- provider selection + steady-state parity

def _full_kind_sweep(comm, M, iters=5):
    r = comm.rank
    a = np.zeros(8)
    ar = comm.allreduce_init(a)
    all_outs = _loop(ar, a, lambda b, k: b.__setitem__(
        ..., np.arange(8.0) + r + k), iters)
    pay = np.zeros(3)
    land = np.zeros(3)
    root = 1 % comm.size
    bc = comm.bcast_init(pay if r == root else land, root=root)
    b_outs = _loop(bc, pay, lambda b, k: b.__setitem__(
        ..., np.array([k, k + 1.0, k + 2.0])) if r == root else None,
        iters)
    red = comm.reduce_init(np.full(4, r + 1.0), root=comm.size - 1)
    red.start()
    red_out = red.wait()
    ga = comm.allgather_init(np.array([r, 10 * r]))
    ga.start()
    g = ga.wait()
    bar = comm.barrier_init()
    bar.start()
    bar.wait()
    plans = (ar, bc, red, ga, bar)
    return (all_outs, b_outs, red_out, g, land,
            [(q.provider, q.algorithm) for q in plans])


def _every_kind(comm, M):
    """All 10 ``*_init`` kinds once (the neighbor ones over a ring
    cart), each started twice with the bound buffers changed between."""
    n, r = comm.size, comm.rank
    rng = np.random.default_rng(31 + r)
    x = rng.integers(-9, 9, size=(n * 2, 3)).astype(np.float32)
    parts = [rng.normal(size=(r + d + 1,)) for d in range(n)]
    cart = comm.cart_create([n], periods=[True])
    nparts = [rng.normal(size=(2,)), rng.normal(size=(3,))]
    land = np.zeros_like(x)
    plans = {
        "barrier": comm.barrier_init(),
        "bcast": comm.bcast_init(x if r == 0 else land, root=0),
        "reduce": comm.reduce_init(x, M.op.MAX, root=n - 1),
        "allreduce": comm.allreduce_init(x, M.op.SUM),
        "allgather": comm.allgather_init(x),
        "alltoall": comm.alltoall_init(x),
        "alltoallv": comm.alltoallv_init(parts),
        "reduce_scatter": comm.reduce_scatter_init(x, M.op.SUM),
        "neighbor_alltoall": cart.neighbor_alltoall_init(nparts),
        "neighbor_alltoallv": cart.neighbor_alltoallv_init(nparts),
    }
    outs = {k: [] for k in plans}
    for k in range(2):
        x += 1.0
        for p in parts:
            p *= 2.0
        for name, q in plans.items():
            q.start()
            out = q.wait()
            if isinstance(out, list):
                out = [None if o is None else np.copy(o) for o in out]
            elif out is not None:
                out = np.copy(out)
            outs[name].append(out)
    return outs, {k: (q.provider, q.algorithm) for k, q in plans.items()}


def _bcast_recvbuf(comm, M):
    pay = np.zeros(4)
    land = np.full(4, -1.0)
    req = comm.bcast_init(pay if comm.rank == 0 else land, root=0)
    hits = []
    for k in range(4):
        pay[...] = k + np.arange(4.0)
        req.start()
        out = req.wait()
        if comm.rank != 0:
            hits.append(out is land and np.array_equal(
                land, k + np.arange(4.0)))
    return hits, req.provider


_FUZZ_DTYPES = (np.float64, np.float32, np.int64, np.int32, np.uint8)


def _fuzz_body(seed, iters):
    def body(comm, M):
        rng = np.random.default_rng(seed + comm.rank)
        shape = tuple(int(x) for x in
                      np.random.default_rng(seed).integers(1, 7, size=2))
        dt = _FUZZ_DTYPES[seed % len(_FUZZ_DTYPES)]
        mine = np.zeros(shape, dt)
        ar = comm.allreduce_init(mine)
        ga = comm.allgather_init(mine)
        outs = []
        for k in range(iters):
            mine[...] = rng.integers(0, 50, size=shape).astype(dt)
            ar.start()
            got = ar.wait()
            want = comm.allreduce(mine)          # one-shot, same data
            ga.start()
            g_got = ga.wait()
            g_want = comm.allgather(mine)
            outs.append((np.copy(got), want, np.copy(g_got), g_want))
        return ar.provider, ga.provider, outs
    return body


def _check_fuzz(res, provider):
    for prov, gprov, outs in res:
        assert prov == gprov == provider
        for got, want, g_got, g_want in outs:
            assert got.tobytes() == np.asarray(want).tobytes()
            assert g_got.tobytes() == np.asarray(g_want).tobytes()


@pytest.mark.parametrize("n", [2, 4, 5])
def test_full_kind_sweep_equals_the_jax_package(n, native):
    jax_res, port_res = both(n, _full_kind_sweep)
    _same(jax_res, port_res)
    for r, (all_outs, b_outs, red_out, g, land, provs) in enumerate(
            port_res):
        assert provs == [("shm", "root_fold")] + [("shm", None)] * 4
        for k, o in enumerate(all_outs):
            assert np.array_equal(
                o, np.arange(8.0) * n + sum(range(n)) + n * k), (k, o)
        for k, o in enumerate(b_outs):
            assert np.array_equal(o, [k, k + 1.0, k + 2.0]), (k, o)
        if r == n - 1:
            assert np.array_equal(red_out, np.full(4, n * (n + 1) / 2))
        else:
            assert red_out is None
        assert np.array_equal(g, [[i, 10 * i] for i in range(n)])


@pytest.mark.parametrize("n", [2, 3, 4])
def test_every_kind_equals_the_jax_package(n):
    jax_res, port_res = both(n, _every_kind)
    _same(jax_res, port_res)
    provs = port_res[0][1]
    assert provs["neighbor_alltoall"] == ("topo", None)
    assert provs["allreduce"] == ("shm", "root_fold")
    assert provs["alltoall"] == ("shm", None)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_every_kind_without_the_arena_equals_the_jax_package(n, host_only):
    jax_res, port_res = both(n, _every_kind)
    _same(jax_res, port_res)
    provs = port_res[0][1]
    assert {p for p, _ in provs.values()} == {"nbc", "host", "topo"}


def test_bcast_lands_in_bound_recvbuf_every_cycle():
    jax_res, port_res = both(3, _bcast_recvbuf)
    _same(jax_res, port_res)
    assert all(all(h) for h, _ in port_res[1:])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fuzz_parity_vs_oneshot_shm(seed, native):
    jax_res, port_res = both(4, _fuzz_body(seed, 6))
    _same(jax_res, port_res)
    _check_fuzz(port_res, "shm")


@pytest.mark.parametrize("seed", [0, 2])
def test_fuzz_parity_vs_oneshot_host(seed, host_only):
    jax_res, port_res = both(3, _fuzz_body(seed, 4))
    _same(jax_res, port_res)
    _check_fuzz(port_res, "nbc")


@pytest.mark.parametrize("hosts", [
    ("a", "a", "b", "b"),
    ("a", "b", "b", "b"),
    ("a", "b", "a", "b"),
])
def test_fuzz_parity_vs_oneshot_hier(hosts):
    def body(comm, M):
        comm._io_host_override = hosts[comm.rank]
        out = _fuzz_body(1, 4)(comm, M)
        bc = comm.bcast_init(np.arange(5.0) if comm.rank == 2 else None,
                             root=2)
        red = comm.reduce_init(np.arange(3.0) + comm.rank, root=1)
        bar = comm.barrier_init()
        got = []
        for q in (bc, red, bar):
            q.start()
            got.append(q.wait())
        return out, got, [q.provider for q in (bc, red, bar)]

    jax_res, port_res = both(len(hosts), body)
    _same(jax_res, port_res)
    _check_fuzz([out for out, _, _ in port_res], "hier")
    assert all(p == ["hier"] * 3 for _, _, p in port_res)


def _noncommutative(comm, M):
    mine = np.zeros((2, 2))
    req = comm.allreduce_init(mine, op=M.op.REPLACE)
    mine[...] = comm.rank + 1.0
    req.start()
    got = req.wait()
    want = comm.allreduce(mine, op=M.op.REPLACE)
    return req.provider, got, want


def _above_cap(comm, M):
    big = np.ones(int(M.vars.get("coll_shm_arena_size")) // 8 + 16)
    req = comm.allreduce_init(big)
    req.start()
    out = req.wait()
    return req.provider, out


def _host_directive(comm, M):
    req = comm.allreduce_init(np.arange(6.0) + comm.rank)
    req.start()
    ga = comm.allgather_init(np.arange(3) * comm.rank)
    ga.start()
    return req.provider, req.wait(), ga.provider, ga.wait()


def _size_one(comm, M):
    ar = comm.allreduce_init(np.arange(3.0))
    ar.start()
    a = ar.wait()
    ga = comm.allgather_init(np.array([7]))
    ga.start()
    g = ga.wait()
    bar = comm.barrier_init()
    bar.start()
    bar.wait()
    a2a = comm.alltoall_init(np.arange(4.0))
    a2a.start()
    return ar.provider, a, g, a2a.provider, a2a.wait()


def test_noncommutative_binds_nbc_and_matches():
    jax_res, port_res = both(3, _noncommutative)
    _same(jax_res, port_res)
    for prov, got, want in port_res:
        assert prov == "nbc" and np.array_equal(got, want)


def test_payload_above_cap_binds_nbc():
    _set("coll_shm_arena_size", 32 << 10)
    jax_res, port_res = both(2, _above_cap)
    _same(jax_res, port_res)
    for prov, out in port_res:
        assert prov == "nbc" and float(out[0]) == 2.0


def test_host_directive_freezes_named_algorithm():
    _set("coll_host_allreduce_algorithm", "ring")
    _set("coll_host_allgather_algorithm", "bruck")
    jax_res, port_res = both(3, _host_directive)
    _same(jax_res, port_res)
    for prov, out, gprov, _g in port_res:
        assert prov == gprov == "host"
        assert np.array_equal(out, np.arange(6.0) * 3 + 3)


def test_size_one_self_provider():
    jax_res, port_res = both(1, _size_one)
    _same(jax_res, port_res)
    prov, a, g, a2a_prov, _ = port_res[0]
    assert prov == a2a_prov == "self"
    assert np.array_equal(a, np.arange(3.0))
    assert np.array_equal(g, [[7]])


@pytest.mark.parametrize("coll", ["allreduce", "allgather", "bcast"])
def test_freeze_decision_equals_the_jax_package(coll):
    """coll/host's bind-time freezing names the algorithm the JAX
    package's does, for every forced choice and the fixed ladder."""
    from ompi_tpu.mpi.coll import coll_framework as jcoll
    from ompi_tpu_torch.mpi.coll import coll_framework as pcoll

    jhost = jcoll.lookup("host")
    phost = pcoll.components()["host"]
    choices = {"allreduce": ["", "recursive_doubling", "ring",
                             "segmented_ring", "linear"],
               "allgather": ["", "bruck", "ring"],
               "bcast": ["", "binomial", "linear", "pipeline"]}[coll]
    comm = types.SimpleNamespace(size=4)
    try:
        for forced in choices:
            _set(f"coll_host_{coll}_algorithm", forced)
            for nbytes in (64, 16 << 10, 4 << 20):
                for op in (None, jop.SUM, jop.REPLACE):
                    pop_ = None if op is None else getattr(
                        pop, op.name.upper())
                    j = jhost.freeze_decision(coll, comm, nbytes, op)[1]
                    p = phost.freeze_decision(coll, comm, nbytes, pop_)[1]
                    assert p == j, (forced, nbytes, op, p, j)
        for fixed in ("barrier", "reduce", "alltoallv", "scan", "exscan"):
            assert (phost.freeze_decision(fixed, comm, 64)[1]
                    == jhost.freeze_decision(fixed, comm, 64)[1])
    finally:
        _set(f"coll_host_{coll}_algorithm", "")


# -- parity double-buffer overlap

def _staggered(comm, M, iters=25):
    rng = random.Random(101 + comm.rank)
    buf = np.zeros(16)
    req = comm.allreduce_init(buf)
    outs = []
    for k in range(iters):
        buf[...] = 10.0 * k + comm.rank
        req.start()
        if rng.random() < 0.5:
            time.sleep(rng.random() * 0.002)   # delay my drain
        outs.append(req.wait().copy())
        if rng.random() < 0.3:
            time.sleep(rng.random() * 0.002)   # delay my next start
    return req.provider, outs


def _root_runahead(comm, M, iters=20):
    pay = np.zeros(8)
    land = np.zeros(8)
    req = comm.bcast_init(pay if comm.rank == 0 else land, root=0)
    outs = []
    for k in range(iters):
        if comm.rank == 0:
            pay[...] = k * 3.0 + np.arange(8.0)
        req.start()
        if comm.rank == comm.size - 1:
            time.sleep(0.001)                  # the slow reader
        outs.append(np.copy(req.wait()))
    return outs


def _reduce_runahead(comm, M, iters=12):
    """A non-root's reduce completes at its publish, so it free-runs:
    only the depart guard two ops back keeps its op k+2 publish off the
    parity slot the slow root has not folded yet."""
    buf = np.zeros(8)
    req = comm.reduce_init(buf, root=0)
    outs = []
    for k in range(iters):
        buf[...] = 100.0 * k + comm.rank + np.arange(8.0)
        req.start()
        if comm.rank == 0:
            time.sleep(0.002)                  # the slow root
        out = req.wait()
        outs.append(None if out is None else np.copy(out))
    return req.provider, outs


def _interleaves(comm, M):
    r = comm.rank
    buf = np.zeros(4)
    req = comm.allreduce_init(buf)
    big = np.ones(4096) * (r + 1)              # > half a 16 KiB slot
    outs = []
    for k in range(6):
        buf[...] = k + r
        req.start()
        p = req.wait()
        outs.append((np.copy(p), comm.allreduce(big)))
    return req.provider, outs


def test_parity_overlap_staggered_drains(native):
    N = 3
    jax_res, port_res = both(N, _staggered)
    _same(jax_res, port_res)
    for prov, outs in port_res:
        assert prov == "shm"
        for k, o in enumerate(outs):
            assert np.array_equal(
                o, np.full(16, 10.0 * k * N + sum(range(N)))), (k, o)


def test_parity_overlap_root_runahead_bcast(native):
    jax_res, port_res = both(4, _root_runahead)
    _same(jax_res, port_res)
    for outs in port_res:
        for k, o in enumerate(outs):
            assert np.array_equal(o, k * 3.0 + np.arange(8.0)), (k, o)


def test_parity_overlap_reduce_runahead(native):
    N = 4
    jax_res, port_res = both(N, _reduce_runahead)
    _same(jax_res, port_res)
    prov, outs = port_res[0]
    assert prov == "shm"
    for k, o in enumerate(outs):
        assert np.array_equal(o, N * (100.0 * k + np.arange(8.0))
                              + sum(range(N))), (k, o)


def test_persistent_interleaves_with_oneshot_segmented_pipeline():
    _set("coll_shm_slot_size", 16 << 10)
    jax_res, port_res = both(3, _interleaves)
    _same(jax_res, port_res)
    for prov, outs in port_res:
        assert prov == "shm"
        for k, (p, big) in enumerate(outs):
            assert np.array_equal(p, np.full(4, 3 * k + 3))
            assert float(big[0]) == 6.0


# -- Startall composition, request semantics

def _startall(comm, M):
    r = comm.rank
    bar = comm.barrier_init()
    a = np.zeros(4)
    ar = comm.allreduce_init(a)
    a[...] = r
    M.req.start_all([bar, ar])
    bar.wait()
    return ar.wait()


def _free_poisons(comm, M):
    req = comm.allreduce_init(np.ones(2))
    req2 = comm.allgather_init(np.ones(2))
    req.start()
    req.wait()
    comm.barrier()
    comm.free()
    out = [req.provider, req2.provider]
    for q in (req, req2):
        try:
            q.start()
            out.append(None)
        except M.C.MPIException as e:
            out.append("freed" in str(e))
    return out


def _request_free(comm, M):
    req = comm.barrier_init()
    req.start()
    req.wait()
    comm.barrier()
    req.free()
    try:
        req.start()
        return False
    except M.C.MPIException:
        return True


def _inactive(comm, M):
    req = comm.allreduce_init(np.ones(2))
    seen = [req.active, req.test(), M.req.request_get_status(req)[0]]
    req.start()
    seen.append(req.active)
    out = req.wait()
    seen.append(req.active)
    req.start()                          # restart after wait
    return seen, float(req.wait()[0]) + float(out[0])


def _double_start(comm, M):
    req = comm.allreduce_init(np.ones(2))
    req.start()
    try:
        req.start()
        hit = False
    except M.C.MPIException:
        hit = True
    comm.barrier()
    return hit, req.wait()


def _shape_change(comm, M):
    holder = {"buf": np.ones(4)}

    class Reader:
        def __array__(self, dtype=None, copy=None):
            return np.asarray(holder["buf"], dtype)

    req = comm.allreduce_init(Reader())
    req.start()
    req.wait()
    comm.barrier()
    holder["buf"] = np.ones(9)          # signature change
    try:
        req.start()
        return False
    except M.C.MPIException as e:
        comm.barrier()
        return "changed" in str(e)


def _rebind(comm, M):
    buf = np.arange(6.0) + comm.rank
    req = comm.allreduce_init(buf)
    req.start()
    first = req.wait()
    req.rebind()                        # collective recompile
    buf += 1.0
    req.start()
    return first, req.wait(), req.provider


CASES = {f.__name__[1:]: f for f in (
    _startall, _free_poisons, _request_free, _inactive, _double_start,
    _shape_change, _rebind)}


@pytest.mark.parametrize("arena", [True, False], ids=["arena", "host"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_request_semantics_equal_the_jax_package(case, arena):
    _set("coll_shm_enable", arena)
    jax_res, port_res = both(3, CASES[case])
    _same(jax_res, port_res)


def test_comm_free_frees_every_bound_plan():
    for out in prun(2, lambda c: _free_poisons(c, P)):
        assert out == [None, None, True, True]


# -- segment-parallel allreduce

@pytest.mark.parametrize("seed", range(3))
def test_segpar_bit_parity_vs_root_fold_and_oneshot(seed, segpar_forced,
                                                    native):
    rng = np.random.default_rng(seed)
    dtype = np.dtype(["f8", "f4", "i8", "i2"][seed % 4])
    opname = ["SUM", "MIN", "MAX"][seed % 3]
    n = int(rng.integers(3, 4000))   # includes n < p (empty segments)

    def body(comm, M):
        op = getattr(M.op, opname)
        r = np.random.default_rng(7 + comm.rank)
        if dtype.kind == "f":
            x = (r.standard_normal(n) * 2).astype(dtype)
        else:
            x = r.integers(1, 4, size=n).astype(dtype)
        req_seg = comm.allreduce_init(x, op=op)
        comm.barrier()
        if comm.rank == 0:
            M.vars.set("coll_shm_allreduce_algorithm", "root_fold")
        comm.barrier()
        req_root = comm.allreduce_init(x, op=op)
        comm.barrier()
        if comm.rank == 0:
            M.vars.set("coll_shm_allreduce_algorithm", "segment_parallel")
        comm.barrier()
        outs = []
        for _ in range(5):
            req_seg.start()
            a = req_seg.wait()
            req_root.start()
            b = req_root.wait()
            outs.append((np.copy(a), np.copy(b)))
        one = comm.allreduce(x, op=op)
        algs = (req_seg.provider, req_seg.algorithm, req_root.algorithm)
        req_seg.free()
        req_root.free()
        return outs, one, algs

    jax_res, port_res = both(5, body)
    _same(jax_res, port_res)
    for outs, one, algs in port_res:
        assert algs == ("shm", "segment_parallel", "root_fold")
        for a, b in outs:
            assert a.tobytes() == b.tobytes() == one.tobytes()


def test_segpar_parity_overlap_staggered_drains(segpar_forced, native):
    def body(comm, M):
        x = np.empty(512)
        req = comm.allreduce_init(x)
        outs = []
        for k in range(16):
            x[...] = (k + 1) * (comm.rank + 1)
            req.start()
            if comm.rank == 0:
                time.sleep(0.002)   # rank 0 drags one op behind
            outs.append(np.copy(req.wait()))
        alg = req.algorithm
        req.free()
        return alg, outs

    p = 4
    jax_res, port_res = both(p, body)
    _same(jax_res, port_res)
    for alg, outs in port_res:
        assert alg == "segment_parallel"
        for k, out in enumerate(outs):
            assert np.array_equal(
                out, np.full(512, (k + 1) * sum(range(1, p + 1))))


def test_segpar_extension_dtype_falls_to_nbc(segpar_forced):
    """An extension dtype (bfloat16, '<V2') cannot ride the arena, so a
    forced segment_parallel must not hijack the fallback: both packages
    bind nbc, and the port's result equals the JAX package's."""
    ml_dtypes = pytest.importorskip("ml_dtypes")
    bf16 = np.dtype(ml_dtypes.bfloat16)

    def body(comm, M):
        x = (np.arange(64) * (comm.rank + 1)).astype(bf16)
        req = comm.allreduce_init(x, op=M.op.SUM)
        prov = req.provider
        req.start()
        out = np.copy(req.wait())
        one = comm.allreduce(x, op=M.op.SUM)
        req.free()
        return prov, out, one

    jax_res, port_res = both(3, body)
    _same(jax_res, port_res)
    for prov, out, one in port_res:
        assert prov == "nbc"
        assert out.tobytes() == one.tobytes()


def test_segpar_selection_ladder(tmp_path, monkeypatch):
    """forced var > rules file > payload crossover, with the loud
    rejection of unknown names, in both packages (the core gate pinned
    open, as tests/mpi/test_coll_persistent.py does)."""
    monkeypatch.setattr(jshm, "_NCORES", 8)
    monkeypatch.setattr(pshm, "_NCORES", 8)
    rules_path = tmp_path / "rules.conf"
    rules_path.write_text(
        "shm_allreduce 0 0      root_fold\n"
        "shm_allreduce 0 4096   segment_parallel\n")

    def body(comm, M):
        def flip(name, val):
            comm.barrier()
            if comm.rank == 0:
                M.vars.set(name, val)
            comm.barrier()

        def algs(*sizes):
            reqs = [comm.allreduce_init(np.zeros(s)) for s in sizes]
            out = tuple(q.algorithm for q in reqs)
            for q in reqs:
                q.free()
            return out

        got = {"crossover": algs(64, 1 << 17)}     # 512 B, 1 MiB
        flip("coll_host_dynamic_rules", str(rules_path))
        got["rules"] = algs(64, 1024)
        flip("coll_shm_allreduce_algorithm", "segment_parallel")
        got["forced"] = algs(64)
        flip("coll_shm_allreduce_algorithm", "bogus")
        try:
            comm.allreduce_init(np.zeros(64))
            got["bogus"] = "no-raise"
        except M.C.MPIException as e:
            got["bogus"] = "raised" if "bogus" in str(e) else str(e)
        flip("coll_shm_allreduce_algorithm", "")
        flip("coll_host_dynamic_rules", "")
        return got

    jax_res, port_res = both(2, body)
    _same(jax_res, port_res)
    for got in port_res:
        assert got["crossover"] == ("root_fold", "segment_parallel")
        assert got["rules"] == ("root_fold", "segment_parallel")
        assert got["forced"] == ("segment_parallel",)
        assert got["bogus"] == "raised"


def test_segpar_crossover_core_gate(monkeypatch):
    def body(comm, M):
        big = comm.allreduce_init(np.zeros(1 << 17))   # 1 MiB
        alg = big.algorithm
        big.free()
        return alg

    for cores, want in ((1, "root_fold"), (2, "segment_parallel")):
        monkeypatch.setattr(jshm, "_NCORES", cores)
        monkeypatch.setattr(pshm, "_NCORES", cores)
        jax_res, port_res = both(2, body)
        assert port_res == jax_res == [want, want]


def test_bind_and_start_pvars_account():
    """Mirror of the JAX package's test of the same name: one bind per
    rank and one Start per iteration per rank, counted by each package's
    ``coll_persistent_{binds,starts}_total``."""
    from ompi_tpu.mpi import trace as jtrace
    from ompi_tpu_torch.mpi import trace as ptrace

    N, iters = 2, 7
    keys = ("coll_persistent_binds_total", "coll_persistent_starts_total")

    def body(comm, M):
        req = comm.allreduce_init(np.ones(4))
        outs = []
        for _ in range(iters):
            req.start()
            outs.append(np.copy(req.wait()))
        return outs

    j0 = [jtrace.counters[k] for k in keys]
    p0 = [ptrace.counters[k] for k in keys]
    jax_res, port_res = both(N, body)
    _same(jax_res, port_res)
    jd = [jtrace.counters[k] - v for k, v in zip(keys, j0)]
    pd = [ptrace.counters[k] - v for k, v in zip(keys, p0)]
    assert pd == jd == [N, N * iters]


def test_segpar_native_folds_on_every_rank(segpar_forced):
    """The cooperative shape's defining property: every rank folds (the
    root fold: one) — one native fold per rank per op in both
    packages, counted by each package's ``coll_shm_native_folds_total``
    (the trace plane's counter, bumped at the fold call)."""
    from ompi_tpu.mpi import trace as jtrace
    from ompi_tpu_torch import _native
    from ompi_tpu_torch.mpi import trace as ptrace

    if not _native.arena_available():
        pytest.skip("the native arena executor did not build")
    _set("coll_shm_native", True)
    p, iters = 4, 3

    def body(comm, M):
        x = np.arange(4096.0) + comm.rank
        req = comm.allreduce_init(x)
        outs = []
        for _ in range(iters):
            req.start()
            outs.append(np.copy(req.wait()))
        req.free()
        return outs

    key = "coll_shm_native_folds_total"
    j0, p0 = jtrace.counters[key], ptrace.counters[key]
    jax_res, port_res = both(p, body)
    _same(jax_res, port_res)
    folds = {"jax": jtrace.counters[key] - j0,
             "port": ptrace.counters[key] - p0}
    assert folds["port"] == folds["jax"] >= p * iters


def test_segpar_timeout_names_the_wait_order_contract(segpar_forced):
    """A segpar drain stuck on a missing peer fold re-raises the arena
    timeout with the wait-order rule in the message, as the JAX
    package's does."""
    def body(comm, M):
        x = np.arange(256.0)
        req = comm.allreduce_init(x)
        plan = req._plan
        orig = plan._slots._wait_all_arrive

        def boom(v, c):
            if v == 2:   # op 0's all-folded phase (2k+2): peer's drain
                raise M.C.MPIException(
                    "coll/shm: arena wait (flag 1, want 2, have 1) "
                    "stuck for 60s on test — peer dead or "
                    "collective-order mismatch (coll_shm_timeout)")
            return orig(v, c)

        plan._slots._wait_all_arrive = boom
        req.start()
        try:
            req.wait()
            got = "no-raise"
        except M.C.MPIException as e:
            got = str(e)
        plan._slots._wait_all_arrive = orig
        req.free()
        return got

    jax_res, port_res = both(2, body)
    _same(jax_res, port_res)
    for got in port_res:
        assert "same order on every rank" in got, got
        assert "root_fold" in got


def test_every_init_refuses_a_tensor_before_binding():
    """Every ``*_init`` refuses a torch tensor with the PML's message
    before the bind runs a collective or draws a tag; the plan bound
    after the refusals still pairs."""
    def body(c):
        t = torch.ones(2 * c.size)
        h = np.ones(2 * c.size)
        cart = c.cart_create([c.size], periods=[True])
        calls = {
            "bcast_init": lambda: c.bcast_init(t, root=0),
            "reduce_init": lambda: c.reduce_init(t),
            "allreduce_init": lambda: c.allreduce_init(t),
            "allgather_init": lambda: c.allgather_init(t),
            "alltoall_init": lambda: c.alltoall_init(t),
            "alltoallv_init": lambda: c.alltoallv_init(
                [h] * (c.size - 1) + [t]),
            "reduce_scatter_init": lambda: c.reduce_scatter_init(t),
            "neighbor_alltoall_init":
                lambda: cart.neighbor_alltoall_init([h, t]),
            "neighbor_alltoallv_init":
                lambda: cart.neighbor_alltoallv_init([t, h]),
        }
        msgs = {}
        for name, call in calls.items():
            try:
                call()
                msgs[name] = None
            except BufferLocationError as e:
                msgs[name] = str(e)
        state = (c._pcoll_seq, len(c._persistent_colls),
                 cart._pcoll_seq)
        req = c.allreduce_init(h * (c.rank + 1))
        req.start()
        return msgs, state, req.wait(), req.provider

    for msgs, state, out, prov in prun(3, body):
        assert len(msgs) == 9
        for name, msg in msgs.items():
            assert msg is not None and msg.startswith(
                f"pml.{name}: got a device buffer"), (name, msg)
        assert state == (0, 0, 0)
        assert prov == "shm"
        np.testing.assert_array_equal(out, np.full(6, 6.0))


# -- the launcher's jobs: the examples and tools/host_bench.py --nbc

def _tpurun(args, timeout=120):
    """One -np 4 job; the launcher's own --timeout kills its ranks (exit
    124) well before the subprocess timeout would orphan them."""
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    return subprocess.run(
        [sys.executable, "-m", "ompi_tpu_torch.tools.tpurun", "-np", "4",
         "--timeout", str(timeout - 30), "--no-tag-output", *args],
        cwd=root, capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("shm", ["1", "0"])
def test_persistent_coll_example_under_the_launcher(shm):
    out = _tpurun(["--mca", "coll_shm_enable", shm, "--", "python", "-m",
                   "ompi_tpu_torch.examples.persistent_coll"])
    assert out.returncode == 0, out.stderr[-2000:]
    prov = "provider=shm algorithm=root_fold" if shm == "1" else \
        "provider=nbc algorithm=None"
    lines = sorted(ln for ln in out.stdout.splitlines() if ln.strip())
    assert lines == sorted(
        [f"rank {r}: persistent ok sum=12288 {prov} binds=1 starts=16 "
         f"fallback=0"
         for r in range(4)] + [f"rank {r}: partitioned ok"
                               for r in range(4)])


def test_cart_halo_example_under_the_launcher():
    out = _tpurun(["--", "python", "-m", "ompi_tpu_torch.examples.cart_halo"])
    assert out.returncode == 0, out.stderr[-2000:]
    coords = {0: [0, 0], 1: [0, 1], 2: [1, 0], 3: [1, 1]}
    assert sorted(ln for ln in out.stdout.splitlines() if ln.strip()) == [
        f"rank {r} coords {coords[r]}: halo exchange ok (4 faces)"
        for r in range(4)]


def test_host_bench_nbc_rows_under_the_launcher():
    """The rows chip_smoke's phase host_nbc reads, at 1 MiB a rank: every
    result bitwise, the arena plan bound, the neighbor plan on topo."""
    import json

    out = _tpurun(["--mca", "pml_eager_limit", "4096", "--", "python",
                   "-m", "ompi_tpu_torch.tools.host_bench", "--nbc",
                   "--mib", "1", "--part-mib", "0.25"])
    assert out.returncode == 0, out.stderr[-2000:]
    (line,) = [ln for ln in out.stdout.splitlines()
               if ln.startswith("host_bench ")]
    res = json.loads(line[len("host_bench "):])
    assert len(res["nbc"]) == 17 and all(c["bitwise"] for c in res["nbc"])
    per = res["persistent"]
    assert per["bitwise"] and per["provider"] == "shm"
    assert per["algorithm"] in ("root_fold", "segment_parallel")
    assert [k["kind"] for k in per["kinds"]] == [
        "barrier", "bcast", "reduce", "allgather", "alltoall", "alltoallv",
        "reduce_scatter", "neighbor_alltoall", "neighbor_alltoallv"]
    assert all(k["bitwise"] for k in per["kinds"])
    assert all(row[m]["bitwise"] for row in res["p2p_persistent"]
               for m in ("persistent", "isend_irecv", "send_recv"))
    assert res["partitioned"]["bitwise"]
    assert res["partitioned"]["partitions"] == 8
    assert all(c["bitwise"] for c in res["topo"]["calls"].values())
    assert res["topo"]["halo_faces"] == 16
