"""The port's coll/shm arena (``ompi_tpu_torch.mpi.coll.shm``) against the
JAX package's, with the arena on in both packages (their default).

Each case runs one rank body on in-process ranks through the JAX
package's harness and through the port's with the same seeded numpy
inputs.  The arena folds the mapped slots in rank order in both packages
(through the native executor or numpy's chain, which agree bit for bit),
so every result must be equal bit for bit: barrier, bcast, reduce,
allreduce and allgather over a seeded (op, dtype, shape, n = 2–5) matrix
with the native executor on and off, on both sides of the
``coll_shm_arena_size`` fallback boundary, and in the hierarchical mode
of mixed-host communicators.  The port's side also checks that ``shm``
serves the slots and that its state's mode is ``arena`` (``hier`` where
the hosts are mixed), as tests/mpi/test_coll_shm.py:23-38 does for the
JAX package.
"""

from __future__ import annotations

import importlib
import os
import time
import types

import numpy as np
import pytest

from ompi_tpu.core.config import var_registry as jvars
from ompi_tpu.mpi import op as jop
from ompi_tpu.mpi.coll import host as _jhost  # noqa: F401 — its vars
from ompi_tpu.mpi.coll import shm as jshm
from ompi_tpu_torch.core import shmseg
from ompi_tpu_torch.core.config import var_registry as pvars
from ompi_tpu_torch.mpi import op as pop
from ompi_tpu_torch.mpi.coll import host as _phost  # noqa: F401
from ompi_tpu_torch.mpi.coll import shm as pshm
from ompi_tpu_torch.mpi.constants import ERR_PROC_FAILED, MPIException
from tests.mpi.harness import run_ranks as jrun
from tests.test_torch_host_p2p import _same
from tests.torch_host_harness import run_ranks as prun

J = types.SimpleNamespace(op=jop)
P = types.SimpleNamespace(op=pop)

_VARS = ("coll_shm_enable", "coll_shm_native", "coll_shm_arena_size",
         "coll_shm_probe_grace", "coll_shm_timeout",
         "coll_shm_allreduce_algorithm", "coll_shm_segpar_min",
         "coll_host_dynamic_rules")


@pytest.fixture(autouse=True)
def restore_vars():
    old = [(reg, name, reg.get(name)) for reg in (jvars, pvars)
           for name in _VARS]
    _set("coll_shm_enable", True)
    yield
    for reg, name, value in old:
        reg.set(name, value)


def _set(name, value):
    for reg in (jvars, pvars):
        reg.set(name, value)


def both(n, body):
    """(JAX package's per-rank results, port's)."""
    return jrun(n, lambda c: body(c, J)), prun(n, lambda c: body(c, P))


def _mode(c):
    st = c._coll_shm_state
    return getattr(st, "mode", None)


_OPS = ("SUM", "PROD", "MIN", "MAX")
_DTYPES = ("f8", "f4", "i8", "i4", "u1")


def _case(seed):
    """(n, op name, dtype, shape, root) of one seeded matrix cell."""
    rng = np.random.default_rng(seed)
    n = 2 + seed % 4
    op = _OPS[int(rng.integers(len(_OPS)))]
    dtype = np.dtype(_DTYPES[int(rng.integers(len(_DTYPES)))])
    if seed % 3 == 2:
        # above half a slot: the segmented pipeline through both halves
        shape = (int(rng.integers(20000, 40000)),)
    else:
        shape = tuple(int(rng.integers(1, 9))
                      for _ in range(int(rng.integers(1, 4))))
    return n, op, dtype, shape, int(rng.integers(n))


def _rank_data(seed, rank, dtype, shape):
    rng = np.random.default_rng(1000 * seed + rank)
    if dtype.kind == "f":
        return (rng.standard_normal(shape) * 3).astype(dtype)
    return rng.integers(1, 5, size=shape).astype(dtype)


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("seed", range(8))
def test_arena_collectives_equal_the_jax_package(seed, native):
    n, op_name, dtype, shape, root = _case(seed)
    _set("coll_shm_native", native)

    def body(c, M):
        op = getattr(M.op, op_name)
        x = _rank_data(seed, c.rank, dtype, shape)
        c.barrier()
        out = {"bcast": c.bcast(x if c.rank == root else None, root=root),
               "reduce": c.reduce(x, op, root=root),
               "allreduce": c.allreduce(x, op),
               "allgather": c.allgather(x)}
        c.barrier()
        if M is P:
            out["providers"] = {s: c.coll.providers[s] for s in (
                "barrier", "bcast", "reduce", "allreduce", "allgather")}
            out["mode"] = _mode(c)
        return out

    ref, port = both(n, body)
    for r, (a, b) in enumerate(zip(ref, port)):
        assert set(b.pop("providers").values()) == {"shm"}
        assert b.pop("mode") == "arena"
        _same(a, b)
    if op_name == "SUM" and dtype.kind in "iu":       # and they are right
        total = sum(_rank_data(seed, r, dtype, shape) for r in range(n))
        np.testing.assert_array_equal(port[0]["allreduce"], total)


@pytest.mark.parametrize("n", [2, 4])
def test_parity_across_the_fallback_boundary(n):
    """Payloads straddling ``coll_shm_arena_size``: below rides the
    arena, above falls back to coll/host — each bit for bit the JAX
    package's, and right."""
    cap = 64 << 10
    _set("coll_shm_arena_size", cap)
    for nbytes in (cap // 2, cap + 8):
        x = np.arange(nbytes // 8, dtype=np.float64) * 0.5   # exact sums

        def body(c, M, x=x):
            return (c.allreduce(x + c.rank, M.op.SUM),
                    c.reduce(x * (c.rank + 1), M.op.MAX, root=n - 1),
                    c.bcast(x if c.rank == 1 else None, root=1),
                    _mode(c))

        ref, port = both(n, body)
        _same(ref, port)
        want = sum(x + r for r in range(n))
        np.testing.assert_array_equal(port[0][0], want)
        assert port[0][3] == "arena"


@pytest.mark.parametrize("hosts", [
    ("a", "a", "b", "b"),     # 2+2
    ("a", "b", "b", "b"),     # 1+3
    ("a", "b", "a", "b", "a"),  # interleaved node membership, n = 5
], ids=["2+2", "1+3", "interleaved"])
def test_hierarchical_composition_equals_the_jax_package(hosts):
    n = len(hosts)

    def body(c, M):
        c._io_host_override = hosts[c.rank]
        c.barrier()
        x = np.arange(6.0) * 0.25 + c.rank * 10
        out = (c.allreduce(x, M.op.SUM),
               c.bcast(np.array([3.0, 1.0, 4.0]) if c.rank == 1 else None,
                       root=1),
               c.allgather(np.array([c.rank, c.rank * c.rank])),
               c.reduce(np.array([float(c.rank + 1)]), M.op.SUM, root=2),
               c.alltoall(np.arange(2.0 * n) + c.rank),
               c.reduce_scatter(np.arange(3.0 * n) * (c.rank + 1),
                                M.op.SUM),
               c.scan(np.array([c.rank + 1.0]), M.op.SUM))
        st = c._coll_shm_state
        return out, st.mode, st.node.size

    ref, port = both(n, body)
    _same(ref, port)
    for out, mode, _ in port:
        assert mode == "hier"
        np.testing.assert_array_equal(
            out[0], np.arange(6.0) * 0.25 * n + 10 * sum(range(n)))


def test_all_singleton_hosts_settle_on_host_mode():
    def body(c, M):
        c._io_host_override = f"solo{c.rank}"
        out = c.allreduce(np.array([c.rank + 1.0]), M.op.SUM)
        return float(out[0]), _mode(c)

    ref, port = both(3, body)
    assert ref == port == [(6.0, "host")] * 3


def test_noncommutative_op_falls_back_like_the_jax_package():
    def body(c, M):
        matmul = M.op.create_op(lambda a, b: a @ b, commutative=False)
        return c.allreduce(np.array([[1.0, c.rank + 1], [0.0, 1.0]]),
                           op=matmul)

    ref, port = both(4, body)
    _same(ref, port)
    np.testing.assert_array_equal(port[0], [[1.0, 10.0], [0.0, 1.0]])


def test_state_is_cached_and_free_closes_the_arena():
    def body(c):
        c.allreduce(np.ones(2))
        st = c._coll_shm_state
        c.allreduce(np.ones(2))
        same = c._coll_shm_state is st
        d = c.dup()
        d.allreduce(np.ones(2))
        arena = d._coll_shm_state.arena
        d.free()
        try:
            arena.seg.buf[0]
            mapped = True
        except ValueError:   # released with the mapping
            mapped = False
        return same, d._coll_shm_state, mapped

    for same, after, mapped in prun(3, body):
        assert same and after is None and not mapped


def test_decide_allreduce_algo_equals_the_jax_package(tmp_path):
    rules = tmp_path / "rules.conf"
    rules.write_text("shm_allreduce 0 0 root_fold\n"
                     "shm_allreduce 4 65536 segment_parallel\n")
    checked = 0
    for setting in ("fixed", "forced", "rules"):
        _set("coll_shm_allreduce_algorithm",
             "segment_parallel" if setting == "forced" else "")
        _set("coll_host_dynamic_rules",
             str(rules) if setting == "rules" else "")
        for size in (1, 2, 3, 4, 8, 64):
            comm = types.SimpleNamespace(size=size)
            for nbytes in (0, 4096, 65536, 1 << 20, 64 << 20):
                assert (pshm.decide_allreduce_algo(comm, nbytes)
                        == jshm.decide_allreduce_algo(comm, nbytes))
                checked += 1
    assert checked == 3 * 6 * 5


# ---------------------------------------------------------------------------
# the arena's waits: the dead-writer probe and the deadline, both paths
# ---------------------------------------------------------------------------

class _Endpoint:
    def __init__(self, alive):
        self.alive = alive

    def peer_alive(self, peer):
        return self.alive


def _bare_arena(alive, p=2):
    pml = types.SimpleNamespace(endpoint=_Endpoint(alive), rank=0)
    seg = shmseg.create(f"torch-arena-test-{time.monotonic_ns()}",
                        pshm.Arena.nbytes_for(p, 4096))
    arena = pshm.Arena(seg, p, 0, 4096, world=list(range(p)), pml=pml)
    seg.unlink()
    return arena


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_dead_writer_fails_the_wait_in_the_probe_grace(native):
    arena = _bare_arena(alive=False)
    _set("coll_shm_probe_grace", 0.2)
    _set("coll_shm_native", native)
    try:
        t0 = time.monotonic()
        with pytest.raises(MPIException) as e:
            arena._wait(1 * 8, 1, None)   # rank 1's arrive: never set
        assert e.value.error_class == ERR_PROC_FAILED
        assert "writer" in str(e.value)
        assert time.monotonic() - t0 < 5.0
    finally:
        arena.close()


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_unknowable_writer_waits_out_the_deadline(native):
    arena = _bare_arena(alive=None)
    _set("coll_shm_probe_grace", 0.05)
    _set("coll_shm_timeout", 1)
    _set("coll_shm_native", native)
    try:
        with pytest.raises(MPIException) as e:
            arena._wait_many(0, 1, None)
        assert "coll_shm_timeout" in str(e.value)
    finally:
        arena.close()


def test_no_native_env_keeps_the_arena_on_the_python_plane(monkeypatch):
    """OMPI_TPU_NO_NATIVE=1 (a fresh loader): the arena still serves the
    slots, on the Python data plane, with the JAX package's bits."""
    from ompi_tpu_torch import _native

    monkeypatch.setenv("OMPI_TPU_NO_NATIVE", "1")
    mod = importlib.reload(_native)
    try:
        assert mod.arena() is None and not mod.arena_available()

        def body(c, M):
            out = c.allreduce(np.arange(2048.0) * 0.1 + c.rank, M.op.SUM)
            return out, c.coll.providers["allreduce"]

        ref, port = both(4, body)
        for (a, _), (b, prov) in zip(ref, port):
            assert prov == "shm" and a.tobytes() == b.tobytes()
    finally:
        monkeypatch.delenv("OMPI_TPU_NO_NATIVE")
        importlib.reload(mod)


def test_arena_and_rings_with_more_ranks_than_cores():
    """More ranks than cores, on threads, under a short switch interval:
    rounds of arena allreduce, bcast and a ring shift over the shm rings
    must stay exact (a lost counter update or a torn ring frame would
    break a sum or a stamp)."""
    import sys

    n = max(10, (os.cpu_count() or 1) + 2)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)

    def body(c):
        for it in range(12):
            s = c.allreduce(np.full(300, c.rank + it, np.int64))
            assert (s == n * it + n * (n - 1) // 2).all(), (c.rank, it)
            b = c.bcast(np.arange(700) + it if c.rank == it % n else None,
                        root=it % n)
            assert (b == np.arange(700) + it).all()
            nxt, prv = (c.rank + 1) % n, (c.rank - 1) % n
            req = c.isend(np.full(50, c.rank * 100 + it, np.int64), nxt,
                          tag=it)
            got = c.recv(source=prv, tag=it)
            req.wait(timeout=60)
            assert (got == prv * 100 + it).all()
        return _mode(c), c.pml.endpoint.route((c.rank + 1) % n)

    try:
        res = prun(n, body, timeout=120.0, btl="^proc")
    finally:
        sys.setswitchinterval(old)
    assert res == [("arena", "shm")] * n
