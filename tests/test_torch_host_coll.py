"""The port's host collectives (``ompi_tpu_torch.mpi.coll.host`` and
``coll/base``, dispatched by ``mpi/coll``) against the JAX package's.

Each case runs one rank body on in-process ranks through the JAX
package's harness and through the port's (``tests/torch_host_harness.py``)
with the same seeded numpy inputs.  Both run coll/host's algorithms over
their PMLs (coll/shm's arena is switched off in both packages), so every
result must be equal bit for bit: every buffer collective at n = 2, 3 and
4 in float32, float64 and int32 with SUM, PROD, MAX and MAXLOC (on the
(value, index) pair types), each forced algorithm, and the decision (the
algorithm coll/host picks for each (n, bytes), forced variable and rules
file).  The ``*_with_the_arena`` cases run the same bodies with the arena
on in both packages, their default: the arena folds the mapped slots in
rank order in both, and a forced host algorithm makes both fall back to
coll/host, so the results are again equal bit for bit.
"""

from __future__ import annotations

import types

import numpy as np
import pytest

from ompi_tpu.core.config import var_registry as jvars
from ompi_tpu.mpi import datatype as jdt
from ompi_tpu.mpi import op as jop
from ompi_tpu.mpi.coll import coll_framework as jcoll
from ompi_tpu_torch.core.config import var_registry as pvars
from ompi_tpu_torch.mpi import datatype as pdt
from ompi_tpu_torch.mpi import op as pop
from ompi_tpu_torch.mpi.coll import coll_framework as pcoll
from tests.mpi.harness import run_ranks as jrun
from tests.test_torch_host_p2p import _same
from tests.torch_host_harness import run_ranks as prun

J = types.SimpleNamespace(dt=jdt, op=jop)
P = types.SimpleNamespace(dt=pdt, op=pop)

SEED = 1017
DTYPES = ("float32", "float64", "int32")
OPS = ("SUM", "PROD", "MAX", "MAXLOC")
_PAIR = {"float32": "FLOAT_INT", "float64": "DOUBLE_INT",
         "int32": "LONG_INT"}


def _set(name, value):
    for reg in (jvars, pvars):
        reg.set(name, value)


@pytest.fixture(autouse=True)
def host_only():
    """coll/shm's arena off in both packages: both run coll/host."""
    import ompi_tpu.mpi.coll.shm  # noqa: F401 — registers coll_shm_enable
    import ompi_tpu_torch.mpi.coll.host  # noqa: F401 — registers its vars
    import ompi_tpu_torch.mpi.coll.shm  # noqa: F401

    old = [(reg, reg.get("coll_shm_enable")) for reg in (jvars, pvars)]
    _set("coll_shm_enable", False)
    yield
    for reg, value in old:
        reg.set("coll_shm_enable", value)


@pytest.fixture
def arena():
    """coll/shm's arena on in both packages (after ``host_only``)."""
    _set("coll_shm_enable", True)


def _rank_data(rank, shape, dtype, op):
    rng = np.random.default_rng(SEED + rank)
    if op == "MAXLOC":
        pair = np.dtype([("val", np.dtype(dtype) if dtype != "int32"
                          else np.int64), ("loc", np.int32)])
        out = np.empty(shape, pair)
        out["val"] = rng.integers(-3, 4, size=shape)   # ties on purpose
        out["loc"] = rank * 1000 + np.arange(np.prod(shape)).reshape(shape)
        return out
    if dtype == "int32":
        lo, hi = (1, 3) if op == "PROD" else (-50, 50)
        return rng.integers(lo, hi, size=shape).astype(np.int32)
    x = rng.normal(size=shape)
    if op == "PROD":
        x = 1.0 + 0.1 * x
    return x.astype(dtype)


def _collectives(c, M, dtype, op_name):
    """Every buffer collective of coll/host on this rank's data."""
    n, r = c.size, c.rank
    op = getattr(M.op, op_name)
    x = _rank_data(r, (n * 3, 2), dtype, op_name)
    out = {"allreduce": c.allreduce(x, op),
           "reduce0": c.reduce(x, op, root=0),
           "reduce_last": c.reduce(x, op, root=n - 1),
           "reduce_scatter": c.reduce_scatter(x, op),
           "reduce_scatter_block": c.reduce_scatter_block(x, op),
           "scan": c.scan(x, op),
           "exscan": c.exscan(x, op)}
    if op_name != "SUM":
        return out
    parts = [x[: 1 + (i + r) % 3] for i in range(n)]
    out.update(
        bcast=c.bcast(x if r == 1 % n else None, root=1 % n),
        gather=c.gather(x, root=n - 1),
        allgather=c.allgather(x),
        scatter=c.scatter(x if r == 0 else None, root=0),
        alltoall=c.alltoall(x),
        gatherv=c.gatherv(x[: r + 1], root=0),
        scatterv=c.scatterv(parts if r == 0 else None, root=0),
        allgatherv=c.allgatherv(x[: r + 1]),
        alltoallv=c.alltoallv(parts))
    dt = getattr(M.dt, {"float32": "FLOAT32", "float64": "FLOAT64",
                        "int32": "INT32"}[dtype])
    recv = [np.zeros(4, dtype) for _ in range(n)]
    c.alltoallw([(x, dt, 2 + (i % 2)) for i in range(n)],
                [(recv[i], dt, 2 + (r % 2)) for i in range(n)])
    out["alltoallw"] = recv
    c.barrier()
    return out


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op_name", OPS)
def test_every_host_collective_equals_the_jax_package(n, dtype, op_name):
    _every_collective(n, dtype, op_name)


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op_name", OPS)
def test_every_host_collective_with_the_arena(n, dtype, op_name, arena):
    _every_collective(n, dtype, op_name)


def _every_collective(n, dtype, op_name):
    def body(M):
        return lambda c: _collectives(c, M, dtype, op_name)

    ref, port = jrun(n, body(J)), prun(n, body(P))
    _same(ref, port)
    if op_name == "SUM" and dtype == "int32":   # and they are right
        total = sum(_rank_data(r, (n * 3, 2), dtype, "SUM")
                    for r in range(n))
        np.testing.assert_array_equal(port[0]["allreduce"], total)


FORCED = [(coll, alg) for coll, algs in (
    ("allreduce", ("recursive_doubling", "ring", "segmented_ring",
                   "linear")),
    ("bcast", ("binomial", "linear", "pipeline")),
    ("allgather", ("bruck", "ring")),
    ("alltoall", ("pairwise", "bruck")),
    ("reduce_scatter", ("ring", "basic"))) for alg in algs]


@pytest.fixture
def small_segments():
    """Segments small enough that the segmented ring and the bcast
    pipeline cut this test's 12 KiB into several pieces."""
    names = ("coll_host_allreduce_segment", "coll_host_bcast_segment")
    old = [(reg, name, reg.get(name)) for reg in (jvars, pvars)
           for name in names]
    for name in names:
        _set(name, 1024)
    yield
    for reg, name, value in old:
        reg.set(name, value)


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("coll,alg", FORCED)
def test_forced_algorithm_equals_the_jax_package(coll, alg, n,
                                                 small_segments):
    _forced(coll, alg, n)


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("coll,alg", FORCED)
def test_forced_algorithm_with_the_arena(coll, alg, n, small_segments,
                                         arena):
    _forced(coll, alg, n)


def _forced(coll, alg, n):
    def body(M):
        def fn(c):
            x = _rank_data(c.rank, (n * 384, 2), "float32", "SUM")
            if coll == "bcast":
                return c.bcast(x if c.rank == 0 else None, root=0)
            if coll in ("allgather", "alltoall"):
                return getattr(c, coll)(x)
            return getattr(c, coll)(x, M.op.SUM)
        return fn

    var = f"coll_host_{coll}_algorithm"
    _set(var, alg)
    try:
        ref, port = jrun(n, body(J)), prun(n, body(P))
    finally:
        _set(var, "")
    _same(ref, port)


def _jlabel(comp, coll, comm, nbytes, op):
    return comp.freeze_decision(coll, comm, nbytes, op)[1].split("(")[0]


@pytest.mark.parametrize("n", [2, 3, 4, 8, 16])
def test_decisions_equal_the_jax_package(n, tmp_path):
    jhost, phost = jcoll.lookup("host"), pcoll.components()["host"]
    comm = types.SimpleNamespace(size=n)
    sizes = [0, 100, 4095, 4096, 10239, 10240, 65535, 65536, 1 << 20,
             (1 << 20) + 1, 64 << 20]
    rules = tmp_path / "rules.conf"
    rules.write_text("allreduce 0 0 linear\nallreduce 4 65536 ring\n"
                     "alltoall 3 0 bruck\nbcast 0 0 pipeline\n")
    checked = 0
    for setting in ("fixed", "forced", "rules"):
        if setting == "forced":
            _set("coll_host_allgather_algorithm", "ring")
        if setting == "rules":
            _set("coll_host_dynamic_rules", str(rules))
        try:
            for coll in ("allreduce", "allgather", "alltoall",
                         "reduce_scatter", "bcast"):
                for nb in sizes:
                    for jo, po in ((jop.SUM, pop.SUM),
                                   (jop.REPLACE, pop.REPLACE)):
                        want = _jlabel(jhost, coll, comm, nb, jo)
                        got = phost.decision(coll, comm, nb, po)
                        assert got == want, (setting, coll, n, nb, jo)
                        checked += 1
        finally:
            _set("coll_host_allgather_algorithm", "")
            _set("coll_host_dynamic_rules", "")
    assert checked == 3 * 5 * len(sizes) * 2


def test_unknown_forced_algorithm_raises_in_both():
    _set("coll_host_allreduce_algorithm", "nope")
    try:
        errs = []
        for run, M in ((jrun, J), (prun, P)):
            with pytest.raises(AssertionError) as e:
                run(2, lambda c, M=M: c.allreduce(np.ones(4), M.op.SUM))
            errs.append(str(e.value.__cause__))
    finally:
        _set("coll_host_allreduce_algorithm", "")
    assert errs[0] == errs[1]
    assert "unknown allreduce algorithm 'nope'" in errs[1]


def test_providers_name_host_for_every_buffer_slot():
    res = prun(2, lambda c: (dict(c.coll.providers),
                             dict(c.coll.device_providers)))
    slots = {"barrier", "bcast", "reduce", "allreduce", "gather",
             "allgather", "scatter", "alltoall", "reduce_scatter",
             "reduce_scatter_block", "scan", "exscan", "gatherv",
             "scatterv", "allgatherv", "alltoallv", "alltoallw"}
    for providers, device in res:
        assert providers == {s: "host" for s in slots}
        assert set(device) == slots - {"alltoallw"}


def test_providers_name_shm_where_the_arena_serves(arena):
    res = prun(2, lambda c: dict(c.coll.providers))
    shm = {"barrier", "bcast", "reduce", "allreduce", "allgather",
           "alltoall", "alltoallv", "alltoallw", "reduce_scatter",
           "reduce_scatter_block", "scan", "exscan"}
    want = jrun(2, lambda c: dict(c.coll.providers))
    for providers, jproviders in zip(res, want):
        assert providers == jproviders
        assert {s for s, c in providers.items() if c == "shm"} == shm
