"""The port's process topologies (``ompi_tpu_torch.mpi.topo`` and the
communicator's topology calls) against the JAX package's.

The pure parts (``dims_create``, the Cartesian rank/coords/shift
arithmetic, ``cart_perm``) are compared directly.  The communicator
cases mirror ``tests/mpi/test_topo.py`` and run one rank body on
in-process ranks through the JAX package's harness and through the
port's, with coll/shm off in both packages and, in the
``*_with_the_arena`` cases, on in both (``cart_sub`` and
``dist_graph_create`` run collectives, so cids move in step): every
neighbor result, query and new communicator's (rank, size, cid) must be
equal, and the blocking, nonblocking (``ineighbor_*``) and persistent
(``neighbor_alltoall_init``) neighbor exchanges must pair over the same
edge-slot tags.
"""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from ompi_tpu.core.config import var_registry as jvars
from ompi_tpu.mpi import constants as jconst
from ompi_tpu.mpi import datatype as jdt
from ompi_tpu.mpi import topo as jtopo
from ompi_tpu_torch.core.buffer import BufferLocationError
from ompi_tpu_torch.core.config import var_registry as pvars
from ompi_tpu_torch.mpi import constants as pconst
from ompi_tpu_torch.mpi import datatype as pdt
from ompi_tpu_torch.mpi import topo as ptopo
from tests.mpi.harness import run_ranks as jrun
from tests.test_torch_host_p2p import _same
from tests.torch_host_harness import run_ranks as prun

J = types.SimpleNamespace(C=jconst, topo=jtopo, dt=jdt)
P = types.SimpleNamespace(C=pconst, topo=ptopo, dt=pdt)


def _set(name, value):
    for reg in (jvars, pvars):
        reg.set(name, value)


@pytest.fixture(autouse=True)
def host_only():
    import ompi_tpu.mpi.coll.shm  # noqa: F401 — registers coll_shm_enable
    import ompi_tpu_torch.mpi.coll.shm  # noqa: F401

    old = [(reg, reg.get("coll_shm_enable")) for reg in (jvars, pvars)]
    _set("coll_shm_enable", False)
    yield
    for reg, value in old:
        reg.set("coll_shm_enable", value)


def both(n, body):
    return jrun(n, lambda c: body(c, J)), prun(n, lambda c: body(c, P))


def _ids(c):
    return None if c is None else (c.rank, c.size, c.cid, c.name)


def _vals(got):
    return [None if g is None else np.asarray(g) for g in got]


# -- pure functions

@pytest.mark.parametrize("nnodes,ndims,dims", [
    (12, 2, None), (8, 3, None), (7, 1, None), (16, 2, None), (6, 2, None),
    (12, 2, [0, 3]), (24, 3, [2, 0, 0]), (1, 2, None), (30, 3, None)])
def test_dims_create_equals_the_jax_package(nnodes, ndims, dims):
    assert ptopo.dims_create(nnodes, ndims, dims) == jtopo.dims_create(
        nnodes, ndims, dims)


def test_dims_create_refuses_like_the_jax_package():
    for args in ((7, 2, [0, 3]), (4, 2, [1]), (6, 1, [4])):
        with pytest.raises(jconst.MPIException) as je:
            jtopo.dims_create(*args)
        with pytest.raises(pconst.MPIException) as pe:
            ptopo.dims_create(*args)
        assert str(pe.value) == str(je.value)
        assert pe.value.error_class == je.value.error_class


@pytest.mark.parametrize("dims,periods", [
    ([2, 3], [True, False]), ([4], [True]), ([4], [False]),
    ([2, 2, 3], [False, True, True]), ([3, 1], [True, True])])
def test_cart_arithmetic_equals_the_jax_package(dims, periods):
    jc, pc = jtopo.CartTopology(dims, periods), ptopo.CartTopology(dims,
                                                                   periods)
    assert (pc.ndims, pc.size) == (jc.ndims, jc.size)
    for r in range(jc.size):
        assert pc.coords(r) == jc.coords(r)
        assert pc.rank(pc.coords(r)) == r
        assert pc.neighbors(r) == jc.neighbors(r)
        for d in range(jc.ndims):
            for disp in (1, 2, -1):
                assert pc.shift(r, d, disp) == jc.shift(r, d, disp)
    for coords in ([5, 0], [0, 7], [-1, -1], [2] * len(dims)):
        coords = coords[:len(dims)] + [0] * (len(dims) - len(coords))
        assert pc.rank(coords) == jc.rank(coords)
    for d in range(jc.ndims):
        for disp in (1, -1, 2):
            assert (ptopo.cart_perm(pc, d, disp)
                    == jtopo.cart_perm(jc, d, disp))


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    from tests import torch_ranks as TR

    p = TR.RankPool(tmp_path_factory.mktemp("ranks"))
    yield p
    p.close()


@pytest.mark.parametrize("dims,periods,direction,disp", [
    ([4], [True], 0, 1), ([4], [False], 0, 1), ([2, 2], [True, True], 1, 1),
    ([2, 2], [False, True], 0, -1)])
def test_cart_perm_drives_the_device_permute(pool, dims, periods,
                                             direction, disp):
    """cart_perm's pairs are what ``DeviceCommunicator.permute`` takes:
    on 4 gloo rank processes each rank's block lands on its cart
    neighbor, and a rank with no source (a non-periodic edge) receives
    zeros, MPI's PROC_NULL."""
    from tests import torch_ranks as TR

    topo = ptopo.CartTopology(dims, periods)
    pairs = ptopo.cart_perm(topo, direction, disp)
    assert pairs == jtopo.cart_perm(jtopo.CartTopology(dims, periods),
                                    direction, disp)
    x = np.random.default_rng(5).normal(size=(4, 3)).astype(np.float32)
    got = pool.map(TR.call, [dict(shard=s["shard"], method="permute",
                                  margs=(pairs,)) for s in TR.shards(x)])
    want = np.zeros_like(x)
    for s, d in pairs:
        want[d] = x[s]
    for r in range(4):
        assert np.array_equal(np.asarray(got[r]).reshape(3), want[r]), r


# -- communicator cases (tests/mpi/test_topo.py)

def _cart_ring(comm, M):
    cart = comm.cart_create([comm.size], periods=[True])
    src, dst = cart.topo.shift(cart.rank, 0, 1)
    out = cart.sendrecv(np.array([cart.rank]), dest=dst, source=src)
    cart.barrier()
    return _ids(cart), int(out[0]), M.topo.cart_get(cart)


def _cart_excludes(comm, M):
    cart = comm.cart_create([2], periods=[False])
    return _ids(cart)


def _cart_sub(comm, M):
    cart = comm.cart_create([2, 2])
    row = cart.cart_sub([False, True])
    col = cart.cart_sub([True, False])
    rowsum = row.allreduce(np.array([comm.rank], dtype=np.int64))
    colsum = col.allreduce(np.array([comm.rank], dtype=np.int64))
    return (_ids(row), _ids(col), rowsum, colsum, row.topo.dims,
            col.topo.periods)


def _neighbor_periodic(comm, M):
    cart = comm.cart_create([comm.size], periods=[True])
    return _vals(cart.neighbor_allgather(
        np.array([cart.rank], dtype=np.int64)))


def _neighbor_nonperiodic(comm, M):
    cart = comm.cart_create([3], periods=[False])
    if cart is None:
        return None
    return _vals(cart.neighbor_allgather(
        np.array([cart.rank], dtype=np.int64)))


def _two_rank_torus(comm, M):
    cart = comm.cart_create([2], periods=[True])
    me = cart.rank
    parts = [np.array([10 * me + 0]), np.array([10 * me + 1])]
    return _vals(cart.neighbor_alltoall(parts))


def _torus_2x2_every_form(comm, M):
    """The chip smoke's topology: a periodic 2×2 torus, where every
    rank's lo and hi neighbor along each dim are the same rank."""
    cart = comm.cart_create([2, 2], periods=[True, True])
    rng = np.random.default_rng(7 + cart.rank)
    one = rng.normal(size=(5,)).astype(np.float32)
    parts = [rng.normal(size=(3, 2)) for _ in range(4)]
    vparts = [rng.integers(0, 9, size=(j + 1,)) for j in range(4)]
    out = {"allgather": _vals(cart.neighbor_allgather(one)),
           "alltoall": _vals(cart.neighbor_alltoall(parts)),
           "alltoallv": _vals(cart.neighbor_alltoallv(vparts)),
           "allgatherv": _vals(M.topo.neighbor_allgatherv(cart, one))}
    reqs = [M.topo.ineighbor_allgather(cart, one),
            M.topo.ineighbor_alltoall(cart, parts),
            M.topo.ineighbor_alltoallv(cart, vparts)]
    out["i"] = [_vals(r.wait()) for r in reversed(reqs)]
    pa = cart.neighbor_alltoall_init(parts)
    pv = cart.neighbor_alltoallv_init(vparts)
    seen = []
    for k in range(3):
        for p in parts:
            p += 1.0                  # the bound parts are re-read
        pa.start()
        pv.start()
        seen.append((_vals(pa.wait()), _vals(pv.wait())))
    out["persistent"] = seen
    out["providers"] = (pa.provider, pv.provider)
    recv = [np.zeros(3, np.float64) for _ in range(4)]
    M.topo.neighbor_alltoallw(
        cart, [(p, M.dt.FLOAT64, 3) for p in parts],
        [(recv[i], M.dt.FLOAT64, 3) for i in range(4)])
    out["alltoallw"] = recv
    out["queries"] = (M.topo.topo_test(cart), M.topo.cart_get(cart),
                      M.topo.cartdim_get(cart),
                      cart.topo.shift(cart.rank, 1, 1),
                      M.topo.cart_map(comm, [2, 2]))
    return out


def _graph(comm, M):
    index = [2, 4, 6, 8]
    edges = [1, 2, 0, 3, 0, 3, 1, 2]
    g = comm.graph_create(index, edges)
    got = g.neighbor_allgather(np.array([g.rank], dtype=np.int64))
    a2a = g.neighbor_alltoall([np.array([g.rank * 10 + j])
                               for j in range(2)])
    ia2a = M.topo.ineighbor_alltoall(
        g, [np.array([g.rank * 100 + j]) for j in range(2)]).wait()
    return (_ids(g), g.topo.neighbors_of(g.rank), _vals(got), _vals(a2a),
            _vals(ia2a), M.topo.topo_test(g), M.topo.graph_get(g),
            M.topo.graphdims_get(g), M.topo.graph_neighbors(g, 3),
            M.topo.graph_neighbors_count(g, 2),
            M.topo.graph_map(comm, index, edges))


def _dist_graph_adjacent(comm, M):
    n, me = comm.size, comm.rank
    dg = comm.dist_graph_create_adjacent(
        sources=[(me - 1) % n], destinations=[(me + 1) % n])
    got = dg.neighbor_alltoall([np.array([100 + me])])
    igot = M.topo.ineighbor_allgather(dg, np.array([me * 1.5])).wait()
    return (_ids(dg), _vals(got), _vals(igot),
            M.topo.dist_graph_neighbors(dg),
            M.topo.dist_graph_neighbors_count(dg))


def _dist_graph_parallel_edges(comm, M):
    """Two parallel edges to the next rank: they pair by occurrence."""
    n, me = comm.size, comm.rank
    dg = comm.dist_graph_create_adjacent(
        sources=[(me - 1) % n] * 2, destinations=[(me + 1) % n] * 2,
        source_weights=[1, 2], dest_weights=[1, 2])
    got = dg.neighbor_alltoall([np.array([me, 0]), np.array([me, 1])])
    return _vals(got), M.topo.dist_graph_neighbors_count(dg)


def _dist_graph_create(comm, M):
    if comm.rank == 0:
        sources = list(range(comm.size))
        degrees = [1] * comm.size
        destinations = [(s + 1) % comm.size for s in sources]
        weights = [s + 5 for s in sources]
    else:
        sources, degrees, destinations, weights = [], [], [], []
    dg = comm.dist_graph_create(sources, degrees, destinations, weights)
    return (_ids(dg), dg.topo.sources, dg.topo.destinations,
            dg.topo.source_weights, dg.topo.dest_weights)


def _reorder(comm, M):
    cart = comm.cart_create([2, 4], reorder=True, mesh_shape=[4, 2])
    i, j = cart.topo.coords(cart.rank)
    return (_ids(cart), comm.rank, i, j,
            M.topo.cart_map(comm, [2, 4], mesh_shape=[4, 2]))


def _errors(comm, M):
    hits = []
    try:
        comm.neighbor_allgather(np.zeros(1))
    except M.C.MPIException as e:
        hits.append((str(e), e.error_class))
    cart = comm.cart_create([2, 2])
    for call in (lambda: cart.cart_sub([True]),
                 lambda: cart.neighbor_alltoall([np.zeros(1)]),
                 lambda: M.topo.graph_get(cart),
                 lambda: comm.cart_create([3, 3])):
        try:
            call()
            hits.append(None)
        except M.C.MPIException as e:
            hits.append((str(e), e.error_class))
    return hits


CASES = {}
for _f, _n in ((_cart_ring, 4), (_cart_ring, 3), (_cart_excludes, 4),
               (_cart_sub, 4), (_neighbor_periodic, 4),
               (_neighbor_periodic, 5), (_neighbor_nonperiodic, 3),
               (_two_rank_torus, 2), (_torus_2x2_every_form, 4),
               (_graph, 4), (_dist_graph_adjacent, 4),
               (_dist_graph_adjacent, 2), (_dist_graph_parallel_edges, 3),
               (_dist_graph_create, 4), (_dist_graph_create, 5),
               (_reorder, 8), (_errors, 4)):
    CASES[f"{_f.__name__[1:]}-n{_n}"] = (_f, _n)


@pytest.mark.parametrize("case", sorted(CASES))
def test_topology_equals_the_jax_package(case):
    fn, n = CASES[case]
    jax_res, port_res = both(n, fn)
    _same(jax_res, port_res)


@pytest.mark.parametrize("case", ["cart_sub-n4", "torus_2x2_every_form-n4",
                                  "dist_graph_create-n4", "graph-n4"])
def test_topology_with_the_arena_equals_the_jax_package(case):
    _set("coll_shm_enable", True)
    fn, n = CASES[case]
    jax_res, port_res = both(n, fn)
    _same(jax_res, port_res)


def test_topology_results_are_what_mpi_says():
    """tests/mpi/test_topo.py's own expectations, on the port."""
    ring = prun(4, lambda c: _cart_ring(c, P))
    assert [r[1] for r in ring] == [3, 0, 1, 2]
    assert [r is None for r in prun(4, lambda c: _cart_excludes(c, P))] \
        == [False, False, True, True]
    sub = prun(4, lambda c: _cart_sub(c, P))
    assert [int(s[2][0]) for s in sub] == [1, 1, 5, 5]
    assert [int(s[3][0]) for s in sub] == [2, 4, 2, 4]
    torus = prun(2, lambda c: _two_rank_torus(c, P))
    assert [[int(v[0]) for v in t] for t in torus] == [[11, 10], [1, 0]]
    assert [int(v[0]) for r in prun(4, lambda c: _dist_graph_adjacent(
        c, P)) for v in r[1]] == [103, 100, 101, 102]
    for cart_ids, world_rank, i, j, _m in prun(8, lambda c: _reorder(c, P)):
        assert world_rank == j * 2 + i


def test_communicator_topology_methods():
    """The port's Communicator carries the topology queries and the
    ineighbor_* forms as methods (the JAX package reaches them through
    ``mpi.topo``)."""
    def body(c):
        cart = c.cart_create([2, 2], periods=[True, False])
        parts = [np.array([cart.rank * 4 + j]) for j in range(4)]
        g = c.graph_create([2, 4, 6, 8], [1, 2, 0, 3, 0, 3, 1, 2])
        dg = c.dist_graph_create_adjacent([(c.rank - 1) % 4],
                                          [(c.rank + 1) % 4])
        return (cart.topo_test(), cart.cart_get(), cart.cartdim_get(),
                cart.cart_rank([1, 1]), cart.cart_coords(2),
                cart.cart_shift(0), cart.cart_shift(1),
                c.cart_map([2, 2]), c.graph_map([1], [0]),
                _vals(cart.ineighbor_alltoall(parts).wait()),
                _vals(cart.ineighbor_alltoallv(parts).wait()),
                _vals(cart.ineighbor_allgather(parts[0]).wait()),
                _vals(cart.ineighbor_allgatherv(parts[0]).wait()),
                _vals(cart.neighbor_allgatherv(parts[0])),
                g.graph_get(), g.graphdims_get(), g.graph_neighbors(1),
                g.graph_neighbors_count(1), dg.dist_graph_neighbors(),
                dg.dist_graph_neighbors_count(), c.topo_test())

    def ref(c):
        t = jtopo
        cart = c.cart_create([2, 2], periods=[True, False])
        parts = [np.array([cart.rank * 4 + j]) for j in range(4)]
        g = c.graph_create([2, 4, 6, 8], [1, 2, 0, 3, 0, 3, 1, 2])
        dg = c.dist_graph_create_adjacent([(c.rank - 1) % 4],
                                          [(c.rank + 1) % 4])
        return (t.topo_test(cart), t.cart_get(cart), t.cartdim_get(cart),
                cart.topo.rank([1, 1]), cart.topo.coords(2),
                cart.topo.shift(cart.rank, 0, 1),
                cart.topo.shift(cart.rank, 1, 1),
                t.cart_map(c, [2, 2]), t.graph_map(c, [1], [0]),
                _vals(t.ineighbor_alltoall(cart, parts).wait()),
                _vals(t.ineighbor_alltoallv(cart, parts).wait()),
                _vals(t.ineighbor_allgather(cart, parts[0]).wait()),
                _vals(t.ineighbor_allgatherv(cart, parts[0]).wait()),
                _vals(t.neighbor_allgatherv(cart, parts[0])),
                t.graph_get(g), t.graphdims_get(g), t.graph_neighbors(g, 1),
                t.graph_neighbors_count(g, 1), t.dist_graph_neighbors(dg),
                t.dist_graph_neighbors_count(dg), t.topo_test(c))

    _same(jrun(4, ref), prun(4, body))


def test_neighbor_entry_points_refuse_a_tensor():
    """Every neighbor exchange — blocking, nonblocking and persistent —
    refuses a torch tensor with the PML's message before any frame
    moves; the exchange after the refusals still pairs."""
    def body(c):
        cart = c.cart_create([2, 2], periods=[True, True])
        t = torch.ones(3)
        h = np.ones(3)
        calls = {
            "neighbor_allgather": lambda: cart.neighbor_allgather(t),
            "neighbor_alltoall": lambda: cart.neighbor_alltoall(
                [h, h, h, t]),
            "neighbor_alltoallv": lambda: cart.neighbor_alltoallv(
                [t, h, h, h]),
            "neighbor_alltoallw": lambda: cart.neighbor_alltoallw(
                [None] * 3 + [(t, pdt.FLOAT64, 3)], [None] * 4),
            "ineighbor_allgather": lambda: cart.ineighbor_allgather(t),
            "ineighbor_alltoall": lambda: cart.ineighbor_alltoall(
                [h, t, h, h]),
            "ineighbor_alltoallv": lambda: cart.ineighbor_alltoallv(
                [h, h, t, h]),
            "neighbor_alltoall_init": lambda: cart.neighbor_alltoall_init(
                [t, h, h, h]),
            "neighbor_alltoallv_init":
                lambda: cart.neighbor_alltoallv_init([h, h, h, t]),
        }
        msgs = {}
        for name, call in calls.items():
            try:
                call()
                msgs[name] = None
            except BufferLocationError as e:
                msgs[name] = str(e)
        got = cart.neighbor_allgather(np.array([cart.rank]))
        return msgs, [int(g[0]) for g in got], cart._pcoll_seq

    for msgs, got, seq in prun(4, body):
        for name, msg in msgs.items():
            assert msg is not None and msg.startswith(
                f"pml.{name}: got a device buffer"), (name, msg)
        assert len(got) == 4 and seq == 0
