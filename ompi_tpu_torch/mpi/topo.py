"""Process topologies: Cartesian, graph, and distributed graph (the port's
copy of the JAX package's ``mpi/topo.py``, whole).

≈ the reference's ``topo`` framework (ompi/mca/topo/, topo_base_cart_create.c
and friends, plus the treematch reordering component) — a Cartesian
communicator is the software view of the device mesh, and every cart shift
lowers to one ``DeviceCommunicator.permute`` on the device path (see
:func:`cart_perm`).

Feature parity:

- ``dims_create``          ≈ MPI_Dims_create   (balanced prime factorization)
- ``cart_create``          ≈ MPI_Cart_create   (periods, reorder)
- ``CartTopology.rank/coords/shift/sub`` ≈ MPI_Cart_{rank,coords,shift,sub}
- ``graph_create``         ≈ MPI_Graph_create  (index/edges form)
- ``dist_graph_create_adjacent`` / ``dist_graph_create``
                           ≈ MPI_Dist_graph_create(_adjacent)
- neighbor collectives     ≈ MPI_Neighbor_{allgather,alltoall,alltoallv}
- ``reorder=True``         ≈ topo/treematch: re-rank so cart neighbors are
                             physical neighbors: when a device mesh shape
                             is supplied cart coords map onto mesh coords
                             directly (row-major folding), the layout the
                             launcher gives the ranks of a job.

The topology object lives on ``comm.topo`` of the communicator returned by
the create call, mirroring ``ompi_communicator_t.c_topo``.

The neighbor collectives move host buffers only: a torch tensor (on any
device) is refused with the PML's message before anything is copied.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ompi_tpu_torch.mpi.constants import PROC_NULL, MPIException
from ompi_tpu_torch.mpi.pml import _reject_device, _reject_device_parts

__all__ = [
    "dims_create", "CartTopology", "GraphTopology", "DistGraphTopology",
    "cart_create", "cart_sub", "graph_create",
    "dist_graph_create_adjacent", "dist_graph_create",
    "neighbor_allgather", "neighbor_alltoall", "neighbor_alltoallv",
    "cart_perm",
]

# reserved internal collective tags (see comm._coll_isend); host coll uses
# 1..63, nbc 64.., osc 500s — neighbor exchange gets the 700 block, each op
# a 64-tag window for per-edge disambiguation
_TAG_NEIGHBOR = 700


# ---------------------------------------------------------------------------
# dims_create
# ---------------------------------------------------------------------------

def _prime_factors(n: int) -> list[int]:
    out, p = [], 2
    while p * p <= n:
        while n % p == 0:
            out.append(p)
            n //= p
        p += 1
    if n > 1:
        out.append(n)
    return out


def dims_create(nnodes: int, ndims: int,
                dims: Optional[Sequence[int]] = None) -> list[int]:
    """≈ MPI_Dims_create: balanced dims whose product covers nnodes.

    Zero entries in ``dims`` are free; nonzero entries are constraints.
    Greedy largest-factor-to-smallest-dim assignment (the reference's
    topo_base_dims_create algorithm produces the same balanced shapes).
    """
    dims = list(dims) if dims is not None else [0] * ndims
    if len(dims) != ndims:
        raise MPIException("dims length != ndims", error_class=3)
    fixed = 1
    for d in dims:
        if d > 0:
            fixed *= d
    if fixed <= 0 or nnodes % fixed:
        raise MPIException(
            f"nnodes {nnodes} not divisible by fixed dims {dims}",
            error_class=3)
    free = [i for i, d in enumerate(dims) if d == 0]
    for i in free:
        dims[i] = 1
    rem = nnodes // fixed
    for f in sorted(_prime_factors(rem), reverse=True):
        if not free:
            if rem != 1:
                raise MPIException("no free dims left", error_class=3)
            break
        # assign to the currently-smallest free dim
        tgt = min(free, key=lambda i: dims[i])
        dims[tgt] *= f
    # MPI contract: free dims come out in non-increasing order (constrained
    # entries keep their position)
    filled = sorted((dims[i] for i in free), reverse=True)
    for i, v in zip(free, filled):
        dims[i] = v
    return dims


# ---------------------------------------------------------------------------
# topology objects (≈ mca_topo_base_comm_cart/graph/dist_graph_2_2_0_t)
# ---------------------------------------------------------------------------

class CartTopology:
    """Cartesian topology state attached to a communicator."""

    kind = "cart"

    def __init__(self, dims: Sequence[int], periods: Sequence[bool]) -> None:
        self.dims = tuple(int(d) for d in dims)
        self.periods = tuple(bool(p) for p in periods)
        if len(self.dims) != len(self.periods):
            raise MPIException("dims/periods length mismatch", error_class=3)
        self.ndims = len(self.dims)
        self.size = int(np.prod(self.dims)) if self.dims else 1

    # row-major rank<->coords, like the reference (topo_base_cart_rank.c)
    def rank(self, coords: Sequence[int]) -> int:
        if len(coords) != self.ndims:
            raise MPIException("bad coords length", error_class=3)
        r = 0
        for d, (c, n, per) in enumerate(
                zip(coords, self.dims, self.periods)):
            c = int(c)
            if per:
                c %= n
            elif not 0 <= c < n:
                return PROC_NULL
            r = r * n + c
        return r

    def coords(self, rank: int) -> list[int]:
        if not 0 <= rank < self.size:
            raise MPIException(f"rank {rank} out of cart range",
                               error_class=6)
        out = []
        for n in reversed(self.dims):
            out.append(rank % n)
            rank //= n
        return list(reversed(out))

    def shift(self, rank: int, direction: int, disp: int) -> tuple[int, int]:
        """(source, dest) for a shift along ``direction`` by ``disp``.

        ≈ MPI_Cart_shift: non-periodic edges yield PROC_NULL.
        """
        if not 0 <= direction < self.ndims:
            raise MPIException("bad shift direction", error_class=3)
        c = self.coords(rank)
        down, up = list(c), list(c)
        down[direction] -= disp
        up[direction] += disp
        return self.rank(down), self.rank(up)

    def neighbors(self, rank: int) -> tuple[list[int], list[int]]:
        """(sources, destinations) in MPI neighbor-collective order:
        for each dim, the -1 then +1 neighbor."""
        srcs, dsts = [], []
        for d in range(self.ndims):
            lo, hi = self.shift(rank, d, 1)
            srcs += [lo, hi]
            dsts += [lo, hi]
        return srcs, dsts


class GraphTopology:
    """General graph topology in MPI_Graph_create index/edges form."""

    kind = "graph"

    def __init__(self, index: Sequence[int], edges: Sequence[int]) -> None:
        self.index = list(int(i) for i in index)
        self.edges = list(int(e) for e in edges)
        self.size = len(self.index)
        if self.index and self.index[-1] != len(self.edges):
            raise MPIException("index[-1] != len(edges)", error_class=3)

    def neighbors_of(self, rank: int) -> list[int]:
        if not 0 <= rank < self.size:
            raise MPIException(f"rank {rank} out of graph range",
                               error_class=6)
        lo = self.index[rank - 1] if rank else 0
        return self.edges[lo:self.index[rank]]

    def neighbors(self, rank: int) -> tuple[list[int], list[int]]:
        nb = self.neighbors_of(rank)
        return nb, nb  # graph edges are symmetric-use in MPI semantics


class DistGraphTopology:
    """Distributed graph: each rank knows only its own in/out edges."""

    kind = "dist_graph"

    def __init__(self, sources: Sequence[int], destinations: Sequence[int],
                 source_weights: Optional[Sequence[int]] = None,
                 dest_weights: Optional[Sequence[int]] = None) -> None:
        self.sources = list(int(s) for s in sources)
        self.destinations = list(int(d) for d in destinations)
        self.source_weights = (list(source_weights)
                               if source_weights is not None else None)
        self.dest_weights = (list(dest_weights)
                             if dest_weights is not None else None)

    def neighbors(self, rank: int) -> tuple[list[int], list[int]]:
        return list(self.sources), list(self.destinations)


# ---------------------------------------------------------------------------
# create calls (collective over the parent communicator)
# ---------------------------------------------------------------------------

def _fold_reorder(comm, dims: Sequence[int],
                  mesh_shape: Optional[Sequence[int]]) -> list[int]:
    """Rank permutation for reorder=True (≈ topo/treematch).

    Places cart rank r (coords c) on the device whose physical mesh coords
    equal c under a greedy matching of cart dims to mesh axes of the same
    extent — so cart neighbors are mesh neighbors.  Assumes parent
    rank == device linear index (row-major over ``mesh_shape``), which is
    how the launcher lays ranks onto the cards.  Falls back to identity when
    no axis matching exists (or no mesh shape is given — the in-process
    harness, where identity is already optimal).
    """
    n = int(np.prod(dims)) if len(dims) else 1
    if mesh_shape is None or int(np.prod(mesh_shape)) != n:
        return list(range(n))
    mesh_shape = [int(m) for m in mesh_shape]
    # greedy: match each cart dim to an unused mesh axis of equal extent
    axis_of: list[Optional[int]] = []
    used: set[int] = set()
    for d in dims:
        ax = next((i for i, m in enumerate(mesh_shape)
                   if i not in used and m == d), None)
        if ax is None:
            return list(range(n))  # shapes incompatible — identity
        used.add(ax)
        axis_of.append(ax)
    if len(used) != len(mesh_shape):
        return list(range(n))  # leftover mesh axes (extent >1) — identity
    strides = [1] * len(mesh_shape)
    for i in range(len(mesh_shape) - 2, -1, -1):
        strides[i] = strides[i + 1] * mesh_shape[i + 1]
    cart = CartTopology(dims, [True] * len(dims))
    order = []
    for r in range(n):
        coords = cart.coords(r)
        order.append(sum(c * strides[ax]
                         for c, ax in zip(coords, axis_of)))
    return order


def cart_create(comm, dims: Sequence[int],
                periods: Optional[Sequence[bool]] = None,
                reorder: bool = False,
                mesh_shape: Optional[Sequence[int]] = None):
    """≈ MPI_Cart_create — collective; returns None on excluded ranks."""
    dims = [int(d) for d in dims]
    periods = ([bool(p) for p in periods] if periods is not None
               else [True] * len(dims))
    n = int(np.prod(dims)) if dims else 1
    if n > comm.size:
        raise MPIException(
            f"cart of {n} ranks > comm size {comm.size}", error_class=3)
    order = _fold_reorder(comm, dims, mesh_shape) if reorder \
        else list(range(n))
    from ompi_tpu_torch.mpi.group import Group

    members = [comm.world_rank(order[r]) for r in range(n)]
    new = comm.create(Group(members), name=f"{comm.name}.cart")
    if new is not None:
        new.topo = CartTopology(dims, periods)
    return new


def topo_test(comm) -> Optional[str]:
    """≈ MPI_Topo_test: "cart" | "graph" | "dist_graph" | None (no
    topology attached — MPI_UNDEFINED's role)."""
    t = getattr(comm, "topo", None)
    return t.kind if t is not None else None


def cart_get(comm) -> tuple[list[int], list[bool], list[int]]:
    """≈ MPI_Cart_get → (dims, periods, my coords)."""
    t = _topo_of(comm, "cart")
    return list(t.dims), list(t.periods), t.coords(comm.rank)


def cartdim_get(comm) -> int:
    """≈ MPI_Cartdim_get."""
    return _topo_of(comm, "cart").ndims


def graph_get(comm) -> tuple[list[int], list[int]]:
    """≈ MPI_Graph_get → (index, edges)."""
    t = _topo_of(comm, "graph")
    return list(t.index), list(t.edges)


def graphdims_get(comm) -> tuple[int, int]:
    """≈ MPI_Graphdims_get → (nnodes, nedges)."""
    t = _topo_of(comm, "graph")
    return t.size, len(t.edges)


def graph_neighbors(comm, rank: int) -> list[int]:
    """≈ MPI_Graph_neighbors."""
    return _topo_of(comm, "graph").neighbors_of(rank)


def graph_neighbors_count(comm, rank: int) -> int:
    """≈ MPI_Graph_neighbors_count."""
    return len(_topo_of(comm, "graph").neighbors_of(rank))


def dist_graph_neighbors(comm) -> tuple[list[int], list[int]]:
    """≈ MPI_Dist_graph_neighbors → (sources, destinations)."""
    return _topo_of(comm, "dist_graph").neighbors(comm.rank)


def dist_graph_neighbors_count(comm) -> tuple[int, int, bool]:
    """≈ MPI_Dist_graph_neighbors_count → (indegree, outdegree, weighted)."""
    t = _topo_of(comm, "dist_graph")
    srcs, dsts = t.neighbors(comm.rank)
    weighted = (t.source_weights is not None
                or t.dest_weights is not None)
    return len(srcs), len(dsts), weighted


def cart_map(comm, dims: Sequence[int],
             periods: Optional[Sequence[bool]] = None,
             mesh_shape: Optional[Sequence[int]] = None) -> int:
    """≈ MPI_Cart_map: the cart rank this process WOULD get under the
    reorder mapping (the same fold `cart_create(reorder=True)` applies),
    or UNDEFINED (-32766) when it doesn't belong to the grid."""
    dims = [int(d) for d in dims]
    n = int(np.prod(dims)) if dims else 1
    if n > comm.size:
        raise MPIException(
            f"cart of {n} ranks > comm size {comm.size}", error_class=3)
    order = _fold_reorder(comm, dims, mesh_shape)
    # order[cart_rank] = parent rank placed there; invert for my cart rank
    for cart_rank, parent in enumerate(order):
        if parent == comm.rank:
            return cart_rank
    return -32766  # MPI_UNDEFINED: not part of the grid


def graph_map(comm, index: Sequence[int], edges: Sequence[int]) -> int:
    """≈ MPI_Graph_map: identity placement (the base component's choice —
    topo_base_graph_map.c does the same), UNDEFINED beyond nnodes."""
    nnodes = len(index)
    if nnodes > comm.size:
        raise MPIException(
            f"graph of {nnodes} ranks > comm size {comm.size}",
            error_class=3)
    return comm.rank if comm.rank < nnodes else -32766


def cart_sub(comm, remain_dims: Sequence[bool]):
    """≈ MPI_Cart_sub — split the cart into lower-dim slices (collective)."""
    topo = _topo_of(comm, "cart")
    remain = [bool(b) for b in remain_dims]
    if len(remain) != topo.ndims:
        raise MPIException("remain_dims length mismatch", error_class=3)
    c = topo.coords(comm.rank)
    kept = [x for x, keep in zip(c, remain) if keep]
    kept_dims = [d for d, keep in zip(topo.dims, remain) if keep]
    kept_periods = [p for p, keep in zip(topo.periods, remain) if keep]
    # color = linearized dropped coords; key = linearized kept coords
    color = 0
    for x, (d, keep) in zip(c, zip(topo.dims, remain)):
        if not keep:
            color = color * d + x
    key = 0
    for x, d in zip(kept, kept_dims):
        key = key * d + x
    sub = comm.split(color, key, name=f"{comm.name}.sub")
    if sub is not None:
        sub.topo = CartTopology(kept_dims, kept_periods)
    return sub


def graph_create(comm, index: Sequence[int], edges: Sequence[int],
                 reorder: bool = False):
    """≈ MPI_Graph_create — collective; None on ranks beyond nnodes."""
    del reorder  # graph reorder is a no-op here, as in many MPIs
    n = len(index)
    if n > comm.size:
        raise MPIException("graph larger than communicator", error_class=3)
    from ompi_tpu_torch.mpi.group import Group

    new = comm.create(Group([comm.world_rank(r) for r in range(n)]),
                      name=f"{comm.name}.graph")
    if new is not None:
        new.topo = GraphTopology(index, edges)
    return new


def dist_graph_create_adjacent(comm, sources: Sequence[int],
                               destinations: Sequence[int],
                               source_weights=None, dest_weights=None):
    """≈ MPI_Dist_graph_create_adjacent — local edge lists, no traffic."""
    new = comm.dup(name=f"{comm.name}.distgraph")
    new.topo = DistGraphTopology(sources, destinations,
                                 source_weights, dest_weights)
    return new


def dist_graph_create(comm, sources: Sequence[int],
                      degrees: Sequence[int], destinations: Sequence[int],
                      weights: Optional[Sequence[int]] = None):
    """≈ MPI_Dist_graph_create — arbitrary ranks declare edges.

    Collective: every rank contributes (src, dst, weight) triples; an
    allgatherv-style exchange (here: allgather of variable rows through the
    host coll path) lets each rank extract its own in/out neighbor lists.
    """
    triples = []
    k = 0
    for s, deg in zip(sources, degrees):
        for _ in range(deg):
            w = int(weights[k]) if weights is not None else 1
            triples.append((int(s), int(destinations[k]), w))
            k += 1
    flat = np.asarray([x for t in triples for x in t],
                      dtype=np.int64).reshape(-1, 3)
    rows = comm.allgatherv(flat.reshape(-1))
    edges = np.concatenate([np.asarray(r).reshape(-1, 3) for r in rows]) \
        if rows else np.empty((0, 3), np.int64)
    me = comm.rank
    srcs = [(int(s), int(w)) for s, d, w in edges if d == me]
    dsts = [(int(d), int(w)) for s, d, w in edges if s == me]
    srcs.sort()
    dsts.sort()
    new = comm.dup(name=f"{comm.name}.distgraph")
    new.topo = DistGraphTopology(
        [s for s, _ in srcs], [d for d, _ in dsts],
        [w for _, w in srcs], [w for _, w in dsts])
    return new


def _topo_of(comm, kind: Optional[str] = None):
    topo = getattr(comm, "topo", None)
    if topo is None:
        raise MPIException(f"{comm.name} has no topology", error_class=11)
    if kind is not None and topo.kind != kind:
        raise MPIException(
            f"{comm.name} topology is {topo.kind}, need {kind}",
            error_class=11)
    return topo


# ---------------------------------------------------------------------------
# neighbor collectives (≈ MPI_Neighbor_*; ref: mca/coll base neighbor funcs)
# ---------------------------------------------------------------------------

def _send_slot(topo, comm_rank: int, j: int, d: int, dsts: list[int]) -> int:
    """The receiver-side recv-slot index this send block lands in.

    Needed so the tag disambiguates multiple edges between the same pair
    (e.g. a 2-cycle torus where the lo and hi neighbor are the same rank —
    there the -1 recv slot must get the peer's +1 send, not its first send).

    - cart: block 2d (lo dest) arrives at the peer as *their hi source* →
      slot 2d+1, and vice versa: slot = j ^ 1 within the dim pair.
    - graph: the full graph is global state; the slot is the matching
      occurrence of us in the peer's neighbor list.
    - dist_graph: peers only know local edges; parallel edges pair by
      occurrence order on both sides (the only consistent convention).
    """
    if topo.kind == "cart":
        return j ^ 1
    if topo.kind == "graph":
        occurrence = sum(1 for jj in range(j) if dsts[jj] == d)
        mine = [i for i, s in enumerate(topo.neighbors_of(d))
                if s == comm_rank]
        return mine[occurrence % len(mine)] if mine else occurrence
    return sum(1 for jj in range(j) if dsts[jj] == d)


def _recv_tag(topo, i: int, s: int, srcs: list[int], tag: int) -> int:
    """Tag expected on recv slot i — mirror of :func:`_send_slot`."""
    if topo.kind in ("cart", "graph"):
        return tag + (i % 64)
    occurrence = sum(1 for ii in range(i) if srcs[ii] == s)
    return tag + (occurrence % 64)


def _edge_meta(comm, ndst: int, tag: int):
    """Routing-only neighbor wire plan — the ONE source of truth for
    the edge slot/tag discipline (see _send_slot's 2-cycle-torus note),
    shared by the blocking, nonblocking, AND persistent variants so
    they always pair.

    Returns (srcs, send_meta, recvs): send_meta = [(out_index, dst,
    tag)] with PROC_NULL edges dropped; recvs = [(in_index, src, tag)]
    likewise.  Pure topology — the persistent neighbor plans freeze
    this once at bind and re-read only the payload per Start.
    """
    topo = _topo_of(comm)
    srcs, dsts = topo.neighbors(comm.rank)
    if ndst != len(dsts):
        raise MPIException(
            f"need {len(dsts)} send blocks, got {ndst}",
            error_class=2)
    send_meta = []
    for j, d in enumerate(dsts):
        if d == PROC_NULL:
            continue
        slot = _send_slot(topo, comm.rank, j, d, dsts)
        send_meta.append((j, d, tag + (slot % 64)))
    recvs = [(i, s, _recv_tag(topo, i, s, srcs, tag))
             for i, s in enumerate(srcs) if s != PROC_NULL]
    return srcs, send_meta, recvs


def _edge_plan(comm, send_per_dst: list, tag: int):
    """:func:`_edge_meta` with the payload attached: sends =
    [(data, dst, tag)]."""
    srcs, send_meta, recvs = _edge_meta(comm, len(send_per_dst), tag)
    sends = [(np.asarray(send_per_dst[j]), d, t)
             for j, d, t in send_meta]
    return srcs, sends, recvs


def _neighbor_exchange(comm, send_per_dst: list, tag: int) -> list:
    """Post irecvs from in-neighbors, isends to out-neighbors, wait all.

    PROC_NULL neighbors yield None in the result (MPI leaves the segment
    untouched; None is the honest Python rendering of that).
    """
    srcs, sends, recvs = _edge_plan(comm, send_per_dst, tag)
    rreq_by_i = {i: comm._coll_irecv(None, s, t) for i, s, t in recvs}
    sreqs = [comm._coll_isend(data, d, t) for data, d, t in sends]
    out = [rreq_by_i[i].wait() if i in rreq_by_i else None
           for i in range(len(srcs))]
    for s in sreqs:
        s.wait()
    return out


def neighbor_allgather(comm, sendbuf) -> list:
    """≈ MPI_Neighbor_allgather: same buffer to every out-neighbor; returns
    one entry per in-neighbor (None for PROC_NULL edges)."""
    _reject_device(sendbuf, "neighbor_allgather")
    topo = _topo_of(comm)
    _, dsts = topo.neighbors(comm.rank)
    return _neighbor_exchange(comm, [sendbuf] * len(dsts), _TAG_NEIGHBOR)


def neighbor_alltoall(comm, sendparts: Sequence) -> list:
    """≈ MPI_Neighbor_alltoall: distinct block per out-neighbor."""
    _reject_device_parts(sendparts, "neighbor_alltoall")
    return _neighbor_exchange(comm, list(sendparts), _TAG_NEIGHBOR + 64)


def neighbor_alltoallv(comm, sendparts: Sequence) -> list:
    """≈ MPI_Neighbor_alltoallv: variable-size blocks per out-neighbor."""
    _reject_device_parts(sendparts, "neighbor_alltoallv")
    return _neighbor_exchange(comm, list(sendparts), _TAG_NEIGHBOR + 128)


def neighbor_allgatherv(comm, sendbuf) -> list:
    """≈ MPI_Neighbor_allgatherv: this API is shape-polymorphic already
    (each in-neighbor entry keeps its own size), so the v-variant is the
    allgather with per-rank sizes allowed."""
    return neighbor_allgather(comm, sendbuf)


def neighbor_alltoallw(comm, sendspecs: Sequence, recvspecs: Sequence
                       ) -> None:
    """≈ MPI_Neighbor_alltoallw: per-neighbor (buf, datatype, count)
    triples (None = no exchange on that edge); receive buffers are filled
    in place via each edge's recv datatype."""
    from ompi_tpu_torch.mpi.coll.base import pack_spec, unpack_spec

    for specs in (sendspecs, recvspecs):
        _reject_device_parts(
            [None if s is None else s[0] for s in specs],
            "neighbor_alltoallw")
    topo = _topo_of(comm)
    srcs, dsts = topo.neighbors(comm.rank)
    if len(sendspecs) != len(dsts) or len(recvspecs) != len(srcs):
        raise MPIException(
            f"neighbor_alltoallw: need {len(dsts)} send / {len(srcs)} recv "
            f"specs, got {len(sendspecs)}/{len(recvspecs)}", error_class=2)
    got = _neighbor_exchange(comm, [pack_spec(s) for s in sendspecs],
                             _TAG_NEIGHBOR + 192)
    for spec, data in zip(recvspecs, got):
        if data is not None:
            unpack_spec(spec, data)


def _ineighbor(comm, send_per_dst: list, tag: int, kind: str):
    """Nonblocking neighbor exchange as a one-round nbc schedule.

    Reuses the blocking variants' tag windows: MPI requires collectives on
    a communicator to be issued in the same order on every rank, and the
    PML matches FIFO per (peer, tag), so concurrent outstanding neighbor
    ops pair up by posting order exactly like consecutive blocking ones."""
    from ompi_tpu_torch.mpi.coll.nbc import Round, _const, _launch

    srcs, sends, recvs = _edge_plan(comm, send_per_dst, tag)
    rounds = [Round(
        sends=tuple((_const(data), d, t) for data, d, t in sends),
        recvs=tuple((s, f"n{i}", t) for i, s, t in recvs))]

    def result(state):
        return [state.get(f"n{i}") if s != PROC_NULL else None
                for i, s in enumerate(srcs)]

    return _launch(comm, rounds, result, kind)


def ineighbor_allgather(comm, sendbuf):
    """≈ MPI_Ineighbor_allgather."""
    _reject_device(sendbuf, "ineighbor_allgather")
    topo = _topo_of(comm)
    _, dsts = topo.neighbors(comm.rank)
    return _ineighbor(comm, [sendbuf] * len(dsts), _TAG_NEIGHBOR,
                      "ineighbor_allgather")


def ineighbor_allgatherv(comm, sendbuf):
    """≈ MPI_Ineighbor_allgatherv (see neighbor_allgatherv)."""
    return ineighbor_allgather(comm, sendbuf)


def ineighbor_alltoall(comm, sendparts: Sequence):
    """≈ MPI_Ineighbor_alltoall."""
    _reject_device_parts(sendparts, "ineighbor_alltoall")
    return _ineighbor(comm, list(sendparts), _TAG_NEIGHBOR + 64,
                      "ineighbor_alltoall")


def ineighbor_alltoallv(comm, sendparts: Sequence):
    """≈ MPI_Ineighbor_alltoallv."""
    _reject_device_parts(sendparts, "ineighbor_alltoallv")
    return _ineighbor(comm, list(sendparts), _TAG_NEIGHBOR + 128,
                      "ineighbor_alltoallv")


# ---------------------------------------------------------------------------
# device lowering: a cart shift IS a ppermute (the TPU-native payoff)
# ---------------------------------------------------------------------------

def cart_perm(topo: CartTopology, direction: int, disp: int = 1
              ) -> list[tuple[int, int]]:
    """(src, dst) pairs for ``DeviceCommunicator.permute`` realizing one
    cart shift across ALL ranks at once.

    Non-periodic edge ranks simply don't appear as sources — matching
    ``permute``'s semantics (missing destinations receive zeros), which is
    also MPI's PROC_NULL behavior for a shift at a boundary.
    """
    pairs = []
    for r in range(topo.size):
        _, dst = topo.shift(r, direction, disp)
        if dst != PROC_NULL:
            pairs.append((r, dst))
    return pairs
