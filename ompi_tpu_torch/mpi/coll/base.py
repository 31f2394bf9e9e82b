"""The host collective algorithm library (the port's copy of the JAX
package's ``mpi/coll/base.py``, every algorithm).

≈ ompi/mca/coll/base/coll_base_*.c — the same algorithm inventory (SURVEY.md
§2.4 table), reimplemented over this framework's p2p with numpy buffers:

- allreduce: recursive doubling (coll_base_allreduce.c:128), ring (:339),
  linear fallback (:877)
- bcast: binomial tree (coll_base_bcast.c:313), linear (:608)
- reduce: binomial (rank-ordered fold, valid for non-commutative), linear
- allgather: recursive doubling (:256), bruck (:85), ring (:364), linear
- alltoall: pairwise (:132), linear
- reduce_scatter: ring (:455), reduce+scatter fallback (:46)
- gather/scatter: linear; barrier: dissemination (Bruck) exchange
- scan: linear chain

All functions are collective over `comm` and exchange equal-shaped arrays
(MPI's equal-count contract); variable-count (v-) versions take per-rank
counts along axis 0.

Array convention: pythonic — input array in, result array out (the reference
mutates out-buffers; the JAX package's immutable style is kept).  Rank
ordering for non-commutative ops follows MPI: the fold is always equivalent
to op(x_0, op(x_1, ... op(x_{p-2}, x_{p-1}))).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ompi_tpu_torch.mpi.op import Op
from ompi_tpu_torch.mpi.request import wait_all

# reserved collective tags (negative space via comm._coll_isend)
TAG_BARRIER = 1
TAG_BCAST = 2
TAG_REDUCE = 3
TAG_ALLREDUCE = 4
TAG_GATHER = 5
TAG_ALLGATHER = 6
TAG_SCATTER = 7
TAG_ALLTOALL = 8
TAG_REDUCE_SCATTER = 9
TAG_SCAN = 10
TAG_GATHERV = 11
TAG_SCATTERV = 12
TAG_ALLGATHERV = 13
TAG_ALLTOALLV = 14
TAG_EXSCAN = 15
TAG_ALLTOALLW = 16


def _fold(op: Op, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Reduce two blocks where `lo` covers lower ranks than `hi`."""
    return np.asarray(op.host(lo, hi))


# ---------------------------------------------------------------------------
# barrier — dissemination exchange (≈ coll_base_barrier.c bruck)

def barrier_dissemination(comm) -> None:
    size, rank = comm.size, comm.rank
    if size == 1:
        return
    token = np.zeros(0, dtype=np.uint8)
    step = 1
    while step < size:
        to = (rank + step) % size
        frm = (rank - step) % size
        sreq = comm._coll_isend(token, to, TAG_BARRIER)
        rreq = comm._coll_irecv(None, frm, TAG_BARRIER,
                                datatype=None, count=None)
        wait_all([sreq, rreq])
        step <<= 1


# ---------------------------------------------------------------------------
# bcast

def bcast_binomial(comm, buf: Optional[np.ndarray], root: int) -> np.ndarray:
    """Binomial tree broadcast (coll_base_bcast.c:313)."""
    size, rank = comm.size, comm.rank
    if size == 1:
        return np.asarray(buf)
    vrank = (rank - root) % size
    # my receive level = lowest set bit of vrank; parent is computable, so
    # receive from it specifically (ANY_SOURCE would race with the next
    # bcast's parent on the same tag)
    recv_mask = 1
    while recv_mask < size and not (vrank & recv_mask):
        recv_mask <<= 1
    if vrank != 0:
        parent = ((vrank & ~recv_mask) + root) % size
        buf = comm._coll_irecv(None, parent, TAG_BCAST).wait()
    arr = np.asarray(buf)
    mask = 1
    while mask < size:
        mask <<= 1
    mask >>= 1
    send_mask = recv_mask >> 1 if vrank != 0 else mask
    reqs = []
    while send_mask >= 1:
        vchild = vrank | send_mask
        if vchild < size and vchild != vrank:
            child = (vchild + root) % size
            reqs.append(comm._coll_isend(arr, child, TAG_BCAST))
        send_mask >>= 1
    wait_all(reqs)
    return arr


def bcast_linear(comm, buf: Optional[np.ndarray], root: int) -> np.ndarray:
    size, rank = comm.size, comm.rank
    if rank == root:
        arr = np.asarray(buf)
        wait_all([comm._coll_isend(arr, r, TAG_BCAST)
                  for r in range(size) if r != rank])
        return arr
    return comm._coll_irecv(None, root, TAG_BCAST).wait()


# ---------------------------------------------------------------------------
# reduce

def reduce_binomial(comm, sendbuf, op: Op, root: int) -> Optional[np.ndarray]:
    """Binomial tree reduce with rank-ordered folding: at every step the
    receiver holds ranks [vrank, vrank+mask) and receives [vrank+mask, ...),
    so op(acc, recv) is always in rank order — valid for non-commutative ops
    when root == 0; other roots rotate, so non-commutative ops reduce at
    vroot 0 and forward (the reference's approach in coll_base_reduce.c)."""
    size, rank = comm.size, comm.rank
    acc = np.asarray(sendbuf)
    if size == 1:
        return acc
    eff_root = root if op.commutative else 0
    vrank = (rank - eff_root) % size
    mask = 1
    while mask < size:
        if vrank & mask:
            parent = ((vrank & ~mask) + eff_root) % size
            comm._coll_isend(acc, parent, TAG_REDUCE).wait()
            acc = None
            break
        else:
            vchild = vrank | mask
            if vchild < size:
                child = (vchild + eff_root) % size
                recv = comm._coll_irecv(None, child, TAG_REDUCE).wait()
                recv = recv.reshape(acc.shape).astype(acc.dtype, copy=False)
                acc = _fold(op, acc, recv)
        mask <<= 1
    if eff_root != root:  # forward the result for non-commutative odd roots
        if rank == eff_root:
            comm._coll_isend(acc, root, TAG_REDUCE).wait()
            acc = None
        elif rank == root:
            shape = np.asarray(sendbuf).shape
            acc = comm._coll_irecv(None, eff_root, TAG_REDUCE).wait()
            acc = acc.reshape(shape)
    return acc if rank == root else None


# ---------------------------------------------------------------------------
# allreduce

def allreduce_recursive_doubling(comm, sendbuf, op: Op) -> np.ndarray:
    """coll_base_allreduce.c:128 — lg(p) rounds; non-power-of-2 folds
    *adjacent pairs* (rank 2r into 2r+1) first so every surviving rank holds
    a rank-contiguous block and the doubling folds stay rank-ordered —
    valid for non-commutative ops."""
    size, rank = comm.size, comm.rank
    acc = np.asarray(sendbuf)
    if size == 1:
        return acc
    shape, dtype = acc.shape, acc.dtype

    pof2 = 1
    while pof2 * 2 <= size:
        pof2 *= 2
    rem = size - pof2
    # pre-fold: among the first 2*rem ranks, even ranks fold into their odd
    # neighbor (keeps combined data rank-contiguous: d_{2r} ∘ d_{2r+1})
    if rank < 2 * rem:
        if rank % 2 == 0:
            comm._coll_isend(acc, rank + 1, TAG_ALLREDUCE).wait()
            newrank = -1
        else:
            recv = comm._coll_irecv(None, rank - 1, TAG_ALLREDUCE).wait()
            acc = _fold(op, recv.reshape(shape).astype(dtype, copy=False),
                        acc)
            newrank = rank // 2
    else:
        newrank = rank - rem
    if newrank >= 0:
        # newrank order == rank order of the contiguous blocks, so
        # partner<newrank decides the fold direction correctly
        def real_rank(nr: int) -> int:
            return 2 * nr + 1 if nr < rem else nr + rem

        mask = 1
        while mask < pof2:
            partner = real_rank(newrank ^ mask)
            sreq = comm._coll_isend(acc, partner, TAG_ALLREDUCE)
            recv = comm._coll_irecv(None, partner, TAG_ALLREDUCE).wait()
            sreq.wait()
            recv = recv.reshape(shape).astype(dtype, copy=False)
            acc = (_fold(op, recv, acc) if (newrank ^ mask) < newrank
                   else _fold(op, acc, recv))
            mask <<= 1
    # return results to the folded-out even ranks
    if rank < 2 * rem:
        if rank % 2:
            comm._coll_isend(acc, rank - 1, TAG_ALLREDUCE).wait()
        else:
            acc = comm._coll_irecv(None, rank + 1, TAG_ALLREDUCE).wait()
            acc = acc.reshape(shape).astype(dtype, copy=False)
    return acc


def allreduce_ring(comm, sendbuf, op: Op) -> np.ndarray:
    """coll_base_allreduce.c:339 — reduce-scatter ring + allgather ring.
    2(p-1) steps, each moving size/p; bandwidth-optimal. Commutative only."""
    size, rank = comm.size, comm.rank
    arr = np.asarray(sendbuf)
    if size == 1:
        return arr
    flat = arr.reshape(-1)
    chunks = np.array_split(flat, size)
    chunks = [c.copy() for c in chunks]
    right = (rank + 1) % size
    left = (rank - 1) % size
    # reduce-scatter: after p-1 steps, chunk (rank+1)%size is fully reduced
    send_idx = rank
    for _ in range(size - 1):
        sreq = comm._coll_isend(chunks[send_idx], right, TAG_ALLREDUCE)
        recv_idx = (send_idx - 1) % size
        recv = comm._coll_irecv(None, left, TAG_ALLREDUCE).wait()
        sreq.wait()
        chunks[recv_idx] = np.asarray(
            op.host(chunks[recv_idx],
                    recv.astype(chunks[recv_idx].dtype, copy=False)))
        send_idx = recv_idx
    # allgather ring: circulate the reduced chunks
    send_idx = (rank + 1) % size
    for _ in range(size - 1):
        sreq = comm._coll_isend(chunks[send_idx], right, TAG_ALLGATHER)
        recv_idx = (send_idx - 1) % size
        recv = comm._coll_irecv(None, left, TAG_ALLGATHER).wait()
        sreq.wait()
        chunks[recv_idx] = recv.astype(chunks[recv_idx].dtype, copy=False)
        send_idx = recv_idx
    return np.concatenate(chunks).reshape(arr.shape)


def allreduce_linear(comm, sendbuf, op: Op) -> np.ndarray:
    """reduce to 0 + bcast (coll_base_allreduce.c:877 nonoverlapping)."""
    out = reduce_binomial(comm, sendbuf, op, 0)
    return bcast_binomial(comm, out, 0)


# ---------------------------------------------------------------------------
# allgather

def allgather_bruck(comm, sendbuf) -> np.ndarray:
    """coll_base_allgather.c:85 — lg(p) rounds, any p; blocks end rotated."""
    size, rank = comm.size, comm.rank
    mine = np.asarray(sendbuf)
    if size == 1:
        return mine[None]
    blocks: list[Optional[np.ndarray]] = [None] * size
    blocks[0] = mine
    step = 1
    filled = 1
    while step < size:
        cnt = min(step, size - filled)
        to = (rank - step) % size
        frm = (rank + step) % size
        payload = np.stack(blocks[0:cnt])
        sreq = comm._coll_isend(payload, to, TAG_ALLGATHER)
        recv = comm._coll_irecv(None, frm, TAG_ALLGATHER).wait()
        sreq.wait()
        recv = recv.reshape((cnt,) + mine.shape).astype(mine.dtype, copy=False)
        for i in range(cnt):
            blocks[filled + i] = recv[i]
        filled += cnt
        step <<= 1
    # local rotation: blocks[i] holds rank (rank+i)%size's data
    out = [None] * size
    for i in range(size):
        out[(rank + i) % size] = blocks[i]
    return np.stack(out)  # type: ignore[arg-type]


def allgather_ring(comm, sendbuf) -> np.ndarray:
    """coll_base_allgather.c:364 — p-1 neighbor exchanges."""
    size, rank = comm.size, comm.rank
    mine = np.asarray(sendbuf)
    if size == 1:
        return mine[None]
    out: list[Optional[np.ndarray]] = [None] * size
    out[rank] = mine
    right = (rank + 1) % size
    left = (rank - 1) % size
    send_idx = rank
    for _ in range(size - 1):
        sreq = comm._coll_isend(out[send_idx], right, TAG_ALLGATHER)
        recv_idx = (send_idx - 1) % size
        recv = comm._coll_irecv(None, left, TAG_ALLGATHER).wait()
        sreq.wait()
        out[recv_idx] = recv.reshape(mine.shape).astype(mine.dtype, copy=False)
        send_idx = recv_idx
    return np.stack(out)  # type: ignore[arg-type]


# ---------------------------------------------------------------------------
# gather / scatter (linear, ≈ coll_base_gather/scatter.c basic linear)

def gather_linear(comm, sendbuf, root: int) -> Optional[np.ndarray]:
    size, rank = comm.size, comm.rank
    mine = np.asarray(sendbuf)
    if rank == root:
        parts: list[Optional[np.ndarray]] = [None] * size
        parts[rank] = mine
        reqs = {r: comm._coll_irecv(None, r, TAG_GATHER)
                for r in range(size) if r != root}
        for r, req in reqs.items():
            parts[r] = req.wait().reshape(mine.shape).astype(
                mine.dtype, copy=False)
        return np.stack(parts)  # type: ignore[arg-type]
    comm._coll_isend(mine, root, TAG_GATHER).wait()
    return None


def scatter_linear(comm, sendbuf, root: int) -> np.ndarray:
    size, rank = comm.size, comm.rank
    if rank == root:
        arr = np.asarray(sendbuf)
        if arr.shape[0] % size:
            from ompi_tpu_torch.mpi.constants import MPIException

            raise MPIException(
                f"scatter: axis 0 ({arr.shape[0]}) not divisible by {size}")
        parts = np.split(arr, size, axis=0)
        reqs = [comm._coll_isend(parts[r], r, TAG_SCATTER)
                for r in range(size) if r != root]
        wait_all(reqs)
        return parts[rank]
    return comm._coll_irecv(None, root, TAG_SCATTER).wait()


# ---------------------------------------------------------------------------
# alltoall — pairwise exchange (coll_base_alltoall.c:132)

def alltoall_pairwise(comm, sendbuf) -> np.ndarray:
    size, rank = comm.size, comm.rank
    arr = np.asarray(sendbuf)
    if arr.shape[0] % size:
        from ompi_tpu_torch.mpi.constants import MPIException

        raise MPIException(
            f"alltoall: axis 0 ({arr.shape[0]}) not divisible by {size}")
    parts = np.split(arr, size, axis=0)
    out: list[Optional[np.ndarray]] = [None] * size
    out[rank] = parts[rank]
    for step in range(1, size):
        to = (rank + step) % size
        frm = (rank - step) % size
        sreq = comm._coll_isend(parts[to], to, TAG_ALLTOALL)
        recv = comm._coll_irecv(None, frm, TAG_ALLTOALL).wait()
        sreq.wait()
        out[frm] = recv.reshape(parts[rank].shape).astype(arr.dtype, copy=False)
    return np.concatenate(out)  # type: ignore[arg-type]


# ---------------------------------------------------------------------------
# reduce_scatter — ring (coll_base_reduce_scatter.c:455)

def reduce_scatter_ring(comm, sendbuf, op: Op) -> np.ndarray:
    """Each rank ends with its block of the fully-reduced array.
    Commutative only (ring accumulation order)."""
    size, rank = comm.size, comm.rank
    arr = np.asarray(sendbuf)
    if size == 1:
        return arr
    flat = arr.reshape(-1)
    chunks = [c.copy() for c in np.array_split(flat, size)]
    right = (rank + 1) % size
    left = (rank - 1) % size
    # after p-1 steps the fully-reduced chunk is (start_idx+1) mod p, so
    # starting at rank-1 leaves rank owning its own chunk
    send_idx = (rank - 1) % size
    for _ in range(size - 1):
        sreq = comm._coll_isend(chunks[send_idx], right, TAG_REDUCE_SCATTER)
        recv_idx = (send_idx - 1) % size
        recv = comm._coll_irecv(None, left, TAG_REDUCE_SCATTER).wait()
        sreq.wait()
        chunks[recv_idx] = np.asarray(
            op.host(chunks[recv_idx],
                    recv.astype(chunks[recv_idx].dtype, copy=False)))
        send_idx = recv_idx
    return chunks[rank]


def reduce_scatter_basic(comm, sendbuf, op: Op) -> np.ndarray:
    """reduce + scatter fallback (valid for non-commutative ops)."""
    size = comm.size
    reduced = reduce_binomial(comm, sendbuf, op, 0)
    if comm.rank == 0:
        flat = reduced.reshape(-1)
        # pad-free equal split contract: use array_split boundaries
        parts = np.array_split(flat, size)
        for r in range(1, size):
            comm._coll_isend(parts[r], r, TAG_REDUCE_SCATTER).wait()
        return parts[0]
    return comm._coll_irecv(None, 0, TAG_REDUCE_SCATTER).wait()


# ---------------------------------------------------------------------------
# scan / exscan — linear chain

def scan_linear(comm, sendbuf, op: Op) -> np.ndarray:
    """Inclusive prefix reduction: result_r = op(x_0, ..., x_r)."""
    rank, size = comm.rank, comm.size
    acc = np.asarray(sendbuf)
    if rank > 0:
        prev = comm._coll_irecv(None, rank - 1, TAG_SCAN).wait()
        acc = _fold(op, prev.reshape(acc.shape).astype(acc.dtype, copy=False),
                    acc)
    if rank < size - 1:
        comm._coll_isend(acc, rank + 1, TAG_SCAN).wait()
    return acc


def exscan_linear(comm, sendbuf, op: Op) -> Optional[np.ndarray]:
    """Exclusive prefix reduction: result_r = op(x_0, ..., x_{r-1}); rank 0's
    result is undefined per MPI (returned as None)."""
    rank, size = comm.rank, comm.size
    mine = np.asarray(sendbuf)
    prev: Optional[np.ndarray] = None
    if rank > 0:
        prev = comm._coll_irecv(None, rank - 1, TAG_EXSCAN).wait()
        prev = prev.reshape(mine.shape).astype(mine.dtype, copy=False)
    if rank < size - 1:
        fwd = mine if prev is None else _fold(op, prev, mine)
        comm._coll_isend(fwd, rank + 1, TAG_EXSCAN).wait()
    return prev


# ---------------------------------------------------------------------------
# variable-count (v-) collectives: per-rank blocks of differing axis-0 length
# (same trailing shape/dtype).  Pythonic contract: lists of arrays in/out
# preserve the block boundaries that MPI expresses as count/displacement
# vectors.  Linear exchange, like the basic components in the reference.

def gatherv_linear(comm, sendbuf, root: int) -> Optional[list]:
    size, rank = comm.size, comm.rank
    mine = np.asarray(sendbuf)
    if rank == root:
        parts: list[Optional[np.ndarray]] = [None] * size
        parts[rank] = mine
        reqs = {r: comm._coll_irecv(None, r, TAG_GATHERV)
                for r in range(size) if r != root}
        for r, req in reqs.items():
            parts[r] = req.wait()
        return parts  # type: ignore[return-value]
    comm._coll_isend(mine, root, TAG_GATHERV).wait()
    return None


def scatterv_linear(comm, sendparts, root: int) -> np.ndarray:
    size, rank = comm.size, comm.rank
    if rank == root:
        if len(sendparts) != size:
            from ompi_tpu_torch.mpi.constants import MPIException

            raise MPIException(
                f"scatterv: {len(sendparts)} blocks for {size} ranks")
        wait_all([comm._coll_isend(np.asarray(sendparts[r]), r, TAG_SCATTERV)
                  for r in range(size) if r != root])
        return np.asarray(sendparts[rank])
    return comm._coll_irecv(None, root, TAG_SCATTERV).wait()


def allgatherv_ring(comm, sendbuf) -> list:
    """Each rank's block circulates p-1 hops (coll_base_allgatherv ring)."""
    size, rank = comm.size, comm.rank
    mine = np.asarray(sendbuf)
    out: list[Optional[np.ndarray]] = [None] * size
    out[rank] = mine
    if size == 1:
        return out  # type: ignore[return-value]
    right = (rank + 1) % size
    left = (rank - 1) % size
    send_idx = rank
    for _ in range(size - 1):
        sreq = comm._coll_isend(out[send_idx], right, TAG_ALLGATHERV)
        recv_idx = (send_idx - 1) % size
        recv = comm._coll_irecv(None, left, TAG_ALLGATHERV).wait()
        sreq.wait()
        out[recv_idx] = recv
        send_idx = recv_idx
    return out  # type: ignore[return-value]


def alltoallv_pairwise(comm, sendparts) -> list:
    """sendparts[i] goes to rank i (None ⇒ an empty block — MPI's
    zero-count entry); returns out[i] = block from rank i."""
    size, rank = comm.size, comm.rank
    if len(sendparts) != size:
        from ompi_tpu_torch.mpi.constants import MPIException

        raise MPIException(
            f"alltoallv: {len(sendparts)} blocks for {size} ranks")
    # normalize up front (a None part used to reach np.asarray and ship
    # an object scalar): every peer still pairs its send/recv, a
    # zero-count block just travels as an empty frame
    norm = [np.empty(0, np.uint8) if p is None else np.asarray(p)
            for p in sendparts]
    out: list[Optional[np.ndarray]] = [None] * size
    out[rank] = norm[rank]
    if size == 1:
        return out  # type: ignore[return-value]
    for step in range(1, size):
        to = (rank + step) % size
        frm = (rank - step) % size
        sreq = comm._coll_isend(norm[to], to, TAG_ALLTOALLV)
        out[frm] = comm._coll_irecv(None, frm, TAG_ALLTOALLV).wait()
        sreq.wait()
    return out  # type: ignore[return-value]


def pack_spec(spec) -> np.ndarray:
    """(buf, datatype, count) triple → packed uint8 array (None → empty).
    The shared half of the Alltoallw-family wire format."""
    if spec is None:
        return np.empty(0, np.uint8)
    buf, dt, count = spec
    return np.frombuffer(dt.pack(np.asarray(buf), count), np.uint8)


def unpack_spec(spec, data) -> None:
    """Packed bytes → the spec's buffer via its datatype (None → no-op)."""
    if spec is None:
        return
    buf, dt, count = spec
    dt.unpack(np.asarray(data, np.uint8).tobytes(), buf, count)


def alltoallw_pairwise(comm, sendspecs, recvspecs) -> None:
    """≈ MPI_Alltoallw (the fully general alltoall: per-peer datatype +
    count on BOTH sides — ompi/mpi/c/alltoallw.c).  ``sendspecs[i]`` /
    ``recvspecs[i]`` are ``(buf, datatype, count)`` triples (or None for
    an empty exchange with that peer); each block is packed with its send
    datatype and unpacked into the receiver's buffer with the receiver's
    datatype, exercising the full convertor path per pair."""
    size, rank = comm.size, comm.rank
    if len(sendspecs) != size or len(recvspecs) != size:
        from ompi_tpu_torch.mpi.constants import MPIException

        raise MPIException(
            f"alltoallw: {len(sendspecs)}/{len(recvspecs)} specs for "
            f"{size} ranks")
    unpack_spec(recvspecs[rank], pack_spec(sendspecs[rank]))
    if size == 1:
        return
    for step in range(1, size):
        to = (rank + step) % size
        frm = (rank - step) % size
        sreq = comm._coll_isend(pack_spec(sendspecs[to]), to, TAG_ALLTOALLW)
        got = comm._coll_irecv(None, frm, TAG_ALLTOALLW).wait()
        sreq.wait()
        unpack_spec(recvspecs[frm], got)


# ---------------------------------------------------------------------------
# extra algorithms from the reference inventory

def alltoall_bruck(comm, sendbuf) -> np.ndarray:
    """coll_base_alltoall.c:191 — lg(p) rounds moving half the blocks each;
    latency-optimal for small messages."""
    size, rank = comm.size, comm.rank
    arr = np.asarray(sendbuf)
    if arr.shape[0] % size:
        from ompi_tpu_torch.mpi.constants import MPIException

        raise MPIException(
            f"alltoall: axis 0 ({arr.shape[0]}) not divisible by {size}")
    if size == 1:
        return arr
    parts = np.split(arr, size, axis=0)
    # phase 1: local rotation so blocks[i] targets (rank+i)%size
    blocks = [parts[(rank + i) % size] for i in range(size)]
    # phase 2: lg(p) exchange rounds — round k moves blocks whose index has
    # bit k set, to rank+2^k (they travel toward their target in binary)
    pof = 1
    while pof < size:
        idxs = [i for i in range(size) if i & pof]
        to = (rank + pof) % size
        frm = (rank - pof) % size
        payload = np.concatenate([blocks[i] for i in idxs], axis=0)
        sreq = comm._coll_isend(payload, to, TAG_ALLTOALL)
        recv = comm._coll_irecv(None, frm, TAG_ALLTOALL).wait()
        sreq.wait()
        recv = recv.reshape((len(idxs),) + blocks[0].shape).astype(
            arr.dtype, copy=False)
        for j, i in enumerate(idxs):
            blocks[i] = recv[j]
        pof <<= 1
    # phase 3: inverse rotation — block i holds data *from* (rank-i)%size
    out: list[Optional[np.ndarray]] = [None] * size
    for i in range(size):
        out[(rank - i) % size] = blocks[i]
    return np.concatenate(out, axis=0)  # type: ignore[arg-type]


def allreduce_segmented_ring(comm, sendbuf, op: Op,
                             segsize: int = 1 << 20) -> np.ndarray:
    """coll_base_allreduce.c:615 — the ring with each step's payload split
    into ~segsize-byte segments sent as independent messages, so folding an
    arrived segment overlaps the transfer of the next (the same
    double-buffered overlap pattern as ring attention).  Latency is the same
    2(p-1) steps as the plain ring.  Commutative only."""
    size, rank = comm.size, comm.rank
    arr = np.asarray(sendbuf)
    if size == 1:
        return arr
    flat = arr.reshape(-1)
    seg_elems = max(1, segsize // max(1, arr.dtype.itemsize))
    nseg = -(-flat.size // (seg_elems * size)) if flat.size else 1
    if nseg <= 1:
        return allreduce_ring(comm, sendbuf, op)
    # segs[s] = per-rank chunk list for segment s; per-pair ordering makes
    # the s-th posted irecv match the s-th segment sent each step
    bounds = [min(s * seg_elems * size, flat.size) for s in range(nseg + 1)]
    segs = [[c.copy() for c in np.array_split(flat[bounds[s]:bounds[s + 1]],
                                              size)]
            for s in range(nseg)]
    right = (rank + 1) % size
    left = (rank - 1) % size

    def ring_phase(tag, fold):
        nonlocal segs
        send_idx = rank if fold else (rank + 1) % size
        for _ in range(size - 1):
            recv_idx = (send_idx - 1) % size
            sreqs = [comm._coll_isend(segs[s][send_idx], right, tag)
                     for s in range(nseg)]
            rreqs = [comm._coll_irecv(None, left, tag) for _ in range(nseg)]
            for s in range(nseg):  # fold segment s while s+1 is in flight
                recv = rreqs[s].wait().reshape(-1)
                cur = segs[s][recv_idx]
                recv = recv.astype(cur.dtype, copy=False)
                segs[s][recv_idx] = (np.asarray(op.host(cur, recv)) if fold
                                     else recv)
            wait_all(sreqs)
            send_idx = recv_idx

    ring_phase(TAG_ALLREDUCE, fold=True)    # reduce-scatter phase
    ring_phase(TAG_ALLGATHER, fold=False)   # allgather phase
    out = np.concatenate([c for s in range(nseg) for c in segs[s]])
    return out.reshape(arr.shape)


def bcast_pipeline(comm, buf: Optional[np.ndarray], root: int,
                   segsize: int = 128 * 1024) -> np.ndarray:
    """coll_base_bcast.c:257 — chain pipeline: ranks form a chain rooted at
    root; the message moves in segments so all links stream concurrently."""
    size, rank = comm.size, comm.rank
    if size == 1:
        return np.asarray(buf)
    vrank = (rank - root) % size
    prev = ((vrank - 1) + root) % size
    nxt = ((vrank + 1) + root) % size
    last = vrank == size - 1
    if vrank == 0:
        arr = np.asarray(buf)
        flat = arr.reshape(-1)
        seg_elems = max(1, segsize // max(1, arr.dtype.itemsize))
        nseg = max(1, -(-flat.size // seg_elems))
        # ship a tiny header so receivers know segmentation + final shape
        hdr = np.array([seg_elems] + list(arr.shape), dtype=np.int64)
        comm._coll_isend(hdr, nxt, TAG_BCAST).wait()
        reqs = [comm._coll_isend(flat[i * seg_elems:(i + 1) * seg_elems],
                                 nxt, TAG_BCAST) for i in range(nseg)]
        wait_all(reqs)
        return arr
    hdr = comm._coll_irecv(None, prev, TAG_BCAST).wait()
    seg_elems = int(hdr[0])
    shape = tuple(int(x) for x in hdr[1:])
    total = int(np.prod(shape)) if shape else 1
    nseg = max(1, -(-total // seg_elems))
    if not last:
        comm._coll_isend(hdr, nxt, TAG_BCAST).wait()
    segs = []
    fwd = []
    for _ in range(nseg):
        seg = comm._coll_irecv(None, prev, TAG_BCAST).wait()
        segs.append(seg)
        if not last:
            fwd.append(comm._coll_isend(seg, nxt, TAG_BCAST))
    wait_all(fwd)
    flat = np.concatenate([s.reshape(-1) for s in segs])
    return flat.reshape(shape)
