"""Nonblocking collectives: round-based schedules (the port's copy of the
JAX package's ``mpi/coll/nbc.py``).

≈ ompi/mca/coll/libnbc (nbc_internal.h:146-155): each nonblocking collective
is compiled, at call time, into a *schedule* — an ordered list of rounds,
each holding sends, receives, and an end-of-round local computation.  The
schedule progresses without a helper thread: every ``test()``/``wait()`` on
the returned request advances whatever rounds have completed (the reference
progresses schedules from ``opal_progress``; here the request itself is the
progress hook, which matches MPI's weak progress guarantee).

Tag isolation: every operation draws a fresh tag from the communicator's
nbc sequence counter — collective calls are ordered identically on all ranks
(an MPI-mandated property the reference also leans on, nbc_internal.h's
schedule tags), so concurrently-outstanding collectives never cross-match.

Host buffers only: a torch tensor (on any device) is refused with the
PML's message before anything is copied; collectives on tensors run on
the communicator's device route (``comm.bind_device``).

Left out: the trace plane's flight-recorder records (``i<kind>`` posts,
round advances) and the ``coll_nbc_ns`` histogram (ROADMAP.md Queue 1
item 6.9).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Optional

import numpy as np

from ompi_tpu_torch.mpi.constants import MPIException
from ompi_tpu_torch.mpi.op import Op
from ompi_tpu_torch.mpi.pml import _reject_device, _reject_device_parts
from ompi_tpu_torch.mpi.request import Request

__all__ = [
    "NbcRequest", "ibarrier", "ibcast", "ireduce", "iallreduce", "igather",
    "iallgather", "iscatter", "ialltoall", "ireduce_scatter", "iscan",
    "iexscan", "ialltoallv", "iallgatherv", "igatherv", "iscatterv",
    "ireduce_scatter_block", "ialltoallw",
    "barrier_schedule", "bcast_schedule", "reduce_schedule",
    "allreduce_schedule", "allgather_schedule",
]

# offset into the reserved collective tag space (blocking collectives use
# low coll-tags; nbc draws from 64 upward, one per outstanding op)
_NBC_TAG_BASE = 64


class Round:
    """One schedule round: post sends+recvs, await all, then compute."""

    __slots__ = ("sends", "recvs", "compute")

    def __init__(self,
                 sends: tuple = (),
                 recvs: tuple = (),
                 compute: Optional[Callable[[dict], None]] = None) -> None:
        # sends: ((buf_fn(state) -> array, peer), ...) — an optional third
        # element is an ABSOLUTE coll tag overriding the schedule's own
        # (neighbor collectives need the edge-slot tag discipline of
        # topo._send_slot); recvs: ((peer, state_key[, abs_tag]), ...)
        self.sends = sends
        self.recvs = recvs
        self.compute = compute


class NbcRequest(Request):
    """A collective request progressed by test()/wait() (libnbc schedule)."""

    def __init__(self, comm, rounds: list[Round],
                 result: Callable[[dict], Any], tag: int,
                 kind: str = "nbc", state: Optional[dict] = None) -> None:
        super().__init__(kind=kind)
        self._comm = comm
        self._rounds = rounds
        self._result_fn = result
        self._tag = tag
        self._state: dict = state if state is not None else {}
        self._ridx = 0
        self._pending: Optional[list] = None  # [(req, key|None), ...]
        self._nbc_lock = threading.Lock()
        self._progress(block=False)

    # -- progress engine --------------------------------------------------

    def _start_round(self) -> None:
        rnd = self._rounds[self._ridx]
        pending = []
        # post receives first (the reference posts recvs before sends in a
        # round to keep the unexpected queue short)
        for entry in rnd.recvs:
            peer, key = entry[0], entry[1]
            tag = entry[2] if len(entry) > 2 else self._tag
            pending.append(
                (self._comm._coll_irecv(None, peer, tag), key))
        for entry in rnd.sends:
            buf_fn, peer = entry[0], entry[1]
            tag = entry[2] if len(entry) > 2 else self._tag
            buf = np.asarray(buf_fn(self._state))
            pending.append((self._comm._coll_isend(buf, peer, tag),
                            None))
        self._pending = pending

    def _finish_round(self) -> None:
        rnd = self._rounds[self._ridx]
        for req, key in self._pending:  # type: ignore[union-attr]
            if key is not None:
                self._state[key] = req.wait()  # already complete
        if rnd.compute is not None:
            rnd.compute(self._state)
        self._pending = None
        self._ridx += 1

    def _progress(self, block: bool,
                  deadline: Optional[float] = None) -> bool:
        """Advance as far as possible; True when the schedule is done."""
        with self._nbc_lock:
            if self.done():
                return True
            while self._ridx < len(self._rounds):
                if self._pending is None:
                    self._start_round()
                assert self._pending is not None
                if block:
                    for req, _ in self._pending:
                        if deadline is None:
                            req.wait()
                        else:
                            remaining = deadline - time.monotonic()
                            if remaining <= 0:
                                raise TimeoutError(
                                    f"{self.kind} timed out in round "
                                    f"{self._ridx}/{len(self._rounds)}")
                            req.wait(timeout=remaining)
                elif not all(req.test() for req, _ in self._pending):
                    return False
                self._finish_round()
            self.complete(self._result_fn(self._state))
            return True

    # -- Request interface ------------------------------------------------

    def test(self) -> bool:
        return self._progress(block=False)

    def wait(self, timeout: Optional[float] = None) -> Any:
        deadline = None if timeout is None else time.monotonic() + timeout
        self._progress(block=True, deadline=deadline)
        return super().wait(timeout=timeout)


# nbc tags live in [64, 500) — below the OSC (500s) and neighbor-collective
# (700-891) blocks; the sequence wraps within the window (collision would
# need 436 simultaneously-outstanding nbc ops on one communicator)
_NBC_TAG_SPAN = 436


def _next_tag(comm) -> int:
    with comm._lock:
        seq = comm._nbc_seq = comm._nbc_seq + 1
    return _NBC_TAG_BASE + (seq % _NBC_TAG_SPAN)


def _launch(comm, rounds, result, kind, state=None) -> NbcRequest:
    return NbcRequest(comm, rounds, result, _next_tag(comm), kind=kind,
                      state=state)


def _const(x):
    return lambda state: x


# ---------------------------------------------------------------------------
# schedule builders (one per collective).  The *_schedule functions
# return ``(rounds, make_state, result_fn)`` — a REUSABLE template:
# the rounds close over the caller's arrays (re-read on every launch,
# the persistent-request buffer contract) while all per-launch
# mutability lives in the fresh dict ``make_state()`` returns.  The
# one-shot i* wrappers launch a template once; coll/persistent
# pre-materialises a template at *_init time and launches it per Start.

def barrier_schedule(comm):
    """Dissemination barrier, one round per step."""
    size, rank = comm.size, comm.rank
    token = np.zeros(0, dtype=np.uint8)
    rounds = []
    step = 1
    while step < size:
        to = (rank + step) % size
        frm = (rank - step) % size
        rounds.append(Round(sends=((_const(token), to),),
                            recvs=((frm, f"t{step}"),)))
        step <<= 1
    return rounds, dict, lambda s: None


def ibarrier(comm) -> NbcRequest:
    rounds, make_state, result = barrier_schedule(comm)
    return _launch(comm, rounds, result, "ibarrier", state=make_state())


def bcast_schedule(comm, buf, root: int = 0):
    """Binomial tree: one recv round (non-root), one send round."""
    size, rank = comm.size, comm.rank
    if size == 1:
        return [], dict, _const(np.asarray(buf))
    vrank = (rank - root) % size
    recv_mask = 1
    while recv_mask < size and not (vrank & recv_mask):
        recv_mask <<= 1
    rounds = []
    if vrank != 0:
        parent = ((vrank & ~recv_mask) + root) % size
        rounds.append(Round(recvs=((parent, "buf"),)))
        get = lambda s: s["buf"]  # noqa: E731
    else:
        arr = np.asarray(buf)
        get = _const(arr)
    mask = 1
    while mask < size:
        mask <<= 1
    mask >>= 1
    send_mask = recv_mask >> 1 if vrank != 0 else mask
    sends = []
    while send_mask >= 1:
        vchild = vrank | send_mask
        if vchild < size and vchild != vrank:
            sends.append((get, (vchild + root) % size))
        send_mask >>= 1
    if sends:
        rounds.append(Round(sends=tuple(sends)))
    return rounds, dict, get


def ibcast(comm, buf, root: int = 0) -> NbcRequest:
    _reject_device(buf, "ibcast")
    rounds, make_state, result = bcast_schedule(comm, buf, root)
    return _launch(comm, rounds, result, "ibcast", state=make_state())


def _reduce_rounds(comm, mine: np.ndarray, op: Op,
                   root: int) -> tuple[list[Round], Callable[[], dict]]:
    """Binomial-fold rounds leaving the reduction in state['acc'] on `root`.
    Children cover disjoint ascending vrank ranges, so folding in ascending
    mask order preserves rank order (valid for non-commutative when the
    effective root is 0, mirroring reduce_binomial)."""
    size, rank = comm.size, comm.rank
    rounds: list[Round] = []
    make_state = lambda: {"acc": mine}  # noqa: E731
    if size == 1:
        return rounds, make_state
    eff_root = root if op.commutative else 0
    vrank = (rank - eff_root) % size
    children = []
    parent = None
    mask = 1
    while mask < size:
        if vrank & mask:
            parent = ((vrank & ~mask) + eff_root) % size
            break
        vchild = vrank | mask
        if vchild < size:
            children.append((vchild + eff_root) % size)
        mask <<= 1

    if children:
        def fold(state, keys=tuple(f"c{i}" for i in range(len(children)))):
            acc = state["acc"]
            for k in keys:
                recv = state[k].reshape(acc.shape).astype(acc.dtype,
                                                          copy=False)
                acc = np.asarray(op.host(acc, recv))
            state["acc"] = acc

        rounds.append(Round(
            recvs=tuple((c, f"c{i}") for i, c in enumerate(children)),
            compute=fold))
    if parent is not None:
        rounds.append(Round(sends=(((lambda s: s["acc"]), parent),)))
    # odd-root forwarding for non-commutative ops
    if eff_root != root:
        if rank == eff_root:
            rounds.append(Round(sends=(((lambda s: s["acc"]), root),)))
        elif rank == root:
            rounds.append(Round(recvs=((eff_root, "fwd"),),
                                compute=lambda s: s.__setitem__(
                                    "acc", s["fwd"].reshape(mine.shape))))
    return rounds, make_state


def reduce_schedule(comm, sendbuf, op: Op, root: int = 0):
    mine = np.asarray(sendbuf)
    rounds, make_state = _reduce_rounds(comm, mine, op, root)
    result = (lambda s: s["acc"]) if comm.rank == root else _const(None)
    return rounds, make_state, result


def ireduce(comm, sendbuf, op: Op, root: int = 0) -> NbcRequest:
    _reject_device(sendbuf, "ireduce")
    rounds, make_state, result = reduce_schedule(comm, sendbuf, op, root)
    return _launch(comm, rounds, result, "ireduce", state=make_state())


def allreduce_schedule(comm, sendbuf, op: Op):
    """Recursive doubling, one round per step.  Non-pof2 folds *adjacent
    pairs* (rank 2r into 2r+1) in pre/post rounds, exactly as the blocking
    allreduce_recursive_doubling, keeping every surviving rank's block
    rank-contiguous — valid for non-commutative ops."""
    size, rank = comm.size, comm.rank
    mine = np.asarray(sendbuf)
    if size == 1:
        return [], dict, _const(mine)
    shape, dtype = mine.shape, mine.dtype
    pof2 = 1
    while pof2 * 2 <= size:
        pof2 *= 2
    rem = size - pof2
    rounds = []

    def as_acc(state, key):
        return state[key].reshape(shape).astype(dtype, copy=False)

    if rank < 2 * rem and rank % 2 == 0:
        # folded-out even rank: contribute, then wait for the result
        rounds.append(Round(sends=(((lambda s: s["acc"]), rank + 1),)))
        rounds.append(Round(recvs=((rank + 1, "fin"),),
                            compute=lambda s: s.__setitem__(
                                "acc", as_acc(s, "fin"))))
    else:
        if rank < 2 * rem:  # odd pre-fold rank: op(d_{rank-1}, d_rank)
            rounds.append(Round(
                recvs=((rank - 1, "r0"),),
                compute=lambda s: s.__setitem__(
                    "acc", np.asarray(op.host(as_acc(s, "r0"), s["acc"])))))
            newrank = rank // 2
        else:
            newrank = rank - rem

        def real_rank(nr: int) -> int:
            return 2 * nr + 1 if nr < rem else nr + rem

        mask = 1
        while mask < pof2:
            partner = real_rank(newrank ^ mask)

            def fold(state, lower=(newrank ^ mask) < newrank,
                     key=f"m{mask}"):
                recv = as_acc(state, key)
                acc = state["acc"]
                state["acc"] = np.asarray(
                    op.host(recv, acc) if lower else op.host(acc, recv))

            rounds.append(Round(sends=(((lambda s: s["acc"]), partner),),
                                recvs=((partner, f"m{mask}"),),
                                compute=fold))
            mask <<= 1
        if rank < 2 * rem:
            rounds.append(Round(sends=(((lambda s: s["acc"]), rank - 1),)))
    return rounds, (lambda: {"acc": mine}), lambda s: s["acc"]


def iallreduce(comm, sendbuf, op: Op) -> NbcRequest:
    _reject_device(sendbuf, "iallreduce")
    rounds, make_state, result = allreduce_schedule(comm, sendbuf, op)
    return _launch(comm, rounds, result, "iallreduce", state=make_state())


def igather(comm, sendbuf, root: int = 0) -> NbcRequest:
    _reject_device(sendbuf, "igather")
    size, rank = comm.size, comm.rank
    mine = np.asarray(sendbuf)
    if size == 1:
        return _launch(comm, [], _const(mine[None]), "igather")
    if rank == root:
        def assemble(state):
            parts = [state[f"p{r}"].reshape(mine.shape).astype(
                mine.dtype, copy=False) if r != root else mine
                for r in range(size)]
            state["out"] = np.stack(parts)

        rounds = [Round(recvs=tuple((r, f"p{r}") for r in range(size)
                                    if r != root),
                        compute=assemble)]
        return _launch(comm, rounds, lambda s: s["out"], "igather")
    rounds = [Round(sends=((_const(mine), root),))]
    return _launch(comm, rounds, _const(None), "igather")


def iscatter(comm, sendbuf, root: int = 0) -> NbcRequest:
    _reject_device(sendbuf, "iscatter")
    size, rank = comm.size, comm.rank
    if size == 1:
        return _launch(comm, [], _const(np.asarray(sendbuf)), "iscatter")
    if rank == root:
        arr = np.asarray(sendbuf)
        if arr.shape[0] % size:
            raise MPIException(
                f"iscatter: axis 0 ({arr.shape[0]}) not divisible by {size}")
        parts = np.split(arr, size, axis=0)
        rounds = [Round(sends=tuple((_const(parts[r]), r)
                                    for r in range(size) if r != root))]
        return _launch(comm, rounds, _const(parts[root]), "iscatter")
    rounds = [Round(recvs=((root, "p"),))]
    return _launch(comm, rounds, lambda s: s["p"], "iscatter")


def allgather_schedule(comm, sendbuf):
    """Ring: p-1 rounds of neighbor sendrecv."""
    size, rank = comm.size, comm.rank
    mine = np.asarray(sendbuf)
    if size == 1:
        return [], dict, _const(mine[None])
    right = (rank + 1) % size
    left = (rank - 1) % size
    rounds = []
    send_idx = rank
    for _ in range(size - 1):
        recv_idx = (send_idx - 1) % size

        def store(state, recv_idx=recv_idx):
            state[f"b{recv_idx}"] = state.pop("_r").reshape(
                mine.shape).astype(mine.dtype, copy=False)

        rounds.append(Round(
            sends=(((lambda s, i=send_idx: s[f"b{i}"]), right),),
            recvs=((left, "_r"),),
            compute=store))
        send_idx = recv_idx

    def result(state):
        return np.stack([state[f"b{r}"] for r in range(size)])

    return rounds, (lambda: {f"b{rank}": mine}), result


def iallgather(comm, sendbuf) -> NbcRequest:
    _reject_device(sendbuf, "iallgather")
    rounds, make_state, result = allgather_schedule(comm, sendbuf)
    return _launch(comm, rounds, result, "iallgather", state=make_state())


def ialltoall(comm, sendbuf) -> NbcRequest:
    """Pairwise: p-1 rounds."""
    _reject_device(sendbuf, "ialltoall")
    size, rank = comm.size, comm.rank
    arr = np.asarray(sendbuf)
    if arr.shape[0] % size:
        raise MPIException(
            f"ialltoall: axis 0 ({arr.shape[0]}) not divisible by {size}")
    if size == 1:
        return _launch(comm, [], _const(arr), "ialltoall")
    parts = np.split(arr, size, axis=0)
    rounds = []
    for step in range(1, size):
        to = (rank + step) % size
        frm = (rank - step) % size

        def store(state, frm=frm):
            state[f"b{frm}"] = state.pop("_r").reshape(
                parts[0].shape).astype(arr.dtype, copy=False)

        rounds.append(Round(sends=((_const(parts[to]), to),),
                            recvs=((frm, "_r"),), compute=store))

    def result(state):
        return np.concatenate([state[f"b{r}"] for r in range(size)])

    return _launch(comm, rounds, result, "ialltoall",
                   state={f"b{rank}": parts[rank]})


def ireduce_scatter(comm, sendbuf, op: Op) -> NbcRequest:
    """Ring reduce-scatter: p-1 rounds (commutative; non-commutative ops
    fall back to reduce+scatter rounds)."""
    _reject_device(sendbuf, "ireduce_scatter")
    size, rank = comm.size, comm.rank
    arr = np.asarray(sendbuf)
    if size == 1:
        return _launch(comm, [], _const(arr), "ireduce_scatter")
    if not op.commutative:
        # rank order must be preserved (the ring below folds out of order):
        # one schedule = binomial-reduce rounds + a scatter round
        rounds, make_state = _reduce_rounds(comm, arr, op, 0)
        if rank == 0:
            def part(s, r):
                return np.array_split(s["acc"].reshape(-1), size)[r]

            rounds.append(Round(sends=tuple(
                ((lambda s, r=r: part(s, r)), r) for r in range(1, size))))
            return _launch(comm, rounds, lambda s: part(s, 0),
                           "ireduce_scatter", state=make_state())
        rounds.append(Round(recvs=((0, "p"),)))
        return _launch(comm, rounds, lambda s: s["p"], "ireduce_scatter",
                       state=make_state())
    flat = arr.reshape(-1)
    chunks = [c.copy() for c in np.array_split(flat, size)]
    right = (rank + 1) % size
    left = (rank - 1) % size
    rounds = []
    send_idx = (rank - 1) % size
    for _ in range(size - 1):
        recv_idx = (send_idx - 1) % size

        def fold(state, recv_idx=recv_idx):
            cur = state[f"c{recv_idx}"]
            recv = state.pop("_r").astype(cur.dtype, copy=False)
            state[f"c{recv_idx}"] = np.asarray(op.host(cur, recv))

        rounds.append(Round(
            sends=(((lambda s, i=send_idx: s[f"c{i}"]), right),),
            recvs=((left, "_r"),), compute=fold))
        send_idx = recv_idx
    return _launch(comm, rounds, lambda s: s[f"c{rank}"], "ireduce_scatter",
                   state={f"c{i}": c for i, c in enumerate(chunks)})


def _chain_scan(comm, sendbuf, op: Op, exclusive: bool,
                kind: str) -> NbcRequest:
    _reject_device(sendbuf, kind)
    rank, size = comm.rank, comm.size
    mine = np.asarray(sendbuf)
    rounds = []
    if rank > 0:
        rounds.append(Round(recvs=((rank - 1, "prev"),)))
    if rank < size - 1:
        def fwd(state):
            prev = state.get("prev")
            if prev is None:
                return mine
            prev = prev.reshape(mine.shape).astype(mine.dtype, copy=False)
            return np.asarray(op.host(prev, mine))

        rounds.append(Round(sends=((fwd, rank + 1),)))

    def result(state):
        prev = state.get("prev")
        if prev is not None:
            prev = prev.reshape(mine.shape).astype(mine.dtype, copy=False)
        if exclusive:
            return prev  # None on rank 0 (undefined per MPI)
        return mine if prev is None else np.asarray(op.host(prev, mine))

    return _launch(comm, rounds, result, kind)


def iscan(comm, sendbuf, op: Op) -> NbcRequest:
    return _chain_scan(comm, sendbuf, op, exclusive=False, kind="iscan")


def iexscan(comm, sendbuf, op: Op) -> NbcRequest:
    return _chain_scan(comm, sendbuf, op, exclusive=True, kind="iexscan")


def iallgatherv(comm, sendbuf) -> NbcRequest:
    """Linear: everyone sends to everyone (variable block sizes)."""
    _reject_device(sendbuf, "iallgatherv")
    size, rank = comm.size, comm.rank
    mine = np.asarray(sendbuf)
    if size == 1:
        return _launch(comm, [], _const([mine]), "iallgatherv")
    rounds = [Round(
        sends=tuple((_const(mine), r) for r in range(size) if r != rank),
        recvs=tuple((r, f"b{r}") for r in range(size) if r != rank))]

    def result(state):
        return [state[f"b{r}"] if r != rank else mine for r in range(size)]

    return _launch(comm, rounds, result, "iallgatherv")


def igatherv(comm, sendbuf, root: int = 0) -> NbcRequest:
    """Linear, variable block shapes: root collects one array per rank."""
    _reject_device(sendbuf, "igatherv")
    size, rank = comm.size, comm.rank
    mine = np.asarray(sendbuf)
    if size == 1:
        return _launch(comm, [], _const([mine]), "igatherv")
    if rank == root:
        def result(state):
            return [state[f"p{r}"] if r != root else mine
                    for r in range(size)]

        rounds = [Round(recvs=tuple((r, f"p{r}") for r in range(size)
                                    if r != root))]
        return _launch(comm, rounds, result, "igatherv")
    return _launch(comm, [Round(sends=((_const(mine), root),))],
                   _const(None), "igatherv")


def iscatterv(comm, sendparts, root: int = 0) -> NbcRequest:
    """Linear, variable block shapes: root sends sendparts[r] to rank r."""
    size, rank = comm.size, comm.rank
    if rank == root or size == 1:
        _reject_device_parts(sendparts, "iscatterv")
    if size == 1:
        return _launch(comm, [], _const(np.asarray(sendparts[0])),
                       "iscatterv")
    if rank == root:
        if len(sendparts) != size:
            raise MPIException(
                f"iscatterv: {len(sendparts)} blocks for {size} ranks")
        rounds = [Round(sends=tuple(
            (_const(np.asarray(sendparts[r])), r)
            for r in range(size) if r != root))]
        return _launch(comm, rounds, _const(np.asarray(sendparts[root])),
                       "iscatterv")
    return _launch(comm, [Round(recvs=((root, "p"),))], lambda s: s["p"],
                   "iscatterv")


def ireduce_scatter_block(comm, sendbuf, op: Op) -> NbcRequest:
    """Reduce then scatter equal blocks: ireduce to 0 + iscatter rounds
    chained (the libnbc composition for the _block variant)."""
    _reject_device(sendbuf, "ireduce_scatter_block")
    size, rank = comm.size, comm.rank
    mine = np.asarray(sendbuf)
    if mine.shape[0] % size:
        raise MPIException(
            f"ireduce_scatter_block: axis 0 ({mine.shape[0]}) not "
            f"divisible by {size}")
    if size == 1:
        return _launch(comm, [], _const(mine), "ireduce_scatter_block")
    # stage 1: everyone sends their r-th block to rank r; stage 2 is local
    blocks = np.split(mine, size, axis=0)
    rounds = [Round(
        sends=tuple((_const(blocks[r]), r) for r in range(size)
                    if r != rank),
        recvs=tuple((r, f"b{r}") for r in range(size) if r != rank))]

    def result(state):
        # fold in RANK order — required for non-commutative ops (same
        # contract as ireduce_scatter's non-commutative branch)
        acc = None
        for r in range(size):
            b = blocks[rank] if r == rank else state[f"b{r}"]
            b = np.asarray(b).reshape(blocks[rank].shape).astype(
                blocks[rank].dtype, copy=False)
            acc = b if acc is None else op.host(acc, b)
        return acc

    return _launch(comm, rounds, result, "ireduce_scatter_block")


def ialltoallw(comm, sendspecs, recvspecs) -> NbcRequest:
    """Nonblocking Alltoallw: packed per-peer blocks exchanged in one
    linear round; receive datatypes unpack into the caller's buffers at
    completion."""
    from ompi_tpu_torch.mpi.coll.base import pack_spec, unpack_spec

    for specs in (sendspecs, recvspecs):
        _reject_device_parts(
            [None if s is None else s[0] for s in specs], "ialltoallw")
    size, rank = comm.size, comm.rank
    if len(sendspecs) != size or len(recvspecs) != size:
        raise MPIException(
            f"ialltoallw: {len(sendspecs)}/{len(recvspecs)} specs for "
            f"{size} ranks")
    if size == 1:
        unpack_spec(recvspecs[0], pack_spec(sendspecs[0]))
        return _launch(comm, [], _const(None), "ialltoallw")
    rounds = [Round(
        sends=tuple((_const(pack_spec(sendspecs[r])), r)
                    for r in range(size) if r != rank),
        recvs=tuple((r, f"b{r}") for r in range(size) if r != rank))]

    def result(state):
        unpack_spec(recvspecs[rank], pack_spec(sendspecs[rank]))
        for r in range(size):
            if r != rank:
                unpack_spec(recvspecs[r], state[f"b{r}"])
        return None

    return _launch(comm, rounds, result, "ialltoallw")


def ialltoallv(comm, sendparts) -> NbcRequest:
    _reject_device_parts(sendparts, "ialltoallv")
    size, rank = comm.size, comm.rank
    if len(sendparts) != size:
        raise MPIException(
            f"ialltoallv: {len(sendparts)} blocks for {size} ranks")
    mine = np.asarray(sendparts[rank])
    if size == 1:
        return _launch(comm, [], _const([mine]), "ialltoallv")
    rounds = [Round(
        sends=tuple((_const(np.asarray(sendparts[r])), r)
                    for r in range(size) if r != rank),
        recvs=tuple((r, f"b{r}") for r in range(size) if r != rank))]

    def result(state):
        return [state[f"b{r}"] if r != rank else mine for r in range(size)]

    return _launch(comm, rounds, result, "ialltoallv")
