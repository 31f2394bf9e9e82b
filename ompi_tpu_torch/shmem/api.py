"""OpenSHMEM host API (≈ oshmem/shmem/c/: shmem_init, shmem_put,
shmem_long_max_to_all, ...) — the port's copy of the JAX package's
``shmem/api.py``, whole.

The symmetric heap (≈ oshmem/mca/memheap) is a registry of collectively
allocated SymmetricArrays; allocation order is the "symmetric address":
every PE's Nth allocation refers to the same logical object, so a PE can
name remote memory by (array, offset) exactly as SHMEM names it by
symmetric address.  The transport (≈ oshmem/mca/spml) is an RMA window per
allocation; collectives (≈ oshmem/mca/scoll/mpi) delegate to the MPI coll
framework.  Atomics (≈ oshmem/mca/atomic) ride the window's fetch/cswap
service.

As with the port's windows, the origin data of ``put``/``iput`` and of
the atomics may be a torch tensor (a CUDA one reaches the host in one
device-to-host copy, a bf16 one is converted to the array's dtype on its
device first); ``get`` returns numpy and the local data stays numpy.  The
module imports no torch.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np

from ompi_tpu_torch.core.buffer import is_tensor
from ompi_tpu_torch.mpi import op as op_mod
from ompi_tpu_torch.mpi.constants import MPIException
from ompi_tpu_torch.mpi.osc import Window, stage_origin

__all__ = [
    "init", "finalize", "my_pe", "n_pes", "barrier_all", "array", "free",
    "put", "get", "broadcast", "collect", "to_all", "atomic_add",
    "atomic_fetch_add", "atomic_cswap", "fence", "quiet", "SymmetricArray",
    "Lock", "set_lock", "test_lock", "clear_lock",
    "broadcast_active", "collect_active", "to_all_active",
]

_state: dict = {"comm": None, "heap": []}
_lock = threading.Lock()

_CMP = {
    "eq": lambda a, b: a == b,
    "ne": lambda a, b: a != b,
    "gt": lambda a, b: a > b,
    "ge": lambda a, b: a >= b,
    "lt": lambda a, b: a < b,
    "le": lambda a, b: a <= b,
}


def init():
    """shmem_init: brings up MPI underneath (the reference requires the
    same — oshmem layers on ompi)."""
    import ompi_tpu_torch

    with _lock:
        if _state["comm"] is None:
            world = ompi_tpu_torch.init()
            _state["comm"] = world.dup(name="SHMEM")
    return _state["comm"]


def _comm():
    if _state["comm"] is None:
        raise MPIException("shmem not initialized (call shmem.init())")
    return _state["comm"]


def finalize() -> None:
    with _lock:
        comm = _state["comm"]
        if comm is None:
            return
        for arr in list(_state["heap"]):
            if arr is not None:
                arr._win.free()
        _state["heap"].clear()
        _state.pop("lock_slabs", None)
        _state["comm"] = None
    import ompi_tpu_torch

    ompi_tpu_torch.finalize()


def my_pe() -> int:
    return _comm().rank


def n_pes() -> int:
    return _comm().size


def barrier_all() -> None:
    _comm().barrier()


class SymmetricArray:
    """A symmetric-heap allocation: same shape/dtype on every PE.

    ``arr[:]`` is the local data (numpy view); remote access goes through
    put/get/atomics with a target PE.
    """

    def __init__(self, shape, dtype, heap_idx: int) -> None:
        self.local = np.zeros(shape, dtype=dtype)
        self.heap_idx = heap_idx
        self._win = Window(_comm(), buffer=self.local.reshape(-1),
                           name=f"sym{heap_idx}")

    @property
    def shape(self):
        return self.local.shape

    @property
    def dtype(self):
        return self.local.dtype

    def __getitem__(self, idx):
        return self.local[idx]

    def __setitem__(self, idx, value):
        self.local[idx] = value

    # -- one-sided ops (≈ shmem_put/get/atomics) --------------------------

    def _origin(self, data) -> np.ndarray:
        return stage_origin(data, self.dtype).reshape(-1)

    def put(self, target_pe: int, data, offset: int = 0) -> None:
        self._win.put(target_pe, self._origin(data), offset)

    def iput(self, target_pe: int, data, target_stride: int,
             offset: int = 0) -> None:
        """Strided put (≈ shmem_iput): element i lands at
        ``offset + i*target_stride`` — one wire message, one counted op."""
        self._win.put_strided(target_pe, self._origin(data), offset,
                              target_stride)

    def get(self, target_pe: int, count: Optional[int] = None,
            offset: int = 0) -> np.ndarray:
        count = count if count is not None else self.local.size - offset
        return self._win.get(target_pe, count, offset)

    def iget(self, target_pe: int, count: int, source_stride: int,
             offset: int = 0) -> np.ndarray:
        """Strided get (≈ shmem_iget): element i comes from
        ``offset + i*source_stride`` — one covering-range round trip,
        strided locally."""
        if source_stride < 1:
            raise MPIException(f"iget needs stride >= 1, got {source_stride}")
        if count == 0:
            return np.zeros(0, dtype=self.dtype)
        span = (count - 1) * source_stride + 1
        return self._win.get(target_pe, span, offset)[::source_stride].copy()

    def wait_until(self, cmp: str, value, offset: int = 0,
                   timeout: Optional[float] = None) -> None:
        """≈ shmem_wait_until: block until the *local* element at ``offset``
        satisfies ``cmp`` against ``value``.  Remote puts/atomics land via
        the window service, which signals the same condition variable —
        so this is a real sleep, not a spin."""
        pred = _CMP.get(cmp)
        if pred is None:
            raise MPIException(
                f"wait_until cmp must be one of {sorted(_CMP)}, got {cmp!r}")
        win = self._win
        flat = self.local.reshape(-1)
        with win._cv:
            ok = win._cv.wait_for(
                lambda: pred(flat[offset], value) or win._service_dead,
                timeout=timeout)
            if not ok:
                raise TimeoutError(
                    f"wait_until({cmp}, {value}) timed out at offset {offset}")
            if not pred(flat[offset], value):
                raise MPIException(
                    "wait_until: window service stopped before the "
                    "condition held")

    def quiet(self) -> None:
        """≈ shmem_quiet: my outstanding puts to all PEs are complete."""
        for pe in range(n_pes()):
            if pe != my_pe():
                self._win.flush(pe)

    def barrier(self) -> None:
        """Window-level fence (completes all pending ops everywhere)."""
        self._win.fence()


def array(shape, dtype=np.float64) -> SymmetricArray:
    """shmem_malloc: collective allocation on every PE."""
    with _lock:
        idx = len(_state["heap"])
        arr = SymmetricArray(shape, dtype, idx)
        _state["heap"].append(arr)
    return arr


def free(arr: SymmetricArray) -> None:
    """shmem_free (collective)."""
    arr._win.free()
    with _lock:
        _state["heap"][arr.heap_idx] = None


# -- flat-API conveniences (the C-style spelling) ---------------------------

def put(arr: SymmetricArray, target_pe: int, data, offset: int = 0) -> None:
    arr.put(target_pe, data, offset)


def get(arr: SymmetricArray, target_pe: int, count=None, offset: int = 0):
    return arr.get(target_pe, count, offset)


def fence() -> None:
    """shmem_fence: ordering of puts per target — our transport is FIFO per
    pair, so fence is a no-op (documented ordering guarantee)."""


def quiet() -> None:
    """shmem_quiet across the whole heap."""
    for arr in _state["heap"]:
        if arr is not None:
            arr.quiet()


# -- collectives (≈ scoll; delegate to MPI coll like scoll/mpi) -------------

def broadcast(arr: SymmetricArray, root: int = 0) -> None:
    """shmem_broadcast: root's local data replaces everyone's."""
    out = _comm().bcast(arr.local.copy(), root=root)
    arr.local[...] = out.reshape(arr.shape)


def collect(arr: SymmetricArray) -> np.ndarray:
    """shmem_collect / fcollect: concatenation of every PE's data."""
    return _comm().allgather(arr.local).reshape(
        (n_pes() * arr.local.shape[0],) + arr.local.shape[1:])


def to_all(arr: SymmetricArray, op=op_mod.MAX) -> None:
    """shmem_*_to_all reductions (max/min/sum/prod/and/or): elementwise
    reduce across PEs, result replacing every PE's local data."""
    out = _comm().allreduce(arr.local, op=op)
    arr.local[...] = out.reshape(arr.shape)


# -- atomics (≈ oshmem/mca/atomic) ------------------------------------------

def _atom(arr: SymmetricArray, value) -> np.ndarray:
    """One atomic operand as a 1-element array (a tensor staged as a
    put's data is)."""
    return arr._origin(value) if is_tensor(value) else np.asarray([value])


def atomic_add(arr: SymmetricArray, target_pe: int, value,
               offset: int = 0) -> None:
    arr._win.accumulate(target_pe, _atom(arr, value), op_mod.SUM, offset)


def atomic_fetch_add(arr: SymmetricArray, target_pe: int, value,
                     offset: int = 0):
    return arr._win.fetch_op(target_pe, _atom(arr, value), op_mod.SUM,
                             offset)[0]


def atomic_cswap(arr: SymmetricArray, target_pe: int, compare, value,
                 offset: int = 0):
    return arr._win.compare_swap(target_pe, compare, value, offset)[0]


# -- distributed locks (≈ oshmem/shmem/c/shmem_lock.c) ----------------------
#
# The reference implements an MCS-style queue lock over remote atomics; the
# same fairness comes cheaper here as a ticket lock: two symmetric int64
# slots (next-ticket, now-serving) on a home PE.  set_lock draws a ticket
# with fetch_add and sleeps on the serving counter via wait_until on the
# home PE (remote waiters poll with backoff); clear_lock quiets my
# outstanding puts (the OpenSHMEM release guarantee) then advances serving.
#
# Locks share chunked slabs of the symmetric heap (64 locks per slab) so a
# thousand locks cost one window, not a thousand service threads.

_LOCKS_PER_SLAB = 64


def _lock_slot() -> tuple["SymmetricArray", int]:
    with _lock:
        slabs = _state.setdefault("lock_slabs", [])
        if not slabs or slabs[-1][1] >= _LOCKS_PER_SLAB:
            slabs.append([None, 0])   # allocated outside _lock (collective)
            need_alloc = True
        else:
            need_alloc = False
        slab = slabs[-1]
        slot = slab[1]
        slab[1] += 1
    if need_alloc:
        slab[0] = array(2 * _LOCKS_PER_SLAB, dtype=np.int64)
    return slab[0], 2 * slot


class Lock:
    """A symmetric distributed lock (collective constructor: every PE must
    create its locks in the same order, like any heap allocation)."""

    def __init__(self) -> None:
        self._arr, base = _lock_slot()
        self._next = base          # next-ticket slot
        self._serving = base + 1   # now-serving slot
        self._home = (base // 2) % n_pes()

    def set_lock(self) -> None:
        """≈ shmem_set_lock: fair (FIFO by ticket), blocking."""
        ticket = int(atomic_fetch_add(self._arr, self._home, 1,
                                      offset=self._next))
        if self._home == my_pe():
            self._arr.wait_until("ge", ticket, offset=self._serving)
            return
        delay = 1e-4
        while int(self._arr.get(self._home, 1, self._serving)[0]) < ticket:
            time.sleep(delay)
            delay = min(delay * 2, 0.01)

    def test_lock(self) -> bool:
        """≈ shmem_test_lock: one attempt; True ⇒ acquired."""
        serving = int(self._arr.get(self._home, 1, self._serving)[0])
        old = int(atomic_cswap(self._arr, self._home, serving, serving + 1,
                               offset=self._next))
        return old == serving

    def clear_lock(self) -> None:
        """≈ shmem_clear_lock: embeds a quiet — my puts are applied at
        their targets before the next holder can observe the release."""
        quiet()
        atomic_add(self._arr, self._home, 1, offset=self._serving)

    def __enter__(self) -> "Lock":
        self.set_lock()
        return self

    def __exit__(self, *exc) -> None:
        self.clear_lock()


def set_lock(lock: Lock) -> None:
    lock.set_lock()


def test_lock(lock: Lock) -> bool:
    return lock.test_lock()


def clear_lock(lock: Lock) -> None:
    lock.clear_lock()


# -- active-set collectives (PE_start, logPE_stride, PE_size) ---------------
#
# ≈ the reference's scoll active-set signatures (oshmem/mca/scoll/scoll.h):
# only the member PEs call, so these cannot ride MPI communicators (whose
# construction is collective over the parent); they run directly over the
# SHMEM comm's internal p2p on reserved tags, the way scoll/basic runs over
# put+flags.  Linear algorithms: active sets are small by construction.

_TAG_AS_BCAST, _TAG_AS_COLLECT, _TAG_AS_REDUCE = 600, 601, 602


def _active_pes(active_set) -> list[int]:
    start, logstride, size = active_set
    pes = [start + (i << logstride) for i in range(size)]
    if my_pe() not in pes:
        raise MPIException(
            f"PE {my_pe()} called an active-set collective for {pes}")
    if pes[-1] >= n_pes():
        raise MPIException(f"active set {pes} exceeds n_pes {n_pes()}")
    return pes


def _as_sendrecv(tag):
    comm = _comm()
    return (lambda buf, pe: comm._coll_isend(buf, pe, tag),
            lambda pe: comm._coll_irecv(None, pe, tag).wait())


def broadcast_active(arr: SymmetricArray, root_pe: int,
                     active_set) -> None:
    """shmem_broadcast over an active set; root's data replaces members'."""
    pes = _active_pes(active_set)
    if root_pe not in pes:
        raise MPIException(f"root {root_pe} not in active set {pes}")
    send, recv = _as_sendrecv(_TAG_AS_BCAST)
    if my_pe() == root_pe:
        reqs = [send(arr.local.reshape(-1), pe)
                for pe in pes if pe != root_pe]
        for r in reqs:
            r.wait()
    else:
        arr.local[...] = recv(root_pe).reshape(arr.shape)


def collect_active(arr: SymmetricArray, active_set) -> np.ndarray:
    """shmem_collect over an active set: concatenation in PE order."""
    pes = _active_pes(active_set)
    send, recv = _as_sendrecv(_TAG_AS_COLLECT)
    root = pes[0]
    if my_pe() == root:
        parts = {root: arr.local.reshape(-1)}
        for pe in pes[1:]:
            parts[pe] = np.asarray(recv(pe))
        full = np.concatenate([parts[pe] for pe in pes])
        reqs = [send(full, pe) for pe in pes[1:]]
        for r in reqs:
            r.wait()
    else:
        send(arr.local.reshape(-1), root).wait()
        full = np.asarray(recv(root))
    return full.reshape((len(pes) * arr.local.shape[0],)
                        + arr.local.shape[1:])


def to_all_active(arr: SymmetricArray, active_set, op=op_mod.MAX) -> None:
    """shmem_*_to_all over an active set: elementwise reduction, result
    replacing every member's local data."""
    pes = _active_pes(active_set)
    send, recv = _as_sendrecv(_TAG_AS_REDUCE)
    root = pes[0]
    if my_pe() == root:
        acc = arr.local.reshape(-1).copy()
        for pe in pes[1:]:
            acc = op.host(acc, np.asarray(recv(pe)).astype(acc.dtype))
        reqs = [send(acc, pe) for pe in pes[1:]]
        for r in reqs:
            r.wait()
        arr.local[...] = acc.reshape(arr.shape)
    else:
        send(arr.local.reshape(-1), root).wait()
        arr.local[...] = np.asarray(recv(root)).reshape(arr.shape)
