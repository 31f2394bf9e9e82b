"""coll/persistent — bind-once persistent collectives (MPI-4 ``*_init``;
the port's copy of the JAX package's ``mpi/coll/persistent.py``).

≈ MPI_Barrier_init / MPI_Allreduce_init & friends (MPI-4.0 §6.12) and
the MPI Advance persistent-collective work (PAPERS.md): a serving or
training step issues the identical collective sequence millions of
times, yet the one-shot path re-pays the whole dispatch stack on every
call — buffer classification, provider routing, the rules-file /
config-var decision walk, arena descriptor rounds, hierarchy lookups,
nbc schedule construction.  ``*_init`` compiles all of that ONCE into
a frozen plan; ``Start`` is a near-pure publish against pre-pinned
state.

What a bind freezes, by provider:

- ``shm``   — flat one-host communicators: a dedicated
  :class:`~ompi_tpu_torch.mpi.coll.shm.PersistentSlots` segment is
  mapped collectively and pinned for the plan's lifetime — parity-indexed
  (op-sequence mod 2) double-buffered slot sets, so op k+1's publish
  overlaps op k's drain (a rank that finished waiting may immediately
  Start the next op while slower ranks still read the other parity;
  slot reuse is guarded by the depart counters two ops back, never a
  per-op barrier).  All slot numpy views are prebuilt at bind; Start
  is guard-check + ``np.copyto`` + one aligned counter store.
- ``hier``  — mixed-host communicators: the node/leader splits, block
  tables, and the inter-node host algorithm (+ its segment sizes) are
  resolved at bind; the drain runs the frozen composition.
- ``host``  — an explicit ``coll_host_*_algorithm`` /rules-file
  directive outranks the shortcut exactly like the one-shot ladder:
  the named algorithm is frozen (``HostColl.freeze_decision``) and
  runs blocking in the drain.
- ``nbc``   — the p2p ground case: the libnbc-style round schedule is
  pre-materialised at bind (``nbc.*_schedule``); Start launches it
  with a fresh state dict, posting round 0 immediately.
- ``topo``  — the neighbor exchanges over the comm's topology: the
  per-edge slots and tags (``topo._edge_meta``) are frozen at bind.
- ``self``  — size-1: Start completes instantly.

Progress model: Start publishes; the remaining work runs on the first
wait()er's thread (the framework's weak-progress model, same as the
nbc schedules).  The flat-arena provider is wait-order-safe across
plans (all cross-rank prerequisites are published at Start); the
hier/host providers run blocking phases in the drain, so outstanding
multi-phase plans must be waited in the same order on every rank.

``Comm.free()`` releases the pinned slots and poisons every bound plan;
:meth:`PersistentCollRequest.rebind` recompiles one collectively.  Host
buffers only: a torch tensor (on any device) given to a ``*_init`` is
refused with the PML's message before anything is bound or copied.

The trace plane's sites are the JAX package's: the
``coll_persistent_{binds,starts,rebinds}_total`` counters, the
``persistent_bind:<kind>`` span, the ``decision:shm_allreduce`` instant,
the ``coll_pstart_ns`` and ``coll_ppublish_ns`` histograms, and the
flight recorder's ``p<kind>`` post and done/err for every Start with
its ``pub`` and ``fold`` phase records.

Left out: fault tolerance (ROADMAP.md Queue 1 item 6.10: the Start
gate's revocation and dead-member checks, and the auto-rebind after a
member is revived).
Every bind still runs the incarnation agreement (``_agree_incs``) on
the all-zero snapshot, so a bind's collective sequence — and the cids
and tags after it — stays in step with the JAX package's, and item
6.10 can plug ``member_incs`` in.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Any, Callable, Optional

import numpy as np

from ompi_tpu_torch.core.config import var_registry
from ompi_tpu_torch.mpi import trace as trace_mod
from ompi_tpu_torch.mpi.constants import MPIException
from ompi_tpu_torch.mpi.pml import _reject_device, _reject_device_parts
from ompi_tpu_torch.mpi.request import (
    CompletedRequest, PersistentRequest, Request,
)

__all__ = ["PersistentCollRequest", "barrier_init", "bcast_init",
           "reduce_init", "allreduce_init", "allgather_init",
           "alltoall_init", "alltoallv_init", "reduce_scatter_init",
           "neighbor_alltoall_init", "neighbor_alltoallv_init"]

# persistent plans draw tags from their own reserved window starting at
# 10000 — far above the blocking-collective tags (1-16), the nbc
# sequence window [64, 500), the OSC 500s, and the neighbor-collective
# 700-891 block.  A plan HOLDS its tag for its whole lifetime, so the
# allocator NEVER wraps (a reused tag would cross-match a still-live
# plan's rounds); the window ends where the partitioned wire-tag space
# begins, and exhausting it raises instead of wrapping.
_PCOLL_TAG_BASE = 10_000
_PCOLL_TAG_MAX = 900_000


def _next_ptag(comm) -> int:
    with comm._lock:
        seq = comm._pcoll_seq = comm._pcoll_seq + 1
    if seq > _PCOLL_TAG_MAX - _PCOLL_TAG_BASE:
        raise MPIException(
            f"persistent-collective tag window exhausted on {comm.name} "
            f"({_PCOLL_TAG_MAX - _PCOLL_TAG_BASE} binds per "
            f"communicator)")
    return _PCOLL_TAG_BASE + seq


# ---------------------------------------------------------------------------
# the bind's incarnation agreement
# ---------------------------------------------------------------------------

def _member_incs(comm) -> tuple:
    """Per-member incarnation snapshot: empty (≡ all zeros) until fault
    tolerance (ROADMAP.md Queue 1 item 6.10) can revive a member."""
    return ()


def _agree_incs(comm, incs: tuple) -> tuple:
    """Element-wise MAX of the per-member incarnation snapshot over the
    communicator — run once per (re)bind, which is collective anyway.
    The AGREED snapshot is what a Start's staleness gate compares
    against (with item 6.10).  Rides the base p2p plane, as the JAX
    package's does, so the bind's collective sequence stays in step
    with it."""
    if comm.size <= 1:
        return incs
    from ompi_tpu_torch.mpi import op as op_mod
    from ompi_tpu_torch.mpi.coll import base

    local = np.array(incs if incs else [0] * comm.size, np.int64)
    agreed = np.asarray(base.allreduce_recursive_doubling(
        comm, local, op_mod.MAX), np.int64)
    if not incs and not agreed.any():
        return ()        # keep the cheap empty form at job start
    return tuple(int(x) for x in agreed)


def _land(recvbuf: Optional[np.ndarray], out: Any) -> Any:
    """Copy a drain result into the bound receive buffer (when one was
    bound) — the mpi4py-style buffer contract for non-root bcast."""
    if recvbuf is None:
        return out
    arr = np.asarray(out)
    flat = recvbuf.reshape(-1)
    if arr.size != flat.size:
        raise MPIException(
            f"persistent bcast: bound recvbuf has {flat.size} elements, "
            f"payload has {arr.size}")
    flat[...] = arr.reshape(-1).astype(flat.dtype, copy=False)
    return recvbuf


# ---------------------------------------------------------------------------
# the split-phase inner request
# ---------------------------------------------------------------------------

class _LazyRequest(Request):
    """The drain half of a split-phase persistent op: ``run()`` executes
    exactly once, on the first wait()er's thread (the framework's weak
    -progress model, like NbcRequest).  ``poll()`` is an optional
    non-blocking readiness check so test() can complete the op without
    blocking once the publishes it depends on have landed."""

    def __init__(self, run: Callable[[], Any],
                 poll: Optional[Callable[[], bool]] = None,
                 kind: str = "pcoll") -> None:
        super().__init__(kind=kind)
        self._run = run
        self._poll = poll
        self._run_lock = threading.Lock()

    def _execute(self) -> None:
        with self._run_lock:
            if self._flag:
                return
            try:
                out = self._run()
            except BaseException as e:  # noqa: BLE001 — fail the request
                self.fail(e)
                return
            self.complete(out)

    def wait(self, timeout: Optional[float] = None) -> Any:
        if not self._flag:
            self._execute()
        return super().wait(timeout=timeout)

    def test(self) -> bool:
        if self._flag:
            return True
        if self._poll is not None and self._poll():
            self._execute()
        return self._flag


# ---------------------------------------------------------------------------
# providers (one frozen plan each)
# ---------------------------------------------------------------------------

class _SelfPlan:
    provider = "self"

    def __init__(self, result_fn: Callable[[], Any]) -> None:
        self._result = result_fn

    def start_op(self) -> Request:
        return CompletedRequest(self._result(), kind="pcoll-self")

    def close(self) -> None:
        pass


class _NbcPlan:
    """Pre-materialised round schedule: the rounds (and every closure
    in them) were built once at bind; Start instantiates an NbcRequest
    with a fresh state dict — round 0 posts immediately (the publish),
    later rounds advance in test()/wait()."""

    provider = "nbc"

    def __init__(self, comm, kind: str, schedule, tag: int,
                 recvbuf: Optional[np.ndarray] = None) -> None:
        from ompi_tpu_torch.mpi.coll import nbc as nbc_mod

        self._nbc = nbc_mod
        self._comm = comm
        self._kind = kind
        self._rounds, self._make_state, result = schedule
        if recvbuf is not None:
            self._result = (lambda s, _r=result: _land(recvbuf, _r(s)))
        else:
            self._result = result
        self._tag = tag

    def start_op(self) -> Request:
        return self._nbc.NbcRequest(
            self._comm, self._rounds, self._result, self._tag,
            kind=f"p{self._kind}", state=self._make_state())

    def close(self) -> None:
        pass


class _DrainPlan:
    """host/hier providers: Start is the FT gate + sequencing only; the
    frozen composition runs blocking in the drain (weak progress)."""

    def __init__(self, provider: str, run: Callable[[], Any],
                 kind: str) -> None:
        self.provider = provider
        self._run = run
        self._kind = kind

    def start_op(self) -> Request:
        return _LazyRequest(self._run, kind=f"p{self._kind}")

    def close(self) -> None:
        pass


class _ArenaPlan:
    """Flat one-host plan over a pinned PersistentSlots segment.

    Counter protocol (all inherited Arena waits — monotonic u64,
    FT-checked, dead-writer-probed): ``arrive[r]`` counts ops rank r
    has published, ``depart[r]`` counts ops consumed (for the fold
    rank: folded).  Op k uses parity q = k mod 2; reuse of a parity-q
    slot by op k is guarded by the departs of op k-2 — the
    double-buffer overlap window.

    Allreduce binds one of two fold strategies (the
    ``decide_allreduce_algo`` ladder):

    - ``root_fold`` — rank 0 folds every slot (arrive +1/op);
    - ``segment_parallel`` — every rank reduce-scatters its 1/p element
      segment across ALL slots into the result slot, then allgathers by
      reading the whole result (the PiP/multi-process-per-GPU
      cooperative shape: O(n) fold work per rank, no single-rank
      bottleneck).  The arrive counter advances by TWO per op — 2k+1 =
      "op k published", 2k+2 = "op k's segment folded" — and the
      publish guard waits ALL departs of op k-2 (every rank reads every
      input slot and the whole result slot).  NOTE: a rank's completion
      needs every OTHER rank's fold (which runs on their wait), so
      outstanding segment-parallel plans must be waited in the same
      order on every rank — the hier/host providers' existing rule, not
      the root-fold arena's anything-order.
    """

    provider = "shm"

    def __init__(self, comm, kind: str, slots, buf, op, root: int,
                 shape, dtype, recvbuf: Optional[np.ndarray] = None,
                 algorithm: Optional[str] = None) -> None:
        from ompi_tpu_torch.mpi.coll import shm as shm_mod

        self._shm = shm_mod
        self._comm = comm
        self._kind = kind
        self._slots = slots
        self._buf = buf
        self._op = op
        self._root = root
        self._shape = tuple(shape)
        self._dtype = np.dtype(dtype)
        self._n = int(np.prod(self._shape)) if self._shape else 1
        self._recvbuf = recvbuf
        self._k = 0
        self.algorithm = algorithm
        self._segpar = algorithm == "segment_parallel"
        p = comm.size
        # prebuilt slot views AND native offsets — the per-op
        # np.frombuffer / address arithmetic of the one-shot arena,
        # paid once here
        if kind in ("reduce", "allreduce", "allgather"):
            self._in = [[np.frombuffer(slots.pslot(q, r), self._dtype,
                                       self._n) for r in range(p)]
                        for q in (0, 1)]
            self._in_off = [[slots.pslot_off(q, r) for r in range(p)]
                            for q in (0, 1)]
        if kind in ("allreduce", "bcast"):
            ridx = p if kind == "allreduce" else 0
            self._res = [np.frombuffer(slots.pslot(q, ridx), self._dtype,
                                       self._n) for q in (0, 1)]
            self._res_off = [slots.pslot_off(q, ridx) for q in (0, 1)]
        # my reduce-scatter segment (element bounds, segment_parallel)
        self._seg_lo = comm.rank * self._n // p
        self._seg_hi = (comm.rank + 1) * self._n // p
        # native fold eligibility, frozen at bind (the executor handle
        # itself is re-resolved per call: benches flip coll_shm_native
        # mid-world for shared-fate comparisons)
        dc = shm_mod._fold_code(self._dtype)
        oc = shm_mod._NATIVE_OP_CODES.get(op) if op is not None else None
        self._fold_codes = ((dc, oc) if dc is not None and oc is not None
                            else None)

    def _fold_exec(self):
        """The native executor when this plan's fold can ride it."""
        s = self._slots
        if (self._fold_codes is None or s is None
                or s._base_addr is None
                or self._n * self._dtype.itemsize
                < self._shm._NATIVE_PUBLISH_MIN):
            return None
        return self._shm._exec()

    # -- plumbing ----------------------------------------------------------

    def _as_bound(self) -> np.ndarray:
        """Re-read the bound buffer (the persistent contract) and hold
        it to the frozen signature — the slot views were compiled for
        exactly this shape/dtype."""
        arr = np.asarray(self._buf)
        if arr.shape != self._shape or arr.dtype != self._dtype:
            raise MPIException(
                f"persistent {self._kind}: bound buffer changed to "
                f"{arr.dtype}{list(arr.shape)} since bind "
                f"({self._dtype}{list(self._shape)}); free() and "
                f"re-init")
        return arr

    def close(self) -> None:
        slots, self._slots = self._slots, None
        # drop the numpy views before detaching the mapping they pin
        self._in = self._res = None
        if slots is not None:
            slots.close()

    def _all_arrived(self, k: int) -> bool:
        s = self._slots
        return all(s.arrive_at(r) >= k + 1 for r in range(s.size))

    # -- Start: the publish half -------------------------------------------

    def start_op(self) -> Request:
        if self._slots is None:
            raise MPIException(
                f"Start on a closed persistent {self._kind} plan")
        k = self._k
        self._k += 1
        q = k & 1
        comm, s, kind = self._comm, self._slots, self._kind
        if kind == "barrier":
            s._set_arrive(k + 1)
            return _LazyRequest(lambda: self._drain_barrier(k),
                                poll=lambda: self._all_arrived(k),
                                kind="pbarrier")
        if kind == "bcast":
            if comm.rank == self._root:
                arr = self._as_bound()
                if k >= 2:         # readers done with this parity's
                    s._wait_all_depart(k - 1, comm)   # k-2 occupant
                _h_t0 = (time.monotonic_ns()
                         if trace_mod.hist_active else 0)
                if not s._publish_arrive(self._res_off[q], arr, k + 1):
                    np.copyto(self._res[q].reshape(self._shape), arr,
                              casting="no")
                    s._set_arrive(k + 1)
                s._set_depart(k + 1)
                if _h_t0:
                    # publish half of the straggler split: slot copy +
                    # flag store, no waits (those land in
                    # coll_arena_wait_ns)
                    trace_mod.record_hist(
                        "coll_ppublish_ns",
                        time.monotonic_ns() - _h_t0)
                trace_mod.coll_event(comm.pml.rank, comm.cid, "pub",
                                     {"k": k})
                return CompletedRequest(arr, kind="pbcast")
            return _LazyRequest(
                lambda: self._drain_bcast(k),
                poll=lambda: s.arrive_at(self._root) >= k + 1,
                kind="pbcast")
        # data publishers: reduce / allreduce / allgather
        arr = self._as_bound()
        segpar = kind == "allreduce" and self._segpar
        if kind == "allgather" or segpar:
            if k >= 2:   # every rank reads every slot (segment_parallel
                # additionally reads the whole result): all departs
                s._wait_all_depart(k - 1, comm)
        else:
            fold = 0 if kind == "allreduce" else self._root
            if k >= 2:
                s._wait_depart(fold, k - 1, comm)
        _h_t0 = time.monotonic_ns() if trace_mod.hist_active else 0
        arrive = 2 * k + 1 if segpar else k + 1
        if not s._publish_arrive(self._in_off[q][comm.rank], arr,
                                 arrive):
            np.copyto(self._in[q][comm.rank].reshape(self._shape), arr,
                      casting="no")
            s._set_arrive(arrive)
        if _h_t0:
            trace_mod.record_hist("coll_ppublish_ns",
                                  time.monotonic_ns() - _h_t0)
        trace_mod.coll_event(comm.pml.rank, comm.cid, "pub", {"k": k})
        if kind == "reduce":
            if comm.rank != self._root:
                # contribution is in the slot: locally complete (the
                # publish guard two ops out is the only backpressure)
                return CompletedRequest(None, kind="preduce")
            return _LazyRequest(lambda: self._drain_reduce(k),
                                poll=lambda: self._all_arrived(k),
                                kind="preduce")
        if kind == "allgather":
            return _LazyRequest(lambda: self._drain_allgather(k),
                                poll=lambda: self._all_arrived(k),
                                kind="pallgather")
        if segpar:
            return _LazyRequest(lambda: self._drain_allreduce_segpar(k),
                                poll=lambda: self._segpar_ready(k),
                                kind="pallreduce")
        if comm.rank == 0:
            return _LazyRequest(lambda: self._drain_allreduce(k),
                                poll=lambda: self._all_arrived(k),
                                kind="pallreduce")
        return _LazyRequest(lambda: self._drain_allreduce(k),
                            poll=lambda: s.depart_at(0) >= k + 1,
                            kind="pallreduce")

    # -- drains ------------------------------------------------------------

    def _drain_barrier(self, k: int) -> None:
        self._slots._wait_all_arrive(k + 1, self._comm)
        return None

    def _drain_bcast(self, k: int):
        q = k & 1
        s, comm = self._slots, self._comm
        s._wait_arrive(self._root, k + 1, comm)
        rb = self._recvbuf
        if rb is not None:
            flat = rb.reshape(-1)
            if not (rb.dtype == self._dtype
                    and s._copy_out_native(self._res_off[q], flat)):
                np.copyto(flat, self._res[q].astype(rb.dtype, copy=False))
            out = rb
        else:
            out = np.empty(self._n, self._dtype)
            if not s._copy_out_native(self._res_off[q], out):
                np.copyto(out, self._res[q])
            out = out.reshape(self._shape)
        s._set_depart(k + 1)
        return out

    def _fold(self, k: int) -> np.ndarray:
        """Rank-ordered fold straight over the parity-q slots — one
        GIL-released native call when the (op, dtype) pair compiled,
        the numpy view chain otherwise (bit-identical either way)."""
        trace_mod.coll_event(self._comm.pml.rank, self._comm.cid,
                             "fold", {"k": k})
        q = k & 1
        ex = self._fold_exec()
        if ex is not None:
            out = np.empty(self._n, self._dtype)
            s = self._slots
            self._shm._native_fold(
                ex, out.ctypes.data,
                [s._base_addr + off for off in self._in_off[q]],
                self._n, *self._fold_codes)
            return out
        views = self._in[q]
        acc = views[0]
        op = self._op
        for r in range(1, self._comm.size):
            acc = op.host(acc, views[r])
        # op.host returned a fresh array (size >= 2 members), so the
        # result does not alias the mapped slots
        return np.asarray(acc, self._dtype)

    def _drain_reduce(self, k: int):
        s, comm = self._slots, self._comm
        s._wait_all_arrive(k + 1, comm)
        out = self._fold(k)
        s._set_depart(k + 1)
        return out.reshape(self._shape)

    def _drain_allreduce(self, k: int):
        q = k & 1
        s, comm = self._slots, self._comm
        if comm.rank == 0:
            s._wait_all_arrive(k + 1, comm)
            if k >= 2:   # readers done with this parity's k-2 result
                s._wait_all_depart(k - 1, comm)
            ex = self._fold_exec()
            if ex is not None:
                # fold straight INTO the mapped result slot (the guard
                # above cleared it), then copy the root's own result out
                self._shm._native_fold(
                    ex, s._base_addr + self._res_off[q],
                    [s._base_addr + off for off in self._in_off[q]],
                    self._n, *self._fold_codes)
                out = np.empty(self._n, self._dtype)
                if not s._copy_out_native(self._res_off[q], out):
                    np.copyto(out, self._res[q])
            else:
                out = self._fold(k)
                np.copyto(self._res[q], out.reshape(-1), casting="no")
            s._set_depart(k + 1)
            return out.reshape(self._shape)
        s._wait_depart(0, k + 1, comm)
        out = np.empty(self._n, self._dtype)
        if not s._copy_out_native(self._res_off[q], out):
            np.copyto(out, self._res[q])
        s._set_depart(k + 1)
        return out.reshape(self._shape)

    # -- segment-parallel allreduce (the cooperative every-rank path) ------

    def _segpar_ready(self, k: int) -> bool:
        """Non-blocking completion poll: every OTHER rank folded its
        segment (arrive 2k+2 — their drains ran), mine is published
        (my own fold runs on this thread inside the drain)."""
        s, me = self._slots, self._comm.rank
        if s.arrive_at(me) < 2 * k + 1:
            return False
        return all(s.arrive_at(r) >= 2 * k + 2
                   for r in range(s.size) if r != me)

    def _drain_allreduce_segpar(self, k: int):
        """Reduce-scatter my 1/p segment across all slots into the
        result slot, then allgather by reading the whole result —
        O(n) fold work per rank instead of the root's O(p·n), viable
        because the concurrent folds and parks run GIL-released."""
        q = k & 1
        s, comm = self._slots, self._comm
        s._wait_all_arrive(2 * k + 1, comm)     # everyone published op k
        lo, hi = self._seg_lo, self._seg_hi
        if hi > lo:
            isz = self._dtype.itemsize
            ex = self._fold_exec()
            if ex is not None:
                self._shm._native_fold(
                    ex, s._base_addr + self._res_off[q] + lo * isz,
                    [s._base_addr + off + lo * isz
                     for off in self._in_off[q]], hi - lo,
                    *self._fold_codes)
            else:
                views = self._in[q]
                acc = views[0][lo:hi]
                op = self._op
                for r in range(1, comm.size):
                    acc = op.host(acc, views[r][lo:hi])
                np.copyto(self._res[q][lo:hi],
                          np.asarray(acc, self._dtype), casting="no")
        s._set_arrive(2 * k + 2)                # my segment is folded
        try:
            s._wait_all_arrive(2 * k + 2, comm)  # every segment is
        except MPIException as e:
            if "coll_shm_timeout" in str(e):
                # the fold we are missing runs inside a PEER's drain:
                # the usual cause is divergent wait order across
                # outstanding segment_parallel plans — name the
                # contract in the failure instead of reading as a hang
                raise MPIException(
                    f"{e} — outstanding segment_parallel allreduce "
                    f"plans must be waited in the same order on every "
                    f"rank (each rank's completion needs every other "
                    f"rank's fold); wait them in one order, or bind "
                    f"root_fold via coll_shm_allreduce_algorithm to "
                    f"restore anything-order waits",
                    error_class=getattr(e, "error_class", 13)
                ) from None
            raise
        out = np.empty(self._n, self._dtype)
        if not s._copy_out_native(self._res_off[q], out):
            np.copyto(out, self._res[q])
        s._set_depart(k + 1)
        return out.reshape(self._shape)

    def _drain_allgather(self, k: int):
        q = k & 1
        s, comm = self._slots, self._comm
        s._wait_all_arrive(k + 1, comm)
        out = np.empty((comm.size,) + self._shape, self._dtype)
        for r in range(comm.size):
            out[r] = self._in[q][r].reshape(self._shape)
        s._set_depart(k + 1)
        return out


# ---------------------------------------------------------------------------
# bind: provider resolution (collective)
# ---------------------------------------------------------------------------

def _arena_dtype_ok(dtype: np.dtype) -> bool:
    from ompi_tpu_torch.mpi.coll import shm as shm_mod

    return shm_mod._arena_dtype_ok(dtype) and shm_mod._desc_dtype_ok(dtype)


def _bcast_meta(comm, buf, root: int):
    """Bind-time signature exchange for bcast: only the root knows the
    payload, so its (nbytes, shape, dtype, arena-eligibility) ride ONE
    base-algorithm bcast here — the per-op descriptor round of the
    one-shot arena path, paid once."""
    from ompi_tpu_torch.mpi.coll import base

    if comm.rank == root:
        arr = np.asarray(buf)
        ok = 1 if _arena_dtype_ok(arr.dtype) else 0
        ints = np.array([arr.nbytes, arr.ndim, ok] + list(arr.shape),
                        np.int64)
        dts = arr.dtype.str.encode()[:32].ljust(32, b"\0")
        payload = np.concatenate([ints.view(np.uint8),
                                  np.frombuffer(dts, np.uint8)])
        base.bcast_binomial(comm, payload, root)
        return arr.shape, arr.dtype, int(arr.nbytes), bool(ok)
    got = np.ascontiguousarray(
        np.asarray(base.bcast_binomial(comm, None, root), np.uint8))
    ints = got[:-32].view(np.int64)
    nbytes, ndim, ok = int(ints[0]), int(ints[1]), int(ints[2])
    shape = tuple(int(x) for x in ints[3:3 + ndim])
    raw = bytes(got[-32:]).rstrip(b"\0").decode()
    try:
        dtype = np.dtype(raw) if raw else np.dtype(np.uint8)
    except TypeError:
        dtype, ok = np.dtype(np.uint8), 0
    return shape, dtype, nbytes, bool(ok)


def _freeze_directive(host, kind: str, comm, nbytes: int) -> Optional[str]:
    """A forced ``coll_host_*_algorithm`` var or rules-file hit — user
    tuning the persistent shortcut must honor, resolved once."""
    if kind not in ("bcast", "allreduce", "allgather",
                    "alltoall", "reduce_scatter"):
        return None
    return host._decide(kind, comm, 0 if kind == "bcast" else nbytes)


def _component(name: str):
    """A registered coll component by name (``host`` or ``shm``)."""
    from ompi_tpu_torch.mpi.coll import coll_framework
    # the imports register the components
    from ompi_tpu_torch.mpi.coll import host as _host  # noqa: F401
    from ompi_tpu_torch.mpi.coll import shm as _shm  # noqa: F401

    return coll_framework.components()[name]


def _shm_state(comm):
    """The shm component's cached dispatch state, or None when the
    component is disabled/unusable or settled on host mode."""
    comp = _component("shm")
    if comp.query(comm=comm) is None:
        return None, comp
    st = comp._state(comm)
    if st is None or getattr(st, "mode", "host") == "host":
        return None, comp
    return st, comp


def _bind(comm, kind: str, buf=None, op=None, root: int = 0,
          recvbuf: Optional[np.ndarray] = None):
    """Compile one frozen plan — collective over ``comm``."""
    from ompi_tpu_torch.mpi.coll import nbc as nbc_mod

    if kind in ("bcast", "reduce") and not 0 <= root < comm.size:
        raise MPIException(
            f"{kind}_init: root {root} out of range for {comm.name} "
            f"(size {comm.size})", error_class=6)

    # size-1: everything degenerates locally (≈ coll/self)
    if comm.size == 1:
        results = {
            "barrier": lambda: None,
            "bcast": lambda: _land(recvbuf, np.asarray(buf)),
            "reduce": lambda: np.asarray(buf),
            "allreduce": lambda: np.asarray(buf),
            "allgather": lambda: np.asarray(buf)[None],
        }
        return _SelfPlan(results[kind])

    # frozen signature (bcast: root's, exchanged once)
    if kind == "bcast":
        shape, dtype, nbytes, dtype_ok = _bcast_meta(comm, buf, root)
        if recvbuf is not None and comm.rank != root:
            if recvbuf.size * recvbuf.dtype.itemsize != nbytes \
                    and dtype_ok:
                raise MPIException(
                    f"bcast_init: bound recvbuf is "
                    f"{recvbuf.size * recvbuf.dtype.itemsize}B, root's "
                    f"payload is {nbytes}B")
    elif kind == "barrier":
        shape, dtype, nbytes, dtype_ok = (), np.dtype(np.uint8), 0, True
    else:
        arr = np.asarray(buf)
        shape, dtype, nbytes = arr.shape, arr.dtype, int(arr.nbytes)
        dtype_ok = _arena_dtype_ok(dtype)

    host = _component("host")
    directive = _freeze_directive(host, kind, comm, nbytes)
    st, comp = _shm_state(comm)
    cap = int(var_registry.get("coll_shm_arena_size") or 0)
    commutative = op is None or op.commutative

    arena_ok = (st is not None and st.mode == "arena"
                and directive is None and dtype_ok and nbytes <= cap)
    if kind in ("reduce", "allreduce"):
        arena_ok = arena_ok and commutative
    if kind == "allgather":
        arena_ok = arena_ok and nbytes * comm.size <= cap

    if arena_ok:
        plan = _bind_arena(comm, kind, buf, op, root, shape, dtype,
                           nbytes, recvbuf)
        if plan is not None:
            return plan
        # mapping failed (MIN-agreed): every rank falls through together

    if st is not None and st.mode == "hier" and directive is None:
        return _bind_hier(comp, st, host, comm, kind, buf, op, root,
                          nbytes, recvbuf)

    if directive is not None:
        fn, label = host.freeze_decision(kind, comm, nbytes, op)
        runs = {
            "bcast": lambda: _land(
                recvbuf if comm.rank != root else None,
                fn(comm, buf if comm.rank == root else None, root)),
            "allreduce": lambda: fn(comm, np.asarray(buf), op),
            "allgather": lambda: fn(comm, np.asarray(buf)),
        }
        return _DrainPlan("host", runs[kind], kind)

    # p2p ground case: pre-materialised nbc rounds
    schedules = {
        "barrier": lambda: nbc_mod.barrier_schedule(comm),
        "bcast": lambda: nbc_mod.bcast_schedule(
            comm, buf if comm.rank == root else None, root),
        "reduce": lambda: nbc_mod.reduce_schedule(comm, buf, op, root),
        "allreduce": lambda: nbc_mod.allreduce_schedule(comm, buf, op),
        "allgather": lambda: nbc_mod.allgather_schedule(comm, buf),
    }
    return _NbcPlan(comm, kind, schedules[kind](), _next_ptag(comm),
                    recvbuf=recvbuf if kind == "bcast"
                    and comm.rank != root else None)


def _bind_arena(comm, kind, buf, op, root, shape, dtype, nbytes,
                recvbuf) -> Optional[_ArenaPlan]:
    from ompi_tpu_torch.mpi.coll import shm as shm_mod

    p = comm.size
    algorithm = None
    if kind == "allreduce":
        # fold strategy frozen at bind: root_fold vs segment_parallel,
        # resolved by the standard ladder (forced var > rules file >
        # payload crossover) — every rank computes the same verdict
        # from globally-agreed inputs
        algorithm, src = shm_mod.decide_allreduce_algo(comm, nbytes)
        if trace_mod.active:
            trace_mod.instant(
                "coll", "decision:shm_allreduce", rank=comm.pml.rank,
                algorithm=algorithm, source=src, nbytes=nbytes,
                size=comm.size)
    nslots = {"barrier": 0, "bcast": 1, "allgather": p,
              "reduce": p + 1, "allreduce": p + 1}[kind]
    slots = shm_mod.make_persistent_slots(comm, nbytes, nslots)
    if slots is None:
        return None
    return _ArenaPlan(comm, kind, slots, buf, op, root, shape, dtype,
                      recvbuf=recvbuf if kind == "bcast"
                      and comm.rank != root else None,
                      algorithm=algorithm)


def _bind_hier(comp, st, host, comm, kind, buf, op, root, nbytes,
               recvbuf) -> _DrainPlan:
    """Freeze the hierarchical composition: node/leader comms and block
    tables come from the cached shm state; the inter-node algorithm is
    resolved by ``HostColl.freeze_decision`` now, not per op."""
    from ompi_tpu_torch.mpi.coll import base

    leader = st.leader
    if kind == "barrier":
        inter = (host.freeze_decision("barrier", leader, 0)[0]
                 if leader is not None else None)

        def run():
            comp._intra_gate_in(st)
            if inter is not None:
                inter(leader)
            comp._intra_gate_out(st)
            return None

        return _DrainPlan("hier", run, kind)

    my_idx = st.node_idx_of[comm.rank]
    if kind == "bcast":
        root_idx = st.node_idx_of[root]
        nroot = (st.node.group.rank_of(comm.world_rank(root))
                 if my_idx == root_idx and st.node.size > 1 else 0)
        inter = (host.freeze_decision("bcast", leader, 0)[0]
                 if leader is not None else None)

        def run():
            data = buf
            if my_idx == root_idx and st.node.size > 1:
                data = comp._intra_bcast(st, data, nroot)
            if inter is not None:
                data = inter(leader,
                             data if my_idx == root_idx else None,
                             root_idx)
            if my_idx != root_idx:
                data = comp._intra_bcast(st, data, 0)
            return _land(recvbuf if comm.rank != root else None,
                         np.asarray(data))

        return _DrainPlan("hier", run, kind)

    if kind == "allreduce":
        inter = (host.freeze_decision("allreduce", leader, nbytes, op)[0]
                 if leader is not None else None)

        def run():
            arr = np.asarray(buf)
            partial = comp._intra_reduce(st, arr, op)
            total = partial
            if inter is not None:
                total = inter(leader, partial, op)
            out = comp._intra_bcast(st, total, 0)
            return np.asarray(out).reshape(arr.shape).astype(
                arr.dtype, copy=False)

        return _DrainPlan("hier", run, kind)

    if kind == "reduce":
        root_idx = st.node_idx_of[root]
        root_leader = st.node_blocks[root_idx][0]
        inter = (host.freeze_decision("reduce", leader, nbytes)[0]
                 if leader is not None else None)

        def run():
            arr = np.asarray(buf)
            partial = comp._intra_reduce(st, arr, op)
            out = None
            if inter is not None:
                out = inter(leader, partial, op, root_idx)
            if root_leader != root:   # root is not its node's leader
                if comm.rank == root_leader:
                    comm._coll_isend(out, root, base.TAG_REDUCE).wait()
                    out = None
                elif comm.rank == root:
                    out = comm._coll_irecv(None, root_leader,
                                           base.TAG_REDUCE).wait()
                    out = out.reshape(arr.shape).astype(arr.dtype,
                                                        copy=False)
            return out if comm.rank == root else None

        return _DrainPlan("hier", run, kind)

    # allgather: node gather → leader allgatherv → reorder → node bcast
    from ompi_tpu_torch.mpi.coll import shm as shm_mod

    node = st.node
    node_blocks = st.node_blocks
    raw_ok = shm_mod._arena_dtype_ok(np.asarray(buf).dtype)

    def run():
        arr = np.asarray(buf)
        if node.size > 1:
            if (st.arena is not None and raw_ok
                    and arr.nbytes <= st.arena.slot_bytes):
                trace_mod.count("coll_shm_fanin_total")
                block = st.arena.allgather(node, arr)
            else:
                block = base.allgather_ring(node, arr)
        else:
            block = arr[None]
        full = None
        if st.leader is not None:
            rows = base.allgatherv_ring(
                st.leader, np.ascontiguousarray(block).reshape(
                    block.shape[0], -1))
            full = np.empty((comm.size, max(arr.size, 0)), arr.dtype)
            for bi, blk in enumerate(rows):
                full[np.asarray(node_blocks[bi])] = np.asarray(
                    blk, arr.dtype).reshape(len(node_blocks[bi]), -1)
        full = comp._intra_bcast(st, full, 0)
        return np.asarray(full, arr.dtype).reshape(
            (comm.size,) + arr.shape)

    return _DrainPlan("hier", run, kind)


def _bind_dense(comm, kind: str, buf=None, op=None):
    """Compile a dense-exchange plan (alltoall / alltoallv /
    reduce_scatter) — collective over ``comm``.

    Dense kinds carry p× the payload of a fan-in collective, so they
    never pin private slots: the shm component's cached ``_state``
    (node/leader splits, arena mapping, reorder tables) IS the
    precompiled schedule, and it is already epoch-fenced.  The bind
    therefore freezes the ROUTE (arena vs hier vs host) plus the
    host-side algorithm pick, and Start is one dispatch against the
    frozen provider."""

    # size-1: ≈ coll/self's dense contracts
    if comm.size == 1:
        results = {
            "alltoall": lambda: np.asarray(buf),
            "alltoallv": lambda: [np.empty(0, np.uint8)
                                  if buf[0] is None
                                  else np.asarray(buf[0])],
            "reduce_scatter": lambda: np.asarray(buf).reshape(-1),
        }
        return _SelfPlan(results[kind])

    if kind == "alltoallv":
        if len(buf) != comm.size:
            raise MPIException(
                f"alltoallv_init: need {comm.size} send parts, got "
                f"{len(buf)}", error_class=2)
        nbytes = sum(int(np.asarray(p).nbytes)
                     for p in buf if p is not None)
    else:
        nbytes = int(np.asarray(buf).nbytes)

    host = _component("host")
    directive = _freeze_directive(host, kind, comm, nbytes)
    st, comp = _shm_state(comm)

    if st is not None and directive is None:
        runs = {
            "alltoall": lambda: comp.coll_alltoall(
                comm, np.asarray(buf)),
            "alltoallv": lambda: comp.coll_alltoallv(comm, list(buf)),
            "reduce_scatter": lambda: comp.coll_reduce_scatter(
                comm, np.asarray(buf), op),
        }
        return _DrainPlan("shm" if st.mode == "arena" else "hier",
                          runs[kind], kind)

    fn, _label = host.freeze_decision(kind, comm, nbytes, op)
    runs = {
        "alltoall": lambda: fn(comm, np.asarray(buf)),
        "alltoallv": lambda: fn(comm, list(buf)),
        "reduce_scatter": lambda: fn(comm, np.asarray(buf), op),
    }
    return _DrainPlan("host", runs[kind], kind)


def _bind_neighbor(comm, kind: str, parts):
    """Compile a persistent neighborhood exchange over the comm's
    attached topology (cart / graph / dist_graph).

    The wire plan — per-edge slot indices and tags, the subtle part of
    the neighbor discipline (parallel-edge pairing on 2-cycle tori) —
    is frozen once from ``topo._edge_meta``; only the bound send parts
    are re-read at each Start.  Topology is immutable state on the
    communicator, so a rebind reproduces the same plan under a fresh
    tag window."""
    from ompi_tpu_torch.mpi import topo as topo_mod

    tag = _next_ptag(comm)
    srcs, send_meta, recvs = topo_mod._edge_meta(comm, len(parts), tag)

    def run():
        rreq_by_i = {i: comm._coll_irecv(None, s, t)
                     for i, s, t in recvs}
        sreqs = [comm._coll_isend(np.asarray(parts[j]), d, t)
                 for j, d, t in send_meta]
        out = [rreq_by_i[i].wait() if i in rreq_by_i else None
               for i in range(len(srcs))]
        for s in sreqs:
            s.wait()
        return out

    return _DrainPlan("topo", run, kind)


# ---------------------------------------------------------------------------
# the public request
# ---------------------------------------------------------------------------

class PersistentCollRequest(PersistentRequest):
    """A bound persistent collective: created inactive by ``*_init``,
    armed by start()/Startall, waited like any persistent request.
    The plan (provider, slots, schedule, decisions) is compiled once
    in the constructor; each start() re-runs only the provider's
    publish."""

    def __init__(self, comm, kind: str,
                 binder: Callable[[], Any]) -> None:
        self._comm = comm
        self._ckind = kind
        self._binder = binder
        self._plan = None
        self._incs: tuple = ()
        # recorder signature of this plan's Starts (kind + world size:
        # a persistent op's shape is frozen at bind, so the signature
        # cannot drift between Starts)
        self._rec_sig = trace_mod.collrec_sig(f"p{kind}", None, comm.size)
        super().__init__(self._launch, kind=f"persistent-{kind}")
        self._compile(first=True)
        comm._persistent_colls.append(weakref.ref(self))

    def _compile(self, first: bool) -> None:
        t0 = trace_mod.begin() if trace_mod.active else 0
        self._plan = self._binder()
        # the staleness snapshot is AGREED across the members (element-
        # wise MAX — one base allreduce on a path that is collective
        # anyway), so every rank's Start reaches the same stale/fresh
        # verdict once item 6.10 can revive a member
        self._incs = _agree_incs(self._comm, _member_incs(self._comm))
        slots = getattr(self._plan, "_slots", None)
        if slots is not None and getattr(slots, "_fence", None) is not None:
            # re-stamp the pinned slots' epoch fence with the agreed
            # snapshot's epoch (sum of agreed incarnations)
            slots._fence = (sum(self._incs), slots._fence[1])
        trace_mod.count("coll_persistent_binds_total")
        if not first:
            trace_mod.count("coll_persistent_rebinds_total")
        if t0:
            trace_mod.complete(
                "coll", f"persistent_bind:{self._ckind}", t0,
                rank=self._comm.pml.rank, cid=self._comm.cid,
                provider=self._plan.provider, rebind=not first)

    @property
    def provider(self) -> Optional[str]:
        """Which layer the plan bound to: shm | hier | host | nbc |
        topo | self (None once freed)."""
        return self._plan.provider if self._plan is not None else None

    @property
    def algorithm(self) -> Optional[str]:
        """The bound fold strategy, where the plan has one (shm
        allreduce: root_fold | segment_parallel)."""
        return getattr(self._plan, "algorithm", None)

    def _launch(self) -> Request:
        plan = self._plan
        if plan is None:
            raise MPIException(
                f"Start on a freed persistent {self._ckind} plan "
                f"(Comm.free() released its pinned slots)")
        comm = self._comm
        trace_mod.count("coll_persistent_starts_total")
        # collective flight recorder: every Start posts under the
        # "p<kind>" name with its own (rank, cid) op_seq; completion of
        # the inner request records done — a wedged Start therefore
        # leaves a post-without-done head the hang doctor reads
        rank = comm.pml.rank
        seq = trace_mod.coll_post(
            rank, comm.cid, f"p{self._ckind}", self._rec_sig,
            plan.provider, 0)
        # Start→completion latency: stamped here, recorded when the
        # inner request completes (CompletedRequest fires the callback
        # inline, so a locally-complete publish still lands a sample)
        _h_t0 = trace_mod.begin() if trace_mod.hist_active else 0
        req = plan.start_op()

        def _rec_close(_r, r=rank, c=comm.cid, s=seq,
                       k=f"p{self._ckind}"):
            # completion callbacks also fire from Request.fail() — a
            # failed Start records err, not done
            exc = getattr(_r, "_exc", None)
            if exc is not None:
                trace_mod.coll_err(r, c, s, k, type(exc).__name__)
            else:
                trace_mod.coll_done(r, c, s, k)

        req.add_completion_callback(_rec_close)
        if _h_t0:
            labels = (f'kind="{self._ckind}",'
                      f'provider="{plan.provider}"')
            req.add_completion_callback(
                lambda _r, t0=_h_t0, lb=labels: trace_mod.record_hist(
                    "coll_pstart_ns", time.monotonic_ns() - t0,
                    labels=lb))
        return req

    def rebind(self) -> "PersistentCollRequest":
        """Recompile the bound plan on the same communicator —
        collective over it, like ``*_init``."""
        if self.active:
            raise MPIException(
                "rebind on an active persistent request (wait it first)")
        old, self._plan = self._plan, None
        self._inner = None
        if old is not None:
            old.close()
        self._compile(first=False)
        return self

    def free(self) -> None:
        """≈ MPI_Request_free: release the pinned slots; later starts
        raise."""
        plan, self._plan = self._plan, None
        if plan is not None:
            plan.close()
        super().free()


# ---------------------------------------------------------------------------
# public constructors (Communicator delegates here)
# ---------------------------------------------------------------------------

def _host_parts(sendparts, what: str) -> list:
    """The bound part list, each part held to the PML's device refusal."""
    parts = list(sendparts)
    _reject_device_parts(parts, what)
    return parts


def barrier_init(comm) -> PersistentCollRequest:
    """≈ MPI_Barrier_init."""
    return PersistentCollRequest(comm, "barrier",
                                 lambda: _bind(comm, "barrier"))


def bcast_init(comm, buf=None, root: int = 0) -> PersistentCollRequest:
    """≈ MPI_Bcast_init: on the root ``buf`` is the (re-read) payload;
    on other ranks an optional landing buffer filled at each wait."""
    _reject_device(buf, "bcast_init")
    rb = None
    if comm.rank != root and isinstance(buf, np.ndarray):
        rb = buf
        if not rb.flags["C_CONTIGUOUS"] or not rb.flags.writeable:
            # a non-contiguous landing buffer would make reshape(-1) a
            # COPY and the drain would silently fill the temporary
            raise MPIException(
                "bcast_init: the landing buffer must be a writable "
                "C-contiguous ndarray (results land in place)")
    return PersistentCollRequest(
        comm, "bcast",
        lambda: _bind(comm, "bcast", buf=buf, root=root, recvbuf=rb))


def reduce_init(comm, sendbuf, op, root: int = 0) -> PersistentCollRequest:
    """≈ MPI_Reduce_init."""
    _reject_device(sendbuf, "reduce_init")
    return PersistentCollRequest(
        comm, "reduce",
        lambda: _bind(comm, "reduce", buf=sendbuf, op=op, root=root))


def allreduce_init(comm, sendbuf, op) -> PersistentCollRequest:
    """≈ MPI_Allreduce_init."""
    _reject_device(sendbuf, "allreduce_init")
    return PersistentCollRequest(
        comm, "allreduce",
        lambda: _bind(comm, "allreduce", buf=sendbuf, op=op))


def allgather_init(comm, sendbuf) -> PersistentCollRequest:
    """≈ MPI_Allgather_init."""
    _reject_device(sendbuf, "allgather_init")
    return PersistentCollRequest(
        comm, "allgather",
        lambda: _bind(comm, "allgather", buf=sendbuf))


def alltoall_init(comm, sendbuf) -> PersistentCollRequest:
    """≈ MPI_Alltoall_init: ``sendbuf`` (re-read at each Start) is the
    row-per-destination dense block, as in the blocking form."""
    _reject_device(sendbuf, "alltoall_init")
    return PersistentCollRequest(
        comm, "alltoall",
        lambda: _bind_dense(comm, "alltoall", buf=sendbuf))


def alltoallv_init(comm, sendparts) -> PersistentCollRequest:
    """≈ MPI_Alltoallv_init: one (possibly None) part per destination;
    the bound list is re-indexed at each Start."""
    parts = _host_parts(sendparts, "alltoallv_init")
    return PersistentCollRequest(
        comm, "alltoallv",
        lambda: _bind_dense(comm, "alltoallv", buf=parts))


def reduce_scatter_init(comm, sendbuf, op) -> PersistentCollRequest:
    """≈ MPI_Reduce_scatter_init (block-free contiguous split, like the
    one-shot form: rank r lands ``np.array_split`` chunk r)."""
    _reject_device(sendbuf, "reduce_scatter_init")
    return PersistentCollRequest(
        comm, "reduce_scatter",
        lambda: _bind_dense(comm, "reduce_scatter", buf=sendbuf, op=op))


def neighbor_alltoall_init(comm, sendparts) -> PersistentCollRequest:
    """≈ MPI_Neighbor_alltoall_init: one block per out-neighbor over
    the comm's cart/graph/dist-graph topology; each wait yields one
    entry per in-neighbor (None on PROC_NULL edges)."""
    parts = _host_parts(sendparts, "neighbor_alltoall_init")
    return PersistentCollRequest(
        comm, "neighbor_alltoall",
        lambda: _bind_neighbor(comm, "neighbor_alltoall", parts))


def neighbor_alltoallv_init(comm, sendparts) -> PersistentCollRequest:
    """≈ MPI_Neighbor_alltoallv_init (the exchange is already
    shape-polymorphic per edge, as in the blocking v-form)."""
    parts = _host_parts(sendparts, "neighbor_alltoallv_init")
    return PersistentCollRequest(
        comm, "neighbor_alltoallv",
        lambda: _bind_neighbor(comm, "neighbor_alltoallv", parts))
