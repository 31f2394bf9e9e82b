"""Requests: completion objects for nonblocking operations (the port's
copy of the JAX package's ``mpi/request.py``, whole).

≈ ompi/request (request.h:124-177): a request completes exactly once;
completion is a plain flag (GIL-atomic reads) plus an Event created lazily
by the first waiter that actually blocks.  Requests that complete before
anyone waits — every inline-delivered send, and recvs matched from the
unexpected queue — never allocate an Event/Condition pair at all, which is
a measurable share of small-message hop latency.  A vader-style pre-block
spin was tried and measured COUNTERPRODUCTIVE here (36→58µs/hop): under
the GIL the waiter's polling steals cycles from the very thread doing the
completing; the reference's opal_progress spin works because its progress
runs in the waiting thread, ours runs in the sender's.  Status carries
(source, tag, count) like MPI_Status.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Optional, Sequence

from ompi_tpu_torch.mpi.constants import MPIException

# Optional bounded GIL-yielding poll before the futex wait; 0 = disabled
# (measured best on GIL builds — see module docstring).  Kept as a knob
# for free-threaded interpreters where the tradeoff flips.
_SPIN_S = 0.0

__all__ = ["Request", "Status", "PersistentRequest", "GeneralizedRequest",
           "grequest_start", "get_elements", "get_count",
           "request_get_status", "wait_all", "wait_any", "wait_some",
           "test_all", "test_any", "test_some", "start_all"]


class Status:
    """≈ MPI_Status: source/tag/error + received element count."""

    def __init__(self) -> None:
        self.source: int = -1
        self.tag: int = -1
        self.error: int = 0
        self.count: int = 0
        # received payload size in BYTES where the PML knows it (None
        # otherwise) — lets unit-converting count queries (mpi4py's
        # Get_count(datatype)) divide by a different item width
        self.count_bytes: Optional[int] = None
        self._cancelled: bool = False
        self._elements: Optional[int] = None  # set_elements override

    def set_cancelled(self, flag: bool) -> None:
        """≈ MPI_Status_set_cancelled (for generalized requests)."""
        self._cancelled = bool(flag)

    def is_cancelled(self) -> bool:
        """≈ MPI_Test_cancelled."""
        return self._cancelled

    def set_elements(self, datatype, count: int) -> None:
        """≈ MPI_Status_set_elements: make a later get_count() report
        ``count`` items of ``datatype`` (generalized-request plumbing);
        Status.count itself stays in basic elements."""
        self._elements = int(count) * datatype.elements_per_item

    def __repr__(self) -> str:
        return (f"Status(source={self.source}, tag={self.tag}, "
                f"count={self.count}, error={self.error})")


def get_elements(status: Status, datatype) -> int:
    """≈ MPI_Get_elements: received count in BASIC elements.  Status.count
    is already kept in basic elements by the PML; a Status.set_elements
    override (generalized requests) takes precedence."""
    if status._elements is not None:
        return status._elements
    return int(status.count)


def request_get_status(request: "Request") -> tuple[bool, Status]:
    """≈ MPI_Request_get_status: (flag, status) WITHOUT completing the
    request — a done persistent request stays active for wait(), a done
    generalized request runs its query_fn but is NOT freed."""
    if isinstance(request, GeneralizedRequest):
        if not request._flag:
            return False, request.status
        if request._query_fn is not None:
            request._query_fn(request.extra_state, request.status)
        return True, request.status
    if isinstance(request, PersistentRequest):
        inner = request._inner
        if inner is None:
            return True, request.status
        return inner._flag, inner.status
    # plain requests: test() is side-effect-free; schedule-driven requests
    # (NbcRequest) NEED it — their rounds only advance inside test()/wait()
    return request.test(), request.status


def get_count(status: Status, datatype) -> int:
    """≈ MPI_Get_count: received count in whole ``datatype`` items, or
    UNDEFINED (-32766) when the byte count isn't a whole number of items
    (MPI semantics for partial trailing items)."""
    elems = get_elements(status, datatype)
    per = datatype.elements_per_item
    if per == 0:
        return 0
    if elems % per:
        return -32766  # MPI_UNDEFINED
    return elems // per


class Request:
    """A completion object. Thread-safe; completes exactly once."""

    def __init__(self, kind: str = "generic") -> None:
        self.kind = kind
        self._flag = False            # GIL-atomic completion flag
        self._event: Optional[threading.Event] = None  # lazy: first blocker
        self._lock = threading.Lock()
        self.status = Status()
        self._result: Any = None
        self._exc: Optional[BaseException] = None
        self._on_complete: list[Callable[["Request"], None]] = []
        self.cancelled = False

    # -- completion (called by the progress side) -------------------------

    def complete(self, result: Any = None) -> None:
        with self._lock:
            if self._flag:
                return
            self._result = result
            self._flag = True
            ev = self._event
            callbacks = list(self._on_complete)
        if ev is not None:
            ev.set()
        for cb in callbacks:
            cb(self)

    def fail(self, exc: BaseException) -> None:
        with self._lock:
            if self._flag:
                return
            self._exc = exc
            self.status.error = getattr(exc, "error_class", 13)
            self._flag = True
            ev = self._event
            callbacks = list(self._on_complete)
        if ev is not None:
            ev.set()
        for cb in callbacks:
            cb(self)

    def add_completion_callback(self, cb: Callable[["Request"], None]) -> None:
        with self._lock:
            if not self._flag:
                self._on_complete.append(cb)
                return
        cb(self)

    # -- user side --------------------------------------------------------

    def done(self) -> bool:
        return self._flag

    def test(self) -> bool:
        """≈ MPI_Test (no progress side effects needed: progress is threaded)."""
        return self._flag

    def wait(self, timeout: Optional[float] = None) -> Any:
        """≈ MPI_Wait: block until complete; return the operation's result
        (received array for recvs, None for sends)."""
        if not self._flag:
            self._block(timeout)
        if self._exc is not None:
            raise self._exc
        return self._result

    def _block(self, timeout: Optional[float]) -> None:
        # no-lost-wakeup invariant: the event is created and re-checked
        # under self._lock — the same lock complete() reads self._event
        # under before setting it
        if _SPIN_S > 0:
            deadline = time.perf_counter() + _SPIN_S
            while time.perf_counter() < deadline:
                if self._flag:
                    return
                time.sleep(0)     # yield the GIL to the completing thread
        with self._lock:
            if self._flag:
                return
            if self._event is None:
                self._event = threading.Event()
            ev = self._event
        if not ev.wait(timeout=timeout):
            raise TimeoutError(f"{self.kind} request did not complete")

    def cancel(self) -> None:
        """≈ MPI_Cancel (only meaningful for unmatched recvs)."""
        self.cancelled = True


class PersistentRequest(Request):
    """≈ MPI persistent communication request (pml.h:502-505 send/recv_init):
    created inactive, (re)armed by start(); wait/test apply to the current
    incarnation and a waited-on request returns to inactive, ready for the
    next start().  The factory re-reads the bound buffer each start, so the
    classic use (fixed buffer, restart every iteration) works unchanged."""

    def __init__(self, factory: Callable[[], Request],
                 kind: str = "persistent") -> None:
        super().__init__(kind=kind)
        self._factory = factory
        self._inner: Optional[Request] = None

    @property
    def active(self) -> bool:
        return self._inner is not None and not self._inner.done()

    def start(self) -> "PersistentRequest":
        if self.active:
            raise MPIException(
                "MPI_Start on an already-active persistent request")
        self._inner = self._factory()
        return self

    # wait/test on an inactive persistent request return immediately (MPI
    # semantics for inactive requests); both deactivate on completion and
    # transfer the inner status/result (MPI_Test must fill status too)

    def wait(self, timeout: Optional[float] = None) -> Any:
        if self._inner is None:
            return self._result
        out = self._inner.wait(timeout=timeout)
        self.status = self._inner.status
        self._result = out
        self._inner = None  # back to inactive
        return out

    def test(self) -> bool:
        if self._inner is None:
            return True
        if not self._inner.test():
            return False
        self.wait()  # completed: non-blocking transfer + deactivate
        return True

    def done(self) -> bool:
        return self.test()

    def add_completion_callback(self, cb: Callable[["Request"], None]) -> None:
        if self._inner is None:
            cb(self)
        else:
            self._inner.add_completion_callback(lambda _r: cb(self))

    def cancel(self) -> None:
        if self._inner is not None:
            self._inner.cancel()
            self.cancelled = self._inner.cancelled

    def free(self) -> None:
        """≈ MPI_Request_free."""
        self._inner = None

    def _abandon(self) -> None:
        """Deactivate after a failed Startall sibling: cancel whatever
        the start launched and return to inactive WITHOUT transferring
        its status — the caller never observed this incarnation, so the
        request must look exactly as it did before the Startall."""
        inner, self._inner = self._inner, None
        if inner is not None:
            try:
                inner.cancel()
            except Exception:  # noqa: BLE001 — best-effort rollback
                pass


def start_all(requests: Sequence[PersistentRequest]) -> None:
    """≈ MPI_Startall — all-or-nothing: when any start() raises (revoked
    communicator, dead peer, freed plan), the requests already started
    by THIS call are deactivated again before the error propagates.
    Without the rollback a failed Startall left a mix of active and
    inactive requests with no way for the caller to reconcile which
    were which (restarting the active ones raised, waiting the
    inactive ones hung).

    Scope: the rollback restores the LOCAL handle state (requests that
    dequeue their posted receives do so — partitioned recvs; already
    -sent wire frames cannot be unsent).  For collective plans that is
    sufficient exactly when the failure is uniform across the
    communicator — the revoke/free/death conditions the gate checks
    are comm-wide, and MPI already requires every rank to Startall the
    same operations in the same order, so all ranks abandon the same
    op and the residue pairs off symmetrically."""
    started = []
    try:
        for r in requests:
            r.start()
            started.append(r)
    except BaseException:
        for r in started:
            r._abandon()
        raise


class CompletedRequest(Request):
    """Pre-completed request (PROC_NULL ops, zero-byte fast paths)."""

    def __init__(self, result: Any = None, kind: str = "null") -> None:
        super().__init__(kind)
        self.complete(result)


class GeneralizedRequest(Request):
    """≈ MPI generalized request (grequest_start.c, ompi/request/grequest.c):
    a user-defined operation wrapped in MPI request semantics.

    The user signals completion with ``.complete()`` (≈
    MPI_Grequest_complete).  When a wait/test observes completion, the
    ``query_fn(extra_state, status)`` runs to fill the status — exactly
    once per wait that returns it, per the MPI contract.  ``cancel_fn``
    receives ``complete=`` telling it whether the operation had already
    completed.  ``free_fn`` runs when the request is freed (after the
    wait that returns it, or an explicit .free())."""

    def __init__(self, query_fn: Optional[Callable] = None,
                 free_fn: Optional[Callable] = None,
                 cancel_fn: Optional[Callable] = None,
                 extra_state: Any = None) -> None:
        super().__init__(kind="generalized")
        self._query_fn = query_fn
        self._free_fn = free_fn
        self._cancel_fn = cancel_fn
        self.extra_state = extra_state
        self._freed = False

    def wait(self, timeout: Optional[float] = None) -> Any:
        out = super().wait(timeout=timeout)
        if self._query_fn is not None:
            self._query_fn(self.extra_state, self.status)
        self.free()
        return out

    def test(self) -> bool:
        if not self._flag:
            return False
        # completed: a successful test has wait semantics for grequests
        self.wait()
        return True

    def cancel(self) -> None:
        if self._cancel_fn is not None:
            self._cancel_fn(self.extra_state, complete=self._flag)
        self.cancelled = True
        self.status.set_cancelled(True)

    def free(self) -> None:
        """≈ MPI_Request_free on a generalized request."""
        if not self._freed:
            self._freed = True
            if self._free_fn is not None:
                self._free_fn(self.extra_state)


def grequest_start(query_fn: Optional[Callable] = None,
                   free_fn: Optional[Callable] = None,
                   cancel_fn: Optional[Callable] = None,
                   extra_state: Any = None) -> GeneralizedRequest:
    """≈ MPI_Grequest_start."""
    return GeneralizedRequest(query_fn, free_fn, cancel_fn, extra_state)


def wait_all(requests: Sequence[Request],
             timeout: Optional[float] = None) -> list[Any]:
    """≈ MPI_Waitall (raises the first failure, after waiting for all)."""
    results = []
    first_exc: Optional[BaseException] = None
    for r in requests:
        try:
            results.append(r.wait(timeout=timeout))
        except TimeoutError:
            raise
        except BaseException as e:
            first_exc = first_exc or e
            results.append(None)
    if first_exc is not None:
        raise first_exc
    return results


def wait_any(requests: Sequence[Request],
             timeout: Optional[float] = None) -> tuple[int, Any]:
    """≈ MPI_Waitany: (index, result) of the first completed request."""
    if not requests:
        raise MPIException("wait_any on empty request list")
    event = threading.Event()

    def poke(_r):
        event.set()

    for r in requests:
        r.add_completion_callback(poke)
    if not event.wait(timeout=timeout):
        raise TimeoutError("wait_any timed out")
    for i, r in enumerate(requests):
        if r.done():
            return i, r.wait()
    raise AssertionError("unreachable: event set but no request done")


def wait_some(requests: Sequence[Request],
              timeout: Optional[float] = None) -> tuple[list[int], list[Any]]:
    """≈ MPI_Waitsome: block until ≥1 completes; return (indices, results)
    of every request complete at that moment."""
    if not requests:
        raise MPIException("wait_some on empty request list")
    event = threading.Event()

    def poke(_r):
        event.set()

    for r in requests:
        r.add_completion_callback(poke)
    if not event.wait(timeout=timeout):
        raise TimeoutError("wait_some timed out")
    idx, results = [], []
    for i, r in enumerate(requests):
        if r.done():
            idx.append(i)
            results.append(r.wait())
    return idx, results


def test_all(requests: Sequence[Request]) -> bool:
    return all(r.test() for r in requests)


def test_any(requests: Sequence[Request]) -> tuple[Optional[int], Any]:
    """≈ MPI_Testany: (index, result) of one completed request, or
    (None, None) when none has completed yet."""
    for i, r in enumerate(requests):
        if r.test():
            return i, r.wait()
    return None, None


def test_some(requests: Sequence[Request]) -> tuple[list[int], list[Any]]:
    """≈ MPI_Testsome: (indices, results) of all currently-complete
    requests (both empty when none)."""
    idx, results = [], []
    for i, r in enumerate(requests):
        if r.test():
            idx.append(i)
            results.append(r.wait())
    return idx, results
