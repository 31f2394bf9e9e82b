"""PML — point-to-point messaging logic: matching, protocols, progress (the
port's trimmed copy of the JAX package's ``mpi/pml.py``).

≈ ompi/mca/pml/ob1: MPI send/recv semantics over the BTL —
- tag/source matching with wildcards, posted-recv + unexpected queues
  (≈ pml_ob1_recvfrag.c:143-173),
- eager vs rendezvous protocol selection by message size
  (≈ pml_ob1_sendreq.h:382-413),
- fragmentation/pipelining of large transfers (≈ the RDMA pipeline),
- the four send modes with the bsend pool, probe/iprobe and the matched
  probe (mprobe/mrecv).

Threading model (replaces the reference's opal_progress polling): BTL reader
threads ONLY read and match; all payload writes go through a single send
worker thread per process, so readers can never block on socket backpressure
— the classic two-sided rendezvous deadlock (both readers stuck in sendall)
is structurally impossible.

MPI ordering guarantee (per sender-receiver pair, per communicator, in tag
order of posting) holds because each direction of a pair is one TCP stream
processed by one reader, the send worker is FIFO, and every data frame
carries a per-(peer, cid) wire sequence number that the receiver gates on.

The wire format (header keys, frame types, dtype specs) is the JAX
package's.  Matching runs in the compiled engine of ``_native/fastdss.c``
(``pml_native_match``, on when it built: the posted and unexpected queues,
the wire-sequence gate and the held frames in C, handing protocol actions
back to ``_apply_action``), with its same-address-space fast lane (a plain
eager contiguous send delivered into the peer's engine with no header) and
its fused shm drain; with the engine off, or ``OMPI_TPU_NO_NATIVE=1``, the
pure-Python matcher below runs the same protocol.  A blocked ``recv``
drains its own shm rings (receiver-pull progress), or on a tcp-only
endpoint runs the native poller's service pass on its own thread.

Partitioned point-to-point (``psend_init``/``precv_init``, MPI-4 §4.2)
rides the same matching: each partition of the bound buffer is an ordinary
zero-copy message on its own wire tag, ``-1_000_000 - tag·2^24 - (offset +
i)``, which leaves int32 beyond user tag 127; every header codec (the dss
dict, the native engine and fast lane, the shm and tcp frames) carries
tags as int64.

The trace plane's sites are the JAX package's: the event bridge
(``add_listener``; ``trace.attach_pml`` turns every event into a ``pml``
instant), flow ids (``fl``, with the job's trace id ``tc``) in every
eager and rendezvous match header while the timeline is armed, the
``eager_send``/``eager_recv``/``rndv_send``/``rndv_recv`` and
``shm_drain_batch`` spans, the ``pml_*`` counters (zero-copy and packed
sends, the partitioned starts and Preadys), the ``pml_eager_send_ns``
and ``pml_rndv_send_ns`` histograms, ``pending_summary`` (what the hang
doctor's capture reads) and the memchecker gates (``--mca memchecker
enable 1``).

Left out: the fault-tolerance hooks (ROADMAP.md Queue 1 item 6.10: ULFM
checks, the partitioned start's revocation check, incarnation fencing,
respawn rebind and the park-and-heal retransmit; a frame that cannot be
routed fails its request at once, as the JAX package does with
``pml_retry_window`` 0).
"""

from __future__ import annotations

import collections
import itertools
import math
import os
import queue
import threading
import time
import weakref
from typing import Any, Optional

import numpy as np

from ompi_tpu_torch.core import output
from ompi_tpu_torch.core.buffer import (BufferKind, BufferLocationError,
                                        classify)
from ompi_tpu_torch.core.config import VarType, register_var, var_registry
from ompi_tpu_torch.core.mca import Component, Framework
from ompi_tpu_torch.mpi import datatype as dt_mod
from ompi_tpu_torch.mpi import trace as trace_mod
from ompi_tpu_torch.mpi.btl import BtlEndpoint
from ompi_tpu_torch.mpi.constants import (
    ANY_SOURCE, ANY_TAG, ERR_TRUNCATE, PROC_NULL, MPIException,
)
from ompi_tpu_torch.mpi.datatype import Datatype
from ompi_tpu_torch.mpi.request import (CompletedRequest, PersistentRequest,
                                        Request, Status)

__all__ = ["pml_framework", "PmlOb1", "RecvRequest", "Message",
           "MESSAGE_NO_PROC", "buffer_attach", "buffer_detach",
           "PartitionedSendRequest", "PartitionedRecvRequest"]


def _reject_device(buf: Any, what: str) -> None:
    """Device buffers (every torch tensor, whatever its device) must NEVER
    silently host-stage through the PML (the reference's coll/cuda
    bounce-buffer anti-pattern this design forbids).  They belong on the
    device path: a comm with a bound DeviceCommunicator
    (comm.bind_device), or DeviceCommunicator's own p2p."""
    kind = classify(buf)
    if kind is not BufferKind.HOST:
        raise BufferLocationError(
            f"pml.{what}: got a {kind.value} buffer; the host PML would "
            f"stage it through host memory. Use the device path instead "
            f"(comm.bind_device(device_world(mesh)) routes collectives "
            f"over NCCL/gloo; for p2p use DeviceCommunicator.shift/"
            f"permute/sendrecv), or .cpu().numpy() the tensor explicitly "
            f"if host staging is intended.")


def _reject_device_parts(parts, what: str) -> None:
    """:func:`_reject_device` for every part of a v-form or per-neighbor
    part list (``classify`` of a list looks at its first part only)."""
    for p in parts:
        _reject_device(p, what)


_log = output.get_stream("pml")

# 1-2 core hosts flip the receiver-pull spin style (see _progress_wait)
_SMALL_HOST = (os.cpu_count() or 1) <= 2

pml_framework = Framework("pml", "point-to-point messaging logic")

register_var("pml", "eager_limit", VarType.SIZE, 64 * 1024,
             "max payload bytes sent eagerly (larger goes rendezvous)")
register_var("pml", "frag_size", VarType.SIZE, 1 << 20,
             "fragment size for rendezvous pipelines")
register_var("pml", "native_match", VarType.BOOL, True,
             "run the matching engine (posted/unexpected queues, wire-seq "
             "gate, held frames) in the compiled extension "
             "(_native/fastdss.c Engine — ob1's recvfrag matcher in C); "
             "off, or a failed native build, → the pure-python matcher")


class RecvRequest(Request):
    def __init__(self, buf: Optional[np.ndarray], datatype: Optional[Datatype],
                 count: Optional[int], source: int, tag: int, cid: int) -> None:
        super().__init__(kind="recv")
        self.buf = buf
        self.datatype = datatype  # None → take element dtype from the wire
        self.count = count        # None → no truncation check (alloc to fit)
        self.source = source
        self.tag = tag
        self.cid = cid
        self.rid = -1  # receiver-side id for rendezvous
        self._pml = None  # set by PmlOb1.irecv; enables real cancel
        # post time (monotonic): the hang doctor's pending-recv age
        self.t_posted = time.monotonic()
        # set BEFORE delivery can complete the request: the status.source
        # value _deliver should report instead of the wire peer (a
        # communicator's group rank when it differs from the world rank).
        # A post-completion translation callback would race the waiter.
        self.source_override: Optional[int] = None

    def cancel(self) -> None:
        """≈ MPI_Cancel on a recv: dequeue the posted request if (and only
        if) nothing has matched it yet; a matched/completed recv proceeds
        (MPI's 'cancel either succeeds or the operation succeeds')."""
        pml = self._pml
        if pml is None or self.done():
            return
        with pml._lock:
            if pml._eng is not None:
                if not pml._eng.cancel(self.cid, self):
                    return  # already matched — delivery wins
            else:
                m = pml._matching.get(self.cid)
                if m is None:
                    return
                try:
                    m.posted.remove(self)
                except ValueError:
                    return  # already matched — delivery wins
        self.cancelled = True
        self.status.set_cancelled(True)  # MPI_Test_cancelled sees it
        self.complete(None)


class Message:
    """≈ MPI_Message: one matched-and-detached incoming message
    (ompi/mpi/c/mprobe.c:1, imrecv.c:1).  Once mprobe/improbe returns a
    handle, the message can no longer match any other recv or probe;
    exactly one mrecv/imrecv consumes it.  This is the only thread-safe
    probe-then-receive with wildcards: the match and the detach happen
    atomically under the PML lock."""

    __slots__ = ("pml", "peer", "hdr", "payload", "consumed")

    def __init__(self, pml, peer: int, hdr: dict, payload) -> None:
        self.pml = pml
        self.peer = peer
        self.hdr = hdr
        self.payload = payload
        self.consumed = False

    @property
    def no_proc(self) -> bool:
        return self.pml is None


#: ≈ MPI_MESSAGE_NO_PROC — what a matched probe of PROC_NULL returns;
#: mrecv on it completes immediately with an empty buffer.
MESSAGE_NO_PROC = Message(None, -1, {}, b"")


_wire_memo: dict = {}  # np.dtype → wire spec (hot-path cache)


def _dtype_to_wire(dt: np.dtype):
    try:
        return _wire_memo[dt]
    except (KeyError, TypeError):
        pass
    if dt.fields:
        spec = dt.descr
    elif dt.kind == "V":
        # extended dtypes (bfloat16, float8_*) stringify as raw void
        # ('<V2'); their registered name ('bfloat16') reconstructs
        spec = dt.name
    else:
        spec = dt.str
    try:
        _wire_memo[dt] = spec
    except TypeError:
        pass
    return spec


_dtype_memo: dict[str, np.dtype] = {}  # hot-path cache (str specs only)


def _wire_to_dtype(spec) -> np.dtype:
    if isinstance(spec, str):
        dt = _dtype_memo.get(spec)
        if dt is not None:
            return dt
    if isinstance(spec, (list, tuple)):
        return np.dtype([tuple(f) for f in spec])
    # the name form ('bfloat16') resolves only where a package registered
    # the extended type with numpy; the port sends none itself
    dt = np.dtype(spec)
    _dtype_memo[spec] = dt
    return dt


class _SendState:
    """Sender-side bookkeeping for sends awaiting a peer event (rendezvous
    CTS, sync-mode ack, ready-mode nack)."""

    def __init__(self, req: Request, peer: int, payload,
                 on_done=None) -> None:
        self.req = req
        self.peer = peer
        self.payload = payload   # bytes or zero-copy memoryview of user buf
        self.on_done = on_done   # e.g. bsend-pool release
        self.fl = 0              # flow id (tracing): rides the rndv_send span
        # creation time (monotonic): the hang doctor's pending-send age
        self.t_posted = time.monotonic()


class _RecvState:
    """Receiver-side rendezvous accumulation.

    ``direct=True`` ⇒ ``data`` is a uint8 view of the user's posted buffer
    and fragments land in place — no intermediate copy (the reference
    pipelines straight into the receive convertor the same way,
    pml_ob1_recvreq.c).  Otherwise ``data`` is a staging bytearray that
    ``_deliver`` unpacks through the datatype engine.
    """

    def __init__(self, req: RecvRequest, size: int, src_hdr: dict,
                 peer: int, direct: bool = False) -> None:
        self.req = req
        self.direct = direct
        if direct:
            self.data = req.buf.reshape(-1).view(np.uint8)[:size]
        else:
            self.data = bytearray(size)
        self.received = 0
        self.src_hdr = src_hdr
        self.peer = peer
        # flight-recorder span: CTS sent → last fragment landed
        self.trace_t0 = trace_mod.begin() if trace_mod.active else 0


class BsendPool:
    """The attached MPI_Buffer_attach pool (per process, ≈ ompi/mpi/c/
    buffer_attach.c + pml bsend accounting).  Byte-counted, not an
    allocator: payloads are Python objects; the pool enforces the MPI
    contract that buffered sends beyond the attached capacity fail."""

    def __init__(self) -> None:
        self._cv = threading.Condition()
        self.capacity = 0
        self.used = 0

    def attach(self, nbytes: int) -> None:
        with self._cv:
            if self.capacity:
                raise MPIException(
                    "a bsend buffer is already attached", error_class=1)
            self.capacity = int(nbytes)

    def detach(self) -> int:
        """Blocks until pending buffered sends drain (MPI semantics), then
        returns the detached capacity."""
        with self._cv:
            self._cv.wait_for(lambda: self.used == 0)
            cap, self.capacity = self.capacity, 0
            return cap

    def reserve(self, nbytes: int) -> None:
        with self._cv:
            if self.used + nbytes > self.capacity:
                raise MPIException(
                    f"bsend of {nbytes}B exceeds attached buffer "
                    f"({self.used}/{self.capacity}B in use); "
                    f"MPI_Buffer_attach more", error_class=1)
            self.used += nbytes

    def release(self, nbytes: int) -> None:
        with self._cv:
            self.used -= nbytes
            if self.used == 0:
                self._cv.notify_all()


def buffer_attach(nbytes: int) -> None:
    """≈ MPI_Buffer_attach — attaches to this process's (world) PML.
    The pool is per-PML so in-process multi-rank harnesses keep ranks'
    buffers independent, exactly like separate MPI processes."""
    _world_pml().bsend_pool.attach(nbytes)


def buffer_detach() -> int:
    """≈ MPI_Buffer_detach — blocks until buffered sends complete."""
    return _world_pml().bsend_pool.detach()


def _world_pml() -> "PmlOb1":
    from ompi_tpu_torch.mpi import runtime

    world = runtime.COMM_WORLD
    if world is None or getattr(world, "pml", None) is None:
        raise MPIException(
            "buffer_attach/detach need an initialized runtime "
            "(ompi_tpu_torch.init()); in harness code use "
            "comm.pml.bsend_pool")
    return world.pml


class _WireWatch(Request):
    """Tracks the wire write of a frame whose *logical* completion comes
    from a later peer event (sack for sync/ready, CTS→data for rndv).
    Success is a no-op; a transport failure must tear down the pending
    send state and fail the real request — otherwise the caller's wait()
    hangs forever on a dead connection."""

    def __init__(self, pml: "PmlOb1", sid: int) -> None:
        super().__init__(kind="wire")
        self._pml = pml
        self._sid = sid

    def complete(self, result: Any = None) -> None:
        pass  # the real request completes on sack / after rndv data

    def fail(self, exc: BaseException) -> None:
        with self._pml._lock:
            state = self._pml._send_states.pop(self._sid, None)
        if state is not None:
            if state.on_done:
                state.on_done()
            state.req.fail(exc)


#: flow-id namespace stride: ids are ``rank * stride + local counter`` —
#: globally unique without coordination (a rank emitting 2^40 frames in
#: one trace window would wrap the ring thousands of times over first)
_FLOW_STRIDE = 1 << 40


class _Matching:
    """Per-communicator matching engine (posted + unexpected queues)."""

    def __init__(self) -> None:
        self.posted: collections.deque[RecvRequest] = collections.deque()
        self.unexpected: collections.deque[tuple[int, dict, bytes]] = \
            collections.deque()


def _hdr_matches(req: RecvRequest, peer: int, hdr: dict) -> bool:
    if req.source != ANY_SOURCE and req.source != peer:
        return False
    if req.tag == ANY_TAG:
        # ANY_TAG never matches the reserved negative tag space (internal
        # collective traffic) — same guard as the reference's ob1 matching;
        # without it a user wildcard recv posted before a barrier would
        # steal the barrier's control frames
        return hdr["tag"] >= 0
    return req.tag == hdr["tag"]


# request-lifecycle events (≈ the PERUSE spec, ompi/peruse/peruse.h:55-76:
# queue/xfer event hooks on the matching engine) — listeners receive
# (event, info_dict)
EVT_SEND_POST = "send_post"        # isend issued
EVT_RECV_POST = "recv_post"        # irecv posted
EVT_MATCH = "match"                # incoming frame matched a posted recv
EVT_UNEXPECTED = "unexpected"      # incoming frame queued unmatched
EVT_DELIVER = "deliver"            # payload delivered, request complete


class PmlOb1:
    """The default PML: matching + eager/rendezvous over the BTL."""

    def __init__(self, rank: int) -> None:
        self.rank = rank
        self.endpoint = BtlEndpoint(rank, self._on_frame)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)  # probe waiters
        self._matching: dict[int, _Matching] = {}
        self._send_states: dict[int, _SendState] = {}
        self._recv_states: dict[int, _RecvState] = {}
        self._ids = itertools.count(1)
        self._seq: dict[tuple[int, int], int] = {}
        self._recv_seq: dict[tuple[int, int], int] = {}
        self._held: dict[tuple[int, int], dict[int, tuple]] = {}
        # frames in _sendq per peer: an inline send must not overtake them
        self._queued: dict[int, int] = {}
        self._qlock = threading.Lock()   # _queued has its own lock:
        # _enqueue_frame runs from handlers that already hold self._lock
        self._sendq: "queue.Queue[Optional[tuple]]" = queue.Queue()
        # memchecker gate read ONCE (off-by-default debug feature — the
        # hot path must not pay a registry lookup per message; toggle it
        # before creating communicators, like the reference's build flag)
        from ompi_tpu_torch.core import memchecker

        self._memcheck = memchecker.enabled()
        # every posted recv, weakly (engine-agnostic: the native matching
        # engine owns the real posted queue) — what the hang doctor's
        # pending_summary walks; completed requests filter out on done()
        self._doctor_recvs: "weakref.WeakSet[RecvRequest]" = \
            weakref.WeakSet()
        self._listeners: list = []   # peruse/monitoring subscribers
        self._events: "collections.deque[tuple]" = collections.deque()
        self.bsend_pool = BsendPool()  # per-PML, like every other send state
        # compiled matching engine: owns posted/unexpected queues + the
        # wire-seq gate when available; every call happens under
        # self._lock (the engine replaces the structures that lock
        # guarded, it does not add its own)
        self._eng = None
        self._fast = None
        if var_registry.get("pml_native_match"):
            from ompi_tpu_torch import _native

            fast = _native.fastdss()
            if fast is not None and hasattr(fast, "Engine"):
                self._eng = fast.Engine()
                self._fast = fast
        self._worker = threading.Thread(
            target=self._send_loop, name=f"pml-send-{rank}", daemon=True)
        self._worker.start()
        self._closed = False
        if self._eng is not None and self.endpoint.proc_btl is not None:
            # same-address-space fast lane: peers deliver into my engine
            self.endpoint.proc_btl.on_fast = self._on_frame_fast
        if self._eng is not None and self.endpoint.shm_btl is not None:
            # fused shm drain: ring decode + matching in one C call per
            # batch; also enables receiver-pull progress (_progress_wait)
            self.endpoint.shm_btl.drain_hook = self._drain_shm
        if self.endpoint.tcp_btl is not None:
            # zero-copy rndv landing: the tcp poller asks for the
            # plan-registered destination of an in-flight "data" frame
            # and lands payload bytes straight into it
            self.endpoint.tcp_btl.recv_sink = self._rndv_sink
            self.endpoint.tcp_btl.recv_sink_done = self._rndv_sink_done

    # -- event hooks (PERUSE equivalent) -----------------------------------
    #
    # _emit only enqueues; _drain_events dispatches OUTSIDE the PML lock so
    # listeners may safely call back into the PML.

    def add_listener(self, cb) -> None:
        """Subscribe cb(event, info) to request-lifecycle events."""
        self._listeners.append(cb)

    def remove_listener(self, cb) -> None:
        self._listeners.remove(cb)

    def _emit(self, event: str, **info) -> None:
        self._events.append((event, info))

    def _drain_events(self) -> None:
        while self._events:
            try:
                event, info = self._events.popleft()
            except IndexError:
                return
            for cb in list(self._listeners):
                cb(event, info)

    # -- wiring ------------------------------------------------------------

    @property
    def address(self) -> str:
        return self.endpoint.address

    def set_peers(self, peers: dict[int, str]) -> None:
        self.endpoint.set_peers(peers)

    def close(self) -> None:
        self._closed = True
        self._sendq.put(None)
        self._worker.join(timeout=2.0)
        self.endpoint.close()

    def _matching_for(self, cid: int) -> _Matching:
        m = self._matching.get(cid)
        if m is None:
            m = self._matching[cid] = _Matching()
        return m

    def pending_summary(self, limit: int = 64) -> dict:
        """Pending point-to-point state for the hang doctor's capture:
        posted recvs (peer/tag/cid/age), sends awaiting a peer event
        (rendezvous CTS, sync ack), in-flight rendezvous receives,
        unexpected-queue depth and parked/queued frame counts.  Runs on
        the doctor responder thread — dict walks under the PML lock,
        no blocking work.  ``parked`` stays empty until the
        park-and-heal retransmit comes with fault tolerance (ROADMAP.md
        Queue 1 item 6.10)."""
        now = time.monotonic()
        recvs: list[dict] = []
        sends: list[dict] = []
        rndv: list[dict] = []
        with self._lock:
            for req in list(self._doctor_recvs):
                if req.done():
                    continue
                recvs.append({
                    "src": req.source, "tag": req.tag, "cid": req.cid,
                    "age_s": round(now - req.t_posted, 3)})
                if len(recvs) >= limit:
                    break
            for st in list(self._send_states.values()):
                if st.req is not None and st.req.done():
                    continue
                payload = st.payload
                nbytes = (getattr(payload, "nbytes", None)
                          or (len(payload) if payload is not None else 0))
                sends.append({
                    "peer": st.peer, "bytes": int(nbytes),
                    "age_s": round(now - st.t_posted, 3)})
                if len(sends) >= limit:
                    break
            for st in list(self._recv_states.values()):
                if st.req is not None and st.req.done():
                    continue
                rndv.append({
                    "peer": st.peer, "bytes": len(st.data),
                    "received": st.received})
                if len(rndv) >= limit:
                    break
            unexpected = sum(len(m.unexpected)
                             for m in self._matching.values())
        with self._qlock:
            queued = {p: n for p, n in self._queued.items() if n}
        return {"recvs": recvs, "sends": sends, "rndv": rndv,
                "unexpected": unexpected, "parked": {},
                "queued": queued}

    # -- send side ---------------------------------------------------------

    def isend(self, buf: Any, peer: int, tag: int, cid: int,
              datatype: Optional[Datatype] = None,
              count: Optional[int] = None, mode: str = "standard") -> Request:
        """mode ∈ standard | sync (ssend) | ready (rsend) | buffered (bsend)
        — the four MPI send modes (≈ pml.h:211 MCA_PML_BASE_SEND_*)."""
        if mode not in ("standard", "sync", "ready", "buffered"):
            raise MPIException(
                f"unknown send mode {mode!r} (standard/sync/ready/buffered)")
        _reject_device(buf, "isend")
        # compiled fast lane (same-address-space or same-host peers): a
        # plain eager contiguous send delivers straight into the peer's
        # posted buffer through its engine — no header object at all
        if (mode == "standard"
                and self._eng is not None
                and peer != self.rank
                and not self._listeners
                and datatype is None and count is None
                and isinstance(buf, np.ndarray)
                and buf.flags["C_CONTIGUOUS"]
                and not self._memcheck):
            req = self._isend_fast(buf, peer, tag, cid)
            if req is not None:
                return req
        if self._memcheck:
            from ompi_tpu_torch.core import memchecker

            memchecker.check_send(buf, "isend")
        arr = np.asarray(buf)
        if datatype is None:
            datatype = dt_mod.from_numpy(arr.dtype)
        if count is None:
            count = arr.size // max(1, datatype.elements_per_item)
        # validate BEFORE the plan gate: the zero-copy branch must reject
        # an uncommitted datatype exactly like the staged pack would
        datatype._validate_packing(count, "pack")
        plan = datatype.pack_plan(count)
        # zero-copy path: a send whose pack plan collapses to ONE run rides
        # a memoryview of the user's array — no sender-side staging copy
        # (the MPI contract forbids touching the buffer until completion
        # anyway; ≈ pml_ob1_sendreq.h:382-413 sending from the user iovec).
        # Buffered mode always copies: the user may reuse immediately.
        if (mode != "buffered" and plan.single_run
                and arr.flags["C_CONTIGUOUS"]
                and plan.start + plan.total <= arr.nbytes):
            payload = arr.reshape(-1).view(np.uint8).data[
                plan.start:plan.start + plan.total]
            trace_mod.count("pml_zero_copy_sends_total")
        else:
            # non-contiguous: stage through the plan walk into a uint8
            # buffer (pack_into — no intermediate bytes)
            staged = np.empty(plan.total, np.uint8)
            datatype.pack_into(arr, count, staged)
            payload = staged.data
            trace_mod.count("pml_packed_sends_total")
        req = Request(kind="send")
        on_done = None
        if mode == "buffered":
            # reserve BEFORE allocating a wire seq: a failed reserve must
            # not burn a sequence number (the peer would hold back every
            # later frame waiting for it)
            self.bsend_pool.reserve(len(payload))
            on_done = (lambda n=len(payload):  # noqa: E731
                       self.bsend_pool.release(n))
        with self._lock:
            seq_key = (peer, cid)
            seq = self._seq.get(seq_key, 0)
            self._seq[seq_key] = seq + 1
        with self._qlock:
            # frames still queued for this peer: inline would overtake
            can_inline = not self._queued.get(peer, 0)
        hdr = {"tag": tag, "cid": cid, "seq": seq,
               "dt": _dtype_to_wire(datatype.base_np),
               "elems": len(payload) // datatype.base_np.itemsize,
               "shp": list(arr.shape)}
        # cross-rank trace correlation: with the flight recorder armed,
        # every eager/rndv frame carries a globally-unique flow id — the
        # send-side span and the matching recv-side span both record it,
        # and trace_export turns each pair into a Perfetto flow arrow
        # (send→recv).  Cost when tracing is off: one attribute check.
        fl = 0
        _fl_t0 = 0
        if trace_mod.active:
            hdr["fl"] = fl = self.rank * _FLOW_STRIDE + next(self._ids)
            # the (trace_id, span_id) pair: trace_id scopes the flow id
            # to ONE job's trace (merged timelines from a shared TMPDIR
            # must not stitch arrows between jobs' equal flow ids)
            hdr["tc"] = trace_mod.trace_id()
            _fl_t0 = trace_mod.begin()
        # eager completion latency (histogram plane, timeline-independent)
        _h_t0 = time.monotonic_ns() if trace_mod.hist_active else 0
        if self._listeners:
            self._emit(EVT_SEND_POST, peer=peer, tag=tag, cid=cid,
                       nbytes=len(payload))
        eager = len(payload) <= var_registry.get("pml_eager_limit")
        if eager and mode in ("sync", "ready"):
            # matched-ack protocol: the frame carries a sync id; the peer
            # acks on match (sync) or nacks when nothing was posted (ready)
            sid = next(self._ids)
            hdr.update(t="eager", sid=sid, sm=mode[0])  # sm: "s" | "r"
            with self._lock:
                self._send_states[sid] = _SendState(req, peer, None, on_done)
            # inline wire write when possible (completion still via sack)
            if not (can_inline
                    and self.endpoint.try_send_inline(peer, hdr, payload)):
                self._enqueue_frame(peer, hdr, payload,
                                    _WireWatch(self, sid))
            self._trace_eager_send(_h_t0, fl, _fl_t0, peer, len(payload))
        elif eager:
            hdr["t"] = "eager"
            # sendi fast path (≈ pml_ob1_isend.c:89-119): the frame goes
            # out on this thread — no send-worker handoff
            if can_inline and self.endpoint.try_send_inline(peer, hdr,
                                                            payload):
                if mode == "buffered":
                    on_done()
                req.complete(None)
            elif mode == "buffered":
                wire = Request(kind="send")
                wire.add_completion_callback(lambda _r: on_done())
                self._enqueue_frame(peer, hdr, payload, wire)
                req.complete(None)  # local completion
            else:
                self._enqueue_frame(peer, hdr, payload, req)
            self._trace_eager_send(_h_t0, fl, _fl_t0, peer, len(payload))
        else:
            sid = next(self._ids)
            hdr.update(t="rndv", size=len(payload), sid=sid)
            if mode == "ready":
                hdr["sm"] = "r"  # peer nacks instead of queueing unexpected
            state_req = req
            if mode == "buffered":
                wire = Request(kind="send")
                wire.add_completion_callback(lambda _r: on_done())
                state_req = wire
                req.complete(None)  # local completion; pool holds the copy
            with self._lock:
                state = _SendState(
                    state_req, peer, payload,
                    None if mode == "buffered" else on_done)
                state.fl = fl  # rndv_send span (send worker) records it
                self._send_states[sid] = state
            self._enqueue_frame(peer, hdr, b"", _WireWatch(self, sid))
        self._drain_events()
        return req

    def _trace_eager_send(self, h_t0: int, fl: int, fl_t0: int, peer: int,
                          nbytes: int) -> None:
        """The eager send's histogram sample and, with a flow id, its
        ``eager_send`` span (the send half of the flow arrow)."""
        if h_t0 and trace_mod.hist_active:
            trace_mod.record_hist("pml_eager_send_ns",
                                  time.monotonic_ns() - h_t0)
        if fl and trace_mod.active:
            trace_mod.complete("pml", "eager_send", fl_t0,
                               rank=self.rank, peer=peer,
                               nbytes=nbytes, fl=fl,
                               tc=trace_mod.trace_id())

    def _isend_fast(self, arr: np.ndarray, peer: int, tag: int,
                    cid: int) -> Optional[Request]:
        """Fast lane for plain eager contiguous sends: deliver through
        the same-address-space peer's compiled engine (proc BTL) or a
        C-built header into its shm ring.  None ⇒ precondition missed,
        caller runs the general isend.  If the receiver punts (no posted
        contiguous buffer, out-of-order, listeners attached mid-flight)
        the frame falls back to the header path WITH the already-drawn
        seq — the wire order is unaffected."""
        if arr.nbytes > var_registry.get("pml_eager_limit"):
            return None
        ep = self.endpoint
        proc_ok = ep.proc_btl is not None and (
            peer in ep._proc_ok
            or (peer not in ep._proc_no and ep._proc_route(peer)))
        if not proc_ok:
            # cross-process: the lane still applies over shm rings
            if ep.shm_btl is None or not (
                    peer in ep._shm_ok or ep._shm_route(peer)):
                return None
        with self._lock:
            if self._queued.get(peer, 0):
                return None
            seq_key = (peer, cid)
            seq = self._seq.get(seq_key, 0)
            self._seq[seq_key] = seq + 1
        payload = arr.reshape(-1).view(np.uint8).data
        trace_mod.count("pml_zero_copy_sends_total")
        req = Request(kind="send")
        dt = _dtype_to_wire(arr.dtype)
        if proc_ok and ep.proc_btl.send_fast(peer, tag, cid, seq, payload,
                                             dt, arr.size, arr.shape):
            req.complete(None)
            return req
        if not proc_ok and isinstance(dt, str):
            # cross-process same-host: publish with the C-built header
            try:
                if ep.shm_btl.try_send_eager(peer, tag, cid, seq, dt,
                                             arr.size, arr.shape, payload):
                    req.complete(None)
                    return req
            except Exception:  # noqa: BLE001 — dead peer/oversize: the
                pass           # header path surfaces it properly
        # receiver declined the fast path — same frame, header route
        hdr = {"tag": tag, "cid": cid, "seq": seq, "dt": dt,
               "elems": arr.size, "shp": list(arr.shape), "t": "eager"}
        if ep.try_send_inline(peer, hdr, payload):
            req.complete(None)
        else:
            self._enqueue_frame(peer, hdr, payload, req)
        return req

    def _on_frame_fast(self, peer: int, tag: int, cid: int, seq: int,
                       payload, dt, elems: int, shp) -> bool:
        """Receiver half of the fast lane (installed as the proc BTL's
        on_fast hook).  False ⇒ sender must re-send via the header
        path — the engine consumed NOTHING."""
        eng = self._eng
        if eng is None:
            return False
        with self._lock:
            acts = eng.incoming_fast(peer, tag, cid, seq, payload,
                                     dt, elems, shp)
            if acts is None:
                return False
            for act in acts:
                self._apply_action(act)
        self._drain_events()
        return True

    def issend(self, buf, peer, tag, cid, **kw) -> Request:
        """≈ MPI_Issend: completes only once the matching recv is posted."""
        return self.isend(buf, peer, tag, cid, mode="sync", **kw)

    def ibsend(self, buf, peer, tag, cid, **kw) -> Request:
        """≈ MPI_Ibsend: completes locally against the attached buffer."""
        return self.isend(buf, peer, tag, cid, mode="buffered", **kw)

    def irsend(self, buf, peer, tag, cid, **kw) -> Request:
        """≈ MPI_Irsend: erroneous unless the recv is already posted — the
        peer nacks and the request fails."""
        return self.isend(buf, peer, tag, cid, mode="ready", **kw)

    def send(self, buf: Any, peer: int, tag: int, cid: int, **kw) -> None:
        self.isend(buf, peer, tag, cid, **kw).wait()

    # -- recv side ---------------------------------------------------------

    def irecv(self, buf: Optional[np.ndarray], source: int, tag: int,
              cid: int, datatype: Optional[Datatype] = None,
              count: Optional[int] = None) -> RecvRequest:
        if buf is not None:
            _reject_device(buf, "irecv")
            buf = np.asarray(buf)
            if self._memcheck:
                from ompi_tpu_torch.core import memchecker

                memchecker.prepare_recv(buf, "irecv")
            if datatype is None:
                datatype = dt_mod.from_numpy(buf.dtype)
            if count is None:
                count = buf.size // max(1, datatype.elements_per_item)
        # buf=None with datatype/count=None is the allocate-on-match path:
        # the element dtype travels in the wire header
        req = RecvRequest(buf, datatype, count, source, tag, cid)
        req.rid = next(self._ids)
        req._pml = self
        if self._listeners:
            self._emit(EVT_RECV_POST, peer=source, tag=tag, cid=cid)
        with self._lock:
            # under the PML lock: pending_summary() iterates this set
            # under the same lock, and a WeakSet is not safe against a
            # concurrent add mid-iteration
            self._doctor_recvs.add(req)
            if self._eng is not None:
                barr = None
                if (buf is not None and datatype is not None
                        and datatype.is_contiguous
                        and buf.flags["C_CONTIGUOUS"]):
                    barr = buf   # registered for native fast delivery
                hit = self._eng.post(
                    cid, req.source, req.tag, req, barr,
                    datatype.base_np.itemsize if datatype is not None
                    else 1,
                    count * datatype.size
                    if (count is not None and datatype is not None)
                    else -1)
                if hit is not None:
                    peer, hdr, payload = hit
                    if self._listeners:
                        self._emit(EVT_MATCH, peer=peer, tag=hdr["tag"],
                                   cid=hdr["cid"])
                    self._match(req, peer, hdr, payload)
            else:
                m = self._matching_for(cid)
                # try the unexpected queue first, in arrival order
                for i, (peer, hdr, payload) in enumerate(m.unexpected):
                    if _hdr_matches(req, peer, hdr):
                        del m.unexpected[i]
                        if self._listeners:
                            self._emit(EVT_MATCH, peer=peer,
                                       tag=hdr["tag"], cid=hdr["cid"])
                        self._match(req, peer, hdr, payload)
                        break
                else:
                    m.posted.append(req)
        self._drain_events()
        return req

    def recv(self, buf: Optional[np.ndarray], source: int, tag: int, cid: int,
             datatype: Optional[Datatype] = None, count: Optional[int] = None,
             status: Optional[Status] = None) -> np.ndarray:
        req = self.irecv(buf, source, tag, cid, datatype, count)
        out = self._progress_wait(req)
        if status is not None:
            status.__dict__.update(req.status.__dict__)
        return out

    def _progress_wait(self, req: Request):
        """Receiver-pull progress (≈ opal_progress running in the waiting
        thread): while blocked on a recv, THIS thread drains its own shm
        rings through the engine — the frame that completes the request
        is matched and copied here, with no poller-thread futex handoff
        on the critical path.  Only engages when shm rings exist (frames
        from another process): for in-process peers the sender's thread
        delivers directly, and a GIL-holding spin would steal exactly
        the cycles it is waiting for."""
        shm = self.endpoint.shm_btl
        if self._eng is None or shm is None or req.done():
            return self._tcp_pull_wait(req)
        readers = shm.reader_list()
        if not readers:
            return self._tcp_pull_wait(req)
        # spin style by core count: on a 1-2 core host the frame we are
        # waiting for is PRODUCED by the process we'd be starving, so
        # yield every iteration; on bigger hosts yield rarely (a
        # sched_yield per iteration invites the kernel to deschedule us
        # right when the frame lands)
        yield_every = _SMALL_HOST
        shm.pull_depth += 1   # poller backs off while we drain
        try:
            spins = 0
            while not req.done():
                progressed = 0
                for r in readers:
                    try:
                        progressed += self._drain_shm(r)
                    except OSError as e:  # corrupt ring already recovered
                        _log.error("receiver-pull drain: %r", e)
                if progressed:
                    spins = 0
                    continue
                spins += 1
                if spins > 4000:   # a few ms of spinning, then sleep
                    break
                if yield_every:
                    time.sleep(0)
                if not spins % 64:
                    readers = shm.reader_list()   # new rings mid-wait
                    if not yield_every:
                        time.sleep(0)
        finally:
            shm.pull_depth -= 1
        return req.wait()

    def _tcp_pull_wait(self, req: Request):
        """Receiver-pull over the native tcp plane: while blocked, THIS
        thread runs the poller's bounded service pass (btl progress()),
        so the frame that completes the request is parsed, matched and
        copied here — no poller wake, no completion-event handoff.
        Each pass is one GIL-released poll slice; request state is
        re-checked between slices.  Falls back to the event wait the
        moment the native plane declines (var off, closing, no
        connections yet): the parked poller thread is always running as
        the backstop."""
        ep = self.endpoint
        tcp = ep.tcp_btl
        # tcp-only endpoints: with proc or shm lanes present the frame
        # may arrive off-plane, and a poll slice here would only delay
        # seeing that completion
        if (tcp is None or not tcp._native_ok
                or ep.proc_btl is not None or ep.shm_btl is not None
                or not var_registry.get("btl_tcp_pull")):
            return req.wait()
        tcp.pull_depth += 1
        try:
            while not req.done():
                if not tcp.progress():
                    break
        finally:
            tcp.pull_depth -= 1
        return req.wait()

    def _drain_shm(self, reader) -> int:
        """The shm BTL's drain hook: decode + seq-gate + match a batch of
        ring frames in one C call under the PML lock.  Control frames
        (cts/sack/…) come back as punts and re-enter the full _on_frame
        after the lock drops."""
        eng = self._eng
        punts = None
        _t0 = trace_mod.begin() if trace_mod.active else 0
        try:
            with self._lock:
                new_tail, n, acts = eng.drain_ring(
                    reader.peer, reader._mm, reader._tail, 64)
                reader._tail = new_tail
                for act in acts:
                    if act[0] == "frame":
                        if punts is None:
                            punts = []
                        punts.append(act)
                    else:
                        self._apply_action(act)
        except self._fast.Unsupported:
            # a header tag only the python codec knows: drain this batch
            # through the python framing path instead (same counter +
            # span accounting as the fused path — frames delivered here
            # must not read as lost in the publish/drain pvar pair)
            n = reader.poll(self._on_frame)
            if n:
                self._trace_drain(_t0, reader.peer, n)
            return n
        except ValueError as e:
            # corrupt stream: same recovery as ShmRingReader.poll —
            # nothing trustworthy to advance by; discard and surface
            head = int(reader._ctr[0])
            dropped = head - reader._tail
            reader._tail = head
            reader._ctr[1] = head
            raise OSError(
                f"btl/shm: corrupt ring from peer {reader.peer} "
                f"({e}); {dropped} pending bytes discarded") from None
        if punts:
            for _k, hdr, payload in punts:
                self._on_frame(reader.peer, hdr, payload)
        if n:
            self._trace_drain(_t0, reader.peer, n)
            self._drain_events()
        return n

    def _trace_drain(self, t0: int, peer: int, n: int) -> None:
        """The fused drain's ``btl_shm_drained_total`` and, when armed,
        its ``shm_drain_batch`` span."""
        trace_mod.count("btl_shm_drained_total", n)
        if t0 and trace_mod.active:
            trace_mod.complete("pml", "shm_drain_batch", t0,
                               rank=self.rank, peer=peer, frames=n)

    # -- probe -------------------------------------------------------------

    def iprobe(self, source: int, tag: int, cid: int) -> Optional[Status]:
        with self._lock:
            return self._iprobe_locked(source, tag, cid)

    def probe(self, source: int, tag: int, cid: int,
              timeout: Optional[float] = None) -> Status:
        # deadline computed ONCE: every unexpected frame notifies the cv,
        # so restarting the full timeout per wakeup would never expire
        # under unrelated traffic
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while True:
                st = self._iprobe_locked(source, tag, cid)
                if st is not None:
                    return st
                left = (None if deadline is None
                        else deadline - time.monotonic())
                if left is not None and left <= 0:
                    raise TimeoutError("probe timed out")
                self._cv.wait(timeout=left)

    def _iprobe_locked(self, source: int, tag: int, cid: int) -> Optional[Status]:
        if self._eng is not None:
            hit = self._eng.iprobe(cid, source, tag)
            if hit is None:
                return None
            peer, hdr = hit
            st = Status()
            st.source = peer
            st.tag = hdr["tag"]
            st.count = hdr.get("elems", hdr.get("size", 0))
            st.count_bytes = hdr.get("size")
            return st
        probe = RecvRequest(None, dt_mod.BYTE, 0, source, tag, cid)
        for peer, hdr, payload in self._matching_for(cid).unexpected:
            if _hdr_matches(probe, peer, hdr):
                st = Status()
                st.source = peer
                st.tag = hdr["tag"]
                st.count = hdr.get("elems", hdr.get("size", len(payload)))
                st.count_bytes = hdr.get("size", len(payload))
                return st
        return None

    # -- matched probe (≈ ompi/mpi/c/mprobe.c, improbe.c, mrecv.c) ---------

    def improbe(self, source: int, tag: int,
                cid: int) -> Optional[tuple[Message, Status]]:
        """Match-and-detach: the matched frame leaves the unexpected
        queue atomically under the PML lock, so a racing recv or probe in
        another thread can never see it — the race MPI_Mprobe exists to
        close."""
        with self._lock:
            return self._improbe_locked(source, tag, cid)

    def _improbe_locked(self, source: int, tag: int,
                        cid: int) -> Optional[tuple[Message, Status]]:
        if self._eng is not None:
            hit = self._eng.improbe(cid, source, tag)
            if hit is None:
                return None
            peer, hdr, payload = hit
            return self._detach_message(peer, hdr, payload)
        probe = RecvRequest(None, dt_mod.BYTE, 0, source, tag, cid)
        m = self._matching_for(cid)
        for i, (peer, hdr, payload) in enumerate(m.unexpected):
            if _hdr_matches(probe, peer, hdr):
                del m.unexpected[i]
                return self._detach_message(peer, hdr, payload)
        return None

    def _detach_message(self, peer: int, hdr: dict,
                        payload) -> tuple[Message, Status]:
        """With self._lock held: finish a match-and-detach on an
        unexpected frame just removed from the queue."""
        if hdr.get("sm") == "s":
            # matching happens HERE: a sync-mode sender completes
            # at match time (the MPI ssend contract — the recv
            # has "started"), not when mrecv later drains it
            self._enqueue_frame(
                peer, {"t": "sack", "sid": hdr["sid"]}, b"", None)
            hdr = {k: v for k, v in hdr.items()
                   if k not in ("sm", "sid")}
        st = Status()
        st.source = peer
        st.tag = hdr["tag"]
        st.count = hdr.get("elems", hdr.get("size", len(payload)))
        st.count_bytes = hdr.get("size", len(payload))
        return Message(self, peer, hdr, payload), st

    def mprobe(self, source: int, tag: int, cid: int,
               timeout: Optional[float] = None) -> tuple[Message, Status]:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while True:
                out = self._improbe_locked(source, tag, cid)
                if out is not None:
                    return out
                left = (None if deadline is None
                        else deadline - time.monotonic())
                if left is not None and left <= 0:
                    raise TimeoutError("mprobe timed out")
                self._cv.wait(timeout=left)

    def imrecv(self, buf: Optional[np.ndarray], message: Message,
               datatype: Optional[Datatype] = None,
               count: Optional[int] = None,
               status_source: Optional[int] = None) -> RecvRequest:
        """Receive the detached message; consumes the handle.  Eager
        payloads deliver immediately; a detached rendezvous replies with
        its CTS now, exactly as a matching irecv would have.
        ``status_source``: value to report as status.source instead of
        the wire peer (the comm layer passes the group rank)."""
        if message.no_proc:
            req = RecvRequest(None, dt_mod.BYTE, 0, -1, -1, -1)
            req.status.source = PROC_NULL
            req.status.tag = ANY_TAG
            req.status.count = 0
            req.complete(np.empty(0, dtype=np.uint8))
            return req
        if message.consumed:
            raise MPIException("message handle was already received")
        message.consumed = True
        if buf is not None:
            _reject_device(buf, "imrecv")
            buf = np.asarray(buf)
            if self._memcheck:
                from ompi_tpu_torch.core import memchecker

                memchecker.prepare_recv(buf, "imrecv")
            if datatype is None:
                datatype = dt_mod.from_numpy(buf.dtype)
            if count is None:
                count = buf.size // max(1, datatype.elements_per_item)
        req = RecvRequest(buf, datatype, count, message.peer,
                          message.hdr["tag"], message.hdr["cid"])
        req.rid = next(self._ids)
        req._pml = self
        if status_source is not None:
            req.source_override = status_source
        if self._listeners:  # balanced post/match pair, like irecv's path
            self._emit(EVT_RECV_POST, peer=message.peer,
                       tag=message.hdr["tag"], cid=message.hdr["cid"])
            self._emit(EVT_MATCH, peer=message.peer,
                       tag=message.hdr["tag"], cid=message.hdr["cid"])
        with self._lock:
            self._match(req, message.peer, message.hdr, message.payload)
        self._drain_events()
        return req

    def mrecv(self, buf: Optional[np.ndarray], message: Message,
              datatype: Optional[Datatype] = None,
              count: Optional[int] = None,
              status: Optional[Status] = None) -> np.ndarray:
        req = self.imrecv(buf, message, datatype, count)
        out = req.wait()
        if status is not None:
            status.__dict__.update(req.status.__dict__)
        return out

    # -- frame handling (reader threads; NEVER blocking-send here) ---------

    def _on_frame(self, peer: int, hdr: dict, payload: bytes) -> None:
        t = hdr["t"]
        if t in ("eager", "rndv"):
            with self._lock:
                if self._eng is not None:
                    # seq gate + matching in the compiled engine; the
                    # protocol actions come back for this thread to run
                    for act in self._eng.incoming(peer, hdr, payload):
                        self._apply_action(act)
                else:
                    # per-(peer, cid) sequence enforcement: TCP + one
                    # reader already guarantee order, but frames of one
                    # pair may ride two BTLs (shm rings and tcp for an
                    # oversize frame, inline proc and the worker) —
                    # frames arriving early are held back
                    key = (peer, hdr["cid"])
                    seq, expected = hdr["seq"], self._recv_seq.get(key, 0)
                    if seq != expected:
                        # held frames outlive the sender's call: own the
                        # bytes (a zero-copy self/proc payload aliases
                        # the user buffer)
                        if isinstance(payload, memoryview):
                            payload = bytes(payload)
                        self._held.setdefault(key, {})[seq] = (hdr,
                                                               payload)
                        return
                    self._match_incoming(peer, hdr, payload)
                    nxt = expected + 1
                    held = self._held.get(key)
                    while held and nxt in held:
                        h2, p2 = held.pop(nxt)
                        self._match_incoming(peer, h2, p2)
                        nxt += 1
                    self._recv_seq[key] = nxt
            self._drain_events()
        elif t == "cts":
            with self._lock:
                state = self._send_states.pop(hdr["sid"], None)
            if state is not None:
                self._sendq.put(("rndv_data", state, hdr["rid"]))
        elif t == "data":
            self._on_data(hdr, payload)
        elif t == "sack":   # sync/ready send matched on the peer
            with self._lock:
                state = self._send_states.pop(hdr["sid"], None)
            if state is not None:
                if state.on_done:
                    state.on_done()
                state.req.complete(None)
        elif t == "rnack":  # ready send found no posted recv
            with self._lock:
                state = self._send_states.pop(hdr["sid"], None)
            if state is not None:
                if state.on_done:
                    state.on_done()
                state.req.fail(MPIException(
                    "rsend: no matching receive was posted at the peer",
                    error_class=4))
        else:
            _log.error("unknown frame type %r from %d", t, peer)

    def _apply_action(self, act: tuple) -> None:
        """With self._lock held: execute one engine action — the
        protocol step the compiled matcher handed back."""
        kind = act[0]
        if kind == "match":
            _, req, peer, hdr, payload = act
            if self._listeners:
                self._emit(EVT_MATCH, peer=peer, tag=hdr["tag"],
                           cid=hdr["cid"])
            self._match(req, peer, hdr, payload)
        elif kind == "unexpected":
            _, peer, hdr = act
            self._cv.notify_all()
            if self._listeners:
                self._emit(EVT_UNEXPECTED, peer=peer,
                           tag=hdr["tag"], cid=hdr["cid"])
        elif kind == "done":
            # native fast delivery: payload already memcpy'd into the
            # posted buffer — only status + completion remain
            _, req, peer, tag, count, nbytes = act
            if self._listeners:
                self._emit(EVT_MATCH, peer=peer, tag=tag, cid=req.cid)
                self._emit(EVT_DELIVER, peer=peer, tag=tag, cid=req.cid,
                           nbytes=nbytes)
            ov = req.source_override
            req.status.source = peer if ov is None else ov
            req.status.tag = tag
            req.status.count = count
            req.status.count_bytes = nbytes
            req.complete(req.buf)
        elif kind == "adeliver":
            # fast-lane frame matched an allocate-on-match recv: build
            # the array from the C-owned bytes via the normal deliver
            # (the synthetic header carries cid: _deliver's EVT_DELIVER
            # emit reads it when listeners are attached)
            _, req, peer, tag, payload, dtspec, shp = act
            if self._listeners:
                self._emit(EVT_MATCH, peer=peer, tag=tag, cid=req.cid)
            self._deliver(req, peer,
                          {"tag": tag, "cid": req.cid, "dt": dtspec,
                           "shp": list(shp)},
                          payload)
        elif kind == "rnack":  # ready-mode send found no posted recv
            _, peer, hdr = act
            self._enqueue_frame(peer, {"t": "rnack", "sid": hdr["sid"]},
                                b"", None)
        else:
            _log.error("unknown engine action %r", kind)

    def _match_incoming(self, peer: int, hdr: dict, payload: bytes) -> None:
        """Called with self._lock held: match one in-order frame."""
        m = self._matching_for(hdr["cid"])
        req = None
        for i, cand in enumerate(m.posted):
            if _hdr_matches(cand, peer, hdr):
                del m.posted[i]
                req = cand
                break
        if req is None:
            if hdr.get("sm") == "r":  # ready-mode: erroneous, nack sender
                self._enqueue_frame(peer,
                                    {"t": "rnack", "sid": hdr["sid"]}, b"",
                                    None)
                return
            # zero-copy self/proc payloads alias the sender's live buffer —
            # an unexpected frame must own its bytes (the sender is free to
            # modify once its request completes)
            if isinstance(payload, memoryview):
                payload = bytes(payload)
            m.unexpected.append((peer, hdr, payload))
            self._cv.notify_all()
            if self._listeners:
                self._emit(EVT_UNEXPECTED, peer=peer,
                           tag=hdr["tag"], cid=hdr["cid"])
        else:
            if self._listeners:
                self._emit(EVT_MATCH, peer=peer, tag=hdr["tag"],
                           cid=hdr["cid"])
            self._match(req, peer, hdr, payload)

    def _match(self, req: RecvRequest, peer: int, hdr: dict,
               payload: bytes) -> None:
        """Called with self._lock held. Eager: deliver now. Rndv: send CTS."""
        if hdr["t"] == "eager":
            if "sm" in hdr:  # sync/ready sender waits for the matched-ack
                self._enqueue_frame(peer,
                                    {"t": "sack", "sid": hdr["sid"]}, b"",
                                    None)
            self._deliver(req, peer, hdr, payload)
        else:  # rndv
            # fragments land directly in the user buffer when it is posted,
            # plan-collapsed (one run from offset 0 — contiguous layouts
            # and single-run derived types alike), and large enough (no
            # intermediate staging buffer)
            direct = False
            if (req.buf is not None and req.datatype is not None
                    and req.buf.flags["C_CONTIGUOUS"]
                    and req.buf.nbytes >= hdr["size"]):
                if req.datatype.committed:
                    # Uncommitted types fall to the staged path, whose
                    # unpack fails the request with the same error the
                    # send side raises.  Decide from the count=1 plan:
                    # N items collapse iff one item does AND items abut
                    # (extent == size), or count == 1.
                    p1 = req.datatype.pack_plan(1)
                    one_ok = p1.single_run and p1.start == 0
                    if req.count is not None:
                        direct = (one_ok
                                  and (req.count == 1
                                       or req.datatype.extent
                                       == req.datatype.size)
                                  and req.count * req.datatype.size
                                  >= hdr["size"])
                    else:
                        direct = (one_ok and req.datatype.extent
                                  == req.datatype.size)
            self._recv_states[req.rid] = _RecvState(
                req, hdr["size"], hdr, peer, direct=direct)
            # CTS is a tiny control frame; safe to enqueue (never inline-send
            # from a reader thread)
            self._enqueue_frame(peer,
                                {"t": "cts", "sid": hdr["sid"],
                                 "rid": req.rid},
                                b"", None)

    def _rndv_sink(self, hdr: dict, nbytes: int):
        """btl/tcp zero-copy landing hook: hand the poller the
        destination slice for an in-flight "data" frame's payload, or
        None (⇒ the btl stages the bytes and delivers normally)."""
        if hdr.get("t") != "data":
            return None
        with self._lock:
            state = self._recv_states.get(hdr.get("rid"))
            if state is None or not state.direct:
                return None
            off = hdr.get("off", 0)
            if (not isinstance(off, int) or off < 0
                    or off + nbytes > len(state.data)):
                return None   # malformed offset: staged path bounds it
            return state.data[off:off + nbytes]

    def _rndv_sink_done(self, hdr: dict, nbytes: int) -> None:
        """Completion half of _rndv_sink: the payload already sits in
        the user buffer, so account for it without a copy."""
        self._on_data(hdr, b"", landed=nbytes)

    def _on_data(self, hdr: dict, payload: bytes,
                 landed: Optional[int] = None) -> None:
        nbytes = len(payload) if landed is None else landed
        with self._lock:
            state = self._recv_states.get(hdr["rid"])
            if state is None:
                return
            off = hdr["off"]
            if landed is None:
                if state.direct:
                    state.data[off:off + nbytes] = \
                        np.frombuffer(payload, np.uint8)
                else:
                    state.data[off:off + nbytes] = payload
            state.received += nbytes
            done = state.received >= len(state.data)
            if done:
                del self._recv_states[hdr["rid"]]
        if done:
            if state.trace_t0 and trace_mod.active:
                _fl = state.src_hdr.get("fl", 0)
                _tc = state.src_hdr.get("tc")
                trace_mod.complete(
                    "pml", "rndv_recv", state.trace_t0, rank=self.rank,
                    peer=state.peer, nbytes=len(state.data),
                    direct=state.direct,
                    **({"fl": _fl} if _fl else {}),
                    **({"tc": _tc} if _tc is not None else {}))
            if state.direct:
                self._complete_direct(state)
            else:
                self._deliver(state.req, state.peer, state.src_hdr,
                              bytes(state.data))
            self._drain_events()

    def _complete_direct(self, state: _RecvState) -> None:
        """Fragments already landed in the user buffer; just finish."""
        req, hdr = state.req, state.src_hdr
        nbytes = len(state.data)
        if self._listeners:
            self._emit(EVT_DELIVER, peer=state.peer, tag=hdr["tag"],
                       cid=hdr["cid"], nbytes=nbytes)
        req.status.source = state.peer
        req.status.tag = hdr["tag"]
        req.status.count = nbytes // req.datatype.base_np.itemsize
        req.status.count_bytes = nbytes
        req.complete(req.buf)

    def _deliver(self, req: RecvRequest, peer: int, hdr: dict,
                 payload: bytes) -> None:
        """Unpack payload into the request's buffer and complete it."""
        # flow correlation: the recv half of an eager frame's arrow (the
        # rndv path records fl on its rndv_recv span instead)
        _fl = (hdr.get("fl", 0)
               if trace_mod.active and hdr.get("t") == "eager" else 0)
        _fl_t0 = trace_mod.begin() if _fl else 0
        datatype = req.datatype
        if datatype is not None and req.count is not None:
            expected = req.count * datatype.size
            if len(payload) > expected:
                req.status.source = peer
                req.status.tag = hdr["tag"]
                req.fail(MPIException(
                    f"message truncated: {len(payload)}B arrived, recv "
                    f"posted for {expected}B", error_class=ERR_TRUNCATE))
                return
        if req.buf is None:
            elem_np = (datatype.base_np if datatype is not None
                       else _wire_to_dtype(hdr["dt"]))
            n_elems = len(payload) // elem_np.itemsize
            out = np.frombuffer(
                bytearray(payload[:n_elems * elem_np.itemsize]),
                dtype=elem_np)
            # allocate-on-match receives recover the sender's array shape
            # from the header (predefined contiguous dtypes only; derived
            # datatypes keep the flat element stream; 0-d sends stay 1-D)
            shp = hdr.get("shp")
            if (datatype is None and shp
                    and math.prod(shp) == n_elems):
                out = out.reshape(shp)
        else:
            out = req.buf
            items = len(payload) // max(1, datatype.size)
            try:
                datatype.unpack(payload, out, items)
            except MPIException as e:
                # unpack validation (uncommitted type, bad sizing) runs
                # on a BTL receive thread — route it to the waiting recv
                # instead of killing the reader / hanging the request
                req.status.source = peer
                req.status.tag = hdr["tag"]
                req.fail(e)
                return
        if self._listeners:
            self._emit(EVT_DELIVER, peer=peer, tag=hdr["tag"],
                       cid=hdr["cid"], nbytes=len(payload))
        ov = req.source_override
        req.status.source = peer if ov is None else ov
        req.status.tag = hdr["tag"]
        elem_size = (datatype.base_np.itemsize if datatype is not None
                     else _wire_to_dtype(hdr["dt"]).itemsize)
        req.status.count = len(payload) // elem_size
        req.status.count_bytes = len(payload)
        req.complete(out)
        if _fl and trace_mod.active:
            _tc = hdr.get("tc")
            trace_mod.complete("pml", "eager_recv", _fl_t0,
                               rank=self.rank, peer=peer,
                               nbytes=len(payload), fl=_fl,
                               **({"tc": _tc} if _tc is not None
                                  else {}))

    # -- send worker (the only thread that writes payloads) ----------------

    def _enqueue_frame(self, peer, hdr, payload, req) -> None:
        """Queue one frame for the send worker, tracking the per-peer
        in-queue count: inline sendi must not run while ANY frame for the
        peer is still queued, or it would overtake it.  Uses its own lock —
        several callers already hold self._lock."""
        with self._qlock:
            self._queued[peer] = self._queued.get(peer, 0) + 1
            self._sendq.put(("frame", peer, hdr, payload, req))

    def _send_loop(self) -> None:
        frag = var_registry.get("pml_frag_size")
        while True:
            job = self._sendq.get()
            if job is None:
                return
            try:
                if job[0] == "frame":
                    _, peer, hdr, payload, req = job
                    with self._qlock:
                        n = self._queued.get(peer, 0)
                        if n > 1:
                            self._queued[peer] = n - 1
                        else:
                            self._queued.pop(peer, None)
                    self._deliver_frame(peer, hdr, payload, req)
                elif job[0] == "rndv_data":
                    _, state, rid = job
                    data = state.payload
                    _t0 = (trace_mod.begin()
                           if trace_mod.active or trace_mod.hist_active
                           else 0)
                    offs = list(range(0, len(data), frag))
                    for i, off in enumerate(offs):
                        last = i == len(offs) - 1
                        ok = self._deliver_frame(
                            state.peer,
                            {"t": "data", "rid": rid, "off": off},
                            data[off:off + frag],
                            state.req if last else None)
                        if not ok:
                            # a hole in the stream: the request must FAIL,
                            # not complete on a later fragment
                            if not last:
                                self._fail_req(state.req, MPIException(
                                    "rendezvous fragment could not be "
                                    "delivered"))
                            break
                    if _t0 and trace_mod.hist_active:
                        trace_mod.record_hist(
                            "pml_rndv_send_ns",
                            time.monotonic_ns() - _t0)
                    if _t0 and trace_mod.active:
                        trace_mod.complete(
                            "pml", "rndv_send", _t0, rank=self.rank,
                            peer=state.peer, nbytes=len(data),
                            fragments=len(offs),
                            **({"fl": state.fl, "tc":
                                trace_mod.trace_id()}
                               if state.fl else {}))
            except Exception:  # noqa: BLE001 — the worker must survive
                _log.error("send worker: unexpected error\n%s",
                           __import__("traceback").format_exc())

    def _deliver_frame(self, peer, hdr, payload, req) -> bool:
        """Send-worker delivery; a frame that cannot be routed fails its
        request (no park-and-heal retransmit in the port)."""
        try:
            self.endpoint.send(peer, hdr, payload)
        except Exception as e:  # noqa: BLE001 — must not kill the loop
            self._fail_req(req, e)
            return False
        self._complete_safely(req)
        return True

    def _complete_safely(self, req) -> None:
        """Completion callbacks are user-extensible — an exception there
        must not kill the singleton send worker."""
        if req is None:
            return
        try:
            req.complete(None)
        except Exception:  # noqa: BLE001
            _log.error("send-completion callback raised\n%s",
                       __import__("traceback").format_exc())

    def _fail_req(self, req, e) -> None:
        if req is not None:
            try:
                req.fail(e if isinstance(e, MPIException)
                         else MPIException(f"send failed: {e}"))
            except Exception:  # noqa: BLE001 — callbacks may raise
                _log.error("send-failure callback raised\n%s",
                           __import__("traceback").format_exc())

    def cancel_recv(self, req) -> None:
        """Dequeue a posted recv so a late frame can no longer complete
        it."""
        with self._lock:
            if self._eng is not None:
                self._eng.cancel(req.cid, req)
            else:
                m = self._matching.get(req.cid)
                if m is not None:
                    try:
                        m.posted.remove(req)
                    except ValueError:
                        pass
        req.cancel()

    # -- partitioned point-to-point (≈ MPI_Psend_init/Precv_init, MPI-4
    #    §4.2: partitions of one bound buffer published independently) ----

    def _part_offset(self, direction: str, peer: int, tag: int,
                     cid: int, partitions: int) -> int:
        """The n-th psend_init toward (peer, tag, cid) pairs with the
        peer's n-th precv_init from me — a local per-endpoint counter
        realises MPI's init-order matching rule with zero traffic.
        The counter is CUMULATIVE in partitions, so every init owns a
        disjoint block of partition slots in the wire-tag space even
        when channels on the same key use different partition counts
        (both sides must init in the same order with the same counts —
        the pairing contract)."""
        with self._lock:
            chans = self.__dict__.setdefault("_part_chan", {})
            key = (direction, peer, tag, cid)
            off = chans.get(key, 0)
            chans[key] = off + partitions
            return off

    def psend_init(self, buf, peer: int, tag: int, cid: int,
                   partitions: int) -> "PartitionedSendRequest":
        _reject_device(buf, "psend_init")   # before the channel counts
        return PartitionedSendRequest(
            self, buf, peer, tag, cid, partitions,
            offset=self._part_offset("send", peer, tag, cid, partitions))

    def precv_init(self, buf, peer: int, tag: int, cid: int,
                   partitions: int) -> "PartitionedRecvRequest":
        _reject_device(buf, "precv_init")
        return PartitionedRecvRequest(
            self, buf, peer, tag, cid, partitions,
            offset=self._part_offset("recv", peer, tag, cid,
                                     partitions))


# ---------------------------------------------------------------------------
# partitioned requests (MPI-4 §4.2)
# ---------------------------------------------------------------------------

# partition messages ride the reserved internal tag space far below the
# collective/nbc/OSC/neighbor windows (which bottom out around -1891):
# wire tag = BASE - tag·STRIDE - (cumulative offset + partition), so
# distinct user tags own disjoint STRIDE-wide blocks and distinct inits
# on one (peer, tag, cid) own disjoint partition-slot ranges — no two
# live partitioned operations can ever share a wire tag, and Pready
# order never matters
_PART_WIRE_BASE = -1_000_000
_PART_TAG_STRIDE = 1 << 24      # partition slots per user tag


class _PartitionedBase(PersistentRequest):
    """Shared half of psend/precv: one bound C-contiguous buffer split
    into ``partitions`` flat views (``np.array_split`` boundaries — the
    trailing partitions may be one element shorter), each riding the
    PML as an ordinary zero-copy message on its own derived wire tag.
    Sender and receiver must init channels on a (peer, tag) pair in
    the same order with the same partition counts (the pairing
    contract).  ``peer is None`` ⇒ the PROC_NULL inert form
    (everything trivially completes).  Start/wait/Startall compose
    exactly like any other persistent request."""

    def __init__(self, pml, buf, peer: Optional[int], tag: int, cid: int,
                 partitions: int, offset: int = 0,
                 kind: str = "partitioned") -> None:
        _reject_device(buf, f"{kind}_init")
        n = int(partitions)
        if n < 1:
            raise MPIException(f"{kind}_init: partitions must be >= 1 "
                               f"(got {partitions})")
        if offset + n > _PART_TAG_STRIDE:
            raise MPIException(
                f"{kind}_init: partition-slot space for tag {tag} "
                f"exhausted ({_PART_TAG_STRIDE} cumulative partitions "
                f"per (peer, tag) pair)")
        arr = np.asarray(buf)
        if not arr.flags["C_CONTIGUOUS"]:
            raise MPIException(
                f"{kind}_init: partitioned operations need a "
                f"C-contiguous buffer (partitions are zero-copy views)")
        self._pml = pml
        self._peer = peer
        self._tag = tag
        self._cid = cid
        self._npart = n
        self._off = int(offset)
        self._arr = arr
        self._parts = np.array_split(arr.reshape(-1), n)
        self._plock = threading.Lock()
        self._op: Optional[Request] = None
        self._preqs: list = [None] * n
        self._ndone = 0
        self._fail: Optional[BaseException] = None
        super().__init__(self._activate, kind=kind)

    def _ptag(self, i: int) -> int:
        return (_PART_WIRE_BASE - self._tag * _PART_TAG_STRIDE
                - (self._off + i))

    def _part_done(self, r: Request) -> None:
        op = self._op
        with self._plock:
            if getattr(r, "_exc", None) is not None \
                    and self._fail is None:
                self._fail = r._exc
            self._ndone += 1
            fire = self._ndone == self._npart
            fail = self._fail
        if fire and op is not None:
            if fail is not None:
                op.fail(fail)
            else:
                op.complete(self._result_value())

    def _result_value(self):
        return None


class PartitionedSendRequest(_PartitionedBase):
    """≈ MPI_Psend_init: start() activates (nothing moves), Pready(i)
    publishes partition i, wait() completes once every partition was
    readied AND sent.  Waiting with unready partitions raises (the MPI
    erroneous case, surfaced instead of hanging)."""

    def __init__(self, pml, buf, peer, tag, cid, partitions,
                 offset: int = 0) -> None:
        super().__init__(pml, buf, peer, tag, cid, partitions,
                         offset=offset, kind="psend")

    def _activate(self) -> Request:
        trace_mod.count("pml_partitioned_starts_total")
        with self._plock:
            self._readied = [False] * self._npart
            self._preqs = [None] * self._npart
            self._ndone = 0
            self._fail = None
        if self._peer is None:       # PROC_NULL: trivially complete
            self._op = None
            return CompletedRequest(None, kind="psend")
        self._op = Request(kind="psend-op")
        return self._op

    def pready(self, partition: int) -> None:
        """≈ MPI_Pready: partition ``partition`` of the bound buffer is
        final — send it (a zero-copy view rides the PML now)."""
        i = int(partition)
        if not 0 <= i < self._npart:
            raise MPIException(
                f"Pready: partition {i} out of range [0, {self._npart})")
        if self._inner is None:
            raise MPIException(
                "Pready on an inactive partitioned send (start() first)")
        with self._plock:
            if self._readied[i]:
                raise MPIException(
                    f"Pready: partition {i} already readied this start")
            self._readied[i] = True
        trace_mod.count("pml_partitioned_pready_total")
        if self._peer is None:
            return
        req = self._pml.isend(self._parts[i], self._peer, self._ptag(i),
                              self._cid)
        with self._plock:
            self._preqs[i] = req
        req.add_completion_callback(self._part_done)

    def pready_range(self, low: int, high: int) -> None:
        """≈ MPI_Pready_range (inclusive bounds, like the binding)."""
        for i in range(int(low), int(high) + 1):
            self.pready(i)

    def pready_list(self, partitions) -> None:
        """≈ MPI_Pready_list."""
        for i in partitions:
            self.pready(i)

    def wait(self, timeout: Optional[float] = None):
        if self._inner is not None and not self._inner.done():
            with self._plock:
                unready = self._npart - sum(self._readied)
            if unready:
                raise MPIException(
                    f"wait on a partitioned send with {unready} unready "
                    f"partition(s) — Pready them first (erroneous per "
                    f"MPI-4 §4.2.2, surfaced instead of hanging)")
        return super().wait(timeout=timeout)


class PartitionedRecvRequest(_PartitionedBase):
    """≈ MPI_Precv_init: start() posts every partition's receive into
    its zero-copy view of the bound buffer; Parrived(i) polls one
    partition; wait() returns the filled buffer."""

    def __init__(self, pml, buf, peer, tag, cid, partitions,
                 offset: int = 0) -> None:
        super().__init__(pml, buf, peer, tag, cid, partitions,
                         offset=offset, kind="precv")
        if not self._arr.flags.writeable:
            raise MPIException("precv_init: receive buffer is read-only")

    def _result_value(self):
        return self._arr

    def _activate(self) -> Request:
        trace_mod.count("pml_partitioned_starts_total")
        with self._plock:
            self._preqs = [None] * self._npart
            self._ndone = 0
            self._fail = None
        if self._peer is None:       # PROC_NULL: nothing will arrive
            self._op = None
            return CompletedRequest(self._arr, kind="precv")
        self._op = Request(kind="precv-op")
        for i in range(self._npart):
            req = self._pml.irecv(self._parts[i], self._peer,
                                  self._ptag(i), self._cid)
            with self._plock:
                self._preqs[i] = req
            req.add_completion_callback(self._part_done)
        return self._op

    def parrived(self, partition: int) -> bool:
        """≈ MPI_Parrived: has partition ``partition`` of the CURRENT
        operation landed?  True on an inactive request (the last
        operation delivered everything)."""
        i = int(partition)
        if not 0 <= i < self._npart:
            raise MPIException(
                f"Parrived: partition {i} out of range "
                f"[0, {self._npart})")
        if self._inner is None or self._peer is None:
            return True
        with self._plock:
            req = self._preqs[i]
        return req is not None and req.done()

    def cancel(self) -> None:
        with self._plock:
            reqs = [r for r in self._preqs if r is not None]
        for r in reqs:
            r.cancel()
        super().cancel()

    def _abandon(self) -> None:
        # Startall rollback: the posted partition irecvs must be
        # DEQUEUED, not just flagged — left behind they would be
        # FIFO-first on their wire tags and swallow the next
        # activation's partitions (wait() would then hang forever)
        with self._plock:
            reqs = [r for r in self._preqs if r is not None]
            self._preqs = [None] * self._npart
        for r in reqs:
            self._pml.cancel_recv(r)
        self._op = None
        super()._abandon()


@pml_framework.component
class Ob1Component(Component):
    """Default PML (named for its ancestor, ompi/mca/pml/ob1)."""

    NAME = "ob1"
    PRIORITY = 50

    def create(self, rank: int) -> PmlOb1:
        return PmlOb1(rank)
