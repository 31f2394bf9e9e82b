"""BTL — byte transfer layer for the host path (the port's copy of the JAX
package's ``mpi/btl.py``).

≈ opal/mca/btl (btl.h:1170-1228; send :891): moves opaque frames between
ranks.  The PML above it owns MPI semantics (matching, protocols); a BTL just
delivers (header, payload) frames reliably and in order per sender.

Components:
- ``tcp``  — sockets between ranks; addresses exchanged via the PMIx modex
  (the reference's btl/tcp + business-card flow).  Each rank dials peers
  lazily and uses dialed connections for sending only; inbound connections
  (identified by a hello frame) are receive-only.  Two simplex pipes per pair
  avoid connection races entirely.
- ``shm``  — shared-memory rings for same-host peers in other processes
  (``mpi/btl_shm.py``, ≈ btl/vader); a frame larger than half a ring
  (``FrameTooBig``) rides tcp instead, and a ring whose receiver died
  (``PeerDeadError``) is dropped.
- ``self`` — loopback fast path (≈ btl/self): frames to one's own rank are
  delivered by direct callback, no sockets.
- ``proc`` — same-address-space direct delivery: ranks on threads of one
  process (the test harness) hand a frame to the peer's handler in one call.

btl/tcp has two data planes over the same sockets and the same wire format
(4-byte total length, 4-byte header length, DSS header, raw payload): the
pure-Python plane (one ``sendmsg`` per frame, one reader thread per
accepted connection) and the native plane of ``_native/net.c``
(``btl_tcp_native``, on when it built: per-peer submission rings drained
by one writer thread in GIL-released batched ``sendmsg`` calls, one parked
poller across every connection, rendezvous payloads landed straight into
the receive buffer, and receiver-pull progress for a blocked recv).

The trace plane's sites are the JAX package's: the ``send`` and
``send_inline`` instants, the tcp plane's ``btl_tcp_native_*_total``
counters (writes, batched frames, parks) and its ``btl_tcp_write_ns``
histogram.  The fault-tolerance sites are the JAX package's too: the
fault injector's frame hook at the endpoint (``send`` and
``try_send_inline``, so every transport below it, python or native tcp,
the shm rings and proc, carries the same verdicts), the ``ft_check``
contract the native tcp plane re-runs between bounded parks, and the
endpoint's ``rebind`` to a respawned peer's new card.  Identity aliasing
(``set_alias``, for dynamic process management's translated ids) is the
JAX package's too: a tcp hello, a proc frame and a proc fast-lane frame
name the sender by the id the peer knows it by, and a shm ring carries
that id in its header (``mpi/btl_shm.py``).

Device buffers never travel through a BTL: the device path is the bound
``DeviceCommunicator`` (NCCL on the card).
"""

from __future__ import annotations

import collections
import ctypes
import errno
import os
import select
import socket
import struct
import threading
import time
from typing import Callable, Optional

import numpy as np

from ompi_tpu_torch.core import dss
from ompi_tpu_torch.core.config import VarType, register_var, var_registry
from ompi_tpu_torch.core.mca import Component, Framework
from ompi_tpu_torch.mpi import trace as trace_mod
from ompi_tpu_torch.mpi.constants import MPIException

__all__ = ["btl_framework", "TcpBTL", "SelfBTL", "ProcBTL",
           "ShmBTLComponent", "BtlEndpoint"]

btl_framework = Framework("btl", "byte transfer layer")

register_var("btl", "tcp_sndbuf", VarType.SIZE, 0,
             "SO_SNDBUF for btl/tcp sockets (0 = OS default)")
register_var("btl", "tcp_rcvbuf", VarType.SIZE, 0,
             "SO_RCVBUF for btl/tcp sockets (0 = OS default)")
register_var("btl", "tcp_native", VarType.BOOL, True,
             "use the native GIL-released tcp plane (submission-ring "
             "writer + parked poller) when _native/net.c built; read "
             "per call, so flipping mid-run moves traffic between "
             "planes frame-by-frame")
register_var("btl", "tcp_ring_bytes", VarType.SIZE, 4 << 20,
             "per-peer submission-ring byte cap: senders park "
             "(GIL-released, in bounded slices) while a peer's "
             "unsent backlog sits above this")
register_var("btl", "tcp_pull", VarType.BOOL, (os.cpu_count() or 1) > 2,
             "receiver-pull progress (opal_progress style): a blocked "
             "recv waiter drains its own sockets via TcpBTL.progress() "
             "instead of sleeping on the poller's wake; wins when "
             "waiter and poller run on separate cores, loses on tiny "
             "hosts where the dual poll() wakeups just thrash")
register_var("btl", "tcp_copy_limit", VarType.SIZE, 64 << 10,
             "payload views at or below this are copied into the ring "
             "entry so send() returns immediately; larger views ride "
             "zero-copy and the sender parks until the writer drains "
             "them (buffer-reuse safety, = the eager size in practice)")

#: native-plane slice bounds — every GIL-released park is bounded and
#: the Python checks (stop flag, errors) re-run between slices (Arena's
#: discipline applied to the inter-node transport)
_PARK_SLICE_NS = 1_000_000        # sender backpressure / writer doorbell
_WRITER_IDLE_NS = 20_000_000      # writer idle park (futex-woken anyway)
_POLL_SLICE_NS = 50_000_000       # receive poller (poll() wakes on data)
_WRITE_SLICE_NS = 20_000_000      # one writev drain call's POLLOUT bound
_LAND_SLICE_NS = 20_000_000       # one rndv direct-landing recv bound
_SCAN_MAX = 128                   # frames per native framing scan
#: burst detector for the opportunistic same-thread write: >= _BURST_MIN
#: consecutive sends to one peer each < _BURST_GAP_NS apart are a burst
#: and route through the submission ring (batched writev amortizes the
#: syscalls); lone sends (the pingpong latency path — inter-send gap is
#: a full RTT, >= ~150us through the PML) write directly on the calling
#: thread, skipping the writer-thread hop entirely
_BURST_GAP_NS = 100_000
_BURST_MIN = 4
_CONN_BUF = 256 << 10             # per-connection staging buffer
#: a trailing partial frame at least this big lands straight into its
#: destination (rndv fragments); smaller ones (eager frames) finish in
#: the staging buffer — must stay below _CONN_BUF or staging deadlocks
_LAND_MIN = 96 << 10


#: biggest frame sent through the GIL-held (PyDLL) crossing — must fit
#: the default sndbuf so the nonblocking sendmsg all but never EAGAINs
#: while holding the interpreter
_NOGIL_MAX = 256 << 10


def _net_lib():
    """The native network executor, or None (pure-python plane)."""
    from ompi_tpu_torch import _native

    return _native.net()


def _net_nogil_lib():
    """The GIL-held (PyDLL) handle to the same library — small-frame
    send3 only, always called with slice_ns=0 (never blocks)."""
    from ompi_tpu_torch import _native

    return _native.net_nogil()


def _park_lib():
    """The arena executor whose futex waits back the ring doorbells."""
    from ompi_tpu_torch import _native

    return _native.arena()

# frame = 4B LE total length | 4B LE header length | DSS(header dict) |
# raw payload (not DSS-wrapped, to avoid copying large buffers through the
# serializer)

OnFrame = Callable[[int, dict, bytes], None]


def _send_all(sock: socket.socket, *parts) -> None:
    """Scatter-gather send: no join copy of the payload (a rendezvous
    fragment is ~1MiB — the old b''.join doubled its memory traffic).
    Falls back across partial sends by re-slicing the iovec."""
    iov = [memoryview(p).cast("B") for p in parts if len(p)]
    while iov:
        try:
            sent = sock.sendmsg(iov)
        except AttributeError:  # platform without sendmsg
            sock.sendall(b"".join(iov))
            return
        # drop fully-sent buffers, trim the partial one
        while iov and sent >= len(iov[0]):
            sent -= len(iov[0])
            iov.pop(0)
        if iov and sent:
            iov[0] = iov[0][sent:]


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytearray]:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], min(1 << 20, n - got))
        if not k:
            return None
        got += k
    return buf


class _TxRing:
    """Per-peer submission ring: senders append (prefix, header,
    payload) iovec descriptors; the writer thread drains the whole
    backlog in batched GIL-released sendmsg calls.  ``ctr`` is the
    drained-ticket counter — a u64 futex word parked senders wait on
    (ring-full backpressure and zero-copy buffer-reuse waits)."""

    __slots__ = ("mu", "entries", "pending_bytes", "enq", "ctr",
                 "ctr_addr", "error", "last_send", "burst_n")

    def __init__(self) -> None:
        self.mu = threading.Lock()
        # (parts tuple, nbytes, ticket, cid) — parts are the wire
        # segments in order; cid rides along for mid-park FT checks
        self.entries: collections.deque = collections.deque()
        self.pending_bytes = 0
        self.enq = 0                       # tickets issued
        self.ctr = (ctypes.c_uint64 * 1)()  # tickets drained (futex word)
        self.ctr_addr = ctypes.addressof(self.ctr)
        self.error: Optional[BaseException] = None
        self.last_send = 0                 # monotonic ns, burst detector
        self.burst_n = 0                   # consecutive close-gap sends

    def in_burst(self) -> bool:
        """Update the burst detector with this send; True ⇒ route via
        the ring/writer (batch), False ⇒ direct write is the win.
        Racy by design (monotonic per caller is enough — a miscount
        just routes one frame the other way)."""
        now = time.monotonic_ns()
        if now - self.last_send < _BURST_GAP_NS:
            self.burst_n += 1
        else:
            self.burst_n = 0
        self.last_send = now
        return self.burst_n >= _BURST_MIN


class _Conn:
    """One accepted (receive-only) connection's poller state: a fixed
    staging buffer (never resized — its address is pinned for the
    native reads) plus the in-flight direct-landing frame, if any."""

    __slots__ = ("sock", "fd", "peer", "buf", "mv", "addr", "used",
                 "pending")

    def __init__(self, sock: socket.socket) -> None:
        from ompi_tpu_torch import _native

        self.sock = sock
        self.fd = sock.fileno()
        self.peer = -1
        self.buf = bytearray(_CONN_BUF)
        self.mv = memoryview(self.buf)
        self.addr = _native.addr_of(self.mv)
        self.used = 0
        # [hdr, dst memoryview, dst addr, filled, payload_len, staged]
        self.pending: Optional[list] = None


class TcpBTL:
    """TCP frame transport between the ranks of one job.

    Two data planes over the SAME sockets and the same wire format:

    - the pure-python plane: per-frame ``sendmsg`` under the GIL on the
      send side, one ``_read_loop`` thread per accepted connection on
      the receive side (the pre-native behavior, kept bit-identical);
    - the native plane (``btl_tcp_native``, default on when
      ``_native/net.c`` builds): senders enqueue onto per-peer
      submission rings and a single writer thread drains whole backlogs
      in GIL-released batched ``sendmsg`` calls, while a single parked
      poller replaces every reader thread with one GIL-released
      ``poll()`` — length-prefix framing parsed natively and oversize
      (rendezvous) payloads landed straight into the plan-registered
      buffer via ``recv_sink``.

    The var is re-read per call, so the planes can be flipped
    frame-by-frame inside a live world; ``OMPI_TPU_NO_NATIVE=1`` or a
    missing toolchain pins the python plane at construction.
    """

    def __init__(self, rank: int, on_frame: OnFrame,
                 host: str = "127.0.0.1") -> None:
        self.rank = rank
        self.on_frame = on_frame
        self._listener = socket.create_server((host, 0), backlog=64)
        self._addr = f"{host}:{self._listener.getsockname()[1]}"
        self._out: dict[int, socket.socket] = {}
        self._out_locks: dict[int, threading.Lock] = {}
        self._peers: dict[int, str] = {}
        self._alias: dict[int, int] = {}  # peer → my id in peer's namespace
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        # -- native-plane state --------------------------------------------
        self._native_ok = _net_lib() is not None
        # handles cached per-instance: the per-send import-machinery
        # lookup is measurable on the latency path
        self._net_h = _net_lib()
        self._net_ng = _net_nogil_lib() if self._native_ok else None
        self._rings: dict[int, _TxRing] = {}
        self._svc_mu = threading.Lock()   # one conn servicer at a time
        #: count of recv-waiters currently pulling (progress()); while
        #: nonzero the poller parks on the wake pipe only — two threads
        #: parked in poll() on the SAME fds would both wake per frame
        #: and thrash the interpreter on small hosts
        self.pull_depth = 0
        self._wctr = (ctypes.c_uint64 * 1)()   # writer doorbell futex word
        self._wctr_addr = ctypes.addressof(self._wctr)
        self._wlock = threading.Lock()
        self._writer: Optional[threading.Thread] = None
        self._writer_parked = False        # doorbell-syscall elision
        self._conns: list[_Conn] = []
        self._poller: Optional[threading.Thread] = None
        self._wake_r = self._wake_w = -1       # poller wake pipe (lazy)
        self._scan_out = (ctypes.c_uint64 * (3 * _SCAN_MAX))()
        self._scan_addr = ctypes.addressof(self._scan_out)
        # FT contract + zero-copy landing hooks, installed by the owning
        # PmlFT / PML (None ⇒ stop-flag-only parks, staged landing)
        self.ft_check: Optional[Callable[[int, Optional[int]], None]] = None
        self.recv_sink: Optional[Callable[[dict, int], object]] = None
        self.recv_sink_done: Optional[Callable[[dict, int], None]] = None
        t = threading.Thread(target=self._accept_loop, name=f"btl-accept-{rank}",
                             daemon=True)
        t.start()
        self._threads.append(t)

    @property
    def address(self) -> str:
        """The business card to publish in the modex."""
        return self._addr

    def set_peers(self, peers: dict[int, str]) -> None:
        """Install the modex results: world rank → address."""
        with self._lock:
            self._peers.update(peers)

    def set_alias(self, peer: int, my_id: int) -> None:
        """Announce myself to `peer` as `my_id` instead of my own rank.

        Needed by dynamic process management: two independently-launched
        jobs each number their ranks from 0, so a connected job's procs
        are installed under translated ids (offset past the local world)
        — and must introduce themselves under that translated id when
        dialing (the hello frame is what the acceptor keys frames by, on
        the python plane and the native one alike).
        """
        with self._lock:
            self._alias[peer] = my_id

    # -- sending -----------------------------------------------------------

    def send(self, peer: int, header: dict, payload: bytes = b"") -> None:
        """Deliver one frame to `peer`. Blocking on socket backpressure;
        in-order per (self → peer)."""
        sock, lock = self._peer_sock(peer)
        hdr = dss.pack(header)
        total = len(hdr) + len(payload)
        prefix = struct.pack("<II", total, len(hdr))
        if self._native_ok and var_registry.get("btl_tcp_native"):
            self._send_native(peer, header.get("cid"), prefix, hdr,
                              payload, sock, lock)
            return
        with lock:
            # FIFO across plane flips: anything the native plane still
            # holds for this peer goes out first, under the same lock
            self._flush_ring_locked(peer, sock)
            _send_all(sock, prefix, hdr, payload)

    def try_send(self, peer: int, header: dict,
                 payload: bytes = b"") -> bool:
        """Nonblocking inline enqueue onto the native submission ring
        (≈ btl_sendi): True ⇒ the frame is queued for the writer and the
        caller's buffer is immediately reusable (bytes ride as-is, small
        views are copied).  False ⇒ no native plane, no live socket yet
        (dialing blocks), ring full, or an oversize view — the caller
        takes the worker path."""
        if not self._native_ok or not var_registry.get("btl_tcp_native"):
            return False
        nbytes = len(payload)
        with self._lock:
            if peer not in self._out:
                return False
        ring = self._ring(peer)
        hdr = dss.pack(header)
        prefix = struct.pack("<II", len(hdr) + nbytes, len(hdr))
        parts = (prefix, hdr, payload) if nbytes else (prefix, hdr)
        if not ring.in_burst():
            # synchronous write ⇒ no copy needed even for views: the
            # caller's buffer is back in its hands before we return
            done = self._direct_write(peer, ring, parts,
                                      raise_errors=False)
            if done is not None:
                return done
        # ring path: the entry outlives this call, so views need an
        # owned copy (bounded by copy_limit; bigger views park in
        # send(), which inline must not)
        if nbytes and not isinstance(payload, bytes):
            if nbytes > int(var_registry.get("btl_tcp_copy_limit") or 0):
                return False
            payload = bytes(payload)
            parts = (prefix, hdr, payload)
        nb = 8 + len(hdr) + nbytes
        cap = int(var_registry.get("btl_tcp_ring_bytes") or (4 << 20))
        with ring.mu:
            if ring.error is not None:
                return False   # worker path surfaces the failure
            if ring.entries and ring.pending_bytes + nb > cap:
                return False
            ring.enq += 1
            ring.entries.append((parts, nb, ring.enq,
                                 header.get("cid")))
            ring.pending_bytes += nb
        self._kick_writer()
        return True

    def _direct_write(self, peer: int, ring: _TxRing, parts,
                      raise_errors: bool, cid: Optional[int] = None,
                      sl=None) -> Optional[bool]:
        """Opportunistic same-thread drain — the latency path.  When
        the peer's ring is idle and the out lock is free, the frame
        goes on the wire right here in GIL-released writev calls: no
        writer-thread hop, no doorbell, exactly the python plane's
        blocking cost minus the GIL and the join copy.

        Returns True (frame fully written), False (socket error — the
        ring is failed; with raise_errors the error raises instead),
        or None (contended / ring busy: the caller enqueues)."""
        net = self._net_h
        if sl is not None:
            sock, lock = sl
        else:
            with self._lock:
                sock = self._out.get(peer)
                lock = self._out_locks.get(peer)
        if sock is None or lock is None or not lock.acquire(
                blocking=False):
            return None
        try:
            with ring.mu:
                if ring.error is not None or ring.entries:
                    return None   # FIFO: queued frames must go first
            _h_t0 = time.monotonic_ns() if trace_mod.hist_active else 0
            fd = sock.fileno()
            # fast path: the whole frame in ONE ctypes crossing —
            # send3 takes the three buffers as pointer args (bytes
            # pass straight through c_void_p; only non-bytes payloads
            # need a Python-side address), so there is no per-frame
            # iovec marshalling at all
            pay = parts[2] if len(parts) == 3 else b""
            if type(pay) is bytes:
                parg, _keep = pay, None
            elif len(pay):
                _keep = np.frombuffer(pay, np.uint8)
                parg = _keep.ctypes.data
            else:
                parg, _keep = None, None
            total = len(parts[0]) + len(parts[1]) + len(pay)
            # small frames: GIL-HELD crossing (PyDLL, slice 0 so the C
            # side can never poll) — the MSG_DONTWAIT sendmsg is ~2us,
            # and releasing the GIL for it lets the peer's just-woken
            # poller steal the interpreter, costing the sender a whole
            # dispatch pass to get it back
            w = 0
            ng = (self._net_ng if total <= _NOGIL_MAX else None)
            if ng is not None:
                w = ng.ompi_tpu_net_send3(
                    fd, parts[0], len(parts[0]), parts[1],
                    len(parts[1]), parg, len(pay), 0)
            if w == 0:   # big frame, no PyDLL, or instant EAGAIN
                w = net.ompi_tpu_net_send3(
                    fd, parts[0], len(parts[0]), parts[1],
                    len(parts[1]), parg, len(pay), _WRITE_SLICE_NS)
            if w == total:
                trace_mod.count("btl_tcp_native_writes_total")
                trace_mod.count("btl_tcp_native_batched_frames_total")
                if _h_t0:
                    trace_mod.record_hist(
                        "btl_tcp_write_ns", time.monotonic_ns() - _h_t0)
                return True
            if w < 0:
                err = OSError(-w, f"{os.strerror(-w)} "
                              "(native direct write)")
                self._fail_ring(ring, err)
                if raise_errors:
                    raise err
                return False
            if w == 0:
                return None   # not writable at all: ring + writer
            # partial frame on the wire: committed — resume through the
            # iovec loop below until complete (torn frames desync)
            keep = [np.frombuffer(p, np.uint8) for p in parts if len(p)]
            flat = [(v.ctypes.data, v.nbytes) for v in keep]
            written = w
            calls = 1
            idx = off = 0
            adv = w
            while idx < len(flat) and adv >= flat[idx][1]:
                adv -= flat[idx][1]
                idx += 1
            off = adv
            while written < total:
                n = len(flat) - idx
                pa = (ctypes.c_uint64 * (2 * n))()
                k = 0
                for a, ln in flat[idx:]:
                    pa[k] = a
                    pa[k + 1] = ln
                    k += 2
                pa[0] += off
                pa[1] -= off
                w = net.ompi_tpu_net_writev(fd, pa, n, _WRITE_SLICE_NS)
                if w < 0:
                    err = OSError(-w, f"{os.strerror(-w)} "
                                  "(native direct write)")
                    self._fail_ring(ring, err)
                    if raise_errors:
                        raise err
                    return False
                if w > 0:
                    calls += 1
                    written += w
                    off += w
                    while idx < len(flat) and off >= flat[idx][1]:
                        off -= flat[idx][1]
                        idx += 1
                    continue
                if written == 0:
                    return None   # not writable at all: ring + writer
                # mid-frame backpressure: the frame MUST complete (a
                # torn frame desyncs the stream) — park bounded, re-run
                # the FT contract, and on abandonment kill the socket
                # so the receiver sees EOF instead of a desynced stream
                trace_mod.count("btl_tcp_native_parks_total")
                if self._stop.is_set():
                    err = ConnectionError("endpoint closed mid-write")
                    self._fail_ring(ring, err)
                    try:
                        sock.close()
                    except OSError:
                        pass
                    if raise_errors:
                        raise err
                    return False
                ft = self.ft_check
                if ft is not None:
                    try:
                        ft(peer, cid)
                    except BaseException:
                        self._fail_ring(ring, ConnectionError(
                            "FT verdict mid-write"))
                        try:
                            sock.close()
                        except OSError:
                            pass
                        if raise_errors:
                            raise
                        return False
            del keep
            trace_mod.count("btl_tcp_native_writes_total", calls)
            trace_mod.count("btl_tcp_native_batched_frames_total")
            if _h_t0:
                trace_mod.record_hist("btl_tcp_write_ns",
                                      time.monotonic_ns() - _h_t0)
            return True
        finally:
            lock.release()

    def _send_native(self, peer: int, cid: Optional[int], prefix: bytes,
                     hdr: bytes, payload, sock=None, lock=None) -> None:
        """Ring enqueue with the buffer-reuse contract: bytes payloads
        are immutable and ride as-is (send returns immediately — the
        batching win); small views are copied into the entry; large
        views ride zero-copy and the sender parks until its drained
        ticket is reached, FT-checked between bounded slices."""
        nbytes = len(payload)
        ring = self._ring(peer)
        parts = (prefix, hdr, payload) if nbytes else (prefix, hdr)
        if not ring.in_burst():
            # lone send (not part of a burst): write on THIS thread —
            # the pingpong latency path.  Synchronous, so views of any
            # size go zero-copy with no drain wait.
            if self._direct_write(peer, ring, parts, raise_errors=True,
                                  cid=cid,
                                  sl=(sock, lock) if lock else None):
                return
        await_drain = False
        if nbytes and not isinstance(payload, bytes):
            if nbytes <= int(var_registry.get("btl_tcp_copy_limit") or 0):
                payload = bytes(payload)
                parts = (prefix, hdr, payload)
            else:
                await_drain = True
        cap = int(var_registry.get("btl_tcp_ring_bytes") or (4 << 20))
        nb = len(prefix) + len(hdr) + nbytes
        while True:
            with ring.mu:
                if ring.error is not None:
                    raise ConnectionError(
                        f"btl/tcp: native ring to rank {peer} failed "
                        f"({ring.error})")
                # always admit at least one frame: a single frame above
                # the cap must not deadlock against an empty ring
                if not ring.entries or ring.pending_bytes + nb <= cap:
                    ring.enq += 1
                    ticket = ring.enq
                    ring.entries.append((parts, nb, ticket, cid))
                    ring.pending_bytes += nb
                    break
                seen = ring.ctr[0]
            self._park_ring(peer, cid, ring, seen)   # ring full
        self._kick_writer()
        if not await_drain:
            return
        while True:   # zero-copy view: reusable only once on the wire
            with ring.mu:
                if ring.error is not None:
                    raise ConnectionError(
                        f"btl/tcp: native ring to rank {peer} failed "
                        f"({ring.error})")
                seen = ring.ctr[0]
            if seen >= ticket:
                return
            self._park_ring(peer, cid, ring, seen)

    def _park_ring(self, peer: int, cid: Optional[int], ring: _TxRing,
                   seen: int) -> None:
        """One bounded GIL-released park on the ring's drained counter,
        then the stop-flag check and the full Python FT contract —
        Arena._wait's discipline on the send side."""
        ar = _park_lib()
        if ar is not None:
            ar.ompi_tpu_arena_wait_change(ring.ctr_addr, seen, 0,
                                          _PARK_SLICE_NS)
        else:
            time.sleep(0.0005)
        trace_mod.count("btl_tcp_native_parks_total")
        if self._stop.is_set():
            raise ConnectionError("btl/tcp: endpoint closed mid-send")
        ft = self.ft_check
        if ft is not None:
            ft(peer, cid)

    def drop_ring(self, peer: int) -> None:
        """Rebind/teardown path: fail and forget the peer's submission
        ring — parked senders wake into ConnectionError (the PML's
        park-and-heal classes), and the next send to the peer's new
        incarnation starts a fresh ring."""
        with self._lock:
            ring = self._rings.pop(peer, None)
        if ring is not None:
            self._fail_ring(ring, ConnectionError("peer rebound"))

    def _ring(self, peer: int) -> _TxRing:
        with self._lock:
            ring = self._rings.get(peer)
            if ring is None:
                ring = self._rings[peer] = _TxRing()
            return ring

    def _fail_ring(self, ring: _TxRing, exc: BaseException) -> None:
        """Pending frames die the way bytes in a dead kernel buffer die;
        parked senders wake (counter bump breaks the wait-for-change)
        and surface ConnectionError — the same class the python plane's
        broken socket raises, so the PML heal ladder is shared."""
        with ring.mu:
            if ring.error is None:
                ring.error = exc
            ring.entries.clear()
            ring.pending_bytes = 0
            ring.ctr[0] += 1   # break wait_change parks; error is sticky
        self._wake_ring(ring)

    def _wake_ring(self, ring: _TxRing) -> None:
        ar = _park_lib()
        if ar is not None:
            ar.ompi_tpu_arena_wake(ring.ctr_addr, 0)

    def _kick_writer(self) -> None:
        if self._writer is None:
            with self._lock:
                if self._writer is None and not self._stop.is_set():
                    t = threading.Thread(target=self._writer_loop,
                                         name=f"btl-writer-{self.rank}",
                                         daemon=True)
                    self._writer = t
                    t.start()
                    self._threads.append(t)
        with self._wlock:
            self._wctr[0] += 1
            parked = self._writer_parked
        if parked:   # a busy writer re-reads the doorbell lock-free
            ar = _park_lib()
            if ar is not None:
                ar.ompi_tpu_arena_wake(self._wctr_addr, 0)

    def _flush_ring_locked(self, peer: int, sock: socket.socket) -> None:
        """Python-plane prelude, under the per-peer out lock the writer
        also drains under: anything still in the peer's submission ring
        hits the wire BEFORE this frame, so a mid-run plane flip never
        reorders a sender's stream."""
        ring = self._rings.get(peer)
        if ring is None:
            return
        while True:
            with ring.mu:
                if ring.error is not None or not ring.entries:
                    return
                parts, nb, ticket, _cid = ring.entries.popleft()
                ring.pending_bytes -= nb
            try:
                _send_all(sock, *parts)
            except OSError as e:
                self._fail_ring(ring, e)
                raise
            with ring.mu:
                if ring.error is None:
                    ring.ctr[0] = ticket
            self._wake_ring(ring)

    def _writer_loop(self) -> None:
        """The single native writer: sweeps every peer's submission
        ring, draining whole backlogs in batched GIL-released sendmsg
        calls, and parks on the doorbell futex when idle.  Missed-wakeup
        guard: the doorbell count is captured BEFORE the sweep, so an
        enqueue racing the park bumps the word past ``seen`` and the
        wait returns immediately."""
        from ompi_tpu_torch import _native

        net = _net_lib()
        ar = _park_lib()
        spins = _native.PARK_SPINS
        while not self._stop.is_set():
            with self._wlock:
                seen = self._wctr[0]
            with self._lock:
                rings = list(self._rings.items())
            progressed = False
            backlogged = False
            for peer, ring in rings:
                if ring.entries and ring.error is None:
                    if self._drain_ring(peer, ring, net):
                        progressed = True
                    if ring.entries and ring.error is None:
                        backlogged = True
            if progressed or backlogged:
                # a backlogged peer's drain already parked in POLLOUT
                # inside the native call — no doorbell wait on top
                continue
            with self._wlock:
                self._writer_parked = True
                cur = self._wctr[0]
            if cur != seen:   # a ring was kicked mid-sweep: re-sweep
                self._writer_parked = False
                continue
            if ar is not None:
                ar.ompi_tpu_arena_wait_change(self._wctr_addr, seen,
                                              spins, _WRITER_IDLE_NS)
            else:
                time.sleep(0.0005)
            self._writer_parked = False
            trace_mod.count("btl_tcp_native_parks_total")

    def _drain_ring(self, peer: int, ring: _TxRing, net) -> bool:
        """Drain one peer's backlog under the per-peer out lock (the
        python plane's send path takes the same lock, so the two planes
        never interleave mid-frame).  Returns True when bytes moved."""
        with self._lock:
            sock = self._out.get(peer)
            lock = self._out_locks.get(peer)
        if sock is None or lock is None:
            # enqueue raced a close: entries die with the ring
            self._fail_ring(ring, ConnectionError("socket dropped"))
            return False
        if not lock.acquire(timeout=0.05):
            return False   # python-plane send in flight; next sweep
        try:
            with ring.mu:
                batch = list(ring.entries)
            if not batch:
                return False
            # scatter-gather list: ≤ 3 iovecs per frame; numpy views
            # give zero-copy addresses for read-only bytes too
            keep = []       # buffer refs pinned for the native call
            flat = []
            for parts, _nb, _ticket, _cid in batch:
                for p in parts:
                    if len(p):
                        v = np.frombuffer(p, np.uint8)
                        keep.append(v)
                        flat.append((v.ctypes.data, v.nbytes))
            total = sum(ln for _a, ln in flat)
            _h_t0 = time.monotonic_ns() if trace_mod.hist_active else 0
            written = 0
            calls = 0
            idx = 0         # first not-fully-written iovec
            off = 0         # bytes of flat[idx] already written
            fd = sock.fileno()
            while written < total:
                n = len(flat) - idx
                pa = (ctypes.c_uint64 * (2 * n))()
                k = 0
                for a, ln in flat[idx:]:
                    pa[k] = a
                    pa[k + 1] = ln
                    k += 2
                pa[0] += off
                pa[1] -= off
                w = net.ompi_tpu_net_writev(fd, pa, n, _WRITE_SLICE_NS)
                if w < 0:
                    self._fail_ring(ring, OSError(
                        -w, f"{os.strerror(-w)} (native writev)"))
                    return written > 0
                if w > 0:
                    calls += 1
                    written += w
                    off += w
                    while idx < len(flat) and off >= flat[idx][1]:
                        off -= flat[idx][1]
                        idx += 1
                    continue
                # slice expired without progress (peer backpressure):
                # re-run the FT contract, then wait again
                trace_mod.count("btl_tcp_native_parks_total")
                if self._stop.is_set():
                    self._fail_ring(ring, ConnectionError(
                        "endpoint closed mid-drain"))
                    return written > 0
                ft = self.ft_check
                if ft is not None:
                    try:
                        ft(peer, None)
                    except Exception as e:  # noqa: BLE001 — FT verdict
                        self._fail_ring(ring, e)
                        return written > 0
            del keep
            # the whole batch is on the wire: retire + publish tickets
            with ring.mu:
                last = 0
                for _parts, nb, ticket, _cid in batch:
                    if not ring.entries:
                        break   # a concurrent _fail_ring cleared us
                    ring.entries.popleft()
                    ring.pending_bytes -= nb
                    last = ticket
                if last and ring.error is None:
                    ring.ctr[0] = last
            self._wake_ring(ring)
            trace_mod.count("btl_tcp_native_writes_total", calls)
            trace_mod.count("btl_tcp_native_batched_frames_total",
                            len(batch))
            if _h_t0:
                trace_mod.record_hist("btl_tcp_write_ns",
                                      time.monotonic_ns() - _h_t0)
            return True
        finally:
            lock.release()

    def _peer_sock(self, peer: int) -> tuple[socket.socket, threading.Lock]:
        with self._lock:
            sock = self._out.get(peer)
            if sock is not None:
                return sock, self._out_locks[peer]
            addr = self._peers.get(peer)
        if addr is None:
            raise ConnectionError(
                f"btl/tcp: no address for rank {peer} (modex incomplete)")
        host, port = addr.rsplit(":", 1)
        sock = socket.create_connection((host, int(port)))
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        for opt, var in ((socket.SO_SNDBUF, "btl_tcp_sndbuf"),
                         (socket.SO_RCVBUF, "btl_tcp_rcvbuf")):
            v = var_registry.get(var)
            if v:
                sock.setsockopt(socket.SOL_SOCKET, opt, v)
        # hello frame identifies us to the acceptor (under the alias the
        # acceptor knows us by, for cross-job connections)
        with self._lock:
            my_id = self._alias.get(peer, self.rank)
        hello = dss.pack({"hello": my_id})
        _send_all(sock, struct.pack("<II", len(hello), len(hello)), hello)
        with self._lock:
            # lost the race with another sender thread? keep the first
            existing = self._out.get(peer)
            if existing is not None:
                sock.close()
                return existing, self._out_locks[peer]
            self._out[peer] = sock
            self._out_locks[peer] = threading.Lock()
            return sock, self._out_locks[peer]

    # -- receiving ---------------------------------------------------------

    def _accept_loop(self) -> None:
        try:
            self._listener.settimeout(0.2)
        except OSError:
            return   # close() won the race before the thread started
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            if self._native_ok:
                self._register_conn(conn)
                continue
            t = threading.Thread(target=self._read_loop, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _register_conn(self, sock: socket.socket) -> None:
        """Hand an accepted connection to the shared poller instead of
        spawning a per-socket read loop.  The socket goes nonblocking:
        from here on only the poller touches it, and both the native and
        python poll branches read with per-call readiness."""
        sock.setblocking(False)
        c = _Conn(sock)
        with self._lock:
            self._conns.append(c)
            if self._poller is None and not self._stop.is_set():
                # the wake pipe is born with the poller and dies with it
                self._wake_r, self._wake_w = os.pipe()
                os.set_blocking(self._wake_r, False)
                os.set_blocking(self._wake_w, False)
                t = threading.Thread(target=self._poll_loop,
                                     name=f"btl-poll-{self.rank}",
                                     daemon=True)
                self._poller = t
                t.start()
                self._threads.append(t)
        self._wake_poller()

    def _wake_poller(self) -> None:
        if self._wake_w >= 0:
            try:
                os.write(self._wake_w, b"\0")
            except (BlockingIOError, OSError):
                pass   # pipe full ⇒ a wake is already pending

    def _drain_wake_pipe(self) -> None:
        try:
            while os.read(self._wake_r, 4096):
                pass
        except (BlockingIOError, OSError):
            pass

    def _poll_loop(self) -> None:
        """One thread parks across EVERY accepted connection.  The
        `btl_tcp_native` var is re-read each iteration, so a runtime
        flip moves frame parsing between the native and python branches
        without touching the sockets.  Slices are bounded: the loop
        returns to Python (stop flag, fresh fd snapshot) at least every
        _POLL_SLICE_NS even when fully idle."""
        from ompi_tpu_torch import _native

        net = _net_lib()
        spins = max(0, _native.PARK_SPINS // 16)
        while not self._stop.is_set():
            with self._lock:
                conns = list(self._conns)
            use_native = (net is not None
                          and bool(var_registry.get("btl_tcp_native"))
                          and len(conns) + 1 <= 1024)
            if use_native:
                nfds = len(conns) + 1
                fds = (ctypes.c_int64 * nfds)()
                fds[0] = self._wake_r
                for i, c in enumerate(conns):
                    fds[i + 1] = c.fd
                rdy = (ctypes.c_uint8 * nfds)()
                rc = net.ompi_tpu_net_poll(fds, nfds, rdy, spins,
                                           _POLL_SLICE_NS)
                if rc == 0:
                    trace_mod.count("btl_tcp_native_parks_total")
                    continue
                if rc < 0:
                    ready = conns   # service-all: dead fds prune here
                else:
                    if rdy[0]:
                        self._drain_wake_pipe()
                    ready = [c for i, c in enumerate(conns)
                             if rdy[i + 1]]
            else:
                try:
                    rl, _, _ = select.select(
                        [self._wake_r] + [c.sock for c in conns],
                        [], [], 0.05)
                except (OSError, ValueError):
                    rl = [c.sock for c in conns]   # service-all prunes
                if self._wake_r in rl:
                    self._drain_wake_pipe()
                ready = [c for c in conns if c.sock in rl]
            # the service mutex serializes socket reads against pulling
            # recv-waiters (progress()); a stale ready list after losing
            # the race is harmless — the reads just EAGAIN
            with self._svc_mu:
                for c in ready:
                    try:
                        self._service_conn(c,
                                           net if use_native else None)
                    except (OSError, ValueError) as e:
                        self._drop_conn(c, e)

    def progress(self, budget_s: float = 0.0005) -> bool:
        """Receiver-pull service pass (≈ opal_progress running in the
        waiting thread): a caller blocked on a recv polls the accepted
        connections itself and, if it wins the service lock, drains and
        dispatches ready frames on ITS OWN thread — the frame that
        completes its request is parsed and matched right here, with no
        poller-thread wake and no completion-event handoff on the
        critical path.  The parked poller stays running as the backstop
        for every other request, so callers may stop pulling at any
        time.  One bounded GIL-released poll slice per call; the caller
        re-runs its Python checks (request done, FT verdicts, stop
        flags) between calls.  Returns False when the native plane is
        off/down or the endpoint is stopping — the caller goes back to
        event-waiting."""
        net = self._net_h
        if (net is None or self._stop.is_set()
                or not var_registry.get("btl_tcp_native")):
            return False
        with self._lock:
            conns = list(self._conns)
        if not conns or len(conns) + 1 > 1024:
            return False
        nfds = len(conns) + 1
        fds = (ctypes.c_int64 * nfds)()
        fds[0] = self._wake_r
        for i, c in enumerate(conns):
            fds[i + 1] = c.fd
        rdy = (ctypes.c_uint8 * nfds)()
        rc = net.ompi_tpu_net_poll(fds, nfds, rdy, 0,
                                   int(budget_s * 1e9))
        if rc <= 0:
            return True   # idle slice (or service-all noise): re-check
        if rdy[0]:
            # take the re-snapshot signal: conns are re-read on every
            # pull anyway, and leaving the byte would turn each poll
            # into an instant (empty) return — a hot loop
            self._drain_wake_pipe()
        ready = [c for i, c in enumerate(conns) if rdy[i + 1]]
        if ready and self._svc_mu.acquire(blocking=False):
            try:
                for c in ready:
                    try:
                        self._service_conn(c, net)
                    except (OSError, ValueError) as e:
                        self._drop_conn(c, e)
            finally:
                self._svc_mu.release()
        return True

    def _drop_conn(self, c: _Conn, exc: BaseException) -> None:
        with self._lock:
            try:
                self._conns.remove(c)
            except ValueError:
                pass
        try:
            c.sock.close()
        except OSError:
            pass

    def _service_conn(self, c: _Conn, net) -> None:
        """Pull whatever the connection has pending: finish an
        in-flight direct landing first, then gulp into the staging
        buffer and parse frames.  Bounded per call — a slow sender
        cannot starve the other connections."""
        if c.pending is not None and not self._land_step(c, net):
            return   # landing still short of bytes; poller re-arms
        while True:
            if net is not None:
                n = net.ompi_tpu_net_read(c.fd, c.addr + c.used,
                                          _CONN_BUF - c.used)
                if n in (-errno.EAGAIN, -errno.EWOULDBLOCK):
                    return
                if n <= 0:   # NET_EOF or -errno
                    raise OSError("btl/tcp: connection lost "
                                  f"(native read {n})")
            else:
                try:
                    n = c.sock.recv_into(c.mv[c.used:])
                except (BlockingIOError, InterruptedError):
                    return
                if n == 0:
                    raise OSError("btl/tcp: connection closed")
            c.used += n
            self._parse_frames(c, net)
            if c.pending is not None and not self._land_step(c, net):
                return

    def _parse_frames(self, c: _Conn, net) -> None:
        """Parse every complete frame in the staging buffer (native
        scan or python struct — bit-identical framing), dispatch them,
        and decide whether the trailing partial should switch to direct
        landing (big rndv payloads recv straight into the plan
        destination instead of round-tripping the staging buffer)."""
        from ompi_tpu_torch import _native

        while True:
            triples = []
            if net is not None:
                nf = net.ompi_tpu_net_scan(c.addr, c.used,
                                           self._scan_addr, _SCAN_MAX)
                if nf < 0:
                    raise OSError(
                        f"btl/tcp: malformed frame stream ({nf})")
                so = self._scan_out
                for i in range(nf):
                    triples.append((so[3 * i], so[3 * i + 1],
                                    so[3 * i + 2]))
            else:
                off = 0
                while len(triples) < _SCAN_MAX and c.used - off >= 8:
                    total, hlen = struct.unpack_from("<II", c.buf, off)
                    if hlen > total:
                        raise OSError("btl/tcp: malformed frame prefix")
                    if c.used - off - 8 < total:
                        break
                    triples.append((off, total, hlen))
                    off += 8 + total
            consumed = 0
            for off, total, hlen in triples:
                hdr = dss.unpack(bytes(c.mv[off + 8:off + 8 + hlen]),
                                 n=1)[0]
                payload = bytes(c.mv[off + 8 + hlen:off + 8 + total])
                if "hello" in hdr:
                    c.peer = hdr["hello"]
                else:
                    self.on_frame(c.peer, hdr, payload)
                consumed = off + 8 + total
            more = len(triples) == _SCAN_MAX
            rem = c.used - consumed
            if not more and rem >= 8:
                total, hlen = struct.unpack_from("<II", c.buf, consumed)
                if hlen > total:
                    raise OSError("btl/tcp: malformed frame prefix")
                if 8 + hlen >= _CONN_BUF:
                    # headers are small by contract; a header that can
                    # never fit the staging buffer would deadlock —
                    # fail the connection loudly instead
                    raise OSError(
                        f"btl/tcp: oversized frame header ({hlen}B)")
                if 8 + total >= _LAND_MIN and rem >= 8 + hlen:
                    hdr = dss.unpack(
                        bytes(c.mv[consumed + 8:consumed + 8 + hlen]),
                        n=1)[0]
                    plen = total - hlen
                    dst = None
                    sink = self.recv_sink
                    # direct zero-copy landing is a native-plane
                    # feature: the python fallback stages + copies,
                    # exactly like the pre-poller per-socket read loop
                    if net is not None and sink is not None \
                            and "hello" not in hdr:
                        try:
                            dst = sink(hdr, plen)
                        except Exception:  # noqa: BLE001 — fall back
                            dst = None
                    staged = dst is None
                    if staged:
                        dst = bytearray(plen)
                    dmv = memoryview(dst).cast("B")
                    daddr = _native.addr_of(dmv)
                    if daddr is None:   # read-only sink? stage instead
                        staged = True
                        dst = bytearray(plen)
                        dmv = memoryview(dst).cast("B")
                        daddr = _native.addr_of(dmv)
                    avail = rem - 8 - hlen
                    if avail:
                        dmv[:avail] = c.mv[consumed + 8 + hlen:c.used]
                    c.pending = [hdr, dmv, daddr, avail, plen, staged]
                    consumed = c.used
            if consumed:
                left = c.used - consumed
                if left:
                    # RHS of a bytearray slice-assign copies first, so
                    # the overlapping move is safe and allocation-free
                    c.buf[0:left] = c.buf[consumed:c.used]
                c.used = left
            if not more:
                return

    def _land_step(self, c: _Conn, net) -> bool:
        """Advance an in-flight direct landing by one bounded slice.
        True ⇒ the frame completed and was dispatched; False ⇒ short
        read, poller re-arms (the stop flag and connection errors are
        checked in the poller's outer loop)."""
        hdr, dmv, daddr, filled, plen, staged = c.pending
        while filled < plen:
            if self._stop.is_set():
                raise OSError("btl/tcp: endpoint closed mid-landing")
            if net is not None:
                m = net.ompi_tpu_net_recv_into(c.fd, daddr + filled,
                                               plen - filled,
                                               _LAND_SLICE_NS)
                if m < 0:   # NET_EOF or -errno
                    raise OSError("btl/tcp: connection lost "
                                  f"(native landing {m})")
                if m == 0:
                    trace_mod.count("btl_tcp_native_parks_total")
                    c.pending[3] = filled
                    return False
            else:
                try:
                    m = c.sock.recv_into(dmv[filled:])
                except (BlockingIOError, InterruptedError):
                    c.pending[3] = filled
                    return False
                if m == 0:
                    raise OSError("btl/tcp: connection closed "
                                  "mid-landing")
            filled += m
        c.pending = None
        if "hello" in hdr:
            c.peer = hdr["hello"]
        elif staged:
            self.on_frame(c.peer, hdr, bytes(dmv))
        else:
            done = self.recv_sink_done
            if done is not None:
                done(hdr, plen)
        return True

    def _read_loop(self, conn: socket.socket) -> None:
        peer = -1
        with conn:
            while not self._stop.is_set():
                try:
                    hdr8 = _recv_exact(conn, 8)
                    if hdr8 is None:
                        return
                    total, hdr_len = struct.unpack("<II", hdr8)
                    blob = _recv_exact(conn, total)
                except OSError:
                    return   # close() shut the socket under us
                if blob is None:
                    return
                header = dss.unpack(bytes(blob[:hdr_len]), n=1)[0]
                # a view of the frame's own fresh buffer: no payload copy
                payload = memoryview(blob)[hdr_len:]
                if "hello" in header:
                    peer = header["hello"]
                    continue
                self.on_frame(peer, header, payload)

    def close(self) -> None:
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            rings = list(self._rings.values())
            self._rings.clear()
            conns = list(self._conns)
            self._conns.clear()
            socks = list(self._out.values())
            self._out.clear()
            poller = self._poller
        for ring in rings:
            self._fail_ring(ring, ConnectionError("btl/tcp closed"))
        # doorbell the writer and poller out of their parks
        with self._wlock:
            self._wctr[0] += 1
        ar = _park_lib()
        if ar is not None:
            ar.ompi_tpu_arena_wake(self._wctr_addr, 0)
        self._wake_poller()
        for sock in socks:
            try:
                sock.close()
            except OSError:
                pass
        for c in conns:
            try:
                c.sock.close()
            except OSError:
                pass
        if poller is not None:
            poller.join(timeout=1.0)
            if not poller.is_alive() and self._wake_r >= 0:
                # only reap the pipe once the poller is provably out of
                # poll()/select() on it — closing early risks fd reuse
                for fd in (self._wake_r, self._wake_w):
                    try:
                        os.close(fd)
                    except OSError:
                        pass
                self._wake_r = self._wake_w = -1


class SelfBTL:
    """Loopback delivery (≈ btl/self): frames to self never touch a socket."""

    def __init__(self, rank: int, on_frame: OnFrame) -> None:
        self.rank = rank
        self.on_frame = on_frame

    def send(self, peer: int, header: dict, payload: bytes = b"") -> None:
        assert peer == self.rank
        self.on_frame(self.rank, header, payload)


class ProcBTL:
    """Same-process direct delivery — the degenerate single-copy case of
    vader's xpmem mode (btl_vader_component.c:61-69): when two ranks share
    an address space (threads-as-ranks harness, in-process jobs) a frame
    is ONE direct call into the peer's frame handler — no ring, no poller
    wakeup, no serialization of the payload.  The PML's per-(peer, cid)
    sequence numbers keep ordering correct when mixed with other BTLs.

    Endpoints register in a process-global table under a unique token;
    the business card is ``pid:token:host`` and reachability is pid and
    host equality.
    """

    _registry: dict[int, "ProcBTL"] = {}
    _next_token = iter(range(1, 1 << 62))
    _reg_lock = threading.Lock()

    def __init__(self, rank: int, on_frame: OnFrame) -> None:
        from ompi_tpu_torch.core.sysinfo import host_identity

        self.rank = rank
        self.on_frame = on_frame
        # optional compiled fast lane: (peer, tag, cid, seq, payload) →
        # bool, installed by the owning PML when its matching engine is
        # native — delivers with no header object at all
        self.on_fast = None
        self._peer_tokens: dict[int, int] = {}
        self._alias: dict[int, int] = {}
        self.hostname = host_identity()
        with ProcBTL._reg_lock:
            self.token = next(ProcBTL._next_token)
            ProcBTL._registry[self.token] = self
        self.address = f"{os.getpid()}:{self.token}:{self.hostname}"

    def set_alias(self, peer: int, my_id: int) -> None:
        self._alias[peer] = my_id

    def can_reach(self, card: str) -> bool:
        try:
            pid, token, host = card.split(":", 2)
        except ValueError:
            return False
        return (pid == str(os.getpid()) and host == self.hostname
                and int(token) in ProcBTL._registry)

    def connect(self, peer: int, card: str) -> bool:
        if not self.can_reach(card):
            return False
        self._peer_tokens[peer] = int(card.split(":", 2)[1])
        return True

    def send(self, peer: int, header: dict, payload: bytes = b"") -> None:
        target = ProcBTL._registry.get(self._peer_tokens[peer])
        if target is None:
            raise ConnectionError(f"btl/proc: peer {peer} endpoint closed")
        target.on_frame(self._alias.get(peer, self.rank), header, payload)

    def send_fast(self, peer: int, tag: int, cid: int, seq: int,
                  payload, dt, elems: int, shp) -> bool:
        """Header-free delivery into the peer's compiled engine; False ⇒
        the peer declined (no engine, out-of-order) and the caller
        re-sends the same frame via the header path.  dt/elems/shp are
        the scalar header fields the engine materializes only when it
        must (unexpected storage, allocate-on-match)."""
        target = ProcBTL._registry.get(self._peer_tokens.get(peer, -1))
        if target is None or target.on_fast is None:
            return False
        return target.on_fast(self._alias.get(peer, self.rank),
                              tag, cid, seq, payload, dt, elems, shp)

    def close(self) -> None:
        with ProcBTL._reg_lock:
            ProcBTL._registry.pop(self.token, None)


@btl_framework.component
class TcpBTLComponent(Component):
    NAME = "tcp"
    PRIORITY = 10

    def create(self, rank: int, on_frame: OnFrame) -> TcpBTL:
        return TcpBTL(rank, on_frame)


@btl_framework.component
class SelfBTLComponent(Component):
    NAME = "self"
    PRIORITY = 90

    def create(self, rank: int, on_frame: OnFrame) -> SelfBTL:
        return SelfBTL(rank, on_frame)


@btl_framework.component
class ProcBTLComponent(Component):
    """Same-address-space direct delivery (≈ vader's xpmem single-copy
    mode degenerated to zero-copy calls) — priority above shm: when ranks
    share a process, a function call beats a ring."""

    NAME = "proc"
    PRIORITY = 70

    def create(self, rank: int, on_frame: OnFrame) -> ProcBTL:
        return ProcBTL(rank, on_frame)


@btl_framework.component
class ShmBTLComponent(Component):
    """Shared-memory rings for same-host ranks (≈ btl/vader — priority
    between self and tcp, exactly the reference's exclusivity ordering:
    btl_vader_component.c:61-69)."""

    NAME = "shm"
    PRIORITY = 50

    def create(self, rank: int, on_frame: OnFrame):
        from ompi_tpu_torch.mpi.btl_shm import ShmBTL

        return ShmBTL(rank, on_frame)


class BtlEndpoint:
    """Per-job BTL multiplexer (≈ bml/r2, bml.h:220-232): routes each frame
    to the best reachable BTL — self for loopback, proc for peers in this
    address space, shm rings for same-host peers, tcp otherwise.  MCA
    selection on the btl framework (``--mca btl ^shm``, ``--mca btl
    self,tcp``) gates which transports are built; the self BTL is always
    on (loopback is load-bearing for COMM_SELF and collective self-sends,
    like coll/self in the reference)."""

    def __init__(self, rank: int, on_frame: OnFrame) -> None:
        self.rank = rank
        enabled = {c.NAME for c in btl_framework._eligible()}
        self.self_btl = SelfBTL(rank, on_frame)
        self.tcp_btl = TcpBTL(rank, on_frame) if "tcp" in enabled else None
        self.shm_btl = None
        if "shm" in enabled:
            from ompi_tpu_torch.mpi.btl_shm import ShmBTL

            self.shm_btl = ShmBTL(rank, on_frame)
        self.proc_btl = ProcBTL(rank, on_frame) if "proc" in enabled else None
        if self.tcp_btl is None and self.shm_btl is None:
            raise MPIException(
                "btl selection leaves no transport for remote peers "
                "(need tcp and/or shm)")
        self._cards: dict[int, str] = {}   # peer → full business card
        self._shm_ok: set[int] = set()     # peers with a live shm route
        self._proc_ok: set[int] = set()    # peers in my address space
        self._proc_no: set[int] = set()    # known peers that are NOT
        # deterministic chaos (ompi_tpu_torch.testing.faultinject): when a
        # fault plan is armed, every header-path frame gets a seeded
        # drop/delay/dup verdict at this boundary, whichever transport
        # (proc, shm rings, python or native tcp) then carries it.  None
        # in production — the hot path pays one attribute check.
        self._fault = None
        from ompi_tpu_torch.testing import faultinject

        if faultinject.active():
            self._fault = faultinject.injector_for(rank)

    @property
    def address(self) -> str:
        """The combined business card: tcp address (``-`` when tcp is
        disabled), plus a segment per enabled same-host transport."""
        card = self.tcp_btl.address if self.tcp_btl is not None else "-"
        if self.shm_btl is not None:
            card += f";shm={self.shm_btl.address}"
        if self.proc_btl is not None:
            card += f";proc={self.proc_btl.address}"
        return card

    @staticmethod
    def _split_card(card: str) -> tuple[str, Optional[str], Optional[str]]:
        """→ (tcp, shm segment, proc segment)."""
        parts = card.split(";")
        tcp, shm, proc = parts[0], None, None
        for p in parts[1:]:
            if p.startswith("shm="):
                shm = p[4:]
            elif p.startswith("proc="):
                proc = p[5:]
        return tcp, shm, proc

    def set_peers(self, peers: dict[int, str]) -> None:
        self._cards.update(peers)
        if self.tcp_btl is not None:
            self.tcp_btl.set_peers(
                {p: self._split_card(c)[0] for p, c in peers.items()})

    def peer_alive(self, peer: int) -> Optional[bool]:
        """Same-host pid-liveness: route the question to the shm BTL's
        shared, rate-limited probe (the pid travels in the peer's shm
        business-card segment).  None when unknowable — remote peer, shm
        disabled, or no pid in the card — True/False otherwise."""
        if self.shm_btl is None or peer == self.rank:
            return None if self.shm_btl is None else True
        card = self._cards.get(peer)
        shm_seg = self._split_card(card)[1] if card else None
        return self.shm_btl.probe_alive(peer, shm_seg)

    def set_alias(self, peer: int, my_id: int) -> None:
        if self.tcp_btl is not None:
            self.tcp_btl.set_alias(peer, my_id)
        if self.shm_btl is not None:
            self.shm_btl.set_alias(peer, my_id)
        if self.proc_btl is not None:
            self.proc_btl.set_alias(peer, my_id)

    def max_peer_id(self) -> int:
        """Highest peer id this endpoint knows (for dpm namespace bases)."""
        if self.tcp_btl is None:
            return max(self._cards, default=-1)
        with self.tcp_btl._lock:
            return max(self.tcp_btl._peers, default=-1)

    def route(self, peer: int) -> str:
        """The transport a header-path frame to ``peer`` takes now:
        ``self``, ``proc``, ``shm`` or ``tcp`` (a frame larger than half
        a shm ring still rides tcp)."""
        if peer == self.rank:
            return "self"
        if self.proc_btl is not None and (peer in self._proc_ok
                                          or self._proc_route(peer)):
            return "proc"
        if self.shm_btl is not None and (peer in self._shm_ok
                                         or self._shm_route(peer)):
            return "shm"
        return "tcp"

    def try_send_inline(self, peer: int, header: dict,
                        payload: bytes = b"") -> bool:
        """Inline fast path (≈ mca_bml_base_sendi → btl_sendi,
        pml_ob1_isend.c:89-119): deliver the frame on the CALLER's thread
        when it cannot block — self loopback always, proc peers, shm when
        the ring has room, the native tcp ring when it does.  False ⇒
        caller enqueues for the send worker.  Safe to mix with queued
        sends: the PML reorders by per-(peer,cid) sequence."""
        if self._fault is not None and peer != self.rank:
            verdict = self._fault.on_frame(peer, header)
            if verdict != "send":
                # the verdict is identity-hashed: the worker path would
                # draw the SAME verdict, so resolve it here (True = the
                # frame's fate is sealed; nothing for the worker to do)
                self._apply_fault(verdict, peer, header, payload)
                return True
        ok = self._try_send_inline(peer, header, payload)
        if ok and trace_mod.active:
            # AFTER success only: a declined inline attempt is re-sent by
            # the worker (whose endpoint.send emits its own instant) — an
            # entry-time emit would trace that frame twice
            trace_mod.instant("btl", "send_inline", rank=self.rank,
                              peer=peer, nbytes=len(payload),
                              t=header.get("t"))
        return ok

    def _try_send_inline(self, peer: int, header: dict,
                         payload: bytes = b"") -> bool:
        if peer == self.rank:
            self.self_btl.send(peer, header, payload)
            return True
        if self.proc_btl is not None and (peer in self._proc_ok
                                          or self._proc_route(peer)):
            self.proc_btl.send(peer, header, payload)
            return True
        if self.shm_btl is not None and (peer in self._shm_ok
                                         or self._shm_route(peer)):
            from ompi_tpu_torch.mpi.btl_shm import FrameTooBig, PeerDeadError

            try:
                return self.shm_btl.try_send(peer, header, payload)
            except FrameTooBig:
                return False   # worker path reroutes oversize over tcp
            except PeerDeadError:
                self._drop_shm(peer)
                return False   # worker path surfaces it
        if self.tcp_btl is not None:
            try:
                return self.tcp_btl.try_send(peer, header, payload)
            except Exception:  # noqa: BLE001 — inline contract: no raise
                return False
        return False

    def send(self, peer: int, header: dict, payload: bytes = b"") -> None:
        if self._fault is not None and peer != self.rank:
            verdict = self._fault.on_frame(peer, header)
            if verdict != "send":
                self._apply_fault(verdict, peer, header, payload)
                return
        self._send_routed(peer, header, payload)

    def _apply_fault(self, verdict, peer: int, header: dict,
                     payload) -> None:
        """Execute a non-"send" chaos verdict.  drop: the frame vanishes
        (the caller believes it was sent — exactly a lossy wire).  dup:
        delivered twice (the PML's seq gate holds the duplicate).  delay:
        re-sent later off a timer, payload copied first (zero-copy views
        alias user buffers the caller is free to reuse at completion).

        Never raises: callers include try_send_inline, whose contract is
        a non-raising bool — a verdict-sealed frame that then hits a
        dead route degrades to a drop (the lossy-wire semantics the
        verdict already committed to), it does not surface a raw
        ConnectionError into application code."""
        if verdict == "drop":
            return
        if verdict == "dup":
            try:
                self._send_routed(peer, header, payload)
                self._send_routed(peer, header, payload)
            except Exception:  # noqa: BLE001 — degrade to drop
                pass
            return
        _, ms = verdict
        data = bytes(payload)

        def later() -> None:
            try:
                self._send_routed(peer, header, data)
            except Exception:  # noqa: BLE001 — a dead route ends the delay
                pass

        t = threading.Timer(ms / 1000.0, later)
        t.daemon = True
        t.start()

    def _send_routed(self, peer: int, header: dict,
                     payload: bytes = b"") -> None:
        if trace_mod.active:
            trace_mod.instant("btl", "send", rank=self.rank, peer=peer,
                              nbytes=len(payload), t=header.get("t"))
        if peer == self.rank:
            self.self_btl.send(peer, header, payload)
            return
        if self.proc_btl is not None:
            if peer in self._proc_ok or self._proc_route(peer):
                self.proc_btl.send(peer, header, payload)
                return
        oversize: Optional[BaseException] = None
        if self.shm_btl is not None:
            # steady state: one set lookup, then straight into the ring
            if peer in self._shm_ok or self._shm_route(peer):
                from ompi_tpu_torch.mpi.btl_shm import (FrameTooBig,
                                                        PeerDeadError)

                try:
                    self.shm_btl.send(peer, header, payload)
                    return
                except FrameTooBig as e:
                    oversize = e   # oversize frame rides tcp; PML reorders
                except PeerDeadError:
                    # stale ring of a dead/respawning peer: drop the route
                    # and surface a retryable failure — the frame must NOT
                    # be silently lost in the orphaned mapping
                    self._drop_shm(peer)
                    raise ConnectionError(
                        f"rank {peer} died (shm ring orphaned); routes "
                        f"dropped pending rebind")
        if self.tcp_btl is None:
            if oversize is not None:
                raise MPIException(
                    f"frame to rank {peer} exceeds the shm ring's "
                    f"single-frame limit ({oversize}) and tcp is disabled "
                    f"— raise --mca btl_shm_ring_size or re-enable tcp "
                    f"for oversize fallback") from oversize
            raise MPIException(
                f"no btl route to rank {peer}: tcp is disabled and the "
                f"peer is not shm-reachable")
        self.tcp_btl.send(peer, header, payload)

    def _shm_route(self, peer: int) -> bool:
        shm_card = self._split_card(self._cards.get(peer, ""))[1]
        if shm_card and self.shm_btl.connect(peer, shm_card):
            self._shm_ok.add(peer)
            return True
        return False

    def _drop_shm(self, peer: int) -> None:
        self._shm_ok.discard(peer)
        self.shm_btl.drop_peer(peer)

    def _proc_route(self, peer: int) -> bool:
        if peer in self._proc_no:
            return False
        proc_card = self._split_card(self._cards.get(peer, ""))[2]
        if proc_card and self.proc_btl.connect(peer, proc_card):
            self._proc_ok.add(peer)
            return True
        if peer in self._cards:
            # a known peer that is NOT in my address space stays that
            # way — cache the miss so per-send fast-lane checks are one
            # set lookup
            self._proc_no.add(peer)
        return False

    def rebind(self, peer: int, card: str) -> None:
        """Re-point every transport at a peer's NEW business card (the
        peer was respawned by errmgr/respawn and re-announced itself).
        Stale sockets/rings are dropped; the next send redials lazily."""
        self._cards[peer] = card
        tcp_addr, _, _ = self._split_card(card)
        if self.tcp_btl is not None:
            with self.tcp_btl._lock:
                self.tcp_btl._peers[peer] = tcp_addr
                sock = self.tcp_btl._out.pop(peer, None)
                self.tcp_btl._out_locks.pop(peer, None)
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
            # fail+forget the native submission ring: parked senders
            # wake into ConnectionError and the new incarnation gets a
            # fresh ring on first send
            self.tcp_btl.drop_ring(peer)
        if self.shm_btl is not None:
            self._drop_shm(peer)
        if self.proc_btl is not None:
            self._proc_ok.discard(peer)
            self._proc_no.discard(peer)
            self.proc_btl._peer_tokens.pop(peer, None)

    def close(self) -> None:
        if self.tcp_btl is not None:
            self.tcp_btl.close()
        if self.shm_btl is not None:
            self.shm_btl.close()
        if self.proc_btl is not None:
            self.proc_btl.close()
