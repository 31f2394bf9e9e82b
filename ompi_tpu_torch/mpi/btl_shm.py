"""btl/shm — shared-memory transport for same-host ranks (the port's copy
of the JAX package's ``mpi/btl_shm.py``, whole, with its trace hooks: the
publish/drain counters, the ``shm_publish`` instant, the ``shm_drain``
span and the ``btl_shm_drain_ns`` histogram).

≈ opal/mca/btl/vader (btl_vader_component.c:61-69): intra-host frames move
through mmap'd SPSC ring buffers instead of TCP loopback — no syscalls per
message, one memcpy into the ring and one out.

Topology: each rank owns an **inbox directory** (under /dev/shm when
available) published in its business card.  A sender's first frame to a
same-host peer creates a ring file in the peer's inbox (atomic rename, the
filesystem is the rendezvous — the role vader's modex-published segment
names play); the receiver's poller discovers it, maps it, and unlinks it
(the mapping stays valid, so teardown is automatic even on crash).

Ring layout (all little-endian, 64B header then the data area)::

    [ head u64 | tail u64 | capacity u64 | magic u32 | pad ]  [ data ... ]

``head``/``tail`` are monotonic byte counters (no wrap ambiguity); the
sender is the only head-writer, the receiver the only tail-writer, so the
SPSC ring needs no cross-process lock — aligned 8-byte stores on x86 (TSO)
give the required store ordering.  The counters are accessed through a
``memoryview.cast("Q")`` so each read/write is one native 8-byte memory
op: ``struct.pack_into("<Q", ...)`` must NOT be used here — CPython packs
explicit-byte-order formats byte-by-byte, and a reader racing those eight
single-byte stores observes a torn counter and walks off the published
region (found the hard way: a ping-pong soak deadlocked on exactly this).
Frames use the same framing as btl/tcp:
``u32 total | u32 hdrlen | dss(header) | payload``.

A frame larger than half the ring raises :class:`FrameTooBig`; the caller
(BtlEndpoint) reroutes that frame over TCP — safe out-of-order because the
PML enforces per-(peer, cid) sequence numbers and rendezvous data frames
are offset-addressed.

Wakeup protocol (the futex-style hybrid vader would use): the poller spins
through a short window, then arms a receiver-owned ``sleep`` flag in every
ring and blocks in ``select`` on a **doorbell FIFO** in its inbox.  A
writer publishes its frame first, then rings the doorbell only if the flag
is armed (plus unconditionally on its first frame, so a sleeping receiver
discovers brand-new rings).  Under load: zero syscalls.  Idle: one write()
per wakeup, kernel-precise like the tcp BTL — which matters on small
hosts, where pure spinning loses the core the sender needs.
"""

from __future__ import annotations

import ctypes
import os
import struct
import tempfile
import threading
import time
from typing import Callable, Optional

from ompi_tpu_torch import _native
from ompi_tpu_torch.core import dss, output
from ompi_tpu_torch.core.config import VarType, register_var, var_registry
from ompi_tpu_torch.mpi import trace as trace_mod

__all__ = ["ShmBTL", "FrameTooBig", "PeerDeadError", "ShmRingWriter",
           "ShmRingReader"]

_log = output.get_stream("btl")

register_var("btl", "shm_ring_size", VarType.SIZE, 4 << 20,
             "per-(sender,receiver) shared-memory ring capacity in bytes")
register_var("btl", "shm_send_timeout", VarType.SIZE, 60,
             "seconds a full ring blocks a send before the peer is declared "
             "dead (0 = wait forever); a crashed receiver leaves its rings "
             "full, and unlike tcp there is no RST to surface it")
register_var("btl", "shm_spin", VarType.INT, 512,
             "poller idle iterations (GIL-yielding) before arming the "
             "doorbell and sleeping — a wider window keeps ping-pong "
             "latency off the fifo-wake path on multi-core hosts; "
             "ignored (0) on 1-2 core hosts")
register_var("btl", "shm_native", VarType.BOOL, True,
             "fuse header encode + ring publish (and decode + drain) into "
             "one CPython-C-API call per frame (_native/fastdss.c "
             "ring_send/ring_recv — the vader-class native data plane). "
             "An earlier ctypes route measured SLOWER than python (call "
             "marshalling exceeded the work saved); the C-API route wins. "
             "Off, or a failed build, → pure-python framing")


def _native_ring():
    """The compiled frame engine (fastdss module), or None."""
    if not var_registry.get("btl_shm_native"):
        return None
    return _native.fastdss()


def _native_park_lib():
    """The GIL-released park executor (_native/arena.c), or None.
    Shares the ``btl_shm_native`` gate with the frame engine: both are
    halves of the same native data plane."""
    if not var_registry.get("btl_shm_native"):
        return None
    return _native.arena()


#: ring-base address helper + park spin burst, shared with the arena
#: executor (_native.addr_of / _native.PARK_SPINS — small hosts park
#: with NO spin burst, like the python spin window already did)
_mv_addr = _native.addr_of
_PARK_SPINS = _native.PARK_SPINS
#: one park slice: the cadence at which the poller re-checks stop/pull
#: state and a blocked writer re-checks its send timeout
_PARK_SLICE_NS = 1_000_000

_HDR = 64                 # ring header bytes
_OFF_HEAD, _OFF_TAIL, _OFF_CAP, _OFF_MAGIC = 0, 8, 16, 24
_OFF_SLEEP = 32           # receiver-owned: 1 ⇒ ring my doorbell on publish
_MAGIC = 0x53484D31       # "SHM1"

OnFrame = Callable[[int, dict, bytes], None]


class FrameTooBig(Exception):
    """Frame exceeds the ring's single-frame limit; send it another way."""


class PeerDeadError(ConnectionError):
    """The ring's receiver process no longer exists — a write would land
    in an orphaned mapping and vanish 'successfully'.  Surfaced instead
    of silently losing the frame (the respawn/retransmit path needs to
    KNOW; ≈ the RST a dead tcp peer would produce)."""


def _shm_dir() -> Optional[str]:
    return "/dev/shm" if os.path.isdir("/dev/shm") else None


class ShmRingWriter:
    """The sender's end: creates the ring file and appends frames."""

    def __init__(self, inbox: str, my_id: int, capacity: int) -> None:
        from ompi_tpu_torch.core import shmseg

        capacity = (capacity + 7) & ~7      # counter view needs 8B multiple
        self.capacity = capacity
        # segment lifecycle rides the generic shmem framework
        # (≈ opal/mca/shmem/mmap), UNPUBLISHED until the ring header is
        # initialized: the receiver's inbox scan must never observe a
        # ring without its magic/capacity in place
        self._seg = shmseg.create(f"ring_{my_id}", _HDR + capacity,
                                  dir=inbox, publish=False)
        self._mm = self._seg.buf
        # counters as a u64 view: single native load/store per access
        self._ctr = self._mm[:_HDR].cast("Q")
        self._ctr[_OFF_CAP // 8] = capacity
        struct.pack_into("<I", self._mm, _OFF_MAGIC, _MAGIC)
        self._seg.publish()       # ring header complete: now visible
        self._head = 0            # local mirror: we are the only writer
        self._ctr_addr = _mv_addr(self._mm)   # native backpressure park
        self._lock = threading.Lock()
        self._db_fd: Optional[int] = None   # receiver's doorbell FIFO
        self._first = True
        self._fast = _native_ring()
        try:
            self._db_fd = os.open(os.path.join(inbox, "doorbell"),
                                  os.O_WRONLY | os.O_NONBLOCK)
        except OSError:
            pass   # no doorbell (older inbox / test rig): receiver spins

    def _frame(self, header: dict, payload: bytes):
        hdr = dss.pack(header)
        body = struct.pack("<II", len(hdr) + len(payload), len(hdr))
        need = 8 + len(hdr) + len(payload)
        if need > self.capacity // 2:
            raise FrameTooBig(f"{need}B frame vs {self.capacity}B ring")
        return body, hdr, need

    def _publish(self, body, hdr, payload) -> None:
        """Write one frame and publish it (call with self._lock held and
        space verified)."""
        self._write(body)
        self._write(hdr)
        if payload:
            self._write(payload)
        # publish AFTER the data is in place (x86 TSO store order)
        self._ctr[_OFF_HEAD // 8] = self._head
        self._ring_doorbell(bool(self._ctr[_OFF_SLEEP // 8]))

    @staticmethod
    def _check_send_timeout(waited: float, timeout: float) -> None:
        """A receiver that died without close() leaves the ring full
        forever — the timeout surfaces that as an error (the tcp path
        gets the equivalent from the kernel via RST)."""
        if timeout and waited > timeout:
            raise ConnectionError(
                f"btl/shm: ring full for {waited:.0f}s — receiver "
                f"appears dead (btl_shm_send_timeout)")

    @classmethod
    def _backoff(cls, waited: float, delay: float, timeout: float
                 ) -> tuple[float, float]:
        """One backpressure tick: the receiver is behind; yield then
        sleep, bounded."""
        cls._check_send_timeout(waited, timeout)
        time.sleep(delay)
        return waited + delay, min(delay + 2e-5, 1e-3)

    def _wait_space(self, waited: float, delay: float, timeout: float
                    ) -> tuple[float, float]:
        """One backpressure park: GIL-released native wait for the
        receiver's tail counter to move at all (the caller's loop
        re-checks whether the freed space suffices), falling back to
        the python yield/sleep tick.  Same timeout contract either
        way."""
        ex = _native_park_lib()
        if ex is None or self._ctr_addr is None:
            return self._backoff(waited, delay, timeout)
        self._check_send_timeout(waited, timeout)
        t0 = time.monotonic()
        ex.ompi_tpu_arena_wait_change(
            self._ctr_addr + _OFF_TAIL, int(self._ctr[_OFF_TAIL // 8]),
            _PARK_SPINS, _PARK_SLICE_NS)
        return waited + (time.monotonic() - t0), delay

    def _ring_doorbell(self, armed: bool) -> None:
        """Wake a sleeping receiver (or announce a brand-new ring: the
        very first frame always rings — a sleeping receiver must
        discover it)."""
        if (self._first or armed) and self._db_fd is not None:
            self._first = False
            try:
                os.write(self._db_fd, b"\x01")
            except (BlockingIOError, BrokenPipeError, OSError):
                pass

    def _send_fast(self, header: dict, payload, block: bool) -> bool:
        """One fused C call per frame: encode the header straight into
        the mapped ring + publish (fastdss.ring_send).  Returns False
        when nonblocking and full; raises FrameTooBig / ConnectionError
        like the python path.  Headers the C codec cannot encode fall
        back to the python framing (wire format is identical)."""
        fast = self._fast
        fallback = False
        with self._lock:
            delay, waited = 0.0, 0.0
            timeout = float(var_registry.get("btl_shm_send_timeout") or 0)
            while True:
                try:
                    self._head, ring_db = fast.ring_send(
                        self._mm, self._head, header, payload)
                except fast.RingFull:
                    if not block:
                        return False
                    waited, delay = self._wait_space(waited, delay,
                                                     timeout)
                    continue
                except fast.Unsupported:
                    fallback = True   # exotic header: python framing,
                    break             # OUTSIDE the (non-reentrant) lock
                except fast.FrameTooBig as e:
                    raise FrameTooBig(str(e)) from None
                break
        if fallback:
            return self._send_py(header, payload, block)
        self._ring_doorbell(bool(ring_db))
        return True

    def _send_py(self, header: dict, payload, block: bool) -> bool:
        body, hdr, need = self._frame(header, payload)
        with self._lock:
            delay, waited = 0.0, 0.0
            timeout = float(var_registry.get("btl_shm_send_timeout") or 0)
            while True:
                tail = self._ctr[_OFF_TAIL // 8]
                if self._head - tail + need <= self.capacity:
                    break
                if not block:
                    return False
                waited, delay = self._wait_space(waited, delay, timeout)
            self._publish(body, hdr, payload)
        return True

    def send(self, header: dict, payload) -> None:
        """Deliver one frame.  ``payload`` is any bytes-like object —
        a zero-copy memoryview of the sender's user buffer (the PML's
        plan-collapsed fast path) is published straight into the ring:
        the ONE copy on the whole send path is the ring write itself."""
        if self._fast is not None:
            self._send_fast(header, payload, block=True)
        else:
            self._send_py(header, payload, block=True)

    def try_send_eager(self, tag: int, cid: int, seq: int, dt: str,
                       elems: int, shp: tuple, payload) -> bool:
        """Nonblocking plain-eager publish with the header BUILT IN C
        (fastdss.ring_send_fast) — no dict, no python codec; the
        receiver's engine fast-scans the same seven fields.  False when
        the ring is full NOW (caller falls back to the header path);
        requires the native engine (callers check)."""
        with self._lock:
            try:
                self._head, ring_db = self._fast.ring_send_fast(
                    self._mm, self._head, tag, cid, seq, dt, elems, shp,
                    payload)
            except self._fast.RingFull:
                return False
        self._ring_doorbell(bool(ring_db))
        return True

    def try_send(self, header: dict, payload) -> bool:
        """Nonblocking send (≈ btl sendi, btl.h:926): publish the frame iff
        the ring has room NOW; False ⇒ the caller takes the queued path.
        Still raises FrameTooBig for frames no amount of draining fits.
        ``payload`` may be any bytes-like object (see :meth:`send`)."""
        if self._fast is not None:
            return self._send_fast(header, payload, block=False)
        return self._send_py(header, payload, block=False)

    def _write(self, data) -> None:
        data = memoryview(data).cast("B")
        pos = self._head % self.capacity
        first = min(len(data), self.capacity - pos)
        self._mm[_HDR + pos:_HDR + pos + first] = data[:first]
        if first < len(data):
            self._mm[_HDR:_HDR + len(data) - first] = data[first:]
        self._head += len(data)

    def close(self) -> None:
        if self._db_fd is not None:
            try:
                os.close(self._db_fd)
            except OSError:
                pass
            self._db_fd = None
        try:
            self._ctr.release()
        except (BufferError, ValueError):
            pass
        self._seg.detach()


class ShmRingReader:
    """The receiver's end: maps a discovered ring and drains frames."""

    def __init__(self, path: str, peer: int) -> None:
        from ompi_tpu_torch.core import shmseg

        self.peer = peer
        self._seg = shmseg.attach(path)
        self._mm = self._seg.buf
        if struct.unpack_from("<I", self._mm, _OFF_MAGIC)[0] != _MAGIC:
            self._seg.detach()
            raise OSError(f"bad ring magic in {path}")
        self._ctr = self._mm[:_HDR].cast("Q")
        self.capacity = self._ctr[_OFF_CAP // 8]
        self._tail = self._ctr[_OFF_TAIL // 8]
        self._seg.unlink()  # mapping survives; crash cleanup is automatic
        self._fast = _native_ring()
        self._ctr_addr = _mv_addr(self._mm)   # head word the park watches

    def poll(self, on_frame: OnFrame, limit: int = 64) -> int:
        """Drain up to ``limit`` frames; returns how many were delivered."""
        fast = self._fast
        n = 0
        while fast is not None and n < limit:
            # fused decode: header is unpacked straight from the mapped
            # ring (fastdss.ring_recv), tail release-stored in C
            try:
                out = fast.ring_recv(self._mm, self._tail)
            except fast.Unsupported:
                # a header tag only the python codec knows: drain the
                # rest of this batch through the python path
                fast = None
                break
            except ValueError as e:
                # corrupt frame: the C decoder did NOT advance the tail
                # (nothing trustworthy to advance by) — retrying would
                # livelock on the same bytes forever.  The stream is
                # unrecoverable; discard everything published and
                # surface the fault loudly (the python path would have
                # decoded garbage instead — this is the stricter cure).
                head = int(self._ctr[_OFF_HEAD // 8])
                dropped = head - self._tail
                self._tail = head
                self._ctr[_OFF_TAIL // 8] = self._tail
                raise OSError(
                    f"btl/shm: corrupt ring from peer {self.peer} "
                    f"({e}); {dropped} pending bytes discarded") from None
            if out is None:
                return n
            header, payload, self._tail = out
            on_frame(self.peer, header, payload)
            n += 1
        if n >= limit:
            return n
        while n < limit:
            head = self._ctr[_OFF_HEAD // 8]
            avail = head - self._tail
            if avail == 0 or avail > self.capacity:
                # nothing published (or a state no sane writer produces —
                # never walk past the published region)
                break
            total, hdr_len = struct.unpack("<II", self._read(8))
            blob = self._read(total)
            header = dss.unpack(blob[:hdr_len], n=1)[0]
            on_frame(self.peer, header, blob[hdr_len:])
            self._ctr[_OFF_TAIL // 8] = self._tail
            n += 1
        return n

    def _read(self, n: int) -> bytes:
        pos = self._tail % self.capacity
        first = min(n, self.capacity - pos)
        # bytes() copy: _mm is a memoryview into the live ring — the
        # returned data must own its bytes (the slot is recycled once the
        # tail advances)
        out = bytes(self._mm[_HDR + pos:_HDR + pos + first])
        if first < n:
            out += bytes(self._mm[_HDR:_HDR + (n - first)])
        self._tail += n
        return out

    def has_data(self) -> bool:
        avail = self._ctr[_OFF_HEAD // 8] - self._tail
        return 0 < avail <= self.capacity

    def set_sleeping(self, flag: bool) -> None:
        self._ctr[_OFF_SLEEP // 8] = 1 if flag else 0

    def close(self) -> None:
        try:
            self._ctr.release()
        except (BufferError, ValueError):
            pass
        self._seg.detach()


class ShmBTL:
    """Shared-memory BTL: one inbox dir per rank, lazy per-pair rings."""

    def __init__(self, rank: int, on_frame: OnFrame) -> None:
        self.rank = rank
        self.on_frame = on_frame
        # OMPI_TPU_FAKE_HOST gives ranks a simulated host identity (set by
        # the sim plm): ranks on different sim-hosts must NOT shm-reach
        # each other, so the cross-host data path runs for real in tests
        from ompi_tpu_torch.core.sysinfo import host_identity

        self.hostname = host_identity()
        self.inbox = tempfile.mkdtemp(prefix="otpu-shm-", dir=_shm_dir())
        os.mkfifo(os.path.join(self.inbox, "doorbell"))
        # read end first (a writer's nonblocking open needs a reader)
        self._db_fd = os.open(os.path.join(self.inbox, "doorbell"),
                              os.O_RDONLY | os.O_NONBLOCK)
        self._writers: dict[int, ShmRingWriter] = {}
        self._readers: dict[int, ShmRingReader] = {}
        # optional fused drain: reader → frames-delivered, installed by
        # the PML when its compiled matching engine is live.  When set,
        # EVERY ring read goes through it (the hook serializes reads
        # under the PML lock, which also lets a blocked receiver drain
        # its own rings — receiver-pull progress)
        self.drain_hook = None
        # >0 ⇒ a blocked receiver is actively pulling: the poller backs
        # off (sleep, don't spin) instead of fighting the waiter for the
        # GIL and the PML lock on every frame
        self.pull_depth = 0
        self._peer_pid: dict[int, Optional[int]] = {}
        self._alive_until: dict[int, float] = {}   # liveness-probe cache
        self._unreachable: set[int] = set()
        self._alias: dict[int, int] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        # spinning only pays when the sender runs on another core; on a
        # 1-2 core host every spin iteration steals the sender's quantum
        self._spin = (int(var_registry.get("btl_shm_spin") or 0)
                      if (os.cpu_count() or 1) > 2 else 0)
        self._poller = threading.Thread(
            target=self._poll_loop, name=f"btl-shm-{rank}", daemon=True)
        self._poller.start()

    @property
    def address(self) -> str:
        """The business-card fragment: host identity + inbox + pid (the
        pid lets writers detect a dead receiver — an orphaned ring accepts
        writes 'successfully' forever)."""
        return f"{self.hostname}|{self.inbox}|{os.getpid()}"

    def set_alias(self, peer: int, my_id: int) -> None:
        with self._lock:
            self._alias[peer] = my_id

    @staticmethod
    def _parse_card(card: str) -> tuple[str, str, Optional[int]]:
        parts = card.split("|")
        host, inbox = parts[0], parts[1] if len(parts) > 1 else ""
        pid = int(parts[2]) if len(parts) > 2 and parts[2].isdigit() else None
        return host, inbox, pid

    def can_reach(self, card: str) -> bool:
        """Same host (by name) and the inbox is visible on my filesystem —
        ≈ the BTL reachability query (btl.h add_procs) vader answers with
        same-node-ness."""
        host, inbox, _ = self._parse_card(card)
        return host == self.hostname and os.path.isdir(inbox)

    def connect(self, peer: int, card: str) -> bool:
        """Create my ring in the peer's inbox; False ⇒ use another BTL."""
        with self._lock:
            if peer in self._writers:
                return True
            if peer in self._unreachable:
                return False
            if not self.can_reach(card):
                self._unreachable.add(peer)
                return False
            my_id = self._alias.get(peer, self.rank)
            host, inbox, pid = self._parse_card(card)
            try:
                self._writers[peer] = ShmRingWriter(
                    inbox, my_id,
                    int(var_registry.get("btl_shm_ring_size")))
            except OSError as e:
                _log.verbose(1, "btl/shm: cannot reach %d (%s); tcp fallback",
                             peer, e)
                self._unreachable.add(peer)
                return False
            self._peer_pid[peer] = pid
            return True

    def probe_alive(self, peer: int,
                    card: Optional[str] = None) -> Optional[bool]:
        """Pid-liveness probe, time-bounded and cache-SHARED with the
        send path (``_check_alive``): the kill(2) syscall runs at most
        once per peer per 50ms no matter how many layers ask.  ``card``
        (the peer's shm business-card segment) supplies the pid when no
        ring was ever connected — the coll/shm arena probes writers it
        may never have exchanged a PML frame with.  Returns None when the
        pid is unknowable, True/False otherwise."""
        pid = self._peer_pid.get(peer)
        if pid is None and card:
            host, _inbox, cpid = self._parse_card(card)
            if host == self.hostname and cpid is not None:
                # a different host's pid namespace would alias — only a
                # same-host card's pid is probeable
                pid = cpid
                self._peer_pid.setdefault(peer, pid)
        if pid is None:
            return None
        if pid == os.getpid():
            return True
        now = time.monotonic()
        if now < self._alive_until.get(peer, 0.0):
            return True
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return False
        except PermissionError:
            pass   # alive under another uid
        self._alive_until[peer] = now + 0.05
        return True

    def _check_alive(self, peer: int) -> None:
        """Send-path arm of the probe: raise instead of answering (death
        detection is delayed by at most the cache bound — the park/heal
        layer absorbs that)."""
        if self.probe_alive(peer) is False:
            raise PeerDeadError(
                f"btl/shm: rank {peer} (pid {self._peer_pid.get(peer)}) "
                f"is gone — dropping the orphaned ring") from None

    def drop_peer(self, peer: int) -> None:
        """Forget a peer's (stale) ring so the next send reconnects from
        its current card (respawn/rebind path)."""
        with self._lock:
            self._unreachable.discard(peer)
            self._peer_pid.pop(peer, None)
            self._alive_until.pop(peer, None)
            w = self._writers.pop(peer, None)
        if w is not None:
            w.close()

    def _trace_publish(self, peer: int, payload) -> None:
        """Counter + instant for a frame that DID enter a ring — called
        only after a successful publish, so the pvar never counts frames
        a FrameTooBig/dead-peer failure kept out."""
        trace_mod.count("btl_shm_publish_total")
        if trace_mod.active:
            trace_mod.instant("btl", "shm_publish", rank=self.rank,
                              peer=peer, nbytes=len(payload))

    def send(self, peer: int, header: dict, payload=b"") -> None:
        """Deliver one frame (``payload``: any bytes-like, zero-copy
        buffer views included); raises FrameTooBig for oversized frames,
        PeerDeadError for a dead receiver, and KeyError if connect() was
        never called for this peer."""
        self._check_alive(peer)
        self._writers[peer].send(header, payload)
        self._trace_publish(peer, payload)

    def try_send(self, peer: int, header: dict, payload=b"") -> bool:
        """Nonblocking delivery on the caller's thread; False when the
        ring is full or unconnected (caller falls back to the send
        worker).  FrameTooBig/PeerDeadError propagate — no queueing fixes
        those."""
        w = self._writers.get(peer)
        if w is None:
            return False
        self._check_alive(peer)
        if not w.try_send(header, payload):
            return False
        self._trace_publish(peer, payload)
        return True

    def try_send_eager(self, peer: int, tag: int, cid: int, seq: int,
                      dt: str, elems: int, shp: tuple, payload) -> bool:
        """Header-free eager publish (see ShmRingWriter.try_send_eager);
        False ⇒ unconnected / no native engine / ring full."""
        w = self._writers.get(peer)
        if w is None or w._fast is None:
            return False
        self._check_alive(peer)
        if not w.try_send_eager(tag, cid, seq, dt, elems, shp, payload):
            return False
        self._trace_publish(peer, payload)
        return True

    # -- receive side ------------------------------------------------------

    def _scan_inbox(self) -> int:
        """Attach newly appeared rings; returns how many were attached."""
        try:
            names = os.listdir(self.inbox)
        except OSError:
            return 0
        attached = 0
        for name in names:
            if not name.startswith("ring_"):
                continue
            try:
                peer = int(name.split("_", 1)[1])
            except ValueError:
                continue
            path = os.path.join(self.inbox, name)
            try:
                reader = ShmRingReader(path, peer)
            except OSError:
                continue
            with self._lock:
                self._readers[peer] = reader
            attached += 1
        return attached

    def _poll_loop(self) -> None:
        import select

        idle = 0
        last_scan = time.monotonic()
        while not self._stop.is_set():
            if self.pull_depth:
                # a blocked receiver is draining on its own thread —
                # stay out of its way (it covers every frame, punts
                # included); wake periodically for new-ring discovery
                time.sleep(0.002)
                self._scan_inbox()
                idle = 0
                continue
            with self._lock:
                readers = list(self._readers.values())
            n = 0
            hook = self.drain_hook
            for r in readers:
                try:
                    # NOTE: an exception out of on_frame consumes the frame
                    # (tail already advanced) — same loss semantics as a tcp
                    # reader thread dying mid-delivery; the log below is the
                    # only trace, so keep it loud
                    if hook is not None:
                        n += hook(r)   # fused drain traces in the PML
                    else:
                        _t0 = (trace_mod.begin()
                               if trace_mod.active
                               or trace_mod.hist_active else 0)
                        got = r.poll(self.on_frame)
                        if got:
                            trace_mod.count("btl_shm_drained_total", got)
                            if _t0 and trace_mod.hist_active:
                                trace_mod.record_hist(
                                    "btl_shm_drain_ns",
                                    time.monotonic_ns() - _t0)
                            if _t0 and trace_mod.active:
                                trace_mod.complete(
                                    "btl", "shm_drain", _t0,
                                    rank=self.rank, peer=r.peer,
                                    frames=got)
                        n += got
                except Exception as e:   # a bad frame must not kill polling
                    _log.error("btl/shm poll from %d failed: %r", r.peer, e)
            if n:
                idle = 0
                # sustained traffic must not starve new-peer discovery: a
                # fresh ring's doorbell is only read while sleeping
                if time.monotonic() - last_scan > 0.05:
                    self._scan_inbox()
                    last_scan = time.monotonic()
                continue
            idle += 1
            parked = self._native_park(readers)
            if parked is not None:
                if parked:
                    # a head moved during the GIL-released park: drain
                    # immediately (the whole idle window ran without
                    # touching the interpreter once)
                    trace_mod.count("btl_shm_native_drains_total")
                    idle = 0
                    continue
                # slice expired with nothing published: fall through to
                # the doorbell arm (kernel-precise idle, zero CPU)
            elif idle <= self._spin:   # spin window: drain bursts cheaply
                time.sleep(0)
                continue
            # arm the doorbell: set every ring's sleep flag, re-check for
            # frames published between the flag store and now (classic
            # missed-wakeup guard), then block on the FIFO.  A ring that
            # appeared during the scan counts as a wakeup too — it is not
            # in the armed snapshot, so its doorbell was already consumed
            # (or never sent) and sleeping on it would strand its frames
            # until the select timeout.
            for r in readers:
                r.set_sleeping(True)
            last_scan = time.monotonic()
            if self._scan_inbox() or any(r.has_data() for r in readers):
                for r in readers:
                    r.set_sleeping(False)
                idle = 0
                continue
            try:
                select.select([self._db_fd], [], [], 0.05)
                while True:       # drain accumulated doorbell bytes
                    try:
                        if not os.read(self._db_fd, 4096):
                            break
                    except BlockingIOError:
                        break
            except OSError:
                pass
            for r in readers:
                r.set_sleeping(False)
            idle = 0

    def _native_park(self, readers) -> Optional[bool]:
        """One GIL-released park across every attached ring's head
        counter (a time.sleep(0) spin here fights every other thread
        for the interpreter).  True ⇒ some ring published during the park, False
        ⇒ slice expired idle, None ⇒ no native executor (python spin
        window applies)."""
        ex = _native_park_lib()
        if ex is None or not readers:
            return None
        n = len(readers)
        ctrs = (ctypes.c_void_p * n)()
        tails = (ctypes.c_uint64 * n)()
        for i, r in enumerate(readers):
            if r._ctr_addr is None:
                return None
            ctrs[i] = r._ctr_addr
            tails[i] = r._tail
        got = ex.ompi_tpu_ring_wait_any(
            ctypes.addressof(ctrs), ctypes.addressof(tails), n,
            _PARK_SPINS, _PARK_SLICE_NS)
        return got >= 0

    def reader_list(self) -> list["ShmRingReader"]:
        """Snapshot of the attached rings (receiver-pull callers)."""
        with self._lock:
            return list(self._readers.values())

    def close(self) -> None:
        self._stop.set()
        self._poller.join(timeout=2.0)
        with self._lock:
            for w in self._writers.values():
                w.close()
            for r in self._readers.values():
                r.close()
            self._writers.clear()
            self._readers.clear()
        try:
            os.close(self._db_fd)
        except OSError:
            pass
        try:
            for name in os.listdir(self.inbox):
                os.unlink(os.path.join(self.inbox, name))
            os.rmdir(self.inbox)
        except OSError:
            pass
