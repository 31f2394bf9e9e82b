"""BTL — byte transfer layer for the host path (the port's trimmed copy of
the JAX package's ``mpi/btl.py``).

≈ opal/mca/btl (btl.h:1170-1228; send :891): moves opaque frames between
ranks.  The PML above it owns MPI semantics (matching, protocols); a BTL just
delivers (header, payload) frames reliably and in order per sender.

Components:
- ``tcp``  — sockets between ranks; addresses exchanged via the PMIx modex
  (the reference's btl/tcp + business-card flow).  Each rank dials peers
  lazily and uses dialed connections for sending only; inbound connections
  (identified by a hello frame) are receive-only.  Two simplex pipes per pair
  avoid connection races entirely.
- ``self`` — loopback fast path (≈ btl/self): frames to one's own rank are
  delivered by direct callback, no sockets.
- ``proc`` — same-address-space direct delivery: ranks on threads of one
  process (the test harness) hand a frame to the peer's handler in one call.

What the port keeps is the JAX package's pure-Python plane, the one it runs
under ``OMPI_TPU_NO_NATIVE=1``: one ``sendmsg`` per frame under a per-peer
lock on the send side, one reader thread per accepted connection on the
receive side, with the same wire format (4-byte total length, 4-byte header
length, DSS header, raw payload).  Left out (ROADMAP.md Queue 1 item 6):
the native tcp plane (submission rings, writer thread, parked poller and
receiver-pull; ``btl_tcp_native`` is not registered), the shared-memory
rings (``btl/shm``), and the fault-injection hook.  Without shm, same-host
peers in different processes talk over tcp.

Device buffers never travel through a BTL: the device path is the bound
``DeviceCommunicator`` (NCCL on the card).
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Callable, Optional

from ompi_tpu_torch.core import dss
from ompi_tpu_torch.core.config import VarType, register_var, var_registry
from ompi_tpu_torch.core.mca import Component, Framework
from ompi_tpu_torch.mpi.constants import MPIException

__all__ = ["btl_framework", "TcpBTL", "SelfBTL", "ProcBTL", "BtlEndpoint"]

btl_framework = Framework("btl", "byte transfer layer")

register_var("btl", "tcp_sndbuf", VarType.SIZE, 0,
             "SO_SNDBUF for btl/tcp sockets (0 = OS default)")
register_var("btl", "tcp_rcvbuf", VarType.SIZE, 0,
             "SO_RCVBUF for btl/tcp sockets (0 = OS default)")

# frame = 4B LE total length | 4B LE header length | DSS(header dict) |
# raw payload (not DSS-wrapped, to avoid copying large buffers through the
# serializer)

OnFrame = Callable[[int, dict, bytes], None]


def _send_all(sock: socket.socket, *parts) -> None:
    """Scatter-gather send: no join copy of the payload (a rendezvous
    fragment is ~1MiB).  Falls back across partial sends by re-slicing the
    iovec."""
    iov = [memoryview(p).cast("B") for p in parts if len(p)]
    while iov:
        sent = sock.sendmsg(iov)
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


class TcpBTL:
    """TCP frame transport between the ranks of one job."""

    def __init__(self, rank: int, on_frame: OnFrame,
                 host: str = "127.0.0.1") -> None:
        self.rank = rank
        self.on_frame = on_frame
        self._listener = socket.create_server((host, 0), backlog=64)
        self._addr = f"{host}:{self._listener.getsockname()[1]}"
        self._out: dict[int, socket.socket] = {}
        self._out_locks: dict[int, threading.Lock] = {}
        self._peers: dict[int, str] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._conns: list[socket.socket] = []
        self._threads: list[threading.Thread] = []
        t = threading.Thread(target=self._accept_loop,
                             name=f"btl-accept-{rank}", daemon=True)
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

    # -- sending -----------------------------------------------------------

    def send(self, peer: int, header: dict, payload: bytes = b"") -> None:
        """Deliver one frame to `peer`. Blocking on socket backpressure;
        in-order per (self → peer)."""
        sock, lock = self._peer_sock(peer)
        hdr = dss.pack(header)
        prefix = struct.pack("<II", len(hdr) + len(payload), len(hdr))
        with lock:
            _send_all(sock, prefix, hdr, payload)

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
        # hello frame identifies us to the acceptor
        hello = dss.pack({"hello": self.rank})
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
            with self._lock:
                self._conns.append(conn)
            t = threading.Thread(target=self._read_loop, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

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
            socks = list(self._out.values()) + list(self._conns)
            self._out.clear()
            self._conns.clear()
        for sock in socks:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass


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
    is ONE direct call into the peer's frame handler — no socket, no
    serialization of the payload.  The PML's per-(peer, cid) sequence
    numbers keep ordering correct when mixed with other BTLs.

    Endpoints register in a process-global table under a unique token;
    the business card is ``pid:token:host`` and reachability is pid and
    host equality.
    """

    _registry: dict[int, "ProcBTL"] = {}
    _next_token = iter(range(1, 1 << 62))
    _reg_lock = threading.Lock()

    def __init__(self, rank: int, on_frame: OnFrame) -> None:
        import os

        from ompi_tpu_torch.core.sysinfo import host_identity

        self.rank = rank
        self.on_frame = on_frame
        self._peer_tokens: dict[int, int] = {}
        self.hostname = host_identity()
        with ProcBTL._reg_lock:
            self.token = next(ProcBTL._next_token)
            ProcBTL._registry[self.token] = self
        self.address = f"{os.getpid()}:{self.token}:{self.hostname}"

    def can_reach(self, card: str) -> bool:
        import os

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
        target.on_frame(self.rank, header, payload)

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
    """Same-address-space direct delivery: when ranks share a process, a
    function call beats a socket."""

    NAME = "proc"
    PRIORITY = 70

    def create(self, rank: int, on_frame: OnFrame) -> ProcBTL:
        return ProcBTL(rank, on_frame)


class BtlEndpoint:
    """Per-job BTL multiplexer (≈ bml/r2, bml.h:220-232): routes each frame
    to the best reachable BTL — self for loopback, proc for peers in this
    address space, tcp otherwise.  MCA selection on the btl framework
    (``--mca btl ^proc``, ``--mca btl self,tcp``) gates which transports
    are built; the self BTL is always on (loopback is load-bearing for
    COMM_SELF and collective self-sends, like coll/self in the
    reference)."""

    def __init__(self, rank: int, on_frame: OnFrame) -> None:
        self.rank = rank
        enabled = {c.NAME for c in btl_framework._eligible()}
        self.self_btl = SelfBTL(rank, on_frame)
        self.tcp_btl = TcpBTL(rank, on_frame) if "tcp" in enabled else None
        self.proc_btl = ProcBTL(rank, on_frame) if "proc" in enabled else None
        if self.tcp_btl is None and self.proc_btl is None:
            raise MPIException(
                "btl selection leaves no transport for remote peers "
                "(need tcp and/or proc)")
        self._cards: dict[int, str] = {}   # peer → full business card
        self._proc_ok: set[int] = set()    # peers in my address space
        self._proc_no: set[int] = set()    # known peers that are NOT

    @property
    def address(self) -> str:
        """The combined business card: tcp address (``-`` when tcp is
        disabled), plus a segment for the proc transport."""
        card = self.tcp_btl.address if self.tcp_btl is not None else "-"
        if self.proc_btl is not None:
            card += f";proc={self.proc_btl.address}"
        return card

    @staticmethod
    def _split_card(card: str) -> tuple[str, Optional[str]]:
        """→ (tcp, proc segment); other segments (the JAX package's shm
        card) are ignored."""
        parts = card.split(";")
        tcp, proc = parts[0], None
        for p in parts[1:]:
            if p.startswith("proc="):
                proc = p[5:]
        return tcp, proc

    def set_peers(self, peers: dict[int, str]) -> None:
        self._cards.update(peers)
        if self.tcp_btl is not None:
            self.tcp_btl.set_peers(
                {p: self._split_card(c)[0] for p, c in peers.items()})

    def try_send_inline(self, peer: int, header: dict,
                        payload: bytes = b"") -> bool:
        """Inline fast path (≈ mca_bml_base_sendi → btl_sendi,
        pml_ob1_isend.c:89-119): deliver the frame on the CALLER's thread
        when it cannot block — self loopback and proc peers.  False ⇒
        caller enqueues for the send worker.  Safe to mix with queued
        sends: the PML reorders by per-(peer,cid) sequence."""
        if peer == self.rank:
            self.self_btl.send(peer, header, payload)
            return True
        if self.proc_btl is not None and (peer in self._proc_ok
                                          or self._proc_route(peer)):
            self.proc_btl.send(peer, header, payload)
            return True
        return False

    def send(self, peer: int, header: dict, payload: bytes = b"") -> None:
        if peer == self.rank:
            self.self_btl.send(peer, header, payload)
            return
        if self.proc_btl is not None and (peer in self._proc_ok
                                          or self._proc_route(peer)):
            self.proc_btl.send(peer, header, payload)
            return
        if self.tcp_btl is None:
            raise MPIException(
                f"no btl route to rank {peer}: tcp is disabled and the "
                f"peer is not in this address space")
        self.tcp_btl.send(peer, header, payload)

    def _proc_route(self, peer: int) -> bool:
        if peer in self._proc_no:
            return False
        proc_card = self._split_card(self._cards.get(peer, ""))[1]
        if proc_card and self.proc_btl.connect(peer, proc_card):
            self._proc_ok.add(peer)
            return True
        if peer in self._cards:
            # a known peer that is NOT in my address space stays that way
            self._proc_no.add(peer)
        return False

    def close(self) -> None:
        if self.tcp_btl is not None:
            self.tcp_btl.close()
        if self.proc_btl is not None:
            self.proc_btl.close()
