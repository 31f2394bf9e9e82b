"""Rendezvous / modex service: put, get, fence, abort (the port's trimmed
copy of the JAX package's ``runtime/pmix.py``).

≈ opal/mca/pmix (pmix.h:328-861: put :396, get :407, fence :384) plus the
server side ORTE provides.  The launcher (HNP) hosts a TCP key-value server;
every app proc connects as a client using the ``OMPI_TPU_HNP_URI`` it
inherits.  The *modex* — each rank publishing its business card (host p2p
listening address, chip binding) and fencing — is exactly the reference's
PMIx_Put/Commit/Fence flow from ompi_mpi_init.c:673-703.

The env names, the commands and the wire format are the JAX package's.
The hang doctor's ports are kept: a rank registers its responder's UDP
port (``doctor``), and ``doctor_ports``/``query_doctor_ports`` read them
back.  Left out (ROADMAP.md Queue 1 item 6.10, errmgr respawn/selfheal
and FT): the failure reports and the dead-set query of the ULFM
detector, revived lives and their stale-report gate and the FT event
timeline; and (item 6.15) the registration-free readiness probes
(``query_regstate``/``query_regcount``).

Wire protocol: 4-byte LE length + DSS-packed (cmd, *args) tuple per message,
one reply per request.  GET blocks server-side until the key is published
(PMIx's "direct modex on demand" behavior), FENCE blocks until all ranks of
the epoch arrive.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
from typing import Any, Callable, Optional

from ompi_tpu_torch.core import dss, output

__all__ = ["PMIxServer", "PMIxClient", "PMIxError", "query_doctor_ports"]

_log = output.get_stream("pmix")

ENV_URI = "OMPI_TPU_HNP_URI"
ENV_RANK = "OMPI_TPU_RANK"
ENV_SIZE = "OMPI_TPU_SIZE"
ENV_JOBID = "OMPI_TPU_JOBID"
ENV_LOCAL_RANK = "OMPI_TPU_LOCAL_RANK"
ENV_CHIP = "OMPI_TPU_CHIP"


class PMIxError(RuntimeError):
    pass


def _send_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(struct.pack("<I", len(payload)) + payload)


def _recv_frame(sock: socket.socket) -> Optional[bytes]:
    hdr = b""
    while len(hdr) < 4:
        chunk = sock.recv(4 - len(hdr))
        if not chunk:
            return None
        hdr += chunk
    (n,) = struct.unpack("<I", hdr)
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 16, n - len(buf)))
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


class PMIxServer:
    """The HNP-side rendezvous server (thread-per-connection)."""

    def __init__(self, size: int,
                 on_abort: Optional[Callable[[int, int, str], None]] = None,
                 host: str = "127.0.0.1") -> None:
        self.size = size
        self.on_abort = on_abort
        self._store: dict[str, Any] = {}
        self._cv = threading.Condition()
        self._fence_counts: dict[int, int] = {}
        self._fence_done: set[int] = set()
        self._client_epoch: dict[int, int] = {}
        self._dead: set[int] = set()
        self._registered: set[int] = set()  # ranks whose client connected
        self._ready: set[int] = set()   # ranks that left init
        self._doctor_ports: dict[int, int] = {}  # rank → responder port
        self._aborted: Optional[tuple[int, int, str]] = None
        self._listener = socket.create_server((host, 0))
        self._port = self._listener.getsockname()[1]
        self._host = host
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="pmix-accept", daemon=True)
        self._accept_thread.start()

    @property
    def uri(self) -> str:
        return f"tcp://{self._host}:{self._port}"

    # -- server loop -----------------------------------------------------

    def _accept_loop(self) -> None:
        self._listener.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            t = threading.Thread(target=self._serve, args=(conn,), daemon=True)
            t.start()
            self._threads.append(t)

    def _serve(self, conn: socket.socket) -> None:
        with conn:
            while True:
                try:
                    payload = _recv_frame(conn)
                except OSError:
                    return  # client died mid-frame (SIGKILL/injected
                    # fault resets the socket) — same as a clean EOF
                if payload is None:
                    return
                msg = dss.unpack(payload, n=1)[0]
                cmd = msg[0]
                try:
                    reply = self._handle(cmd, msg[1:])
                except Exception as e:  # report, don't kill the server thread
                    reply = ("err", f"{type(e).__name__}: {e}")
                _send_frame(conn, dss.pack(reply))
                if cmd == "fin":
                    return

    def _handle(self, cmd: str, args: tuple) -> tuple:
        if cmd == "put":
            rank, key, value = args
            with self._cv:
                self._store[f"{key}@{rank}"] = value
                self._cv.notify_all()
            return ("ok",)
        if cmd == "get":
            key, rank, timeout = args
            full = f"{key}@{rank}" if rank >= 0 else key
            with self._cv:
                ok = self._cv.wait_for(
                    lambda: full in self._store or self._aborted is not None,
                    timeout=timeout if timeout > 0 else None)
                if self._aborted is not None:
                    return ("abort", *self._aborted)
                if not ok:
                    return ("timeout",)
                return ("ok", self._store[full])
        if cmd == "fence":
            (rank, collect) = args
            with self._cv:
                epoch = self._client_epoch.get(rank, 0)
                self._client_epoch[rank] = epoch + 1
                self._fence_counts[epoch] = self._fence_counts.get(epoch, 0) + 1
                self._check_fence_done(epoch)
                self._cv.wait_for(
                    lambda: epoch in self._fence_done or self._aborted is not None)
                if self._aborted is not None:
                    return ("abort", *self._aborted)
                if collect:
                    return ("ok", dict(self._store))
                return ("ok",)
        if cmd == "abort":
            rank, status, msg = args
            with self._cv:
                if self._aborted is None:
                    self._aborted = (rank, status, msg)
                self._cv.notify_all()
            if self.on_abort is not None:
                self.on_abort(rank, status, msg)
            return ("ok",)
        if cmd == "reg":
            # client registration (sent once at PMIxClient construction)
            with self._cv:
                self._registered.add(int(args[0]))
            return ("ok",)
        if cmd == "ready":
            # the rank finished ompi_tpu_torch.init(): user code is
            # running from here on
            with self._cv:
                self._ready.add(int(args[0]))
            return ("ok",)
        if cmd == "doctor":
            # hang-doctor responder registration: the rank's capture
            # endpoint (UDP port, loopback on the rank's host)
            rank, port = int(args[0]), int(args[1])
            with self._cv:
                self._doctor_ports[rank] = port
            return ("ok",)
        if cmd == "doctor_ports":
            with self._cv:
                return ("ok", dict(self._doctor_ports))
        if cmd == "fin":
            return ("ok",)
        raise PMIxError(f"unknown command {cmd!r}")

    def _check_fence_done(self, epoch: int) -> None:
        """With _cv held: a fence completes when every *live* rank arrived."""
        live = self.size - len(self._dead)
        if self._fence_counts.get(epoch, 0) >= live:
            self._fence_done.add(epoch)
            self._cv.notify_all()

    def proc_died(self, rank: int) -> None:
        """Launcher notification: rank exited abnormally. Re-evaluates every
        pending fence so survivors don't block on a dead peer forever."""
        with self._cv:
            self._dead.add(rank)
            for epoch in list(self._fence_counts):
                if epoch not in self._fence_done:
                    self._check_fence_done(epoch)
            self._cv.notify_all()

    # -- host-side access (launcher uses these directly) ------------------

    def lookup(self, key: str, rank: int = -1) -> Any:
        full = f"{key}@{rank}" if rank >= 0 else key
        with self._cv:
            return self._store.get(full)

    def publish(self, key: str, value: Any) -> None:
        with self._cv:
            self._store[key] = value
            self._cv.notify_all()

    def close(self) -> None:
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass


class PMIxClient:
    """App-proc side client. Thread-safe (one in-flight request at a time)."""

    def __init__(self, uri: Optional[str] = None, rank: Optional[int] = None,
                 size: Optional[int] = None) -> None:
        uri = uri or os.environ.get(ENV_URI)
        if not uri:
            raise PMIxError(
                f"no rendezvous URI: {ENV_URI} not set (run under tpurun)")
        self.rank = rank if rank is not None else int(os.environ[ENV_RANK])
        self.size = size if size is not None else int(os.environ[ENV_SIZE])
        host, port = uri.removeprefix("tcp://").rsplit(":", 1)
        self._sock = socket.create_connection((host, int(port)))
        self._lock = threading.Lock()
        self._local: dict[str, Any] = {}
        # register: boot is over (interpreter + framework imports are
        # behind us)
        self._rpc("reg", self.rank)

    def _rpc(self, *msg: Any) -> tuple:
        with self._lock:
            _send_frame(self._sock, dss.pack(tuple(msg)))
            payload = _recv_frame(self._sock)
        if payload is None:
            raise PMIxError("connection to rendezvous server lost")
        reply = dss.unpack(payload, n=1)[0]
        if reply[0] == "abort":
            raise PMIxError(
                f"job aborted by rank {reply[1]} (status {reply[2]}): {reply[3]}")
        if reply[0] == "err":
            raise PMIxError(reply[1])
        if reply[0] == "timeout":
            raise TimeoutError("pmix get timed out")
        return reply

    def put(self, key: str, value: Any) -> None:
        self._local[key] = value
        self._rpc("put", self.rank, key, value)

    def get(self, key: str, rank: int = -1, timeout: float = 60.0) -> Any:
        if rank == self.rank and key in self._local:
            return self._local[key]
        return self._rpc("get", key, rank, float(timeout))[1]

    def fence(self, collect: bool = False) -> Optional[dict]:
        reply = self._rpc("fence", self.rank, bool(collect))
        return reply[1] if collect else None

    def barrier(self) -> None:
        self.fence(collect=False)

    def ready(self) -> None:
        """One-way init-complete notice: this rank finished
        ompi_tpu_torch.init() and user code is running."""
        self._rpc("ready", self.rank)

    def abort(self, msg: str = "", status: int = 1) -> None:
        self._rpc("abort", self.rank, int(status), msg)

    def register_doctor(self, port: int) -> None:
        """Register this rank's hang-doctor responder UDP port with the
        control plane."""
        self._rpc("doctor", self.rank, int(port))

    def doctor_ports(self) -> dict[int, int]:
        """Every registered hang-doctor responder port by rank (the
        registration-free probe non-rank callers must use is
        :func:`query_doctor_ports`)."""
        return {int(r): int(p)
                for r, p in dict(self._rpc("doctor_ports")[1]).items()}

    def finalize(self) -> None:
        try:
            self._rpc("fin", self.rank)
        finally:
            self._sock.close()


def _oneshot_query(uri: str, cmd: str,
                   timeout: float) -> Optional[tuple]:
    """One transient connection, one command, one "ok" reply — the
    skeleton of a registration-free probe (a non-rank caller must NOT
    send "reg").  None when the server is unreachable or the reply is
    not ok."""
    host, port = uri.removeprefix("tcp://").rsplit(":", 1)
    try:
        with socket.create_connection((host, int(port)),
                                      timeout=timeout) as sock:
            sock.settimeout(timeout)
            _send_frame(sock, dss.pack((cmd,)))
            payload = _recv_frame(sock)
        if payload is None:
            return None
        reply = dss.unpack(payload, n=1)[0]
        if reply[0] != "ok":
            return None
        return tuple(reply[1:])
    except (OSError, ValueError, IndexError):
        return None


def query_doctor_ports(uri: str,
                       timeout: float = 2.0) -> Optional[dict[int, int]]:
    """One-shot, registration-free probe of the registered hang-doctor
    responder ports → {rank: udp_port}.  None when the server is
    unreachable."""
    reply = _oneshot_query(uri, "doctor_ports", timeout)
    if reply is None or not reply:
        return None
    try:
        return {int(r): int(p) for r, p in dict(reply[0]).items()}
    except (TypeError, ValueError):
        return None
