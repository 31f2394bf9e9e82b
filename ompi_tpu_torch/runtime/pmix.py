"""Rendezvous / modex service: put, get, fence, abort (the port's copy of
the JAX package's ``runtime/pmix.py``).

≈ opal/mca/pmix (pmix.h:328-861: put :396, get :407, fence :384) plus the
server side ORTE provides.  The launcher (HNP) hosts a TCP key-value server;
every app proc connects as a client using the ``OMPI_TPU_HNP_URI`` it
inherits.  The *modex* — each rank publishing its business card (host p2p
listening address, chip binding) and fencing — is exactly the reference's
PMIx_Put/Commit/Fence flow from ompi_mpi_init.c:673-703.

The env names, the commands and the wire format are the JAX package's,
the failure side included: ``proc_died``/``proc_revived`` with the
stale-report gate (``pmix_register_grace_s``), the ``failed``,
``report_failed``, ``coll_rejoin`` and ``adopted`` commands the ULFM
detector and the errmgr policies use, and the registration time the
crash-loop governor measures uptime from (``on_client_contact``).  The
hang doctor's ports are kept: a rank registers its responder's UDP port
(``doctor``), and ``doctor_ports``/``query_doctor_ports`` read them back.
The registration-free readiness probes (``regcount``,
``query_regstate``/``query_regcount``) are kept too: the orted's
barrier-keyed daemon kill (``faultinject.arm_daemon_launch``) reads them.

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
import time
from typing import Any, Callable, Optional

from ompi_tpu_torch.core import dss, output
from ompi_tpu_torch.core.config import VarType, register_var, var_registry

__all__ = ["PMIxServer", "PMIxClient", "PMIxError", "query_regcount",
           "query_regstate", "query_doctor_ports"]

_log = output.get_stream("pmix")

register_var("pmix", "register_grace_s", VarType.DOUBLE, 20.0,
             "wedge escape for the stale-failure-report gate: a "
             "revived life normally announces its incarnation, and "
             "reports stamped with an older one are dropped.  A life "
             "still silent this long after its revive — never "
             "registered (SIGSTOP, OOM stall, import deadlock during "
             "boot), or registered but hung before any survivor "
             "adopted its incarnation — is presumed wedged: reports "
             "about it are accepted regardless of incarnation so it "
             "can be re-reaped instead of stalling the job forever.  "
             "The escape closes permanently for a life once any "
             "survivor reports having adopted its incarnation (an "
             "adopted life provably announced — a later stale report "
             "is a partitioned reporter or a cached dead-life probe, "
             "not a wedge).  0 disables the escape (stale reports are "
             "always dropped)")

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
        # optional launcher hook for client-reported failures (a rank's
        # gossip detector declaring a hung-but-alive peer): called once
        # per newly-reported rank with (rank, reason) so the launcher can
        # reap the pid — the exit report then drives the errmgr normally
        self.on_failed_report: Optional[Callable[[int, str], None]] = None
        # optional launcher hook fired once per life when the rank's
        # client registers ("reg", sent at PMIxClient construction): the
        # errmgr crash-loop governor starts the uptime clock here so
        # interpreter and framework boot never count toward errmgr_min_uptime_s
        self.on_client_contact: Optional[Callable[[int], None]] = None
        self._store: dict[str, Any] = {}
        self._cv = threading.Condition()
        self._fence_counts: dict[int, int] = {}
        self._fence_done: set[int] = set()
        self._client_epoch: dict[int, int] = {}
        self._dead: set[int] = set()
        self._failed_reasons: dict[int, str] = {}
        self._life: dict[int, int] = {}   # rank → current incarnation
        self._finished: set[int] = set()  # ranks that exited cleanly
        self._registered: set[int] = set()  # ranks whose CURRENT life reg'd
        self._ready: set[int] = set()   # ranks whose current life LEFT
        # init (the one-way "ready" notice at the end of ompi_tpu.init)
        self._revived_at: dict[int, float] = {}  # rank → last revive time
        self._adopted_life: dict[int, int] = {}  # rank → highest life any
        # SURVIVOR adopted (the "adopted" RPC, pushed once per life per
        # survivor on its peer_reincarnated transition): an adopted life
        # provably announced — it cannot be boot-wedged, so the stale-
        # report escape below closes for it and a late stale report
        # (partitioned reporter, cached dead-life pid probe) can no
        # longer SIGKILL a long-healthy revived rank
        self._doctor_ports: dict[int, int] = {}  # rank → hang-doctor
        # responder UDP port (current life only; a revive drops it until
        # the new life re-registers)
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
            # client registration (sent once at PMIxClient construction):
            # marks the rank's CURRENT life as having finished booting.
            # Gates the stale-report escape below and starts the errmgr
            # governor's uptime clock via on_client_contact.
            rank = int(args[0])
            with self._cv:
                first = rank not in self._registered
                self._registered.add(rank)
            if first and self.on_client_contact is not None:
                try:
                    self.on_client_contact(rank)
                except Exception as e:  # noqa: BLE001 — server survives
                    _log.error("on_client_contact(%d) failed: %r", rank, e)
            return ("ok",)
        if cmd == "regcount":
            # introspection: how many ranks' CURRENT lives have
            # registered (finished booting), how many fence epochs have
            # completed, and how many ranks are READY (left init — the
            # one-way notice below).  Chaos schedules key on these
            # (``daemon=V:kill@reg=N`` fires only once N ranks are
            # ready, so the kill cannot land mid-init), and together
            # they make a cheap job-readiness probe.
            with self._cv:
                return ("ok", len(self._registered),
                        len(self._fence_done), len(self._ready))
        if cmd == "ready":
            # the rank's current life finished ompi_tpu_torch.init(): user
            # code is running from here on
            with self._cv:
                self._ready.add(int(args[0]))
            return ("ok",)
        if cmd == "adopted":
            # a survivor adopted a peer's new incarnation (its rebind /
            # first si-stamped frame arrived): the life announced, so it
            # is not boot-wedged — close the stale-report escape for it
            rank, inc = int(args[0]), int(args[1])
            with self._cv:
                if inc > self._adopted_life.get(rank, 0):
                    self._adopted_life[rank] = inc
            return ("ok",)
        if cmd == "coll_rejoin":
            # one-way notice: the rank finished its epoch-fenced rebuild
            # of the coll/shm hierarchy after a revive (the rejoin half
            # of the selfheal cycle) — recorded on the FT timeline so
            # /status (and the --dvm-ps rejoins column, fed by the
            # coll_rejoin_total pvar on the metrics uplink) shows it.
            # jobid 0: the server is per-job, and jobid-0 events ride
            # every job filter by design (ftevents.snapshot)
            rank, oe, ne, ms = (int(args[0]), int(args[1]),
                                int(args[2]), int(args[3]))
            from ompi_tpu_torch.runtime import ftevents

            with self._cv:
                lives = self._life.get(rank, 0)
            ftevents.record("coll_rejoin", jobid=0, rank=rank,
                            lives=lives, old_epoch=oe, new_epoch=ne,
                            rebuild_ms=ms)
            return ("ok",)
        if cmd == "report_failed":
            # the reverse direction of "failed": an app rank PUSHES a
            # death its rank-plane gossip detector observed (hung pid —
            # alive to the daemon heartbeats, silent to its peers).  The
            # dead-set gains it (so every other detector's poll sees it)
            # and the launcher hook may reap the pid.
            reporter, failed_rank, reason = args[:3]
            # optional 4th arg: the incarnation the reporter observed
            # dead.  Under a reviving errmgr (respawn/selfheal) several
            # reporters race to declare the same corpse — the first
            # report reaps and revives it, and a second report about the
            # DEAD life must not SIGKILL the new one (or re-poison the
            # dead-set the revive just cleared).
            inc = int(args[3]) if len(args) > 3 else 0
            failed_rank = int(failed_rank)
            with self._cv:
                if inc < self._life.get(failed_rank, 0):
                    # stale — UNLESS the current life is wedged: revived
                    # a while ago yet either never registered (hung
                    # during interpreter boot) or registered but hung
                    # before its announce/beats reached any survivor.
                    # Either way no reporter can ever have adopted its
                    # incarnation, so the gate would drop every report
                    # forever, leaving a hung pid unreapable.  grace 0
                    # disables the escape: an always-open escape would
                    # let a racing stale report SIGKILL a legitimately
                    # booting revived rank.
                    revived_at = self._revived_at.get(failed_rank)
                    grace = float(
                        var_registry.get("pmix_register_grace_s") or 0)
                    adopted = (self._adopted_life.get(failed_rank, 0)
                               >= self._life.get(failed_rank, 0))
                    wedged = (grace > 0
                              and not adopted
                              and revived_at is not None
                              and time.monotonic() - revived_at >= grace)
                    if not wedged:
                        _log.verbose(1, "stale failure report for rank %d "
                                     "(life %d < %d); ignored", failed_rank,
                                     inc, self._life[failed_rank])
                        return ("ok", "stale")
                    _log.verbose(1, "accepting stale-incarnation report "
                                 "for rank %d: life %d %s within %.1fs "
                                 "(wedged)", failed_rank,
                                 self._life[failed_rank],
                                 ("never registered"
                                  if failed_rank not in self._registered
                                  else "registered but never adopted by "
                                  "any survivor"),
                                 grace)
                if failed_rank in self._finished:
                    # the rank exited CLEANLY: its gossip beats stopped
                    # with its transports, which peers can misread as a
                    # hang — poisoning the dead-set (or reaping a pid
                    # slot) for a rank that finished its work would turn
                    # a healthy completion into a failure event
                    _log.verbose(1, "failure report for finished rank "
                                 "%d; ignored", failed_rank)
                    return ("ok", "finished")
                fresh = failed_rank not in self._dead
                if fresh:
                    self._dead.add(failed_rank)
                    if reason:
                        self._failed_reasons[failed_rank] = str(reason)
                    for epoch in list(self._fence_counts):
                        if epoch not in self._fence_done:
                            self._check_fence_done(epoch)
                    self._cv.notify_all()
            if fresh:
                _log.verbose(1, "rank %s reported rank %d failed (%s)",
                             reporter, failed_rank, reason)
                if self.on_failed_report is not None:
                    try:
                        self.on_failed_report(failed_rank, str(reason))
                    except Exception as e:  # noqa: BLE001 — server survives
                        _log.error("on_failed_report(%d) failed: %r",
                                   failed_rank, e)
            return ("ok",)
        if cmd == "failed":
            # ULFM failure-detector query: the launcher's reap loop /
            # heartbeat monitor feeds _dead via proc_died; app ranks poll
            # this to turn silent peer death into MPI_ERR_PROC_FAILED
            with self._cv:
                return ("ok", sorted(self._dead),
                        dict(self._failed_reasons))
        if cmd == "doctor":
            # hang-doctor responder registration: the rank's capture
            # endpoint (UDP port, loopback on the rank's host) — the
            # owning orted resolves it through "doctor_ports" when a
            # TAG_DOCTOR capture fans out
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

    def proc_finished(self, rank: int) -> None:
        """Launcher notification: the rank exited CLEANLY (rc 0).  Its
        beats/transports are gone, so late gossip suspicions about it
        are completion, not failure — ``report_failed`` ignores them."""
        with self._cv:
            self._finished.add(rank)

    def proc_died(self, rank: int, reason: str = "") -> None:
        """Launcher notification: rank exited abnormally. Re-evaluates every
        pending fence so survivors don't block on a dead peer forever."""
        with self._cv:
            self._dead.add(rank)
            if reason:
                self._failed_reasons[rank] = reason
            for epoch in list(self._fence_counts):
                if epoch not in self._fence_done:
                    self._check_fence_done(epoch)
            self._cv.notify_all()

    def proc_revived(self, rank: int,
                     incarnation: Optional[int] = None) -> None:
        """errmgr respawn/selfheal notification: the rank is back.
        Future fences count it again; its fence-epoch counter restarts
        (already-completed epochs return immediately, so a restarted rank
        fast-forwards through barriers the survivors already passed).
        ``incarnation`` (the new life number, = the monotone
        ``proc.lives`` — NOT the governor-resettable restart budget)
        fences stale ``report_failed`` pushes about the dead life."""
        with self._cv:
            self._dead.discard(rank)
            self._failed_reasons.pop(rank, None)
            self._finished.discard(rank)
            self._client_epoch[rank] = 0
            self._life[rank] = (self._life.get(rank, 0) + 1
                                if incarnation is None else int(incarnation))
            # the new life hasn't booted yet: it must "reg" again, and
            # the boot-wedge escape measures from this revive
            self._registered.discard(rank)
            self._ready.discard(rank)
            # the dead life's doctor endpoint is a stale port — a
            # capture must not read a stranger's socket
            self._doctor_ports.pop(rank, None)
            self._revived_at[rank] = time.monotonic()
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


def _oneshot_query(uri: str, cmd: str,
                   timeout: float) -> Optional[tuple]:
    """One transient connection, one command, one "ok" reply — the
    shared skeleton of every registration-free probe (a non-rank caller
    must NOT send "reg": it would inflate the very barrier it watches).
    None when the server is unreachable or the reply is not ok."""
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


def query_regstate(uri: str, timeout: float = 2.0
                   ) -> Optional[tuple[int, int, int]]:
    """One-shot, registration-free probe of the server's readiness
    state → ``(ranks_registered, fence_epochs_done, ranks_ready)``.
    None when the server is unreachable."""
    reply = _oneshot_query(uri, "regcount", timeout)
    if reply is None or not reply:
        return None
    try:
        return (int(reply[0]),
                int(reply[1]) if len(reply) > 1 else 0,
                int(reply[2]) if len(reply) > 2 else 0)
    except (TypeError, ValueError):
        return None


def query_regcount(uri: str, timeout: float = 2.0) -> Optional[int]:
    """The ranks-registered half of :func:`query_regstate`."""
    state = query_regstate(uri, timeout=timeout)
    return None if state is None else state[0]


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
        # register this life: boot is over (interpreter + framework
        # imports are behind us) — the server starts the crash-loop
        # governor's uptime clock and lifts the boot-wedge presumption
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

    def regcount(self) -> int:
        """How many ranks' current lives have registered with the server
        — the ranks-registered barrier (see :func:`query_regcount` for
        the registration-free variant non-rank probes must use)."""
        return int(self._rpc("regcount")[1])

    def ready(self) -> None:
        """One-way init-complete notice: this life finished
        ompi_tpu_torch.init() and user code is running (counts toward the
        readiness probe's third field)."""
        self._rpc("ready", self.rank)

    def failed_ranks(self) -> dict[int, str]:
        """The runtime's current dead-set (ranks the launcher reaped dead
        or the heartbeat monitor declared silent) → human-readable
        reason ('' when the runtime recorded none) — the control-plane
        source the ULFM failure detector (mpi/ft.py) polls."""
        reply = self._rpc("failed")
        reasons = reply[2] if len(reply) > 2 else {}
        return {int(r): str(reasons.get(r, "")) for r in reply[1]}

    def report_failed(self, failed_rank: int, reason: str = "",
                      incarnation: int = 0) -> Optional[str]:
        """Push a locally-observed death (gossip suspect, arena pid
        probe) into the runtime dead-set so the control plane — and
        every other rank's detector poll — learns it, and the launcher
        can reap a hung-but-alive pid.  ``incarnation`` is the life of
        the rank the reporter observed dead (its adopted incarnation
        number) — the server drops reports about already-reaped lives so
        racing reporters cannot kill a freshly-revived rank.  Returns
        the server's gate verdict: ``"stale"`` / ``"finished"`` when the
        report was dropped, None when it was taken (the caller retries
        stale-gated pushes — a life that wedges after the drop would
        otherwise never be re-reported)."""
        reply = self._rpc("report_failed", self.rank, int(failed_rank),
                          reason, int(incarnation))
        return reply[1] if len(reply) > 1 else None

    def register_doctor(self, port: int) -> None:
        """Register this rank's hang-doctor responder UDP port with the
        control plane (the owning orted queries it on TAG_DOCTOR)."""
        self._rpc("doctor", self.rank, int(port))

    def doctor_ports(self) -> dict[int, int]:
        """Every registered hang-doctor responder port by rank (the
        registration-free probe non-rank callers must use is
        :func:`query_doctor_ports`)."""
        return {int(r): int(p)
                for r, p in dict(self._rpc("doctor_ports")[1]).items()}

    def coll_rejoin(self, old_epoch: int, new_epoch: int,
                    rebuild_ms: int) -> None:
        """One-way notice that this rank completed an epoch-fenced
        rebuild of its coll/shm hierarchy after a revive was adopted
        (old -> new coll epoch, rebuild latency) — lands on the HNP's
        FT timeline as a ``coll_rejoin`` event.  Best-effort
        observability; called from the coll dispatch (app) thread."""
        self._rpc("coll_rejoin", self.rank, int(old_epoch),
                  int(new_epoch), int(rebuild_ms))

    def peer_adopted(self, rank: int, incarnation: int) -> None:
        """Tell the control plane this process adopted ``rank``'s new
        life ``incarnation`` (its rebind / first si-stamped frame
        arrived): the life provably announced, so the server's
        boot-wedge escape closes for it and a late stale-incarnation
        report can no longer reap the healthy rank.  Pushed once per
        adopted life per survivor (see ``PmlFT.peer_reincarnated``)."""
        self._rpc("adopted", int(rank), int(incarnation))

    def abort(self, msg: str = "", status: int = 1) -> None:
        self._rpc("abort", self.rank, int(status), msg)

    def finalize(self) -> None:
        try:
            self._rpc("fin", self.rank)
        finally:
            self._sock.close()
