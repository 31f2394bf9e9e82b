"""RML — the runtime's tagged messaging bus over a routed daemon tree (the
port's copy of the JAX package's ``runtime/rml.py``, whole: every tag,
the DVM's included, and the same DSS frames, so a port daemon and a JAX
package daemon read each other's frames).

≈ orte/mca/rml (rml.h:373,412 send/recv_buffer_nb) + orte/mca/oob/tcp +
orte/mca/routed/binomial (routed.h:123) + grpcomm xcast (grpcomm.h:110),
collapsed into one module sized for tens of hosts, not tens of thousands:

- Every runtime node (the HNP = vpid 0, one daemon per host = vpid 1..N)
  is an :class:`RmlNode` with a TCP listener and tag→handler registry.
- **Bootstrap** is the reference's phone-home: each daemon dials the HNP
  and registers (vpid, uri).  When all have reported, the HNP computes a
  binary routing tree and sends each daemon a WIRE message naming its
  children; every parent then dials its children (the routed overlay).
- **xcast(tag, payload)** floods down the tree: each node delivers
  locally and relays to its children — O(log n) fan-out from the HNP,
  exactly grpcomm/xcast's job.
- **send_up(tag, payload)** relays toward vpid 0 through parents — the
  daemons' report channel (IOF, proc exits, registrations).

Messages are DSS-framed ``(kind, tag, origin, payload)`` tuples; handlers
run on the link reader thread (keep them short or hand off, the same
contract as the reference's event-loop callbacks).

Every link is a :class:`_Link` — (socket, send-lock) — because frames are
written by many threads (IOF readers, exit waiters, relays) and
``sendall`` is not atomic under backpressure: without the lock, partial
sends interleave and corrupt the length-prefixed stream (the same reason
TcpBTL keeps a per-socket lock).
"""

from __future__ import annotations

import heapq
import socket
import struct
import sys
import threading
import time
from typing import Any, Callable, Optional

from ompi_tpu_torch.core import dss, output
from ompi_tpu_torch.core.config import VarType, register_var, var_registry

__all__ = ["RmlNode", "tree_children", "tree_parent",
           "nearest_live_ancestor", "HeartbeatMonitor", "start_heartbeats",
           "scaled_timeout"]

_log = output.get_stream("rml")

register_var("rml", "heartbeat_period", VarType.DOUBLE, 0.0,
             "seconds between daemon liveness heartbeats up the tree "
             "(0 = disabled; link EOF detection still applies)")
register_var("rml", "heartbeat_timeout", VarType.DOUBLE, 3.0,
             "seconds of heartbeat silence before the HNP declares a "
             "daemon dead (only meaningful with rml_heartbeat_period > 0)")
register_var("rml", "reparent_timeout", VarType.DOUBLE, 10.0,
             "seconds an orphaned orted (tree parent lost under the "
             "notify errmgr policy) waits for the HNP-arbitrated "
             "re-parenting handshake before falling back to the lifeline "
             "teardown")

# well-known tags (≈ orte/mca/rml/rml_types.h:59-69)
TAG_REGISTER = "register"       # daemon → HNP: (vpid, uri, hostname)
TAG_WIRE = "wire"               # HNP → daemon: children to dial
TAG_LAUNCH = "launch"           # xcast: proc table
TAG_KILL = "kill"               # xcast: jobid | None — tear ONE job
#                                 down (daemons drop its spec/procs)
#                                 or, with None, every job (lifeline
#                                 teardown / VM shutdown)
TAG_SHUTDOWN = "shutdown"       # xcast: daemons exit
TAG_IOF = "iof"                 # up: (jobid, rank, stream, chunk)
TAG_STDIN = "stdin"             # xcast: (target_rank, chunk | None=EOF)
TAG_PROC_EXIT = "proc_exit"     # up: (jobid, rank, rc, errmsg)
TAG_DAEMON_READY = "ready"      # up: daemon wired + children connected
TAG_RESPAWN = "respawn"         # xcast: {jobid, rank, lives, target,
#                                 local_rank, chip} — the daemon whose
#                                 vpid == target adopts the row and
#                                 revives the rank (migration: every
#                                 daemon holds the job spec, so the
#                                 target need not be the original
#                                 owner); other daemons drop the row
TAG_STATS = "stats"             # xcast: request per-rank resource usage
TAG_STATS_REPLY = "stats_reply"  # up: (vpid, epoch,
#                                 [(jobid, rank, pid, rss, cpu_s)...])
TAG_HEARTBEAT = "heartbeat"     # up: vpid — daemon liveness beat
TAG_PROC_FAILED = "proc_failed"  # xcast: (rank, reason) — errmgr notify
#                                  propagating a rank death to survivors
#                                  instead of killing the job
TAG_ORPHANED = "orphaned"       # direct (boot link) daemon → HNP:
#                                 (vpid, lost_parent) — my tree parent
#                                 vanished; arbitrate a re-parenting
TAG_REPARENT = "reparent"       # direct HNP → orphan: new parent vpid —
#                                 expect its hello instead of tearing down
TAG_ADOPT = "adopt"             # direct HNP → adopter: [(vpid, uri), ...]
#                                 orphans to dial as tree children
TAG_REPARENT_ACK = "reparent_ack"  # up: (vpid, new_parent) — re-wired
TAG_KILL_RANK = "kill_rank"     # xcast: (jobid, rank) — the owning
#                                 daemon SIGKILLs
#                                 exactly that rank (reaping a hung pid
#                                 the gossip detector reported)
TAG_SIGNAL_RANK = "signal_rank"  # xcast: (jobid, rank, signum) — the
#                                 owning daemon signals the rank's
#                                 process group (the DVM remediation
#                                 actor's SIGCONT probe: resume a
#                                 SIGSTOP'd straggler before paying a
#                                 reap-and-revive)
TAG_DOCTOR = "doctor"           # xcast: epoch — every orted captures its
#                                 local ranks' hang-doctor state (UDP
#                                 query of each rank's responder; /proc
#                                 probe for frozen pids) and replies up
TAG_DOCTOR_REPLY = "doctor_reply"  # up: (vpid, epoch, [capture, ...]) —
#                                 the per-rank doctor captures the
#                                 HNP/DVM analyzer folds into a verdict
TAG_METRICS = "metrics"         # hop (one tree level, delivered at EVERY
#                                 hop, not send_up's root-only relay):
#                                 {jobid: {rank: [wall_ts, {pvar: value}]}}
#                                 — each orted merges its children's
#                                 payloads with its local ranks' and
#                                 forwards one combined delta per
#                                 trace_metrics_push_period; the HNP/DVM
#                                 folds the stream into the scrape
#                                 aggregate
TAG_CLOCK = "clock"             # hop child → parent: (vpid, seq, t0_ns) —
#                                 one leg of the min-RTT clock pingpong;
#                                 the receiving hop answers immediately so
#                                 each edge of the tree is measured against
#                                 its OWN parent (offsets compose down)
TAG_CLOCK_REPLY = "clock_reply"  # direct parent → child:
#                                 (seq, t0_ns, t_parent_ns) — t0 echoed so
#                                 the prober needs no outstanding-probe
#                                 table; the child stamps t3 on delivery
TAG_TIMELINE = "timeline"       # xcast: (epoch, tail) — every orted
#                                 gathers bounded flight-recorder tails
#                                 from its local ranks (UDP query of each
#                                 responder) and replies up: the live
#                                 /timeline capture, same shape as
#                                 TAG_DOCTOR
TAG_TIMELINE_REPLY = "timeline_reply"  # up: (vpid, epoch, [capture, ...])
#                                 — per-rank recorder tails the HNP/DVM
#                                 merges into one skew-corrected trace


def _pack_env(kind: str, tag: str, origin: int, payload: Any) -> bytes:
    """Frame one RML envelope.  With the flight recorder armed in this
    process the envelope grows a 5th element — the ``(trace_id,
    span_id)`` pair — and an ``rml_send`` instant lands in the
    recorder; the receiving side's matching ``rml_recv`` instant lets
    the timeline merge draw an arrow per OOB edge (control traffic —
    doctor rounds, rejoin epochs, metrics hops — becomes causally
    visible next to the data plane).  Readers tolerate both widths, so
    instrumented and plain processes interoperate.  Cost with tracing
    off (every daemon's default): one attribute check."""
    tc = None
    # sys.modules, not an import: the MPI layer must only be consulted
    # when something else already loaded it — a bare daemon's OOB sends
    # must not drag numpy into the orted process
    trace = sys.modules.get("ompi_tpu_torch.mpi.trace")
    if trace is not None:
        # the attribute reads live INSIDE the guard: sys.modules holds a
        # partially-initialized module while another thread runs its
        # first import, and an AttributeError here must degrade to an
        # unstamped envelope — not kill the send (an orphan report lost
        # to a tracing race once stalled a whole reparent epoch)
        try:
            if trace.active:
                tc = [trace.trace_id(), trace.next_span_id()]
                trace.instant("runtime", "rml_send", tag=tag, tc=tc)
        except Exception:  # noqa: BLE001 — tracing never breaks the OOB plane
            tc = None
    if tc is None:
        return dss.pack((kind, tag, origin, payload))
    return dss.pack((kind, tag, origin, payload, tc))


def _note_recv(tag: str, tc: Any) -> None:
    """The receive half of the envelope trace pair (no-op unless this
    process has the flight recorder armed)."""
    trace = sys.modules.get("ompi_tpu_torch.mpi.trace")
    if trace is not None:
        try:  # see _pack_env on the partial-import hazard
            if trace.active:
                trace.instant("runtime", "rml_recv", tag=tag,
                              tc=list(tc))
        except Exception:  # noqa: BLE001
            pass


def tree_parent(vpid: int) -> Optional[int]:
    """Binary routing tree over vpids 0..N (0 = HNP) — the k=2 case of
    the shared netpatterns k-ary tree (≈ routed/binomial's role)."""
    from ompi_tpu_torch.core.netpatterns import kary_parent

    return kary_parent(vpid, k=2)

def tree_children(vpid: int, n: int) -> list[int]:
    """Children of ``vpid`` among vpids 0..n-1."""
    from ompi_tpu_torch.core.netpatterns import kary_children

    return kary_children(vpid, n, k=2)


def nearest_live_ancestor(vpid: int, dead: set[int]) -> int:
    """The closest ancestor of ``vpid`` not in ``dead`` — the adopter a
    mid-tree daemon death hands its orphans to (vpid arithmetic on the
    routing tree; the HNP, vpid 0, is never in ``dead``)."""
    p = tree_parent(vpid)
    while p is not None and p in dead:
        p = tree_parent(p)
    return 0 if p is None else p


#: routing-tree depth at which timeout scaling kicks in — depth 4 covers
#: a 31-node world, so every historical small-world test keeps its exact
#: configured timeout (factor 1.0) while a 100-daemon world gets 1.5x
#: and a 1000-daemon world 2.25x
_SCALE_BASE_DEPTH = 4


def scaled_timeout(base: float, world: int) -> float:
    """A liveness window scaled with world size: beats and reparent acks
    cross ``tree_depth`` store-and-forward hops, and a correlated loss
    makes every survivor re-wire at once — a timeout tuned on a 9-rank
    world declares half a 1000-rank fleet dead during one reparent wave.
    Scale is the routing-tree depth relative to :data:`_SCALE_BASE_DEPTH`
    (never below 1.0, so small worlds keep their configured window)."""
    from ompi_tpu_torch.core.netpatterns import tree_depth

    depth = tree_depth(max(1, int(world)), k=2)
    return float(base) * max(1.0, depth / _SCALE_BASE_DEPTH)


class _Link:
    """One framed TCP link with a serialized writer side."""

    __slots__ = ("sock", "_wlock")

    def __init__(self, sock: socket.socket) -> None:
        self.sock = sock
        self._wlock = threading.Lock()

    def send(self, payload: bytes) -> None:
        frame = struct.pack("<I", len(payload)) + payload
        with self._wlock:
            self.sock.sendall(frame)

    def close(self) -> None:
        # shutdown() before close(): a close() alone does NOT tear the
        # connection down while this node's own reader is blocked in
        # recv on the fd (the in-flight syscall pins the file, so the
        # FIN is deferred until it returns — which is never, since the
        # peer is waiting on us).  A process death releases every ref at
        # once, but an in-process daemon (simfleet) or any multi-link
        # teardown needs the explicit half-close to wake both sides
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


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


class RmlNode:
    """One runtime node on the bus (HNP or daemon)."""

    def __init__(self, vpid: int, host: str = "127.0.0.1") -> None:
        self.vpid = vpid
        self._handlers: dict[str, Callable[[int, Any], None]] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._parent_link: Optional[_Link] = None
        self.parent_wired = threading.Event()  # set when the up-link exists
        # which vpid is allowed to become my parent: tree position by
        # default, retargeted by the re-parenting handshake (an orphaned
        # daemon starts expecting its adopter instead)
        self.parent_vpid: Optional[int] = tree_parent(vpid)
        self._pending_hellos: dict[int, _Link] = {}  # hellos from peers
        # that are not (yet) my parent — an adopter's dial can race the
        # HNP's TAG_REPARENT order, so the link is kept until retargeted
        # an up-path of last resort (the daemon's bootstrap link to the
        # HNP): used while orphaned, so exit reports / heartbeats survive
        # the window between losing a parent and being adopted
        self.fallback_up: Optional[_Link] = None
        self._child_links: dict[int, _Link] = {}
        self.boot_links: dict[int, _Link] = {}  # HNP: vpid → link
        # Called with the peer vpid when a known link hits EOF — the
        # lifeline-lost signal (≈ ORTE aborting on a lost daemon lifeline).
        self.on_peer_lost: Optional[Callable[[int], None]] = None
        # Partition-injection seam: when set, called as gate(direction,
        # tag) with direction "in"/"out" before any non-hello frame is
        # delivered or sent; returning False blackholes the frame with
        # the socket left alive — a true network partition (no EOF, no
        # RST), unlike close().  Must be non-blocking: the inbound check
        # runs on the link reader thread.  None (the default) costs one
        # attribute test per frame.
        self.frame_gate: Optional[Callable[[str, str], bool]] = None
        self._listener = socket.create_server((host, 0), backlog=32)
        self.uri = f"{host}:{self._listener.getsockname()[1]}"
        self._threads: list[threading.Thread] = []
        t = threading.Thread(target=self._accept_loop,
                             name=f"rml-accept-{vpid}", daemon=True)
        t.start()
        self._threads.append(t)

    # -- wiring -----------------------------------------------------------

    def register_recv(self, tag: str,
                      cb: Callable[[int, Any], None]) -> None:
        """Register cb(origin_vpid, payload) for a tag (≈ rml.h:412)."""
        with self._lock:
            self._handlers[tag] = cb

    def dial_bootstrap(self, hnp_uri: str) -> _Link:
        """Daemon side phone-home: a direct link to the HNP used ONLY for
        registration and the WIRE reply (the tree does not exist yet —
        ≈ orted's callback to mpirun, orted_main.c)."""
        host, port = hnp_uri.rsplit(":", 1)
        sock = socket.create_connection((host, int(port)))
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        link = _Link(sock)
        link.send(dss.pack(("hello", self.vpid)))
        self._spawn_reader(link, 0)
        return link

    def dial_children(self, children: list[tuple[int, str]]) -> None:
        """Parent side: connect the down-links (the routed overlay edges)."""
        for cvpid, curi in children:
            host, port = curi.rsplit(":", 1)
            sock = socket.create_connection((host, int(port)))
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            link = _Link(sock)
            link.send(dss.pack(("hello", self.vpid)))
            with self._lock:
                self._child_links[cvpid] = link
            self._spawn_reader(link, cvpid)

    def wait_parent(self, timeout: float) -> bool:
        """Block until the tree parent has dialed in (the up-link exists).

        The WIRE handler must call this before replying DAEMON_READY: WIRE
        arrives over the bootstrap link, but the reply rides the tree —
        and the parent's dial may still be in flight.
        """
        return self.parent_wired.wait(timeout)

    def retarget_parent(self, new_parent: int) -> None:
        """Re-parenting: expect ``new_parent``'s hello as my new up-link.

        If the adopter already dialed in (its hello raced the HNP's
        TAG_REPARENT order), the pending link is promoted immediately;
        otherwise ``parent_wired`` clears until the hello arrives.
        """
        with self._lock:
            self.parent_vpid = new_parent
            link = self._pending_hellos.pop(new_parent, None)
            if link is None:
                self.parent_wired.clear()
            else:
                self._parent_link = link
                self.parent_wired.set()

    # -- traffic ----------------------------------------------------------

    def xcast(self, tag: str, payload: Any) -> None:
        """Deliver everywhere below me (incl. locally) — grpcomm xcast.

        Relay BEFORE local delivery: a handler may tear this node down
        (SHUTDOWN sets _done → close()), and relaying first guarantees the
        children got the message before our links can vanish.
        """
        if not self._gate("out", tag):
            return
        self._relay_down(tag, self.vpid, payload)
        self._deliver(tag, self.vpid, payload)

    def _gate(self, direction: str, tag: str) -> bool:
        gate = self.frame_gate
        if gate is None:
            return True
        try:
            return bool(gate(direction, tag))
        except Exception:  # noqa: BLE001 — a broken gate must not wedge the bus
            return True

    def send_up(self, tag: str, payload: Any) -> None:
        """Deliver at the HNP, relaying through the tree (or, while
        orphaned, over the bootstrap fallback link)."""
        if not self._gate("out", tag):
            return
        if self.vpid == 0:
            self._deliver(tag, 0, payload)
            return
        self._send_up_blob(_pack_env("up", tag, self.vpid, payload))

    def _send_up_blob(self, blob: bytes) -> None:
        """One pre-framed "up" message toward the HNP: the tree parent
        when wired, else the bootstrap fallback (re-parenting window —
        exit reports and heartbeats must survive an orphaned stretch)."""
        link = self._parent_link
        if link is not None and self.parent_wired.is_set():
            try:
                link.send(blob)
                return
            except OSError:
                pass  # parent just died — try the fallback below
        fb = self.fallback_up
        if fb is not None:
            fb.send(blob)
            return
        raise ConnectionError("rml: no parent link (not wired yet)")

    def send_direct(self, link: _Link, tag: str, payload: Any) -> None:
        """Bootstrap-only: a message over an explicit link (HNP replies to
        a registration before the tree exists)."""
        if not self._gate("out", tag):
            return
        link.send(_pack_env("direct", tag, self.vpid, payload))

    def send_child(self, vpid: int, tag: str, payload: Any) -> bool:
        """One message DOWN a single tree edge (or, at the HNP, down a
        bootstrap link) — the reply path for per-hop request/response
        exchanges like the TAG_CLOCK pingpong, where xcast (every
        descendant) and send_direct (caller must hold the link) both
        fit badly.  Returns False when no live link to ``vpid`` exists
        (the prober times out and retries — clock probes are lossy by
        design)."""
        if not self._gate("out", tag):
            return False
        with self._lock:
            link = self._child_links.get(vpid) or self.boot_links.get(vpid)
        if link is None:
            return False
        try:
            link.send(_pack_env("direct", tag, self.vpid, payload))
            return True
        except OSError:
            return False

    def send_hop(self, tag: str, payload: Any) -> None:
        """One tree level toward the root, DELIVERED at the receiving
        hop (unlike ``send_up``, which relays silently until vpid 0).
        The per-hop aggregation primitive: a mid-tree daemon's handler
        merges the payload and later forwards its own combined message —
        how TAG_METRICS folds a subtree's pvar deltas on the way up."""
        if not self._gate("out", tag):
            return
        if self.vpid == 0:
            self._deliver(tag, 0, payload)
            return
        self._send_up_blob(_pack_env("hop", tag, self.vpid, payload))

    def _relay_down(self, tag: str, origin: int, payload: Any) -> None:
        with self._lock:
            links = list(self._child_links.values())
        blob = _pack_env("xcast", tag, origin, payload)
        for link in links:
            try:
                link.send(blob)
            except OSError as e:
                _log.error("rml %d: xcast relay failed: %r", self.vpid, e)

    def _deliver(self, tag: str, origin: int, payload: Any,
                 tc: Any = None) -> None:
        if tc is not None:
            _note_recv(tag, tc)
        with self._lock:
            cb = self._handlers.get(tag)
        if cb is None:
            _log.verbose(1, "rml %d: no handler for tag %r", self.vpid, tag)
            return
        try:
            cb(origin, payload)
        except Exception as e:
            _log.error("rml %d: handler %r failed: %r", self.vpid, tag, e)

    # -- link management --------------------------------------------------

    def _accept_loop(self) -> None:
        try:
            self._listener.settimeout(0.2)
        except OSError:
            return
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._spawn_reader(_Link(conn), None)

    def _spawn_reader(self, link: _Link, peer: Optional[int]) -> None:
        t = threading.Thread(target=self._read_loop, args=(link, peer),
                             daemon=True)
        t.start()
        self._threads.append(t)

    def _read_loop(self, link: _Link, peer: Optional[int]) -> None:
        sock = link.sock
        with sock:
            while not self._stop.is_set():
                try:
                    blob = _recv_frame(sock)
                except OSError:
                    # an abrupt peer death arrives as an RST
                    # (ECONNRESET) — or EBADF when the peer's close()
                    # races this recv — not a clean FIN.  Either way
                    # the link is gone: take the same EOF path, so
                    # on_peer_lost fires instead of the reader dying
                    blob = None
                if blob is None:
                    break
                msg = dss.unpack(blob, n=1)[0]
                kind = msg[0]
                if kind == "hello":
                    peer = msg[1]
                    # an accepted hello from my expected parent IS my
                    # up-link; at the HNP an accepted hello is a bootstrap
                    # link; anything else is kept pending — a racing
                    # adopter whose TAG_REPARENT order is still in flight
                    with self._lock:
                        if self.parent_vpid == peer:
                            self._parent_link = link
                            self.parent_wired.set()
                        elif self.vpid != 0:
                            self._pending_hellos[peer] = link
                        if self.vpid == 0:
                            self.boot_links[peer] = link
                    continue
                tag, origin, payload = msg[1], msg[2], msg[3]
                if not self._gate("in", tag):
                    continue  # partitioned: the frame never arrived
                # instrumented senders append a (trace_id, span_id)
                # envelope stamp; plain 4-tuples stay the common case
                tc = msg[4] if len(msg) > 4 else None
                if kind == "xcast":
                    # relay first — see xcast() on the SHUTDOWN/close race
                    self._relay_down(tag, origin, payload)
                    self._deliver(tag, origin, payload, tc)
                elif kind == "up":
                    if self.vpid == 0:
                        self._deliver(tag, origin, payload, tc)
                    else:
                        try:
                            self._send_up_blob(blob)
                        except (ConnectionError, OSError) as e:
                            _log.error("rml %d: up relay failed: %r",
                                       self.vpid, e)
                elif kind == "hop":
                    # one-level message: deliver HERE (the handler owns
                    # any further forwarding — per-hop merge semantics)
                    self._deliver(tag, origin, payload, tc)
                elif kind == "direct":
                    self._deliver(tag, origin, payload, tc)
                else:
                    _log.error("rml %d: unknown kind %r", self.vpid, kind)
        if peer is not None and not self._stop.is_set():
            # prune the dead link so xcast relays and adoptions never
            # write into a corpse (a re-parented tree re-adds live edges)
            with self._lock:
                if self._child_links.get(peer) is link:
                    del self._child_links[peer]
                if self._pending_hellos.get(peer) is link:
                    del self._pending_hellos[peer]
            cb = self.on_peer_lost
            if cb is not None:
                try:
                    cb(peer)
                except Exception as e:
                    _log.error("rml %d: peer-lost cb failed: %r",
                               self.vpid, e)

    def close(self) -> None:
        self._stop.set()
        try:  # wake a blocked accept() so the thread exits (see _Link)
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            links = list(self._child_links.values())
            self._child_links.clear()
            links += list(self.boot_links.values())
            self.boot_links.clear()
            links += list(self._pending_hellos.values())
            self._pending_hellos.clear()
        if self._parent_link is not None:
            links.append(self._parent_link)
        if self.fallback_up is not None:
            # the daemon-side bootstrap link: closing it is what gives
            # the HNP a prompt boot-link EOF for a dying daemon — a
            # LEAF daemon has no live children to report it orphaned,
            # so without this its death waits on heartbeat silence
            links.append(self.fallback_up)
        for link in links:
            link.close()


class HeartbeatMonitor:
    """HNP-side liveness watchdog over the daemon heartbeats.

    ≈ the sensor/heartbeat component of the reference: link EOF already
    catches clean daemon death (TCP RST), but a SIGSTOP'd daemon, a hung
    host, or a half-open connection across a network partition stays
    silent with the socket alive.  When ``rml_heartbeat_period`` > 0 each
    orted beats :data:`TAG_HEARTBEAT` up the tree; this monitor declares
    any watched vpid dead after ``rml_heartbeat_timeout`` seconds of
    silence and fires ``on_silent(vpid)`` exactly once per vpid.

    The expiry sweep is incremental: every beat pushes a ``(beat_ts,
    vpid)`` entry on a min-heap and the tick pops only entries older
    than the timeout, lazily discarding ones a fresher beat superseded
    — a tick on a 1000-daemon world costs O(expired), not O(world).
    Each beat's entry is examined exactly once (when it ages past the
    timeout), so the heap is bounded by the beats of one timeout window.
    Two more fleet-survival hooks: :meth:`set_world` scales the
    effective timeout with world size (see :func:`scaled_timeout`) and
    :meth:`grace` suspends declarations for a bounded stretch — the PLM
    arms it around a batched reparent wave so survivors busy re-wiring
    are not declared dead mid-adoption (deferred entries re-arm with a
    fresh window; a daemon that stays silent after the grace is still
    declared).
    """

    def __init__(self, on_silent: Callable[[int], None]) -> None:
        self.on_silent = on_silent
        self._last: dict[int, float] = {}
        self._declared: set[int] = set()
        self._heap: list[tuple[float, int]] = []  # (beat_ts, vpid), lazy
        self._grace_until = 0.0
        self._world = 0
        #: sweep telemetry: heap entries examined / sweeps run — what the
        #: per-tick-cost unit test asserts against
        self.scanned_total = 0
        self.ticks_total = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def watch(self, vpid: int) -> None:
        """Start expecting beats from ``vpid`` (clock starts now)."""
        self.beat(vpid)

    def beat(self, vpid: int) -> None:
        """A heartbeat (or any sign of life) arrived from ``vpid``."""
        now = time.monotonic()
        with self._lock:
            self._last[vpid] = now
            heapq.heappush(self._heap, (now, vpid))

    def set_world(self, world: int) -> None:
        """Declare the world size (daemons + HNP) so the effective
        timeout scales with routing-tree depth."""
        with self._lock:
            self._world = int(world)

    def grace(self, seconds: float) -> None:
        """Suspend dead-declarations until ``seconds`` from now (extends,
        never shortens, an active grace window)."""
        until = time.monotonic() + float(seconds)
        with self._lock:
            self._grace_until = max(self._grace_until, until)

    def ages(self) -> dict[int, float]:
        """Seconds since each watched vpid's last beat (the /status
        last-heartbeat-age column; empty when heartbeats are off)."""
        now = time.monotonic()
        with self._lock:
            return {vpid: max(0.0, now - last)
                    for vpid, last in self._last.items()}

    def effective_timeout(self) -> float:
        """The declare threshold actually in force: the configured (and
        2x-period-clamped) timeout, world-scaled."""
        period = float(var_registry.get("rml_heartbeat_period") or 0)
        timeout = float(var_registry.get("rml_heartbeat_timeout") or 0)
        timeout = max(timeout, 2 * period)
        with self._lock:
            world = self._world or (len(self._last) + 1)
        return scaled_timeout(timeout, world)

    def start(self) -> None:
        period = float(var_registry.get("rml_heartbeat_period") or 0)
        if period <= 0 or self._thread is not None:
            return
        timeout = float(var_registry.get("rml_heartbeat_timeout") or 0)
        if timeout < 2 * period:
            # a timeout shorter than two beat intervals declares every
            # HEALTHY daemon dead between beats — clamp rather than
            # letting a plausible-looking config abort the job
            _log.verbose(0, "heartbeat: timeout %.2fs < 2x period %.2fs; "
                         "clamping to %.2fs", timeout, period, 2 * period)
        self._thread = threading.Thread(target=self._run, name="rml-hb-mon",
                                        daemon=True)
        self._thread.start()

    def _sweep(self, now: float, timeout: float) -> list[int]:
        """One incremental expiry sweep: pop heap entries older than the
        timeout, declaring the vpids whose NEWEST beat that is.  Returns
        the newly silent vpids (callers fire ``on_silent`` outside the
        lock)."""
        cutoff = now - timeout
        silent: list[int] = []
        with self._lock:
            self.ticks_total += 1
            grace = self._grace_until
            while self._heap and self._heap[0][0] <= cutoff:
                ts, vpid = heapq.heappop(self._heap)
                self.scanned_total += 1
                last = self._last.get(vpid)
                if last is None or vpid in self._declared or last > ts:
                    continue  # unwatched / already declared / stale entry
                if now < grace:
                    # reparent-wave grace: re-arm with a fresh window
                    # instead of declaring — still-silent daemons expire
                    # one timeout after the deferral
                    self._last[vpid] = now
                    heapq.heappush(self._heap, (now, vpid))
                    continue
                self._declared.add(vpid)
                silent.append(vpid)
        return silent

    def _run(self) -> None:
        period = float(var_registry.get("rml_heartbeat_period") or 0)
        # check at the beat cadence; declare at the (world-scaled) timeout
        while not self._stop.wait(max(0.05, period / 2)):
            timeout = self.effective_timeout()
            for vpid in self._sweep(time.monotonic(), timeout):
                _log.error("heartbeat: vpid %d silent for >%.1fs; "
                           "declaring it dead", vpid, timeout)
                try:
                    self.on_silent(vpid)
                except Exception as e:  # noqa: BLE001 — watchdog survives
                    _log.error("heartbeat: on_silent(%d) failed: %r",
                               vpid, e)

    def stop(self) -> None:
        self._stop.set()


def start_heartbeats(node: RmlNode, stop: threading.Event) -> None:
    """Daemon side: beat TAG_HEARTBEAT up the tree every
    ``rml_heartbeat_period`` seconds until ``stop`` is set (no thread is
    spawned when the period is 0)."""
    period = float(var_registry.get("rml_heartbeat_period") or 0)
    if period <= 0:
        return

    def beater() -> None:
        while not stop.wait(period):
            try:
                node.send_up(TAG_HEARTBEAT, node.vpid)
            except ConnectionError:
                return  # tree torn down; the lifeline path handles it

    threading.Thread(target=beater, name=f"rml-hb-{node.vpid}",
                     daemon=True).start()
