"""ft — user-level fault tolerance (ULFM semantics; the port's copy of the
JAX package's ``mpi/ft.py``, whole, with the same frames, counters and
MCA variables).

≈ the MPI User-Level Failure Mitigation chapter (MPIX_Comm_revoke /
_shrink / _agree / _get_failed — the extension-style capability MPI
Advance ships ahead of standardization): rank death stops being a
job-level event the errmgr alone decides about and becomes something
*application code* can observe and recover from:

- :class:`FailureDetector` — the per-process view of which world ranks
  are dead.  Fed by the runtime control plane (the PMIx server's
  dead-set, which the launcher's reap loop and the RML heartbeat monitor
  maintain) via rate-limited polling plus a background watcher, by
  local marks (transport evidence, arena pid probes, fault injection,
  tests), and — with ``ft_gossip_period`` > 0 — by rank-plane gossip
  heartbeats: epoch beats with piggybacked peer views on the FT control
  plane, so a hung-but-alive rank (SIGSTOP, wedged host thread) the
  daemon heartbeat layer cannot see is declared suspect in the gossip
  window and pushed back to the runtime (``report_failed``) for pid
  reaping.
- ``Comm.revoke()`` — poison a communicator everywhere: in-flight and
  future operations on its cid fail with MPI_ERR_REVOKED.  Propagated by
  flooding: every process that learns of the revocation forwards it once
  to every other member, so a single dropped frame cannot hide it.
- ``Comm.agree(flag)`` — fault-tolerant agreement: survivors converge on
  the bitwise AND of their flags and on a common view of the failed set,
  with retransmission (deterministic fault injection drops frames; the
  protocol must not care).  Coordinator-based: the lowest live rank
  gathers and decides; contributors resend until a decision arrives and
  gossip to every live peer after repeated silence, so any rank holding
  the decision can answer.  A coordinator that dies *after* delivering
  the decision to only a subset is the classic early-deciding window —
  the next agree's coordinator re-derives membership from the detector,
  and the recipients of the partial decision all hold the SAME value
  (the decision is computed once), so divergence cannot occur; what can
  be lost is only progress, repaired by the retry loop (and bounded by
  the detector window once gossip heartbeats are armed).  Memory is
  bounded by **acked-decision watermarks**: every returned agree acks
  the decider (``agree_a``), the decider broadcasts the slowest live
  member's watermark as a GC floor (``agree_g``), and every per-(cid,
  seq) state at or below the floor is reclaimed
  (``ft_agree_gc_reclaimed_total``) — dead members are excluded from
  the minimum so their unacked seqs cannot pin memory forever.
- ``Comm.shrink()`` — agree on the failed set, then build a new
  communicator over the survivors with a deterministically derived cid
  (the same negative-namespace hash construction comm.create_group
  uses), so every survivor computes the same handle with no extra
  traffic.
- ``Comm.get_failed()`` / ``ack_failed()`` — the local failed-group
  query + acknowledgement.

Wire format: FT control frames are headers with ``t: "ft"`` riding the
PML's ordered frame path (``_enqueue_frame``), below MPI matching — they
are immune to the revoked-cid poison (recovery must run on a revoked
communicator) and carry an attempt counter ``n`` so the fault injector
gives every retransmission a fresh drop verdict.

Incarnation fence (errmgr respawn/selfheal rejoin): FT frames carry the
sender's own incarnation (``si``) and the incarnation they were stamped
FOR (``de`` — the destination epoch, distinct from the gossip epoch
``ep`` beats already use).  A frame from a peer's dead life (``si``
below its known incarnation) or stamped for THIS rank's dead life
(``de`` below our incarnation) is dropped and counted
(``ft_fenced_frames_total``): agree sequence numbers and gossip epochs
restart at 0 in a revived life, so without the fence a dead life's
in-flight decision could complete the new life's same-numbered
agreement with stale membership.  Senders that have not yet learned the
new incarnation heal through the PML rebind re-announce; FT protocols
retransmit, so a fenced frame costs a retry, never a hang.

Thread-context rules:
``on_ft_frame`` runs on BTL reader threads — it must never block, never
RPC, and send only via the PML worker queue (``_send_ft`` →
``_enqueue_frame``); anything that must reach the control
plane from frame dispatch is queued and drained by the gossip loop or a
detector poll hook instead (``_adopt_notify`` → ``_flush_adopt_notices``
is the pattern).  ``FailureDetector.is_dead(peer, poll=False)`` is the
reader-safe form — the polling default is a blocking RPC, which is why
its poll branch documents the contract.  ``self._lock`` and the
per-comm ``_CommFT.lock`` are reader-shared, so no sleep/RPC may be
reachable while either is held, and their nesting order must stay
acyclic against the PML's.
"""

from __future__ import annotations

import inspect
import itertools
import threading
import time
import weakref
import zlib
from typing import Optional, TYPE_CHECKING

from ompi_tpu_torch.core import output
from ompi_tpu_torch.core.config import VarType, register_var, var_registry
from ompi_tpu_torch.mpi import trace as trace_mod
from ompi_tpu_torch.mpi.constants import (
    ERR_PROC_FAILED, ERR_REVOKED, MPIException,
)

if TYPE_CHECKING:
    from ompi_tpu_torch.mpi.comm import Communicator
    from ompi_tpu_torch.mpi.pml import PmlOb1

__all__ = ["FailureDetector", "PmlFT", "pml_ft", "attach_runtime",
           "comm_revoke", "comm_is_revoked", "comm_agree", "comm_shrink",
           "comm_get_failed", "comm_ack_failed", "comm_coll_epoch",
           "member_incs"]

_log = output.get_stream("ft")

register_var("ft", "enable", VarType.BOOL, False,
             "arm the runtime-fed failure detector at init regardless of "
             "errmgr policy (it arms automatically under --mca errmgr "
             "notify; under respawn the dead-set is transient while a "
             "rank revives, so it stays off unless forced)")
register_var("ft", "poll_period", VarType.DOUBLE, 0.2,
             "minimum seconds between failure-detector polls of the "
             "runtime dead-set (the PMIx 'failed' query)")
register_var("ft", "agree_timeout", VarType.DOUBLE, 60.0,
             "seconds before Comm.agree()/shrink() gives up and raises "
             "MPI_ERR_PROC_FAILED (protocol livelock guard)")
register_var("ft", "agree_retry_interval", VarType.DOUBLE, 0.1,
             "seconds between agreement retransmissions")
register_var("ft", "gossip_period", VarType.DOUBLE, 0.0,
             "seconds between rank-plane gossip liveness beats (0 = "
             "disabled).  Beats ride the FT control plane and carry the "
             "sender's view of every peer's epoch, so an in-host hang — "
             "alive pid, silent rank, invisible to the daemon-level "
             "heartbeats — is declared suspect by its peers and fed into "
             "the same failure-detector dead-set the PMIx path feeds")
register_var("ft", "gossip_timeout", VarType.DOUBLE, 2.0,
             "seconds a peer's gossip epoch may stand still before the "
             "peer is declared suspect (clamped to >= 2x "
             "ft_gossip_period — a shorter window would declare every "
             "healthy rank dead between beats)")


def gossip_window() -> float:
    """The effective suspect window: ``ft_gossip_timeout`` clamped to at
    least two beat intervals (the same hygiene rule the daemon heartbeat
    monitor applies to its own pair of vars)."""
    period = float(var_registry.get("ft_gossip_period") or 0)
    timeout = float(var_registry.get("ft_gossip_timeout") or 0)
    if period > 0 and timeout < 2 * period:
        _log.verbose(0, "gossip: timeout %.2fs < 2x period %.2fs; "
                     "clamping to %.2fs", timeout, period, 2 * period)
        return 2 * period
    return timeout


class FailureDetector:
    """Per-process failure knowledge: world rank → dead?

    Two sources merge here: the runtime control plane (polled, and
    watched by a background thread so blocked receivers learn of deaths
    without calling anything) and local marks.  Listeners fire once per
    newly-dead rank — the PML uses that to fail posted recvs and parked
    sends against the corpse.
    """

    def __init__(self) -> None:
        self._dead: set[int] = set()
        self._runtime_marked: set[int] = set()  # deaths the control
        # plane reported — reconciled on every poll so an errmgr-respawn
        # revival (proc_revived clears the server dead-set) un-declares
        self._stale_reports: set[int] = set()  # pushes the server
        # stale-gated (a revive was in flight) — retried by the gossip
        # loop until accepted (wedge escape) or the rank revives
        self._reasons: dict[int, str] = {}
        self._revived_at: dict[int, float] = {}  # rank → last direct-
        # evidence revive: poll_runtime skips re-marking a rank whose
        # revive landed after the poll's snapshot was taken (the RPC
        # reply would otherwise resurrect the death it just cleared)
        self._lock = threading.Lock()
        self._listeners: list = []
        self._revive_listeners: list = []
        self._poll_hooks: list = []
        self._client = None
        self._report_legacy: Optional[bool] = None  # report_failed
        # lacks the incarnation parameter (older stubs) — probed once
        # per client from its signature, NOT by catching TypeError per
        # call (a TypeError raised INSIDE a modern client would then be
        # misread as a legacy surface and the report double-sent)
        self._last_poll = 0.0
        self._watch_stop: Optional[threading.Event] = None

    # -- feeding -----------------------------------------------------------

    def attach_client(self, client) -> None:
        """Connect the runtime control plane (a PMIxClient) and start the
        background watcher that keeps polling while the app is blocked."""
        self._client = client
        self._report_legacy = None   # re-probe the new client's surface
        if self._watch_stop is None:
            self._watch_stop = threading.Event()
            t = threading.Thread(target=self._watch, name="ft-detector",
                                 daemon=True)
            t.start()

    def close(self) -> None:
        if self._watch_stop is not None:
            self._watch_stop.set()

    def mark_failed(self, world_rank: int, reason: str = "") -> bool:
        """Record a death (local evidence / injection).  True when new."""
        with self._lock:
            if world_rank in self._dead:
                return False
            self._dead.add(world_rank)
            if reason:
                self._reasons[world_rank] = reason
            listeners = list(self._listeners)
        _log.verbose(1, "detector: rank %d declared dead%s", world_rank,
                     f" ({reason})" if reason else "")
        trace_mod.count("ft_rank_deaths_total")
        for cb in listeners:
            try:
                cb(world_rank)
            except Exception as e:  # noqa: BLE001 — detector must survive
                _log.error("detector listener failed for %d: %r",
                           world_rank, e)
        return True

    def add_listener(self, cb) -> None:
        """cb(world_rank) fires once per newly-discovered death."""
        with self._lock:
            self._listeners.append(cb)

    def add_revive_listener(self, cb) -> None:
        """cb(world_rank) fires when a runtime poll un-declares a death
        (errmgr/respawn brought the rank back)."""
        with self._lock:
            self._revive_listeners.append(cb)

    def add_poll_hook(self, cb) -> None:
        """cb() runs before each actual runtime poll, on the polling
        thread (the background watcher or an app thread — never a
        transport reader): deferred control-plane pushes that reader
        threads queued (e.g. adoption notices) ride it even when the
        gossip loop is disabled."""
        with self._lock:
            self._poll_hooks.append(cb)

    def revive(self, world_rank: int) -> bool:
        """Un-declare a death on direct evidence (a frame from the
        peer's NEW incarnation, or the runtime poll diff).  True when
        the rank was locally dead.  Needed beyond the poll diff: under
        errmgr selfheal the server-side dead window (reap → revive) can
        be shorter than a poll period, so a rank whose own report was
        stale-gated would otherwise hold its local death forever."""
        with self._lock:
            was = world_rank in self._dead
            self._dead.discard(world_rank)
            self._reasons.pop(world_rank, None)
            self._runtime_marked.discard(world_rank)
            self._stale_reports.discard(world_rank)
            self._revived_at[world_rank] = time.monotonic()
            cbs = list(self._revive_listeners) if was else []
        if was:
            _log.verbose(1, "detector: rank %d revived (new incarnation "
                         "evidence)", world_rank)
        for cb in cbs:
            try:
                cb(world_rank)
            except Exception as e:  # noqa: BLE001 — detector survives
                _log.error("revive listener failed for %d: %r",
                           world_rank, e)
        return was

    # -- querying ----------------------------------------------------------

    def is_dead(self, world_rank: int, poll: bool = True) -> bool:
        if world_rank in self._dead:
            return True
        if poll:
            # reader-thread/under-lock callers MUST pass poll=False —
            # this branch is a blocking control-plane RPC (the linter's
            # reachability is context-insensitive, hence the waiver;
            # the contract it can't see is this comment)
            self.poll_runtime()   # lint: reader-ok lock-ok
            return world_rank in self._dead
        return False

    def dead_ranks(self) -> set[int]:
        self.poll_runtime()
        with self._lock:
            return set(self._dead)

    def reason(self, world_rank: int) -> str:
        return self._reasons.get(world_rank, "")

    def report_to_runtime(self, world_rank: int, reason: str = "",
                          incarnation: int = 0) -> bool:
        """Push a locally-observed death (gossip suspect, arena writer
        probe) to the runtime control plane so the launcher can reap the
        hung pid — under errmgr selfheal that reap IS the start of the
        revive cycle — and every other rank's poll learns it.
        ``incarnation`` is the victim's life number as this process
        knows it (the adopted ``si``): the server drops reports about
        lives it already reaped, so racing reporters cannot SIGKILL a
        freshly-revived rank.  A stale-gated push is remembered (see
        :meth:`stale_reported`) so the gossip loop can retry it — the
        gated life may itself wedge, and nobody else will ever
        re-report it.  False when no client is attached or the push
        failed."""
        client = self._client
        if client is None:
            return False
        if self._report_legacy is None:
            # older client surface (tests, external stubs) without the
            # incarnation parameter — detected ONCE from the signature
            try:
                inspect.signature(client.report_failed).bind(
                    world_rank, reason, incarnation)
                self._report_legacy = False
            except TypeError:
                self._report_legacy = True
            except ValueError:   # no introspectable signature (C-level)
                self._report_legacy = False
        try:
            verdict = (client.report_failed(world_rank, reason)
                       if self._report_legacy else
                       client.report_failed(world_rank, reason, incarnation))
        except Exception as e:  # noqa: BLE001 — control plane optional
            _log.verbose(1, "report_failed(%d) failed: %r", world_rank, e)
            return False
        with self._lock:
            if verdict == "stale":
                self._stale_reports.add(world_rank)
            else:
                self._stale_reports.discard(world_rank)
        return True

    def stale_reported(self) -> set[int]:
        """Locally-dead ranks whose latest control-plane push was
        stale-gated: a revive of the victim was in flight when this
        process reported it.  If that new life wedges before any
        survivor adopts its incarnation, the one-shot gossip declare
        has already fired — these are re-pushed (by the gossip loop)
        until the server's wedge escape accepts one or the new life's
        evidence revives the rank locally."""
        with self._lock:
            return {r for r in self._stale_reports if r in self._dead}

    def poll_runtime(self, force: bool = False) -> None:
        """Rate-limited pull of the runtime dead-set."""
        client = self._client
        if client is None:
            return
        now = time.monotonic()
        period = var_registry.get("ft_poll_period")
        with self._lock:
            if not force and now - self._last_poll < period:
                return
            self._last_poll = now
            hooks = list(self._poll_hooks)
        for cb in hooks:
            try:
                cb()
            except Exception as e:  # noqa: BLE001 — detector survives
                _log.error("poll hook failed: %r", e)
        snap_t = now  # the RPC reply reflects server state no older
        # than this instant — a direct-evidence revive() stamped at or
        # after it may postdate the server's snapshot, so its rank must
        # not be re-marked from this (possibly stale) reply: re-marking
        # would fail pending ops toward the healthy new life for a poll
        # period and, if it lands mid msglog auto-replay, lose the
        # one-shot replay of the in-flight gap for good
        try:
            failed = client.failed_ranks()   # rank → reason
        except Exception:  # noqa: BLE001 — control plane may be tearing down
            return
        with self._lock:
            fresh = {r: reason for r, reason in failed.items()
                     if self._revived_at.get(r, 0.0) < snap_t}
            revived = self._runtime_marked - set(failed)
            self._runtime_marked = set(fresh)
            self._dead -= revived   # errmgr/respawn brought them back
            for r in revived:
                self._reasons.pop(r, None)
            revive_cbs = list(self._revive_listeners) if revived else []
        for r in revived:
            for cb in revive_cbs:
                try:
                    cb(r)
                except Exception as e:  # noqa: BLE001 — detector survives
                    _log.error("revive listener failed for %d: %r", r, e)
        for r, reason in fresh.items():
            self.mark_failed(r, reason=reason or "runtime-declared")

    def _watch(self) -> None:
        period = var_registry.get("ft_poll_period")
        while not self._watch_stop.wait(max(0.05, period)):
            self.poll_runtime(force=True)


class _AgreeState:
    """One agreement instance (comm cid × sequence number)."""

    __slots__ = ("cv", "contribs", "decision", "decider")

    def __init__(self) -> None:
        self.cv = threading.Condition()
        self.contribs: dict[int, tuple[int, frozenset]] = {}  # world → ...
        self.decision: Optional[tuple[int, tuple]] = None
        self.decider: Optional[int] = None   # who computed it (ack target)


class _CommFT:
    """Per-communicator FT bookkeeping (agree sequencing, acked deaths,
    and the acked-decision watermarks that bound agreement memory)."""

    def __init__(self, comm: "Communicator") -> None:
        self.comm_ref = weakref.ref(comm)
        self.group_ranks = tuple(comm.group.ranks)  # world ranks, frozen
        self.agree_seq = itertools.count()
        self.shrink_seq = itertools.count()
        self.acked: set[int] = set()
        self.states: dict[int, _AgreeState] = {}
        self.lock = threading.Lock()
        # acked-decision watermarks: my_w = highest agree seq THIS rank
        # has returned from; peer_w[r] = highest seq rank r confirmed
        # (via agree_a acks and contrib piggybacks).  A state may be
        # garbage-collected only once every LIVE member's watermark has
        # passed it — until then some straggler may still retransmit its
        # contribution and a decision-holder must be able to answer.
        self.my_w = -1
        self.peer_w: dict[int, int] = {}
        self.gc_floor = -1   # states with seq <= gc_floor are reclaimed

    def state(self, seq: int) -> _AgreeState:
        with self.lock:
            st = self.states.get(seq)
            if st is None:
                st = self.states[seq] = _AgreeState()
            return st


class PmlFT:
    """The PML's fault-tolerance sidecar: revoked cids, posted-recv
    shadow tracking, FT frame dispatch, and the failure detector.

    Installed lazily (``pml_ft(pml)``): a process that never touches FT
    pays a single ``pml.ft is None`` check per operation.  Once
    installed, deaths poison matching posted recvs + parked sends, and
    revocations poison a cid's present and future operations.
    """

    def __init__(self, pml: "PmlOb1") -> None:
        self.pml = pml
        self.detector = FailureDetector()
        self.revoked: set[int] = set()
        self._comms: dict[int, _CommFT] = {}
        self._pending: dict[int, "weakref.WeakSet"] = {}  # cid → recvs
        self._lock = threading.Lock()
        self.detector.add_listener(self._on_rank_dead)
        # rank-plane gossip: world rank → [epoch, last-advance monotonic]
        self._beats: dict[int, list] = {}
        self._beat_epoch = 0
        self._gossip_stop: Optional[threading.Event] = None
        # highest peer incarnation whose gossip entry was reset — the
        # once-per-life gate of peer_reincarnated (beats from the new
        # life arrive repeatedly and must not re-reset its clock)
        self._gossip_inc: dict[int, int] = {}
        # adopted lives not yet pushed to the control plane ("adopted"
        # RPC, closes the server's boot-wedge escape): queued on the
        # adopt transition (reader threads must not block on an RPC)
        # and drained by the gossip loop / the detector poll thread
        self._adopt_notify: dict[int, int] = {}
        self.detector.add_poll_hook(self._flush_adopt_notices)
        # native tcp plane FT contract: parked ring senders re-run the
        # same revoked-cid / detector-dead gate between bounded slices
        tcp = getattr(pml.endpoint, "tcp_btl", None)
        if tcp is not None:
            tcp.ft_check = self.check_send

    def close(self) -> None:
        self.detector.close()
        if self._gossip_stop is not None:
            self._gossip_stop.set()

    # -- registration ------------------------------------------------------

    def comm_ft(self, comm: "Communicator") -> _CommFT:
        with self._lock:
            cft = self._comms.get(comm.cid)
            if cft is None or cft.comm_ref() is not comm:
                cft = self._comms[comm.cid] = _CommFT(comm)
            return cft

    def track_recv(self, req) -> None:
        """Shadow-register a posted recv so a revoke / peer death can
        fail it (the compiled matching engine owns the real queues and
        has no enumeration API)."""
        with self._lock:
            ws = self._pending.get(req.cid)
            if ws is None:
                ws = self._pending[req.cid] = weakref.WeakSet()
            ws.add(req)

    # -- operation gates (called from pml hot paths) -----------------------

    def check_send(self, peer: int, cid: int) -> None:
        """Raise before a send that can never complete: revoked cid, or
        a peer the detector already declared dead (fail fast — do not
        park for the retry window)."""
        if cid in self.revoked:
            raise MPIException(
                f"communicator cid {cid} has been revoked",
                error_class=ERR_REVOKED)
        if self.detector.is_dead(peer, poll=False):
            raise MPIException(
                f"rank {peer} has failed "
                f"({self.detector.reason(peer) or 'detector-declared'})",
                error_class=ERR_PROC_FAILED)

    def check_cid(self, cid: int) -> None:
        if cid in self.revoked:
            raise MPIException(
                f"communicator cid {cid} has been revoked",
                error_class=ERR_REVOKED)

    # -- death / revocation poisoning --------------------------------------

    def _on_rank_dead(self, world_rank: int) -> None:
        """Detector listener: fail every posted recv naming the corpse
        and every frame parked for it — the blocked caller gets
        MPI_ERR_PROC_FAILED instead of a 30 s park-and-heal stall."""
        exc = MPIException(
            f"rank {world_rank} has failed "
            f"({self.detector.reason(world_rank) or 'detector-declared'})",
            error_class=ERR_PROC_FAILED)
        with self._lock:
            victims = [req for ws in self._pending.values() for req in ws
                       if req.source == world_rank and not req.done()]
        for req in victims:
            self._fail_recv(req, exc)
        self._fail_parked(world_rank, exc)

    def _fail_recv(self, req, exc: MPIException) -> None:
        """Dequeue a posted recv (so a late frame cannot double-complete
        it) and fail it."""
        pml = self.pml
        with pml._lock:
            if pml._eng is not None:
                pml._eng.cancel(req.cid, req)
            else:
                m = pml._matching.get(req.cid)
                if m is not None:
                    try:
                        m.posted.remove(req)
                    except ValueError:
                        pass
        if not req.done():
            req.fail(exc)

    def _fail_parked(self, peer: int, exc: MPIException,
                     cid: Optional[int] = None) -> None:
        """Fail parked frames toward ``peer`` (all of them, or only the
        user-data frames of one revoked cid — FT control and foreign-cid
        frames stay parked)."""
        pml = self.pml
        with pml._lock:
            parked = pml._parked.get(peer)
            if not parked:
                return
            if cid is None:
                dead, parked[:] = list(parked), []
                pml._parked.pop(peer, None)
            else:
                dead = [e for e in parked
                        if e[0].get("t") in ("eager", "rndv")
                        and e[0].get("cid") == cid]
                parked[:] = [e for e in parked if e not in dead]
        for _h, _p, req in dead:
            pml._fail_req(req, exc)

    def mark_revoked(self, cid: int) -> bool:
        """Poison a cid locally; True when newly revoked here."""
        with self._lock:
            if cid in self.revoked:
                return False
            self.revoked.add(cid)
            victims = [req for req in self._pending.get(cid, ())
                       if not req.done()]
        exc = MPIException(
            f"communicator cid {cid} has been revoked",
            error_class=ERR_REVOKED)
        for req in victims:
            self._fail_recv(req, exc)
        # parked user-data frames on the revoked cid will never be
        # wanted — fail their senders now, toward every parked peer
        with self.pml._lock:
            peers = list(self.pml._parked)
        for peer in peers:
            self._fail_parked(peer, exc, cid=cid)
        trace_mod.count("ft_revokes_total")
        return True

    # -- FT frame plane ----------------------------------------------------

    def _send_ft(self, peer: int, hdr: dict) -> None:
        """One FT control frame via the PML's ordered worker path (non-
        blocking; reader-thread safe).  Dead peers are skipped — FT
        frames must not pile up in the park-and-heal queue.  Frames are
        stamped with the sender's incarnation (``si``) and the peer's
        known incarnation (``de``) so a revived receiver can fence
        traffic stamped for its dead life."""
        if peer == self.pml.rank:
            return
        if self.detector.is_dead(peer, poll=False):
            return
        if self.pml.incarnation:
            hdr.setdefault("si", self.pml.incarnation)
        de = self.pml._peer_epoch.get(peer, 0)
        if de:
            hdr.setdefault("de", de)
        self.pml._enqueue_frame(peer, hdr, b"", None)

    def on_ft_frame(self, peer: int, hdr: dict) -> None:
        """Dispatch one incoming FT frame (BTL reader thread: never
        block, sends only via the worker queue)."""
        # incarnation fence (errmgr respawn/selfheal): a frame stamped
        # for a previous life of THIS rank, or sent by a previous life
        # of the PEER, is stale — its seq spaces (agree seqs, gossip
        # epochs) restarted with the new life, so acting on it could
        # complete a new-life agreement with dead-life state.  Dropped
        # like the PML drops pre-restart data frames; the protocols'
        # retransmission (and the rebind re-announce) heal the gap.
        # liveness beats are exempt from the destination-epoch fence: a
        # beat proves the SENDER is alive regardless of which of my
        # lives it was stamped for, and fencing it would starve a
        # revived rank's gossip clocks exactly in its rejoin window —
        # it would then declare every not-yet-adopted survivor stalled
        # (a kill storm).  The si fence below still applies: a beat
        # from the peer's own dead life cannot refresh its clock.
        if (hdr.get("op") != "beat"
                and int(hdr.get("de", 0)) < self.pml.incarnation):
            trace_mod.count("ft_fenced_frames_total")
            _log.verbose(1, "rank %d: fenced ft %r from %d (de %d < "
                         "inc %d)", self.pml.rank, hdr.get("op"), peer,
                         int(hdr.get("de", 0)), self.pml.incarnation)
            # same heal as the PML data fence: the sender is stamping
            # for our dead life, so its rebind adopt never landed —
            # re-announce (rate-limited) instead of fencing it forever
            self.pml._heal_reannounce(peer)
            return
        # shared fence/adopt choke point (pml.note_peer_si): the FT
        # plane may learn a revival before any data frame does — the
        # adopt resets the wire-seq space and restamps parked frames
        # under the same lock, exactly like the data path
        si = int(hdr.get("si", 0))
        fenced, adopted = self.pml.note_peer_si(peer, si)
        if fenced:
            trace_mod.count("ft_fenced_frames_total")
            _log.verbose(1, "rank %d: fenced ft %r from dead life of %d "
                         "(si %d)", self.pml.rank, hdr.get("op"), peer, si)
            return
        if adopted:
            # a frame stamped by a NEW life of the peer is direct
            # revival evidence — un-declare a locally-held death.  Only
            # on the adopt transition: a revived peer stamps si forever,
            # and steady-state frames must not pay the extra locks
            self.peer_reincarnated(peer, si)
        self._note_alive(peer)   # any FT frame is liveness evidence
        op = hdr.get("op")
        if op == "revoke":
            self._recv_revoke(hdr)
        elif op == "agree_c":
            self._recv_agree_contrib(peer, hdr)
        elif op == "agree_d":
            self._recv_agree_decision(hdr)
        elif op == "agree_a":
            self._recv_agree_ack(peer, hdr)
        elif op == "agree_g":
            self._recv_agree_gc(hdr)
        elif op == "beat":
            self._recv_beat(peer, hdr)
        else:
            _log.error("unknown ft op %r from %d", op, peer)

    def peer_reincarnated(self, peer: int, inc: int) -> None:
        """Direct transport evidence that ``peer`` is back as life
        ``inc`` (its rebind announce, or any si-stamped frame from the
        new incarnation): un-declare it NOW instead of waiting to
        observe the runtime dead-set transition — under errmgr selfheal
        the reap→revive window can be shorter than a detector poll
        period, so the poll diff alone can miss the revival entirely
        and the local death would stick forever (starving the revived
        rank of gossip beats, which then declares the SURVIVORS)."""
        if not inc:
            return
        # reset the gossip clock/epoch for the new life REGARDLESS of
        # whether this process ever declared the death: a reap→revive
        # faster than both the poll period and the gossip window leaves
        # a survivor that never marked the death holding the DEAD
        # life's high epoch — the new life's restarted epochs would
        # never pass it transitively, and (if this rank is not one of
        # the revived rank's direct beat targets) the stalled entry
        # would re-declare the healthy new life one window later with
        # the ADOPTED incarnation, sailing through the server's stale
        # gate and SIGKILLing it.  Once per adopted life, not per
        # frame: beats from the new life must still be able to advance
        # its fresh epoch/clock normally.
        with self._lock:
            fresh_life = inc > self._gossip_inc.get(peer, 0)
            if fresh_life:
                self._gossip_inc[peer] = inc
                # close the server's boot-wedge escape for the adopted
                # life — queued, not pushed: this runs on transport
                # reader threads, which must never block on an RPC
                self._adopt_notify[peer] = inc
        if fresh_life:
            self._gossip_reset(peer)
        if self.detector.is_dead(peer, poll=False):
            self.detector.revive(peer)

    def _flush_adopt_notices(self) -> None:
        """Drain queued adoption notices to the control plane (gossip
        loop / detector poll thread — safe to RPC here).  A push that
        fails is re-queued: the notice must eventually land or a stale
        report after ``pmix_register_grace_s`` could reap the healthy
        adopted life."""
        client = self.detector._client
        notify = getattr(client, "peer_adopted", None)
        if notify is None:
            return
        with self._lock:
            pending = dict(self._adopt_notify)
            self._adopt_notify.clear()
        for peer, inc in pending.items():
            try:
                notify(peer, inc)
            except Exception as e:  # noqa: BLE001 — control plane optional
                _log.verbose(1, "peer_adopted(%d, %d) failed: %r",
                             peer, inc, e)
                with self._lock:
                    if inc > self._adopt_notify.get(peer, 0):
                        self._adopt_notify[peer] = inc

    # -- rank-plane gossip heartbeats --------------------------------------

    def arm_gossip(self, world) -> None:
        """Start the low-rate background beat + suspect checker over the
        given world ranks (no-op when ``ft_gossip_period`` is 0 or the
        thread already runs).  Every rank's epoch clock starts NOW, so a
        rank that hangs before ever beating is still caught."""
        period = float(var_registry.get("ft_gossip_period") or 0)
        if period <= 0 or self._gossip_stop is not None:
            return
        now = time.monotonic()
        me = self.pml.rank
        with self._lock:
            for r in world:
                self._beats.setdefault(int(r), [0, now])
        self._gossip_stop = threading.Event()
        self.detector.add_revive_listener(self._gossip_reset)
        t = threading.Thread(target=self._gossip_loop,
                             name=f"ft-gossip-{me}", daemon=True)
        t.start()

    def _note_alive(self, peer: int, epoch: Optional[int] = None) -> None:
        """Direct evidence of life from ``peer`` — refreshes its clock
        regardless of epoch arithmetic (a respawned incarnation restarts
        at epoch 0 and must not look stalled)."""
        with self._lock:
            ent = self._beats.get(peer)
            if ent is None:
                self._beats[peer] = [int(epoch or 0), time.monotonic()]
                return
            if epoch is not None and epoch > ent[0]:
                ent[0] = int(epoch)
            ent[1] = time.monotonic()

    def _gossip_reset(self, world_rank: int) -> None:
        """A respawned rank restarts its epochs at 0: reset its entry so
        the old (higher) epoch does not mask the new life as a stall.
        The clock is stamped one window INTO THE FUTURE: revival is
        observed at reap/announce time, but the new life's first beat
        only comes after its interpreter boots (seconds on a loaded
        box) — without the boot grace a tight gossip window would
        re-declare the booting life and the reap→revive cycle would
        chase its own tail."""
        with self._lock:
            if world_rank in self._beats:
                self._beats[world_rank] = [
                    0, time.monotonic() + gossip_window()]

    def _recv_beat(self, peer: int, hdr: dict) -> None:
        """Merge one gossip beat: the sender's own epoch plus its view of
        everyone else's — epochs spread transitively, so a rank two hops
        away still sees progress it never heard directly.  View entries
        are ``[epoch, incarnation]`` (legacy plain ints read as life 0):
        epochs only compare within the SAME life — a not-yet-adopted
        survivor's in-flight view carrying a dead life's high epoch must
        not re-poison an entry just reset for the new life (pinning it
        above the restarted epochs and re-declaring the healthy rank),
        and a view naming a NEWER life than we know is itself revival
        evidence, spread transitively like the epochs."""
        self._note_alive(peer, int(hdr.get("ep", 0)))
        me = self.pml.rank
        reincarnated = []
        with self._lock:
            now = time.monotonic()
            for r, ev in (hdr.get("v") or {}).items():
                r = int(r)
                e, vinc = ((int(ev[0]), int(ev[1]))
                           if isinstance(ev, (list, tuple)) else (int(ev), 0))
                if r in (me, peer):
                    continue
                known = self._gossip_inc.get(r, 0)
                if vinc < known:
                    continue   # a dead life's epoch: not progress
                if vinc > known:
                    reincarnated.append((r, vinc))
                    continue   # reset first; later views merge normally
                ent = self._beats.get(r)
                if ent is None:
                    self._beats[r] = [e, now]
                elif e > ent[0]:
                    ent[0] = e
                    # the epoch ADVANCED: that is progress — but never
                    # pull the clock BACK over a revive boot grace
                    ent[1] = max(ent[1], now)
        for r, vinc in reincarnated:
            self.peer_reincarnated(r, vinc)

    def _gossip_targets(self, world: list[int]) -> list[int]:
        """Recursive-doubling fan-out: peers at distance 2^i in rank
        order — log2(n) frames per beat, epidemic convergence in log2(n)
        rounds (the standard gossip dissemination bound)."""
        me = self.pml.rank
        if me not in world:
            return []
        idx, n = world.index(me), len(world)
        out, d = [], 1
        while d < n:
            peer = world[(idx + d) % n]
            if peer != me and peer not in out:
                out.append(peer)
            d <<= 1
        return out

    def _gossip_loop(self) -> None:
        period = float(var_registry.get("ft_gossip_period") or 0)
        window = gossip_window()
        me = self.pml.rank
        stop = self._gossip_stop
        while not stop.wait(period):
            self._beat_epoch += 1
            with self._lock:
                world = sorted(self._beats)
                # view entries carry [epoch, incarnation]: epochs only
                # compare within one life of a rank (see _recv_beat)
                view = {r: [ent[0], self._gossip_inc.get(r, 0)]
                        for r, ent in self._beats.items()}
            view[me] = [self._beat_epoch, self.pml.incarnation]
            live = [r for r in world
                    if not self.detector.is_dead(r, poll=False)]
            for peer in self._gossip_targets(live):
                self._send_ft(peer, {"t": "ft", "op": "beat",
                                     "ep": self._beat_epoch,
                                     "v": view, "n": 0})
                trace_mod.count("ft_gossip_beats_total")
            now = time.monotonic()
            with self._lock:
                stalled = [(r, now - ent[1]) for r, ent in
                           self._beats.items()
                           if r != me and now - ent[1] > window]
            for r, silent_for in stalled:
                if self.detector.is_dead(r, poll=False):
                    continue
                self._gossip_declare(r, silent_for)
            # pushes the server stale-gated (our declare raced a revive
            # of the victim) are retried once per beat: if the revived
            # life wedges before anyone adopts its incarnation, the
            # one-shot declare above never fires again, and without the
            # retry the wedge escape server-side would have no report
            # left to accept — the hung pid would be unreapable
            for r in self.detector.stale_reported():
                if r == me:
                    continue
                self.detector.report_to_runtime(
                    r, self.detector.reason(r) or
                    "gossip: stale-gated report retry",
                    self.adopted_inc(r))
            # adoption notices queued by reader threads (close the
            # server's wedge escape within a beat, not a poll period)
            self._flush_adopt_notices()

    def adopted_inc(self, world_rank: int) -> int:
        """The highest incarnation of ``world_rank`` this process has
        adopted, across BOTH adoption paths: direct transport evidence
        (``pml._peer_inc``, set by rebind / si-stamped frames) and
        gossip-transitive adoption (``_gossip_inc``, set by
        ``peer_reincarnated`` off a third-party beat view).  Failure
        reports must be stamped with THIS, not ``_peer_inc`` alone: a
        transitive adopter never hears the new life directly, so its
        ``_peer_inc`` stays 0 — every report it pushed about a
        later-wedged life would be stale-gated while its own
        ``adopted`` push had closed the server's wedge escape, leaving
        the hung pid unreapable forever."""
        return max(self._gossip_inc.get(world_rank, 0),
                   self.pml._peer_inc.get(world_rank, 0))

    def _gossip_declare(self, world_rank: int, silent_for: float) -> None:
        """A peer's epoch stood still past the window: suspect → the same
        dead-set the PMIx path feeds (posted recvs fail, arena waits
        raise), and pushed to the runtime so the control plane can reap
        the hung pid and every other rank's poll learns it."""
        reason = (f"gossip: rank silent for {silent_for:.1f}s "
                  f"(epoch stalled)")
        if not self.detector.mark_failed(world_rank, reason):
            return
        # the reap this triggers is, under errmgr selfheal, the first
        # step of the revive cycle (reap → respawn → rejoin); the
        # incarnation stamp keeps a racing second reporter from killing
        # the life the first report's revive just started
        self.detector.report_to_runtime(
            world_rank, reason, self.adopted_inc(world_rank))

    def _recv_revoke(self, hdr: dict) -> None:
        cid = hdr["cid"]
        if not self.mark_revoked(cid):
            return  # already knew — the flood stops here
        _log.verbose(1, "rank %d: cid %d revoked remotely; flooding",
                     self.pml.rank, cid)
        for peer in hdr.get("grp", ()):
            if peer != self.pml.rank:
                self._send_ft(peer, {"t": "ft", "op": "revoke", "cid": cid,
                                     "grp": list(hdr.get("grp", ())),
                                     "n": int(hdr.get("n", 0)) + 1})

    # -- agreement ---------------------------------------------------------

    def _comm_ft_by_cid(self, cid: int) -> Optional[_CommFT]:
        with self._lock:
            return self._comms.get(cid)

    def _recv_agree_contrib(self, peer: int, hdr: dict) -> None:
        cft = self._comm_ft_by_cid(hdr["cid"])
        if cft is None:
            # agreement on a comm this process never FT-touched: that is
            # fine — contributions retransmit until our agree() call
            # creates the state.  Drop; the resend finds us ready.
            return
        seq = hdr["aseq"]
        self._note_watermark(cft, int(hdr["from"]), hdr.get("w"))
        if seq <= cft.gc_floor:
            return  # fully-acked round: a stale retransmit, nothing to say
        st = cft.state(seq)
        with st.cv:
            st.contribs[int(hdr["from"])] = (
                int(hdr["flag"]), frozenset(int(r) for r in hdr["failed"]))
            decision = st.decision
            st.cv.notify_all()
        if decision is not None:
            # anyone holding the decision answers — late/confused
            # contributors converge on the already-computed value
            flag, failed = decision
            self._send_ft(peer, {"t": "ft", "op": "agree_d",
                                 "cid": hdr["cid"], "aseq": seq,
                                 "flag": flag, "failed": list(failed),
                                 "from": self.pml.rank,
                                 "n": int(hdr.get("n", 0))})

    def _recv_agree_decision(self, hdr: dict) -> None:
        cft = self._comm_ft_by_cid(hdr["cid"])
        if cft is None or hdr["aseq"] <= cft.gc_floor:
            return
        st = cft.state(hdr["aseq"])
        with st.cv:
            if st.decision is None:
                st.decision = (int(hdr["flag"]),
                               tuple(sorted(int(r)
                                            for r in hdr["failed"])))
            if st.decider is None and "from" in hdr:
                st.decider = int(hdr["from"])
            st.cv.notify_all()

    # -- acked-decision watermarks + state GC ------------------------------

    def _note_watermark(self, cft: _CommFT, peer: int, w) -> None:
        if w is None:
            return
        with cft.lock:
            if int(w) > cft.peer_w.get(peer, -1):
                cft.peer_w[peer] = int(w)

    def _recv_agree_ack(self, peer: int, hdr: dict) -> None:
        """A member confirms it returned from agree seq <= w: record the
        watermark; when every live member's watermark passed a seq, that
        state can never be asked about again — reclaim and tell everyone."""
        cft = self._comm_ft_by_cid(hdr["cid"])
        if cft is None:
            return
        self._note_watermark(cft, int(hdr["from"]), hdr.get("w"))
        self._maybe_gc(cft, hdr["cid"])

    def _recv_agree_gc(self, hdr: dict) -> None:
        cft = self._comm_ft_by_cid(hdr["cid"])
        if cft is not None:
            self._apply_gc_floor(cft, int(hdr["f"]))

    def _apply_gc_floor(self, cft: _CommFT, floor: int) -> int:
        """Reclaim every state at or below ``floor`` (monotonic)."""
        with cft.lock:
            if floor <= cft.gc_floor:
                return 0
            victims = [s for s in cft.states if s <= floor]
            for s in victims:
                del cft.states[s]
            cft.gc_floor = floor
        if victims:
            trace_mod.count("ft_agree_gc_reclaimed_total", len(victims))
        return len(victims)

    def _maybe_gc(self, cft: _CommFT, cid: int) -> None:
        """Advance the GC floor to the slowest LIVE member's watermark
        and broadcast it — dead members are excluded (their unacked seqs
        would otherwise pin memory forever, the exact leak this bounds)."""
        me = self.pml.rank
        with cft.lock:
            floor = cft.my_w
            for r in cft.group_ranks:
                if r == me or self.detector.is_dead(r, poll=False):
                    continue
                floor = min(floor, cft.peer_w.get(r, -1))
            cur = cft.gc_floor
            live = [r for r in cft.group_ranks if r != me
                    and not self.detector.is_dead(r, poll=False)]
        if floor <= cur:
            return
        self._apply_gc_floor(cft, floor)
        for peer in live:
            # "aseq" carries the floor so every broadcast draws its own
            # fault-injection verdict (GC floors are monotonic; a lost
            # one is subsumed by the next)
            self._send_ft(peer, {"t": "ft", "op": "agree_g", "cid": cid,
                                 "aseq": floor, "f": floor, "n": 0})

    def agree(self, comm: "Communicator", flag: bool) -> tuple[bool, tuple]:
        """Blocking fault-tolerant agreement over ``comm``'s survivors →
        (AND of flags, agreed failed world-rank tuple)."""
        cft = self.comm_ft(comm)
        seq = next(cft.agree_seq)
        st = cft.state(seq)
        me = comm._world_rank
        retry = var_registry.get("ft_agree_retry_interval")
        deadline = time.monotonic() + var_registry.get("ft_agree_timeout")
        my_failed = frozenset(r for r in cft.group_ranks
                              if self.detector.is_dead(r, poll=False))
        attempt = 0
        t0 = trace_mod.begin() if trace_mod.active else 0
        while True:
            with st.cv:
                if st.decision is not None:
                    break
                st.contribs[me] = (int(bool(flag)), my_failed)
            self.detector.poll_runtime()
            known_dead = {r for r in cft.group_ranks
                          if self.detector.is_dead(r, poll=False)}
            my_failed = my_failed | frozenset(known_dead)
            live = [r for r in cft.group_ranks if r not in known_dead]
            if not live:
                raise MPIException("agree: no live ranks remain",
                                   error_class=ERR_PROC_FAILED)
            coord = live[0]
            if me == coord:
                if self._agree_decide(comm.cid, st, seq, live, known_dead):
                    break
            else:
                attempt += 1
                self._send_ft(coord, {
                    "t": "ft", "op": "agree_c", "cid": comm.cid,
                    "aseq": seq, "from": me, "flag": int(bool(flag)),
                    "failed": sorted(my_failed), "w": cft.my_w,
                    "n": attempt})
                if attempt % 8 == 0:
                    # sustained coordinator silence: gossip the
                    # contribution to everyone — any decision-holder
                    # replies, and a dead coordinator stops mattering
                    # (with rank-plane gossip armed the detector usually
                    # declares the corpse first, so re-election is
                    # bounded by the detector window, not this schedule)
                    for peer in live[1:]:
                        if peer != me:
                            self._send_ft(peer, {
                                "t": "ft", "op": "agree_c",
                                "cid": comm.cid, "aseq": seq, "from": me,
                                "flag": int(bool(flag)),
                                "failed": sorted(my_failed),
                                "w": cft.my_w, "n": attempt})
                with st.cv:
                    st.cv.wait_for(lambda: st.decision is not None,
                                   timeout=retry)
                    if st.decision is not None:
                        break
            if time.monotonic() > deadline:
                raise MPIException(
                    f"agree on cid {comm.cid} (seq {seq}) timed out",
                    error_class=ERR_PROC_FAILED)
        with st.cv:
            dflag, dfailed = st.decision
            decider = st.decider
        # acked-decision watermark: this rank has RETURNED from seq — no
        # frame for any seq <= my_w will ever leave here again, so once
        # every live member's watermark passes a seq its state is garbage
        with cft.lock:
            cft.my_w = max(cft.my_w, seq)
            my_w = cft.my_w
        if decider is not None and decider != me:
            self._send_ft(decider, {"t": "ft", "op": "agree_a",
                                    "cid": comm.cid, "aseq": seq,
                                    "from": me, "w": my_w, "n": 0})
        self._maybe_gc(cft, comm.cid)
        if t0 and trace_mod.active:
            trace_mod.complete("ft", "agree", t0, rank=self.pml.rank,
                               cid=comm.cid, aseq=seq,
                               failed=len(dfailed))
        trace_mod.count("ft_agrees_total")
        return bool(dflag), dfailed

    def _agree_decide(self, cid: int, st: _AgreeState, seq: int,
                      live: list[int], known_dead: set[int]) -> bool:
        """Coordinator arm of one agree attempt: True once decided."""
        retry = var_registry.get("ft_agree_retry_interval")
        with st.cv:
            missing = [r for r in live
                       if r != self.pml.rank and r not in st.contribs]
            if missing:
                st.cv.wait_for(lambda: st.decision is not None or all(
                    r in st.contribs for r in live if r != self.pml.rank),
                    timeout=retry)
            if st.decision is not None:
                return True
            missing = [r for r in live
                       if r != self.pml.rank and r not in st.contribs]
            if missing:
                return False  # re-evaluate liveness, try again
            flag = 1
            failed = set(known_dead)
            for f, fl in st.contribs.values():
                flag &= f
                failed |= fl
            st.decision = (flag, tuple(sorted(failed)))
            st.decider = self.pml.rank
            contributors = set(st.contribs) | set(live)
            decision = st.decision
        for peer in contributors:
            if peer != self.pml.rank:
                self._send_ft(peer, {
                    "t": "ft", "op": "agree_d", "cid": cid, "aseq": seq,
                    "flag": decision[0], "failed": list(decision[1]),
                    "from": self.pml.rank, "n": 0})
        return True


_pml_fts: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_pml_fts_lock = threading.Lock()


def pml_ft(pml: "PmlOb1") -> PmlFT:
    """The PML's FT sidecar, created on first use and installed as
    ``pml.ft`` (the attribute the PML hot paths check)."""
    ft = pml.ft
    if ft is not None:
        return ft
    with _pml_fts_lock:
        ft = _pml_fts.get(pml)
        if ft is None:
            ft = _pml_fts[pml] = PmlFT(pml)
            pml.ft = ft
    return ft


def attach_runtime(pml: "PmlOb1", client) -> None:
    """runtime.init wiring (errmgr notify/selfheal, or ft_enable): arm
    the detector against the job's control plane so peer deaths the
    launcher/heartbeat monitor observed surface as MPI_ERR_PROC_FAILED
    here, and (when ``ft_gossip_period`` > 0) start the rank-plane
    gossip heartbeats that catch in-host hangs the daemon-level layer
    cannot see.  Under selfheal the detector's revive listeners are the
    rejoin half of the cycle: the errmgr's revive clears the runtime
    dead-set, the next poll un-declares the peer, and gossip epochs
    reset so the new life is not instantly re-declared."""
    if client is None:
        return
    ft = pml_ft(pml)
    ft.detector.attach_client(client)
    ft.arm_gossip(range(client.size))


# -- Communicator-facing entry points (comm.py delegates here) -------------


def comm_revoke(comm: "Communicator") -> None:
    """≈ MPIX_Comm_revoke: poison the communicator everywhere.  Returns
    after the local mark + the first propagation wave; the flood (every
    learner forwards once) carries it to members this rank cannot reach
    directly."""
    ft = pml_ft(comm.pml)
    ft.comm_ft(comm)   # agreement on this comm stays possible
    grp = list(comm.group.ranks)
    ft.mark_revoked(comm.cid)
    _log.verbose(1, "rank %d revokes cid %d", comm.pml.rank, comm.cid)
    for peer in grp:
        if peer != comm._world_rank:
            ft._send_ft(peer, {"t": "ft", "op": "revoke", "cid": comm.cid,
                               "grp": grp, "n": 0})


def comm_is_revoked(comm: "Communicator") -> bool:
    ft = getattr(comm.pml, "ft", None)
    return ft is not None and comm.cid in ft.revoked


def comm_agree(comm: "Communicator", flag: bool = True) -> bool:
    """≈ MPIX_Comm_agree: AND of ``flag`` over the survivors; uniform
    across every rank that returns."""
    out, _failed = pml_ft(comm.pml).agree(comm, flag)
    return out


def comm_shrink(comm: "Communicator", name: Optional[str] = None
                ) -> "Communicator":
    """≈ MPIX_Comm_shrink: agree on the failed set, then build the
    survivor communicator.  The cid is hash-derived from (parent cid,
    failed set, shrink call number) in the negative cid namespace —
    every survivor computes the same value with zero extra traffic,
    exactly the create_group construction."""
    from ompi_tpu_torch.mpi.comm import Communicator
    from ompi_tpu_torch.mpi.group import Group

    ft = pml_ft(comm.pml)
    cft = ft.comm_ft(comm)
    _flag, failed = ft.agree(comm, True)
    sseq = next(cft.shrink_seq)
    survivors = [r for r in cft.group_ranks if r not in failed]
    desc = (f"shrink:{comm.cid}:{','.join(map(str, failed))}:{sseq}")
    cid = -(1 + (zlib.crc32(desc.encode()) & 0x7FFFFFFF))
    _log.verbose(1, "rank %d shrinks cid %d -> %d (lost %s)",
                 comm.pml.rank, comm.cid, cid, list(failed))
    trace_mod.count("ft_shrinks_total")
    return Communicator(Group(survivors), cid, comm._world_rank,
                        name or f"{comm.name}.shrink", pml=comm.pml)


def member_incs(comm: "Communicator") -> tuple:
    """Per-member adopted-incarnation snapshot, in group-rank order:
    this process's own life number for itself, and for peers the merge
    of BOTH adoption paths — direct transport evidence
    (``pml._peer_epoch``, set by rebind announces / si stamps) and the
    gossip-transitive ``PmlFT.adopted_inc``.  THE single source every
    collective-rejoin fence derives from: ``comm_coll_epoch`` is its
    sum, and coll/persistent's bind snapshot (whose agreed element-wise
    MAX re-stamps the pinned-slots fence) is its element-wise form —
    keeping the two fences arithmetically consistent by construction.

    Cheap common case — no adoption evidence from ANY source (first
    life, no transport-adopted epochs, no gossip-transitive adoptions):
    a handful of attribute checks, returns the empty tuple (≡ all
    zeros).  This is the fast path of the per-dispatch staleness check
    in coll/shm, so it must stay O(1) even with an armed FT sidecar —
    the O(members) walk below runs only once a revive has actually
    been adopted somewhere (every adoption source populates one of the
    three inputs: ``_adopt_incarnation`` fills ``_peer_epoch``,
    ``peer_reincarnated`` fills ``_gossip_inc``, a revived life has
    ``incarnation``)."""
    pml = comm.pml
    ft = pml.ft
    epochs = getattr(pml, "_peer_epoch", None) or {}
    own = int(getattr(pml, "incarnation", 0) or 0)
    if not epochs and not own and (
            ft is None or not getattr(ft, "_gossip_inc", None)):
        return ()
    me = pml.rank
    out = []
    for w in comm.group.ranks:
        if w == me:
            out.append(own)
            continue
        inc = int(epochs.get(w, 0))
        if ft is not None:
            inc = max(inc, int(ft.adopted_inc(w)))
        out.append(inc)
    return tuple(out)


def comm_coll_epoch(comm: "Communicator") -> int:
    """The communicator's **collective epoch**: the sum of
    :func:`member_incs`.  Incarnations are monotone per rank, so the
    epoch is a monotone generation counter that advances exactly when a
    selfheal/respawn revive is adopted — the fence every cached
    collective artifact (the coll/shm node-comm split + arena, pinned
    ``PersistentSlots``, persistent-plan bind snapshots) is stamped
    with and compared against on dispatch.  A shrink needs no bump: it
    constructs a NEW communicator whose artifacts are built fresh."""
    return sum(member_incs(comm))


def comm_get_failed(comm: "Communicator"):
    """≈ MPIX_Comm_get_failed: the group of members this process knows
    to be dead (monotonic; no agreement implied)."""
    from ompi_tpu_torch.mpi.group import Group

    ft = pml_ft(comm.pml)
    ft.detector.poll_runtime()
    return Group([r for r in comm.group.ranks
                  if ft.detector.is_dead(r, poll=False)])


def comm_ack_failed(comm: "Communicator",
                    num_to_ack: Optional[int] = None) -> int:
    """≈ MPIX_Comm_ack_failed: acknowledge (up to ``num_to_ack`` of) the
    locally-known failures; returns how many are now acknowledged."""
    ft = pml_ft(comm.pml)
    cft = ft.comm_ft(comm)
    failed = sorted(r for r in cft.group_ranks
                    if ft.detector.is_dead(r, poll=False))
    limit = len(failed) if num_to_ack is None else min(num_to_ack,
                                                      len(failed))
    cft.acked.update(failed[:limit])
    return len(cft.acked)
