"""Pessimist-protocol message logging: sender payloads + event order.

≈ ompi/mca/vprotocol/pessimist (vprotocol_pessimist.h:29-56), both halves:

- :class:`MessageLog` — every send since the last checkpoint is logged on
  the sender so that, after a peer restarts from that checkpoint, the
  sender can replay exactly the traffic the restarted process lost.
- :class:`EventLog` — the *nondeterministic event* half: the match order
  of wildcard receives (ANY_SOURCE/ANY_TAG) is recorded in posting order;
  on replay the same wrapper rewrites each wildcard receive to the
  recorded (source, tag), forcing the restarted process down the exact
  matching sequence of its first life.  An SPMD step-boundary checkpoint
  discipline (ckpt.snapc) removes most of the need — EventLog covers the
  host-path programs that do use wildcards between checkpoints.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

import numpy as np

from ompi_tpu_torch.core import output
from ompi_tpu_torch.mpi import pml as pml_mod
from ompi_tpu_torch.mpi import trace as trace_mod
from ompi_tpu_torch.mpi.constants import ANY_SOURCE, ANY_TAG, ERR_IO

_log = output.get_stream("msglog")

__all__ = ["MessageLog", "EventLog"]


class MessageLog:
    """Logs outbound user messages (payload copies) between checkpoints.

    Attach to a communicator; ``mark()`` at every checkpoint truncates the
    log; ``replay(to_rank)`` re-sends everything a restarted peer lost.
    Only user p2p traffic (tag ≥ 0) is logged — collective-internal tags
    are regenerated by re-running the collective after restart.
    """

    def __init__(self, comm, max_bytes: int = 64 << 20) -> None:
        self.comm = comm
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._log: list[tuple[int, int, np.ndarray]] = []  # (dest,tag,data)
        self._bytes = 0
        self._complete = True   # False once eviction has dropped entries
        self._attached = False
        # replay()/detach() work (as no-ops on the wrapper) even if the log
        # was never attach()ed — bound here so they can't hit AttributeError
        self._orig_isend = comm.isend

    # the log wraps isend at the communicator level (payload + user tag are
    # in hand here; the PML event only carries sizes)

    def attach(self, auto_replay: bool = False) -> "MessageLog":
        """Wrap the communicator's isend; with ``auto_replay`` also
        subscribe to the PML's peer-revived event and replay the logged
        stream to each peer as its new incarnation is adopted — sends
        that died with the old incarnation's transport (written into an
        orphaned ring in the death window) are re-delivered without the
        application polling for failures."""
        if self._attached:
            if auto_replay and getattr(self, "_revived_cb", None) is None:
                from ompi_tpu_torch.mpi.constants import MPIException

                raise MPIException(
                    "MessageLog already attached without auto_replay; "
                    "detach() first — silently ignoring the upgrade "
                    "would leave revival recovery unarmed", error_class=3)
            return self
        comm = self.comm
        self._orig_isend = comm.isend
        if auto_replay:
            def do_replay(r: int) -> None:
                try:
                    # no detector reconciliation needed here: every
                    # EVT_PEER_REVIVED emit site runs peer_reincarnated
                    # (→ detector.revive) on the adopt transition BEFORE
                    # the event is dispatched, so any stale local death
                    # that would fail the replay's sends is already
                    # cleared — and the revive stamp keeps a concurrent
                    # stale runtime poll from re-marking it
                    n = self.replay(r)
                    _log.verbose(1, "auto-replayed %d messages to "
                                 "revived rank %d", n, r)
                except Exception as e:  # noqa: BLE001 — replay is
                    # best-effort recovery; the failure is observable
                    _log.error("auto-replay to revived rank %d failed: "
                               "%r", r, e)

            def on_event(event: str, info: dict) -> None:
                if event != pml_mod.EVT_PEER_REVIVED:
                    return
                r = self.comm.group.rank_of(info["peer"])
                if r is None or r < 0:
                    return
                # replay on its own thread: the dispatcher may be a
                # transport reader thread, and replay blocks on sends
                threading.Thread(target=do_replay, args=(r,),
                                 daemon=True,
                                 name="msglog-replay").start()

            self._revived_cb = on_event
            comm.pml.add_listener(on_event)

        def logging_isend(buf: Any, dest: int, tag: int = 0,
                          datatype=None, count=None):
            # initiate first: a send the PML rejects was never part of the
            # execution and must not be replayed
            req = self._orig_isend(buf, dest, tag, datatype, count)
            if tag >= 0 and dest >= 0:
                arr = np.array(np.asarray(buf), copy=True)
                with self._lock:
                    self._log.append((dest, tag, arr))
                    self._bytes += arr.nbytes
                    while self._bytes > self.max_bytes and self._log:
                        _, _, old = self._log.pop(0)
                        self._bytes -= old.nbytes
                        self._complete = False  # replay can no longer
                        # reconstruct the full inter-checkpoint stream
            return req

        comm.isend = logging_isend
        self._attached = True
        return self

    def detach(self) -> None:
        if self._attached:
            self.comm.isend = self._orig_isend
            self._attached = False
            cb = getattr(self, "_revived_cb", None)
            if cb is not None:
                self.comm.pml.remove_listener(cb)
                self._revived_cb = None

    def __enter__(self) -> "MessageLog":
        return self.attach()

    def __exit__(self, *exc) -> None:
        self.detach()

    # -- checkpoint interface ----------------------------------------------

    def mark(self) -> None:
        """Checkpoint taken: everything before this is re-creatable from
        the snapshot; drop it."""
        with self._lock:
            self._log.clear()
            self._bytes = 0
            self._complete = True

    @property
    def complete(self) -> bool:
        """False when the byte cap has evicted entries — replay would be
        missing messages."""
        return self._complete

    def pending(self, to_rank: Optional[int] = None
                ) -> list[tuple[int, int, np.ndarray]]:
        with self._lock:
            return [e for e in self._log
                    if to_rank is None or e[0] == to_rank]

    def replay(self, to_rank: int) -> int:
        """Re-send (in original order) every logged message for a restarted
        peer; returns the number replayed.  Refuses when eviction has made
        the log incomplete — a partial replay silently mismatches the
        peer's re-posted receives."""
        if not self._complete:
            from ompi_tpu_torch.mpi.constants import MPIException

            raise MPIException(
                "message log incomplete (byte cap evicted entries); "
                "cannot replay a full stream — raise max_bytes or "
                "checkpoint more often", error_class=ERR_IO)
        _t0 = trace_mod.begin() if trace_mod.active else 0
        n = 0
        for dest, tag, data in self.pending(to_rank):
            self._orig_isend(data, dest, tag).wait()
            n += 1
        if _t0 and trace_mod.active:
            trace_mod.complete("ckpt", "msglog_replay", _t0,
                               rank=self.comm.pml.rank, peer=to_rank,
                               messages=n)
        return n

    @property
    def nbytes(self) -> int:
        return self._bytes


class EventLog:
    """Records (or replays) the match order of wildcard receives.

    Record mode (default): each wildcard ``irecv`` gets a slot in posting
    order; on completion the slot is filled with the matched
    ``(source, tag)``.  ``events()`` returns the completed history — store
    it next to the checkpoint (it is plain ints).

    Replay mode (``EventLog(comm, replay=events)``): the i-th wildcard
    ``irecv`` posted is rewritten to the i-th recorded ``(source, tag)``,
    so the restarted process matches messages in exactly the original
    order regardless of arrival timing (the pessimist guarantee).  Once
    the recorded history is exhausted the wrapper records again — the
    process has caught up to the nondeterministic frontier.
    """

    def __init__(self, comm,
                 replay: Optional[list[tuple[int, int]]] = None) -> None:
        self.comm = comm
        # RLock: the slot reservation AND the irecv post happen under one
        # critical section (slot order must equal PML posting order, or
        # replay pairs the wrong events); a same-thread synchronous match
        # (unexpected-queue hit completing inside irecv) may re-enter via
        # a completion callback
        self._lock = threading.RLock()
        self._events: list[Optional[tuple[int, int]]] = []
        self._epoch = 0     # bumped by mark(); stale completions dropped
        self._replay = list(replay) if replay else []
        self._replay_pos = 0
        self._attached = False
        self._orig_irecv = comm.irecv

    def attach(self) -> "EventLog":
        if self._attached:
            return self
        self._orig_irecv = self.comm.irecv

        def wrapped_irecv(buf=None, source: int = 0, tag: int = ANY_TAG,
                          datatype=None, count=None):
            wild = source == ANY_SOURCE or tag == ANY_TAG
            if not wild:
                return self._orig_irecv(buf, source, tag, datatype, count)
            with self._lock:
                if self._replay_pos < len(self._replay):
                    src, tg = self._replay[self._replay_pos]
                    self._replay_pos += 1
                    return self._orig_irecv(buf, src, tg, datatype, count)
                slot = len(self._events)
                epoch = self._epoch
                self._events.append(None)
                # post INSIDE the lock: slot order == PML posting order
                req = self._orig_irecv(buf, source, tag, datatype, count)

            def fill(r, slot=slot, epoch=epoch):
                # status carries the WORLD rank; record the comm-local one
                # (it is what a replayed irecv(source=...) expects)
                src = r.status.source
                if src >= 0:
                    src = self.comm.group.rank_of(src)
                with self._lock:
                    if epoch != self._epoch:
                        return  # completed across a mark(): belongs to
                        # the pre-checkpoint epoch, not the new history
                    self._events[slot] = (src, r.status.tag)

            req.add_completion_callback(fill)
            return req

        self.comm.irecv = wrapped_irecv
        self._attached = True
        return self

    def detach(self) -> None:
        if self._attached:
            self.comm.irecv = self._orig_irecv
            self._attached = False

    def __enter__(self) -> "EventLog":
        return self.attach()

    def __exit__(self, *exc) -> None:
        self.detach()

    def events(self) -> list[tuple[int, int]]:
        """The recorded wildcard-match history, posting order.  Raises if
        a recorded receive has not completed (an incomplete history would
        replay a hole)."""
        with self._lock:
            if any(e is None for e in self._events):
                from ompi_tpu_torch.mpi.constants import MPIException

                raise MPIException(
                    "event log has outstanding wildcard receives; drain "
                    "them (checkpoint at a quiescent point) before "
                    "capturing the history")
            return list(self._events)  # type: ignore[arg-type]

    def mark(self) -> None:
        """Checkpoint taken: history before it replays from the snapshot.
        Bumps the epoch so a wildcard still in flight across the mark
        cannot write a pre-checkpoint event into the new history."""
        with self._lock:
            self._epoch += 1
            self._events.clear()

    @property
    def replaying(self) -> bool:
        with self._lock:
            return self._replay_pos < len(self._replay)
