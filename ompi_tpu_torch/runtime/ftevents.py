"""FT event timeline — the structured record of the failure machinery
(the port's copy of the JAX package's ``runtime/ftevents.py``, whole).

Every rung of the errmgr/selfheal ladder (detect, reap, revive, shrink,
escalate, abort) and the containment plane (daemon loss, re-parenting)
records one structured event here, stamped with wall-clock, monotonic
time, jobid, rank and incarnation — so a kill-storm is readable AFTER
the fact (the daemon tree's HNP records its daemon losses and
re-parenting rounds here, a standing DVM its stuck events, doctor
verdicts, remediations and requeues, and serves the log per job on its
``/status`` endpoint), and each event doubles as a flight-recorder
instant (category
``errmgr``) when tracing is armed.

The log is a bounded ring (oldest events fall off first, like the trace
ring) and lives in the launcher/HNP process — the only place every
detection source converges.  Recording is lock-cheap (one deque append
under a lock) and must stay non-blocking: several record sites run on
RML link reader threads (see the ``reader-thread`` lint checker).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Optional

__all__ = ["FtEventLog", "log", "record", "KINDS"]

#: the event vocabulary — the ladder rungs, the containment plane, and
#: the hang-doctor plane ("stuck" = a rank's watchdog crossed
#: coll_stuck_timeout; "doctor" = a cross-rank capture produced a
#: verdict)
#: ``coll_rejoin`` = a rank's epoch-fenced coll-hierarchy rebuild after
#: a selfheal revive landed (pushed by the rank via the one-way PMIx
#: "coll_rejoin" RPC — the rejoin half of the revive cycle)
#: ``remediate`` = the DVM's doctor-driven remediation actor acted on a
#: watchdog verdict (SIGCONT probe / reap-and-revive / kill+requeue /
#: budget-exhausted reject); ``requeue`` = a remediated job went back on
#: the admission queue for a fresh placement
#: ``truncated`` = a synthetic marker the ring PREPENDS to snapshots
#: once capacity eviction has discarded events — truncation is explicit,
#: never silent (the marker's info.dropped counts the forgotten events)
KINDS = ("detect", "reap", "revive", "shrink", "escalate", "abort",
         "daemon_lost", "reparent", "finished", "stuck", "doctor",
         "coll_rejoin", "remediate", "requeue", "truncated")


class FtEventLog:
    """Bounded, thread-safe timeline of FT events."""

    def __init__(self, capacity: int = 1024) -> None:
        self._lock = threading.Lock()
        self._events: collections.deque = collections.deque(
            maxlen=max(16, capacity))
        self._n = 0
        self._dropped = 0   # events the ring evicted (capacity)

    def record(self, kind: str, jobid: int = 0, rank: int = -1,
               lives: int = 0, **info: Any) -> dict:
        """Append one event; returns the record (tests/tools read it).
        Also emits an ``errmgr`` trace instant when tracing is armed, so
        the merged Perfetto timeline shows the FT plane inline with the
        transport spans."""
        ev = {
            "seq": 0,                     # stamped under the lock below
            "wall": time.time(),
            "mono_ns": time.monotonic_ns(),
            "kind": kind,
            "jobid": int(jobid),
            "rank": int(rank),
            "lives": int(lives),
        }
        if info:
            ev["info"] = {k: v for k, v in info.items() if v is not None}
        with self._lock:
            self._n += 1
            ev["seq"] = self._n
            if len(self._events) == self._events.maxlen:
                self._dropped += 1   # the append below evicts the oldest
            self._events.append(ev)
        from ompi_tpu_torch.mpi import trace as trace_mod

        if trace_mod.active:
            trace_mod.instant("errmgr", f"ft:{kind}", rank=rank,
                              jobid=jobid, lives=lives,
                              **(ev.get("info") or {}))
        return ev

    def snapshot(self, jobid: Optional[int] = None) -> list[dict]:
        """Events oldest-first, optionally filtered to one job (events
        recorded with jobid 0 — pre-job containment noise — ride along
        with every job filter: a daemon loss belongs to any timeline
        that overlaps it).  Once capacity eviction has forgotten events,
        every snapshot leads with an explicit ``truncated`` marker
        (jobid 0, so it survives any job filter) naming how many — a
        reader must never mistake a clipped timeline for a complete
        one."""
        with self._lock:
            events = list(self._events)
            dropped = self._dropped
        if jobid is not None:
            events = [e for e in events
                      if e["jobid"] == int(jobid) or e["jobid"] == 0]
        if dropped:
            events.insert(0, {
                "seq": 0, "wall": 0.0, "mono_ns": 0,
                "kind": "truncated", "jobid": 0, "rank": -1, "lives": 0,
                "info": {"dropped": dropped,
                         "detail": f"ring evicted {dropped} older "
                                   f"event(s); timeline is a tail"}})
        return events

    def total(self) -> int:
        """Events ever recorded (including those the ring forgot)."""
        with self._lock:
            return self._n

    def dropped(self) -> int:
        """Events the bounded ring evicted (0 = the snapshot is the
        complete history)."""
        with self._lock:
            return self._dropped

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._dropped = 0


#: process-global log (the launcher/HNP is one process; tests may make
#: their own FtEventLog instances)
log = FtEventLog()


def record(kind: str, jobid: int = 0, rank: int = -1, lives: int = 0,
           **info: Any) -> dict:
    """Record one FT event on the process-global timeline."""
    return log.record(kind, jobid=jobid, rank=rank, lives=lives, **info)
