"""Communication monitoring: per-peer, per-class message/byte counts and a
PMPI-style timing profiler (the port's copy of the JAX package's
``mpi/monitoring.py``, whole; the osc class counts the host windows'
traffic, ``mpi.osc``'s tags 500 and up).

≈ the reference's monitoring stack — pml/coll/osc ``monitoring``
interposition components + ompi/mca/common/monitoring (counts messages and
bytes per peer per class, exported as MPI_T pvars, dumped as a
communication matrix by profile2mat.pl) and the PMPI profiling layer
(ompi/mpi/c/send.c:36-38 weak symbols).

Redesign: instead of interposing a whole component layer, a Monitor
subscribes to the PML's PERUSE-style event hooks (pml.py EVT_*) and
classifies traffic by the reserved wire-tag ranges the frameworks already
use — user p2p (tag ≥ 0), collectives (blocking + nonblocking + neighbor
internal tags), one-sided (the OSC tag window).  The same numbers the
reference gathers, with zero per-call overhead when no monitor is
attached (one list check in the PML hot path).

The :class:`Profiler` wraps a Communicator like the PMPI shim wraps MPI_*
symbols: every public method is timed and counted, the object is otherwise
transparent.
"""

from __future__ import annotations

import io as _stdio
import threading
import time
from typing import Any, Optional

import numpy as np

from ompi_tpu_torch.mpi import pml as pml_mod
from ompi_tpu_torch.mpi.mpit import Pvar, PvarClass, pvar_registry

__all__ = ["Monitor", "Profiler", "CLASSES", "classify_tag"]

CLASSES = ("pt2pt", "coll", "osc")

# wire tags are _INTERNAL_TAG_BASE - coll_tag for internal traffic (see
# comm.py); the coll-tag windows are: blocking coll 1..63, nbc 64..499,
# osc 500..699, neighbor 700..891
_OSC_LO, _OSC_HI = 500, 699


def classify_tag(wire_tag: int) -> str:
    """Map a wire tag to a monitoring class (≈ the reference attributing
    traffic to the pml/coll/osc monitoring component that saw it)."""
    if wire_tag >= 0:
        return "pt2pt"
    coll_tag = -1000 - wire_tag          # invert comm.py's encoding
    if _OSC_LO <= coll_tag <= _OSC_HI:
        return "osc"
    return "coll"


class Monitor:
    """Attached to one rank's PML; counts sent/received messages+bytes per
    peer per class (the common_monitoring matrices)."""

    def __init__(self, pml, nranks: int,
                 register_pvars: bool = False) -> None:
        self.pml = pml
        self.nranks = nranks
        self._lock = threading.Lock()
        z = lambda: np.zeros(nranks, dtype=np.int64)  # noqa: E731
        self.sent_count = {c: z() for c in CLASSES}
        self.sent_bytes = {c: z() for c in CLASSES}
        self.recv_count = {c: z() for c in CLASSES}
        self.recv_bytes = {c: z() for c in CLASSES}
        self.unexpected = 0              # frames queued unmatched
        self.matched = 0
        self._attached = False
        self._register = register_pvars
        self._pvar_names: list[str] = []

    # -- attachment --------------------------------------------------------

    def attach(self) -> "Monitor":
        if not self._attached:
            if self._register and not self._pvar_names:
                self._register_pvars()  # re-export on every (re)attach
            self.pml.add_listener(self._on_event)
            self._attached = True
        return self

    def detach(self) -> None:
        # flip the flag under our own lock FIRST: an event already drained
        # from the PML queue on another thread then becomes a no-op, so
        # counts are deterministically frozen when detach() returns
        with self._lock:
            self._attached = False
        try:
            self.pml.remove_listener(self._on_event)
        except ValueError:
            pass
        for name in self._pvar_names:
            pvar_registry.unregister(name)
        self._pvar_names.clear()

    def __enter__(self) -> "Monitor":
        return self.attach()

    def __exit__(self, *exc) -> None:
        self.detach()

    # -- event sink --------------------------------------------------------

    def _on_event(self, event: str, info: dict) -> None:
        with self._lock:
            if not self._attached:   # late dispatch after detach(): drop
                return
            if event == pml_mod.EVT_SEND_POST:
                cls = classify_tag(info["tag"])
                peer = info["peer"]
                if 0 <= peer < self.nranks:
                    self.sent_count[cls][peer] += 1
                    self.sent_bytes[cls][peer] += info["nbytes"]
            elif event == pml_mod.EVT_DELIVER:
                cls = classify_tag(info["tag"])
                peer = info["peer"]
                if 0 <= peer < self.nranks:
                    self.recv_count[cls][peer] += 1
                    self.recv_bytes[cls][peer] += info["nbytes"]
            elif event == pml_mod.EVT_UNEXPECTED:
                self.unexpected += 1
            elif event == pml_mod.EVT_MATCH:
                self.matched += 1

    # -- MPI_T export ------------------------------------------------------

    def _register_pvars(self) -> None:
        rank = self.pml.rank
        # both directions + the matching-engine counters, so the MPI_T
        # view carries the same information as the matrices (the
        # reference's common_monitoring exports recv pvars too)
        specs = [
            (f"pml_monitoring_messages_count_{rank}", "messages",
             lambda m: int(sum(a.sum() for a in m.sent_count.values()))),
            (f"pml_monitoring_messages_size_{rank}", "bytes",
             lambda m: int(sum(a.sum() for a in m.sent_bytes.values()))),
            (f"pml_monitoring_messages_recv_count_{rank}", "messages",
             lambda m: int(sum(a.sum() for a in m.recv_count.values()))),
            (f"pml_monitoring_messages_recv_size_{rank}", "bytes",
             lambda m: int(sum(a.sum() for a in m.recv_bytes.values()))),
            (f"pml_monitoring_unexpected_{rank}", "messages",
             lambda m: m.unexpected),
            (f"pml_monitoring_matched_{rank}", "messages",
             lambda m: m.matched),
        ]
        try:
            for name, unit, fn in specs:
                # strict register: a second exporting Monitor on the same
                # rank would otherwise read (and on detach, destroy) the
                # first one's pvars — make the conflict loud instead
                pvar_registry.register(Pvar(
                    name, PvarClass.COUNTER, unit=unit,
                    description="monitoring counter",
                    read_fn=lambda m, fn=fn: fn(m if m is not None
                                                else self),
                ))
                self._pvar_names.append(name)
        except Exception:
            for name in self._pvar_names:
                pvar_registry.unregister(name)
            self._pvar_names.clear()
            raise

    # -- reporting (profile2mat equivalent) --------------------------------

    def totals(self) -> dict:
        with self._lock:
            return {
                "sent_count": {c: int(v.sum())
                               for c, v in self.sent_count.items()},
                "sent_bytes": {c: int(v.sum())
                               for c, v in self.sent_bytes.items()},
                "recv_count": {c: int(v.sum())
                               for c, v in self.recv_count.items()},
                "recv_bytes": {c: int(v.sum())
                               for c, v in self.recv_bytes.items()},
                "unexpected": self.unexpected,
                "matched": self.matched,
            }

    def matrices(self) -> dict:
        """All four per-peer matrices as one nested dict —
        ``{what: {class: int64 array of len nranks}}`` plus the scalar
        engine counters.  Copies, taken under the lock: callers may keep
        the result across a detach()/attach() cycle."""
        with self._lock:
            out: dict = {
                what: {c: getattr(self, what)[c].copy() for c in CLASSES}
                for what in ("sent_count", "sent_bytes",
                             "recv_count", "recv_bytes")
            }
            out["unexpected"] = self.unexpected
            out["matched"] = self.matched
        return out

    def row(self, what: str = "sent_bytes",
            cls: Optional[str] = None) -> np.ndarray:
        """This rank's row of the communication matrix: per-peer totals
        (sum over classes unless one is named)."""
        store = getattr(self, what)
        with self._lock:
            if cls is not None:
                return store[cls].copy()
            return sum(store.values()).astype(np.int64)

    def dump(self, stream=None) -> str:
        """Human-readable per-peer table (≈ profile2mat.pl output)."""
        out = stream or _stdio.StringIO()
        print(f"# monitoring rank {self.pml.rank} "
              f"({self.nranks} peers)", file=out)
        for cls in CLASSES:
            sc, sb = self.sent_count[cls], self.sent_bytes[cls]
            if sc.sum() == 0:
                continue
            for peer in range(self.nranks):
                if sc[peer]:
                    print(f"{cls} -> {peer}: {int(sc[peer])} msgs "
                          f"{int(sb[peer])} B", file=out)
        return out.getvalue() if stream is None else ""


def gather_matrix(comm, monitor: Monitor,
                  what: str = "sent_bytes") -> Optional[np.ndarray]:
    """Collectively assemble the full N×N communication matrix on rank 0
    (row r = what rank r sent to each peer)."""
    rows = comm.gather(monitor.row(what), root=0)
    if comm.rank != 0:
        return None
    return np.asarray(rows).reshape(comm.size, monitor.nranks)


class Profiler:
    """PMPI-layer equivalent: a transparent Communicator proxy that counts
    calls and accumulates wall time per method name."""

    def __init__(self, comm) -> None:
        self._comm = comm
        self._lock = threading.Lock()
        self.calls: dict[str, int] = {}
        self.seconds: dict[str, float] = {}

    def __getattr__(self, name: str) -> Any:
        target = getattr(self._comm, name)
        if not callable(target):
            return target

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return target(*a, **kw)
            finally:
                dt = time.perf_counter() - t0
                with self._lock:
                    self.calls[name] = self.calls.get(name, 0) + 1
                    self.seconds[name] = self.seconds.get(name, 0.0) + dt

        return timed

    def report(self) -> dict[str, tuple[int, float]]:
        with self._lock:
            return {k: (self.calls[k], self.seconds[k])
                    for k in sorted(self.calls)}
