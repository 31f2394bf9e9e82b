"""Clock sync — measured per-daemon monotonic offsets over the OOB tree
(the port's copy of the JAX package's ``runtime/clocksync.py``, whole).

≈ the reference's lack of one, and MPI Advance's point that measurement
has to come first: every host has its own CLOCK_MONOTONIC origin (boot
time), so merging per-rank trace dumps by raw timestamps scrambles
cross-host ordering by seconds to days.  The fix is the classic
NTP-style pingpong, run over the RML tree's existing edges:

- Each orted periodically sends ``TAG_CLOCK (vpid, seq, t0)`` one hop
  toward the root; the receiving hop stamps its own clock and answers
  straight back down that edge with ``TAG_CLOCK_REPLY (seq, t0,
  t_parent, parent_off_root)``.
- The child stamps ``t3`` on delivery and feeds the triple to a
  min-RTT midpoint estimator: ``offset = t_parent - (t0 + t3)/2`` is
  exact when the two legs are symmetric, and the error is bounded by
  ``rtt/2`` — so keeping the minimum-RTT sample in a sliding window
  both bounds the error and tracks drift (old samples age out).
- Offsets COMPOSE down the tree: the reply echoes the responder's own
  offset-to-root (0 at the HNP), so ``off_root(child) = off_to_parent
  + off_root(parent)`` without any global exchange.  Ranks share their
  host daemon's kernel clock, so a daemon's offset is its ranks'.

The estimator is pure (no sockets, no threads) so tests drive it with
synthetic clocks; :class:`ClockProber` owns the probe loop and the
reply handler; :func:`install_responder` is the three-line server side
any node (orted or HNP) installs.

In the port the orted runs a prober and a responder and the HNP a
responder (``runtime/orted.py``, ``runtime/plm.py``).  The orted stamps
its composed offset on every rank row it forwards up the metrics uplink
(``rank_clock_to_root_ns``), and the timeline merge
(``runtime/timeline.py``) corrects each capture that carries a measured
``clock_to_root_ns`` with it: a standing DVM's ``TAG_TIMELINE`` capture
stamps every live rank's row with its orted's offset
(``runtime/orted.py``, ``runtime/dvm.py``).
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Any, Callable, Optional

from ompi_tpu_torch.core import output
from ompi_tpu_torch.core.config import VarType, register_var, var_registry
from ompi_tpu_torch.runtime import rml

__all__ = ["OffsetEstimator", "ClockProber", "install_responder"]

_log = output.get_stream("clocksync")

register_var("clock", "sync_period", VarType.DOUBLE, 1.0,
             "seconds between clock-sync pingpongs up the RML tree "
             "(0 = disabled; trace merges then fall back to per-rank "
             "wall-clock anchors)")
register_var("clock", "sync_window", VarType.INT, 16,
             "sliding window of pingpong samples the min-RTT offset "
             "estimator keeps (drift tracking: old samples age out)")


class OffsetEstimator:
    """Min-RTT midpoint offset estimator for ONE edge.

    ``observe(t0, t_peer, t3)`` takes the local send stamp, the peer's
    reply stamp, and the local delivery stamp (all ns).  The reported
    offset is peer_clock - local_clock — ADD it to a local monotonic
    timestamp to express it on the peer's clock.  Error is bounded by
    half the retained sample's RTT (asymmetry can use at most the
    whole of one leg).
    """

    def __init__(self, window: int = 16) -> None:
        self._samples: deque[tuple[int, int]] = deque(maxlen=max(1, window))
        self._n = 0

    def observe(self, t0_ns: int, t_peer_ns: int, t3_ns: int) -> None:
        rtt = t3_ns - t0_ns
        if rtt < 0:
            return   # reordered/stale delivery: not a usable sample
        self._samples.append((rtt, t_peer_ns - (t0_ns + t3_ns) // 2))
        self._n += 1

    def reset(self) -> None:
        """Forget everything (the peer changed: offsets don't mix)."""
        self._samples.clear()

    def offset_ns(self) -> Optional[int]:
        """Offset of the min-RTT sample in the window, or None."""
        if not self._samples:
            return None
        return min(self._samples)[1]

    def rtt_ns(self) -> Optional[int]:
        """RTT of the best sample — 2x the worst-case offset error."""
        if not self._samples:
            return None
        return min(self._samples)[0]

    def sample_count(self) -> int:
        """Samples observed over the estimator's lifetime."""
        return self._n


def install_responder(node: rml.RmlNode,
                      off_root_fn: Callable[[], Optional[int]]) -> None:
    """Answer TAG_CLOCK probes on ``node``: stamp-and-reply down the
    probed edge.  ``off_root_fn`` supplies this node's own
    offset-to-root (0 at the HNP, the prober's composed estimate on a
    mid-tree daemon, None while unknown).  Runs on the link reader
    thread by design — handing off to a worker would add scheduler
    jitter between delivery and the t_parent stamp; the reply itself
    is a tiny fire-and-forget send."""

    def _on_clock(origin: int, payload: Any) -> None:
        t_here = time.monotonic_ns()   # stamp FIRST: jitter below only
        # inflates the prober's RTT, never skews the midpoint
        vpid, seq, t0_ns = payload
        if not node.send_child(   # lint: reader-ok
                vpid, rml.TAG_CLOCK_REPLY,
                (seq, t0_ns, t_here, off_root_fn())):
            _log.verbose(2, "clocksync %d: no link to prober %d",
                         node.vpid, vpid)

    node.register_recv(rml.TAG_CLOCK, _on_clock)


class ClockProber:
    """Daemon-side probe loop: pingpong the parent edge, compose the
    offset-to-root, hand the answer to /status and the metrics plane."""

    def __init__(self, node: rml.RmlNode,
                 period: Optional[float] = None) -> None:
        self.node = node
        if period is None:
            period = float(var_registry.get("clock_sync_period") or 0)
        self.period = period
        window = int(var_registry.get("clock_sync_window") or 16)
        self.est = OffsetEstimator(window)
        self._responder: Optional[int] = None
        self._parent_off_root: Optional[int] = None
        self._seq = itertools.count(1)
        self._pending: dict[int, int] = {}   # seq → t0 (lossy, pruned)
        self._last_reply_mono = 0.0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        node.register_recv(rml.TAG_CLOCK_REPLY, self._on_reply)

    # -- probe side -------------------------------------------------------

    def start(self) -> None:
        if self.period <= 0 or self.node.vpid == 0 \
                or self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name=f"clocksync-{self.node.vpid}",
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _run(self) -> None:
        # a short opening burst fills the window fast (the first trace
        # capture should not wait a full minute for 16 samples)
        for _ in range(4):
            if self._stop.wait(0.05):
                return
            self.probe_once()
        while not self._stop.wait(self.period):
            self.probe_once()

    def probe_once(self) -> None:
        """Send one probe up the tree (lossy: no retry, the next round
        re-probes; stale pendings are pruned on a small bound)."""
        seq = next(self._seq)
        with self._lock:
            if len(self._pending) > 64:
                for k in sorted(self._pending)[:32]:
                    del self._pending[k]
            t0 = time.monotonic_ns()
            self._pending[seq] = t0
        try:
            self.node.send_hop(rml.TAG_CLOCK, (self.node.vpid, seq, t0))
        except (ConnectionError, OSError):
            pass   # orphaned window: the next round retries

    def _on_reply(self, origin: int, payload: Any) -> None:
        t3 = time.monotonic_ns()   # stamp before any bookkeeping
        seq, t0_ns, t_peer_ns, peer_off_root = payload
        with self._lock:
            sent_t0 = self._pending.pop(seq, None)
            if sent_t0 is None or sent_t0 != t0_ns:
                return   # duplicate or stale reply
            if origin != self._responder:
                # re-parented (or fallback answered): samples against a
                # different clock must not mix into the min-RTT window
                self._responder = origin
                self.est.reset()
                self._parent_off_root = None
            self.est.observe(t0_ns, t_peer_ns, t3)
            if peer_off_root is not None:
                self._parent_off_root = int(peer_off_root)
            self._last_reply_mono = time.monotonic()

    # -- answers ----------------------------------------------------------

    def offset_to_root_ns(self) -> Optional[int]:
        """This daemon's composed monotonic offset to vpid 0 (add to a
        local monotonic ns to express it on the root's clock), or None
        until both the edge estimate and the parent's own composition
        exist.  The HNP is its own root: always 0."""
        if self.node.vpid == 0:
            return 0
        with self._lock:
            edge = self.est.offset_ns()
            if edge is None or self._parent_off_root is None:
                return None
            return edge + self._parent_off_root

    def stats(self) -> dict[str, Any]:
        """The /status block: edge estimate, composed offset, quality."""
        with self._lock:
            edge = self.est.offset_ns()
            rtt = self.est.rtt_ns()
            n = self.est.sample_count()
            responder = self._responder
            por = self._parent_off_root
            age = (time.monotonic() - self._last_reply_mono
                   if self._last_reply_mono else None)
        off_root = 0 if self.node.vpid == 0 else (
            None if edge is None or por is None else edge + por)
        return {"offset_to_root_ns": off_root, "edge_offset_ns": edge,
                "rtt_ns": rtt, "samples": n, "responder": responder,
                "reply_age_s": age}
