"""Clock sync — the min-RTT offset estimator (the port's copy of the JAX
package's ``runtime/clocksync.py``, its :class:`OffsetEstimator` only).

Every host has its own CLOCK_MONOTONIC origin (boot time), so merging
per-rank trace dumps by raw timestamps scrambles cross-host ordering.
The fix is the classic NTP-style pingpong: a probe ``t0``, the peer's
reply stamp ``t_peer`` and the delivery stamp ``t3`` give ``offset =
t_peer - (t0 + t3)/2``, exact when the two legs are symmetric, with an
error bounded by ``rtt/2`` — so keeping the minimum-RTT sample in a
sliding window both bounds the error and tracks drift (old samples age
out).  The estimator is pure (no sockets, no threads).

Left out (ROADMAP.md Queue 1 item 6.15): the probe loop over the orted
tree (``ClockProber``) and its server side (``install_responder``), which
ride ``runtime/rml.py``; until then the timeline merge falls back to each
rank's wall-clock anchor.
"""

from __future__ import annotations

from collections import deque
from typing import Optional

__all__ = ["OffsetEstimator"]


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
