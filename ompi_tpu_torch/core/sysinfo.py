"""System introspection: the timer and the host identity (the port's
trimmed copy of the JAX package's ``core/sysinfo.py``).

≈ the reference's **timer** framework (``opal/mca/timer``): monotonic +
cycle-resolution timestamps.  On modern CPython ``time.perf_counter_ns``
already reads the best monotonic clock the OS offers, so the framework
collapses to a thin facade with an interval helper.  ``host_identity``
is what reachability decisions and ``MPI_Get_processor_name`` report.

Left out: the pstat process statistics and the backtrace handlers, which
no ported module reads yet (ROADMAP.md Queue 1 item 6).
"""

from __future__ import annotations

import os
import time

__all__ = ["Timer", "host_identity"]


class Timer:
    """Monotonic interval timer (≈ opal_timer_base_get_cycles/usec)."""

    @staticmethod
    def cycles() -> int:
        """Highest-resolution monotonic tick (ns — the cycle analog)."""
        return time.perf_counter_ns()

    @staticmethod
    def usec() -> float:
        return time.perf_counter_ns() / 1e3

    @staticmethod
    def resolution_s() -> float:
        """Resolution of :meth:`cycles` in seconds (the underlying clock's
        resolution, floored at the 1ns integer truncation)."""
        return max(time.get_clock_info("perf_counter").resolution, 1e-9)

    def __init__(self) -> None:
        self._t0 = time.perf_counter_ns()

    def elapsed_s(self) -> float:
        return (time.perf_counter_ns() - self._t0) / 1e9

    def restart(self) -> float:
        """Return elapsed seconds and restart the interval."""
        now = time.perf_counter_ns()
        dt = (now - self._t0) / 1e9
        self._t0 = now
        return dt


def host_identity() -> str:
    """The canonical host identity — what reachability decisions, host
    keys, and MPI_Get_processor_name all report.  ``OMPI_TPU_FAKE_HOST``
    (set by the sim plm) overrides the nodename so co-located simulated
    hosts are genuinely distinct to every consumer at once."""
    return os.environ.get("OMPI_TPU_FAKE_HOST") or os.uname().nodename
