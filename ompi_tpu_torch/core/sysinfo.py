"""System introspection: timers, process stats, crash backtraces and the
host identity (the port's copy of the JAX package's ``core/sysinfo.py``).

≈ three small OPAL frameworks the reference always builds:

- **timer** (``opal/mca/timer``): monotonic + cycle-resolution timestamps.
  On modern CPython ``time.perf_counter_ns`` already reads the best
  monotonic clock the OS offers, so the framework collapses to a thin
  facade with an interval helper.
- **pstat** (``opal/mca/pstat``): per-process resource usage read from
  ``/proc`` (Linux) or ``resource`` (portable) — RSS, user/system time,
  thread count.
- **backtrace** (``opal/mca/backtrace`` + ``opal/util/stacktrace.c``):
  signal handlers that dump every thread's Python stack on fatal
  signals — CPython's ``faulthandler`` is exactly this mechanism.

``host_identity`` is what reachability decisions and
``MPI_Get_processor_name`` report.
"""

from __future__ import annotations

import os
import time
from typing import Optional

__all__ = ["Timer", "proc_stats", "install_backtrace_handlers",
           "host_identity"]


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


def proc_stats(pid: Optional[int] = None) -> dict:
    """Resource usage for one process (≈ pstat query: rss, cpu, threads).

    Reads /proc when available (any pid), falls back to ``resource`` for
    the calling process on non-Linux.
    """
    pid = os.getpid() if pid is None else pid
    stats: dict = {"pid": pid}
    try:
        with open(f"/proc/{pid}/stat") as f:
            fields = f.read().rsplit(") ", 1)[1].split()
        tick = os.sysconf("SC_CLK_TCK")
        page = os.sysconf("SC_PAGE_SIZE")
        stats.update(
            state=fields[0],
            utime_s=int(fields[11]) / tick,
            stime_s=int(fields[12]) / tick,
            threads=int(fields[17]),
            vsize_bytes=int(fields[20]),
            rss_bytes=int(fields[21]) * page,
        )
        return stats
    except (OSError, IndexError, ValueError):
        pass
    try:  # portable fallback: self/children only
        import resource

        ru = resource.getrusage(resource.RUSAGE_SELF)
        stats.update(utime_s=ru.ru_utime, stime_s=ru.ru_stime,
                     rss_bytes=ru.ru_maxrss * 1024, threads=None,
                     state="?")
    except Exception:  # noqa: BLE001 — diagnostics must never raise
        pass
    return stats


_installed = False


def install_backtrace_handlers(all_threads: bool = True) -> bool:
    """Dump Python stacks of every thread on SIGSEGV/SIGFPE/SIGABRT/SIGBUS
    (≈ opal_util_register_stackhandlers).  Idempotent; returns whether the
    handlers are active."""
    global _installed
    if _installed:
        return True
    try:
        import faulthandler

        faulthandler.enable(all_threads=all_threads)
        _installed = True
    except Exception:  # noqa: BLE001 — e.g. no stderr in embedded use
        return False
    return True
