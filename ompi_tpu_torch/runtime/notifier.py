"""Notifier — admin-facing event alerts (the port's copy of the JAX
package's ``runtime/notifier.py``, whole).

≈ orte/mca/notifier (syslog/smtp components): job-level events the
operator should see even when stdout scrolled away — job abort, daemon
loss, rank respawn — go through a severity-filtered notifier framework.

Components:
- ``syslog`` — forwards to the system log via the stdlib syslog binding.
- ``log``    — forwards to the framework's own output streams (always
  available; the default, so tests and containers without a syslog daemon
  still capture events).

Select with ``--mca notifier syslog``; filter with
``--mca notifier_severity warn``.
"""

from __future__ import annotations

import enum
from typing import Optional

from ompi_tpu_torch.core import output
from ompi_tpu_torch.core.config import VarType, register_var, var_registry
from ompi_tpu_torch.core.mca import Component, Framework

__all__ = ["Severity", "notifier_framework", "notify"]

_log = output.get_stream("notifier")

notifier_framework = Framework("notifier", "admin event alerts")

register_var("notifier", "severity", VarType.STRING, "warn",
             "minimum severity forwarded: debug|info|warn|error|critical")


class Severity(enum.IntEnum):
    DEBUG = 0
    INFO = 1
    WARN = 2
    ERROR = 3
    CRITICAL = 4


@notifier_framework.component
class LogNotifier(Component):
    """Default sink: the framework's own output streams."""

    NAME = "log"
    PRIORITY = 10

    def notify(self, severity: Severity, event: str, detail: str) -> None:
        # the severity threshold already filtered — everything arriving
        # here must be VISIBLE (a verbosity gate on top would hide the
        # 'admin must see this' events the framework exists for)
        if severity >= Severity.ERROR:
            _log.error("[%s] %s: %s", severity.name, event, detail)
        else:
            _log.emit("[%s] %s: %s", severity.name, event, detail)


@notifier_framework.component
class SyslogNotifier(Component):
    """≈ notifier/syslog: forward to the system log."""

    NAME = "syslog"
    PRIORITY = 0    # opt-in via --mca notifier syslog

    _PRIO = None

    def query(self, **ctx) -> Optional[int]:
        try:
            import syslog  # noqa: F401
        except ImportError:  # non-POSIX
            return None
        return self.PRIORITY

    def notify(self, severity: Severity, event: str, detail: str) -> None:
        import syslog

        prio = {Severity.DEBUG: syslog.LOG_DEBUG,
                Severity.INFO: syslog.LOG_INFO,
                Severity.WARN: syslog.LOG_WARNING,
                Severity.ERROR: syslog.LOG_ERR,
                Severity.CRITICAL: syslog.LOG_CRIT}[severity]
        syslog.openlog("ompi_tpu")
        try:
            syslog.syslog(prio, f"{event}: {detail}")
        finally:
            syslog.closelog()


def _threshold() -> Severity:
    name = (var_registry.get("notifier_severity") or "warn").upper()
    try:
        return Severity[name]
    except KeyError:
        return Severity.WARN


def notify(severity: Severity, event: str, detail: str = "") -> None:
    """Emit one admin event through the selected notifier component."""
    if severity < _threshold():
        return
    comp = notifier_framework.select()
    comp.notify(severity, event, detail)
