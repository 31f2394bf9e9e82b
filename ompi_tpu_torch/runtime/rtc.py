"""RTC — runtime control: apply CPU binding to launched ranks (the port's
copy of the JAX package's ``runtime/rtc.py``, whole; the local launcher
and the orted both bind each child right after it starts).

≈ orte/mca/rtc/hwloc: the reference's rtc framework applies the binding
rmaps computed (cpuset per rank) at fork time.  Here the policy is
``--mca rtc_bind core|none`` (default none — oversubscribed test rigs and
single-core hosts must not serialize on one cpu): with ``core``, rank r
on a host is pinned to allowed-cpu ``local_rank mod n_allowed`` via
``sched_setaffinity`` in the child before exec, exactly the
one-core-per-rank default ``mpirun --bind-to core`` applies.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

from ompi_tpu_torch.core import output
from ompi_tpu_torch.core.config import VarType, register_var, var_registry

__all__ = ["bind_child"]

_log = output.get_stream("rtc")

register_var("rtc", "bind", VarType.STRING, "none",
             "cpu binding applied to launched ranks: none | core "
             "(rank pinned to one allowed cpu, round-robin)",
             enumerator=("none", "core"))


def bind_child(pid: int, local_rank: int) -> Optional[int]:
    """Pin a freshly-spawned child to one allowed cpu; returns the cpu or
    None when binding is off/unsupported/pointless.

    Applied from the PARENT right after Popen (affinity survives exec) —
    NOT via preexec_fn, which is fork-unsafe in the multithreaded
    launcher/orted (inherited locks can deadlock the child) and disables
    the posix_spawn fast path.  Same effect as the reference's rtc/hwloc
    binding applied in the odls fork window."""
    if var_registry.get("rtc_bind") != "core":
        return None
    if not hasattr(os, "sched_setaffinity"):
        return None
    try:
        allowed = sorted(os.sched_getaffinity(0))
    except OSError:
        return None
    if len(allowed) < 2:
        # one schedulable cpu: pinning is a no-op that only removes the
        # scheduler's freedom — skip, like the reference's overload check
        return None
    cpu = allowed[local_rank % len(allowed)]
    try:
        os.sched_setaffinity(pid, {cpu})
    except OSError as e:
        _log.verbose(1, "rtc: binding pid %d failed: %r", pid, e)
        return None
    _log.verbose(1, "rtc: local rank %d (pid %d) → cpu %d",
                 local_rank, pid, cpu)
    return cpu
