"""MPI_T tool interface: control variables (cvars) + performance variables
(pvars) (the port's copy of the JAX package's ``mpi/mpit.py``, whole).

≈ ompi/mpi/tool + opal/mca/base/mca_base_pvar.c: the cvar side is a
read/write window onto the MCA variable registry (every ``register_var``
call is automatically an MPI_T cvar, exactly as in the reference); the
pvar side is a registry of typed performance variables with session-scoped
handles that can be bound to an object (a communicator, a monitor) the way
MPI_T handles bind to MPI objects.

Pvar classes mirror MPI_T_PVAR_CLASS_*: COUNTER (monotonic), LEVEL
(instantaneous utilization), SIZE, HIGHWATERMARK, LOWWATERMARK, TIMER,
STATE, AGGREGATE.
"""

from __future__ import annotations

import enum
import threading
import time
from typing import Any, Callable, Optional

from ompi_tpu_torch.core.config import var_registry
from ompi_tpu_torch.mpi.constants import MPIException

__all__ = [
    "PvarClass", "Pvar", "pvar_registry", "PvarRegistry", "PvarSession",
    "cvar_num", "cvar_names", "cvar_get_info", "cvar_read", "cvar_write",
]


# ---------------------------------------------------------------------------
# cvars — a thin MPI_T window onto the MCA var registry
# ---------------------------------------------------------------------------

def cvar_names() -> list[str]:
    """All control-variable names (≈ MPI_T_cvar_get_num + iteration)."""
    return [v.full_name for v in var_registry.all_vars()]


def cvar_num() -> int:
    return len(cvar_names())


def cvar_get_info(name: str) -> dict[str, Any]:
    """≈ MPI_T_cvar_get_info — type/default/description metadata."""
    var = var_registry.lookup(name)
    if var is None:
        raise MPIException(f"unknown cvar {name}")
    return {
        "name": name,
        "type": var.vtype.value if hasattr(var.vtype, "value")
        else str(var.vtype),
        "default": var.default,
        "description": var.description,
    }


def cvar_read(name: str) -> Any:
    """≈ MPI_T_cvar_read."""
    return var_registry.get(name)


def cvar_write(name: str, value: Any) -> None:
    """≈ MPI_T_cvar_write."""
    var_registry.set(name, value)


# ---------------------------------------------------------------------------
# pvars
# ---------------------------------------------------------------------------

class PvarClass(enum.Enum):
    COUNTER = "counter"            # monotonically increasing
    LEVEL = "level"                # instantaneous value
    SIZE = "size"                  # fixed resource size
    HIGHWATERMARK = "highwatermark"
    LOWWATERMARK = "lowwatermark"
    TIMER = "timer"                # accumulated seconds
    STATE = "state"                # discrete state id
    AGGREGATE = "aggregate"        # arbitrary aggregated value


class Pvar:
    """A performance variable (≈ mca_base_pvar_t).

    Two flavors:
    - *storage-backed*: holds its own value; mutate with inc()/set_value()/
      watermark(); the common case for framework-internal counters.
    - *read-function-backed*: ``read_fn(bound_obj)`` pulls the value from a
      live object at read time (how the monitoring component exports its
      matrices); such pvars usually require a bound object at handle
      allocation, mirroring MPI_T bindings.
    """

    def __init__(self, name: str, klass: PvarClass, unit: str = "",
                 description: str = "",
                 read_fn: Optional[Callable[[Any], Any]] = None,
                 requires_binding: bool = False) -> None:
        self.name = name
        self.klass = klass
        self.unit = unit
        self.description = description
        self.read_fn = read_fn
        self.requires_binding = requires_binding
        self._lock = threading.Lock()
        self._value: Any = 0
        self._wm_sampled = False  # watermark classes: any sample yet?

    # storage-backed mutation

    def inc(self, delta: Any = 1) -> None:
        with self._lock:
            self._value += delta

    def set_value(self, v: Any) -> None:
        with self._lock:
            self._value = v

    def watermark(self, v: Any) -> None:
        with self._lock:
            if self.klass not in (PvarClass.HIGHWATERMARK,
                                  PvarClass.LOWWATERMARK):
                raise MPIException(f"{self.name} is not a watermark pvar")
            if not self._wm_sampled:
                self._value = v
                self._wm_sampled = True
            elif self.klass is PvarClass.HIGHWATERMARK:
                self._value = max(self._value, v)
            else:
                self._value = min(self._value, v)

    def read(self, bound: Any = None) -> Any:
        if self.read_fn is not None:
            if bound is None and self.requires_binding:
                raise MPIException(
                    f"pvar {self.name} requires a bound object")
            return self.read_fn(bound)
        with self._lock:
            return self._value

    def __repr__(self) -> str:
        return f"Pvar({self.name}, {self.klass.value})"


class PvarRegistry:
    """Process-global pvar directory (≈ the mca_base_pvar registry)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._vars: dict[str, Pvar] = {}

    def register(self, pvar: Pvar) -> Pvar:
        with self._lock:
            if pvar.name in self._vars:
                raise MPIException(f"pvar {pvar.name} already registered")
            self._vars[pvar.name] = pvar
        return pvar

    def register_or_get(self, pvar: Pvar) -> Pvar:
        with self._lock:
            return self._vars.setdefault(pvar.name, pvar)

    def lookup(self, name: str) -> Pvar:
        try:
            return self._vars[name]
        except KeyError:
            raise MPIException(f"unknown pvar {name}") from None

    def names(self) -> list[str]:
        return sorted(self._vars)

    def unregister(self, name: str) -> None:
        with self._lock:
            self._vars.pop(name, None)


pvar_registry = PvarRegistry()


class _PvarHandle:
    """A session handle (≈ MPI_T_pvar_handle): start/stop/read/reset with
    a per-handle baseline so concurrent tools don't disturb each other."""

    def __init__(self, pvar: Pvar, bound: Any) -> None:
        self.pvar = pvar
        self.bound = bound
        self._started = False
        # counters read cumulative values until reset() sets a baseline
        # (MPI_T_pvar_reset semantics)
        self._base: Any = 0
        self._t0: Optional[float] = None
        self._acc = 0.0

    def start(self) -> None:
        self._started = True
        if self.pvar.klass is PvarClass.TIMER:
            self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self.pvar.klass is PvarClass.TIMER and self._t0 is not None:
            self._acc += time.perf_counter() - self._t0
            self._t0 = None
        self._started = False

    def read(self) -> Any:
        if self.pvar.klass is PvarClass.TIMER:
            live = (time.perf_counter() - self._t0
                    if self._started and self._t0 is not None else 0.0)
            return self._acc + live
        cur = self.pvar.read(self.bound)
        if self.pvar.klass is PvarClass.COUNTER:
            return cur - self._base
        return cur

    def reset(self) -> None:
        if self.pvar.klass is PvarClass.TIMER:
            self._acc = 0.0
            if self._started:
                self._t0 = time.perf_counter()
        elif self.pvar.klass is PvarClass.COUNTER:
            self._base = self.pvar.read(self.bound)


class PvarSession:
    """≈ MPI_T_pvar_session_create/free."""

    def __init__(self) -> None:
        self._handles: list[_PvarHandle] = []

    def handle_alloc(self, name: str, bound: Any = None) -> _PvarHandle:
        h = _PvarHandle(pvar_registry.lookup(name), bound)
        self._handles.append(h)
        return h

    def handle_free(self, handle: _PvarHandle) -> None:
        self._handles.remove(handle)

    def free(self) -> None:
        self._handles.clear()
