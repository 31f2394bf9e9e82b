"""Error handlers (the port's copy of the JAX package's
``mpi/errhandler.py``).

≈ ompi/errhandler (ompi_errhandler_t) — the three MPI behaviors:

- ERRORS_ARE_FATAL: abort the job (here: raise SystemExit after printing,
  matching mpirun killing the job)
- ERRORS_RETURN: surface the error to the caller (pythonically: the
  MPIException propagates)
- user handlers: ``fn(holder, exc)`` called first; the exception still
  propagates afterwards unless the handler raises something else or
  swallows by returning True
"""

from __future__ import annotations

import sys
from typing import Any, Callable, Optional

from ompi_tpu_torch.mpi.constants import MPIException

__all__ = ["Errhandler", "ERRORS_ARE_FATAL", "ERRORS_RETURN",
           "create_errhandler"]


class Errhandler:
    def __init__(self, fn: Optional[Callable[[Any, MPIException], Any]],
                 name: str = "user") -> None:
        self.fn = fn
        self.name = name

    def invoke(self, holder: Any, exc: MPIException) -> None:
        """Run the policy; returns normally only if the error is handled
        (swallowed) — otherwise raises."""
        if self is ERRORS_ARE_FATAL:
            print(f"*** {getattr(holder, 'name', holder)}: "
                  f"MPI error, aborting: {exc}", file=sys.stderr)
            raise SystemExit(1) from exc
        if self.fn is not None:
            if self.fn(holder, exc) is True:
                return
        raise exc

    def __repr__(self) -> str:
        return f"Errhandler({self.name})"


ERRORS_ARE_FATAL = Errhandler(None, "errors_are_fatal")
ERRORS_RETURN = Errhandler(None, "errors_return")


def create_errhandler(fn: Callable[[Any, MPIException], Any]) -> Errhandler:
    """≈ MPI_Comm_create_errhandler."""
    return Errhandler(fn)
