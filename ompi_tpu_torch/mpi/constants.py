"""MPI-layer constants of the port (a trimmed copy of the JAX package's
``mpi/constants.py``: only what the device plane and the communicator read)."""

from __future__ import annotations

__all__ = ["MPIException", "ANY_TAG", "UNDEFINED"]

ANY_TAG = -2     # MPI_ANY_TAG: match any tag
UNDEFINED = -32766  # MPI_UNDEFINED (e.g. the rank of a process not in a group)


class MPIException(RuntimeError):
    """Raised by MPI-layer operations (≈ error handler MPI_ERRORS_RETURN
    path)."""

    def __init__(self, msg: str, error_class: int = 13) -> None:
        super().__init__(msg)
        self.error_class = error_class
