"""MPI-layer constants of the port (a trimmed copy of the JAX package's
``mpi/constants.py``: only what the device plane raises)."""

from __future__ import annotations

__all__ = ["MPIException"]


class MPIException(RuntimeError):
    """Raised by MPI-layer operations (≈ error handler MPI_ERRORS_RETURN
    path)."""

    def __init__(self, msg: str, error_class: int = 13) -> None:
        super().__init__(msg)
        self.error_class = error_class
