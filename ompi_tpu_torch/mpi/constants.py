"""MPI-layer constants of the port (a trimmed copy of the JAX package's
``mpi/constants.py``: only what the device plane, the communicator, the
PML and the host collectives read; the dynamic error classes and the
fault-tolerance classes wait for their modules)."""

from __future__ import annotations

__all__ = ["MPIException", "ANY_SOURCE", "ANY_TAG", "PROC_NULL",
           "UNDEFINED", "SUCCESS", "ERR_BUFFER", "ERR_COUNT", "ERR_TYPE",
           "ERR_TAG", "ERR_RANK", "ERR_TRUNCATE", "ERR_INTERN", "ERR_IO",
           "ERR_PROC_FAILED", "COMM_TYPE_SHARED"]

ANY_SOURCE = -1  # MPI_ANY_SOURCE: match a message from any rank
ANY_TAG = -2     # MPI_ANY_TAG: match any tag
PROC_NULL = -3   # MPI_PROC_NULL: send/recv to nowhere completes immediately
UNDEFINED = -32766  # MPI_UNDEFINED (e.g. the rank of a process not in a group)
COMM_TYPE_SHARED = 1   # ranks that share a memory domain (same host)

# Error classes (subset of MPI_ERR_*)
SUCCESS = 0
ERR_BUFFER = 1
ERR_COUNT = 2
ERR_TYPE = 3
ERR_TAG = 4
ERR_RANK = 6
ERR_INTERN = 13
ERR_TRUNCATE = 15
ERR_IO = 38
ERR_PROC_FAILED = 75   # ULFM: target/peer process is dead


class MPIException(RuntimeError):
    """Raised by MPI-layer operations (≈ error handler MPI_ERRORS_RETURN
    path)."""

    def __init__(self, msg: str, error_class: int = 13) -> None:
        super().__init__(msg)
        self.error_class = error_class
