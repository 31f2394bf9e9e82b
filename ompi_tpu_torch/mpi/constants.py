"""MPI-layer constants of the port (a trimmed copy of the JAX package's
``mpi/constants.py``: only what the device plane, the communicator, the
PML, the host collectives and the fault-tolerance plane read, with the
JAX package's error strings; the dynamic error classes wait for their
modules)."""

from __future__ import annotations

__all__ = ["MPIException", "ANY_SOURCE", "ANY_TAG", "PROC_NULL",
           "UNDEFINED", "SUCCESS", "ERR_BUFFER", "ERR_COUNT", "ERR_TYPE",
           "ERR_TAG", "ERR_RANK", "ERR_TRUNCATE", "ERR_INTERN", "ERR_IO",
           "ERR_PROC_FAILED", "ERR_PROC_FAILED_PENDING", "ERR_REVOKED",
           "COMM_TYPE_SHARED", "error_string"]

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

# ULFM fault-tolerance error classes (MPI_ERR_PROC_FAILED & friends —
# the user-level fault tolerance chapter's additions; numbered in the
# post-standard space the ULFM prototype uses)
ERR_PROC_FAILED = 75          # target/peer process is dead
ERR_PROC_FAILED_PENDING = 76  # wildcard recv cannot complete: peer died
ERR_REVOKED = 77              # the communicator was revoked

_ERROR_STRINGS = {
    SUCCESS: "no error",
    ERR_BUFFER: "invalid buffer",
    ERR_COUNT: "invalid count argument",
    ERR_TYPE: "invalid datatype argument",
    ERR_TAG: "invalid tag argument",
    ERR_RANK: "invalid rank",
    ERR_TRUNCATE: "message truncated on receive",
    ERR_INTERN: "internal error",
    ERR_IO: "I/O error",
    ERR_PROC_FAILED: "peer process has failed",
    ERR_PROC_FAILED_PENDING: "operation pending on a failed process",
    ERR_REVOKED: "communicator has been revoked",
}


def error_string(error_class: int) -> str:
    """≈ MPI_Error_string: human text for an error class (the values
    MPIException.error_class carries)."""
    return _ERROR_STRINGS.get(int(error_class),
                              f"unknown error class {error_class}")


class MPIException(RuntimeError):
    """Raised by MPI-layer operations (≈ error handler MPI_ERRORS_RETURN
    path)."""

    def __init__(self, msg: str, error_class: int = 13) -> None:
        super().__init__(msg)
        self.error_class = error_class
