"""MPI-layer constants of the port (the port's copy of the JAX package's
``mpi/constants.py``, whole: the same values, the same error strings and
the same dynamic error classes and codes)."""

from __future__ import annotations

__all__ = ["MPIException", "ANY_SOURCE", "ANY_TAG", "PROC_NULL",
           "UNDEFINED", "SUCCESS", "ERR_BUFFER", "ERR_COUNT", "ERR_TYPE",
           "ERR_TAG", "ERR_RANK", "ERR_TRUNCATE", "ERR_INTERN", "ERR_IO",
           "ERR_PROC_FAILED", "ERR_PROC_FAILED_PENDING", "ERR_REVOKED",
           "COMM_TYPE_SHARED", "error_string", "ROOT", "IN_PLACE",
           "ERR_COMM", "ERR_OTHER", "ERR_PENDING", "ERR_IN_STATUS",
           "ERR_NAME", "ERR_SERVICE", "ERR_PORT", "LASTUSEDCODE",
           "add_error_class", "add_error_code", "add_error_string",
           "error_class"]

ANY_SOURCE = -1  # MPI_ANY_SOURCE: match a message from any rank
ANY_TAG = -2     # MPI_ANY_TAG: match any tag
PROC_NULL = -3   # MPI_PROC_NULL: send/recv to nowhere completes immediately
ROOT = -4        # MPI_ROOT (intercomm collectives)
UNDEFINED = -32766  # MPI_UNDEFINED (e.g. the rank of a process not in a group)
COMM_TYPE_SHARED = 1   # ranks that share a memory domain (same host)


class _InPlace:
    """Singleton marker for MPI_IN_PLACE."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:
        return "IN_PLACE"


IN_PLACE = _InPlace()

# Error classes (subset of MPI_ERR_*)
SUCCESS = 0
ERR_BUFFER = 1
ERR_COUNT = 2
ERR_TYPE = 3
ERR_TAG = 4
ERR_COMM = 5
ERR_RANK = 6
ERR_INTERN = 13
ERR_TRUNCATE = 15
ERR_OTHER = 16
ERR_PENDING = 18
ERR_IN_STATUS = 19
ERR_PORT = 27     # MPI_ERR_PORT: invalid/unknown port name
ERR_NAME = 33     # MPI_ERR_NAME: service name not published
ERR_IO = 38
ERR_SERVICE = 41  # MPI_ERR_SERVICE: publish/unpublish failure

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
    ERR_COMM: "invalid communicator",
    ERR_RANK: "invalid rank",
    ERR_TRUNCATE: "message truncated on receive",
    ERR_OTHER: "known error not in this list",
    ERR_INTERN: "internal error",
    ERR_PENDING: "pending request",
    ERR_IN_STATUS: "error code in status",
    ERR_NAME: "service name not published",
    ERR_SERVICE: "name service operation failed",
    ERR_PORT: "invalid port name",
    ERR_IO: "I/O error",
    ERR_PROC_FAILED: "peer process has failed",
    ERR_PROC_FAILED_PENDING: "operation pending on a failed process",
    ERR_REVOKED: "communicator has been revoked",
}


# Dynamic error classes/codes (≈ ompi/errhandler/errcode.c's user space):
# user classes/codes are allocated above LASTCODE so they never collide
# with the predefined table.
LASTUSEDCODE = 100  # ≈ MPI_LASTUSEDCODE attribute's initial value
_user_next = [LASTUSEDCODE + 1]
_user_class_of: dict[int, int] = {}   # code → its error class


def add_error_class() -> int:
    """≈ MPI_Add_error_class: allocate a fresh user error class."""
    cls = _user_next[0]
    _user_next[0] += 1
    _user_class_of[cls] = cls
    return cls


def add_error_code(error_class: int) -> int:
    """≈ MPI_Add_error_code: allocate a fresh code in ``error_class``
    (predefined or user-added)."""
    code = _user_next[0]
    _user_next[0] += 1
    _user_class_of[code] = int(error_class)
    return code


def add_error_string(code: int, text: str) -> None:
    """≈ MPI_Add_error_string for a user-added class/code."""
    if int(code) not in _user_class_of:
        raise MPIException(
            f"add_error_string: {code} was not user-added", error_class=3)
    _ERROR_STRINGS[int(code)] = str(text)


def error_class(code: int) -> int:
    """≈ MPI_Error_class: the class a (possibly user-added) code maps to;
    predefined codes are their own class here."""
    return _user_class_of.get(int(code), int(code))


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
