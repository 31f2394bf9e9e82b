"""MPI_Info objects and attribute keyvals (the port's copy of the JAX
package's ``mpi/info.py``).

≈ ompi/info (ompi_info_t: ordered string key-value store with MPI's
lookup/dup semantics) and ompi/attribute (attribute.c: keyvals carrying
copy/delete callbacks, invoked on communicator dup/free).
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Callable, Optional

from ompi_tpu_torch.mpi.constants import MPIException

__all__ = ["Info", "Keyval", "keyval_create", "keyval_free"]

MAX_KEY = 255
MAX_VALUE = 4096


class Info:
    """≈ MPI_Info: ordered, case-sensitive string→string map."""

    def __init__(self, items: Optional[dict[str, str]] = None) -> None:
        self._d: dict[str, str] = {}
        self._lock = threading.Lock()
        if items:
            for k, v in items.items():
                self.set(k, v)

    def set(self, key: str, value: str) -> None:
        if not key or len(key) > MAX_KEY:
            raise MPIException(f"bad info key {key!r}", error_class=3)
        if len(str(value)) > MAX_VALUE:
            raise MPIException("info value too long", error_class=3)
        with self._lock:
            self._d[key] = str(value)

    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        with self._lock:
            return self._d.get(key, default)

    def delete(self, key: str) -> None:
        with self._lock:
            if key not in self._d:
                raise MPIException(f"info key {key!r} not present",
                                   error_class=30)
            del self._d[key]

    @property
    def nkeys(self) -> int:
        with self._lock:
            return len(self._d)

    def nthkey(self, n: int) -> str:
        """≈ MPI_Info_get_nthkey — insertion order."""
        with self._lock:
            keys = list(self._d)
        if not 0 <= n < len(keys):
            raise MPIException(f"info has no key #{n}", error_class=3)
        return keys[n]

    def dup(self) -> "Info":
        with self._lock:
            return Info(dict(self._d))

    def items(self) -> list[tuple[str, str]]:
        with self._lock:
            return list(self._d.items())

    def __contains__(self, key: str) -> bool:
        return self.get(key) is not None

    def __repr__(self) -> str:
        return f"Info({self._d!r})"


# ---------------------------------------------------------------------------
# attribute keyvals (≈ MPI_Comm_create_keyval + attribute caching)
# ---------------------------------------------------------------------------

class Keyval:
    """An attribute key with copy/delete callbacks.

    ``copy_fn(comm, value) -> (keep: bool, new_value)`` runs when the
    holder is duplicated (MPI's COPY_FN; return keep=False to not
    propagate).  ``delete_fn(comm, value)`` runs when the attribute is
    deleted or the holder freed.
    """

    _ids = itertools.count(1)

    def __init__(self,
                 copy_fn: Optional[Callable] = None,
                 delete_fn: Optional[Callable] = None,
                 extra: Any = None) -> None:
        self.id = next(Keyval._ids)
        self.copy_fn = copy_fn
        self.delete_fn = delete_fn
        self.extra = extra
        self.freed = False

    def __hash__(self) -> int:
        return self.id

    def __repr__(self) -> str:
        return f"Keyval({self.id})"


def keyval_create(copy_fn: Optional[Callable] = None,
                  delete_fn: Optional[Callable] = None,
                  extra: Any = None) -> Keyval:
    """≈ MPI_Comm_create_keyval."""
    return Keyval(copy_fn, delete_fn, extra)


def keyval_free(kv: Keyval) -> None:
    """≈ MPI_Comm_free_keyval — marks it; cached attributes stay valid
    until deleted (MPI semantics)."""
    kv.freed = True
