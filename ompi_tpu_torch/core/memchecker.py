"""Memchecker — buffer-validity checking at messaging boundaries (the
port's copy of the JAX package's ``core/memchecker.py``, whole; the PML
refuses torch tensors, so every buffer it checks is a host array).

≈ opal/mca/memchecker/valgrind: the reference annotates buffers
defined/undefined at PML/convertor boundaries so valgrind can flag reads
of uninitialized message data.  CPython has no valgrind client hooks, so
the same discipline is realized directly, gated off by default
(``--mca memchecker enable 1``):

- **send side**: the outgoing buffer must be a readable array; with
  ``memchecker_nan_check`` on, float payloads are scanned for NaN — the
  closest observable analog of "sending undefined memory" (a poisoned
  recv buffer forwarded without ever being written).
- **recv side**: the destination must be writable (catching recvs into
  read-only views, which numpy would otherwise fail deep inside unpack);
  with ``memchecker_poison`` on, it is pre-filled with a NaN/0xCC pattern
  before delivery — exactly valgrind's "mark undefined": any rank that
  reads more than the matched message actually wrote sees poison, not
  stale plausible data.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ompi_tpu_torch.core import output
from ompi_tpu_torch.core.config import VarType, register_var, var_registry

__all__ = ["enabled", "check_send", "prepare_recv", "MemcheckError"]

_log = output.get_stream("memchecker")

register_var("memchecker", "enable", VarType.BOOL, False,
             "validate buffers at PML boundaries (≈ memchecker/valgrind)")
register_var("memchecker", "nan_check", VarType.BOOL, True,
             "with memchecker on: reject float send payloads containing "
             "NaN (the 'sending undefined memory' signal)")
register_var("memchecker", "poison", VarType.BOOL, True,
             "with memchecker on: pre-fill recv buffers with a poison "
             "pattern so reads beyond the received data are detectable")


class MemcheckError(ValueError):
    """A buffer failed a memchecker validation."""


def enabled() -> bool:
    return bool(var_registry.get("memchecker_enable"))


def check_send(buf, where: str = "send") -> None:
    """Validate an outgoing payload (call only when :func:`enabled`)."""
    arr = np.asarray(buf)
    if arr.dtype == object:
        raise MemcheckError(f"{where}: object-dtype buffer is not a "
                            f"wire-safe payload")
    if (var_registry.get("memchecker_nan_check")
            and np.issubdtype(arr.dtype, np.floating) and arr.size):
        # NaN in an outgoing buffer usually means a poisoned/uninitialized
        # region is being forwarded — the memchecker's raison d'être
        if bool(np.isnan(arr).any()):
            raise MemcheckError(
                f"{where}: payload contains NaN "
                f"(uninitialized/poisoned data on the wire; disable with "
                f"--mca memchecker_nan_check 0 if NaN is legitimate)")


def prepare_recv(buf: Optional[np.ndarray],
                 where: str = "recv") -> None:
    """Validate (and optionally poison) a recv destination in place."""
    if buf is None:
        return
    if not isinstance(buf, np.ndarray):
        raise MemcheckError(f"{where}: destination must be a numpy array")
    if not buf.flags.writeable:
        raise MemcheckError(f"{where}: destination buffer is read-only")
    if var_registry.get("memchecker_poison") and buf.size:
        # mark undefined: NaN for floats, 0xCC bytes otherwise
        if np.issubdtype(buf.dtype, np.floating):
            buf.fill(np.nan)
        elif buf.dtype != object:
            buf.view(np.uint8).fill(0xCC)
