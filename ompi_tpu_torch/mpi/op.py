"""Reduction operations: the op table + user-defined ops (the port's copy
of the JAX package's ``mpi/op.py``).

Each Op carries a host implementation (numpy) and a device
implementation (torch) so the same Op object works in host code and in
the device collectives of ``DeviceCommunicator``.  In place of the JAX
package's ``jax_reduce_name``, ``dist_op`` names the native
``torch.distributed.ReduceOp`` of SUM, MAX and MIN (the three the JAX
package lowers to psum/pmax/pmin); every other op goes through the
communicator's rank-ordered fold.  The predefined ops name their torch
function and ``ReduceOp`` member, resolved at their first device use, so
a host-only rank does not import torch.

MAXLOC/MINLOC operate on the (val, loc) pair types, as in MPI, on the
host only.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np

from ompi_tpu_torch.mpi.constants import MPIException

__all__ = ["Op", "SUM", "PROD", "MAX", "MIN", "LAND", "LOR", "LXOR",
           "BAND", "BOR", "BXOR", "MAXLOC", "MINLOC", "REPLACE", "NO_OP",
           "create_op", "reduce_local", "op_commutative"]


class Op:
    """A reduction operator with host and device callables.

    ``host(a, b)`` reduces two numpy arrays elementwise; ``device(a, b)``
    does the same for torch tensors (``device`` is a callable or the name
    of a ``torch`` function).  ``commutative`` gates algorithm choice, as
    in the reference.
    """

    def __init__(self, name: str, host: Callable,
                 device: Optional[Callable | str],
                 commutative: bool = True,
                 dist_op: Optional[str] = None) -> None:
        self.name = name
        self.host = host
        self._device = device
        self.commutative = commutative
        self._dist_op = dist_op

    @property
    def dist_op(self):
        """The native ``torch.distributed.ReduceOp``, where one matches."""
        if self._dist_op is None:
            return None
        import torch.distributed as dist

        return getattr(dist.ReduceOp, self._dist_op)

    def device(self, a: Any, b: Any) -> Any:
        fn = self._device
        if fn is None:
            raise MPIException(
                f"op {self.name} has no device implementation; reduce on host")
        if isinstance(fn, str):
            import torch

            fn = getattr(torch, fn)
        return fn(a, b)

    def __call__(self, a, b):
        return self.host(a, b)

    def __repr__(self) -> str:
        return f"Op({self.name})"


def _pair_extreme(cmp):
    """MAXLOC/MINLOC on structured (val, loc) arrays: pick extreme value,
    lowest loc on ties (the MPI rule)."""

    def host(a: np.ndarray, b: np.ndarray) -> np.ndarray:
        take_b = cmp(b["val"], a["val"]) | (
            (b["val"] == a["val"]) & (b["loc"] < a["loc"]))
        return np.where(take_b, b, a)

    return host


SUM = Op("sum", np.add, "add", dist_op="SUM")
PROD = Op("prod", np.multiply, "mul")
MAX = Op("max", np.maximum, "maximum", dist_op="MAX")
MIN = Op("min", np.minimum, "minimum", dist_op="MIN")
LAND = Op("land", np.logical_and, "logical_and")
LOR = Op("lor", np.logical_or, "logical_or")
LXOR = Op("lxor", np.logical_xor, "logical_xor")
BAND = Op("band", np.bitwise_and, "bitwise_and")
BOR = Op("bor", np.bitwise_or, "bitwise_or")
BXOR = Op("bxor", np.bitwise_xor, "bitwise_xor")
MAXLOC = Op("maxloc", _pair_extreme(np.greater), None)
MINLOC = Op("minloc", _pair_extreme(np.less), None)
REPLACE = Op("replace", lambda a, b: b, lambda a, b: b, commutative=False)
NO_OP = Op("no_op", lambda a, b: a, lambda a, b: a, commutative=False)


def create_op(fn: Callable, commutative: bool = False,
              device_fn: Optional[Callable] = None, name: str = "user") -> Op:
    """MPI_Op_create: user-defined reduction (host fn mandatory; pass
    device_fn — a function of two torch tensors — to use it in device
    collectives)."""
    return Op(name, fn, device_fn, commutative=commutative)


def reduce_local(inbuf: Any, inoutbuf: np.ndarray, op: Op) -> np.ndarray:
    """≈ MPI_Reduce_local: inoutbuf = op(inbuf, inoutbuf), in place, no
    communication.  MPI argument order: inbuf is the FIRST operand
    (matters for non-commutative ops)."""
    a = np.asarray(inbuf)
    if a.shape != inoutbuf.shape:
        raise MPIException(
            f"reduce_local: shape mismatch {a.shape} vs {inoutbuf.shape}",
            error_class=2)
    inoutbuf[...] = op.host(a, inoutbuf)
    return inoutbuf


def op_commutative(op: Op) -> bool:
    """≈ MPI_Op_commutative."""
    return bool(op.commutative)
