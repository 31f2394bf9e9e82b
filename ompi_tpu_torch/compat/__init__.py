"""Compatibility facades for users switching from the reference stack
(the port's copy of the JAX package's ``compat`` package).

``from ompi_tpu_torch.compat import MPI`` is a drop-in for mpi4py's
``from mpi4py import MPI`` — the de-facto Python binding of the reference
(Open MPI) — covering the Comm/Request/Status/Op/Group/Message surface an
mpi4py script actually touches.  See :mod:`ompi_tpu_torch.compat.MPI`.
"""

from ompi_tpu_torch.compat import MPI

__all__ = ["MPI"]
