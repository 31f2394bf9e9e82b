"""DeviceCommunicator — the port's communicator over mesh axes.

This slice carries the shape API the model reads (``mesh``, ``axes``,
``size``, ``axis_sizes``, ``rank()``, ``coords()``, ``sub()``), following
the JAX package's ``DeviceCommunicator``.  A communicator is a set of
mesh axes; its rank is the row-major flat index over them.  The
collectives (over ``torch.distributed``: NCCL on the card, gloo on the
CPU) come with the multi-rank slices (ROADMAP.md, port slices 2-3);
until then a communicator that spans more than one device raises.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

__all__ = ["DeviceCommunicator"]

_LATER = ("device collectives over torch.distributed come with the "
          "multi-rank device plane and training slice (ROADMAP.md, port "
          "slices 2-3)")


class DeviceCommunicator:
    """A communicator over one or more mesh axes."""

    def __init__(self, mesh, axes: Optional[Sequence[str]] = None,
                 name: str = "device") -> None:
        self.mesh = mesh
        self.axes: tuple[str, ...] = tuple(axes if axes is not None
                                           else mesh.axis_names)
        for ax in self.axes:
            if ax not in mesh.axis_names:
                raise ValueError(f"axis {ax!r} not in mesh {mesh.axis_names}")
        self.name = name
        if self.size != 1:
            raise NotImplementedError(
                f"communicator {name!r} spans {self.size} devices: {_LATER}")

    @property
    def size(self) -> int:
        return math.prod(int(self.mesh.shape[a]) for a in self.axes)

    @property
    def axis_sizes(self) -> tuple[int, ...]:
        return tuple(int(self.mesh.shape[a]) for a in self.axes)

    def rank(self) -> int:
        """My flat rank over the axes (row-major); 0 on one device."""
        return 0

    def coords(self) -> tuple[int, ...]:
        """My coordinates along each axis (≈ MPI_Cart_coords)."""
        return tuple(0 for _ in self.axes)

    def sub(self, axes: Sequence[str], name: Optional[str] = None
            ) -> "DeviceCommunicator":
        """Sub-communicator over a subset of my axes (≈ MPI_Cart_sub)."""
        return DeviceCommunicator(self.mesh, axes,
                                  name or f"{self.name}.sub{tuple(axes)}")
