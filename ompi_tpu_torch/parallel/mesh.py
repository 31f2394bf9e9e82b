"""Mesh construction for the port.

The JAX package addresses chips as a ``jax.sharding.Mesh`` whose axes
carry parallelism roles (dp/sp/tp/...).  The port's :class:`Mesh` keeps
that surface (``.shape`` axis → size, ``.axis_names``) and adds the
``torch.device`` its tensors live on.  This slice runs one process on one
device, so every axis has size 1; the multi-process NCCL mesh comes with
the multi-rank slices (ROADMAP.md, port slices 2-3).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

__all__ = ["Mesh", "make_mesh", "mesh_shape_for", "resolve_device"]


def resolve_device(device) -> torch.device:
    """The explicit ``torch.device`` for an entry point; a CUDA device on
    a machine without CUDA raises (the port never drops quietly to the
    CPU — callers that want the CPU say ``device="cpu"``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev


def mesh_shape_for(n_devices: int, axis_names: Sequence[str]) -> dict[str, int]:
    """Factor n_devices over the axes, largest factors innermost (the last
    axis gets the largest factor → tensor-parallel on the fastest links).

    Outer axes take the largest divisor ≤ the remaining geometric mean
    (rounded down), so the leftover — always ≥ the mean — lands innermost.
    """
    names = list(axis_names)
    shape = {name: 1 for name in names}
    remaining = n_devices
    for i, name in enumerate(names[:-1]):
        axes_left = len(names) - i
        target = int(math.floor(remaining ** (1 / axes_left)))
        f = 1
        for cand in range(max(1, target), 0, -1):
            if remaining % cand == 0:
                f = cand
                break
        shape[name] = f
        remaining //= f
    shape[names[-1]] = remaining
    return shape


class Mesh:
    """Named axes over the devices of this process (one, in this slice)."""

    def __init__(self, shape: dict[str, int], device="cuda") -> None:
        self.shape = {str(a): int(s) for a, s in shape.items()}
        self.axis_names = tuple(self.shape)
        total = math.prod(self.shape.values())
        if total != 1:
            raise NotImplementedError(
                f"mesh {self.shape} spans {total} devices; the port's "
                "multi-process NCCL mesh comes with the multi-rank device "
                "plane and training slice (ROADMAP.md, port slices 2-3)")
        self.device = resolve_device(device)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={str(self.device)!r})"


def make_mesh(axes: Optional[dict[str, int] | Sequence[str]] = None,
              device="cuda") -> Mesh:
    """Build a Mesh over this process's device.

    - ``make_mesh()`` → 1-D mesh ("world").
    - ``make_mesh({"dp": 1, "tp": 1})`` → explicit shape (a -1 entry is
      inferred).
    - ``make_mesh(["dp", "tp"])`` → auto-factored shape.
    """
    n = 1
    if axes is None:
        return Mesh({"world": n}, device=device)
    if not isinstance(axes, dict):
        axes = mesh_shape_for(n, list(axes))
    sizes = dict(axes)
    unknown = [a for a, s in sizes.items() if s == -1]
    if len(unknown) == 1:
        known = math.prod(s for s in sizes.values() if s != -1)
        sizes[unknown[0]] = max(1, n // known)
    return Mesh(sizes, device=device)
