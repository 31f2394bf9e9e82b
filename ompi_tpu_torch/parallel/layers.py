"""Tensor-parallel building blocks (Megatron-style column/row sharding).

A column-parallel matmul keeps its activation sharded over ``tp`` (no
communication); the row-parallel matmul contracts the sharded dimension
and finishes with one sum over ``tp``.  At tp == 1 that sum is the
identity and is elided, as in the JAX package.

Gradients: the row-parallel sum is an all-reduce forward and the
identity backward, and the replicated activation that enters the
column-parallel matmuls goes through :func:`tp_input`, the identity
forward and a tp all-reduce backward (``parallel.collectives``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ompi_tpu_torch.parallel.collectives import sum_backward, sum_forward

__all__ = ["column_parallel", "row_parallel", "tp_input"]


def tp_input(x: torch.Tensor, comm, axis: Optional[str] = None
             ) -> torch.Tensor:
    """x: (..., D) replicated over tp, about to enter column-parallel
    matmuls.  The identity; its backward sums the partial input
    gradients of those matmuls over tp (once, however many consume x)."""
    return sum_backward(comm, x, (axis or comm.axes[-1],))


def column_parallel(x: torch.Tensor, w_shard: torch.Tensor) -> torch.Tensor:
    """x: (..., D) replicated over tp; w_shard: (D, F/tp) local shard.
    Returns (..., F/tp) — output stays tp-sharded, no communication."""
    return torch.matmul(x, w_shard)


def row_parallel(x_shard: torch.Tensor, w_shard: torch.Tensor, comm,
                 axis: Optional[str] = None) -> torch.Tensor:
    """x_shard: (..., F/tp); w_shard: (F/tp, D).  Contracts the sharded
    dimension and sums the partial products over tp → replicated
    (..., D)."""
    partial = torch.matmul(x_shard, w_shard)
    return sum_forward(comm, partial, (axis or comm.axes[-1],))
