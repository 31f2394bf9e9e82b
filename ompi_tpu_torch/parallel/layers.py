"""Tensor-parallel building blocks (Megatron-style column/row sharding).

A column-parallel matmul keeps its activation sharded over ``tp`` (no
communication); the row-parallel matmul contracts the sharded dimension
and would finish with one sum over ``tp``.  At tp == 1 that sum is the
identity and is elided, as in the JAX package; tp > 1 comes with the
multi-rank training slice (ROADMAP.md queue 1 item 3).
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["column_parallel", "row_parallel"]


def column_parallel(x: torch.Tensor, w_shard: torch.Tensor) -> torch.Tensor:
    """x: (..., D) replicated over tp; w_shard: (D, F/tp) local shard.
    Returns (..., F/tp) — output stays tp-sharded, no communication."""
    return torch.matmul(x, w_shard)


def row_parallel(x_shard: torch.Tensor, w_shard: torch.Tensor, comm,
                 axis: Optional[str] = None) -> torch.Tensor:
    """x_shard: (..., F/tp); w_shard: (F/tp, D).  Contracts the sharded
    dimension; the sum over tp is the identity at tp == 1."""
    partial = torch.matmul(x_shard, w_shard)
    ax = axis or comm.axes[-1]
    if int(comm.mesh.shape[ax]) != 1:
        raise NotImplementedError(
            "row_parallel over tp > 1 comes with the multi-rank training "
            "slice (ROADMAP.md queue 1 item 3)")
    return partial
