"""Differentiable exchanges: the collectives that training differentiates
through.

JAX differentiates ``ppermute``, ``psum``, ``all_to_all`` and
``all_gather`` itself; here each exchange of the training path is a
``torch.autograd.Function`` whose backward is written out:

- :func:`shift`: a ring shift; the backward shifts the cotangent back.
- :func:`permute`: a (src, dst) permutation along an axis (ranks that
  receive nothing get zeros); the backward sends each cotangent back
  along the inverse pairs (GPipe's stage-to-stage hop).
- :func:`sum_forward`: an all-reduce SUM forward, the identity backward.
  Every rank of the group then holds, and differentiates, the same
  replicated value, and passes its cotangent to its own partial (the
  row-parallel output over tp; the loss's numerator over dp × sp).
- :func:`sum_backward`: the identity forward, an all-reduce SUM backward
  (a replicated activation entering column-parallel matmuls, whose
  input gradients are partial over tp).  With :func:`sum_forward` it is
  Megatron's pair; differentiating an all-reduce as an all-reduce would
  scale every gradient upstream by the group's size.
- :func:`all_to_all`: the backward is the inverse all-to-all.
- :func:`all_gather`: the backward is a reduce-scatter with SUM.

Each takes a :class:`~ompi_tpu_torch.mpi.device_comm.DeviceCommunicator`
whose mesh holds the named axes, and returns ``x`` itself when the group
has one rank: a degenerate axis makes no call on the process group, as
the JAX package elides its degenerate collectives.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

__all__ = ["shift", "permute", "sum_forward", "sum_backward", "all_to_all",
           "all_gather", "group_size"]


def group_size(comm, axes: Sequence[str]) -> int:
    """Ranks in the group over ``axes`` (1 for an axis the mesh lacks)."""
    return math.prod(int(comm.mesh.shape.get(a, 1)) for a in axes)


def _over(comm, axes: Sequence[str]):
    return comm.sub(tuple(a for a in axes if a in comm.mesh.shape))


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, disp, axis):
        ctx.args = (comm, disp, axis)
        return comm.shift(x, disp, axis)

    @staticmethod
    def backward(ctx, g):
        comm, disp, axis = ctx.args
        return comm.shift(g, -disp, axis), None, None, None


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, perm, axis):
        ctx.args = (comm, [(d, s) for s, d in perm], axis)
        return comm.permute(x, perm, axis)

    @staticmethod
    def backward(ctx, g):
        comm, inverse, axis = ctx.args
        return comm.permute(g, inverse, axis), None, None, None


class _SumForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        return comm.allreduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.allreduce(g), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, split_dim, concat_dim):
        ctx.args = (comm, split_dim, concat_dim)
        return comm.alltoall(x, split_axis=split_dim, concat_axis=concat_dim)

    @staticmethod
    def backward(ctx, g):
        comm, split_dim, concat_dim = ctx.args
        return (comm.alltoall(g, split_axis=concat_dim,
                              concat_axis=split_dim), None, None, None)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim):
        ctx.args = (comm, dim)
        return comm.allgather(x, axis=dim)

    @staticmethod
    def backward(ctx, g):
        comm, dim = ctx.args
        return comm.reduce_scatter(g, axis=dim), None, None


def shift(comm, x: torch.Tensor, disp: int, axis: str) -> torch.Tensor:
    """Cyclic shift along ``axis``: rank i's ``x`` lands on rank
    (i + disp) mod n (``lax.ppermute`` over the ring)."""
    if group_size(comm, (axis,)) == 1:
        return x
    return _Shift.apply(x, comm, int(disp), axis)


def permute(comm, x: torch.Tensor, perm, axis: str) -> torch.Tensor:
    """``lax.ppermute`` along ``axis``: rank s's ``x`` lands on rank d for
    each (s, d) in ``perm``; a rank that receives nothing gets zeros."""
    if group_size(comm, (axis,)) == 1:
        return x
    return _Permute.apply(x, comm, [(int(s), int(d)) for s, d in perm],
                          axis)


def sum_forward(comm, x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """Σ of ``x`` over the group of ``axes``; the backward passes the
    cotangent through unchanged."""
    if group_size(comm, axes) == 1:
        return x
    return _SumForward.apply(x, _over(comm, axes))


def sum_backward(comm, x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """``x`` unchanged; the backward sums the cotangent over the group of
    ``axes``."""
    if group_size(comm, axes) == 1:
        return x
    return _SumBackward.apply(x, _over(comm, axes))


def all_to_all(comm, x: torch.Tensor, axis: str, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """Block j of ``x`` along ``split_dim`` goes to rank j of ``axis``;
    the blocks received are concatenated along ``concat_dim`` in rank
    order (``lax.all_to_all(..., tiled=True)``)."""
    if group_size(comm, (axis,)) == 1:
        return x
    return _AllToAll.apply(x, _over(comm, (axis,)), split_dim, concat_dim)


def all_gather(comm, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, concatenated along ``dim`` in rank
    order (``lax.all_gather(..., tiled=True)``)."""
    if group_size(comm, (axis,)) == 1:
        return x
    return _AllGather.apply(x, _over(comm, (axis,)), dim)
