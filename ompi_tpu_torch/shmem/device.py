"""Device-mode symmetric heap: OpenSHMEM on the card over the port's
device plane (the port of the JAX package's ``shmem/device.py``).

A symmetric allocation is one block per PE (rank), made collectively
(≈ shmem_malloc) as a symmetric window that every other PE has mapped
(``ops/symmetric.py``): "the address of x on PE p" is PE p's block of the
same window.  Each PE's process holds its own block.

    shmem_put/get (one-sided)      →  the remote-DMA kernels (ops/remote_dma)
    put_to/get_from/cshift         →  p2p exchange / broadcast (exchange-shaped)
    shmem_*_to_all reductions      →  all_reduce
    shmem_broadcast                →  broadcast
    shmem_collect/fcollect         →  all_gather
    shmem_alltoall                 →  all_to_all

Usage (on every PE)::

    heap = DeviceSymmetricHeap(device_world(mesh))
    x = heap.array((4,), torch.float32)        # this PE's (4,) block
    def step(c, x):
        y = heap.cshift(x, 1)                  # put to right neighbour
        return heap.to_all(y, op=MAX)          # max-reduction to all
    out = heap.run(step, x)
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np
import torch

from ompi_tpu_torch.mpi.device_comm import DeviceCommunicator, torch_dtype
from ompi_tpu_torch.mpi.op import MAX, Op
from ompi_tpu_torch.ops import symmetric

__all__ = ["DeviceSymmetricHeap"]


class DeviceSymmetricHeap:
    """A symmetric heap over a :class:`DeviceCommunicator`'s PEs."""

    def __init__(self, comm: DeviceCommunicator) -> None:
        self.comm = comm
        self._allocs = 0

    @property
    def n_pes(self) -> int:
        return self.comm.size

    # -- allocation (collective, ≈ shmem_malloc / shmem_free) -------------

    def array(self, local_shape: Sequence[int], dtype=np.float32, fill=0):
        """Collective: this PE's ``local_shape`` block of a new symmetric
        allocation, filled with ``fill``."""
        self._allocs += 1
        return self.comm.window(local_shape, torch_dtype(dtype), fill)

    def free(self, sym) -> None:
        """Collective: release a symmetric allocation on every PE."""
        symmetric.free(self.comm.mesh, sym)

    def run(self, fn: Callable, *blocks, out_specs: Any = None):
        """``fn(comm, *blocks)`` on this PE's blocks (the body the
        reference runs SPMD)."""
        return self.comm.run(fn, *blocks)

    # -- exchange-shaped ops ----------------------------------------------

    def cshift(self, x, displacement: int = 1):
        """Circular shift: my block lands at PE (me+displacement)."""
        return self.comm.shift(x, displacement)

    def put_to(self, x, pairs: Sequence[tuple[int, int]], fill=0):
        """Explicit-pair put: ``pairs`` is (src_pe, dst_pe); PEs not
        receiving get ``fill``."""
        out = self.comm.permute(x, pairs)
        if fill == 0 or self.comm.rank() in {int(d) for _, d in pairs}:
            return out
        return torch.full_like(out, fill)

    def get_from(self, x, src_pe: int):
        """Every PE reads PE ``src_pe``'s block (a broadcast from it)."""
        return self.comm.bcast(x, root=int(src_pe))

    # -- one-sided (remote DMA) --------------------------------------------

    def put(self, sym, value, src_pe: int, dst_pe: int):
        """PE ``src_pe`` writes ``value`` into PE ``dst_pe``'s block of
        ``sym``, in place; returns ``sym``.  All PEs call; only the
        src→dst path carries bytes."""
        return self.comm.put(sym, value, int(src_pe), int(dst_pe))

    def get(self, sym, src_pe: int, dst_pe: int):
        """PE ``dst_pe`` fetches PE ``src_pe``'s block of ``sym``; other
        PEs get their own block back."""
        return self.comm.get(sym, int(src_pe), int(dst_pe))

    def quiet(self, token=None):
        """shmem_quiet: puts complete inside their call (implicit per-op
        quiet), so this only keeps API parity."""
        return token

    # -- collectives --------------------------------------------------------

    def broadcast(self, x, root: int = 0):
        return self.comm.bcast(x, root=root)

    def collect(self, x, axis: int = 0):
        """fcollect: concatenation of every PE's block."""
        return self.comm.allgather(x, axis=axis)

    def to_all(self, x, op: Op = MAX):
        """shmem_*_to_all: elementwise reduction, result on every PE."""
        return self.comm.allreduce(x, op=op)

    def alltoall(self, x, split_axis: int = 0, concat_axis: int = 0):
        return self.comm.alltoall(x, split_axis, concat_axis)

    def barrier_all(self, token=None):
        return self.comm.barrier(token)

    def my_pe(self) -> int:
        """The calling PE's index."""
        return self.comm.rank()

    def __repr__(self) -> str:
        return (f"DeviceSymmetricHeap(pes={self.n_pes}, "
                f"axes={self.comm.axes}, allocs={self._allocs})")
