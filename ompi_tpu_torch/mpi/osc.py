"""One-sided communication windows of the port: ``DeviceWindow``.

The port of the JAX package's ``mpi/osc.py`` ``DeviceWindow`` (≈
ompi/mca/osc/rdma: put → btl_put, get → btl_get).  The host plane's
windows (pt2pt emulation, shared windows) are not part of the port yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ompi_tpu_torch.mpi.constants import MPIException
from ompi_tpu_torch.mpi.device_comm import torch_dtype
from ompi_tpu_torch.ops import symmetric

__all__ = ["DeviceWindow"]


class DeviceWindow:
    """Device-resident RMA window: the osc/rdma strategy on the card.

    Collective allocation (≈ MPI_Win_allocate): every rank of ``dcomm``
    gets one ``local_shape`` part of a symmetric window, which its peers
    have mapped; ``put``/``get`` run the one-sided copy kernels of
    ``ops/remote_dma`` straight into and out of the peer's part, with no
    service thread and no active messages.  Every rank makes every call.

    Each process holds its own part (``array``), updated in place.  Per-op
    completion is implicit (each call drains its copy before returning on
    the ranks it touches); ``fence()`` is a device barrier.
    """

    def __init__(self, dcomm, local_shape, dtype=np.float32, fill=0):
        self.comm = dcomm
        self.local_shape = tuple(int(s) for s in local_shape)
        self.array = dcomm.window(self.local_shape, torch_dtype(dtype), fill)

    @property
    def dtype(self):
        return self.array.dtype

    def _origin_value(self, data) -> torch.Tensor:
        """Origin-local data as a tensor on the window's device (every
        rank passes data of the window's shape; only the origin's is
        read)."""
        value = torch.as_tensor(np.asarray(data) if not isinstance(
            data, torch.Tensor) else data).to(self.array.device,
                                              self.array.dtype)
        if tuple(value.shape) != self.local_shape:
            raise MPIException(
                f"DeviceWindow: data shape {tuple(value.shape)} must match "
                f"the window's local shape {self.local_shape}")
        return value.contiguous()

    def put(self, data, origin: int, target: int) -> None:
        """origin's ``data`` lands in target's part of the window (only the
        origin→target path moves bytes)."""
        self.array = self.comm.put(self.array, self._origin_value(data),
                                   int(origin), int(target))

    def get(self, origin: int, target: int):
        """origin fetches target's part one-sided.  Returns, as a numpy
        array, what this rank's call returns: target's part on origin, its
        own part on every other rank."""
        fetched = self.comm.get(self.array, int(target), int(origin))
        return fetched.cpu().numpy()

    def local(self, rank: int):
        """Host copy of this rank's current part (``rank`` must be the
        caller's: a process holds only its own part)."""
        me = self.comm.rank()
        if int(rank) != me:
            raise MPIException(
                f"DeviceWindow.local({rank}) on rank {me}: each process "
                "holds only its own part; gather the parts over the host "
                "group, or get() them one-sided")
        return self.array.cpu().numpy()

    def fence(self) -> None:
        """Active-target epoch boundary: a device barrier (the ops already
        completed per call; the fence orders epochs)."""
        self.comm.barrier()

    def free(self) -> None:
        """Collective: release the window on every rank."""
        if self.array is not None:
            symmetric.free(self.comm.mesh, self.array)
        self.array = None
