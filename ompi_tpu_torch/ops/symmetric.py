"""Symmetric windows: one buffer per rank that every other rank has mapped.

The JAX package needs no such thing: its one-sided kernels address a peer
chip's shard by logical device index (``ompi_tpu/ops/remote_dma.py:74-77``,
``DeviceIdType.LOGICAL``) and the window is "the registered remote
segment" (``:95-96``).  On CUDA a rank is a process, so the segment is
registered by hand, collectively over the mesh's host group (≈
``MPI_Win_allocate``, ``shmem_malloc``):

- each rank makes one ``cudaMalloc`` in the kernel library (not PyTorch's
  caching allocator, so the handle's offset is 0 and a peer's mapping
  stays valid until the collective free), holding the data and, after it,
  256-byte aligned int64 flag words ``ready[n]``, ``done[n]``, ``status``
  and an arrival counter (``csrc/remote_dma.cu`` says what each means);
- each rank exports a ``cudaIpcMemHandle_t``; the handles are exchanged
  with ``all_gather_object`` on the host group and each peer's is opened
  with ``cudaIpcMemLazyEnablePeerAccess``;
- the local part reaches PyTorch through ``__cuda_array_interface__``;
- freeing is collective: barrier, every rank closes its peers' handles,
  barrier, then ``cudaFree``.

On the CPU a window is a plain tensor: the plain one-sided ops move it
over gloo.  The mesh keeps the windows of its ranks (``Mesh.windows``, by
data pointer), so a one-sided op finds the mapping from the tensor alone;
a CUDA tensor that is not such a window is refused there.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Sequence

import torch

from ompi_tpu_torch.mpi.constants import MPIException

__all__ = ["SymmetricWindow", "allocate", "free", "lookup"]

_ALIGN = 256
_vp = ctypes.c_void_p


@functools.cache
def _lib():
    from ompi_tpu_torch.ops import _build

    lib = _build.load("remote_dma.cu")
    lib.ompi_win_alloc.argtypes = [ctypes.c_int, ctypes.c_ulonglong,
                                   ctypes.POINTER(_vp), ctypes.c_char_p]
    lib.ompi_win_open.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                  ctypes.POINTER(_vp)]
    lib.ompi_win_close.argtypes = [ctypes.c_int, _vp]
    lib.ompi_win_free.argtypes = [ctypes.c_int, _vp]
    for fn in (lib.ompi_win_alloc, lib.ompi_win_open, lib.ompi_win_close,
               lib.ompi_win_free, lib.ompi_rma_handle_bytes):
        fn.restype = ctypes.c_int
    return lib


class _DeviceMemory:
    """A raw device range seen through ``__cuda_array_interface__``."""

    def __init__(self, ptr: int, nbytes: int) -> None:
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False),
            "version": 3, "strides": None}


def _bytes_at(ptr: int, nbytes: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_DeviceMemory(ptr, nbytes), device=device)


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"symmetric window: {what} failed with CUDA "
                           f"error {err}")


class SymmetricWindow:
    """This rank's part of a window over every rank of ``mesh``, with the
    mapped views of its peers' parts (allocate with :func:`allocate`)."""

    def __init__(self, mesh, local_shape: Sequence[int],
                 dtype: torch.dtype, fill=0) -> None:
        self.mesh = mesh
        n, me = mesh.world_size, mesh.rank
        dev = mesh.device
        self.device_index = dev.index if dev.index is not None else 0
        shape = tuple(int(s) for s in local_shape)
        itemsize = torch.empty((), dtype=dtype).element_size()
        self.nbytes = math.prod(shape) * itemsize
        self.flag_offset = -(-self.nbytes // _ALIGN) * _ALIGN
        n_words = 2 * n + 2
        total = self.flag_offset + 8 * n_words
        lib = _lib()
        ptr = _vp()
        handle = ctypes.create_string_buffer(lib.ompi_rma_handle_bytes())
        err = lib.ompi_win_alloc(self.device_index, total, ctypes.byref(ptr),
                                 handle)
        # every rank learns every rank's outcome before anyone raises, so a
        # failure on one rank cannot leave the others blocked
        got = mesh.all_gather_object((err, handle.raw))
        bad = [(r, e) for r, (e, _) in enumerate(got) if e != 0]
        if bad:
            if err == 0:
                lib.ompi_win_free(self.device_index, ptr)
            raise RuntimeError(f"symmetric window: cudaMalloc/IPC export "
                               f"failed on (rank, CUDA error) {bad}")
        self.ptr = ptr.value
        self._lib = lib
        self._opened: list[int] = []
        ptrs = []
        for r, (_, h) in enumerate(got):
            if r == me:
                ptrs.append(self.ptr)
                continue
            peer = _vp()
            _raise_on(lib.ompi_win_open(self.device_index, h,
                                        ctypes.byref(peer)),
                      f"cudaIpcOpenMemHandle of rank {r}'s window")
            self._opened.append(peer.value)
            ptrs.append(peer.value)
        #: every rank's data, as addresses in this process and as tensors
        self.ptrs = ptrs
        self.data = [_bytes_at(p, self.nbytes, dev).view(dtype).view(shape)
                     for p in ptrs]
        self.flags = [_bytes_at(p + self.flag_offset, 8 * n_words, dev)
                      .view(torch.int64) for p in ptrs]
        # the flag words' addresses, fixed here so a put or get makes no
        # tensor view: ready_ptrs[r][p] is ready[p] in rank r's window
        flag_ptrs = [p + self.flag_offset for p in ptrs]
        self.ready_ptrs = [[f + 8 * p for p in range(n)] for f in flag_ptrs]
        self.done_ptrs = [[f + 8 * (n + p) for p in range(n)]
                          for f in flag_ptrs]
        self.status_ptr = flag_ptrs[me] + 8 * 2 * n
        self.counter_ptr = flag_ptrs[me] + 8 * (2 * n + 1)
        #: this rank's status and counter words (1-element int64 views)
        self.status = self._word(me, 2 * n)
        self.counter = self._word(me, 2 * n + 1)
        self.tensor = self.data[me]
        self.tensor.fill_(fill)
        torch.cuda.current_stream(dev).synchronize()
        #: calls made on this window (every rank makes every call)
        self.seq = 0
        #: the arrival counter's value (blocks of this rank's copies)
        self.arrived = 0
        mesh.host_barrier()

    # -- flag words (1-element int64 views) --------------------------------

    def _word(self, rank: int, i: int) -> torch.Tensor:
        return self.flags[rank][i:i + 1]

    def ready(self, peer: int, at: int = None) -> torch.Tensor:
        """``ready[peer]`` in rank ``at``'s window (default: this rank's)."""
        return self._word(self.mesh.rank if at is None else at, peer)

    def done(self, peer: int, at: int = None) -> torch.Tensor:
        """``done[peer]`` in rank ``at``'s window (default: this rank's)."""
        n = self.mesh.world_size
        return self._word(self.mesh.rank if at is None else at, n + peer)

    def next_seq(self) -> int:
        self.seq += 1
        return self.seq

    def free(self) -> None:
        """Collective: barrier, close the peers' mappings, barrier, free."""
        torch.cuda.current_stream(self.mesh.device).synchronize()
        self.mesh.host_barrier()
        self.data = self.flags = self.tensor = None
        self.status = self.counter = None
        for p in self._opened:
            _raise_on(self._lib.ompi_win_close(self.device_index, p),
                      "cudaIpcCloseMemHandle")
        self._opened = []
        self.mesh.host_barrier()
        _raise_on(self._lib.ompi_win_free(self.device_index, self.ptr),
                  "cudaFree")
        self.ptr = None


def allocate(mesh, local_shape: Sequence[int], dtype: torch.dtype = torch.float32,
             fill=0) -> torch.Tensor:
    """Collective over every rank of ``mesh``: this rank's part of a new
    window of ``local_shape`` and ``dtype``, filled with ``fill``."""
    shape = tuple(int(s) for s in local_shape)
    if mesh.device.type != "cuda":
        return torch.full(shape, fill, dtype=dtype, device=mesh.device)
    w = SymmetricWindow(mesh, shape, dtype, fill)
    mesh.windows[w.tensor.data_ptr()] = w
    return w.tensor


def lookup(mesh, tensor: torch.Tensor) -> SymmetricWindow:
    """The window whose local part ``tensor`` is; raises for any other
    tensor (the one-sided kernels address peers only through windows)."""
    w = mesh.windows.get(tensor.data_ptr())
    if (w is None or tuple(tensor.shape) != tuple(w.tensor.shape)
            or tensor.dtype != w.tensor.dtype):
        raise MPIException(
            f"one-sided op on a {tensor.device.type} tensor "
            f"{tuple(tensor.shape)} {tensor.dtype} that is not a symmetric "
            "window: peers can address only memory allocated collectively "
            "with DeviceWindow, DeviceSymmetricHeap.array or "
            "comm.window(...)")
    return w


def free(mesh, tensor: torch.Tensor) -> None:
    """Collective: free the window whose local part ``tensor`` is (a CPU
    window is a plain tensor and needs nothing)."""
    if mesh.device.type != "cuda":
        return
    w = lookup(mesh, tensor)
    del mesh.windows[tensor.data_ptr()]
    w.free()
