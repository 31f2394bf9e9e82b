"""OSHMEM of the port — the OpenSHMEM 1.3 programming model (≈ the
reference's oshmem/), as the JAX package's ``shmem`` package has it.

The host path (``shmem.api``) layers on the port's MPI exactly as the
reference does (oshmem requires MPI init; scoll/mpi delegates
collectives): a symmetric heap of identically-shaped numpy arrays on every
PE, one-sided put/get/atomics over the host RMA windows, and the SHMEM
collective set.  On the card, ``DeviceSymmetricHeap`` (``shmem.device``)
is the symmetric heap of the device plane; it loads on first use, so
``from ompi_tpu_torch import shmem`` imports no torch.
"""

import importlib

from ompi_tpu_torch.shmem.api import (
    init, finalize, my_pe, n_pes, barrier_all, array, free,
    put, get, broadcast, collect, to_all, atomic_add, atomic_fetch_add,
    atomic_cswap, fence, quiet, SymmetricArray,
    Lock, set_lock, test_lock, clear_lock,
    broadcast_active, collect_active, to_all_active,
)


def __getattr__(name: str):
    if name == "DeviceSymmetricHeap":
        return importlib.import_module(
            "ompi_tpu_torch.shmem.device").DeviceSymmetricHeap
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
