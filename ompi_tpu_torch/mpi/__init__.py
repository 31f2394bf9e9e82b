"""Communicators of the port: the host plane (``comm``, ``pml``, ``btl``,
``coll``, MPI-IO in ``io``) and the device plane (``device_comm``).  The
device names and ``io`` load on first use, so a host-plane rank does not
import torch."""

import importlib

__all__ = ["DeviceCommunicator", "device_world"]


def __getattr__(name: str):
    if name == "io":
        return importlib.import_module("ompi_tpu_torch.mpi.io")
    if name in __all__:
        from ompi_tpu_torch.mpi import device_comm

        return getattr(device_comm, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
