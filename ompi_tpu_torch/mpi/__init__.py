"""Communicators of the port (device plane)."""

from ompi_tpu_torch.mpi.device_comm import DeviceCommunicator

__all__ = ["DeviceCommunicator"]
