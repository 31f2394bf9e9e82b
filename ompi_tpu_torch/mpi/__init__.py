"""Communicators of the port (device plane)."""

from ompi_tpu_torch.mpi.device_comm import DeviceCommunicator, device_world

__all__ = ["DeviceCommunicator", "device_world"]
