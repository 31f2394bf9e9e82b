"""OpenSHMEM of the port (device mode)."""

from ompi_tpu_torch.shmem.device import DeviceSymmetricHeap

__all__ = ["DeviceSymmetricHeap"]
