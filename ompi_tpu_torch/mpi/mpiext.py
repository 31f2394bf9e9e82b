"""MPIX extensions — the non-standard-but-supported API surface (the port's
copy of the JAX package's ``mpi/mpiext.py``).

≈ ompi/mpiext (the MPIX_ mechanism; its flagship is
``MPIX_Query_cuda_support`` in ompi/mpiext/cuda): a registry of named
extensions a program can probe at run time instead of guessing from
version strings.  The port's accelerator probe is the reference's own
CUDA query.

    >>> import ompi_tpu_torch.mpi.mpiext as mpix
    >>> mpix.query_cuda_support()       # is the device path on a card?
    >>> mpix.extensions()               # {"cuda", "device_heap", ...}
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["extensions", "has_extension", "register_extension",
           "query_cuda_support", "query_device_heap_support",
           "query_sequence_parallel_support"]

_registry: dict[str, Callable[[], bool]] = {}


def register_extension(name: str, probe: Callable[[], bool]) -> None:
    """Register an MPIX extension (≈ dropping a dir under ompi/mpiext)."""
    _registry[name] = probe


def extensions() -> set[str]:
    """Names of every registered extension (probed or not)."""
    return set(_registry)


def has_extension(name: str) -> bool:
    """Probe one extension; unknown names are False, probes never raise."""
    probe = _registry.get(name)
    if probe is None:
        return False
    try:
        return bool(probe())
    except Exception:  # noqa: BLE001 — a probe failure means "not usable"
        return False


def query_cuda_support() -> bool:
    """≈ MPIX_Query_cuda_support: True when PyTorch sees at least one
    CUDA device (the coll/xla data plane has a card to run on)."""
    return has_extension("cuda")


def query_device_heap_support() -> bool:
    """True when the OSHMEM device symmetric heap (shmem/device.py) can
    host symmetric tensors — a device mesh can be made (CPU meshes
    included, as in the JAX package)."""
    return has_extension("device_heap")


def query_sequence_parallel_support() -> bool:
    """True when ring/Ulysses sequence-parallel attention is importable."""
    return has_extension("sequence_parallel")


def _probe_cuda() -> bool:
    return torch.cuda.is_available() and torch.cuda.device_count() >= 1


def _probe_device_heap() -> bool:
    from ompi_tpu_torch.shmem import device as _dev  # noqa: F401

    return True


def _probe_seq_parallel() -> bool:
    from ompi_tpu_torch.parallel import attention as _attn  # noqa: F401

    return True


register_extension("cuda", _probe_cuda)
register_extension("device_heap", _probe_device_heap)
register_extension("sequence_parallel", _probe_seq_parallel)
