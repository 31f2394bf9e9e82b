"""ompi_tpu_torch — the PyTorch/CUDA port of ompi_tpu, for NVIDIA Hopper.

A package of its own beside ``ompi_tpu`` (the JAX reference, which it
never imports).  Plain tensor code is PyTorch; every Pallas kernel of the
JAX package on a ported path becomes a hand-written Hopper kernel under
``ops/csrc``, built with nvcc at first use.  Public names and layouts
follow the JAX package so that each counterpart is easy to find and the
parity tests compare like with like.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU; with no CUDA they raise.  The slices ported so far are
listed in ROADMAP.md.
"""

from __future__ import annotations

import importlib
from typing import Any

__version__ = "0.1.0"

_LAZY = {
    "var_registry": ("ompi_tpu_torch.core.config", "var_registry"),
    "register_var": ("ompi_tpu_torch.core.config", "register_var"),
    "DeviceCommunicator": ("ompi_tpu_torch.mpi.device_comm",
                           "DeviceCommunicator"),
    "device_world": ("ompi_tpu_torch.mpi.device_comm", "device_world"),
    "Communicator": ("ompi_tpu_torch.mpi.comm", "Communicator"),
    "Group": ("ompi_tpu_torch.mpi.group", "Group"),
    "DeviceWindow": ("ompi_tpu_torch.mpi.osc", "DeviceWindow"),
    "DeviceSymmetricHeap": ("ompi_tpu_torch.shmem.device",
                            "DeviceSymmetricHeap"),
    "window_put": ("ompi_tpu_torch.ops.remote_dma", "window_put"),
    "window_get": ("ompi_tpu_torch.ops.remote_dma", "window_get"),
    "fetch_bcast": ("ompi_tpu_torch.ops.remote_dma", "fetch_bcast"),
    "Mesh": ("ompi_tpu_torch.parallel.mesh", "Mesh"),
    "make_mesh": ("ompi_tpu_torch.parallel.mesh", "make_mesh"),
    "flash_attention": ("ompi_tpu_torch.ops.flash_attention",
                        "flash_attention"),
    "flash_attention_lse": ("ompi_tpu_torch.ops.flash_attention",
                            "flash_attention_lse"),
    "TransformerConfig": ("ompi_tpu_torch.models.transformer",
                          "TransformerConfig"),
    "init_params": ("ompi_tpu_torch.models.transformer", "init_params"),
    "make_forward": ("ompi_tpu_torch.models.transformer", "make_forward"),
    "make_loss_fn": ("ompi_tpu_torch.models.transformer", "make_loss_fn"),
    "make_train_step": ("ompi_tpu_torch.models.transformer",
                        "make_train_step"),
    "make_train_loop": ("ompi_tpu_torch.models.transformer",
                        "make_train_loop"),
    "param_specs": ("ompi_tpu_torch.models.transformer", "param_specs"),
    "shard_tokens": ("ompi_tpu_torch.models.transformer", "shard_tokens"),
    "make_decoder": ("ompi_tpu_torch.models.decode", "make_decoder"),
    "ArraySource": ("ompi_tpu_torch.models.data", "ArraySource"),
    "MemmapSource": ("ompi_tpu_torch.models.data", "MemmapSource"),
    "train_stream": ("ompi_tpu_torch.models.data", "train_stream"),
    "from_jax_params": ("ompi_tpu_torch.models.weights", "from_jax_params"),
    "to_numpy_params": ("ompi_tpu_torch.models.weights", "to_numpy_params"),
    "switch_moe": ("ompi_tpu_torch.parallel.moe", "switch_moe"),
    "moe_params": ("ompi_tpu_torch.parallel.moe", "moe_params"),
}

__all__ = sorted(_LAZY)


def __getattr__(name: str) -> Any:
    try:
        mod, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}") from None
    value = getattr(importlib.import_module(mod), attr)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
