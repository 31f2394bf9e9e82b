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

Two execution modes share one API, as in the JAX package:

1. **Device mode** — one process per card; a communicator bound to a
   ``DeviceCommunicator`` runs its collectives on torch tensors over
   NCCL (gloo on the CPU), with no host copy.
2. **Host process mode** — one OS process per rank, launched by
   ``python -m ompi_tpu_torch.tools.tpurun``; ``init()`` returns
   ``COMM_WORLD``, whose host buffers move over the ob1 PML (self, proc
   and tcp BTLs) with full MPI matching semantics.  Under ``tpurun
   --gpu`` the ranks are also bound one to a card and joined into one
   ``torch.distributed`` group, so both modes run in one job.
"""

from __future__ import annotations

import importlib
from typing import Any

__version__ = "0.1.0"

_LAZY = {
    "init": ("ompi_tpu_torch.mpi.runtime", "init"),
    "finalize": ("ompi_tpu_torch.mpi.runtime", "finalize"),
    "initialized": ("ompi_tpu_torch.mpi.runtime", "initialized"),
    "wtime": ("ompi_tpu_torch.mpi.runtime", "wtime"),
    "wtick": ("ompi_tpu_torch.mpi.runtime", "wtick"),
    "abort": ("ompi_tpu_torch.mpi.runtime", "abort"),
    "get_processor_name": ("ompi_tpu_torch.mpi.runtime",
                           "get_processor_name"),
    "get_version": ("ompi_tpu_torch.mpi.runtime", "get_version"),
    "get_library_version": ("ompi_tpu_torch.mpi.runtime",
                            "get_library_version"),
    "error_string": ("ompi_tpu_torch.mpi.constants", "error_string"),
    "error_class": ("ompi_tpu_torch.mpi.constants", "error_class"),
    "add_error_class": ("ompi_tpu_torch.mpi.constants", "add_error_class"),
    "add_error_code": ("ompi_tpu_torch.mpi.constants", "add_error_code"),
    "add_error_string": ("ompi_tpu_torch.mpi.constants",
                         "add_error_string"),
    "publish_name": ("ompi_tpu_torch.mpi.dpm", "publish_name"),
    "unpublish_name": ("ompi_tpu_torch.mpi.dpm", "unpublish_name"),
    "lookup_name": ("ompi_tpu_torch.mpi.dpm", "lookup_name"),
    "COMM_WORLD": ("ompi_tpu_torch.mpi.runtime", "COMM_WORLD"),
    "COMM_SELF": ("ompi_tpu_torch.mpi.runtime", "COMM_SELF"),
    "GeneralizedRequest": ("ompi_tpu_torch.mpi.request",
                           "GeneralizedRequest"),
    "grequest_start": ("ompi_tpu_torch.mpi.request", "grequest_start"),
    "get_count": ("ompi_tpu_torch.mpi.request", "get_count"),
    "get_elements": ("ompi_tpu_torch.mpi.request", "get_elements"),
    "reduce_local": ("ompi_tpu_torch.mpi.op", "reduce_local"),
    "op_commutative": ("ompi_tpu_torch.mpi.op", "op_commutative"),
    "Datatype": ("ompi_tpu_torch.mpi.datatype", "Datatype"),
    "Op": ("ompi_tpu_torch.mpi.op", "Op"),
    "Request": ("ompi_tpu_torch.mpi.request", "Request"),
    "Status": ("ompi_tpu_torch.mpi.request", "Status"),
    "PersistentRequest": ("ompi_tpu_torch.mpi.request",
                          "PersistentRequest"),
    "wait_all": ("ompi_tpu_torch.mpi.request", "wait_all"),
    "wait_any": ("ompi_tpu_torch.mpi.request", "wait_any"),
    "wait_some": ("ompi_tpu_torch.mpi.request", "wait_some"),
    "test_all": ("ompi_tpu_torch.mpi.request", "test_all"),
    "test_any": ("ompi_tpu_torch.mpi.request", "test_any"),
    "test_some": ("ompi_tpu_torch.mpi.request", "test_some"),
    "start_all": ("ompi_tpu_torch.mpi.request", "start_all"),
    "buffer_attach": ("ompi_tpu_torch.mpi.pml", "buffer_attach"),
    "buffer_detach": ("ompi_tpu_torch.mpi.pml", "buffer_detach"),
    "ANY_SOURCE": ("ompi_tpu_torch.mpi.constants", "ANY_SOURCE"),
    "ANY_TAG": ("ompi_tpu_torch.mpi.constants", "ANY_TAG"),
    "PROC_NULL": ("ompi_tpu_torch.mpi.constants", "PROC_NULL"),
    "UNDEFINED": ("ompi_tpu_torch.mpi.constants", "UNDEFINED"),
    "IN_PLACE": ("ompi_tpu_torch.mpi.constants", "IN_PLACE"),
    "SUM": ("ompi_tpu_torch.mpi.op", "SUM"),
    "PROD": ("ompi_tpu_torch.mpi.op", "PROD"),
    "MAX": ("ompi_tpu_torch.mpi.op", "MAX"),
    "MIN": ("ompi_tpu_torch.mpi.op", "MIN"),
    "LAND": ("ompi_tpu_torch.mpi.op", "LAND"),
    "LOR": ("ompi_tpu_torch.mpi.op", "LOR"),
    "BAND": ("ompi_tpu_torch.mpi.op", "BAND"),
    "BOR": ("ompi_tpu_torch.mpi.op", "BOR"),
    "MAXLOC": ("ompi_tpu_torch.mpi.op", "MAXLOC"),
    "MINLOC": ("ompi_tpu_torch.mpi.op", "MINLOC"),
    "REPLACE": ("ompi_tpu_torch.mpi.op", "REPLACE"),
    "NO_OP": ("ompi_tpu_torch.mpi.op", "NO_OP"),
    "var_registry": ("ompi_tpu_torch.core.config", "var_registry"),
    "register_var": ("ompi_tpu_torch.core.config", "register_var"),
    "Framework": ("ompi_tpu_torch.core.mca", "Framework"),
    "Component": ("ompi_tpu_torch.core.mca", "Component"),
    "framework_registry": ("ompi_tpu_torch.core.mca", "framework_registry"),
    "DeviceCommunicator": ("ompi_tpu_torch.mpi.device_comm",
                           "DeviceCommunicator"),
    "device_world": ("ompi_tpu_torch.mpi.device_comm", "device_world"),
    "Communicator": ("ompi_tpu_torch.mpi.comm", "Communicator"),
    "Group": ("ompi_tpu_torch.mpi.group", "Group"),
    "Window": ("ompi_tpu_torch.mpi.osc", "Window"),
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

# Names that are rebound at runtime (init() replaces them) must be resolved on
# every access, never cached in this module's globals.
_MUTABLE = {"COMM_WORLD", "COMM_SELF"}


def __getattr__(name: str) -> Any:
    try:
        mod, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}") from None
    value = getattr(importlib.import_module(mod), attr)
    if name not in _MUTABLE:
        globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
