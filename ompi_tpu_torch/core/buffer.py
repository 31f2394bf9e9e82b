"""Buffer-location abstraction: host vs device (the port's copy of the JAX
package's ``core/buffer.py``).

The reference threads CUDA special cases through its convertor, PML, BTL
and coll layers via the ``CONVERTOR_CUDA`` flag
(opal/datatype/opal_convertor.h:43-59, opal_convertor.c:574-614
``mca_cuda_convertor_init``); here device-ness is decided once, as data:

- ``HOST``   — numpy arrays, scalars, python buffers, ``None``; they move
               by the host path.
- ``DEVICE`` — a ``torch.Tensor``, whatever its device: this rank's shard,
               moved by the bound ``DeviceCommunicator`` (NCCL on the card,
               gloo for a CPU tensor), never serialized.  The JAX package
               counts a ``jax.Array`` on a CPU device as DEVICE too.

The JAX package has a third kind, TRACED (a tracer inside ``shard_map``).
A port rank is a process that owns one device and runs eagerly, so the
tensor it passes already is its shard: DEVICE has TRACED's per-shard
semantics and there is no TRACED kind.

Every layer above (p2p, coll) dispatches on ``classify()`` instead of
sprinkling isinstance checks.  The module does not import torch: a buffer
can only be a tensor once the process has loaded torch, so a host-plane
rank that never touches a tensor never pays torch's import.
"""

from __future__ import annotations

import enum
import sys
from typing import Any

import numpy as np

__all__ = ["BufferKind", "classify", "is_device", "is_tensor", "nbytes_of",
           "BufferLocationError", "torch_dtype_name", "tensor_to_host",
           "host_array"]


#: torch dtypes numpy has no name for without ml_dtypes (their name,
#: ml_dtypes' and torch's alike) → the integer dtype of their bits, which
#: is how they cross to numpy (MPI-IO writes, the snapshot stores)
BITS_DTYPE = {"bfloat16": "int16", "float8_e4m3fn": "uint8",
              "float8_e5m2": "uint8", "float8_e4m3fnuz": "uint8",
              "float8_e5m2fnuz": "uint8"}


class BufferKind(enum.Enum):
    HOST = "host"
    DEVICE = "device"


class BufferLocationError(TypeError):
    pass


def is_tensor(buf: Any) -> bool:
    """Is ``buf`` a torch.Tensor (without importing torch)?"""
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(buf, torch.Tensor)


def classify(buf: Any) -> BufferKind:
    """Classify a user buffer."""
    if is_tensor(buf):
        return BufferKind.DEVICE
    if buf is None:  # "no data on this rank" placeholder (non-root scatter)
        return BufferKind.HOST
    if isinstance(buf, np.ndarray) or np.isscalar(buf):
        return BufferKind.HOST
    if isinstance(buf, (bytes, bytearray, memoryview)):
        return BufferKind.HOST
    if isinstance(buf, (list, tuple)):
        # v-collective part lists: the parts share a location; classify the
        # first (an empty list is a host no-op)
        return classify(buf[0]) if buf else BufferKind.HOST
    # any other array-like the host path accepts (array.array, objects
    # with __array__ / the buffer protocol)
    if hasattr(buf, "__array__") or hasattr(buf, "__array_interface__"):
        return BufferKind.HOST
    try:
        memoryview(buf)
        return BufferKind.HOST
    except TypeError:
        pass
    raise BufferLocationError(
        f"cannot classify buffer of type {type(buf).__name__}; expected "
        f"numpy array, torch tensor, or bytes-like")


def is_device(buf: Any) -> bool:
    return classify(buf) is BufferKind.DEVICE


def nbytes_of(buf: Any) -> int:
    if is_tensor(buf):
        return buf.numel() * buf.element_size()
    if isinstance(buf, (bytes, bytearray, memoryview)):
        return len(buf)
    nb = getattr(buf, "nbytes", None)
    if nb is not None:
        return int(nb)
    return int(np.asarray(buf).nbytes)


def torch_dtype_name(t: Any) -> str:
    """A tensor's dtype as numpy and ml_dtypes name it ("bfloat16")."""
    return str(t.dtype).removeprefix("torch.")


def tensor_to_host(t: Any, bits_to: Any = None, copy: bool = False
                   ) -> tuple[np.ndarray, bool]:
    """Host form of a tensor.  A CUDA tensor is made contiguous on the card
    and comes to the host in ONE device-to-host copy; a CPU tensor is
    viewed in place unless ``copy``.  A dtype numpy has no name for (bf16,
    float8) is converted on the tensor's own device to the numpy dtype
    ``bits_to`` where one is given, and otherwise crosses as its raw bits
    (``BITS_DTYPE``).  Returns the array and whether it holds raw bits."""
    import torch

    t = t.detach()
    name = torch_dtype_name(t)
    bits = name in BITS_DTYPE and bits_to is None
    if bits:
        t = t.view(getattr(torch, BITS_DTYPE[name]))
    elif name in BITS_DTYPE:
        t = t.to(getattr(torch, np.dtype(bits_to).name, torch.float32))
    if t.device.type != "cpu":
        # contiguous() runs on the card; cpu() is the one whole-buffer copy
        return t.contiguous().cpu().numpy(), bits
    arr = t.numpy()
    return (arr.copy() if copy else arr), bits


def host_array(buf: Any, bits_to: Any = None) -> np.ndarray:
    """Host form of send data: a tensor through ``tensor_to_host`` (a CPU
    tensor viewed, a CUDA tensor in one device-to-host copy), anything
    else through ``np.asarray`` (as the JAX package takes a buffer)."""
    if is_tensor(buf):
        return tensor_to_host(buf, bits_to=bits_to)[0]
    return np.asarray(buf)
