"""The port's buffer-location abstraction (``ompi_tpu_torch.core.buffer``),
mirroring ``tests/core/test_buffer.py``: a torch tensor is DEVICE whatever
its device (the JAX package counts a ``jax.Array`` on a CPU device as
DEVICE too), and there is no TRACED kind."""

from __future__ import annotations

import array

import numpy as np
import pytest
import torch

from ompi_tpu_torch.core.buffer import (BufferKind, BufferLocationError,
                                        classify, is_device, nbytes_of,
                                        tensor_to_host, torch_dtype_name)


def test_host_kinds():
    assert classify(np.zeros(3)) == BufferKind.HOST
    assert classify(b"abc") == BufferKind.HOST
    assert classify(bytearray(2)) == BufferKind.HOST
    assert classify(3.0) == BufferKind.HOST
    assert classify(None) == BufferKind.HOST
    assert classify(array.array("f", [1.0])) == BufferKind.HOST
    assert not is_device(np.zeros(3))


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_device_kind(device):
    x = torch.zeros(4, device=device)
    assert classify(x) == BufferKind.DEVICE
    assert is_device(x)


def test_no_traced_kind():
    assert {k.name for k in BufferKind} == {"HOST", "DEVICE"}


def test_part_lists_take_their_first_part():
    assert classify([torch.zeros(2), np.zeros(2)]) == BufferKind.DEVICE
    assert classify((np.zeros(2), torch.zeros(2))) == BufferKind.HOST
    assert classify([]) == BufferKind.HOST


def test_unknown_rejected():
    with pytest.raises(BufferLocationError):
        classify(object())


def test_nbytes():
    assert nbytes_of(np.zeros(4, np.float32)) == 16
    assert nbytes_of(b"12345") == 5
    assert nbytes_of(torch.zeros(3, dtype=torch.bfloat16)) == 6
    assert nbytes_of(torch.zeros(8, device="meta")) == 32


def test_same_kinds_as_the_jax_package():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from ompi_tpu.core import buffer as jbuffer

    for host in (np.zeros(3), b"ab", 2, None, [np.zeros(1)]):
        assert classify(host).value == jbuffer.classify(host).value
    assert (classify(torch.zeros(2)).value
            == jbuffer.classify(jnp.zeros(2)).value == "device")


@pytest.mark.parametrize("copy", [False, True])
def test_tensor_to_host_views_or_copies_a_cpu_tensor(copy):
    t = torch.arange(6, dtype=torch.float32)
    arr, bits = tensor_to_host(t, copy=copy)
    assert not bits and arr.dtype == np.float32
    assert np.shares_memory(arr, t.numpy()) is not copy
    np.testing.assert_array_equal(arr, np.arange(6, dtype=np.float32))


@pytest.mark.parametrize("dtype,bits_dtype", [
    (torch.bfloat16, np.int16), (torch.float8_e4m3fn, np.uint8)])
def test_tensor_to_host_bits_or_converted(dtype, bits_dtype):
    """Without ``bits_to`` a dtype numpy has no name for crosses as its raw
    bits; with it, the values are converted on the tensor's device."""
    t = torch.tensor([1.5, -2.0, 0.25, 448.0]).to(dtype)
    arr, bits = tensor_to_host(t)
    assert bits and arr.dtype == bits_dtype
    assert arr.tobytes() == t.view(getattr(torch, arr.dtype.name)).numpy(
    ).tobytes()
    conv, bits = tensor_to_host(t, bits_to=np.float32)
    assert not bits and conv.dtype == np.float32
    np.testing.assert_array_equal(conv, t.float().numpy())
    assert torch_dtype_name(t) == str(dtype).removeprefix("torch.")
