"""Host RMA windows and SHMEM arrays fed from the card: a CUDA tensor as
a host window's buffer raises and names ``DeviceWindow``; a CUDA tensor
put (f32 and bf16) into an f32 window reaches the host in one
device-to-host copy and lands bit for bit as ``t.float().cpu()``.  These
need a card and skip without one; the file imports no JAX (the card's
machine has none).  Run on the card with
``python -m pytest -m gpu tests/test_torch_osc_card.py``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ompi_tpu_torch.mpi import osc
from ompi_tpu_torch.mpi.constants import MPIException
from tests.torch_host_harness import run_ranks


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_tensor_as_a_host_window_buffer_raises():
    dev = _card()

    def fn(comm):
        msgs = []
        for call in (lambda: osc.Window(comm, buffer=torch.zeros(8,
                                                                 device=dev)),
                     lambda: osc.Window.create_dynamic(comm).attach(
                         torch.zeros(8, device=dev))):
            with pytest.raises(MPIException, match="DeviceWindow") as e:
                call()
            msgs.append(str(e.value))
        return msgs

    assert len(run_ranks(1, fn)[0]) == 2


def _dtoh(prof) -> int:
    return sum(e.count for e in prof.key_averages()
               if e.device_type.name == "CUDA" and "DtoH" in e.key)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_tensor_put_is_one_copy_and_bitwise(dtype):
    from torch.profiler import ProfilerActivity, profile

    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(5)
    n = 1 << 16
    src = torch.randn(2, n, device=dev, generator=gen).to(dtype)
    copies: list = []

    def fn(comm):
        win = osc.Window(comm, size=n, dtype=np.float32)
        win.fence()
        t = src[comm.rank][::1]
        if comm.rank == 0:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                win.put(1, t)
                torch.cuda.synchronize()
            copies.append(_dtoh(prof))
        comm.barrier()
        if comm.rank == 1:
            win.put(0, t)
        win.fence()
        out = win.buf.copy()
        win.free()
        return out

    got = run_ranks(2, fn)
    assert copies == [1]
    for r in range(2):
        want = src[1 - r].float().cpu().numpy()
        assert got[r].tobytes() == want.tobytes()
