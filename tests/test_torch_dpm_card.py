"""The mpi4py facade fed from the card: a CUDA tensor as send, origin or
file-write data reaches the host in one device-to-host copy and lands bit
for bit (f32 and bf16, whose bits travel); a CUDA tensor as a receive,
landing or window buffer raises ERR_BUFFER and names the device route;
a CUDA tensor over an intercommunicator arrives as numpy.  These need a
card and skip without one; the file imports no JAX (the card's machine
has none).  Run on the card with
``python -m pytest -m gpu tests/test_torch_dpm_card.py``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ompi_tpu_torch.compat import MPI
from ompi_tpu_torch.mpi import dpm
from ompi_tpu_torch.mpi.constants import ERR_BUFFER, MPIException
from tests.torch_host_harness import run_ranks


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _dtoh(prof) -> int:
    return sum(e.count for e in prof.key_averages()
               if e.device_type.name == "CUDA" and "DtoH" in e.key)


def _tensor(dev, seed: int, n: int, dtype=torch.float32):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(n, device=dev, generator=gen).to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_send_is_one_copy_and_bitwise(dtype):
    from torch.profiler import ProfilerActivity, profile

    dev = _card()
    n = 1 << 18
    t = _tensor(dev, 3, n, dtype)
    bits = t.view(torch.int16 if dtype == torch.bfloat16 else torch.int32)
    want = bits.cpu().numpy()
    copies: list = []

    def fn(c):
        comm = MPI.Comm(c)
        if comm.Get_rank() == 0:
            comm.Send(t, dest=1, tag=1)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                comm.Send(t, dest=1, tag=2)
                t[:1].cpu()                     # the control: one DtoH
                torch.cuda.synchronize()
            copies.append(_dtoh(prof))
            return None
        out = []
        for tag in (1, 2):
            buf = np.zeros(n, want.dtype)
            comm.Recv(buf, source=0, tag=tag)
            out.append(buf)
        return out

    got = run_ranks(2, fn)[1]
    for buf in got:
        assert buf.tobytes() == want.tobytes()
    assert copies == [2]


@pytest.mark.gpu
def test_cuda_allreduce_put_and_file_write_are_bitwise(tmp_path):
    dev = _card()
    n = 1 << 16
    ts = [torch.randint(0, 1000, (n,), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(r)
                        ).float() for r in range(2)]
    path = str(tmp_path / "f.bin")

    def fn(c):
        comm = MPI.Comm(c)
        r = comm.Get_rank()
        red = np.zeros(n, np.float32)
        comm.Allreduce(ts[r], red)
        win = MPI.Win.Allocate(n * 4, disp_unit=4, comm=comm)
        win.Fence()
        win.Put(ts[r], 1 - r)
        win.Fence()
        mem = np.asarray(win.memory).view(np.float32).copy()
        win.Free()
        fh = MPI.File.Open(comm, path, MPI.MODE_RDWR | MPI.MODE_CREATE)
        fh.Write_at_all(r * n * 4, ts[r])
        back = np.zeros(2 * n, np.float32)
        fh.Read_at_all(0, back)
        fh.Close()
        return red, mem, back

    host = [t.cpu().numpy() for t in ts]
    for r, (red, mem, back) in enumerate(run_ranks(2, fn)):
        assert red.tobytes() == (host[0] + host[1]).tobytes()
        assert mem.tobytes() == host[1 - r].tobytes()
        assert back.tobytes() == np.concatenate(host).tobytes()


@pytest.mark.gpu
def test_cuda_receive_and_window_buffers_raise_err_buffer():
    dev = _card()

    def fn(c):
        comm = MPI.Comm(c)
        peer = 1 - comm.Get_rank()
        sreq = comm.Isend(np.ones(8, np.float32), dest=peer, tag=4)
        codes = []
        for call in (
                lambda: comm.Recv(torch.zeros(8, device=dev), source=peer,
                                  tag=4),
                lambda: comm.Irecv(torch.zeros(8, device=dev), source=peer,
                                   tag=4),
                lambda: MPI.Win.Create(torch.zeros(8, device=dev),
                                       comm=comm),
                lambda: comm.Allreduce(np.ones(8, np.float32),
                                       torch.zeros(8, device=dev))):
            with pytest.raises(MPIException, match="DeviceCommunicator") \
                    as e:
                call()
            codes.append(e.value.error_class)
        got = np.zeros(8, np.float32)
        comm.Recv(got, source=peer, tag=4)     # the message stayed queued
        sreq.Wait()
        return codes, got.tolist()

    for codes, got in run_ranks(2, fn):
        assert codes == [ERR_BUFFER] * 4
        assert got == [1.0] * 8


@pytest.mark.gpu
def test_cuda_tensor_over_an_intercomm_arrives_as_numpy():
    dev = _card()
    t = _tensor(dev, 9, 1 << 12)
    port = dpm.open_port()
    out: list = []

    def server(c):
        ic = dpm.accept(c, port)
        ic.send(t, dest=0, tag=5)
        ic.disconnect()

    def client(c):
        ic = dpm.connect(c, port)
        out.append(ic.recv(source=0, tag=5))
        ic.disconnect()

    import threading

    ths = [threading.Thread(target=run_ranks, args=(1, fn))
           for fn in (server, client)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(60)
    dpm.close_port(port)
    assert type(out[0]) is np.ndarray
    assert out[0].tobytes() == t.cpu().numpy().tobytes()
