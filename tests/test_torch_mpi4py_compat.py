"""The port's mpi4py facade (``ompi_tpu_torch.compat.MPI``) against the
JAX package's.

The mirrored cases run the JAX package's own test bodies — every case of
``tests/mpi/test_mpi4py_compat.py`` and ``test_mpi4py_facade_init_family``
of ``tests/mpi/test_coll_persistent.py`` — once through each facade
(``tests/torch_mirror.py``: the same bytecode, every assertion kept, over
each package's in-process harness; the spawn case launches each
package's own ``tpurun``).  Every rank's results of the two runs must be
equal.

The port's own cases follow: CPU tensors as buffers (send data, and
receive, landing and window buffers whose memory the result lands in);
bf16 tensors against the JAX facade on the same ``ml_dtypes`` arrays;
and the port's copies of the three facade examples under its launcher,
with the reference's markers and rank counts.
"""

from __future__ import annotations

import inspect
import os
import pathlib
import subprocess
import sys
import types

import ml_dtypes
import numpy as np
import pytest
import torch

import tests.mpi.test_coll_persistent as ref_persistent
import tests.mpi.test_mpi4py_compat as ref
from ompi_tpu.compat import MPI as JMPI
from ompi_tpu_torch.compat import MPI as PMPI
from tests.mpi.harness import run_ranks as jrun
from tests.test_torch_host_p2p import _same
from tests.torch_host_harness import run_ranks as prun
from tests.torch_mirror import mirror

ROOT = pathlib.Path(__file__).resolve().parents[1]

J = types.SimpleNamespace(name="jax", MPI=JMPI, run=jrun)
P = types.SimpleNamespace(name="port", MPI=PMPI, run=prun)

REF_CASES = sorted(n for n, f in vars(ref).items()
                   if n.startswith("test_") and inspect.isfunction(f))
#: the reference case that races (see ``_win_allocate_typed_roundtrip``),
#: run below with one added barrier
RACY = "test_win_allocate_typed_roundtrip"


def both(fn, **fixtures):
    """Run the JAX package's test body ``fn`` through each facade; the
    results its harness calls returned must be equal."""
    outs = []
    for port in (False, True):
        out: list = []
        mirror(fn, port, out)(**fixtures)
        outs.append(out)
    _same(outs[0], outs[1])
    return outs[1]


def test_every_reference_case_is_mirrored():
    assert len(REF_CASES) == 36


@pytest.mark.parametrize("name", [n for n in REF_CASES if n != RACY])
def test_facade_case_equals_the_jax_package(name, tmp_path_factory):
    fn = getattr(ref, name)
    kw = ({"tmp_path_factory": tmp_path_factory}
          if "tmp_path_factory" in inspect.signature(fn).parameters else {})
    both(fn, **kw)


def _win_allocate_typed_roundtrip(M):
    """``tests/mpi/test_mpi4py_compat.py::test_win_allocate_typed_roundtrip``
    with every assertion, and one barrier added: in the reference, rank 0
    leaves the fence after its REPLACE accumulate and its passive-target
    Get_accumulate can overwrite rank 1's memory before rank 1 has read
    it, in either package (a passive-target op does not wait for the
    target's own reads).  The final memory of rank 1 is compared."""
    MPI = M.MPI

    def fn(c):
        comm = MPI.Comm(c)
        rank = comm.rank
        win = MPI.Win.Allocate(8 * 8, disp_unit=8, comm=comm)
        win.Fence()
        vals = np.array([3.25e9, -1.5, 0.125], np.float64)
        if rank == 0:
            win.Put(vals, 1, target=2)       # disp 2 doubles into rank 1
        win.Fence()
        if rank == 1:
            mem = np.asarray(win.memory).view(np.float64)
            np.testing.assert_array_equal(mem[2:5], vals)
        # typed Get reads the bytes back as float64
        got = np.zeros(3, np.float64)
        win.Lock(1, MPI.LOCK_SHARED)
        win.Get(got, 1, target=2)
        win.Unlock(1)
        np.testing.assert_array_equal(got, vals)
        # REPLACE accumulate is a bitwise put; arithmetic ops must refuse
        win.Fence()
        if rank == 0:
            win.Accumulate(vals * 2, 1, target=2, op=MPI.REPLACE)
            with pytest.raises(MPI.Exception, match="uint8 origin"):
                win.Accumulate(vals, 1, target=2, op=MPI.SUM)
        win.Fence()
        if rank == 1:
            mem = np.asarray(win.memory).view(np.float64)
            np.testing.assert_array_equal(mem[2:5], vals * 2)
        comm.Barrier()     # the added barrier: rank 1 has read its memory
        # Get_accumulate with REPLACE: old typed value comes back
        old = np.zeros(3, np.float64)
        if rank == 0:
            win.Lock(1)
            win.Get_accumulate(vals, old, 1, target=2, op=MPI.REPLACE)
            win.Unlock(1)
            np.testing.assert_array_equal(old, vals * 2)
        # single-element atomics can't reinterpret a typed operand into
        # one byte — they refuse instead of value-casting
        if rank == 0:
            res = np.zeros(1)
            with pytest.raises(MPI.Exception, match="uint8 origin"):
                win.Fetch_and_op(np.array([3.25e9]), res, 1, 0, op=MPI.SUM)
            with pytest.raises(MPI.Exception, match="uint8 origin"):
                win.Compare_and_swap(np.array([1.5]), np.zeros(1), res, 1)
            # uint8 operands still work
            win.Lock(1)
            win.Fetch_and_op(np.array([2], np.uint8),
                             np.zeros(1, np.uint8), 1, 0, op=MPI.SUM)
            win.Unlock(1)
        win.Fence()
        mem = np.asarray(win.memory).copy()
        win.Free()
        return mem

    return M.run(2, fn)


def test_win_allocate_typed_roundtrip():
    out = [_win_allocate_typed_roundtrip(M) for M in (J, P)]
    _same(out[0], out[1])


def test_mpi4py_facade_init_family():
    assert both(ref_persistent.test_mpi4py_facade_init_family) == [
        [True, True]]


# ---------------------------------------------------------------------------
# the port's own cases
# ---------------------------------------------------------------------------

def _buffers_case(M, tmp: pathlib.Path, tensors: bool):
    """Send, receive, collective, window and file calls whose buffers
    are CPU tensors (the port, ``tensors``) or the same numpy arrays
    (either package).  Returns what landed in each buffer."""
    MPI = M.MPI
    rng = np.random.default_rng(18)
    data = rng.normal(size=(2, 6)).astype(np.float32)
    path = str(tmp / f"buf_{M.name}_{int(tensors)}.bin")

    def buf(a):
        a = np.array(a, copy=True)
        return torch.from_numpy(a) if tensors else a

    def host(b):
        return b.numpy().copy() if tensors else b.copy()

    def fn(c):
        comm = MPI.Comm(c)
        r = comm.Get_rank()
        out = {}
        recv = buf(np.zeros(6, np.float32))
        if r == 0:
            comm.Send(buf(data[0]), dest=1, tag=3)
        else:
            comm.Recv(recv, source=0, tag=3)
        out["recv"] = host(recv)
        red = buf(np.zeros(6, np.float32))
        comm.Allreduce(buf(data[r]), red, op=MPI.SUM)
        out["allreduce"] = host(red)
        gath = buf(np.zeros(12, np.float32))
        comm.Allgather(buf(data[r]), gath)
        out["allgather"] = host(gath)
        bc = buf(data[0] if r == 0 else np.zeros(6, np.float32))
        comm.Bcast(bc, root=0)
        out["bcast"] = host(bc)
        req_buf = buf(np.zeros(6, np.float32))
        comm.Iallreduce(buf(data[r]), req_buf).Wait()
        out["iallreduce"] = host(req_buf)
        mem = buf(np.zeros(6, np.float32))
        win = MPI.Win.Create(mem, disp_unit=4, comm=comm)
        win.Fence()
        win.Put(buf(data[r]), 1 - r)
        win.Fence()
        got = buf(np.zeros(3, np.float32))
        win.Lock(1 - r, MPI.LOCK_SHARED)
        win.Get(got, 1 - r, target=[1, 3])
        win.Unlock(1 - r)
        win.Free()
        out["window"] = host(mem)
        out["get"] = host(got)
        fh = MPI.File.Open(comm, path, MPI.MODE_RDWR | MPI.MODE_CREATE)
        fh.Write_at_all(r * 24, buf(data[r]))
        back = buf(np.zeros(12, np.float32))
        fh.Read_at_all(0, back)
        fh.Close()
        out["file"] = host(back)
        return out

    return M.run(2, fn)


def test_cpu_tensor_buffers_land_in_place(tmp_path):
    """CPU tensors wherever mpi4py takes a buffer: the results land in
    the tensors' own memory and equal the JAX facade's on numpy."""
    ref_res = _buffers_case(J, tmp_path, tensors=False)
    _same(ref_res, _buffers_case(P, tmp_path, tensors=False))
    got = _buffers_case(P, tmp_path, tensors=True)
    _same(ref_res, got)
    rng = np.random.default_rng(18)
    data = rng.normal(size=(2, 6)).astype(np.float32)
    np.testing.assert_array_equal(got[1]["recv"], data[0])
    np.testing.assert_array_equal(got[0]["window"], data[1])
    np.testing.assert_array_equal(got[1]["file"], data.reshape(-1))


def _bf16_case(M, tmp: pathlib.Path):
    """bf16 data through the facade: an ``ml_dtypes`` array in the JAX
    package, a bf16 CPU tensor in the port."""
    MPI = M.MPI
    vals = (np.arange(6, dtype=np.float32) - 2.3) * 1.7
    path = str(tmp / f"bf16_{M.name}.bin")

    def bf(a):
        a = np.asarray(a, np.float32)
        if M is P:
            return torch.from_numpy(a.copy()).to(torch.bfloat16)
        return a.astype(ml_dtypes.bfloat16)

    def bits(b):
        return (b.view(torch.int16).numpy().copy() if M is P
                else b.view(np.int16).copy())

    def fn(c):
        comm = MPI.Comm(c)
        r = comm.Get_rank()
        out = {}
        i16 = np.zeros(6, np.int16)
        f32 = np.zeros(6, np.float32)
        if r == 0:
            comm.Send(bf(vals), dest=1, tag=1)
            comm.Send(bf(vals), dest=1, tag=2)
        else:
            comm.Recv(i16, source=0, tag=1)
            comm.Recv(f32, source=0, tag=2)   # the bits land raw
        out["recv_bits"], out["recv_f32_raw"] = i16, f32
        red = bf(np.zeros(6))
        comm.Allreduce(bf(vals * (r + 1)), red)
        out["allreduce_bf16"] = bits(red)
        red32 = np.zeros(6, np.float32)
        comm.Allreduce(bf(vals * (r + 1)), red32)
        out["allreduce_f32"] = red32
        bc = bf(vals if r == 0 else np.zeros(6))
        comm.Bcast(bc, root=0)
        out["bcast"] = bits(bc)
        g = bf(np.zeros(12))
        comm.Allgather(bf(vals + r), g)
        out["allgather"] = bits(g)
        fh = MPI.File.Open(comm, path, MPI.MODE_RDWR | MPI.MODE_CREATE)
        fh.Write_at_all(r * 12, bf(vals + r))
        fh.Close()
        with open(path, "rb") as f:
            out["file"] = np.frombuffer(f.read(), np.uint8).copy()
        return out

    return M.run(2, fn)


def test_bf16_tensors_give_the_jax_facades_values(tmp_path):
    """A bf16 tensor moves as its bits where the JAX facade moves an
    ``ml_dtypes`` array's bytes (p2p, bcast, allgather, file writes), and
    reduces to the values the JAX facade's bf16 reduction gives."""
    ref_res = _bf16_case(J, tmp_path)
    got = _bf16_case(P, tmp_path)
    _same(ref_res, got)
    want = torch.from_numpy((np.arange(6, dtype=np.float32) - 2.3) * 1.7
                            ).to(torch.bfloat16)
    np.testing.assert_array_equal(got[1]["recv_bits"],
                                  want.view(torch.int16).numpy())
    np.testing.assert_array_equal(got[0]["allreduce_f32"],
                                  (want.float() * 3).to(torch.bfloat16)
                                  .float().numpy())


def test_bf16_put_into_a_typed_window_lands_as_values():
    """The JAX facade's remote put of an ``ml_dtypes`` bf16 array into an
    f32 window fails at the target (ROADMAP.md "Notes for porters"); the
    port's converts a bf16 tensor to the window's dtype on its device,
    so the window holds ``t.float()``."""
    t = torch.linspace(-3, 3, 8).to(torch.bfloat16)

    def fn(c):
        comm = PMPI.Comm(c)
        mem = np.zeros(8, np.float32)
        win = PMPI.Win.Create(mem, disp_unit=4, comm=comm)
        win.Fence()
        win.Put(t, 1 - comm.Get_rank())
        win.Fence()
        win.Free()
        return mem

    for mem in prun(2, fn):
        np.testing.assert_array_equal(mem, t.float().numpy())


def _tpurun(pkg: str, np_: int, *prog: str) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", f"{pkg}.tools.tpurun", "-np", str(np_),
         "--", sys.executable, *prog], cwd=ROOT, capture_output=True,
        text=True, timeout=180, env={**os.environ, "JAX_PLATFORMS": "cpu"})


@pytest.mark.parametrize("script,marker,np_", [
    ("mpi4py_ring", "exiting", 3),
    ("mpi4py_cart_halo", "halo exchange ok", 3)])
def test_facade_example_runs_under_tpurun(script, marker, np_):
    """The port's copy of each facade example under the port's launcher
    (tests/runtime/test_examples.py's marker and rank count) prints the
    JAX package's example's lines."""
    p = _tpurun("ompi_tpu_torch", np_, "-m", f"ompi_tpu_torch.examples.{script}")
    out = p.stdout + p.stderr
    assert p.returncode == 0, out[-2000:]
    assert marker in out, out[-2000:]
    ref_p = _tpurun("ompi_tpu", np_, str(ROOT / "examples" / f"{script}.py"))
    assert ref_p.returncode == 0, ref_p.stderr[-2000:]
    assert sorted(p.stdout.splitlines()) == sorted(ref_p.stdout.splitlines())


def test_facade_collectives_bench_runs():
    """The facade-overhead microbench completes and prints per-collective
    ratios (tests/runtime/test_examples.py's assertions); the ratio
    VALUES are advisory, so only the structure is asserted."""
    proc = subprocess.run(
        [sys.executable, "-m",
         "ompi_tpu_torch.examples.facade_collectives_bench"],
        capture_output=True, text=True, timeout=400, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    for coll in ("allreduce", "allgather", "bcast"):
        assert coll in proc.stdout
    assert "ratio" in proc.stdout
