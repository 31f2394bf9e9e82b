"""The port's MPI-IO (``ompi_tpu_torch.mpi.io``) against the JAX
package's: views, individual, collective, shared and ordered access.

Each case mirrors one of ``tests/mpi/test_io.py`` or
``tests/mpi/test_io_vectorized.py`` with every assertion kept.  The case
runs once through each package (``M``: its ``io``, ``datatype``, variable
registry and in-process harness) on the same numpy inputs, each in its own
directory, and returns what it produced — every rank's results and the
bytes of every file it wrote; the two must be equal byte for byte.
Variables are set inside the case and restored, as the reference's tests
do, in the package under test.

The port's own cases follow: torch tensors as write buffers (a CPU
tensor in place, a non-contiguous one, bf16 as its bits), the
nonblocking write's staging (a tensor changed in place after
``iwrite_at_all`` returns does not reach the file), and the sm shared
pointer's ``/dev/shm`` segments (none left after close, two opens of one
path by the two packages kept apart).
"""

from __future__ import annotations

import glob
import os
import types

import numpy as np
import pytest

from ompi_tpu.core.config import var_registry as jvars
from ompi_tpu.mpi import datatype as jdt
from ompi_tpu.mpi import io as jio
from ompi_tpu.mpi.constants import MPIException as JMPIException
from ompi_tpu_torch.core.config import var_registry as pvars
from ompi_tpu_torch.mpi import datatype as pdt
from ompi_tpu_torch.mpi import io as pio
from ompi_tpu_torch.mpi.constants import MPIException as PMPIException
from tests.mpi.harness import run_ranks as jrun
from tests.test_torch_host_p2p import _same
from tests.torch_host_harness import run_ranks as prun

J = types.SimpleNamespace(name="jax", mio=jio, dt=jdt, vars=jvars,
                          MPIException=JMPIException, run=jrun)
P = types.SimpleNamespace(name="port", mio=pio, dt=pdt, vars=pvars,
                          MPIException=PMPIException, run=prun)


def _files(d) -> dict:
    """{name: bytes} of every file a case left in its directory."""
    return {os.path.relpath(p, d): open(p, "rb").read()
            for p in sorted(glob.glob(os.path.join(str(d), "**", "*"),
                                      recursive=True))
            if os.path.isfile(p)}


def both(case, tmp_path, *args):
    """Run ``case(M, dir, *args)`` through both packages, each in its own
    directory; their results and files must be equal byte for byte."""
    out = []
    for M in (J, P):
        d = tmp_path / M.name
        d.mkdir()
        res = case(M, d, *args)
        out.append((res, _files(d)))
    _same(out[0], out[1])
    return out[1][0]


# ---------------------------------------------------------------------------
# FileView (pure mapping logic)
# ---------------------------------------------------------------------------

def _view_contiguous_bytes(M, d):
    v = M.mio.FileView(disp=10)
    assert v.contiguous
    assert v.byte_runs(5, 7) == [(15, 7)]
    return v.byte_runs(5, 7)


def test_view_contiguous_bytes(tmp_path):
    both(_view_contiguous_bytes, tmp_path)


def _view_etype_units(M, d):
    v = M.mio.FileView(disp=0, etype=M.dt.FLOAT64)
    assert v.byte_runs(2, 16) == [(16, 16)]
    return v.byte_runs(2, 16)


def test_view_etype_units(tmp_path):
    both(_view_etype_units, tmp_path)


def _view_strided_filetype(M, d):
    ft = M.dt.INT32.vector(2, 2, 4).commit()
    v = M.mio.FileView(disp=0, etype=M.dt.INT32, filetype=ft)
    assert not v.contiguous
    assert v.byte_runs(0, 8) == [(0, 8)]
    assert v.byte_runs(0, 16) == [(0, 8), (16, 8)]
    assert v.byte_runs(2, 16) == [(16, 16)]
    v32 = M.mio.FileView(disp=0, etype=M.dt.INT32,
                         filetype=ft.resized(32).commit())
    assert v32.byte_runs(2, 16) == [(16, 8), (32, 8)]
    return v.byte_runs(0, 40), v32.byte_runs(1, 40)


def test_view_strided_filetype(tmp_path):
    both(_view_strided_filetype, tmp_path)


def _view_rejects_partial_etype(M, d):
    ft = M.dt.INT32.contiguous(3).commit()
    with pytest.raises(M.MPIException):
        M.mio.FileView(etype=M.dt.FLOAT64, filetype=ft)
    return True


def test_view_rejects_partial_etype(tmp_path):
    both(_view_rejects_partial_etype, tmp_path)


# ---------------------------------------------------------------------------
# individual IO
# ---------------------------------------------------------------------------

def _open_write_read_roundtrip(M, d):
    path = str(d / "a.dat")

    def body(comm):
        f = M.mio.File.open(comm, path, M.mio.MODE_RDWR | M.mio.MODE_CREATE)
        f.set_view(0, M.dt.FLOAT64)
        f.write_at(comm.rank * 4, np.full(4, float(comm.rank)))
        f.close()
        f2 = M.mio.File.open(comm, path)
        f2.set_view(0, M.dt.FLOAT64)
        out = f2.read_at(0, 4 * comm.size)
        f2.close()
        return out

    res = M.run(3, body)
    for out in res:
        np.testing.assert_array_equal(out, np.repeat(np.arange(3.0), 4))
    return res


def test_open_write_read_roundtrip(tmp_path):
    both(_open_write_read_roundtrip, tmp_path)


def _individual_pointer_and_seek(M, d):
    path = str(d / "b.dat")

    def body(comm):
        f = M.mio.File.open(comm, path, M.mio.MODE_RDWR | M.mio.MODE_CREATE)
        f.set_view(0, M.dt.INT32)
        got = None
        if comm.rank == 0:
            f.write(np.arange(10, dtype=np.int32))
            assert f.get_position() == 10
            f.seek(2)
            got = f.read(3)
            np.testing.assert_array_equal(got, [2, 3, 4])
            f.seek(-2, M.mio.SEEK_CUR)
            assert f.get_position() == 3
            f.seek(0, M.mio.SEEK_END)
            assert f.get_position() == 10
        comm.barrier()
        f.close()
        return got

    return M.run(2, body)


def test_individual_pointer_and_seek(tmp_path):
    both(_individual_pointer_and_seek, tmp_path)


def _strided_view_write_read(M, d):
    path = str(d / "c.dat")
    n, bl = 3, 2

    def body(comm):
        ft = M.dt.INT32.vector(1, bl, bl * n).resized(bl * n * 4).commit()
        f = M.mio.File.open(comm, path, M.mio.MODE_RDWR | M.mio.MODE_CREATE)
        f.set_view(comm.rank * bl * 4, M.dt.INT32, ft)
        data = np.arange(4 * bl, dtype=np.int32) + 100 * comm.rank
        f.write_at(0, data)
        f.close()
        return None

    M.run(n, body)
    raw = np.fromfile(path, dtype=np.int32)
    want = []
    for blk in range(4):
        for r in range(n):
            want.extend(np.arange(blk * bl, blk * bl + bl) + 100 * r)
    np.testing.assert_array_equal(raw, np.array(want, dtype=np.int32))
    return raw


def test_strided_view_write_read(tmp_path):
    both(_strided_view_write_read, tmp_path)


def _read_write_mode_guards(M, d):
    path = str(d / "d.dat")

    def body(comm):
        f = M.mio.File.open(comm, path,
                            M.mio.MODE_CREATE | M.mio.MODE_WRONLY)
        try:
            f.read_at(0, 1)
        except M.MPIException:
            ok1 = True
        else:
            ok1 = False
        f.close()
        f2 = M.mio.File.open(comm, path, M.mio.MODE_RDONLY)
        try:
            f2.write_at(0, np.zeros(1, np.uint8))
        except M.MPIException:
            ok2 = True
        else:
            ok2 = False
        f2.close()
        return ok1 and ok2

    res = M.run(2, body)
    assert all(res)
    return res


def test_read_write_mode_guards(tmp_path):
    both(_read_write_mode_guards, tmp_path)


def _excl_create(M, d):
    path = str(d / "e.dat")

    def body(comm):
        f = M.mio.File.open(comm, path, M.mio.MODE_CREATE | M.mio.MODE_EXCL
                            | M.mio.MODE_RDWR)
        f.close()
        try:
            M.mio.File.open(comm, path, M.mio.MODE_CREATE | M.mio.MODE_EXCL
                            | M.mio.MODE_RDWR)
        except M.MPIException:
            return True
        return False

    res = M.run(3, body)
    assert all(res)
    return res


def test_excl_create(tmp_path):
    both(_excl_create, tmp_path)


def _delete_on_close_and_set_size(M, d):
    path = str(d / "f.dat")

    def body(comm):
        f = M.mio.File.open(comm, path, M.mio.MODE_CREATE | M.mio.MODE_RDWR
                            | M.mio.MODE_DELETE_ON_CLOSE)
        f.set_size(128)
        assert f.get_size() == 128
        f.preallocate(64)
        assert f.get_size() == 128
        f.close()
        return os.path.exists(path)

    res = M.run(2, body)
    assert not any(res)
    return res


def test_delete_on_close_and_set_size(tmp_path):
    both(_delete_on_close_and_set_size, tmp_path)


# ---------------------------------------------------------------------------
# collective two-phase IO
# ---------------------------------------------------------------------------

def _write_at_all_interleaved(M, d, twophase):
    path = str(d / f"g{twophase}.dat")
    M.vars.set("io_twophase", twophase)
    try:
        n = 4

        def body(comm):
            ft = M.dt.FLOAT32.vector(1, 2, 2 * n).resized(2 * n * 4).commit()
            f = M.mio.File.open(comm, path,
                                M.mio.MODE_RDWR | M.mio.MODE_CREATE)
            f.set_view(comm.rank * 8, M.dt.FLOAT32, ft)
            data = np.arange(6, dtype=np.float32) + 10 * comm.rank
            f.write_at_all(0, data)
            out = f.read_at_all(0, 6)
            f.close()
            return out

        results = M.run(n, body)
        for r, out in enumerate(results):
            np.testing.assert_array_equal(
                out, np.arange(6, dtype=np.float32) + 10 * r)
        raw = np.fromfile(path, dtype=np.float32)
        want = []
        for blk in range(3):
            for r in range(n):
                want.extend(np.arange(blk * 2, blk * 2 + 2) + 10 * r)
        np.testing.assert_array_equal(raw, np.array(want, np.float32))
        return results
    finally:
        M.vars.set("io_twophase", True)


@pytest.mark.parametrize("twophase", [True, False])
def test_write_at_all_interleaved(tmp_path, twophase):
    both(_write_at_all_interleaved, tmp_path, twophase)


def _write_all_with_pointer(M, d):
    path = str(d / "h.dat")

    def body(comm):
        f = M.mio.File.open(comm, path, M.mio.MODE_RDWR | M.mio.MODE_CREATE)
        f.set_view(0, M.dt.INT64)
        f.seek(comm.rank * 3)
        f.write_all(np.arange(3, dtype=np.int64) + 100 * comm.rank)
        f.close()

    M.run(3, body)
    raw = np.fromfile(path, dtype=np.int64)
    want = np.concatenate([np.arange(3) + 100 * r for r in range(3)])
    np.testing.assert_array_equal(raw, want)
    return raw


def test_write_all_with_pointer(tmp_path):
    both(_write_all_with_pointer, tmp_path)


def _collective_read_uneven(M, d):
    path = str(d / "i.dat")
    base = np.arange(32, dtype=np.float64)
    base.tofile(path)

    def body(comm):
        f = M.mio.File.open(comm, path)
        f.set_view(0, M.dt.FLOAT64)
        count = [0, 5, 27][comm.rank]
        off = [0, 0, 5][comm.rank]
        out = f.read_at_all(off, count)
        f.close()
        return out

    r0, r1, r2 = M.run(3, body)
    assert len(r0) == 0
    np.testing.assert_array_equal(r1, base[:5])
    np.testing.assert_array_equal(r2, base[5:])
    return [r0, r1, r2]


def test_collective_read_uneven(tmp_path):
    both(_collective_read_uneven, tmp_path)


def _collective_read_past_eof(M, d):
    path = str(d / "r.dat")
    base = np.arange(10, dtype=np.float64)
    base.tofile(path)

    def body(comm):
        f = M.mio.File.open(comm, path)
        f.set_view(0, M.dt.FLOAT64)
        off = [0, 8][comm.rank]
        count = [8, 12][comm.rank]
        out = f.read_at_all(off, count)
        f.close()
        return out

    r0, r1 = M.run(2, body)
    np.testing.assert_array_equal(r0, base[:8])
    np.testing.assert_array_equal(r1, base[8:10])
    return [r0, r1]


def test_collective_read_past_eof(tmp_path):
    both(_collective_read_past_eof, tmp_path)


# ---------------------------------------------------------------------------
# shared / ordered pointers
# ---------------------------------------------------------------------------

def _write_shared_disjoint(M, d):
    path = str(d / "j.dat")

    def body(comm):
        f = M.mio.File.open(comm, path, M.mio.MODE_RDWR | M.mio.MODE_CREATE)
        f.set_view(0, M.dt.INT32)
        f.write_shared(np.full(4, comm.rank, np.int32))
        comm.barrier()
        pos = f.get_position_shared()
        f.close()
        return pos

    results = M.run(4, body)
    assert all(p == 16 for p in results)
    raw = np.fromfile(path, dtype=np.int32)
    assert sorted(raw.reshape(4, 4)[:, 0]) == [0, 1, 2, 3]
    for row in raw.reshape(4, 4):
        assert (row == row[0]).all()
    os.unlink(path)      # the ranks' order is the race's: sorted above
    return results, sorted(raw.reshape(4, 4)[:, 0].tolist())


def test_write_shared_disjoint(tmp_path):
    both(_write_shared_disjoint, tmp_path)


def _write_ordered_rank_order(M, d):
    path = str(d / "k.dat")

    def body(comm):
        f = M.mio.File.open(comm, path, M.mio.MODE_RDWR | M.mio.MODE_CREATE)
        f.set_view(0, M.dt.INT32)
        f.write_ordered(np.full(2 + comm.rank, comm.rank, np.int32))
        out = None
        if comm.rank == 0:
            out = f.read_at(0, 2 + 3 + 4)
        f.close()
        return out

    results = M.run(3, body)
    np.testing.assert_array_equal(
        results[0], np.array([0, 0, 1, 1, 1, 2, 2, 2, 2], np.int32))
    return results


def test_write_ordered_rank_order(tmp_path):
    both(_write_ordered_rank_order, tmp_path)


def _read_ordered(M, d):
    path = str(d / "l.dat")
    np.arange(9, dtype=np.int32).tofile(path)

    def body(comm):
        f = M.mio.File.open(comm, path)
        f.set_view(0, M.dt.INT32)
        out = f.read_ordered(3)
        f.close()
        return out

    results = M.run(3, body)
    for r, out in enumerate(results):
        np.testing.assert_array_equal(out, np.arange(r * 3, r * 3 + 3))
    return results


def test_read_ordered(tmp_path):
    both(_read_ordered, tmp_path)


def _derived_etype_pointer_advance(M, d):
    path = str(d / "n.dat")
    np.arange(12, dtype=np.int32).tofile(path)

    def body(comm):
        et = M.dt.INT32.contiguous(2).commit()
        f = M.mio.File.open(comm, path)
        f.set_view(0, et)
        out = f.read(2)
        pos = f.get_position()
        out2 = f.read(1)
        f.close()
        return out, pos, out2

    out, pos, out2 = M.run(1, body)[0]
    np.testing.assert_array_equal(out, [0, 1, 2, 3])
    assert pos == 2
    np.testing.assert_array_equal(out2, [4, 5])
    return out, pos, out2


def test_derived_etype_pointer_advance(tmp_path):
    both(_derived_etype_pointer_advance, tmp_path)


def _seek_end_strided_view(M, d):
    path = str(d / "o.dat")
    np.zeros(24, dtype=np.int32).tofile(path)

    def body(comm):
        ft = M.dt.INT32.vector(1, 2, 6).resized(24).commit()
        f = M.mio.File.open(comm, path)
        f.set_view(0, M.dt.INT32, ft)
        f.seek(0, M.mio.SEEK_END)
        pos = f.get_position()
        f.close()
        return pos

    res = M.run(1, body)
    assert res[0] == 8
    return res


def test_seek_end_strided_view(tmp_path):
    both(_seek_end_strided_view, tmp_path)


def _append_starts_pointers_at_eof(M, d):
    path = str(d / "p.dat")
    np.arange(4, dtype=np.uint8).tofile(path)

    def body(comm):
        f = M.mio.File.open(comm, path, M.mio.MODE_RDWR | M.mio.MODE_APPEND)
        assert f.get_position() == 4
        assert f.get_position_shared() == 4
        f.write_shared(np.array([99], np.uint8))
        f.close()

    M.run(1, body)
    got = np.fromfile(path, dtype=np.uint8)
    np.testing.assert_array_equal(got, [0, 1, 2, 3, 99])
    return got


def test_append_starts_pointers_at_eof(tmp_path):
    both(_append_starts_pointers_at_eof, tmp_path)


def _failed_shared_access_does_not_advance(M, d):
    path = str(d / "q.dat")

    def body(comm):
        f = M.mio.File.open(comm, path,
                            M.mio.MODE_CREATE | M.mio.MODE_WRONLY)
        f.set_view(0, M.dt.INT32)
        try:
            f.read_shared(5)
        except M.MPIException:
            pass
        pos = f.get_position_shared()
        try:
            f.seek_shared(3, whence=7)
        except M.MPIException:
            pass
        pos2 = f.get_position_shared()
        f.close()
        return pos, pos2

    res = M.run(1, body)
    assert res[0] == (0, 0)
    return res


def test_failed_shared_access_does_not_advance(tmp_path):
    both(_failed_shared_access_does_not_advance, tmp_path)


def _seek_shared(M, d):
    path = str(d / "m.dat")
    np.arange(8, dtype=np.int64).tofile(path)

    def body(comm):
        f = M.mio.File.open(comm, path)
        f.set_view(0, M.dt.INT64)
        f.seek_shared(4)
        comm.barrier()
        assert f.get_position_shared() == 4
        pos = f.get_position_shared()
        f.close()
        return pos

    return M.run(2, body)


def test_seek_shared(tmp_path):
    both(_seek_shared, tmp_path)


# ---------------------------------------------------------------------------
# sharedfp/individual (relaxed shared-pointer semantics, opt-in)
# ---------------------------------------------------------------------------

def _individual_sharedfp(case):
    """Run ``case`` with ``io_sharedfp=individual`` in the package."""
    def run(M, d):
        M.vars.set("io_sharedfp", "individual")
        try:
            return case(M, d)
        finally:
            M.vars.set("io_sharedfp", "")
    return run


@_individual_sharedfp
def _sharedfp_individual_merge_order(M, d):
    path = str(d / "ind.dat")

    def body(comm):
        f = M.mio.File.open(comm, path, M.mio.MODE_RDWR | M.mio.MODE_CREATE)
        f.set_view(0, M.dt.INT32)
        for round_ in range(2):
            for r in range(comm.size):
                if comm.rank == r:
                    f.write_shared(np.full(2, 10 * round_ + r, np.int32))
                comm.barrier()
        before = os.path.getsize(path) if comm.rank == 0 else -1
        comm.barrier()
        f.close()
        return before

    sizes = M.run(3, body)
    assert sizes[0] == 0
    raw = np.fromfile(path, dtype=np.int32)
    want = []
    for round_ in range(2):
        for r in range(3):
            want.extend([10 * round_ + r] * 2)
    np.testing.assert_array_equal(raw, np.array(want, np.int32))
    return sizes


def test_sharedfp_individual_merge_order(tmp_path):
    both(_sharedfp_individual_merge_order, tmp_path)


@_individual_sharedfp
def _sharedfp_individual_reads_erroneous(M, d):
    path = str(d / "ind2.dat")

    def body(comm):
        f = M.mio.File.open(comm, path, M.mio.MODE_RDWR | M.mio.MODE_CREATE)
        errs = 0
        for fn in (lambda: f.read_shared(1),
                   lambda: f.seek_shared(0),
                   lambda: f.get_position_shared()):
            try:
                fn()
            except M.MPIException:
                errs += 1
        comm.barrier()
        f.close()
        return errs

    res = M.run(2, body)
    assert res == [3, 3]
    return res


def test_sharedfp_individual_reads_erroneous(tmp_path):
    both(_sharedfp_individual_reads_erroneous, tmp_path)


@_individual_sharedfp
def _sharedfp_individual_ordered_after_shared(M, d):
    path = str(d / "ind3.dat")

    def body(comm):
        f = M.mio.File.open(comm, path, M.mio.MODE_RDWR | M.mio.MODE_CREATE)
        f.set_view(0, M.dt.INT32)
        for r in range(comm.size):
            if comm.rank == r:
                f.write_shared(np.full(1, 100 + r, np.int32))
            comm.barrier()
        f.write_ordered(np.full(2, comm.rank, np.int32))
        out = f.read_at(0, comm.size + 2 * comm.size) \
            if comm.rank == 0 else None
        f.close()
        return out

    results = M.run(2, body)
    np.testing.assert_array_equal(
        results[0], np.array([100, 101, 0, 0, 1, 1], np.int32))
    return results


def test_sharedfp_individual_ordered_after_shared(tmp_path):
    both(_sharedfp_individual_ordered_after_shared, tmp_path)


@_individual_sharedfp
def _sharedfp_individual_sync_lands_pending(M, d):
    path = str(d / "ind4.dat")

    def body(comm):
        f = M.mio.File.open(comm, path, M.mio.MODE_RDWR | M.mio.MODE_CREATE)
        f.set_view(0, M.dt.INT32)
        f.write_shared(np.full(1, comm.rank, np.int32))
        comm.barrier()
        f.sync()
        mid = np.fromfile(path, dtype=np.int32).size \
            if comm.rank == 0 else -1
        comm.barrier()
        f.write_shared(np.full(1, 10 + comm.rank, np.int32))
        comm.barrier()
        f.close()
        return mid

    mids = M.run(2, body)
    assert mids[0] == 2
    raw = np.fromfile(path, dtype=np.int32)
    assert raw.size == 4
    assert sorted(raw[:2]) == [0, 1]
    assert sorted(raw[2:]) == [10, 11]
    os.unlink(path)      # timestamps order the rounds' ranks: sorted above
    return mids, sorted(raw[:2].tolist()), sorted(raw[2:].tolist())


def test_sharedfp_individual_sync_lands_pending(tmp_path):
    both(_sharedfp_individual_sync_lands_pending, tmp_path)


# ---------------------------------------------------------------------------
# the vectorized hot paths (tests/mpi/test_io_vectorized.py)
# ---------------------------------------------------------------------------

def naive_byte_runs(view, offset_etypes: int, nbytes: int):
    """The original per-run descriptor walk (reference model)."""
    start = offset_etypes * view.etype.size
    if nbytes <= 0:
        return []
    out = []
    pos, end = start, start + nbytes
    while pos < end:
        tile, within = divmod(pos, view._tile_bytes)
        ri = int(np.searchsorted(view._run_cum, within, "right")) - 1
        run_off = within - int(view._run_cum[ri])
        take = min(int(view._run_lens[ri]) - run_off, end - pos)
        fpos = (view.disp + tile * view._tile_extent
                + int(view._run_starts[ri]) + run_off)
        if out and out[-1][0] + out[-1][1] == fpos:
            out[-1] = (out[-1][0], out[-1][1] + take)
        else:
            out.append((fpos, take))
        pos += take
    return out


_FILETYPES = {
    "vector": lambda dt: dt.DOUBLE.vector(7, 2, 5),
    "hindexed_monotone": lambda dt: dt.DOUBLE.hindexed([2, 1, 3],
                                                       [0, 32, 56]),
    "hindexed_nonmonotone": lambda dt: dt.DOUBLE.hindexed([1, 2, 1],
                                                          [48, 8, 0]),
    "indexed_block": lambda dt: dt.DOUBLE.indexed_block(2, [0, 4, 9]),
}


def _byte_runs_matches_naive_walk(M, d, ft_name):
    ft = _FILETYPES[ft_name](M.dt)
    view = M.mio.FileView(16, M.dt.DOUBLE, ft)
    out = []
    for off_e, nbytes in [(0, ft.size), (1, ft.size - 8),
                          (0, 3 * ft.size), (2, 2 * ft.size + 8),
                          (5, 8), (0, 8), (3, 5 * ft.size)]:
        got = view.byte_runs(off_e, nbytes)
        want = naive_byte_runs(view, off_e, nbytes)
        assert [tuple(g) for g in got] == want, (ft_name, off_e, nbytes)
        out.append([tuple(g) for g in got])
    return out


@pytest.mark.parametrize("ft_name", sorted(_FILETYPES))
def test_byte_runs_matches_naive_walk(tmp_path, ft_name):
    both(_byte_runs_matches_naive_walk, tmp_path, ft_name)


def _nonmonotone_view_collective_roundtrip(M, d):
    path = str(d / "nm.bin")
    old = M.vars.get("io_fcoll")

    def body(comm):
        backs = []
        try:
            for comp in ("two_phase", "dynamic", "static"):
                M.vars.set("io_fcoll", comp)
                ft = M.dt.DOUBLE.hindexed([1, 1, 1], [48, 8, 0])
                f = M.mio.File.open(comm, path,
                                    M.mio.MODE_RDWR | M.mio.MODE_CREATE)
                f.set_view(disp=200 * comm.rank, etype=M.dt.DOUBLE,
                           filetype=ft)
                data = (np.arange(9, dtype=np.float64)
                        + 100 * comm.rank + ord(comp[0]))
                n = f.write_at_all(0, data)
                assert n == data.size
                back = f.read_at_all(0, data.size)
                f.close()
                np.testing.assert_array_equal(back, data, err_msg=comp)
                backs.append(back)
                comm.barrier()
            return backs
        finally:
            M.vars.set("io_fcoll", old or "")

    return M.run(3, body, timeout=180.0)


def test_nonmonotone_view_collective_roundtrip(tmp_path):
    both(_nonmonotone_view_collective_roundtrip, tmp_path)


def _collective_read_past_eof_truncates(M, d):
    path = str(d / "eof.bin")
    old = M.vars.get("io_fcoll")

    def body(comm):
        try:
            M.vars.set("io_fcoll", "two_phase")
            f = M.mio.File.open(comm, path,
                                M.mio.MODE_RDWR | M.mio.MODE_CREATE)
            ft = M.dt.FLOAT.vector(6, 1, 3)
            f.set_view(disp=4 * comm.rank, etype=M.dt.FLOAT, filetype=ft)
            data = np.arange(6, dtype=np.float32) + comm.rank
            f.write_at_all(0, data)
            comm.barrier()
            back = f.read_at_all(0, 12)
            f.close()
            np.testing.assert_array_equal(back[:6], data)
            assert len(back) <= 12
            return back
        finally:
            M.vars.set("io_fcoll", old or "")

    return M.run(3, body, timeout=180.0)


def test_collective_read_past_eof_truncates(tmp_path):
    both(_collective_read_past_eof_truncates, tmp_path)


def _zero_blocklength_runs_dropped(M, d):
    t = M.dt.INT32.indexed([2, 0], [0, 100]).commit()
    assert t.segments() == [(0, 8)]
    assert M.dt.min_span(t, 1) == 8
    assert t.get_true_extent() == (0, 8)
    packed = t.pack(np.arange(2, dtype=np.int32), 1)
    assert len(packed) == 8
    out = np.zeros(2, np.int32)
    t.unpack(packed, out, 1)
    np.testing.assert_array_equal(out, [0, 1])
    return np.frombuffer(packed, np.uint8), out


def test_zero_blocklength_runs_dropped(tmp_path):
    both(_zero_blocklength_runs_dropped, tmp_path)


def _single_run_pread_eof_short(M, d):
    path = str(d / "short.bin")

    def body(comm):
        f = M.mio.File.open(comm, path, M.mio.MODE_RDWR | M.mio.MODE_CREATE)
        f.set_view(disp=0, etype=M.dt.DOUBLE)
        data = np.arange(10, dtype=np.float64)
        f.write_at(0, data)
        back = f.read_at(0, 20)
        np.testing.assert_array_equal(back, data)
        ft = M.dt.DOUBLE.vector(3, 2, 4)
        f.set_view(disp=64, etype=M.dt.DOUBLE, filetype=ft)
        assert len(f.view.byte_runs(0, 16)) == 1
        got = f.read_at(0, 2)
        np.testing.assert_array_equal(got, [8.0, 9.0])
        got2 = f.read_at(0, 4)
        np.testing.assert_array_equal(got2, [8.0, 9.0])
        f.close()
        return back, got, got2

    return M.run(1, body, timeout=60.0)


def test_single_run_pread_eof_short(tmp_path):
    both(_single_run_pread_eof_short, tmp_path)


def _eof_short_strided_read_matches_reference_walk(M, d):
    path = str(d / "strided_eof.bin")

    def body(comm):
        f = M.mio.File.open(comm, path, M.mio.MODE_RDWR | M.mio.MODE_CREATE)
        f.set_view(disp=0, etype=M.dt.DOUBLE)
        f.write_at(0, np.arange(11, dtype=np.float64))
        ft = M.dt.DOUBLE.vector(4, 1, 3)
        f.set_view(disp=0, etype=M.dt.DOUBLE, filetype=ft)
        got = f.read_at(0, 8)
        want = bytearray()
        for off, ln in naive_byte_runs(f.view, 0, 64):
            want += os.pread(f._fd, ln, off)
        f.close()
        np.testing.assert_array_equal(
            got, np.frombuffer(bytes(want), np.float64))
        return got

    return M.run(1, body, timeout=60.0)


def test_eof_short_strided_read_matches_reference_walk(tmp_path):
    both(_eof_short_strided_read_matches_reference_walk, tmp_path)


def _as_bytes_zero_copy_contract(M, d):
    path = str(d / "zc.bin")

    def body(comm):
        f = M.mio.File.open(comm, path, M.mio.MODE_RDWR | M.mio.MODE_CREATE)
        arr = np.arange(6, dtype=np.uint8)
        raw = f._as_bytes(arr)
        assert isinstance(raw, memoryview)
        arr[0] = 99
        assert raw[0] == 99
        raw2 = f._as_bytes(np.arange(4, dtype=np.float32))
        assert len(raw2) == 4
        assert isinstance(
            f._as_bytes(np.arange(8, dtype=np.uint8)[::2]), bytes)
        f.set_view(disp=0, etype=M.mio.dt_mod.INT32, datarep="external32")
        ext = f._as_bytes(np.arange(3, dtype=np.int32))
        assert isinstance(ext, bytes)
        f.close()
        return bytes(raw), bytes(raw2), ext

    return M.run(1, body, timeout=60.0)


def test_as_bytes_zero_copy_contract(tmp_path):
    both(_as_bytes_zero_copy_contract, tmp_path)


def _payload_prefix_nonmonotone_filetype(M, d):
    ft = M.dt.BYTE.indexed([4, 4], [100, 0])
    v = M.mio.FileView(0, M.dt.BYTE, ft)
    assert v.payload_bytes_up_to(50) == 0
    assert v.payload_bytes_up_to(102) == 6
    assert v.payload_bytes_up_to(104) == 8
    return [v.payload_bytes_up_to(n) for n in (50, 100, 102, 104, 300)]


def test_payload_prefix_nonmonotone_filetype(tmp_path):
    both(_payload_prefix_nonmonotone_filetype, tmp_path)


# ---------------------------------------------------------------------------
# the port's own: tensors as write buffers, staging, the sm segments
# ---------------------------------------------------------------------------

def test_tensors_write_the_bytes_numpy_writes(tmp_path):
    """A CPU tensor (viewed in place), a non-contiguous one, an int64
    tensor through an INT32 view (converted, as numpy's astype does) and
    bf16 through BFLOAT16 and BYTE views (its bits, never converted) write
    the file the JAX package writes from the numpy data."""
    torch = pytest.importorskip("torch")
    import ml_dtypes

    rng = np.random.default_rng(5)
    f32 = rng.normal(size=(6, 4)).astype(np.float32)
    bits = f32.astype(ml_dtypes.bfloat16)

    def case(M, d, data):
        path = str(d / "t.bin")

        def body(comm):
            f = M.mio.File.open(comm, path,
                                M.mio.MODE_RDWR | M.mio.MODE_CREATE)
            f.set_view(0, M.dt.FLOAT32)
            f.write_at_all(0, data["f32"])
            f.write_at(24, data["cols"])
            f.set_view(0, M.dt.INT32)
            f.write_at(40, data["i64"])
            f.set_view(0, M.dt.BFLOAT16)
            f.write_at(96, data["bf16"])
            back = f.read_at(96, 24)
            f.set_view(0, M.dt.BYTE)
            f.write_at(256, data["bf16"])
            f.close()
            return back.view(np.uint16)

        return M.run(1, body)

    i64 = np.arange(-3, 5, dtype=np.int64)
    numpy_data = {"f32": f32, "cols": np.ascontiguousarray(f32.T[1]),
                  "i64": i64, "bf16": bits}
    t = torch.from_numpy(f32.copy())
    tensor_data = {"f32": t, "cols": t.t()[1], "i64": torch.from_numpy(i64),
                   "bf16": torch.from_numpy(f32.copy()).to(torch.bfloat16)}
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    (tmp_path / "portnp").mkdir()
    want = case(J, tmp_path / "jax", numpy_data)
    got = case(P, tmp_path / "port", tensor_data)
    numpy_bf16 = dict(numpy_data, bf16=bits.view(np.uint16))
    got_np = case(P, tmp_path / "portnp", numpy_bf16)
    _same(want, got)
    _same(want, got_np)
    jfile = _files(tmp_path / "jax")["t.bin"]
    pfile = _files(tmp_path / "port")["t.bin"]
    # through the FLOAT32, INT32 and BFLOAT16 views: the JAX package's file
    assert pfile[:256] == jfile[:256]
    assert _files(tmp_path / "portnp")["t.bin"][:256] == jfile[:256]
    # through the BYTE view the JAX package converts the bf16 VALUES
    # (astype); the port writes a bf16 tensor's bits, never its values
    assert pfile[256:] == bits.tobytes()
    assert jfile[256:] == bits.astype(np.uint8).tobytes()


def test_iwrite_at_all_keeps_the_values_of_call_time(tmp_path):
    """The nonblocking write stages a tensor's bytes in the caller's
    thread: changing the tensor in place before ``wait()`` does not reach
    the file, which holds what the JAX package's file holds."""
    torch = pytest.importorskip("torch")

    def case(M, d, make, bump):
        path = str(d / "nb.bin")

        def body(comm):
            f = M.mio.File.open(comm, path,
                                M.mio.MODE_RDWR | M.mio.MODE_CREATE)
            f.set_view(etype=M.dt.FLOAT64)
            buf = make(comm.rank)
            reqs = []
            for i in range(3):
                reqs.append(f.iwrite_at_all(comm.rank * 12 + 4 * i, buf))
                bump(buf)         # changed in place before the wait
            f.write_at_all_begin(comm.rank * 12 + 24 * 2, buf)
            bump(buf)
            n = f.write_at_all_end()
            got = [r.wait(timeout=30) for r in reqs] + [n]
            f.close()
            return got

        return M.run(2, body)

    jres = case(J, _mk(tmp_path, "jax"),
                lambda r: np.arange(4, dtype=np.float64) + 10 * r,
                lambda b: None)
    # the JAX package's arrays are not changed: the file holds call-time
    # values by construction; the port's tensor is bumped after each call
    vals = {}

    def make(r):
        t = torch.arange(4, dtype=torch.float64) + 10 * r
        vals[r] = t
        return t

    calls = {"n": 0}

    def bump(t):
        calls["n"] += 1
        t.add_(1000.0)

    pres = case(P, _mk(tmp_path, "port"), make, bump)
    assert jres == pres == [[4, 4, 4, 4]] * 2
    jf = np.fromfile(tmp_path / "jax" / "nb.bin", np.float64)
    pf = np.fromfile(tmp_path / "port" / "nb.bin", np.float64)
    assert calls["n"] == 8
    assert [float(vals[r][0]) for r in range(2)] == [4000.0, 4010.0]
    # the jax run wrote the unbumped values at every call: so must the
    # port's first call; each later call wrote what it saw at call time
    for r in range(2):
        for i in range(3):
            lo = r * 12 + 4 * i
            np.testing.assert_array_equal(
                pf[lo:lo + 4], jf[lo:lo + 4] + 1000.0 * i)
        lo = r * 12 + 48
        np.testing.assert_array_equal(pf[lo:lo + 4], jf[lo:lo + 4] + 3000.0)


def _mk(tmp_path, name):
    d = tmp_path / name
    d.mkdir()
    return d


def _shfp_segments(path: str) -> list:
    """The ``otpu-shfp-*`` segments of opens of ``path`` (named from the
    path's crc; other tests' opens, in other workers, name others)."""
    import zlib

    crc = zlib.crc32(os.path.abspath(path).encode())
    return sorted(glob.glob(f"/dev/shm/otpu-shfp-{os.getuid()}-{crc:08x}-*"))


@pytest.mark.skipif(not os.path.isdir("/dev/shm"), reason="no /dev/shm")
def test_sm_segments_are_kept_apart_and_removed(tmp_path):
    """Both packages open one path with the sm shared pointer at once in
    one process: the per-open nonce keeps their segments apart, each
    package's pointer counts its own writes, and close leaves no
    ``otpu-shfp-*`` segment behind."""
    from ompi_tpu import _native as jnative
    from ompi_tpu_torch import _native as pnative

    if jnative.fastdss() is None or pnative.fastdss() is None:
        pytest.skip("native atomics unavailable")
    path = str(tmp_path / "shared.bin")
    before = _shfp_segments(path)
    opened = {}

    def body(M, comm, n):
        f = M.mio.File.open(comm, path, M.mio.MODE_RDWR | M.mio.MODE_CREATE)
        assert f._shfp.name == "sm"
        opened.setdefault(M.name, f._shfp._path())
        f.set_view(0, M.dt.INT32)
        for _ in range(n):
            f.write_shared(np.full(2, comm.rank, np.int32))
        comm.barrier()
        pos = f.get_position_shared()
        comm.barrier()
        if comm.rank == 0:
            opened.setdefault("during", _shfp_segments(path))
        comm.barrier()
        f.close()
        return pos

    import threading

    out = {}
    tj = threading.Thread(target=lambda: out.setdefault(
        "jax", jrun(2, lambda c: body(J, c, 3))))
    tj.start()
    out["port"] = prun(2, lambda c: body(P, c, 5))
    tj.join(60)
    assert out["jax"] == [12, 12] and out["port"] == [20, 20]
    assert opened["jax"] != opened["port"]
    assert opened["during"] and before == []
    assert _shfp_segments(path) == []


def test_file_imports_no_torch_for_numpy_io(tmp_path):
    """A subprocess writes and reads numpy data through the port's
    ``File`` on one rank: torch never enters ``sys.modules``."""
    import subprocess
    import sys

    code = (
        "import sys, numpy as np\n"
        "from ompi_tpu_torch.mpi import io, datatype as dt\n"
        "from tests.torch_host_harness import run_ranks\n"
        f"p = {str(tmp_path / 'x.bin')!r}\n"
        "def body(c):\n"
        "    f = io.File.open(c, p, io.MODE_RDWR | io.MODE_CREATE)\n"
        "    f.set_view(0, dt.FLOAT32)\n"
        "    f.write_at_all(c.rank * 4, np.full(4, c.rank, np.float32))\n"
        "    r = f.iwrite_at_all(8 + c.rank * 4, np.ones(4, np.float32))\n"
        "    r.wait()\n"
        "    out = f.read_at_all(0, 16)\n"
        "    f.close()\n"
        "    return out\n"
        "res = run_ranks(2, body)\n"
        "assert res[0].tolist() == [0.0] * 4 + [1.0] * 12, res\n"
        "print('torch' in sys.modules, 'jax' in sys.modules)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=root, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.split() == ["False", "False"]


def test_mpiio_darray_example_under_the_launcher():
    """The port's ``examples/mpiio_darray`` under ``tpurun -np 4`` prints
    the marker of the repo's ``examples/mpiio_darray.py``."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.run(
        [sys.executable, "-m", "ompi_tpu_torch.tools.tpurun", "-np", "4",
         "--timeout", "90", "--", sys.executable, "-m",
         "ompi_tpu_torch.examples.mpiio_darray"],
        cwd=root, capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "darray collective IO ok" in p.stdout
