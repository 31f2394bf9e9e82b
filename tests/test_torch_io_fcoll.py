"""The port's collective-IO components (the fcoll framework of
``ompi_tpu_torch.mpi.io``), its sharedfp components, split and
nonblocking collectives, datareps and file accessors against the JAX
package's.

Each case mirrors one of ``tests/mpi/test_io_fcoll.py``,
``tests/mpi/test_io_fuzz.py`` (the same seeds and plan),
the six IO cases of ``tests/mpi/test_api_parity3.py`` or
``test_file_errhandler_and_info`` of ``tests/mpi/test_objects.py``, with
every assertion kept.  The case runs once through each package (its
``io``, ``datatype``, ``info``, ``errhandler``, variable registry and
in-process harness) on the same numpy inputs in its own directory; the
ranks' results and the files must be equal byte for byte.  Variables and
the ``_io_host_override`` placement hook are set inside the case, where
the reference's tests set them, and restored.
"""

from __future__ import annotations

import os
import types

import numpy as np
import pytest

from ompi_tpu import _native as jnative
from ompi_tpu.core.config import var_registry as jvars
from ompi_tpu.mpi import datatype as jdt
from ompi_tpu.mpi import errhandler as jeh
from ompi_tpu.mpi import info as jinfo
from ompi_tpu.mpi import io as jio
from ompi_tpu.mpi.constants import MPIException as JMPIException
from ompi_tpu_torch import _native as pnative
from ompi_tpu_torch.core.config import var_registry as pvars
from ompi_tpu_torch.mpi import datatype as pdt
from ompi_tpu_torch.mpi import errhandler as peh
from ompi_tpu_torch.mpi import info as pinfo
from ompi_tpu_torch.mpi import io as pio
from ompi_tpu_torch.mpi.constants import MPIException as PMPIException
from tests.mpi.harness import run_ranks as jrun
from tests.test_torch_io import _files
from tests.test_torch_host_p2p import _same
from tests.torch_host_harness import run_ranks as prun

J = types.SimpleNamespace(name="jax", mio=jio, dt=jdt, vars=jvars,
                          Info=jinfo.Info, eh=jeh, native=jnative,
                          MPIException=JMPIException, run=jrun)
P = types.SimpleNamespace(name="port", mio=pio, dt=pdt, vars=pvars,
                          Info=pinfo.Info, eh=peh, native=pnative,
                          MPIException=PMPIException, run=prun)


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


def _fcoll(M, comp):
    """Set ``io_fcoll`` in the package; returns the restore."""
    old = M.vars.get("io_fcoll")
    M.vars.set("io_fcoll", comp)
    return lambda: M.vars.set("io_fcoll", old or "")


def _strided_write(M, comm, path, hosts=None, info=None):
    if hosts is not None:
        comm._io_host_override = hosts[comm.rank]
    size = comm.size
    f = M.mio.File.open(comm, path, M.mio.MODE_RDWR | M.mio.MODE_CREATE,
                        info=info)
    ft = M.dt.FLOAT.vector(16, 1, size)
    f.set_view(disp=4 * comm.rank, etype=M.dt.FLOAT, filetype=ft)
    data = np.full(16, comm.rank, np.float32)
    n = f.write_at_all(0, data)
    assert n == 16
    f.close()
    comm.barrier()
    return np.fromfile(path, np.float32).reshape(16, size)


def _check(mat, size):
    for c in range(size):
        np.testing.assert_array_equal(mat[:, c], np.full(16, c, np.float32))


# ---------------------------------------------------------------------------
# tests/mpi/test_io_fcoll.py
# ---------------------------------------------------------------------------

def _forced_components_correct(M, d, comp):
    path = str(d / f"m_{comp}.bin")
    restore = _fcoll(M, comp)
    try:
        res = M.run(4, lambda comm: _strided_write(M, comm, path))
    finally:
        restore()
    _check(np.fromfile(path, np.float32).reshape(16, 4), 4)
    return res


@pytest.mark.parametrize("comp", ["two_phase", "dynamic", "individual",
                                  "static", "dynamic_gen2"])
def test_forced_components_correct(tmp_path, comp):
    both(_forced_components_correct, tmp_path, comp)


def _unknown_component_raises(M, d):
    restore = _fcoll(M, "bogus")
    path = str(d / "x.bin")

    def body(comm):
        with pytest.raises(M.MPIException, match="bogus"):
            _strided_write(M, comm, path)
        return None

    try:
        return M.run(2, body)
    finally:
        restore()


def test_unknown_component_raises(tmp_path):
    both(_unknown_component_raises, tmp_path)


def _host_aware_aggregators(M, d):
    path = str(d / "hosts.bin")
    hosts = ["nodeA", "nodeA", "nodeB", "nodeB"]
    seen = {}

    def body(comm):
        comm._io_host_override = hosts[comm.rank]
        f = M.mio.File.open(comm, path, M.mio.MODE_RDWR | M.mio.MODE_CREATE)
        seen[comm.rank] = f._aggregators()
        f.close()
        return _strided_write(M, comm, path, hosts=hosts)

    res = M.run(4, body)
    assert seen[0] == [0, 2]
    assert all(v == [0, 2] for v in seen.values())
    _check(np.fromfile(path, np.float32).reshape(16, 4), 4)
    return res, dict(sorted(seen.items()))


def test_host_aware_aggregators(tmp_path):
    both(_host_aware_aggregators, tmp_path)


def _cb_nodes_hint_caps_aggregators(M, d):
    path = str(d / "cap.bin")
    hosts = ["a", "b", "c", "d"]

    def body(comm):
        comm._io_host_override = hosts[comm.rank]
        f = M.mio.File.open(comm, path, M.mio.MODE_RDWR | M.mio.MODE_CREATE,
                            info=M.Info({"cb_nodes": "2"}))
        aggs = f._aggregators()
        f.close()
        return aggs

    out = M.run(4, body)
    assert all(a == [0, 1] for a in out)
    return out


def test_cb_nodes_hint_caps_aggregators(tmp_path):
    both(_cb_nodes_hint_caps_aggregators, tmp_path)


def _collective_buffering_hint_disables(M, d):
    path = str(d / "nobuf.bin")

    def body(comm):
        f = M.mio.File.open(comm, path, M.mio.MODE_RDWR | M.mio.MODE_CREATE,
                            info=M.Info({"collective_buffering": "false"}))
        comp = f._fcoll_component(64, [(0, 4), (8, 4)])
        f.close()
        return comp

    out = M.run(2, body)
    assert out == ["individual", "individual"]
    return out


def test_collective_buffering_hint_disables(tmp_path):
    both(_collective_buffering_hint_disables, tmp_path)


def _auto_decision_skew_picks_dynamic(M, d):
    path = str(d / "skew.bin")

    def body(comm):
        f = M.mio.File.open(comm, path, M.mio.MODE_RDWR | M.mio.MODE_CREATE)
        nbytes = 8192 if comm.rank == 0 else 512
        runs = [(comm.rank * 64, 32), (4096 + comm.rank * 64, 32)]
        comp = f._fcoll_component(nbytes, runs)
        f.close()
        return comp

    out = M.run(4, body)
    assert out == ["dynamic"] * 4
    return out


def test_auto_decision_skew_picks_dynamic(tmp_path):
    assert pio._fs_type(str(tmp_path)) == jio._fs_type(str(tmp_path))
    both(_auto_decision_skew_picks_dynamic, tmp_path)


def _dynamic_domain_bounds_balance(M, d):
    path = str(d / "bal.bin")

    def body(comm):
        f = M.mio.File.open(comm, path, M.mio.MODE_RDWR | M.mio.MODE_CREATE)
        runs = [(comm.rank * 1024, 1024)]
        if comm.rank == 0:
            runs.append((1 << 20, 1024))
        bounds = f._domain_bounds("dynamic", runs, 2)
        f.close()
        return bounds

    out = M.run(2, body)
    b = out[0]
    assert b[0] == 0 and b[-1] == (1 << 20) + 1024
    assert b[1] <= 2048
    return out


def test_dynamic_domain_bounds_balance(tmp_path):
    both(_dynamic_domain_bounds_balance, tmp_path)


def _fs_type_detection(M, d):
    t = M.mio._fs_type("/dev/shm") if os.path.isdir("/dev/shm") else None
    if t is not None:
        assert t in ("tmpfs", "ramfs"), t
    assert isinstance(M.mio._fs_type(str(d)), str)
    return t, M.mio._fs_type(str(d)), M.mio._fs_type("/")


def test_fs_type_detection(tmp_path):
    both(_fs_type_detection, tmp_path)


def _fs_adaptive_memory_backed_prefers_individual(M, d):
    import shutil
    import tempfile

    sd = tempfile.mkdtemp(dir="/dev/shm")
    path = os.path.join(sd, "m.bin")

    def body(comm):
        f = M.mio.File.open(comm, path, M.mio.MODE_RDWR | M.mio.MODE_CREATE)
        assert f.fs_type in ("tmpfs", "ramfs")
        strided = [(comm.rank * 64 + i * 256, 64) for i in range(16)]
        comp = f._fcoll_component(1024, strided)
        f.fs_type = "ext4"
        comp_disk = f._fcoll_component(1024, strided)
        f.close()
        return comp, comp_disk

    try:
        out = M.run(2, body)
    finally:
        shutil.rmtree(sd, ignore_errors=True)
    assert all(c == "individual" for c, _ in out)
    assert all(cd == "two_phase" for _, cd in out)
    return out


def test_fs_adaptive_memory_backed_prefers_individual(tmp_path):
    if not os.path.isdir("/dev/shm"):
        pytest.skip("no /dev/shm")
    both(_fs_adaptive_memory_backed_prefers_individual, tmp_path)


def _large_strided_roundtrip_all_components(M, d):
    path = str(d / "mix.bin")
    restore = _fcoll(M, "dynamic_gen2")
    try:
        M.run(4, lambda comm: _strided_write(M, comm, path))
        M.vars.set("io_fcoll", "static")

        def rd(comm):
            size = comm.size
            f = M.mio.File.open(comm, path, M.mio.MODE_RDONLY)
            ft = M.dt.FLOAT.vector(16, 1, size)
            f.set_view(disp=4 * comm.rank, etype=M.dt.FLOAT, filetype=ft)
            out = f.read_at_all(0, 16)
            f.close()
            np.testing.assert_array_equal(
                out, np.full(16, comm.rank, np.float32))
            return out

        return M.run(4, rd)
    finally:
        restore()


def test_large_strided_roundtrip_all_components(tmp_path):
    both(_large_strided_roundtrip_all_components, tmp_path)


def _sharedfp_components(M, d, comp):
    old = M.vars.get("io_sharedfp")
    M.vars.set("io_sharedfp", comp)
    path = str(d / f"sh_{comp}.bin")

    def body(comm):
        f = M.mio.File.open(comm, path, M.mio.MODE_RDWR | M.mio.MODE_CREATE)
        assert f._shfp.name == comp
        f.set_view(0, M.dt.INT32)
        f.write_shared(np.full(8, comm.rank, np.int32))
        comm.barrier()
        assert f.get_position_shared() == 32
        pos = f.get_position_shared()
        f.close()
        return pos

    try:
        res = M.run(4, body)
    finally:
        M.vars.set("io_sharedfp", old or "")
    blocks = np.fromfile(path, np.int32).reshape(4, 8)
    assert sorted(int(b[0]) for b in blocks) == [0, 1, 2, 3]
    for b in blocks:
        assert (b == b[0]).all()
    os.unlink(path)      # the ranks' order is the race's: sorted above
    return res, sorted(int(b[0]) for b in blocks)


@pytest.mark.parametrize("comp", ["sm", "lockedfile"])
def test_sharedfp_components(tmp_path, comp):
    if comp == "sm" and (jnative.fastdss() is None
                         or pnative.fastdss() is None):
        pytest.skip("native atomics unavailable")
    both(_sharedfp_components, tmp_path, comp)


def _sharedfp_auto_picks_sm_same_host(M, d):
    path = str(d / "auto.bin")

    def body(comm):
        f = M.mio.File.open(comm, path, M.mio.MODE_RDWR | M.mio.MODE_CREATE)
        name = f._shfp.name
        f.close()
        return name

    res = M.run(2, body)
    assert res == ["sm", "sm"]
    return res


def test_sharedfp_auto_picks_sm_same_host(tmp_path):
    if jnative.fastdss() is None or pnative.fastdss() is None:
        pytest.skip("native atomics unavailable")
    both(_sharedfp_auto_picks_sm_same_host, tmp_path)


def _sharedfp_auto_lockedfile_cross_host(M, d):
    path = str(d / "xhost.bin")
    hosts = ["hostA", "hostB"]

    def body(comm):
        comm._io_host_override = hosts[comm.rank]
        f = M.mio.File.open(comm, path, M.mio.MODE_RDWR | M.mio.MODE_CREATE)
        name = f._shfp.name
        f.close()
        return name

    res = M.run(2, body)
    assert res == ["lockedfile", "lockedfile"]
    return res


def test_sharedfp_auto_lockedfile_cross_host(tmp_path):
    both(_sharedfp_auto_lockedfile_cross_host, tmp_path)


def _static_routes_stripes_round_robin(M, d):
    path = str(d / "static.bin")
    old = M.vars.get("io_stripe_bytes")
    M.vars.set("io_stripe_bytes", 64)
    try:
        def body(comm):
            comm._io_host_override = f"h{comm.rank}"
            f = M.mio.File.open(comm, path,
                                M.mio.MODE_RDWR | M.mio.MODE_CREATE)
            my_runs = [(comm.rank * 256, 256)]
            aggs = f._aggregators()
            meta, _pay, order = f._route_to_aggregators(
                my_runs, [0, 1024], aggs, None, mode="static")
            f.close()
            for dest, take in order:
                assert take == 64
            for agg_rank, m in enumerate(meta):
                for off, ln in m:
                    assert (off // 64) % comm.size == agg_rank
            return [np.asarray(m, np.int64).reshape(-1, 2) for m in meta], \
                order

        res = M.run(4, body)
        assert all(res)
        return res
    finally:
        M.vars.set("io_stripe_bytes", old)


def test_static_routes_stripes_round_robin(tmp_path):
    both(_static_routes_stripes_round_robin, tmp_path)


def _dynamic_gen2_bounds_stripe_aligned(M, d):
    path = str(d / "gen2.bin")
    old = M.vars.get("io_stripe_bytes")
    M.vars.set("io_stripe_bytes", 128)
    try:
        def body(comm):
            comm._io_host_override = f"h{comm.rank}"
            f = M.mio.File.open(comm, path,
                                M.mio.MODE_RDWR | M.mio.MODE_CREATE)
            my_runs = [(comm.rank * 1000, (comm.rank + 1) * 100)]
            bounds = f._domain_bounds("dynamic_gen2", my_runs, comm.size)
            f.close()
            for b in bounds[1:-1]:
                assert b % 128 == 0 or b == bounds[0], bounds
            assert bounds == sorted(bounds)
            return bounds

        res = M.run(4, body)
        assert all(res)
        return res
    finally:
        M.vars.set("io_stripe_bytes", old)


def test_dynamic_gen2_bounds_stripe_aligned(tmp_path):
    both(_dynamic_gen2_bounds_stripe_aligned, tmp_path)


# ---------------------------------------------------------------------------
# tests/mpi/test_io_fuzz.py: the same seeds, the same plan
# ---------------------------------------------------------------------------

COMPONENTS = ["individual", "two_phase", "dynamic", "static",
              "dynamic_gen2"]


def _io_fuzz_strided_roundtrip(M, d, seed):
    rng = np.random.default_rng(seed)
    size = 4
    rounds = 4
    path = str(d / f"fuzz_{seed}.bin")
    plan = []
    for _ in range(rounds):
        count = int(rng.integers(4, 20))
        blocklen = int(rng.integers(1, 5))
        stride = blocklen * size
        wcomp = COMPONENTS[int(rng.integers(len(COMPONENTS)))]
        rcomp = COMPONENTS[int(rng.integers(len(COMPONENTS)))]
        base = float(rng.integers(1, 1000))
        plan.append((count, blocklen, stride, wcomp, rcomp, base))
    old = M.vars.get("io_fcoll")

    def body(comm):
        backs = []
        try:
            for count, blocklen, stride, wcomp, rcomp, base in plan:
                ft = M.dt.FLOAT.vector(count, blocklen, stride)
                data = np.full(count * blocklen, base + comm.rank,
                               np.float32)
                M.vars.set("io_fcoll", wcomp)
                f = M.mio.File.open(comm, path,
                                    M.mio.MODE_RDWR | M.mio.MODE_CREATE)
                f.set_view(disp=4 * blocklen * comm.rank, etype=M.dt.FLOAT,
                           filetype=ft)
                n = f.write_at_all(0, data)
                assert n == data.size
                f.close()
                comm.barrier()
                M.vars.set("io_fcoll", rcomp)
                f = M.mio.File.open(comm, path, M.mio.MODE_RDONLY)
                f.set_view(disp=4 * blocklen * comm.rank, etype=M.dt.FLOAT,
                           filetype=ft)
                back = f.read_at_all(0, data.size)
                f.close()
                np.testing.assert_array_equal(
                    np.asarray(back), data,
                    err_msg=f"write={wcomp} read={rcomp}")
                backs.append(np.asarray(back))
                comm.barrier()
            return backs
        finally:
            M.vars.set("io_fcoll", old or "")

    res = M.run(size, body, timeout=180.0)
    assert all(len(b) == rounds for b in res)
    got = np.fromfile(path, np.float32)
    count, blocklen, stride, _w, _r, base = plan[-1]
    for r in range(size):
        for c in range(count):
            lo = c * stride + r * blocklen
            np.testing.assert_array_equal(
                got[lo:lo + blocklen],
                np.full(blocklen, base + r, np.float32))
    return res, plan


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_io_fuzz_strided_roundtrip(tmp_path, seed):
    both(_io_fuzz_strided_roundtrip, tmp_path, seed)


# ---------------------------------------------------------------------------
# tests/mpi/test_api_parity3.py: split collectives, nonblocking
# collectives, datareps, accessors
# ---------------------------------------------------------------------------

def _split_collective_io(M, d):
    path = str(d / "split.bin")

    def fn(comm):
        f = M.mio.File.open(comm, path, M.mio.MODE_CREATE | M.mio.MODE_RDWR)
        f.set_view(etype=M.dt.INT32)
        f.write_at_all_begin(comm.rank * 4, np.full(4, comm.rank, np.int32))
        assert f.write_at_all_end() == 4
        f.read_at_all_begin(0, 4 * comm.size)
        got = f.read_at_all_end()
        with pytest.raises(M.MPIException):
            f.read_all_end()
        f.write_all_begin(np.zeros(0, np.int32))
        with pytest.raises(M.MPIException):
            f.read_all_begin(1)
        f.write_all_end()
        f.close()
        return got

    res = M.run(3, fn)
    expect = sum(([r] * 4 for r in range(3)), [])
    for r in range(3):
        assert list(res[r]) == expect
    return res


def test_split_collective_io(tmp_path):
    both(_split_collective_io, tmp_path)


def _nonblocking_collective_io(M, d):
    path = str(d / "nbc.bin")

    def fn(comm):
        f = M.mio.File.open(comm, path, M.mio.MODE_CREATE | M.mio.MODE_RDWR)
        f.set_view(etype=M.dt.FLOAT64)
        w = f.iwrite_at_all(comm.rank * 2,
                            np.array([comm.rank, comm.rank + 0.5]))
        assert w.wait(timeout=30) == 2
        r = f.iread_at_all(0, 2 * comm.size)
        got = r.wait(timeout=30)
        f.close()
        return got

    res = M.run(2, fn)
    assert list(res[0]) == [0.0, 0.5, 1.0, 1.5]
    return res


def test_nonblocking_collective_io(tmp_path):
    both(_nonblocking_collective_io, tmp_path)


def _nonblocking_io_isolated_from_user_collectives(M, d):
    path = str(d / "nbc_iso.bin")

    def fn(comm):
        f = M.mio.File.open(comm, path, M.mio.MODE_CREATE | M.mio.MODE_RDWR)
        f.set_view(etype=M.dt.FLOAT64)
        outs = []
        for i in range(5):
            w = f.iwrite_at_all(comm.rank * 2,
                                np.array([1.0 * i, 2.0 * i]))
            mine = np.array([comm.rank * 100 + i], np.int64)
            outs.append(np.asarray(comm.allgather(mine)).reshape(-1))
            assert w.wait(timeout=30) == 2
        f.close()
        return outs

    res = M.run(2, fn)
    for r, outs in enumerate(res):
        for i, got in enumerate(outs):
            assert list(got) == [i, 100 + i], (r, i, got)
    return res


def test_nonblocking_io_isolated_from_user_collectives(tmp_path):
    both(_nonblocking_io_isolated_from_user_collectives, tmp_path)


def _external32_datarep_roundtrip(M, d):
    path = str(d / "ext32.bin")

    def fn(comm):
        f = M.mio.File.open(comm, path, M.mio.MODE_CREATE | M.mio.MODE_RDWR)
        f.set_view(etype=M.dt.INT32, datarep="external32")
        f.write_at(0, np.array([0x01020304], np.int32))
        back = f.read_at(0, 1)
        f.close()
        return int(back[0])

    res = M.run(1, fn)
    assert res == [0x01020304]
    raw = open(path, "rb").read(4)
    assert raw == b"\x01\x02\x03\x04"
    return res


def test_external32_datarep_roundtrip(tmp_path):
    both(_external32_datarep_roundtrip, tmp_path)


def _register_datarep_user_conversion(M, d):
    name = "xor-55"
    if name not in M.mio._datareps:
        M.mio.register_datarep(
            name,
            read_conv=lambda raw, et: bytes(b ^ 0x55 for b in raw),
            write_conv=lambda raw, et: bytes(b ^ 0x55 for b in raw))
    with pytest.raises(M.MPIException):
        M.mio.register_datarep(name)
    path = str(d / "xor.bin")

    def fn(comm):
        f = M.mio.File.open(comm, path, M.mio.MODE_CREATE | M.mio.MODE_RDWR)
        f.set_view(datarep=name)
        f.write_at(0, np.frombuffer(b"hello", np.uint8))
        back = f.read_at(0, 5)
        f.close()
        return bytes(back)

    res = M.run(1, fn)
    assert res == [b"hello"]
    assert open(path, "rb").read(5) == bytes(b ^ 0x55 for b in b"hello")
    return res


def test_register_datarep_user_conversion(tmp_path):
    both(_register_datarep_user_conversion, tmp_path)


def _file_accessors(M, d):
    path = str(d / "acc.bin")

    def fn(comm):
        amode = M.mio.MODE_CREATE | M.mio.MODE_RDWR
        f = M.mio.File.open(comm, path, amode)
        assert f.get_amode() == amode
        assert f.get_group() is comm.group
        tile = M.dt.INT32.vector(2, 1, 2).commit()
        f.set_view(disp=8, etype=M.dt.INT32, filetype=tile)
        assert f.get_byte_offset(0) == 8
        assert f.get_byte_offset(1) == 8 + 2 * 4
        assert f.get_type_extent(tile) == tile.extent
        f.set_info(M.Info({"cb_nodes": "1"}))
        assert f.get_info().get("cb_nodes") == "1"
        f.close()
        return [f.get_byte_offset(i) for i in range(4)]

    res = M.run(1, fn)
    assert all(res)
    return res


def test_file_accessors(tmp_path):
    both(_file_accessors, tmp_path)


# ---------------------------------------------------------------------------
# tests/mpi/test_objects.py
# ---------------------------------------------------------------------------

def _file_errhandler_and_info(M, d):
    path = str(d / "x.dat")

    def body(comm):
        hints = M.Info({"cb_nodes": "2"})
        f = M.mio.File.open(comm, path, M.mio.MODE_CREATE | M.mio.MODE_RDWR,
                            info=hints)
        assert f.get_info().get("cb_nodes") == "2"
        assert f.get_errhandler() is M.eh.ERRORS_RETURN
        seen = []
        f.set_errhandler(M.eh.create_errhandler(
            lambda h, e: seen.append(1)))
        f.close()
        return True

    res = M.run(2, body)
    assert all(res)
    return res


def test_file_errhandler_and_info(tmp_path):
    both(_file_errhandler_and_info, tmp_path)
