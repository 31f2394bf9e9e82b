"""The port's one-sided device RMA (``ompi_tpu_torch.ops.remote_dma``)
against the JAX package's remote-DMA kernels.

Counterparts of ``tests/mpi/test_remote_dma.py``: the same inputs, made
with numpy from a seed, go through the JAX package on a 4-device sub-mesh
of the suite's virtual CPU devices (its Pallas kernels in interpret mode,
as that file runs them) and through the port on 4 rank processes (gloo,
``tests/torch_ranks.py``).  Every one-sided op is a copy, so every
comparison is exact (bitwise; bfloat16 compared as its bit pattern).

The kernels themselves run only on a CUDA card: the ``gpu``-marked tests
hold each one against its plain version there and skip here.  JAX is
imported only by the tests that compare with it, so the card's machine
(which has no JAX) runs the ``gpu`` tests of this file.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ompi_tpu_torch.mpi.constants import MPIException
from ompi_tpu_torch.ops import remote_dma as R
from tests import torch_ranks as TR

N = TR.WORLD


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


@pytest.fixture(scope="module")
def jmesh(jax):
    from ompi_tpu.parallel.mesh import make_mesh

    return make_mesh(devices=jax.devices()[:N])


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = TR.RankPool(tmp_path_factory.mktemp("ranks"))
    yield p
    p.close()


def _data(dtype: str, shape, seed: int) -> np.ndarray:
    """(N, *shape) per-rank data; bfloat16 as ml_dtypes values."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    full = (N,) + tuple(shape)
    if dtype == "int32":
        return rng.integers(-2**31, 2**31 - 1, size=full, dtype=np.int32)
    x = rng.standard_normal(full).astype(np.float32)
    return x.astype(jnp.bfloat16) if dtype == "bfloat16" else x


def _bits(a) -> np.ndarray:
    import jax.numpy as jnp

    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


def _sharded(mesh, arr):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    return jax.device_put(arr, NamedSharding(mesh, P("world")))


def _jax_run(mesh, body, *arrays):
    import jax
    from jax.sharding import PartitionSpec as P

    f = jax.jit(jax.shard_map(body, mesh=mesh,
                              in_specs=tuple(P("world") for _ in arrays),
                              out_specs=P("world"), check_vma=False))
    return np.asarray(f(*(_sharded(mesh, a) for a in arrays)))


def _J():
    from ompi_tpu.ops import remote_dma

    return remote_dma


def _port(pool, kind, win, dtype, value=None, **kw):
    """Every rank's (result, window) after one op, stacked over ranks."""
    per = [dict(kind=kind, win=_bits(win[r]), dtype=dtype,
                value=None if value is None else _bits(value[r]), **kw)
           for r in range(N)]
    res = pool.map(TR.one_sided, per)
    return (np.stack([o for o, _ in res]), np.stack([w for _, w in res]))


PUTS = [(3, 1, "float32", (8, 128)), (0, 2, "bfloat16", (8, 128)),
        (2, 0, "int32", (8, 128)), (1, 3, "float32", (7, 129)),
        (3, 0, "bfloat16", (7, 129))]


@pytest.mark.parametrize("src,dst,dtype,shape", PUTS)
def test_window_put_traced(jmesh, pool, src, dst, dtype, shape):
    win = np.zeros((N,) + shape, _data(dtype, (1,), 0).dtype)
    val = _data(dtype, shape, 1)
    want = _jax_run(jmesh, lambda w, v: _J().window_put(
        w[0], v[0], src=src, dst=dst, axis="world")[None], win, val)
    got, after = _port(pool, "put", win, dtype, val, src=src, dst=dst)
    np.testing.assert_array_equal(got, _bits(want))
    np.testing.assert_array_equal(after, _bits(want))   # in place
    assert np.array_equal(_bits(want)[dst], _bits(val)[src])


GETS = [(2, 0, "float32", (8, 128)), (1, 3, "bfloat16", (8, 128)),
        (3, 2, "int32", (7, 129)), (0, 1, "float32", (7, 129)),
        (2, 2, "float32", (8, 128))]


@pytest.mark.parametrize("src,dst,dtype,shape", GETS)
def test_window_get_traced(jmesh, pool, src, dst, dtype, shape):
    val = _data(dtype, shape, 2)
    want = _jax_run(jmesh, lambda v: _J().window_get(
        v[0], src=src, dst=dst, axis="world")[None], val)
    got, after = _port(pool, "get", val, dtype, src=src, dst=dst)
    np.testing.assert_array_equal(got, _bits(want))
    np.testing.assert_array_equal(after, _bits(val))    # windows untouched


@pytest.mark.parametrize("pe,dtype,shape", [(2, "float32", (8, 128)),
                                            (0, "bfloat16", (8, 128)),
                                            (3, "int32", (7, 129))])
def test_self_put(jmesh, pool, pe, dtype, shape):
    win = np.zeros((N,) + shape, _data(dtype, (1,), 0).dtype)
    val = _data(dtype, shape, 3)
    want = _jax_run(jmesh, lambda w, v: _J().window_put(
        w[0], v[0], src=pe, dst=pe, axis="world")[None], win, val)
    got, _ = _port(pool, "put", win, dtype, val, src=pe, dst=pe)
    np.testing.assert_array_equal(got, _bits(want))


@pytest.mark.parametrize("root,dtype,shape", [(0, "float32", (8, 128)),
                                              (1, "bfloat16", (8, 128)),
                                              (2, "int32", (7, 129)),
                                              (3, "float32", (7, 129))])
def test_fetch_bcast(jmesh, pool, root, dtype, shape):
    val = _data(dtype, shape, 4 + root)
    want = _jax_run(jmesh, lambda v: _J().fetch_bcast(
        v[0], root=root, n=N, axis="world")[None], val)
    got, _ = _port(pool, "bcast", val, dtype, root=root)
    np.testing.assert_array_equal(got, _bits(want))
    assert all(np.array_equal(g, _bits(val)[root]) for g in got)


@pytest.mark.parametrize("src,dst", [(1, 3), (2, 2)])
def test_device_comm_put_driver(jmesh, pool, src, dst):
    win = np.zeros((N, 4, 128), np.float32)
    val = _data("float32", (4, 128), 8)
    from ompi_tpu.mpi.device_comm import device_world

    jdc = device_world(jmesh)
    want = np.asarray(jdc.run_method("put", _sharded(jmesh, win),
                                     _sharded(jmesh, val), margs=(src, dst)))
    got, _ = _port(pool, "put", win, "float32", val, src=src, dst=dst,
                   driver=True)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("src,dst", [(3, 2), (0, 1)])
def test_device_comm_get_driver(jmesh, pool, src, dst):
    val = _data("float32", (4, 128), 9)
    from ompi_tpu.mpi.device_comm import device_world

    jdc = device_world(jmesh)
    want = np.asarray(jdc.run_method("get", _sharded(jmesh, val),
                                     margs=(src, dst)))
    got, _ = _port(pool, "get", val, "float32", src=src, dst=dst,
                   driver=True)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("method", ["put", "get"])
def test_flat_axis_guard(jax, pool, method):
    import jax.numpy as jnp

    from ompi_tpu.mpi.constants import MPIException as JMPIException
    from ompi_tpu.mpi.device_comm import DeviceCommunicator as JComm
    from ompi_tpu.parallel.mesh import make_mesh

    jdc = JComm(make_mesh({"x": 2, "y": 2}, devices=jax.devices()[:N]),
                ("x", "y"))
    with pytest.raises(JMPIException, match="flat single-axis") as jerr:
        if method == "put":
            jdc.put(jnp.zeros((8, 128)), jnp.ones((8, 128)), 0, 1)
        else:
            jdc.get(jnp.zeros((8, 128)), 0, 1)
    for name, msg in pool.run(TR.flat_axis_guard, method=method):
        assert name == "MPIException" and msg == str(jerr.value)


@pytest.mark.parametrize("put_pair,get_pair", [((0, 3), (3, 1)),
                                               ((2, 1), (1, 2))])
def test_shmem_one_sided_put_get(jmesh, pool, put_pair, get_pair):
    import jax.numpy as jnp

    from ompi_tpu.mpi.device_comm import device_world
    from ompi_tpu.shmem.device import DeviceSymmetricHeap

    heap = DeviceSymmetricHeap(device_world(jmesh))
    sym = heap.array((8, 128), np.float32, fill=0)

    def prog(comm, blk):
        v = jnp.full_like(blk, 9.0)
        blk = heap.put(blk, v, *put_pair)
        blk = heap.quiet(blk)
        return heap.get(blk, *get_pair)

    want = np.asarray(heap.run(prog, sym))
    got = np.stack(pool.run(TR.heap_put_get, shape=(8, 128), value=9.0,
                            put_pair=put_pair, get_pair=get_pair))
    np.testing.assert_array_equal(got, want)
    assert np.all(got[get_pair[1]] == 9.0)


@pytest.mark.parametrize("origin,target,get_origin", [(2, 3, 1), (0, 0, 2)])
def test_device_window_rma(jmesh, pool, origin, target, get_origin):
    data = np.random.default_rng(10).standard_normal((4, 128)).astype(
        np.float32)
    from ompi_tpu.mpi.device_comm import device_world
    from ompi_tpu.mpi.osc import DeviceWindow

    jwin = DeviceWindow(device_world(jmesh), (4, 128), np.float32)
    jwin.put(data, origin=origin, target=target)
    jwin.fence()
    want_local = [jwin.local(r) for r in range(N)]
    want_fetched = jwin.get(origin=get_origin, target=target)
    jwin.fence()
    jwin.free()
    res = pool.run(TR.device_window, local_shape=(4, 128), data=data,
                   origin=origin, target=target, get_origin=get_origin)
    for r, (local, fetched, other) in enumerate(res):
        np.testing.assert_array_equal(local, want_local[r])
        # get_origin sees target's part; everyone else its own part
        np.testing.assert_array_equal(
            fetched, want_fetched if r == get_origin else want_local[r])
        assert other[0] == "MPIException" and "own part" in other[1]


def test_window_not_allocated_by_the_communicator_raises():
    """A non-CPU tensor that is not a symmetric window is refused before
    any kernel (here a meta tensor stands in for a CUDA one)."""
    from ompi_tpu_torch.mpi.device_comm import device_world
    from ompi_tpu_torch.parallel.mesh import make_mesh

    comm = device_world(make_mesh(device="cpu"))
    w = torch.empty((4, 8), device="meta")
    for call in (lambda: R.window_put(w, w, 0, 0, comm),
                 lambda: R.window_get(w, 0, 0, comm),
                 lambda: R.fetch_bcast(w, 0, comm)):
        with pytest.raises(MPIException, match="DeviceWindow, "
                           "DeviceSymmetricHeap.array or comm.window"):
            call()


def test_window_put_checks_the_value_like_the_reference():
    from ompi_tpu_torch.mpi.device_comm import device_world
    from ompi_tpu_torch.parallel.mesh import make_mesh

    comm = device_world(make_mesh(device="cpu"))
    with pytest.raises(ValueError, match="must match the window shard"):
        R.window_put(torch.zeros((4, 8)), torch.zeros((4, 9)), 0, 0, comm)
    with pytest.raises(MPIException, match="outside a communicator"):
        R.window_put(torch.zeros((4, 8)), torch.zeros((4, 8)), 0, 1, comm)


def test_kernel_level_calls_refuse_cpu_tensors():
    """The CPU's plain version is copy_plain; the kernel-level entry points
    take CUDA tensors only."""
    a, b = torch.zeros(16), torch.arange(16.0)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        R.put_kernel(a, b)
    R.copy_plain([a], b)
    assert torch.equal(a, b)
    plans = [R.copy_plan(n, 0, 0, SMS) for n in (1, 4096, 4097, 1 << 30)]
    assert [p.grid for p in plans] == [1, 1, 1, SMS]
    assert [p.stages for p in plans] == [1, 1, 1, R.STAGES]
    assert all(p.bulk for p in plans)
    assert not R.copy_plan(4096, 4, 0, SMS).bulk


SMS = 132                                  # an H100 SXM's SMs
PLAN_SIZES = (1, 15, 16, 4096, 4096 + 7, (33 << 10) + 16, (64 << 20) + 48,
              256 << 20)


@pytest.mark.parametrize("src_off,dst_off", [(0, 0), (4, 0), (0, 8)])
@pytest.mark.parametrize("nbytes", PLAN_SIZES)
def test_copy_plan_covers_every_byte_once(nbytes, src_off, dst_off):
    """The put/get launch plan: every byte covered exactly once, bulk
    ranges 16-byte aligned and whole multiples of 16, at most one block
    an SM, each stage inside the shared memory the launch asks for, and
    any pair that is not 16-byte aligned on the byte path."""
    base = 1 << 20                          # a 16-byte-aligned address
    p = R.copy_plan(nbytes, base + src_off, base + dst_off, SMS)
    assert p.nbytes == nbytes and 1 <= p.grid <= SMS
    if src_off or dst_off:
        assert not p.bulk and p.body == 0 and p.smem == 0
        assert p.threads == R.THREADS      # a grid-stride loop over all
        return
    assert p.bulk and p.threads >= 16
    # chunk g of the body goes to block g mod grid; every block has one
    chunks = -(-p.body // p.stage)
    ranges = sorted((g * p.stage, min((g + 1) * p.stage, p.body))
                    for g in range(chunks))
    assert {g % p.grid for g in range(chunks)} == set(range(p.grid)) \
        or chunks == 0 and p.grid == 1
    ranges.append((p.body, nbytes))         # the tail, by threads
    ends = [0]
    for lo, hi in ranges:
        assert lo == ends[-1]
        ends.append(hi)
    assert ends[-1] == nbytes
    assert nbytes - p.body < 16 <= p.threads
    for lo, hi in ranges[:-1]:
        assert lo % 16 == 0 and (hi - lo) % 16 == 0 and hi > lo
    # chunks of STAGE_BYTES (one below that); a block's chunks fill its
    # ring at most once over; every stage fits the shared memory the
    # launch asks for and one mbarrier transaction
    assert p.stage == min(R.STAGE_BYTES, max(16, p.body))
    assert p.stages <= max(1, -(-chunks // p.grid))
    assert p.stage % 16 == 0 and 16 <= p.stage < 1 << 20
    assert 1 <= p.ahead <= p.stages <= R.MAX_STAGES
    assert p.stages * p.stage <= p.smem <= R.MAX_RING_BYTES


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")


@pytest.mark.gpu
def test_kernels_match_plain_on_the_card():
    _card()
    dev = torch.device("cuda", 0)
    flags = torch.zeros(8, dtype=torch.int64, device=dev)
    ready, done = flags[0:1], flags[1:2]
    status, counter = flags[2:3], flags[3:4]
    ready.fill_(1 << 40)                       # every wait passes at once
    arrived, seq = 0, 0
    # (bytes, source offset, landing offset): landings off by one take the
    # byte path; 16-byte-aligned pairs (16, 48, 80: not 128-aligned) the
    # bulk ring, with sizes that fill no stage or block range evenly
    for nbytes, off, l_off in ((4096, 0, 1), (1 << 20, 0, 1),
                               (7 * 129 * 4, 0, 1), (4096 + 3, 1, 2),
                               (1 << 20, 5, 6), (0, 0, 0), (4096, 0, 0),
                               (4096 + 7, 16, 0), ((33 << 10) + 16, 16, 48),
                               (1 << 20, 48, 80), ((64 << 20) + 48, 0, 16)):
        src = torch.randint(0, 256, (nbytes + off,), dtype=torch.uint8,
                            device=dev)[off:]
        for kind, fn in (("put", R.put_kernel), ("get", R.get_kernel),
                         ("bcast", None)):
            seq += 1
            lands = [torch.zeros(nbytes + l_off, dtype=torch.uint8,
                                 device=dev)[l_off:] for _ in range(3)]
            sync = R.Sync(wait=[ready], release=[done], counter=counter,
                          status=status, seq=seq, arrived=arrived)
            before = (R.put_launch_count, R.get_launch_count,
                      R.bcast_launch_count)
            if fn is None:
                R.bcast_kernel(lands, src, sync)
            else:
                fn(lands[0], src, sync)
                lands = lands[:1]
            arrived = sync.arrived
            torch.cuda.synchronize()
            after = (R.put_launch_count, R.get_launch_count,
                     R.bcast_launch_count)
            assert sum(after) == sum(before) + 1
            want = [torch.empty_like(t) for t in lands]
            R.copy_plain(want, src)
            for got, exp in zip(lands, want):
                assert torch.equal(got, exp), (kind, nbytes, off, l_off)
            assert int(done.item()) == seq and int(status.item()) == 0
    assert int(counter.item()) == arrived


@pytest.mark.gpu
def test_back_to_back_puts_land_before_done_on_the_card():
    """100 puts of 1 MiB, each of a new value with the handshake: each
    landing holds its value once the call's done flag is read."""
    _card()
    dev = torch.device("cuda", 0)
    flags = torch.zeros(4, dtype=torch.int64, device=dev)
    ready, done, status, counter = (flags[i:i + 1] for i in range(4))
    ready.fill_(1 << 40)
    sync = R.Sync(wait=[ready], release=[done], counter=counter,
                  status=status)
    src = torch.empty(1 << 18, dtype=torch.float32, device=dev)
    land = torch.empty_like(src)
    for k in range(1, 101):
        src.fill_(float(k))
        sync.seq = k
        R.put_kernel(land, src, sync)
        assert int(done.item()) == k and int(status.item()) == 0
        assert bool((land == float(k)).all()), k
    assert int(counter.item()) == sync.arrived


@pytest.mark.gpu
def test_cuda_window_not_allocated_by_the_communicator_raises_on_the_card():
    _card()
    from ompi_tpu_torch.mpi.device_comm import device_world
    from ompi_tpu_torch.parallel.mesh import make_mesh

    comm = device_world(make_mesh())
    w = torch.zeros((4, 8), device="cuda")
    with pytest.raises(MPIException, match="comm.window"):
        R.window_put(w, w, 0, 0, comm)
