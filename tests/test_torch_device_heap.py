"""The port's device-mode symmetric heap (``ompi_tpu_torch.shmem``)
against the JAX package's ``DeviceSymmetricHeap``.

Counterparts of ``tests/shmem/test_device_heap.py`` at 4 PEs: the JAX
package on a 4-device sub-mesh of the suite's virtual CPU devices, the
port on 4 rank processes (gloo, ``tests/torch_ranks.py``), each PE's
block compared with the JAX global array's block.  Copies, shifts, max
and broadcasts are exact; float32 sums at 1e-6 relative (gloo and XLA sum
in different orders).
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from jax.sharding import Mesh  # noqa: E402

from ompi_tpu.mpi import op as jop  # noqa: E402
from ompi_tpu.mpi.device_comm import device_world as jdevice_world  # noqa: E402
from ompi_tpu.shmem.device import DeviceSymmetricHeap as JHeap  # noqa: E402
from tests import torch_ranks as TR  # noqa: E402

N = TR.WORLD
SUM_RTOL = 1e-6


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = TR.RankPool(tmp_path_factory.mktemp("ranks"))
    yield p
    p.close()


@pytest.fixture(scope="module")
def jheap():
    devs = np.array(jax.devices()[:N])
    return JHeap(jdevice_world(Mesh(devs, axis_names=("pe",))))


def _port(pool, body, x):
    """Every PE's result of one heap op on its block of x, stacked."""
    return np.concatenate(pool.map(
        TR.heap_op, [dict(shard=s, body=body) for s in np.split(x, N)]))


def test_alloc_shape_and_sharding(pool, jheap):
    want = np.asarray(jheap.array((4,), np.float32, fill=7))
    got = np.concatenate(pool.run(TR.heap_op, shard=None, body="alloc",
                                  fill=7, shape=(4,)))
    assert got.shape == want.shape == (N, 4)
    np.testing.assert_array_equal(got, want)
    assert float(got.sum()) == N * 4 * 7


@pytest.mark.parametrize("body", ["cshift", "alltoall"])
def test_cshift_circular(pool, jheap, body):
    x = np.arange(N * 4, dtype=np.float32).reshape(N, 4)
    fns = {"cshift": lambda c, b: jheap.cshift(b, 1),
           "alltoall": lambda c, b: jheap.alltoall(b)}
    want = np.asarray(jheap.run(fns[body], x))
    np.testing.assert_array_equal(_port(pool, body, x), want)


def test_to_all_max_reduction(pool, jheap):
    vals = np.random.default_rng(0).normal(size=(N, 3)).astype(np.float32)
    want = np.asarray(jheap.run(
        lambda c, b: jheap.to_all(b, op=jop.MAX), vals))
    got = _port(pool, "to_all_max", vals)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.tile(vals.max(axis=0), (N, 1)))


@pytest.mark.parametrize("body", ["get_from", "broadcast"])
def test_get_from_and_broadcast(pool, jheap, body):
    x = np.arange(N * 2, dtype=np.float32).reshape(N, 2)
    fns = {"get_from": lambda c, b: jheap.get_from(b, 1),
           "broadcast": lambda c, b: jheap.broadcast(b, root=2)}
    want = np.asarray(jheap.run(fns[body], x))
    np.testing.assert_array_equal(_port(pool, body, x), want)


def test_put_to_pairs(pool, jheap):
    x = (np.arange(N, dtype=np.float32) + 1).reshape(N, 1)
    want = np.asarray(jheap.run(
        lambda c, b: jheap.put_to(b, [(0, 3)], fill=-1), x))
    got = _port(pool, "put_to", x)
    np.testing.assert_array_equal(got, want)
    assert got[3, 0] == 1.0 and np.all(got[:3] == -1.0)


def test_collect_fcollect(pool, jheap):
    x = np.arange(N * 2, dtype=np.float32).reshape(N, 2)
    want = np.asarray(jheap.run(lambda c, b: jheap.collect(b), x))
    got = _port(pool, "collect", x)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.reshape(N, -1)[N - 1],
                                  np.arange(N * 2, dtype=np.float32))


def test_jit_composes_compute_and_heap_ops(pool, jheap):
    x = np.random.default_rng(1).normal(size=(N, 4)).astype(np.float32)

    def step(c, b):
        return jheap.to_all(jheap.cshift(b * 2.0, 1), op=jop.SUM)

    want = np.asarray(jheap.run(step, x))
    np.testing.assert_allclose(_port(pool, "compose", x), want,
                               rtol=SUM_RTOL)


@pytest.mark.parametrize("body", ["my_pe", "barrier_all"])
def test_my_pe_and_barrier(pool, jheap, body):
    x = np.zeros((N, 2), np.float32)
    got = _port(pool, body, x)
    if body == "my_pe":
        want = np.asarray(jheap.run(
            lambda c, b: b * 0 + jheap.my_pe(), x))
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_equal(got, x)
