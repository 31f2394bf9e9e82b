"""The port's device collectives (``ompi_tpu_torch.mpi.device_comm``)
against the JAX package's ``DeviceCommunicator``.

Counterparts of ``tests/mpi/test_device_comm.py``,
``tests/mpi/test_device_vcoll.py`` (all but its two decision-layer tests:
``mpi/coll/xla.py`` comes with ROADMAP.md queue 1 item 5) and
``tests/mpi/test_device_large_prefix.py`` (with
``coll_device_generic_large_bytes`` forced low).  The same numpy inputs
go through the JAX package on a 4-device sub-mesh of the suite's virtual
CPU devices (a 2×2 mesh where the reference uses 2×4) and through the
port on 4 rank processes (gloo, ``tests/torch_ranks.py``).

Tolerances: float32 sums at 1e-6 relative (gloo and XLA sum in different
orders; plus 1e-6 absolute where the summands are sines, which the two
libraries round differently); integers, max/min, copies and permutations exact;
``allreduce_qint8`` at 1e-6 absolute against JAX's own lossy output; the
non-commutative 2×2 products of the large-payload forms at the
reference's 2e-5.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from ompi_tpu.core import config as jconfig  # noqa: E402
from ompi_tpu.mpi import op as jop  # noqa: E402
from ompi_tpu.mpi.device_comm import DeviceCommunicator as JComm  # noqa: E402
from ompi_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402
from ompi_tpu_torch.mpi.device_comm import DeviceCommunicator  # noqa: E402
from tests import torch_ranks as TR  # noqa: E402

N = TR.WORLD
SUM_RTOL = 1e-6
QINT8_ATOL = 1e-6
PREFIX_TOL = 2e-5          # tests/mpi/test_device_large_prefix.py
MESH22 = {"dp": 2, "tp": 2}


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = TR.RankPool(tmp_path_factory.mktemp("ranks"))
    yield p
    p.close()


@pytest.fixture(scope="module")
def jworld():
    return JComm(jmake_mesh(devices=jax.devices()[:N]))


@pytest.fixture(scope="module")
def j22():
    return JComm(jmake_mesh(MESH22, devices=jax.devices()[:N]))


def _jresolve(a):
    if isinstance(a, str) and a.startswith("op:"):
        if a == "op:matmul":
            return jop.create_op(lambda x, y: x @ y, commutative=False,
                                 device_fn=lambda x, y: x @ y, name="matmul")
        return getattr(jop, a[3:].upper())
    return a


def _jax(jcomm, method, x, margs=(), mkw=None, squeeze=False, expand=False,
         sub=None, out_specs=None):
    """The JAX package's result of one method under ``run``."""
    target = jcomm.sub(sub) if sub else jcomm

    def body(c, s):
        out = getattr(target, method)(s[0] if squeeze else s,
                                      *[_jresolve(a) for a in margs],
                                      **{k: _jresolve(v) for k, v in
                                         (mkw or {}).items()})
        return out[None] if squeeze or expand else out

    return np.asarray(jcomm.run(body, x, out_specs=out_specs))


def _port(pool, method, x, **kw):
    """Every rank's result of the port's method on its shard of x."""
    return pool.map(TR.call, [dict(shard=s["shard"], method=method, **kw)
                              for s in TR.shards(x)])


def _both(pool, jcomm, method, x, *, axes=None, large_bytes=None, **kw):
    """(JAX global output, port per-rank outputs concatenated on axis 0)."""
    want = _jax(jcomm, method, x, **kw)
    got = np.concatenate(_port(pool, method, x, axes=axes,
                               large_bytes=large_bytes, **kw), axis=0)
    assert got.shape == want.shape and got.dtype == want.dtype
    return want, got


def _global(n=32, dtype=np.float32):
    return np.arange(n, dtype=dtype).reshape(N, n // N)


def _mats(seed=None):
    """(N, 2, 2) float32 factors: upper-triangular ones (exact products)
    as the reference, or near-identity random ones."""
    if seed is None:
        return np.stack([np.array([[1.0, r + 1], [0, 1]])
                         for r in range(N)]).astype(np.float32)
    rng = np.random.default_rng(seed)
    return (np.eye(2)[None] + 0.1 * rng.normal(size=(N, 2, 2))).astype(
        np.float32)


# -- tests/mpi/test_device_comm.py ------------------------------------------

@pytest.mark.parametrize("method,margs,exact", [
    ("allreduce", (), False),                       # test_allreduce_psum
    ("allreduce", ("op:max",), True),               # test_allreduce_max
    ("allreduce", ("op:min",), True),
    ("bcast", (3,), True),                          # test_bcast_from_nonzero_root
    ("scan", (), False),                            # test_scan_inclusive
    ("shift", (1,), True),                          # test_ring_shift
    ("shift", (-1,), True),
])
def test_elementwise_collectives(pool, jworld, method, margs, exact):
    x = _global()
    want, got = _both(pool, jworld, method, x, margs=margs)
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=SUM_RTOL)


def test_allreduce_generic_noncommutative(pool, jworld):
    mats = _mats()
    want, got = _both(pool, jworld, "allreduce", mats, margs=("op:matmul",),
                      squeeze=True)
    np.testing.assert_array_equal(got, want)
    expect = mats[0]
    for r in range(1, N):
        expect = expect @ mats[r]
    np.testing.assert_array_equal(got[0], expect)


@pytest.mark.parametrize("root", [0, 2])
def test_reduce_root_only(pool, jworld, root):
    want, got = _both(pool, jworld, "reduce", _global(), mkw={"root": root})
    np.testing.assert_allclose(got, want, rtol=SUM_RTOL)
    assert np.all(got[[r for r in range(N) if r != root]] == 0)


def test_reduce_scatter_matches_mpi(pool, jworld):
    x = np.tile(np.arange(16, dtype=np.float32), (N, 1))
    want, got = _both(pool, jworld, "reduce_scatter", x, squeeze=True)
    np.testing.assert_allclose(got, want, rtol=SUM_RTOL)
    np.testing.assert_allclose(got.reshape(-1), N * np.arange(16))


def test_allgather(pool, jworld):
    want, got = _both(pool, jworld, "allgather", _global(16), expand=True)
    np.testing.assert_array_equal(got, want)


def test_alltoall(pool, jworld):
    want, got = _both(pool, jworld, "alltoall",
                      np.arange(16, dtype=np.float32))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.reshape(N, N), _global(16).T)


@pytest.mark.parametrize("root", [0, 3])
def test_scatter(pool, jworld, root):
    x = np.tile(np.arange(16, dtype=np.float32), (N, 1))
    want, got = _both(pool, jworld, "scatter", x, mkw={"root": root},
                      squeeze=True)
    np.testing.assert_array_equal(got, want)


def test_rank_and_coords_2d(pool, j22):
    assert j22.size == 4 and j22.axis_sizes == (2, 2)
    want = np.asarray(j22.run(lambda c, s: s * 0 + c.rank(),
                              np.zeros((N, 1), np.int32))).ravel()
    res = pool.run(TR.rank_and_coords, axes=MESH22)
    assert [r[0] for r in res] == want.tolist() == list(range(N))
    assert [tuple(r[1]) for r in res] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(r[2] == 4 and tuple(r[3]) == (2, 2) for r in res)


@pytest.mark.parametrize("sub", [("tp",), ("dp",)])
def test_sub_communicator_axes(pool, j22, sub):
    x = np.arange(N, dtype=np.float32).reshape(N, 1)
    want, got = _both(pool, j22, "allreduce", x, axes=MESH22, sub=sub)
    np.testing.assert_array_equal(got, want)


def test_2d_allreduce_over_both_axes(pool, j22):
    x = np.arange(N, dtype=np.float32).reshape(N, 1)
    want, got = _both(pool, j22, "allreduce", x, axes=MESH22)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.ravel(), np.full(N, 6.0))


def test_2d_comm_in_transposed_axis_order(pool):
    """A communicator over ("tp", "dp") ranks column-major: its allgather
    is in its own rank order (as JAX's all_gather over the axis tuple)."""
    jc = JComm(jmake_mesh(MESH22, devices=jax.devices()[:N]), ("tp", "dp"))
    x = np.arange(N, dtype=np.float32).reshape(N, 1)
    want = np.asarray(jc.run(lambda c, s: c.allgather(s)[None], x))
    # run() hands block i to communicator rank i; mesh rank g = (dp, tp)
    # is communicator rank tp·2 + dp
    per = [dict(shard=x[(g % 2) * 2 + g // 2][None], method="allgather",
                axes=MESH22, comm_axes=("tp", "dp"), expand=True)
           for g in range(N)]
    got = pool.map(TR.call, per)
    for g in range(N):
        np.testing.assert_array_equal(got[g][0], want[0])
    np.testing.assert_array_equal(want[0].ravel(), np.arange(N))


def test_inside_user_jit_composes(pool, jworld):
    x = _global()

    def step(c, s):
        return c.allreduce(jnp.sin(s) * 2.0) / c.size

    want = np.asarray(jworld.run(step, x))
    got = np.concatenate(pool.map(TR.compose, TR.shards(x)))
    # XLA's and PyTorch's float32 sin differ in the last bit or two: the
    # reference's rtol plus an absolute 1e-6 for values near zero
    np.testing.assert_allclose(got, want, rtol=SUM_RTOL, atol=1e-6)


@pytest.mark.parametrize("n", [N * 256, 1000])    # aligned and ragged
def test_allreduce_qint8_accuracy(pool, jworld, n):
    x = np.random.default_rng(3).normal(0, 1, size=(N, n)).astype(np.float32)
    want, got = _both(pool, jworld, "allreduce_qint8", x)
    np.testing.assert_allclose(got, want, rtol=0, atol=QINT8_ATOL)
    exact = np.tile(x.sum(axis=0), (N, 1))
    assert np.abs(got - exact).max() <= np.abs(x).max() * N / 127 * 4
    assert np.linalg.norm(got - exact) / np.linalg.norm(exact) < 0.02


def test_allreduce_qint8_non_sum_falls_back(pool, jworld):
    want, got = _both(pool, jworld, "allreduce_qint8", _global(),
                      margs=("op:max",))
    np.testing.assert_array_equal(got, want)


# -- tests/mpi/test_device_vcoll.py -----------------------------------------

def test_exscan_sum(pool, jworld):
    want, got = _both(pool, jworld, "exscan", _global())
    np.testing.assert_allclose(got, want, rtol=SUM_RTOL)
    assert np.all(got[0] == 0)


def test_exscan_noncommutative(pool, jworld):
    want, got = _both(pool, jworld, "exscan", _mats(), margs=("op:matmul",),
                      squeeze=True)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], np.zeros((2, 2)))


@pytest.mark.parametrize("method,margs", [
    ("allreduce_rs_ag", ()),          # test_allreduce_rs_ag_matches_psum
    ("allgather_ring", ()),           # test_allgather_ring_matches_all_gather
    ("bcast_ring", (3,)),             # test_bcast_ring_matches_bcast
    ("bcast_ring", (0,)),
])
def test_algorithm_forms_match_jax(pool, jworld, method, margs):
    x = _global(64)
    want, got = _both(pool, jworld, method, x, margs=margs)
    # bcast_ring sums masked contributions, allreduce_rs_ag sums: compare
    # as floats (== treats -0.0 and +0.0 alike)
    if method == "allreduce_rs_ag":
        np.testing.assert_allclose(got, want, rtol=SUM_RTOL)
    else:
        np.testing.assert_array_equal(got, want)
    native = {"allreduce_rs_ag": "allreduce", "allgather_ring": "allgather",
              "bcast_ring": "bcast"}[method]
    same = np.concatenate(_port(pool, native, x, margs=margs))
    np.testing.assert_allclose(got, same, rtol=SUM_RTOL)


COUNTS = (3, 1, 0, 4)       # ragged, includes an empty rank


def _ragged_padded(counts, width=5, seed=0):
    rng = np.random.default_rng(seed)
    x = np.zeros((N, max(counts), width), np.float32)
    for r, c in enumerate(counts):
        x[r, :c] = rng.normal(size=(c, width))
    return x


def test_allgatherv_ragged(pool, jworld):
    x = _ragged_padded(COUNTS)
    want = np.asarray(jworld.run(lambda c, s: c.allgatherv(s[0], COUNTS),
                                 x, out_specs=P()))
    res = _port(pool, "allgatherv", x, margs=(COUNTS,), squeeze=True)
    for r in range(N):
        np.testing.assert_array_equal(res[r][0], want)


def test_allgatherv_uniform_is_dense(pool, jworld):
    want, got = _both(pool, jworld, "allgatherv", _global(64))
    np.testing.assert_array_equal(got, want)


def test_gatherv_root_only(pool, jworld):
    x = _ragged_padded(COUNTS)
    want = np.asarray(jworld.run(lambda c, s: c.gatherv(s[0], COUNTS,
                                                        root=2), x))
    got = np.concatenate(_port(pool, "gatherv", x, margs=(COUNTS,),
                               mkw={"root": 2}, squeeze=True))
    np.testing.assert_array_equal(got.reshape(want.shape), want)


def test_scatterv_ragged(pool, jworld):
    total = sum(COUNTS)
    full = np.random.default_rng(1).normal(size=(total, 5)).astype(
        np.float32)
    xin = np.tile(full, (N, 1)).reshape(N * total, 5)
    want, got = _both(pool, jworld, "scatterv", xin, margs=(COUNTS,),
                      mkw={"root": 0})
    np.testing.assert_array_equal(got, want)


def test_alltoallv_ragged(pool, jworld):
    rng = np.random.default_rng(2)
    m = rng.integers(0, 4, size=(N, N))
    maxc = int(m.max())
    x = np.zeros((N, N, maxc, 3), np.float32)
    for s in range(N):
        for d in range(N):
            x[s, d, :m[s, d]] = rng.normal(size=(int(m[s, d]), 3))
    want, got = _both(pool, jworld, "alltoallv", x.reshape(N * N, maxc, 3),
                      margs=(m.tolist(),))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("segment", [1024, 1 << 20])
def test_allreduce_segmented_matches_psum(pool, jworld, segment):
    x = np.arange(N * 3000, dtype=np.float32).reshape(N, 3000)
    want, got = _both(pool, jworld, "allreduce_segmented", x,
                      mkw={"segment_elems": segment})
    np.testing.assert_allclose(got, want, rtol=SUM_RTOL)


# -- tests/mpi/test_device_large_prefix.py ----------------------------------

@pytest.fixture
def force_large():
    old = jconfig.var_registry.get("coll_device_generic_large_bytes")
    jconfig.var_registry.set("coll_device_generic_large_bytes", 1)
    yield
    jconfig.var_registry.set("coll_device_generic_large_bytes", old)


@pytest.mark.parametrize("method,seed", [("scan", 0), ("exscan", 1),
                                         ("allreduce", 2)])
def test_large_generic_matches_small(pool, jworld, force_large, method,
                                     seed):
    mats = _mats(seed)
    want, large = _both(pool, jworld, method, mats, margs=("op:matmul",),
                        squeeze=True, large_bytes=1)
    small = np.concatenate(_port(pool, method, mats, margs=("op:matmul",),
                                 squeeze=True, large_bytes=1 << 30))
    np.testing.assert_allclose(large, want, rtol=PREFIX_TOL, atol=PREFIX_TOL)
    np.testing.assert_allclose(large, small, rtol=PREFIX_TOL,
                               atol=PREFIX_TOL)
    if method == "exscan":
        np.testing.assert_array_equal(large[0], np.zeros((2, 2)))
    expect = np.eye(2, dtype=np.float32)
    for r in range(N):
        expect = expect @ mats[r]
    if method != "exscan":
        np.testing.assert_allclose(large[N - 1], expect, rtol=PREFIX_TOL,
                                   atol=PREFIX_TOL)


@pytest.mark.parametrize("method,x", [
    ("scan", np.arange(N * 4, dtype=np.float32).reshape(N, 4)),
    ("exscan", np.ones((N, 4), np.float32))])
def test_large_sum_paths(pool, jworld, force_large, method, x):
    want, got = _both(pool, jworld, method, x, squeeze=True, large_bytes=1)
    np.testing.assert_allclose(got, want, rtol=SUM_RTOL)


# -- the port's own ---------------------------------------------------------

class _SharedCardMesh:
    """A 4-rank mesh whose ranks share one card: no device groups."""

    shape = {"world": 4}
    axis_names = ("world",)
    device = torch.device("cuda", 0)

    def coords(self, rank=None):
        return (1,)

    def members(self, axes):
        return [0, 1, 2, 3]

    def device_group(self, axes):
        return None


@pytest.mark.parametrize("call", [
    lambda c: c.allreduce(torch.zeros(2)),
    lambda c: c.allgather(torch.zeros(2)),
    lambda c: c.bcast(torch.zeros(2)),
    lambda c: c.shift(torch.zeros(2)),
    lambda c: c.alltoall(torch.zeros(4))])
def test_device_collective_over_ranks_sharing_a_card_raises(call):
    comm = DeviceCommunicator(_SharedCardMesh())
    with pytest.raises(NotImplementedError,
                       match="one card per rank.*one process per card"):
        call(comm)


def test_mesh_groups_over_four_ranks(pool):
    res = pool.run(TR.mesh_facts, axes=MESH22)
    for r, facts in enumerate(res):
        assert facts["rank"] == r and facts["world_size"] == N
        assert facts["devices"] == [[0, 1], [2, 3]]
        assert facts["members_tp"] == [2 * (r // 2), 2 * (r // 2) + 1]
        assert facts["members_dp"] == [r % 2, r % 2 + 2]
        assert facts["groups"] == 3 and not facts["shares_card"]


@pytest.mark.parametrize("raw", ["1", "64K", "1M", "2G"])
def test_size_var_parses_like_the_reference(monkeypatch, raw):
    from ompi_tpu.core.config import _parse_size
    from ompi_tpu_torch.core import config as tconfig

    monkeypatch.setenv("OMPI_TPU_MCA_coll_device_generic_large_bytes", raw)
    reg = tconfig.VarRegistry()
    var = reg.register(tconfig.Var(
        framework="coll", name="device_generic_large_bytes",
        vtype=tconfig.VarType.SIZE, default=1 << 20))
    assert var.value == _parse_size(raw)
