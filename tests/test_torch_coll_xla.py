"""The port's MPI communicator device route (``ompi_tpu_torch.mpi.comm``,
``mpi/coll`` and its ``xla`` component) against the JAX package's.

Counterparts of every test of ``tests/mpi/test_coll_xla.py`` and of the two
decision-layer tests of ``tests/mpi/test_device_vcoll.py``; then the
route's own traps: per-shard bytes in the decision, the TPU's measured
rules not steering the port, a host buffer on a communicator of more
than one rank (with a PML: the host route's answer, equal to the JAX
package's; with none: the JAX package's error), and a tensor on another
device than the bound mesh's.

Parity: the same numpy inputs go through the JAX package's global-array
``comm.<slot>`` (a size-1 communicator bound to a 4-device mesh of the
suite's virtual CPU devices, the reference's ``_solo_comm`` shape) and
through the port's world communicator on 4 rank processes (gloo,
``tests/torch_ranks.py``), each rank passing its row block; rank r's
result must equal row block r of the JAX result.  Tolerances: integers,
MAX/MIN, copies and the exact 2×2 upper-triangular products exact; float
sums and products at 1e-6 relative (gloo and XLA reduce in different
orders).  Every rank call runs under a guard that records np.asarray,
Tensor.numpy and Tensor.cpu on a tensor: none may happen.
"""

from __future__ import annotations

import os
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from ompi_tpu.core.buffer import BufferLocationError as JLocationError  # noqa: E402,E501
from ompi_tpu.mpi import op as jop  # noqa: E402
from ompi_tpu.mpi.comm import Communicator as JCommunicator  # noqa: E402
from ompi_tpu.mpi.device_comm import device_world as jworld  # noqa: E402
from ompi_tpu.mpi.group import Group as JGroup  # noqa: E402
from ompi_tpu.mpi.pml import PmlOb1  # noqa: E402
from ompi_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402
from ompi_tpu_torch.core.buffer import BufferLocationError  # noqa: E402
from ompi_tpu_torch.core.config import var_registry  # noqa: E402
from ompi_tpu_torch.mpi import op as op_mod  # noqa: E402
from ompi_tpu_torch.mpi.coll import xla as xla_mod  # noqa: E402
from ompi_tpu_torch.mpi.comm import Communicator  # noqa: E402
from ompi_tpu_torch.mpi.constants import MPIException  # noqa: E402
from ompi_tpu_torch.mpi.device_comm import device_world  # noqa: E402
from ompi_tpu_torch.mpi.group import Group  # noqa: E402
from ompi_tpu_torch.parallel.mesh import Mesh, make_mesh  # noqa: E402
from tests import torch_ranks as TR  # noqa: E402
from tests.mpi.harness import run_ranks as jrun  # noqa: E402

N = TR.WORLD
SUM_RTOL = 1e-6


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = TR.RankPool(tmp_path_factory.mktemp("ranks"))
    yield p
    p.close()


@pytest.fixture(scope="module")
def jcomm():
    """The JAX package's size-1 communicator bound to a 4-device mesh."""
    pml = PmlOb1(0)
    pml.set_peers({0: pml.address})
    comm = JCommunicator(JGroup([0]), cid=7, pml=pml, my_world_rank=0,
                         name="xla_test")
    comm.bind_device(jworld(jmake_mesh(devices=jax.devices()[:N])))
    yield comm
    pml.close()


@pytest.fixture
def coll_directive():
    """Set the port's coll selection directive, restore after."""
    old = var_registry.get("coll_")
    yield lambda value: var_registry.set("coll_", value)
    var_registry.set("coll_", old or "")


def _solo_comm():
    """The port's size-1 communicator bound to the one-process CPU mesh."""
    comm = Communicator(Group([0]), cid=7, my_world_rank=0, name="xla_test")
    return comm.bind_device(device_world(make_mesh(device="cpu")))


def _jax_op(name):
    if name == "matmul":
        return jop.create_op(lambda a, b: a @ b, commutative=False,
                             device_fn=lambda a, b: a @ b, name="matmul")
    return getattr(jop, name.upper())


def _port(pool, slot, x, margs=()):
    """Every rank's result of ``comm.<slot>`` on its row block of x, with
    the staging guard's findings checked."""
    res = pool.map(TR.mpi_coll, [dict(slot=slot, shard=s["shard"],
                                      margs=margs) for s in TR.shards(x)])
    for r, (_, hits) in enumerate(res):
        assert hits == [], f"rank {r}: {slot} staged through the host {hits}"
    return [out for out, _ in res]


def _compare(got_blocks, want, exact):
    want_blocks = np.split(np.asarray(want), N, axis=0)
    for r, (g, w) in enumerate(zip(got_blocks, want_blocks)):
        assert g.shape == w.shape and g.dtype == w.dtype, (r, g.shape,
                                                           w.shape)
        if exact:
            np.testing.assert_array_equal(g, w, err_msg=f"rank {r}")
        else:
            np.testing.assert_allclose(g, w, rtol=SUM_RTOL,
                                       err_msg=f"rank {r}")


def _data(dtype, seed=0, positive=False):
    """(4N, 3) inputs; floats in [0.5, 1.5), so that a sum or product of N
    of them is well conditioned and 1e-6 relative bounds the order of
    evaluation, not a cancellation."""
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "i":
        lo = 1 if positive else -50
        return rng.integers(lo, 4 if positive else 50, size=(4 * N, 3)
                            ).astype(dtype)
    return rng.uniform(0.5, 1.5, size=(4 * N, 3)).astype(dtype)


def _mats():
    """(2N, 2) float32: rank r's shard is [[1, r+1], [0, 1]] (exact
    products in any order of evaluation, not commutable)."""
    return np.concatenate([np.array([[1.0, r + 1], [0, 1]])
                           for r in range(N)]).astype(np.float32)


# -- tests/mpi/test_coll_xla.py ----------------------------------------------

def test_dispatch_table_records_both_providers(jcomm):
    comm = _solo_comm()
    assert comm.coll.providers["allreduce"] == "self"  # size-1 host path
    assert comm.coll.device_providers["allreduce"] == "xla"
    # the same tables as the JAX package's, alltoallw's host slot included
    assert comm.coll.device_providers == jcomm.coll.device_providers
    assert comm.coll.providers == jcomm.coll.providers


def test_device_allreduce_routes_to_mesh_no_host_staging(pool, jcomm):
    x = np.arange(N * 4, dtype=np.float32)
    got = _port(pool, "allreduce", x)
    want = jcomm.allreduce(jnp.asarray(x))
    _compare(got, want, exact=False)
    shards = x.reshape(N, 4)
    np.testing.assert_allclose(np.concatenate(got),
                               np.tile(shards.sum(0), N))


def test_traced_allreduce_is_the_shard_semantics(pool, jcomm):
    """The JAX package's TRACED kind is the port's DEVICE kind: the
    tensor a rank passes is its shard, as the tracer inside shard_map."""
    mesh = jcomm.device.mesh
    x = np.arange(N * 2, dtype=np.float32)

    def kernel(shard):
        return jcomm.allreduce(shard)  # TRACED → lax.psum via coll/xla

    fn = jax.jit(jax.shard_map(kernel, mesh=mesh, in_specs=P("world"),
                               out_specs=P("world"), check_vma=False))
    want = np.asarray(fn(x))
    _compare(_port(pool, "allreduce", x), want, exact=False)
    np.testing.assert_allclose(want, np.tile(x.reshape(N, 2).sum(0), N))


def test_device_max_and_reduce_scatter(pool, jcomm):
    x = np.arange(N * N, dtype=np.float32)
    mx = _port(pool, "allreduce", x, ("op:max",))
    rs = _port(pool, "reduce_scatter", x)
    _compare(mx, jcomm.allreduce(jnp.asarray(x), op=jop.MAX), exact=True)
    _compare(rs, jcomm.reduce_scatter(jnp.asarray(x)), exact=False)
    host = x.reshape(N, N)
    np.testing.assert_allclose(np.concatenate(rs), host.sum(0))


def _jax_no_pml_errors():
    """What the JAX package's communicator of ranks 0 and 1 with no PML
    raises for a host send, a host recv and a host allreduce."""
    def err(fn):
        try:
            fn()
        except Exception as e:  # noqa: BLE001 — the test inspects it
            return type(e).__name__
        return None

    c0, c1 = (JCommunicator(JGroup([0, 1]), cid=3, pml=None,
                            my_world_rank=r, name="w") for r in (0, 1))
    return {"send": err(lambda: c0.send(np.ones(4, np.float32), dest=1,
                                        tag=5)),
            "recv": err(lambda: c1.recv(source=0, tag=5)),
            "allreduce": err(lambda: c0.allreduce(np.ones(4, np.float32)))}


def _host_data():
    return np.arange(N * 4, dtype=np.float32).reshape(N, 4) * 0.5


def test_pml_rejects_device_buffer(pool):
    x = _host_data()
    res = pool.map(TR.mpi_errors, TR.shards(x))
    want = _jax_no_pml_errors()
    assert want["send"] == want["recv"] == "AttributeError"
    for rank in (0, 1):
        kind, msg = res[rank]["p2p_device"]
        assert kind == "BufferLocationError"
        assert "DeviceCommunicator.shift/permute/sendrecv" in msg
        kind, _ = res[rank]["p2p_host"]   # no PML: the JAX package's error
        assert kind == want["send" if rank == 0 else "recv"]
    assert all("p2p_device" not in r for r in res[2:])

    # with a PML, the host route answers as the JAX package's does
    def ref_body(c):
        if c.rank == 0:
            c.send(x[0:1], dest=1, tag=5)
        return c.recv(source=0, tag=5) if c.rank == 1 else None

    ref = jrun(2, ref_body)
    got = res[1]["p2p_pml"]
    assert got.dtype == ref[1].dtype and got.shape == ref[1].shape
    assert got.tobytes() == ref[1].tobytes()
    assert all(r["p2p_pml"] is None for i, r in enumerate(res) if i != 1)


def test_directive_excluding_xla_makes_device_buffers_error(coll_directive):
    coll_directive("^xla")
    comm = _solo_comm()
    with pytest.raises(BufferLocationError):
        comm.allreduce(torch.ones(4))
    # host path still works
    out = comm.allreduce(np.ones(4, np.float32))
    np.testing.assert_allclose(np.asarray(out), np.ones(4))


def test_directive_xla_only_makes_host_buffers_error(coll_directive):
    coll_directive("xla")
    comm = _solo_comm()
    with pytest.raises(BufferLocationError, match="directive excludes"):
        comm.allreduce(np.ones(4, np.float32))
    out = comm.allreduce(torch.ones(8))
    assert isinstance(out, torch.Tensor)


def test_unbound_comm_gives_actionable_error(pool):
    res = pool.map(TR.mpi_errors, TR.shards(np.ones((N, 4), np.float32)))
    for r in res:
        kind, msg = r["unbound"]
        assert kind == "BufferLocationError" and "bind_device" in msg


def test_dup_propagates_device_binding():
    comm = _solo_comm()
    dup = comm.dup()
    assert dup.device is comm.device
    assert dup.cid != comm.cid and dup.name == "xla_test.dup"


def test_missing_component_in_directive_raises(coll_directive):
    from ompi_tpu_torch.core.mca import ComponentError

    coll_directive("nccl")
    with pytest.raises(ComponentError, match="nccl"):
        _solo_comm()


# -- the 16 buffer collectives and barrier, 4 ranks against JAX --------------

_OP_SLOTS = ("reduce", "allreduce", "reduce_scatter", "reduce_scatter_block",
             "scan", "exscan")
_CASES = (
    [(s, op, dt) for s in _OP_SLOTS for op in ("sum", "max", "prod")
     for dt in ("float32", "int32")]
    + [(s, "matmul", "float32") for s in ("allreduce", "scan", "exscan")]
    + [(s, root, dt) for s in ("bcast", "gather", "scatter", "gatherv",
                               "scatterv") for root in (0, 2)
       for dt in ("float32", "int32")]
    + [("reduce", 2, "float32")]
    + [(s, None, dt) for s in ("allgather", "alltoall", "allgatherv",
                               "alltoallv") for dt in ("float32", "int32")])


@pytest.mark.parametrize("slot,arg,dtype", _CASES,
                         ids=[f"{s}-{a}-{d}" for s, a, d in _CASES])
def test_slot_matches_jax_global_array(pool, jcomm, slot, arg, dtype):
    if arg == "matmul":
        x = _mats()
    else:
        x = _data(dtype, seed=len(slot), positive=(arg == "prod"))
    if isinstance(arg, str):
        margs, jargs = (f"op:{arg}",), (_jax_op(arg),)
    elif arg is None:
        margs = jargs = ()
    elif slot == "reduce":
        margs, jargs = ("op:sum", arg), (jop.SUM, arg)
    else:
        margs = jargs = (arg,)
    want = getattr(jcomm, slot)(jnp.asarray(x), *jargs)
    got = _port(pool, slot, x, margs)
    exact = (dtype == "int32" or arg in ("max", "matmul")
             or (arg is None or isinstance(arg, int)) and slot != "reduce")
    _compare(got, want, exact)


def test_alltoallw_has_no_device_provider_in_either(pool, jcomm):
    """The JAX package's coll/xla has no alltoallw: a device buffer
    raises there, and so it does in the port."""
    from ompi_tpu.mpi import datatype as jdt

    x = jnp.ones((4,), jnp.float32)
    with pytest.raises(JLocationError):
        jcomm.alltoallw([(x, jdt.FLOAT32, 4)], [(x, jdt.FLOAT32, 4)])
    comm = _solo_comm()
    t = torch.ones(4)
    with pytest.raises(BufferLocationError, match="no device-capable"):
        comm.alltoallw([(t, None, 4)], [(t, None, 4)])


def test_barrier(pool, jcomm):
    assert jcomm.barrier() is None
    res = pool.map(TR.mpi_coll, [dict(slot="barrier")] * N)
    assert res == [(None, [])] * N


# -- tests/mpi/test_device_vcoll.py: the decision layer ----------------------

class FakeDC:
    size = 8
    axes = ("world",)


def _fresh_component():
    comp = xla_mod.XlaColl()
    comp.register_params()
    return comp


def test_xla_decision_fixed_and_forced():
    comp = _fresh_component()
    dc = FakeDC()
    # fixed: small → psum, huge → rs_ag
    assert comp._decide("allreduce", None, dc, 1024) == "psum"
    assert comp._decide("allreduce", None, dc, 1 << 30) == "rs_ag"
    assert comp._decide("allgather", None, dc, 1024) == "all_gather"
    # dcn axis flips the preference
    var_registry.set("coll_xla_dcn_axes", "world")
    try:
        assert comp._decide("allreduce", None, dc, 1024) == "rs_ag"
        assert comp._decide("allgather", None, dc, 1024) == "ring"
        assert comp._decide("bcast", None, dc, 0) == "ring"
    finally:
        var_registry.set("coll_xla_dcn_axes", "")
    # forced var wins over everything
    var_registry.set("coll_xla_allreduce_algorithm", "rs_ag")
    try:
        assert comp._decide("allreduce", None, dc, 8) == "rs_ag"
    finally:
        var_registry.set("coll_xla_allreduce_algorithm", "")


def test_xla_decision_rules_file(tmp_path):
    comp = _fresh_component()
    rules = tmp_path / "device.rules"
    rules.write_text("allreduce 0 4096 rs_ag\n")
    var_registry.set("coll_xla_dynamic_rules", str(rules))
    try:
        assert comp._decide("allreduce", None, FakeDC(), 100) == "psum"
        assert comp._decide("allreduce", None, FakeDC(), 8192) == "rs_ag"
        # a rules file may not pick a lossy algorithm
        rules.write_text("allreduce 0 0 qint8\n")
        os.utime(rules, (1, 1))
        with pytest.raises(MPIException, match="lossy"):
            comp._decide("allreduce", None, FakeDC(), 100)
    finally:
        var_registry.set("coll_xla_dynamic_rules", "")


# -- the route's own traps ---------------------------------------------------

class _RecordingDC:
    """A size-8 device communicator on the meta device (no memory) that
    records which method the decision reached."""

    size = 8
    axes = ("world",)
    mesh = types.SimpleNamespace(device=torch.device("meta"))

    def rank(self):
        return 0

    def allreduce(self, x, op=None):
        return "allreduce"

    def allreduce_rs_ag(self, x, op=None):
        return "allreduce_rs_ag"


def test_decision_reads_per_shard_bytes():
    """32 MiB a shard at size 8 is at coll_xla_allreduce_large: rs_ag.
    Dividing by the size, as the JAX package must for its global array,
    would see 4 MiB and pick psum."""
    comm = Communicator(Group(range(8)), cid=1, my_world_rank=0)
    comm.bind_device(_RecordingDC())
    big = torch.empty(8 << 20, dtype=torch.float32, device="meta")
    assert big.numel() * big.element_size() == 32 << 20
    assert comm.allreduce(big) == "allreduce_rs_ag"
    assert comm.allreduce(big[:-1]) == "allreduce"
    assert xla_mod._dev_nbytes(big) == 32 << 20


def test_tpu_measured_rules_not_copied_nor_used(tmp_path, monkeypatch):
    from ompi_tpu.mpi.coll import xla as jxla

    # the port looks for its own file, which is not the TPU's and absent
    assert xla_mod._MEASURED_PATH != jxla._MEASURED_PATH
    assert os.path.dirname(xla_mod._MEASURED_PATH).endswith(
        os.path.join("ompi_tpu_torch", "mpi", "coll"))
    assert not os.path.exists(xla_mod._MEASURED_PATH)
    comp = _fresh_component()
    dc = device_world(Mesh({"world": 1}, device="cpu"))
    conf = tmp_path / "xla_measured_rules.conf"
    monkeypatch.setattr(xla_mod, "_MEASURED_PATH", str(conf))
    monkeypatch.setattr(xla_mod, "_measured_cache", [])
    for i, (platform, want) in enumerate((("tpu", "psum"),
                                          ("cuda", "psum"),
                                          ("cpu", "rs_ag"))):
        conf.write_text(f"#! platform={platform}\n#! n_devices=1\n"
                        "allreduce 0 0 rs_ag\n")
        os.utime(conf, (i + 1, i + 1))
        xla_mod._measured_cache.clear()  # the file is read once a process
        assert comp._decide("allreduce", None, dc, 1024) == want, platform


def test_host_buffer_on_a_multi_rank_comm_names_the_roadmap():
    """A communicator of two ranks with no PML: coll/shm and coll/host
    serve the buffer slots as in the JAX package's, and a host allreduce
    fails as the JAX package's communicator with no PML does."""
    comm = Communicator(Group([0, 1]), cid=3, my_world_rank=0, name="w")
    with pytest.raises(Exception) as e:
        comm.allreduce(np.ones(4, np.float32))
    assert type(e.value).__name__ == _jax_no_pml_errors()["allreduce"]
    slots = {"barrier", "bcast", "reduce", "allreduce", "gather",
             "allgather", "scatter", "alltoall", "reduce_scatter",
             "reduce_scatter_block", "scan", "exscan", "gatherv",
             "scatterv", "allgatherv", "alltoallv"}
    shm = {"barrier", "bcast", "reduce", "allreduce", "allgather",
           "alltoall", "alltoallv", "alltoallw", "reduce_scatter",
           "reduce_scatter_block", "scan", "exscan"}
    assert comm.coll.providers == {
        s: "shm" if s in shm else "host" for s in slots | {"alltoallw"}}
    jcomm = JCommunicator(JGroup([0, 1]), cid=3, pml=None,
                          my_world_rank=0, name="w")
    assert comm.coll.providers == jcomm.coll.providers
    assert set(comm.coll.device_providers) == slots


def test_host_buffer_through_the_pool_names_the_roadmap(pool):
    """On 4 rank processes: the world communicator with no PML fails a
    host allreduce as the JAX package's does; with a PML, its host
    allreduce equals the JAX package's bit for bit."""
    x = _host_data()
    res = pool.map(TR.mpi_errors, TR.shards(x))
    want = _jax_no_pml_errors()["allreduce"]
    ref = jrun(N, lambda c: c.allreduce(x[c.rank:c.rank + 1]))
    for r, jr in zip(res, ref):
        kind, _ = r["host"]
        assert kind == want
        got = r["host_pml"]
        assert got.dtype == jr.dtype and got.shape == jr.shape
        assert got.tobytes() == jr.tobytes()
    np.testing.assert_array_equal(res[0]["host_pml"][0], x.sum(0))


def test_tensor_on_another_device_raises_and_is_not_moved(monkeypatch):
    comm = _solo_comm()
    x = torch.zeros(4, device="meta")
    moved = []
    monkeypatch.setattr(torch.Tensor, "to",
                        lambda self, *a, **k: moved.append(a) or self)
    for call in (lambda: comm.allreduce(x), lambda: comm.bcast(x),
                 lambda: comm.alltoall(x), lambda: comm.scan(x)):
        with pytest.raises(BufferLocationError) as e:
            call()
        assert "meta" in str(e.value) and "cpu" in str(e.value)
    assert moved == []


def test_unbound_solo_comm_and_default_op():
    comm = Communicator(Group([0]), cid=2, my_world_rank=0, name="u")
    with pytest.raises(BufferLocationError, match="bind_device"):
        comm.allreduce(torch.ones(2))
    comm.bind_device(device_world(make_mesh(device="cpu")))
    out = comm.allreduce(torch.arange(3.0), op=op_mod.MAX)
    assert torch.equal(out, torch.arange(3.0))
    comm.free()
    assert comm.device is None


def test_bind_device_refuses_a_mesh_of_other_ranks():
    """A 2-rank communicator bound to the one-process mesh (a job launched
    without --gpu) would reduce its own data alone: bind_device raises,
    and so it does when the ranks agree in number but not in place."""
    comm = Communicator(Group([0, 1]), cid=4, my_world_rank=0, name="w2")
    with pytest.raises(ValueError, match="rank 0 of 2.*rank 0 of 1"):
        comm.bind_device(device_world(make_mesh(device="cpu")))
    assert comm.device is None
    other = Communicator(Group([0, 1]), cid=4, my_world_rank=1, name="w2")
    pair = types.SimpleNamespace(size=2, rank=lambda: 0, name="pair")
    with pytest.raises(ValueError, match="rank 1 of 2.*rank 0 of 2"):
        other.bind_device(pair)
    assert other.device is None


# -- the trimmed copies beside their counterparts ----------------------------

def test_config_variables_match_the_jax_package():
    """Every coll_xla_* variable and the coll selection directive keep
    the JAX package's names, types and defaults."""
    from ompi_tpu.core import config as jconfig
    from ompi_tpu.mpi.coll import xla as _jxla  # noqa: F401

    jvars = {v.full_name: v for v in jconfig.var_registry.all_vars()
             if v.full_name == "coll_"
             or v.full_name.startswith("coll_xla_")}
    assert len(jvars) == 7
    for name, jv in jvars.items():
        pv = var_registry._vars[name]
        assert (pv.vtype.value, pv.default) == (jv.vtype.value, jv.default)


def test_directive_from_the_environment(tmp_path):
    import subprocess
    import sys

    probe = ("import torch\n"
             "from ompi_tpu_torch.mpi.comm import Communicator\n"
             "from ompi_tpu_torch.mpi.group import Group\n"
             "c = Communicator(Group([0]), cid=1, my_world_rank=0)\n"
             "print(sorted(set(c.coll.device_providers.values())),"
             " sorted(set(c.coll.providers.values())))\n")
    env = dict(os.environ, OMPI_TPU_MCA_coll_="^xla")
    out = subprocess.run([sys.executable, "-c", probe], env=env,
                         cwd=os.path.dirname(os.path.dirname(__file__)),
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.split("\n")[0] == "[] ['self']"


@pytest.mark.parametrize("op", ["union", "intersection", "difference",
                                "incl", "excl", "range_incl", "translate",
                                "compare"])
def test_group_matches_the_jax_package(op):
    a, b = [5, 1, 3, 7, 0], [3, 9, 5, 2]
    out = []
    for G in (Group, JGroup):
        ga, gb = G(a), G(b)
        res = {"union": lambda: ga.union(gb).ranks,
               "intersection": lambda: ga.intersection(gb).ranks,
               "difference": lambda: ga.difference(gb).ranks,
               "incl": lambda: ga.incl([4, 0, 2]).ranks,
               "excl": lambda: ga.excl([1, 3]).ranks,
               "range_incl": lambda: ga.range_incl([(0, 4, 2)]).ranks,
               "translate": lambda: ga.translate_ranks([0, 1, 2, 3], gb),
               "compare": lambda: (ga.compare(G(a[::-1])), ga.compare(gb),
                                   ga.rank_of(9), ga.size)}[op]()
        out.append(res)
    assert out[0] == out[1]


def test_rules_match_the_jax_package():
    from ompi_tpu.mpi.coll import rules as jrules
    from ompi_tpu_torch.mpi.coll import rules

    text = ("#! platform=cuda\n#! n_devices=4\n"
            "allreduce 0 0 psum  # comment\n"
            "allreduce 0 10240 rs_ag\nallreduce 16 1048576 segmented\n"
            "allgather 2 0 ring\n")
    rs, jrs = rules.parse(text), jrules.parse(text)
    assert rs.meta == jrs.meta and len(rs) == len(jrs) == 4
    for coll in ("allreduce", "allgather", "bcast"):
        for size in (1, 2, 16, 64):
            for nbytes in (0, 100, 10240, 1 << 20, 1 << 30):
                assert (rs.lookup(coll, size, nbytes)
                        == jrs.lookup(coll, size, nbytes))
    with pytest.raises(MPIException, match="expected"):
        rules.parse("allreduce 0 psum\n")
