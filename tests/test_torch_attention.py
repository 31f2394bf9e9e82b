"""The port's attention, mesh, communicator and tensor-parallel layers
against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
JAX side runs on a 1-device mesh.  The materialized attention paths are
the same algorithm in both, so they agree to f32 rounding (2e-5, the JAX
package's attention tolerance).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ompi_tpu.parallel import attention as JA
from ompi_tpu.parallel import mesh as JM
from ompi_tpu_torch.mpi.device_comm import DeviceCommunicator
from ompi_tpu_torch.parallel import attention as TA
from ompi_tpu_torch.parallel import mesh as TM
from ompi_tpu_torch.parallel.layers import column_parallel, row_parallel

TOL = 2e-5


def _qkv(B=2, T=32, H=4, D=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, T, H, D)).astype(np.float32)
            for _ in range(3)]


def _comm():
    return DeviceCommunicator(TM.make_mesh({"dp": 1, "sp": 1, "tp": 1},
                                           device="cpu"))


@pytest.mark.parametrize("causal,offsets", [(True, (0, 0)),
                                            (True, (32, 0)),
                                            (True, (0, 32)),
                                            (False, (0, 0))])
def test_local_attention_jnp_matches_jax(causal, offsets):
    q, k, v = _qkv()
    q_off, k_off = offsets
    want = JA.local_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, q_offset=q_off, k_offset=k_off,
                              impl="jnp")
    got = TA.local_attention(*map(torch.from_numpy, (q, k, v)),
                             causal=causal, q_offset=q_off, k_offset=k_off,
                             impl="jnp")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_local_attention_lse_dtypes_follow_impl():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv())
    o_j, l_j = TA.local_attention_lse(q, k, v, impl="jnp")
    o_f, l_f = TA.local_attention_lse(q, k, v, impl="flash")
    assert o_j.dtype == torch.float32 and o_f.dtype == torch.bfloat16
    assert l_j.dtype == l_f.dtype == torch.float32
    assert TA.local_attention(q, k, v, impl="jnp").dtype == torch.bfloat16


def test_flash_and_jnp_impls_agree_on_cpu():
    q, k, v = map(torch.from_numpy, _qkv(T=64))
    torch.testing.assert_close(TA.local_attention(q, k, v, impl="flash"),
                               TA.local_attention(q, k, v, impl="jnp"),
                               atol=TOL, rtol=TOL)


def test_flash_wanted_rules():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert not TA._flash_wanted("jnp", 128, 128, device=cuda)
    assert not TA._flash_wanted("auto", 128, 128, device=cpu)
    assert TA._flash_wanted("auto", 128, 128, device=cuda)
    assert not TA._flash_wanted("auto", 200, 200, device=cuda)
    assert TA._flash_wanted("flash", 128, 128, device=cpu)
    with pytest.raises(ValueError, match="tiling"):
        TA._flash_wanted("flash", 200, 200, device=cuda)
    with pytest.raises(ValueError, match="impl"):
        TA._flash_wanted("pallas", 128, 128)


@pytest.mark.parametrize("t_q,t_k", [(128, 128), (96, 96), (256, 384),
                                     (200, 256), (7, 7)])
def test_flash_blocks_agree_with_jax(t_q, t_k):
    assert TA._flash_blocks(t_q, t_k) == JA._flash_blocks(t_q, t_k)


@pytest.mark.parametrize("fn", ["ring_attention", "ulysses_attention",
                                "gathered_attention"])
def test_sequence_parallel_entry_points_reduce_at_sp1(fn):
    q, k, v = map(torch.from_numpy, _qkv())
    want = TA.local_attention(q, k, v, causal=True)
    got = getattr(TA, fn)(_comm(), q, k, v, axis="sp", causal=True)
    assert torch.equal(got, want)


class _FakeMesh:
    """A mesh surface with sp > 1, which one process cannot build."""

    shape = {"dp": 1, "sp": 2, "tp": 1}
    axis_names = ("dp", "sp", "tp")


class _FakeComm:
    mesh = _FakeMesh()
    axes = ("dp", "sp", "tp")


def test_ulysses_checks_head_divisibility_first():
    q, k, v = map(torch.from_numpy, _qkv(H=3))
    with pytest.raises(ValueError, match="divisible"):
        TA.ulysses_attention(_FakeComm(), q, k, v, axis="sp")


@pytest.mark.parametrize("n,names", [(1, ["dp", "sp", "tp"]), (8, ["dp", "tp"]),
                                     (16, ["dp", "sp", "tp"]), (6, ["a", "b"]),
                                     (12, ["x"])])
def test_mesh_shape_for_matches_jax(n, names):
    assert TM.mesh_shape_for(n, names) == JM.mesh_shape_for(n, names)


def test_make_mesh_forms():
    m = TM.make_mesh(device="cpu")
    assert m.shape == {"world": 1} and m.axis_names == ("world",)
    m = TM.make_mesh({"dp": -1, "sp": 1, "tp": 1}, device="cpu")
    assert m.shape == {"dp": 1, "sp": 1, "tp": 1}
    assert m.device == torch.device("cpu")
    assert TM.make_mesh(["dp", "tp"], device="cpu").shape == {"dp": 1,
                                                              "tp": 1}
    with pytest.raises(ValueError, match="needs 2 ranks, the process "
                       "group has 1"):
        TM.make_mesh({"dp": 2, "tp": 1}, device="cpu")


def test_device_communicator_shape_api():
    mesh = TM.make_mesh({"dp": 1, "sp": 1, "tp": 1}, device="cpu")
    comm = DeviceCommunicator(mesh, ("dp", "sp", "tp"))
    assert comm.size == 1 and comm.axis_sizes == (1, 1, 1)
    assert comm.rank() == 0 and comm.coords() == (0, 0, 0)
    sub = comm.sub(("tp",))
    assert sub.axes == ("tp",) and sub.mesh is mesh and sub.size == 1
    with pytest.raises(ValueError, match="not in mesh"):
        DeviceCommunicator(mesh, ("ep",))
    with pytest.raises(ValueError, match="needs 2 ranks"):
        TM.Mesh(_FakeMesh.shape, device="cpu")


def test_column_and_row_parallel_match_jax():
    from ompi_tpu.mpi.device_comm import DeviceCommunicator as JComm
    from ompi_tpu.parallel import layers as JL

    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    w1 = rng.normal(size=(16, 32)).astype(np.float32)
    w2 = rng.normal(size=(32, 16)).astype(np.float32)
    jmesh = JM.make_mesh({"dp": 1, "sp": 1, "tp": 1},
                         devices=jax.devices()[:1])
    jcomm = JComm(jmesh, ("dp", "sp", "tp"))
    want = JL.row_parallel(JL.column_parallel(jnp.asarray(x),
                                              jnp.asarray(w1)),
                           jnp.asarray(w2), jcomm, axis="tp")
    got = row_parallel(column_parallel(torch.from_numpy(x),
                                       torch.from_numpy(w1)),
                       torch.from_numpy(w2), _comm(), axis="tp")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-5)
