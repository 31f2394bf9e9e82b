"""Sequence-parallel attention of the port (ring, Ulysses, gathered) on 4
ranks, against the JAX package on the same mesh.

Counterpart of ``tests/parallel/test_attention.py`` at sp > 1.  The same
numpy q, k, v and cotangent go through the JAX package's
``ring_attention``/``ulysses_attention``/``gathered_attention`` under
``shard_map`` on 4 of the suite's virtual CPU devices (output and VJP),
and through the port on 4 gloo rank processes (``tests/torch_ranks.py``),
each rank holding its (B/dp, T/sp) block.  The meshes: sp = 4, and
dp = 2 × sp = 2.  Tolerance (f32): 1e-5 absolute on outputs and
gradients, whose entries are O(1).
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from ompi_tpu.mpi.device_comm import DeviceCommunicator as JComm  # noqa: E402
from ompi_tpu.parallel import attention as JA  # noqa: E402
from ompi_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402
from tests import torch_ranks as TR  # noqa: E402

TOL = 1e-5
MESHES = {"sp4": {"sp": 4}, "dp2sp2": {"dp": 2, "sp": 2}}


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = TR.RankPool(tmp_path_factory.mktemp("ranks"))
    yield p
    p.close()


def _inputs(B=2, T=32, H=4, D=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, T, H, D)).astype(np.float32)
            for _ in range(4)]


def _blocks(x, axes):
    """Rank r's (B/dp, T/sp) block of x, ranks row-major over ``axes``."""
    dp, sp = axes.get("dp", 1), axes["sp"]
    return [np.split(np.split(x, dp, axis=0)[r // sp], sp, axis=1)[r % sp]
            for r in range(TR.WORLD)]


def _join(blocks, axes):
    dp, sp = axes.get("dp", 1), axes["sp"]
    return np.concatenate([np.concatenate(blocks[d * sp:(d + 1) * sp],
                                          axis=1) for d in range(dp)],
                          axis=0)


def _jax(kind, axes, q, k, v, g, causal):
    """The JAX package's output and VJP on the same mesh."""
    names = tuple(axes)
    jmesh = jmake_mesh(dict(axes), devices=jax.devices()[:TR.WORLD])
    comm = JComm(jmesh, names)
    spec = P("dp", "sp") if "dp" in axes else P(None, "sp")
    fn = getattr(JA, f"{kind}_attention")
    shm = jax.shard_map(
        lambda a, b, c: fn(comm, a, b, c, axis="sp", causal=causal),
        mesh=jmesh, in_specs=(spec,) * 3, out_specs=spec, check_vma=False)
    out, vjp = jax.vjp(jax.jit(shm), *map(jnp.asarray, (q, k, v)))
    return [np.asarray(t) for t in (out, *vjp(jnp.asarray(g)))]


def _port(pool, kind, axes, q, k, v, g, causal, **kw):
    per = [dict(kind=kind, q=qb, k=kb, v=vb, g=gb, axes=axes, causal=causal,
                **kw) for qb, kb, vb, gb in zip(*(_blocks(x, axes)
                                                  for x in (q, k, v, g)))]
    res = pool.map(TR.sp_attention, per)
    return [_join([r[i] for r in res], axes) for i in range(4)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("kind", ["ring", "ulysses", "gathered"])
def test_sp_attention_and_vjp_match_jax(pool, kind, mesh, causal):
    axes = MESHES[mesh]
    q, k, v, g = _inputs()
    want = _jax(kind, axes, q, k, v, g, causal)
    got = _port(pool, kind, axes, q, k, v, g, causal)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("impl,bwd_kernel", [("flash", False),
                                             ("flash", True)])
def test_ring_through_the_flash_path_matches_jax(pool, impl, bwd_kernel):
    """Every hop through ``_Flash`` (on the CPU the kernels' plain
    versions): nonzero offsets, fully masked hops and an lse cotangent at
    every hop; with ``ops_flash_bwd_kernel`` on, the backward is the
    kernels' own arithmetic (dm = rowsum(g·out) − g_lse)."""
    axes = MESHES["sp4"]
    q, k, v, g = _inputs()
    want = _jax("ring", axes, q, k, v, g, True)
    got = _port(pool, "ring", axes, q, k, v, g, True, impl=impl,
                bwd_kernel=bwd_kernel)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_ring_equals_gathered_and_full_attention(pool, mesh):
    axes = MESHES[mesh]
    q, k, v, g = _inputs(seed=3)
    ring = _port(pool, "ring", axes, q, k, v, g, True)
    gathered = _port(pool, "gathered", axes, q, k, v, g, True)
    full = np.asarray(JA.local_attention(*map(jnp.asarray, (q, k, v)),
                                         causal=True))
    for a, b in zip(ring, gathered):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0)
    np.testing.assert_allclose(ring[0], full, atol=TOL, rtol=0)


def test_ulysses_indivisible_heads_raise_the_reference_message(pool):
    q, k, v, g = _inputs(H=2)
    with pytest.raises(RuntimeError, match=r"ulysses needs heads \(2\) "
                       r"divisible by sp \(4\)"):
        _port(pool, "ulysses", MESHES["sp4"], q, k, v, g, True)
