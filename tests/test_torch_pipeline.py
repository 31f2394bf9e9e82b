"""The port's GPipe pipeline (``ompi_tpu_torch.parallel.pipeline.gpipe``)
against the JAX package's, on 4 gloo rank processes (one stage a rank)
and 4 virtual CPU devices.

The setup is tests/parallel/test_pipeline.py's: stage s is
gelu(h @ w[s] + b[s]) (the exact gelu in both packages: torch's default,
``approximate=False`` in JAX), the loss Σ out².  Outputs at 1, 2, 4 and 8 microbatches, and every
gradient — each stage's (w, b) on its rank, x's summed over the ranks —
against ``jax.grad`` of the JAX package's ``gpipe``, at the reference's
rtol/atol 2e-5.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JMesh, PartitionSpec as P  # noqa: E402

from ompi_tpu.mpi.device_comm import DeviceCommunicator as JDC  # noqa: E402
from ompi_tpu.parallel.pipeline import gpipe as jgpipe  # noqa: E402
from ompi_tpu_torch.mpi.device_comm import device_world  # noqa: E402
from ompi_tpu_torch.parallel import gpipe  # noqa: E402
from ompi_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from tests import torch_ranks as TR  # noqa: E402

PP = 4
TOL = 2e-5


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = TR.RankPool(tmp_path_factory.mktemp("ranks"))
    yield p
    p.close()


def _jstage(params, h):
    w, b = params
    return jax.nn.gelu(h @ w + b, approximate=False)


def _make_params(rng, stages, d):
    w = rng.normal(0, d ** -0.5, size=(stages, d, d)).astype(np.float32)
    b = rng.normal(0, 0.1, size=(stages, d)).astype(np.float32)
    return w, b


def _jax_gpipe(x, w, b, microbatches):
    mesh = JMesh(np.array(jax.devices()[:PP]), axis_names=("pp",))
    comm = JDC(mesh, ("pp",))
    return jax.shard_map(
        lambda xx, ww, bb: jgpipe(comm, _jstage, (ww[0], bb[0]), xx,
                                  microbatches, axis="pp"),
        mesh=mesh, in_specs=(P(), P("pp"), P("pp")), out_specs=P(),
        check_vma=False)


def _sequential(w, b, x):
    h = jnp.asarray(x)
    for s in range(w.shape[0]):
        h = _jstage((w[s], b[s]), h)
    return np.asarray(h)


@pytest.mark.parametrize("microbatches", [1, 2, 4, 8])
def test_gpipe_matches_the_jax_package(pool, microbatches):
    rng = np.random.default_rng(0)
    B, D = 16, 32
    x = rng.normal(size=(B, D)).astype(np.float32)
    w, b = _make_params(rng, PP, D)
    want = np.asarray(jax.jit(_jax_gpipe(x, w, b, microbatches))(x, w, b))
    np.testing.assert_allclose(want, _sequential(w, b, x), rtol=TOL,
                               atol=TOL)
    res = pool.run(TR.gpipe_run, x=x, w=w, b=b, microbatches=microbatches)
    for out, _, _, _, calls in res:
        np.testing.assert_allclose(out, want, rtol=TOL, atol=TOL)
        assert calls == microbatches + PP - 1


@pytest.mark.parametrize("microbatches", [1, 4])
def test_gpipe_gradients_match_jax_grad(pool, microbatches):
    rng = np.random.default_rng(1)
    B, D = 8, 16
    x = rng.normal(size=(B, D)).astype(np.float32)
    w, b = _make_params(rng, PP, D)
    fn = _jax_gpipe(x, w, b, microbatches)
    gx, gw, gb = jax.grad(lambda x, w, b: (fn(x, w, b) ** 2).sum(),
                          argnums=(0, 1, 2))(x, w, b)
    res = pool.run(TR.gpipe_run, x=x, w=w, b=b, microbatches=microbatches,
                   grad=True)
    for s, (_, gws, gbs, _, _) in enumerate(res):
        np.testing.assert_allclose(gws, np.asarray(gw[s]), rtol=TOL,
                                   atol=TOL, err_msg=f"stage {s} w")
        np.testing.assert_allclose(gbs, np.asarray(gb[s]), rtol=TOL,
                                   atol=TOL, err_msg=f"stage {s} b")
        assert np.abs(gws).sum() > 0
    np.testing.assert_allclose(sum(r[3] for r in res), np.asarray(gx),
                               rtol=TOL, atol=TOL)
    for r in res[1:]:
        assert not r[3].any()            # x feeds stage 0 only


def _solo():
    return device_world(Mesh({"pp": 1}, device="cpu"))


def _stage(params, h):
    w, b = params
    return torch.nn.functional.gelu(h @ w + b)


def test_gpipe_single_stage_degenerate():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 8)).astype(np.float32)
    w, b = _make_params(rng, 1, 8)
    params = (torch.from_numpy(w[0]), torch.from_numpy(b[0]))
    got = gpipe(_solo(), _stage, params, torch.from_numpy(x), 2, axis="pp")
    np.testing.assert_allclose(got.numpy(), _sequential(w, b, x),
                               rtol=TOL, atol=TOL)
    assert torch.equal(got, _stage(params, torch.from_numpy(x)))


def test_gpipe_errors():
    x = torch.zeros(6, 4)
    params = (torch.eye(4), torch.zeros(4))
    with pytest.raises(ValueError, match="not bound to this communicator"):
        gpipe(_solo(), _stage, params, x, 2, axis="stages")
    with pytest.raises(ValueError, match="not divisible by 4 microbatches"):
        gpipe(_solo(), _stage, params, x, 4)


def test_the_pipeline_example_on_four_launched_ranks():
    """``examples/pipeline.py`` under tpurun on 4 gloo CPU ranks (the
    4-card command of ROADMAP.md with ``--device cpu``): each stage's
    gradients, the output and x's summed gradient equal the sequential
    chain's at the reference's 2e-5."""
    import json
    import pathlib
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    p = subprocess.run(
        [sys.executable, "-m", "ompi_tpu_torch.tools.tpurun", "-np", "4",
         "--no-tag-output", "-x", f"OMPI_TPU_COORD=127.0.0.1:{port}", "-x",
         "OMPI_TPU_NHOSTS=1", "--", sys.executable, "-m",
         "ompi_tpu_torch.examples.pipeline", "--device", "cpu",
         "--width", "32", "--tokens", "16", "--microbatches", "4"],
        cwd=pathlib.Path(__file__).resolve().parents[1],
        capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    ranks = [json.loads(line.split(" ", 1)[1])
             for line in p.stdout.splitlines()
             if line.startswith("pipeline ")]
    assert sorted(r["stage"] for r in ranks) == [0, 1, 2, 3]
    for r in ranks:
        for key in ("out_rel_err", "w_grad_rel_err", "b_grad_rel_err",
                    "x_grad_rel_err"):
            assert r[key] <= TOL, (key, r)
