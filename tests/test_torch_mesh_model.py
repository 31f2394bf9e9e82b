"""The flagship model on a mesh of 4 ranks: loss and gradients against the
JAX package on the same mesh and against the port's own one-rank run.

Counterpart of ``tests/parallel/test_mesh_model.py`` (and of
``test_degenerate_elision.py`` for the one-rank mesh).  The f32 config of
``test_mesh_model.py:34-36``; parameters from the JAX package's
``init_params``, cut to each rank's tp blocks by
``from_jax_params(..., mesh=)``; tokens from a numpy seed, each rank
passing its (B/dp, S/sp) shard.  The JAX side runs ``shard_map`` on 4 of
the suite's virtual CPU devices, the port 4 gloo rank processes
(``tests/torch_ranks.py``).  Tolerances (f32): loss 1e-5 absolute, every
gradient leaf 1e-4 relative L2, logits 1e-5 absolute.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from ompi_tpu.models import transformer as J  # noqa: E402
from ompi_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402
from ompi_tpu_torch.models import transformer as T  # noqa: E402
from ompi_tpu_torch.models.weights import from_jax_params  # noqa: E402
from ompi_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from tests import torch_ranks as TR  # noqa: E402

FIELDS = dict(vocab=128, d_model=64, n_heads=4, n_layers=2, d_ff=128,
              seq=32, attention="ring", compute_dtype="float32")
LOSS_ATOL = 1e-5
GRAD_RL2 = 1e-4
LOGIT_ATOL = 1e-5

#: (mesh, config options): ring and Ulysses and gathered attention,
#: ce_chunk on and off, remat "dots" on at sp = 2
CASES = {
    "dp2sp2-ring-dots": ({"dp": 2, "sp": 2, "tp": 1},
                         dict(remat="dots")),
    "dp2sp2-ulysses-ce8": ({"dp": 2, "sp": 2, "tp": 1},
                           dict(attention="ulysses", ce_chunk=8,
                                remat=None)),
    "sp2tp2-ring-ce8-dots": ({"dp": 1, "sp": 2, "tp": 2},
                             dict(ce_chunk=8, remat="dots")),
    "sp2tp2-gathered": ({"dp": 1, "sp": 2, "tp": 2},
                        dict(attention="gathered", remat=None)),
    "dp2tp2-ring": ({"dp": 2, "sp": 1, "tp": 2}, dict(remat=None)),
    "tp4-ulysses-dots": ({"dp": 1, "sp": 1, "tp": 4},
                         dict(attention="ulysses", remat="dots")),
    "sp4-ring-ce4": ({"dp": 1, "sp": 4, "tp": 1},
                     dict(ce_chunk=4, remat=None)),
}


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = TR.RankPool(tmp_path_factory.mktemp("ranks"))
    yield p
    p.close()


def _tokens(batch=4, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, FIELDS["vocab"],
                        size=(batch, FIELDS["seq"])).astype(np.int32)


def _jax_value_and_grad(fields, axes, params, tokens):
    jmesh = jmake_mesh(dict(axes), devices=jax.devices()[:TR.WORLD])
    loss, grads = jax.jit(jax.value_and_grad(
        J.make_loss_fn(J.TransformerConfig(**fields), jmesh)))(params,
                                                               tokens)
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


def _one_rank(fields, params, tokens):
    """The port's loss and gradients on the one-process mesh."""
    cfg = T.TransformerConfig(**fields)
    mesh = make_mesh({"dp": 1, "sp": 1, "tp": 1}, device="cpu")
    p = from_jax_params(params, cfg, "cpu", train=True)
    loss = T.make_loss_fn(cfg, mesh)(p, tokens)
    keys = list(p)
    grads = torch.autograd.grad(loss, [p[k] for k in keys])
    return loss.item(), {k: g.numpy() for k, g in zip(keys, grads)}


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _assert_same(loss, grads, want_loss, want_grads, what):
    assert abs(loss - want_loss) <= LOSS_ATOL, (what, loss, want_loss)
    assert sorted(grads) == sorted(want_grads)
    for k in want_grads:
        assert grads[k].shape == want_grads[k].shape, (what, k)
        assert _rel_l2(grads[k], want_grads[k]) <= GRAD_RL2, (
            what, k, _rel_l2(grads[k], want_grads[k]))


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_every_grad_match_jax_and_one_rank(pool, case):
    axes, opts = CASES[case]
    fields = {**FIELDS, **opts}
    params = J.init_params(J.TransformerConfig(**fields), seed=2)
    toks = _tokens()
    res = pool.run(TR.model_grads, fields=fields, axes=axes, params=params,
                   tokens=toks)
    jl, jg = _jax_value_and_grad(fields, axes, params, toks)
    ol, og = _one_rank(fields, params, toks)
    for r, (loss, grads) in enumerate(res):
        _assert_same(loss, grads, jl, jg, f"rank {r} vs JAX")
        _assert_same(loss, grads, ol, og, f"rank {r} vs one rank")


def test_forward_logits_tile_the_one_rank_logits(pool):
    axes = {"dp": 2, "sp": 2, "tp": 1}
    params = J.init_params(J.TransformerConfig(**FIELDS), seed=2)
    toks = _tokens()
    res = pool.run(TR.model_forward, fields=FIELDS, axes=axes,
                   params=params, tokens=toks)
    cfg = T.TransformerConfig(**FIELDS)
    want = T.make_forward(cfg, make_mesh({"dp": 1, "sp": 1, "tp": 1},
                                         device="cpu"))(
        from_jax_params(params, cfg, "cpu"), toks).numpy()
    got = np.concatenate([np.concatenate(res[d * 2:(d + 1) * 2], axis=1)
                          for d in range(2)], axis=0)
    assert got.shape == (4, FIELDS["seq"], FIELDS["vocab"])
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)


def test_from_jax_params_cuts_tp_blocks_and_to_numpy_gathers_them(pool):
    axes = {"dp": 1, "sp": 2, "tp": 2}
    params = J.init_params(J.TransformerConfig(**FIELDS), seed=2)
    toks = _tokens()
    res = pool.run(TR.train_steps, fields=FIELDS, axes=axes, params=params,
                   tokens=toks, steps=0)
    L, D, F = FIELDS["n_layers"], FIELDS["d_model"], FIELDS["d_ff"]
    for _, whole, facts in res:
        shapes = facts["shapes"]
        assert shapes["wq"] == (L, D, D // 2) and shapes["wo"] == (L, D // 2,
                                                                   D)
        assert shapes["w1"] == (L, D, F // 2) and shapes["w2"] == (L, F // 2,
                                                                   D)
        assert shapes["emb"] == params["emb"].shape
        for k in params:
            np.testing.assert_array_equal(whole[k], params[k], err_msg=k)


def test_shard_tokens_is_the_p_dp_sp_block():
    class _M:
        shape = {"dp": 2, "sp": 2, "tp": 1}
        axis_names = ("dp", "sp", "tp")

        def __init__(self, coords):
            self._c = coords

        def coords(self):
            return self._c

    toks = np.arange(4 * 32).reshape(4, 32)
    blocks = {(d, s): T.shard_tokens(toks, _M((d, s, 0)))
              for d in range(2) for s in range(2)}
    np.testing.assert_array_equal(blocks[(1, 0)], toks[2:, :16])
    np.testing.assert_array_equal(blocks[(0, 1)], toks[:2, 16:])
    np.testing.assert_array_equal(
        np.block([[blocks[(0, 0)], blocks[(0, 1)]],
                  [blocks[(1, 0)], blocks[(1, 1)]]]), toks)
