"""Training steps, ZeRO-1 and the input stream of the port on a mesh of 4
ranks, against the JAX package on the same mesh.

Counterpart of ``tests/parallel/test_mesh_model.py``'s step tests (its
ZeRO-1 test at ``:197-249``), of ``tests/parallel/test_data.py`` over dp
and of ``test_degenerate_elision.py``.  The f32 config of
``test_mesh_model.py:34-36``; parameters from the JAX package's
``init_params`` (``from_jax_params(..., mesh=)`` cuts the tp blocks),
tokens from a numpy seed, each rank passing its (B/dp, S/sp) shard; the
JAX side on 4 of the suite's virtual CPU devices, the port on 4 gloo rank
processes (``tests/torch_ranks.py``).  Tolerances (f32): losses and
parameters after optimizer steps at ``tests/test_torch_train.py``'s
1e-4 relative (with 1e-5 absolute on parameters); one step's accumulated
gradients at ``tests/test_torch_mesh_model.py``'s 1e-5 absolute on the
loss and 1e-4 relative L2 a leaf; the ZeRO-1 run against
the run without it at 1e-6 relative (the same arithmetic on 1/dp of each
leaf); batches bit for bit.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from ompi_tpu.models import data as JD  # noqa: E402
from ompi_tpu.models import transformer as J  # noqa: E402
from ompi_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402
from ompi_tpu_torch.models import transformer as T  # noqa: E402
from ompi_tpu_torch.models.weights import from_jax_params  # noqa: E402
from ompi_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from tests import torch_ranks as TR  # noqa: E402

FIELDS = dict(vocab=128, d_model=64, n_heads=4, n_layers=2, d_ff=128,
              seq=32, attention="ring", compute_dtype="float32")
STEP_TOL = 1e-4
ZERO_TOL = 1e-6
LOSS_ATOL = 1e-5
GRAD_RL2 = 1e-4
DP2SP2 = {"dp": 2, "sp": 2, "tp": 1}
DP2TP2 = {"dp": 2, "sp": 1, "tp": 2}


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = TR.RankPool(tmp_path_factory.mktemp("ranks"))
    yield p
    p.close()


def _tokens(batch=4, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, FIELDS["vocab"],
                        size=(batch, FIELDS["seq"])).astype(np.int32)


def _jax_steps(fields, axes, params, tokens, steps=3, lr=1e-2):
    jmesh = jmake_mesh(dict(axes), devices=jax.devices()[:TR.WORLD])
    step, init_opt = J.make_train_step(J.TransformerConfig(**fields), jmesh,
                                       lr=lr)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    state = init_opt(p)
    losses = []
    for _ in range(steps):
        p, state, loss = step(p, state, tokens)
        losses.append(float(loss))
    return losses, {k: np.asarray(v) for k, v in p.items()}


def _assert_params(got, want, rtol=STEP_TOL, atol=1e-5):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


@pytest.fixture(scope="module")
def jax_dp2sp2():
    params = J.init_params(J.TransformerConfig(**FIELDS), seed=3)
    return params, _jax_steps(FIELDS, DP2SP2, params, _tokens())


@pytest.mark.parametrize("loop", [False, True])
def test_three_steps_at_dp2sp2_match_jax(pool, jax_dp2sp2, loop):
    params, (want, want_params) = jax_dp2sp2
    res = pool.run(TR.train_steps, fields=FIELDS, axes=DP2SP2,
                   params=params, tokens=_tokens(), loop=loop)
    for losses, got_params, _ in res:
        np.testing.assert_allclose(losses, want, rtol=STEP_TOL)
        assert losses[-1] < losses[0]
        _assert_params(got_params, want_params)


def test_grad_accum_with_dp_equals_the_single_pass_and_jax(pool):
    toks = _tokens(batch=8)
    params = J.init_params(J.TransformerConfig(**FIELDS), seed=4)
    runs = {}
    for acc in (1, 2):
        fields = {**FIELDS, "grad_accum": acc}
        runs[acc] = pool.run(TR.train_steps, fields=fields, axes=DP2SP2,
                             params=params, tokens=toks)
    want, _ = _jax_steps({**FIELDS, "grad_accum": 2}, DP2SP2, params, toks)
    # losses only: the microbatches group the rows differently on the two
    # sides, and Adam's normalised step magnifies the f32 differences of
    # near-zero gradient entries in the parameters
    for (l1, _, _), (l2, _, _) in zip(runs[1], runs[2]):
        np.testing.assert_allclose(l2, l1, rtol=STEP_TOL)
        np.testing.assert_allclose(l2, want, rtol=STEP_TOL)


def test_grad_accum_with_dp_grads_equal_the_single_pass_and_jax(pool):
    """One step's gradients leaf by leaf: 2 microbatches accumulated and
    summed over dp × sp against the single pass on the same mesh and
    against JAX's gradient of the global batch's loss (each microbatch
    row has the same count of weighted positions, so the mean of the
    microbatch means is the global mean)."""
    toks = _tokens(batch=8)
    params = J.init_params(J.TransformerConfig(**FIELDS), seed=4)
    runs = {acc: pool.run(TR.model_grads,
                          fields={**FIELDS, "grad_accum": acc},
                          axes=DP2SP2, params=params, tokens=toks)
            for acc in (1, 2)}
    jmesh = jmake_mesh(dict(DP2SP2), devices=jax.devices()[:TR.WORLD])
    jl, jg = jax.jit(jax.value_and_grad(J.make_loss_fn(
        J.TransformerConfig(**FIELDS), jmesh)))(params, toks)
    jg = {k: np.asarray(v) for k, v in jg.items()}
    for (l1, g1), (l2, g2) in zip(runs[1], runs[2]):
        for want_loss, want in ((l1, g1), (float(jl), jg)):
            assert abs(l2 - want_loss) <= LOSS_ATOL, (l2, want_loss)
            assert sorted(g2) == sorted(want)
            for k in want:
                assert g2[k].shape == want[k].shape, k
                rel = np.linalg.norm(g2[k] - want[k]) / np.linalg.norm(
                    want[k])
                assert rel <= GRAD_RL2, (k, rel)


@pytest.mark.parametrize("axis", ["dp", "tp"])
def test_zero1_shards_the_optimizer_and_equals_the_run_without(pool, axis):
    """Every rank holds 1/2 of each optimizer leaf: over dp, its part of
    every leaf (tp blocks flattened whole); over tp, its part of each
    replicated leaf and its own tp block of the others, already half."""
    params = J.init_params(J.TransformerConfig(**FIELDS), seed=5)
    toks = _tokens()
    runs = {z: pool.run(TR.train_steps, fields={**FIELDS, "zero1_axis": z},
                        axes=DP2TP2, params=params, tokens=toks)
            for z in (None, axis)}
    L, D, F = FIELDS["n_layers"], FIELDS["d_model"], FIELDS["d_ff"]
    tp_leaves = {k for k, spec in T.param_specs().items() if "tp" in spec}
    for r, ((l0, p0, _), (l1, p1, facts)) in enumerate(zip(runs[None],
                                                            runs[axis])):
        shapes = facts["shapes"]
        # tp leaves stay tp-sharded, the others whole
        assert shapes["w1"] == (L, D, F // 2), shapes["w1"]
        assert shapes["wo"] == (L, D // 2, D), shapes["wo"]
        assert shapes["emb"] == params["emb"].shape
        for k, shape in shapes.items():
            n = int(np.prod(shape))
            part = n if axis == "tp" and k in tp_leaves else -(-n // 2)
            for kind in ("master", "mu", "nu"):
                assert facts[kind][k] == part, (r, kind, k)
            assert part <= -(-params[k].size // 2)    # ≤ half the leaf
        np.testing.assert_allclose(l1, l0, rtol=ZERO_TOL)
        _assert_params(p1, p0, rtol=ZERO_TOL, atol=1e-7)
        assert l1[-1] < l1[0]


def test_zero1_over_an_axis_not_in_the_mesh_raises():
    cfg = T.TransformerConfig(**{**FIELDS, "zero1_axis": "ep"})
    with pytest.raises(ValueError, match=r"zero1 axis 'ep' is not a mesh "
                       r"axis"):
        T.make_train_step(cfg, make_mesh({"dp": 1, "sp": 1, "tp": 1},
                                         device="cpu"))


def test_zero1_on_one_rank_equals_the_plain_step():
    params = T.init_params(T.TransformerConfig(**FIELDS), seed=6)
    mesh = make_mesh({"dp": 1, "sp": 1, "tp": 1}, device="cpu")
    out = {}
    for z in (None, "dp"):
        cfg = T.TransformerConfig(**{**FIELDS, "zero1_axis": z})
        step, init = T.make_train_step(cfg, mesh, lr=1e-2)
        p = from_jax_params(params, cfg, "cpu", train=True)
        state, losses = init(p), []
        for _ in range(2):
            p, state, loss = step(p, state, _tokens())
            losses.append(loss.item())
        out[z] = losses, p
    assert out[None][0] == out["dp"][0]
    for k in params:
        torch.testing.assert_close(out["dp"][1][k], out[None][1][k],
                                   rtol=ZERO_TOL, atol=1e-7)


@pytest.mark.parametrize("axes", [DP2SP2, {"dp": 2, "sp": 1, "tp": 2}])
def test_train_stream_shards_tile_the_jax_global_batch(pool, axes):
    corpus = (np.arange(5000) * 2654435761 % 251).astype(np.int32)
    batch, seq = 4, 32
    res = pool.run(TR.stream_batches, corpus=corpus, seed=7, axes=axes,
                   batch=batch, seq=seq, n=2, start_step=3)
    dp, sp = axes["dp"], axes["sp"]
    src = JD.ArraySource(corpus, seed=7)
    for i in range(2):
        want = src.batch(3 + i, batch, seq)
        for r, batches in enumerate(res):
            d, s = np.unravel_index(r, tuple(axes.values()))[:2]
            b = batches[i]
            assert b.dtype == np.int32 and b.shape == (batch // dp, seq // sp)
            rows = slice(d * batch // dp, (d + 1) * batch // dp)
            cols = slice(s * seq // sp, (s + 1) * seq // sp)
            np.testing.assert_array_equal(b, want[rows, cols])


_PG_CALLS = ("all_reduce", "all_gather", "reduce_scatter", "broadcast",
             "batch_isend_irecv", "isend", "irecv", "send", "recv",
             "all_to_all", "barrier", "all_gather_object", "new_group")


@pytest.mark.parametrize("attention,zero1", [("ring", None),
                                             ("ulysses", "dp"),
                                             ("gathered", None)])
def test_one_rank_mesh_makes_no_process_group_call(monkeypatch, attention,
                                                   zero1):
    """dp = sp = tp = 1 elides every collective: a train step and a
    forward call nothing of ``torch.distributed`` (each call counted by a
    stub)."""
    import torch.distributed as dist

    calls = []
    for name in _PG_CALLS:
        monkeypatch.setattr(dist, name, lambda *a, _n=name, **k:
                            calls.append(_n))
    cfg = T.TransformerConfig(**{**FIELDS, "attention": attention,
                                 "zero1_axis": zero1, "ce_chunk": 8})
    mesh = make_mesh({"dp": 1, "sp": 1, "tp": 1}, device="cpu")
    step, init = T.make_train_step(cfg, mesh, lr=1e-2)
    p = from_jax_params(T.init_params(cfg), cfg, "cpu", train=True)
    p, state, loss = step(p, init(p), _tokens())
    T.make_forward(cfg, mesh)(from_jax_params(T.init_params(cfg), cfg,
                                              "cpu"), _tokens())
    assert np.isfinite(loss.item())
    assert calls == []


def test_grad_accum_keeps_the_reference_check(pool):
    """(batch / grad_accum) % dp == 0 on the global batch: 4 rows over dp 2
    leave 2 a rank, which 4 microbatches cannot split."""
    with pytest.raises(RuntimeError, match=r"batch 4 not divisible by "
                       r"grad_accum 4 with dp 2"):
        pool.run(TR.train_steps, fields={**FIELDS, "grad_accum": 4},
                 axes=DP2SP2, params=J.init_params(
                     J.TransformerConfig(**FIELDS)), tokens=_tokens())
