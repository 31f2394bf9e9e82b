"""The MoE model family of the port against the JAX package's, on the CPU:
the forward, the loss and every gradient leaf, the steps, ZeRO-1 and the
cached decode, on one rank and over an ``ep`` axis of 4 ranks.

Counterpart of ``tests/parallel/test_moe_model.py`` (its f32 config at
``:15-17``, 8 experts) and of ``tests/parallel/test_decode.py:77-96``
(the MoE decode at ``moe_capacity_factor=4.0``).  Parameters from the JAX
package's ``init_params``, cut to each rank's tp and ep blocks by
``from_jax_params(..., mesh=)``; tokens from a numpy seed, each rank
passing its (B/dp, S/sp) shard.  The JAX side runs on 1 or 4 of the
suite's virtual CPU devices, the port on one process or 4 gloo rank
processes (``tests/torch_ranks.py``).  Tolerances (f32), those of
``tests/test_torch_model.py`` and ``tests/test_torch_mesh_*.py``: logits
1e-4 absolute, loss 1e-5 absolute, every gradient leaf 1e-4 relative L2,
steps' losses 1e-4 relative and each leaf's change over them 1e-4
relative L2, ZeRO-1 against the run without it 1e-6 relative, greedy
tokens exactly.

The expert leaves are where expert parallelism can go wrong: every ep
rank of a (dp, sp) coordinate holds the same tokens, so the backward
hands each expert's owner ep equal cotangent blocks.  Only a comparison
of every gradient leaf at ep > 1 sees that, which is what the mesh cases
make.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from ompi_tpu.models import transformer as J  # noqa: E402
from ompi_tpu.models.decode import make_decoder as jmake_decoder  # noqa: E402
from ompi_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402
from ompi_tpu_torch.models import transformer as T  # noqa: E402
from ompi_tpu_torch.models.decode import make_decoder  # noqa: E402
from ompi_tpu_torch.models.weights import (from_jax_params,  # noqa: E402
                                           to_numpy_params)
from ompi_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from tests import torch_ranks as TR  # noqa: E402

FIELDS = dict(vocab=128, d_model=64, n_heads=4, n_layers=2, d_ff=128,
              seq=32, attention="ring", compute_dtype="float32",
              moe_experts=8, remat=False)
LOGIT_ATOL = 1e-4
LOSS_ATOL = 1e-5
GRAD_RL2 = 1e-4
STEP_TOL = 1e-4
ZERO_TOL = 1e-6
ONE = {"dp": 1, "sp": 1, "tp": 1}


def _tokens(batch=4, seed=1, seq=FIELDS["seq"]):
    rng = np.random.default_rng(seed)
    return rng.integers(0, FIELDS["vocab"],
                        size=(batch, seq)).astype(np.int32)


def _jmesh(axes):
    n = int(np.prod(list(axes.values())))
    return jmake_mesh(dict(axes), devices=jax.devices()[:n])


def _jax_value_and_grad(fields, axes, params, tokens):
    loss, grads = jax.jit(jax.value_and_grad(J.make_loss_fn(
        J.TransformerConfig(**fields), _jmesh(axes))))(params, tokens)
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


def _one_rank(fields, params, tokens):
    """The port's loss and gradients as the step takes them, one process."""
    cfg = T.TransformerConfig(**fields)
    mesh = make_mesh(ONE, device="cpu")
    p = from_jax_params(params, cfg, "cpu", train=True)
    loss, grads = T._make_loss_and_grads(cfg, mesh)(p, tokens)
    return loss.item(), to_numpy_params(grads)


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _assert_updates(got, want, before, what):
    """Every leaf's change over the steps, relative L2 ≤ STEP_TOL.  Not
    element by element: Adam's normalised step maps a gradient entry near
    its eps (1e-8) to anything up to ±lr, and a rarely routed expert has
    such entries whose f32 values differ between the two packages (the
    gradients themselves are held leaf by leaf elsewhere)."""
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, (what, k)
        err = _rel_l2(got[k] - before[k], want[k] - before[k])
        assert err <= STEP_TOL, (what, k, err)


def _assert_same(loss, grads, want_loss, want_grads, what):
    assert abs(loss - want_loss) <= LOSS_ATOL, (what, loss, want_loss)
    assert sorted(grads) == sorted(want_grads)
    for k in want_grads:
        assert grads[k].shape == want_grads[k].shape, (what, k)
        assert _rel_l2(grads[k], want_grads[k]) <= GRAD_RL2, (
            what, k, _rel_l2(grads[k], want_grads[k]))


# ---------------------------------------------------------------------------
# one rank (ep = 1: the exchange elides)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("attention", ["xla", "flash", "ring"])
def test_moe_forward_logits_match_jax(attention):
    fields = {**FIELDS, "attention": attention}
    params = J.init_params(J.TransformerConfig(**fields), seed=2)
    toks = _tokens()
    want = np.asarray(jax.jit(J.make_forward(
        J.TransformerConfig(**fields), _jmesh(ONE)))(params, toks))
    cfg = T.TransformerConfig(**fields)
    got = T.make_forward(cfg, make_mesh(ONE, device="cpu"))(
        from_jax_params(params, cfg, "cpu"), toks)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("opts", [
    dict(), dict(remat="dots"), dict(remat="full", ce_chunk=8),
    dict(attention="xla", ce_chunk=16, moe_capacity_factor=0.5),
    dict(moe_experts=4, moe_aux_weight=0.5)],
    ids=["plain", "dots", "full-ce8", "xla-ce16-binding", "e4-aux0.5"])
def test_moe_loss_and_every_grad_match_jax_on_one_rank(opts):
    """At the config's capacity factor, at a binding one (0.5: many
    tokens dropped) and with a heavy balance loss, under every remat
    policy: the aux term and the dropped tokens' zero path included."""
    fields = {**FIELDS, **opts}
    params = J.init_params(J.TransformerConfig(**fields), seed=2)
    toks = _tokens()
    jl, jg = _jax_value_and_grad(fields, ONE, params, toks)
    ol, og = _one_rank(fields, params, toks)
    _assert_same(ol, og, jl, jg, "one rank vs JAX")


def test_moe_grad_accum_grads_and_steps_match_jax():
    """grad_accum = 2 at ep = 1: one step's accumulated gradients, every
    leaf, against the mean of the JAX package's gradients of the two
    microbatches (capacity and balance loss are per microbatch on both
    sides, as in its scanned step), and the losses of three
    ``make_train_loop`` steps and every leaf's change over them against
    its ``make_train_step``'s."""
    fields = {**FIELDS, "grad_accum": 2}
    params = J.init_params(J.TransformerConfig(**fields), seed=3)
    toks = _tokens(batch=4)
    micro = [_jax_value_and_grad(FIELDS, ONE, params, toks[i:i + 2])
             for i in (0, 2)]
    want_loss = (micro[0][0] + micro[1][0]) / 2
    want_grads = {k: (micro[0][1][k] + micro[1][1][k]) / 2
                  for k in micro[0][1]}
    loss, grads = _one_rank(fields, params, toks)
    _assert_same(loss, grads, want_loss, want_grads, "accumulated vs JAX")

    step, init_opt = J.make_train_step(J.TransformerConfig(**fields),
                                       _jmesh(ONE), lr=1e-2)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    state, want = init_opt(p), []
    for _ in range(3):
        p, state, jloss = step(p, state, toks)
        want.append(float(jloss))
    cfg = T.TransformerConfig(**fields)
    tp = from_jax_params(params, cfg, "cpu", train=True)
    run, init = T.make_train_loop(cfg, make_mesh(ONE, device="cpu"),
                                  lr=1e-2, steps=3)
    tp, _, losses = run(tp, init(tp), toks)
    np.testing.assert_allclose(losses.numpy(), want, rtol=STEP_TOL)
    assert losses[-1] < losses[0]
    _assert_updates(to_numpy_params(tp), {k: np.asarray(v) for k, v in
                                          p.items()}, params, "steps")


def _greedy_reference(fwd, params, prompt, max_new):
    cur = prompt
    for _ in range(max_new):
        logits = fwd(params, cur).numpy()
        nxt = logits[:, -1, :].argmax(-1).astype(np.int32)[:, None]
        cur = np.concatenate([cur, nxt], axis=1)
    return cur


DECODE = dict(FIELDS, moe_experts=4, moe_capacity_factor=4.0,
              attention="xla")


@pytest.mark.parametrize("factor", [4.0, 1.25])
def test_moe_decode_tokens_equal_jax_decoder(factor):
    """Greedy cached MoE decode at ep = 1: the tokens equal the JAX
    decoder's exactly, at a capacity that never binds (4.0, where the
    cached path also equals a full-forward greedy) and at the default
    1.25, where each cached step's capacity comes from its B tokens, as
    in the JAX package."""
    fields = {**DECODE, "moe_capacity_factor": factor}
    params = J.init_params(J.TransformerConfig(**fields))
    prompt = np.random.default_rng(1).integers(
        0, fields["vocab"], size=(4, 6)).astype(np.int32)
    want = np.asarray(jmake_decoder(J.TransformerConfig(**fields),
                                    _jmesh(ONE), max_new=4)(params, prompt))
    cfg = T.TransformerConfig(**fields)
    mesh = make_mesh(ONE, device="cpu")
    p = from_jax_params(params, cfg, "cpu")
    got = make_decoder(cfg, mesh, max_new=4)(p, prompt).numpy()
    np.testing.assert_array_equal(got, want)
    if factor == 4.0:
        np.testing.assert_array_equal(got, _greedy_reference(
            T.make_forward(cfg, mesh), p, prompt, 4))


def test_moe_param_specs_follow_the_mesh():
    cfg = T.TransformerConfig(**FIELDS)

    class _M:
        axis_names = ("dp", "sp", "tp", "ep")

    specs = T.param_specs(cfg, _M())
    assert specs["w1"] == specs["w2"] == (None, "ep", None, None)
    assert specs["wg"] == () and specs["wq"] == (None, None, "tp")
    flat = T.param_specs(cfg, make_mesh(ONE, device="cpu"))
    assert flat["w1"] == flat["w2"] == ()
    assert T.param_specs()["w1"] == (None, None, "tp")
    assert T.layer_keys(cfg) == T.LAYER_KEYS + ("wg",)


def test_moe_experts_must_divide_the_ep_axis():
    class _M:
        shape = {"dp": 1, "sp": 1, "tp": 1, "ep": 3}
        axis_names = tuple(shape)
        device = torch.device("cpu")

    cfg = T.TransformerConfig(**FIELDS)
    for call in (lambda: T.make_loss_fn(cfg, _M()),
                 lambda: make_decoder(cfg, _M(), max_new=2)):
        with pytest.raises(ValueError, match="not divisible by the mesh's "
                                             "ep axis"):
            call()


# ---------------------------------------------------------------------------
# 4 ranks: ep = 4, and ep = 2 beside dp, tp or sp
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = TR.RankPool(tmp_path_factory.mktemp("ranks"))
    yield p
    p.close()


EP4 = {"dp": 1, "sp": 1, "tp": 1, "ep": 4}
DP2EP2 = {"dp": 2, "sp": 1, "tp": 1, "ep": 2}
TP2EP2 = {"dp": 1, "sp": 1, "tp": 2, "ep": 2}
SP2EP2 = {"dp": 1, "sp": 2, "tp": 1, "ep": 2}

#: (mesh, config options, also against the one-rank run): the one-rank
#: run has the same per-rank tokens, and so the same capacities and
#: balance loss, only where dp = sp = 1
CASES = {
    "ep4-dots": (EP4, dict(remat="dots"), True),
    "dp2ep2-ce8": (DP2EP2, dict(ce_chunk=8), False),
    "tp2ep2-ulysses": (TP2EP2, dict(attention="ulysses"), True),
    "sp2ep2-ring-dots": (SP2EP2, dict(remat="dots"), False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_loss_and_every_grad_match_jax_over_ep(pool, case):
    axes, opts, vs_one = CASES[case]
    fields = {**FIELDS, **opts}
    params = J.init_params(J.TransformerConfig(**fields), seed=2)
    toks = _tokens()
    res = pool.run(TR.model_grads, fields=fields, axes=axes, params=params,
                   tokens=toks)
    jl, jg = _jax_value_and_grad(fields, axes, params, toks)
    if vs_one:
        ol, og = _one_rank(fields, params, toks)
    for r, (loss, grads) in enumerate(res):
        _assert_same(loss, grads, jl, jg, f"rank {r} vs JAX")
        if vs_one:
            _assert_same(loss, grads, ol, og, f"rank {r} vs one rank")


def _jax_steps(fields, axes, params, tokens, steps=3, lr=1e-2):
    step, init_opt = J.make_train_step(J.TransformerConfig(**fields),
                                       _jmesh(axes), lr=lr)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    state, losses = init_opt(p), []
    for _ in range(steps):
        p, state, loss = step(p, state, tokens)
        losses.append(float(loss))
    return losses, {k: np.asarray(v) for k, v in p.items()}


def test_moe_steps_at_dp2ep2_match_jax_and_zero1_matches_without(pool):
    """Three AdamW steps on {dp: 2, ep: 2} against the JAX package's (the
    losses, and every leaf's change as :func:`_assert_updates`), and
    the same steps with ZeRO-1 over dp (each rank updating half of its
    local block of every leaf, the expert blocks included) against the
    run without it."""
    params = J.init_params(J.TransformerConfig(**FIELDS), seed=3)
    toks = _tokens()
    want, want_params = _jax_steps(FIELDS, DP2EP2, params, toks)
    plain = pool.run(TR.train_steps, fields=FIELDS, axes=DP2EP2,
                     params=params, tokens=toks)
    zero = pool.run(TR.train_steps, fields={**FIELDS, "zero1_axis": "dp"},
                    axes=DP2EP2, params=params, tokens=toks)
    E, D, F = FIELDS["moe_experts"], FIELDS["d_model"], FIELDS["d_ff"]
    L = FIELDS["n_layers"]
    for (losses, got, _), (z_losses, z_got, facts) in zip(plain, zero):
        np.testing.assert_allclose(losses, want, rtol=STEP_TOL)
        assert losses[-1] < losses[0]
        _assert_updates(got, want_params, params, "steps vs JAX")
        np.testing.assert_allclose(z_losses, losses, rtol=ZERO_TOL)
        for k in got:
            np.testing.assert_allclose(z_got[k], got[k], rtol=ZERO_TOL,
                                       atol=1e-7, err_msg=k)
        # the expert leaves keep their ep block; ZeRO-1 holds half of it
        assert facts["shapes"]["w1"] == (L, E // 2, D, F)
        assert facts["master"]["w1"] == L * (E // 2) * D * F // 2


def test_moe_from_jax_params_cuts_ep_blocks_and_to_numpy_gathers(pool):
    params = J.init_params(J.TransformerConfig(**FIELDS), seed=2)
    res = pool.run(TR.train_steps, fields=FIELDS, axes=TP2EP2,
                   params=params, tokens=_tokens(), steps=0)
    L, D, F, E = (FIELDS["n_layers"], FIELDS["d_model"], FIELDS["d_ff"],
                  FIELDS["moe_experts"])
    for _, whole, facts in res:
        shapes = facts["shapes"]
        assert shapes["w1"] == (L, E // 2, D, F)       # ep blocks, no tp
        assert shapes["w2"] == (L, E // 2, F, D)
        assert shapes["wg"] == (L, D, E)
        assert shapes["wq"] == (L, D, D // 2)          # tp blocks
        for k in params:
            np.testing.assert_array_equal(whole[k], params[k], err_msg=k)


def test_moe_decode_at_dp2ep2_equals_jax(pool):
    """Cached MoE decode over {dp: 2, ep: 2}: each dp rank decodes its
    half of the prompts; the tokens equal the JAX decoder's on the same
    mesh (mirrors tests/parallel/test_decode.py:77-96)."""
    cfg = J.TransformerConfig(**DECODE)
    params = J.init_params(cfg)
    prompt = np.random.default_rng(1).integers(
        0, cfg.vocab, size=(4, 6)).astype(np.int32)
    want = np.asarray(jmake_decoder(cfg, _jmesh(DP2EP2), max_new=4)(
        params, prompt))
    res = pool.run(TR.decode_tokens, fields=DECODE, axes=DP2EP2,
                   params=params, prompt=prompt, max_new=4)
    for r, got in enumerate(res):
        dp = r // 2
        np.testing.assert_array_equal(got, want[2 * dp:2 * dp + 2],
                                      err_msg=f"rank {r}")
    # the ep ranks of one dp coordinate agree, as they must
    np.testing.assert_array_equal(res[0], res[1])


def test_moe_dataclass_replace_keeps_the_family():
    cfg = dataclasses.replace(T.TransformerConfig(**FIELDS), moe_experts=2)
    assert T.layer_keys(cfg)[-1] == "wg"
