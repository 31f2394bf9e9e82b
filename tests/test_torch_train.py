"""Training in the port (ompi_tpu_torch.models) against the JAX package's,
on the CPU.

Both packages get the same parameters (``init_params`` makes the same
numpy draws) and the same tokens, on the f32 config of
tests/parallel/test_mesh_model.py:34-36 at dp = sp = tp = 1.  The JAX side
runs on a 1-device mesh with its Pallas kernels in interpret mode; the
port runs its plain versions.  Tolerances: loss 1e-5 and grads 2e-4 rel /
1e-6 abs for one value_and_grad (two f32 summation orders through two
layers); 1e-4 on losses after optimizer steps (the differences compound);
the chunked loss against the full one at test_mesh_model.py:69-86's
1e-6 / 2e-5.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ompi_tpu.models import transformer as J
from ompi_tpu.parallel.mesh import make_mesh as jax_mesh
from ompi_tpu_torch.models import transformer as T
from ompi_tpu_torch.models.weights import from_jax_params, to_numpy_params
from ompi_tpu_torch.parallel.mesh import make_mesh

FIELDS = dict(vocab=128, d_model=64, n_heads=4, n_layers=2, d_ff=128,
              seq=32, attention="ring", compute_dtype="float32")
LOSS_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-6
STEP_TOL = 1e-4


def _jmesh():
    return jax_mesh({"dp": 1, "sp": 1, "tp": 1}, devices=jax.devices()[:1])


def _tmesh():
    return make_mesh({"dp": 1, "sp": 1, "tp": 1}, device="cpu")


def _tokens(batch=4, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, FIELDS["vocab"],
                        size=(batch, FIELDS["seq"])).astype(np.int32)


@pytest.fixture
def bwd_kernel_var():
    import importlib

    from ompi_tpu.core.config import var_registry as jreg
    from ompi_tpu_torch.core.config import var_registry as treg

    for mod in ("ompi_tpu.ops.flash_attention",    # each registers the var
                "ompi_tpu_torch.ops.flash_attention"):
        importlib.import_module(mod)

    def set_both(on: bool):
        jreg.set("ops_flash_bwd_kernel", on)
        treg.set("ops_flash_bwd_kernel", on)

    yield set_both
    set_both(False)


def _port_value_and_grad(cfg, params_np, toks):
    params = from_jax_params(params_np, cfg, "cpu", train=True)
    loss = T.make_loss_fn(cfg, _tmesh())(params, toks)
    keys = list(params)
    grads = torch.autograd.grad(loss, [params[k] for k in keys])
    return loss.item(), {k: g.numpy() for k, g in zip(keys, grads)}


def _jax_value_and_grad(cfg, params_np, toks):
    loss, grads = jax.jit(jax.value_and_grad(J.make_loss_fn(cfg, _jmesh())))(
        params_np, toks)
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


def _assert_grads(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("attention", ["xla", "flash"])
def test_loss_and_grads_match_jax(attention, kernel, bwd_kernel_var):
    bwd_kernel_var(kernel)
    jc = J.TransformerConfig(**{**FIELDS, "attention": attention})
    tc = T.TransformerConfig(**{**FIELDS, "attention": attention})
    params = J.init_params(jc, seed=2)
    toks = _tokens()
    jl, jg = _jax_value_and_grad(jc, params, toks)
    tl, tg = _port_value_and_grad(tc, params, toks)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_TOL)
    _assert_grads(tg, jg)


def test_chunked_ce_matches_full_and_jax():
    cfg = T.TransformerConfig(**FIELDS)
    cfg_c = dataclasses.replace(cfg, ce_chunk=8)      # 32 / 8 = 4 chunks
    params = T.init_params(cfg)
    toks = _tokens()
    l_full, g_full = _port_value_and_grad(cfg, params, toks)
    l_chunk, g_chunk = _port_value_and_grad(cfg_c, params, toks)
    np.testing.assert_allclose(l_chunk, l_full, rtol=1e-6)
    _assert_grads(g_chunk, g_full, rtol=2e-5, atol=1e-6)
    jl, jg = _jax_value_and_grad(
        J.TransformerConfig(**FIELDS, ce_chunk=8), params, toks)
    np.testing.assert_allclose(l_chunk, jl, rtol=LOSS_TOL)
    _assert_grads(g_chunk, jg)


def test_untiled_ce_chunk_takes_the_full_path():
    """ce_chunk that does not divide T is ignored, silently, as in JAX."""
    cfg = T.TransformerConfig(**FIELDS)
    params = T.init_params(cfg)
    toks = _tokens()
    a = _port_value_and_grad(dataclasses.replace(cfg, ce_chunk=5), params,
                             toks)
    b = _port_value_and_grad(cfg, params, toks)
    assert a[0] == b[0]


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_policies_give_equal_numbers(remat):
    base = T.TransformerConfig(**{**FIELDS, "attention": "flash",
                                  "remat": None})
    params = T.init_params(base)
    toks = _tokens()
    l0, g0 = _port_value_and_grad(base, params, toks)
    l1, g1 = _port_value_and_grad(dataclasses.replace(base, remat=remat),
                                  params, toks)
    assert l1 == l0
    for k in g0:
        np.testing.assert_array_equal(g1[k], g0[k], err_msg=k)


def _jax_losses(cfg, params_np, toks, steps, lr=1e-2):
    step, init_opt = J.make_train_step(cfg, _jmesh(), lr=lr)
    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    opt_state = init_opt(params)
    losses = []
    for _ in range(steps):
        params, opt_state, loss = step(params, opt_state, toks)
        losses.append(float(loss))
    return losses, params, opt_state


def _port_losses(cfg, params_np, toks, steps, lr=1e-2):
    step, init_opt = T.make_train_step(cfg, _tmesh(), lr=lr)
    params = from_jax_params(params_np, cfg, "cpu", train=True)
    opt_state = init_opt(params)
    losses = []
    for _ in range(steps):
        params, opt_state, loss = step(params, opt_state, toks)
        losses.append(float(loss))
    return losses, params, opt_state


@pytest.fixture(scope="module")
def jax_three_steps():
    cfg = J.TransformerConfig(**{**FIELDS, "attention": "xla"})
    params = J.init_params(cfg, seed=3)
    losses, jparams, _ = _jax_losses(cfg, params, _tokens(), 3)
    return params, losses, {k: np.asarray(v) for k, v in jparams.items()}


def test_three_train_steps_match_jax(jax_three_steps):
    params, want, want_params = jax_three_steps
    cfg = T.TransformerConfig(**{**FIELDS, "attention": "xla"})
    got, tparams, state = _port_losses(cfg, params, _tokens(), 3)
    np.testing.assert_allclose(got, want, rtol=STEP_TOL)
    assert got[-1] < got[0]
    got_params = to_numpy_params(tparams)
    for k in want_params:
        np.testing.assert_allclose(got_params[k], want_params[k],
                                   rtol=STEP_TOL, atol=1e-5, err_msg=k)
    assert int(state.count) == 3 and state.count.dtype == torch.int32


def test_train_loop_equals_single_steps():
    cfg = T.TransformerConfig(**{**FIELDS, "attention": "flash"})
    params = T.init_params(cfg, seed=4)
    toks = _tokens()
    singles, p1, _ = _port_losses(cfg, params, toks, 3)
    loop, init_opt = T.make_train_loop(cfg, _tmesh(), lr=1e-2, steps=3)
    p2 = from_jax_params(params, cfg, "cpu", train=True)
    p2, _, losses = loop(p2, init_opt(p2), toks)
    assert losses.shape == (3,) and losses.dtype == torch.float32
    np.testing.assert_array_equal(losses.numpy(),
                                  np.asarray(singles, np.float32))
    for k in p1:
        assert torch.equal(p1[k], p2[k]), k


def test_grad_accum_matches_single_pass_and_jax():
    toks = _tokens(batch=8)
    losses = {}
    for acc in (1, 4):
        cfg = T.TransformerConfig(**{**FIELDS, "grad_accum": acc})
        losses[acc] = _port_losses(cfg, T.init_params(cfg), toks, 3)[0]
    assert abs(losses[1][-1] - losses[4][-1]) < 2e-3 * max(
        1.0, abs(losses[1][-1]))
    jc = J.TransformerConfig(**{**FIELDS, "grad_accum": 4})
    want = _jax_losses(jc, J.init_params(jc), toks, 3)[0]
    np.testing.assert_allclose(losses[4], want, rtol=STEP_TOL)


def test_grad_accum_errors():
    for acc, msg in ((0, "grad_accum must be"), (3, "not divisible")):
        cfg = T.TransformerConfig(**{**FIELDS, "grad_accum": acc})
        with pytest.raises(ValueError, match=msg):
            step, init_opt = T.make_train_step(cfg, _tmesh())
            params = from_jax_params(T.init_params(cfg), cfg, "cpu",
                                     train=True)
            step(params, init_opt(params), _tokens(batch=4))


def test_bf16_param_storage_master_weights():
    cfg = T.TransformerConfig(**{**FIELDS, "param_dtype": "bfloat16"})
    params_np = T.init_params(cfg)
    assert params_np["w1"].dtype == np.float32   # rounded in the loader
    step, init_opt = T.make_train_step(cfg, _tmesh(), lr=1e-2)
    params = from_jax_params(params_np, cfg, "cpu", train=True)
    assert params["w1"].dtype == torch.bfloat16 and params["w1"].is_leaf
    # the loader rounds as the JAX package's astype does
    want = np.asarray(jnp.asarray(params_np["w1"]).astype(jnp.bfloat16),
                      np.float32)
    np.testing.assert_array_equal(params["w1"].float().detach().numpy(),
                                  want)
    opt_state = init_opt(params)
    assert opt_state["master"]["w1"].dtype == torch.float32
    losses = []
    for _ in range(5):
        params, opt_state, loss = step(params, opt_state, _tokens())
        losses.append(float(loss))
    assert params["w1"].dtype == torch.bfloat16
    assert torch.equal(params["w1"],
                       opt_state["master"]["w1"].to(torch.bfloat16))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_bf16_adam_moments_stored_in_bf16():
    toks = _tokens()
    losses = {}
    for mu in (None, "bfloat16"):
        cfg = T.TransformerConfig(**{**FIELDS, "adam_mu_dtype": mu})
        ls, _, state = _port_losses(cfg, T.init_params(cfg), toks, 4)
        losses[mu] = ls[-1]
        want = torch.bfloat16 if mu == "bfloat16" else torch.float32
        assert state.mu["w1"].dtype == want
        assert state.nu["w1"].dtype == torch.float32
    assert np.isfinite(losses["bfloat16"])
    assert abs(losses[None] - losses["bfloat16"]) < 0.05 * abs(losses[None])
    jc = J.TransformerConfig(**{**FIELDS, "adam_mu_dtype": "bfloat16"})
    want = _jax_losses(jc, J.init_params(jc), toks, 4)[0]
    np.testing.assert_allclose(losses["bfloat16"], want[-1], rtol=STEP_TOL)


def test_lr_schedule_matches_jax():
    import optax

    sched = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=1e-2, warmup_steps=2, decay_steps=10)
    cfg = T.TransformerConfig(**FIELDS)
    params = T.init_params(cfg)
    got = _port_losses(cfg, params, _tokens(), 3, lr=sched)[0]
    want = _jax_losses(J.TransformerConfig(**FIELDS), params, _tokens(), 3,
                       lr=sched)[0]
    np.testing.assert_allclose(got, want, rtol=STEP_TOL)
    assert got[0] == got[1]    # lr(0) = 0: the first step moves nothing


def test_unembed_grads_match_jax_vjp_in_bf16():
    """grad_h and grad_emb of the bf16 unembed against JAX's VJP of its
    preferred_element_type=f32 einsum.  The port rounds the f32 cotangent
    to bf16 before its f32-accumulated products (the TPU's default
    precision) and both round the gradient to bf16, so each element may
    differ by 2^-8 of (|g| @ |operand| + |want|): half a bf16 ulp of every
    cotangent term and one ulp of the result."""
    rng = np.random.default_rng(7)
    cfg = T.TransformerConfig(**{**FIELDS, "compute_dtype": "bfloat16"})
    emb = np.array(jnp.asarray(T.init_params(cfg, seed=3)["emb"])
                   .astype(jnp.bfloat16).astype(jnp.float32))
    h = np.array(jnp.asarray(rng.normal(size=(2, 6, cfg.d_model)))
                 .astype(jnp.bfloat16).astype(jnp.float32))
    g = rng.normal(size=(2, 6, cfg.vocab)).astype(np.float32)

    def f(hh, ee):
        return jnp.einsum("btd,vd->btv", hh, ee,
                          preferred_element_type=jnp.float32)

    _, vjp = jax.vjp(f, jnp.asarray(h, jnp.bfloat16),
                     jnp.asarray(emb, jnp.bfloat16))
    jh, je = (np.asarray(x.astype(jnp.float32)) for x in vjp(jnp.asarray(g)))
    th = torch.from_numpy(h).to(torch.bfloat16).requires_grad_(True)
    te = torch.from_numpy(emb).to(torch.bfloat16).requires_grad_(True)
    T.unembed(th, te, torch.bfloat16).backward(torch.from_numpy(g))
    assert th.grad.dtype == te.grad.dtype == torch.bfloat16
    ag = np.abs(g)
    for got, want, mag in (
            (th.grad, jh, np.einsum("btv,vd->btd", ag, np.abs(emb))),
            (te.grad, je, np.einsum("btv,btd->vd", ag, np.abs(h)))):
        got = got.float().numpy()
        tol = 2.0 ** -8 * (mag + np.abs(want))
        assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()


def test_train_entry_points_turn_tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = True
    T.make_train_step(T.TransformerConfig(**FIELDS), _tmesh())
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
