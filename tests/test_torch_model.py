"""The port's flagship model (ompi_tpu_torch.models) against the JAX
package's, on the CPU.

Both packages get the same parameters (``init_params`` makes the same
numpy draws; ``from_jax_params`` loads them) and the same tokens.  The
JAX side runs on a 1-device mesh, its flash kernel in Pallas interpret
mode.  Logits agree in f32 to 1e-4 (different summation orders through
two layers; the values are O(1)).
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
from ompi_tpu_torch.models.weights import from_jax_params
from ompi_tpu_torch.parallel.mesh import make_mesh

FIELDS = dict(vocab=97, d_model=64, n_heads=4, n_layers=2, d_ff=128,
              seq=64, attention="xla", compute_dtype="float32")
LOGIT_TOL = 1e-4


def _jmesh():
    return jax_mesh({"dp": 1, "sp": 1, "tp": 1}, devices=jax.devices()[:1])


def _tmesh():
    return make_mesh({"dp": 1, "sp": 1, "tp": 1}, device="cpu")


def test_config_fields_and_defaults_match():
    jf = {f.name: f.default for f in dataclasses.fields(J.TransformerConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(T.TransformerConfig)}
    assert jf == tf
    assert T.TransformerConfig(**FIELDS).head_dim == 16


@pytest.mark.parametrize("extra", [{}, {"moe_experts": 4}])
@pytest.mark.parametrize("seed", [0, 5])
def test_init_params_bit_identical(seed, extra):
    jp = J.init_params(J.TransformerConfig(**FIELDS, **extra), seed=seed)
    tp = T.init_params(T.TransformerConfig(**FIELDS, **extra), seed=seed)
    assert sorted(jp) == sorted(tp)
    for k in jp:
        assert jp[k].dtype == tp[k].dtype
        np.testing.assert_array_equal(jp[k], tp[k])


@pytest.mark.parametrize("attention", ["xla", "flash", "ring", "ulysses",
                                       "gathered"])
def test_forward_logits_match_jax(attention):
    jc = J.TransformerConfig(**{**FIELDS, "attention": attention})
    tc = T.TransformerConfig(**{**FIELDS, "attention": attention})
    params = J.init_params(jc, seed=1)
    tokens = np.random.default_rng(0).integers(
        0, jc.vocab, size=(2, 16)).astype(np.int32)
    want = np.asarray(jax.jit(J.make_forward(jc, _jmesh()))(params, tokens))
    got = T.make_forward(tc, _tmesh())(from_jax_params(params, tc, "cpu"),
                                       tokens)
    assert got.dtype == torch.float32 and got.shape == (2, 16, jc.vocab)
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)


def test_rmsnorm_and_rope_match_jax_in_bf16():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    pos = np.arange(3, 8, dtype=np.int32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    for want, got in (
            (J._rmsnorm(jx, jnp.asarray(scale)),
             T._rmsnorm(tx, torch.from_numpy(scale))),
            (J._rope(jx, jnp.asarray(pos)),
             T._rope(tx, torch.from_numpy(pos)))):
        assert got.dtype == torch.bfloat16
        # one bf16 ulp: the f32 intermediates round in another order
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=1e-2, rtol=1e-2)


def test_dense_ffn_tail_uses_tanh_gelu():
    rng = np.random.default_rng(4)
    D, F = 16, 32
    h = rng.normal(size=(2, 3, D)).astype(np.float32)
    lp = {"ln2": np.ones((D,), np.float32),
          "w1": rng.normal(size=(D, F)).astype(np.float32),
          "w2": rng.normal(size=(F, D)).astype(np.float32) * 0.1}
    from ompi_tpu.mpi.device_comm import DeviceCommunicator as JComm
    from ompi_tpu_torch.mpi.device_comm import DeviceCommunicator

    want = J._dense_ffn_tail(jnp.asarray(h),
                             {k: jnp.asarray(v) for k, v in lp.items()},
                             JComm(_jmesh()), jnp.float32)
    got = T._dense_ffn_tail(torch.from_numpy(h),
                            {k: torch.from_numpy(v) for k, v in lp.items()},
                            DeviceCommunicator(_tmesh()), torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_from_jax_params_dtypes():
    cfg = T.TransformerConfig(**{**FIELDS, "compute_dtype": "bfloat16"})
    params = from_jax_params(T.init_params(cfg), cfg, "cpu")
    for k, v in params.items():
        want = torch.float32 if k.startswith("ln") else torch.bfloat16
        assert v.dtype == want, k
        assert v.device == torch.device("cpu")


def test_from_jax_params_takes_jax_bf16_arrays():
    cfg = T.TransformerConfig(**{**FIELDS, "compute_dtype": "bfloat16"})
    f32 = T.init_params(cfg)
    jbf = {k: np.asarray(jnp.asarray(v).astype(jnp.bfloat16))
           for k, v in f32.items()}
    a = from_jax_params(jbf, cfg, "cpu")
    b = from_jax_params(f32, cfg, "cpu")
    for k in a:
        assert torch.equal(a[k].float(), b[k].float()), k


def test_bf16_forward_is_finite_and_close_to_f32():
    cfg32 = T.TransformerConfig(**FIELDS)
    cfg16 = T.TransformerConfig(**{**FIELDS, "compute_dtype": "bfloat16",
                                   "attention": "flash"})
    params = T.init_params(cfg32, seed=3)
    tokens = np.arange(12, dtype=np.int32).reshape(1, 12)
    l32 = T.make_forward(cfg32, _tmesh())(
        from_jax_params(params, cfg32, "cpu"), tokens)
    l16 = T.make_forward(cfg16, _tmesh())(
        from_jax_params(params, cfg16, "cpu"), tokens)
    assert l16.dtype == torch.float32 and torch.isfinite(l16).all()
    assert (l16 - l32).abs().max() < 0.1


def _unembed_inputs(seed=4, b=2, t=5):
    """A bf16 config's emb (init_params, numpy seed) and a hidden state
    (b, t, d_model) drawn with numpy, both f32 arrays."""
    cfg = T.TransformerConfig(**{**FIELDS, "compute_dtype": "bfloat16"})
    emb = T.init_params(cfg, seed=seed)["emb"]
    h = np.random.default_rng(seed).normal(
        size=(b, t, cfg.d_model)).astype(np.float32)
    return h, emb


def test_unembed_logits_match_jax_bf16_einsum():
    """bf16 operands, f32 accumulation, f32 logits on both sides: equal
    up to the order of f32 sums, rel 1e-5 of the largest logit."""
    h, emb = _unembed_inputs()
    want = np.asarray(jnp.einsum(
        "btd,vd->btv", jnp.asarray(h).astype(jnp.bfloat16),
        jnp.asarray(emb).astype(jnp.bfloat16),
        preferred_element_type=jnp.float32))
    got = T.unembed(torch.from_numpy(h), torch.from_numpy(emb),
                    torch.bfloat16)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    ref = T.unembed_reference(torch.from_numpy(h), torch.from_numpy(emb),
                              torch.bfloat16)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


def test_f32_unembed_runs_full_f32_with_tf32_off(monkeypatch):
    """An f32 config multiplies f32 operands in full f32, TF32 off, in the
    forward and both backward products."""
    seen = []
    orig = T._mm_f32

    def spy(a, b):
        seen.append((a.dtype, b.dtype, torch.backends.cuda.matmul.allow_tf32))
        return orig(a, b)

    monkeypatch.setattr(T, "_mm_f32", spy)
    torch.backends.cuda.matmul.allow_tf32 = True
    cfg = T.TransformerConfig(**FIELDS)
    params = from_jax_params(T.init_params(cfg, seed=1), cfg, "cpu",
                             train=True)
    tokens = np.arange(16, dtype=np.int32).reshape(2, 8)
    loss = T.make_loss_fn(cfg, _tmesh())(params, tokens)
    loss.backward()
    assert seen == [(torch.float32, torch.float32, False)] * 3
    h = torch.from_numpy(_unembed_inputs()[0][0])
    emb = params["emb"].detach()
    got = T.unembed(h, emb, torch.float32)
    want = (h.double() @ emb.double().t()).float()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_training_only_options_do_not_change_the_forward():
    base = T.TransformerConfig(**FIELDS)
    other = dataclasses.replace(base, remat=False, ce_chunk=4, grad_accum=2,
                                zero1_axis="dp", adam_mu_dtype="bfloat16")
    params = from_jax_params(T.init_params(base), base, "cpu")
    tokens = np.arange(8, dtype=np.int32).reshape(1, 8)
    assert torch.equal(T.make_forward(base, _tmesh())(params, tokens),
                       T.make_forward(other, _tmesh())(params, tokens))


def test_model_build_turns_tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = True
    T.make_forward(T.TransformerConfig(**FIELDS), _tmesh())
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
