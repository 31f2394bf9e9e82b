"""The port's flash attention (ompi_tpu_torch.ops.flash_attention) against
the JAX package's Pallas kernel.

On the CPU the port's wrapper runs its plain PyTorch version; the JAX
function runs its Pallas kernel in interpret mode, as the JAX package's
own tests do.  Inputs are made with numpy from a seed and handed to both.
Tolerances are the JAX package's flash tolerances
(tests/parallel/test_flash.py): 2e-5 in f32, 3e-2 in bf16.  The kernel
itself runs only on a CUDA card (marked ``gpu``); JAX is imported inside
the tests that use it, so that the card's tests run where JAX is absent.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

tfa = importlib.import_module("ompi_tpu_torch.ops.flash_attention")

F32_TOL = 2e-5
BF16_TOL = 3e-2
#: (q_offset, k_offset); the last three are not multiples of the kernels'
#: 64- and 128-row tiles, so the diagonal crosses tiles off their edges
OFFSETS = [(0, 0), (128, 0), (0, 128), (64, 0), (0, 64), (100, 36)]


def _qkv(b=2, t=96, h=2, d=32, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, t, h, d)).astype(np.float32)
            for _ in range(3)]


def _jfa():
    return importlib.import_module("ompi_tpu.ops.flash_attention")


def _both(arrays, dtype):
    """The same numpy arrays as JAX and torch arrays of ``dtype``."""
    import jax.numpy as jnp

    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return ([jnp.asarray(a).astype(jd) for a in arrays],
            [torch.from_numpy(a).to(td) for a in arrays])


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL),
                                       ("bfloat16", BF16_TOL)])
@pytest.mark.parametrize("offsets", OFFSETS)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_flash_matches_jax_pallas(causal, offsets, dtype, tol):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(), dtype)
    q_off, k_off = offsets
    jo, jl = _jfa().flash_attention_lse(jq, jk, jv, causal=causal,
                                     q_offset=q_off, k_offset=k_off)
    to, tl = tfa.flash_attention_lse(tq, tk, tv, causal=causal,
                                     q_offset=q_off, k_offset=k_off)
    assert to.dtype == tq.dtype and tl.dtype == torch.float32
    assert to.shape == tq.shape and tl.shape == (2, 2, 96)
    np.testing.assert_allclose(to.float().numpy(),
                               np.asarray(jo, np.float32), atol=tol, rtol=tol)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl, np.float32),
                               atol=tol, rtol=tol)


def test_fully_masked_rows_give_zero_and_finite_lse():
    (_, (tq, tk, tv)) = _both(_qkv(t=128), "float32")
    o, lse = tfa.flash_attention_lse(tq, tk, tv, causal=True, q_offset=0,
                                     k_offset=128)
    assert torch.isfinite(lse).all()
    assert (o == 0).all()


def test_flash_attention_drops_lse_and_keeps_dtype():
    (_, (tq, tk, tv)) = _both(_qkv(), "bfloat16")
    out = tfa.flash_attention(tq, tk, tv)
    o, _ = tfa.flash_attention_lse(tq, tk, tv)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, o)


@pytest.mark.parametrize("t_q,t_k", [(96, 96), (128, 256), (256, 128),
                                     (200, 128), (128, 200), (7, 7),
                                     (384, 512), (1, 1)])
@pytest.mark.parametrize("bq,bk", [(128, 128), (64, 128), (128, 32),
                                   (100, 100)])
def test_flash_tiles_agrees_with_jax(t_q, t_k, bq, bk):
    assert tfa.flash_tiles(t_q, t_k, bq, bk) == _jfa().flash_tiles(
        t_q, t_k, bq, bk)


def test_untileable_shapes_raise_in_both():
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(t=200), "float32")
    with pytest.raises(ValueError, match="must tile"):
        _jfa().flash_attention(jq, jk, jv)
    with pytest.raises(ValueError, match="must tile"):
        tfa.flash_attention(tq, tk, tv)


def test_requires_grad_raises_until_the_training_slice():
    """The op is differentiable: a leaf that requires grad gets a gradient
    (the backward's parity is in test_torch_flash_bwd.py), and
    forward-only use stays graph-free."""
    (_, (tq, tk, tv)) = _both(_qkv(), "float32")
    tq.requires_grad_(True)
    tfa.flash_attention(tq, tk, tv).sum().backward()
    assert tq.grad is not None and tq.grad.shape == tq.shape
    assert torch.isfinite(tq.grad).all() and tk.grad is None
    with torch.no_grad():
        assert tfa.flash_attention(tq, tk, tv).grad_fn is None


def test_cpu_path_launches_no_kernel():
    (_, (tq, tk, tv)) = _both(_qkv(), "float32")
    before = tfa.launch_count
    tfa.flash_attention(tq, tk, tv)
    assert tfa.launch_count == before


def test_kernel_entry_refuses_cpu_tensors():
    q3 = torch.zeros(4, 96, 32)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_fwd_3d(q3, q3, q3, 0, 0, 1.0, True)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa.flash_fwd_3d(q3.half(), q3.half(), q3.half(), 0, 0, 1.0, True)
    with pytest.raises(ValueError, match="head_dim"):
        z = torch.zeros(4, 96, 48)
        tfa.flash_fwd_3d(z, z, z, 0, 0, 1.0, True)


def test_missing_nvcc_raises_clearly(monkeypatch, tmp_path):
    from ompi_tpu_torch.ops import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc_path()


def test_block_vars_read_the_same_env_in_both_packages(monkeypatch):
    from ompi_tpu.core import config as jcfg
    from ompi_tpu_torch.core import config as tcfg

    monkeypatch.setenv("OMPI_TPU_MCA_ops_flash_block_q", "64")
    got = []
    for mod in (jcfg, tcfg):
        reg = mod.VarRegistry()
        reg.register(mod.Var(framework="ops", name="flash_block_q",
                             vtype=mod.VarType.INT, default=128))
        got.append(reg.get("ops_flash_block_q"))
    assert got == [64, 64]


def test_block_vars_are_registered_in_the_port():
    from ompi_tpu_torch.core.config import var_registry

    assert var_registry.get("ops_flash_block_q") == 128
    assert var_registry.get("ops_flash_block_k") == 128


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
def test_kernel_matches_plain_on_the_card(dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(0)
    for d in (16, 32, 64, 128):
        for t in (7, 96, 256):
            q, k, v = (torch.randn((2, t, 2, d), generator=g, device="cuda")
                       .to(dtype) for _ in range(3))
            for causal in (True, False):
                for q_off, k_off in OFFSETS:
                    before = tfa.launch_count
                    o, lse = tfa.flash_attention_lse(
                        q, k, v, causal=causal, q_offset=q_off,
                        k_offset=k_off)
                    ro, rl = tfa.flash_attention_lse_reference(
                        q, k, v, causal=causal, q_offset=q_off,
                        k_offset=k_off)
                    torch.cuda.synchronize()
                    assert tfa.launch_count == before + 1
                    torch.testing.assert_close(o.float(), ro.float(),
                                               atol=tol, rtol=tol)
                    torch.testing.assert_close(lse, rl, atol=tol, rtol=tol)
