"""The flash-attention backward of the port (ompi_tpu_torch.ops) against
the JAX package's.

On the CPU the port's backward runs the plain versions of its kernels
(``flash_bwd_reference``) or the materialized recompute; the JAX side runs
its Pallas backward kernels in interpret mode (``_flash_bwd_raw``) or its
XLA recompute, as the JAX package's own tests do.  Inputs are made with
numpy from a seed and handed to both.  Tolerances:
- the plain backward vs ``_flash_bwd_raw``: 1e-4 in f32 (two f32
  accumulation orders over T = 128 keys), 3e-2 of max|ref| in bf16 (a ds
  or p that rounds to the other side of a bf16 step);
- autograd gradients: 2e-4 with the recompute backward
  (tests/parallel/test_flash.py:59-72) and 2e-3 with the kernels
  (tests/parallel/test_flash.py:130-172).
The kernels themselves run only on a CUDA card (marked ``gpu``); JAX is
imported inside the tests that use it, so the card's tests run where JAX
is absent.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

tfa = importlib.import_module("ompi_tpu_torch.ops.flash_attention")

F32_TOL = 1e-4
BF16_TOL = 3e-2
GRAD_TOL = 2e-4
KERNEL_GRAD_TOL = 2e-3
#: (q_offset, k_offset); the last three are not multiples of the kernels'
#: 64- and 128-row tiles, so the diagonal crosses tiles off their edges
OFFSETS = [(0, 0), (128, 0), (0, 128), (64, 0), (0, 64), (100, 36)]


def _arrays(n, shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(n)]


def _jfa():
    return importlib.import_module("ompi_tpu.ops.flash_attention")


@pytest.fixture
def bwd_kernel_var():
    """Set ops_flash_bwd_kernel in both packages' registries; restored
    after the test."""
    from ompi_tpu.core.config import var_registry as jreg
    from ompi_tpu_torch.core.config import var_registry as treg

    _jfa()          # registers the var in the JAX package's registry

    def set_both(on: bool):
        jreg.set("ops_flash_bwd_kernel", on)
        treg.set("ops_flash_bwd_kernel", on)

    yield set_both
    set_both(False)


def _bwd_inputs(bh=4, t=128, d=32, seed=0):
    """q, k, v, g (BH, T, D) and a dm (BH, T) as the backward makes it
    (rowsum(g·out) with an lse cotangent folded in)."""
    q, k, v, g = _arrays(4, (bh, t, d), seed)
    dm = np.random.default_rng(seed + 1).normal(size=(bh, t)).astype(
        np.float32)
    return q, k, v, g, dm


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL),
                                       ("bfloat16", BF16_TOL)])
@pytest.mark.parametrize("offsets", OFFSETS)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_matches_jax_pallas(causal, offsets, dtype, tol):
    import jax.numpy as jnp

    q, k, v, g, dm = _bwd_inputs()
    # lse from the real forward, so p stays in range
    jq, jk, jv = (jnp.asarray(a).astype(jnp.dtype(dtype)) for a in (q, k, v))
    q_off, k_off = offsets
    qoff = jnp.asarray(q_off, jnp.int32).reshape(1)
    koff = jnp.asarray(k_off, jnp.int32).reshape(1)
    scale = q.shape[-1] ** -0.5
    _, jlse = _jfa()._flash_fwd_raw(jq, jk, jv, qoff, koff, scale, causal,
                                    128, 128, True)
    jg = jnp.asarray(g).astype(jnp.dtype(dtype))
    want = _jfa()._flash_bwd_raw(jq, jk, jv, jg, jlse, jnp.asarray(dm),
                                 qoff, koff, scale, causal, 128, 128, True)
    td = getattr(torch, dtype)
    got = tfa.flash_bwd_reference(
        *(torch.from_numpy(a).to(td) for a in (q, k, v, g)),
        torch.from_numpy(np.array(jlse)), torch.from_numpy(dm),
        q_off, k_off, scale, causal)
    for name, w, t in zip(("dq", "dk", "dv"), want, got):
        assert t.dtype == td and t.shape == (4, 128, 32), name
        w = np.asarray(w, np.float32)
        atol = tol * max(1.0, float(np.abs(w).max())) if dtype == \
            "bfloat16" else tol
        np.testing.assert_allclose(t.float().numpy(), w, atol=atol,
                                   rtol=tol, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_per_kernel_references_split_the_pair(causal):
    """flash_bwd_dq_reference and flash_bwd_dkv_reference (the plain
    versions timed beside each kernel) give flash_bwd_reference's parts."""
    q, k, v, g, dm = (torch.from_numpy(a).to(torch.bfloat16) if a.ndim == 3
                      else torch.from_numpy(a) for a in _bwd_inputs(t=96))
    lse = torch.from_numpy(_arrays(1, (4, 96), seed=9)[0]) + 5.0
    args = (q, k, v, g, lse, dm, 32, 0, 32 ** -0.5, causal)
    dq, dk, dv = tfa.flash_bwd_reference(*args)
    assert torch.equal(tfa.flash_bwd_dq_reference(*args), dq)
    dk2, dv2 = tfa.flash_bwd_dkv_reference(*args)
    assert torch.equal(dk2, dk) and torch.equal(dv2, dv)


def _grads_both(loss_j, loss_t, arrays):
    import jax
    import jax.numpy as jnp

    jg = jax.grad(loss_j, argnums=(0, 1, 2))(*map(jnp.asarray, arrays))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    loss_t(*ts).backward()
    return [np.asarray(a) for a in jg], [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("offsets", [(0, 0), (128, 0)])
def test_autograd_grads_match_jax(kernel, offsets, bwd_kernel_var):
    import jax.numpy as jnp

    bwd_kernel_var(kernel)
    q_off, k_off = offsets
    arrays = _arrays(3, (2, 128, 2, 32), seed=3)
    w = np.arange(2 * 128 * 2 * 32, dtype=np.float32).reshape(
        2, 128, 2, 32) / 1e4

    def loss_j(q, k, v):
        o = _jfa().flash_attention(q, k, v, causal=True, q_offset=q_off,
                                   k_offset=k_off)
        return (o * jnp.asarray(w)).sum()

    def loss_t(q, k, v):
        o = tfa.flash_attention(q, k, v, causal=True, q_offset=q_off,
                                k_offset=k_off)
        return (o * torch.from_numpy(w)).sum()

    tol = KERNEL_GRAD_TOL if kernel else GRAD_TOL
    for a, b in zip(*_grads_both(loss_j, loss_t, arrays)):
        np.testing.assert_allclose(b, a, atol=tol, rtol=tol)


@pytest.mark.parametrize("kernel", [False, True])
def test_lse_cotangent_matches_jax(kernel, bwd_kernel_var):
    """Gradient through the lse output (ring attention's merge path)."""
    import jax.numpy as jnp

    bwd_kernel_var(kernel)
    arrays = _arrays(3, (2, 128, 2, 32), seed=4)

    def loss_j(q, k, v):
        o, lse = _jfa().flash_attention_lse(q, k, v, causal=True)
        return o.astype(jnp.float32).sum() + (lse * 0.01).sum()

    def loss_t(q, k, v):
        o, lse = tfa.flash_attention_lse(q, k, v, causal=True)
        return o.float().sum() + (lse * 0.01).sum()

    tol = KERNEL_GRAD_TOL if kernel else GRAD_TOL
    for a, b in zip(*_grads_both(loss_j, loss_t, arrays)):
        np.testing.assert_allclose(b, a, atol=tol, rtol=tol)


@pytest.mark.parametrize("kernel", [False, True])
def test_lse_only_cotangent(kernel, bwd_kernel_var):
    """A loss that reads only lse: out's cotangent is absent (None)."""
    bwd_kernel_var(kernel)
    arrays = _arrays(3, (1, 64, 2, 16), seed=5)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    _, lse = tfa.flash_attention_lse(*ts, causal=True)
    lse.sum().backward()
    # d lse / d v = 0; d lse / d q = sum_k p k scale
    assert torch.equal(ts[2].grad, torch.zeros_like(ts[2]))
    assert torch.isfinite(ts[0].grad).all() and ts[0].grad.abs().sum() > 0


@pytest.mark.parametrize("kernel", [False, True])
def test_fully_masked_offsets_give_finite_grads_equal_to_jax(
        kernel, bwd_kernel_var):
    """q at 0.., k at 128..: every row fully masked.  p must be 0 (the
    second mask), so all gradients are zero and finite, as in JAX."""
    bwd_kernel_var(kernel)
    arrays = _arrays(3, (2, 128, 2, 32), seed=6)

    def loss_j(q, k, v):
        return (_jfa().flash_attention(q, k, v, causal=True, q_offset=0,
                                       k_offset=128) ** 2).sum()

    def loss_t(q, k, v):
        return (tfa.flash_attention(q, k, v, causal=True, q_offset=0,
                                    k_offset=128) ** 2).sum()

    for a, b in zip(*_grads_both(loss_j, loss_t, arrays)):
        assert np.isfinite(b).all()
        np.testing.assert_allclose(b, a, atol=GRAD_TOL, rtol=GRAD_TOL)


def test_kernel_and_recompute_backwards_agree(bwd_kernel_var):
    arrays = _arrays(3, (2, 96, 2, 16), seed=7)
    out = {}
    for kernel in (False, True):
        bwd_kernel_var(kernel)
        ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
        o, lse = tfa.flash_attention_lse(*ts, causal=True, q_offset=32)
        (o.square().sum() + lse.sum() * 0.1).backward()
        out[kernel] = [t.grad for t in ts]
    for a, b in zip(out[False], out[True]):
        torch.testing.assert_close(b, a, atol=KERNEL_GRAD_TOL,
                                   rtol=KERNEL_GRAD_TOL)


def test_bwd_var_reads_the_same_env_in_both_packages(monkeypatch):
    from ompi_tpu.core import config as jcfg
    from ompi_tpu_torch.core import config as tcfg

    for raw, want in (("1", True), ("yes", True), ("off", False)):
        monkeypatch.setenv("OMPI_TPU_MCA_ops_flash_bwd_kernel", raw)
        got = []
        for mod in (jcfg, tcfg):
            reg = mod.VarRegistry()
            reg.register(mod.Var(framework="ops", name="flash_bwd_kernel",
                                 vtype=mod.VarType.BOOL, default=False))
            got.append(reg.get("ops_flash_bwd_kernel"))
        assert got == [want, want]
    monkeypatch.setenv("OMPI_TPU_MCA_ops_flash_bwd_kernel", "maybe")
    reg = tcfg.VarRegistry()
    with pytest.raises(ValueError, match="ops_flash_bwd_kernel"):
        reg.register(tcfg.Var(framework="ops", name="flash_bwd_kernel",
                              vtype=tcfg.VarType.BOOL, default=False))


def test_bwd_var_registered_off_with_the_jax_description():
    from ompi_tpu.core.config import var_registry as jreg
    from ompi_tpu_torch.core.config import var_registry as treg

    _jfa()
    assert treg.get("ops_flash_bwd_kernel") is False
    assert (treg._vars["ops_flash_bwd_kernel"].description
            == jreg._vars["ops_flash_bwd_kernel"].description)


def test_cpu_backward_launches_no_kernel(bwd_kernel_var):
    bwd_kernel_var(True)
    ts = [torch.from_numpy(a).requires_grad_(True)
          for a in _arrays(3, (1, 64, 2, 16))]
    before = (tfa.launch_count, tfa.dq_launch_count, tfa.dkv_launch_count)
    tfa.flash_attention(*ts).sum().backward()
    assert (tfa.launch_count, tfa.dq_launch_count,
            tfa.dkv_launch_count) == before


def test_bwd_kernel_entry_refuses_bad_inputs():
    z = torch.zeros(4, 96, 32)
    l2 = torch.zeros(4, 96)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_bwd_3d(z, z, z, z, l2, l2, 0, 0, 1.0, True)
    with pytest.raises(ValueError, match="dm"):
        tfa.flash_bwd_3d(z, z, z, z, l2, l2.double(), 0, 0, 1.0, True)
    with pytest.raises(ValueError, match="g is"):
        tfa.flash_bwd_3d(z, z, z, z[:, :64], l2, l2, 0, 0, 1.0, True)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        h = z.half()
        tfa.flash_bwd_3d(h, h, h, h, l2, l2, 0, 0, 1.0, True)
    with pytest.raises(ValueError, match="head_dim"):
        w = torch.zeros(4, 96, 48)
        tfa.flash_bwd_3d(w, w, w, w, l2, l2, 0, 0, 1.0, True)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_kernels_match_plain_on_the_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    for d in (16, 32, 64, 128):
        # the Hopper kernels' 128-row blocks: 200 and 1024 beside 96
        for t in (7, 96, 256) + ((200, 1024) if d >= 64 else ()):
            q, k, v, g = (torch.randn((2, t, 2, d), generator=gen,
                                      device="cuda").to(dtype)
                          for _ in range(4))
            for causal in (True, False):
                for q_off, k_off in OFFSETS:
                    # the forward kernel's lse: the public entry would
                    # refuse T = 200, which no 128-row block tiles
                    q3, k3, v3, g3 = (tfa._to3(x) for x in (q, k, v, g))
                    _, lse3 = tfa.flash_fwd_3d(q3, k3, v3, q_off, k_off,
                                               d ** -0.5, causal)
                    dm = torch.randn((4, t), generator=gen, device="cuda")
                    before = (tfa.dq_launch_count, tfa.dkv_launch_count)
                    got = tfa.flash_bwd_3d(q3, k3, v3, g3, lse3, dm, q_off,
                                           k_off, d ** -0.5, causal)
                    want = tfa.flash_bwd_reference(q3, k3, v3, g3, lse3, dm,
                                                   q_off, k_off, d ** -0.5,
                                                   causal)
                    torch.cuda.synchronize()
                    assert (tfa.dq_launch_count, tfa.dkv_launch_count) == (
                        before[0] + 1, before[1] + 1)
                    for name, a, b in zip(("dq", "dk", "dv"), got, want):
                        assert a.dtype == dtype, name
                        scale = max(1.0, b.float().abs().max().item())
                        tol = (2e-3 if dtype == torch.float32
                               else 3e-2 * scale)
                        torch.testing.assert_close(
                            a.float(), b.float(), atol=tol,
                            rtol=2e-3 if dtype == torch.float32 else 3e-2,
                            msg=lambda m: f"{name} d={d} t={t} "
                            f"causal={causal} off=({q_off},{k_off}): {m}")


@pytest.mark.gpu
def test_autograd_kernel_path_matches_recompute_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from ompi_tpu_torch.core.config import var_registry

    gen = torch.Generator(device="cuda").manual_seed(1)
    base = [torch.randn((2, 256, 4, 64), generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(3)]
    out = {}
    try:
        for kernel in (False, True):
            var_registry.set("ops_flash_bwd_kernel", kernel)
            ts = [t.clone().requires_grad_(True) for t in base]
            o, lse = tfa.flash_attention_lse(*ts, causal=True)
            (o.float().square().sum() + lse.sum()).backward()
            out[kernel] = [t.grad.float() for t in ts]
    finally:
        var_registry.set("ops_flash_bwd_kernel", False)
    for a, b in zip(out[False], out[True]):
        scale = max(1.0, a.abs().max().item())
        torch.testing.assert_close(b, a, atol=3e-2 * scale, rtol=3e-2)
