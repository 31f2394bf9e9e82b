"""The plain reference against the port's plain CPU path at a tiny size,
in float32 compute, from the same weights and tokens: loss, gradients,
the AdamW step, and the served logits.  The two implement the same
model, so they agree to rounding."""

from __future__ import annotations

import pytest
import torch

from benchmark import reference, weights

from .conftest import OPT, tiny_model


def _port(model: dict, seq: int, attention: str = "flash"):
    from ompi_tpu_torch.models.transformer import TransformerConfig
    from ompi_tpu_torch.parallel.mesh import make_mesh

    cfg = TransformerConfig(
        vocab=model["vocab"], d_model=model["d_model"],
        n_heads=model["n_heads"], n_layers=model["n_layers"],
        d_ff=model["d_ff"], seq=seq, attention=attention,
        moe_experts=model["moe_experts"], ce_chunk=16,
        compute_dtype="float32", remat="dots")
    return cfg, make_mesh({"dp": 1, "sp": 1, "tp": 1}, device="cpu")


@pytest.mark.parametrize("moe", [0, 4])
def test_loss_and_gradients_match_the_port(moe):
    from ompi_tpu_torch.models.transformer import make_loss_fn
    from ompi_tpu_torch.models.weights import from_jax_params

    model = tiny_model(moe)
    cfg, mesh = _port(model, 32)
    drawn = weights.make(model, 3, "cpu")
    tokens = torch.randint(0, model["vocab"], (3, 32),
                           generator=torch.Generator().manual_seed(0))
    p_port = from_jax_params(drawn, cfg, "cpu", train=True, mesh=mesh)
    l_port = make_loss_fn(cfg, mesh)(p_port, tokens)
    g_port = torch.autograd.grad(l_port, list(p_port.values()))
    p_ref = {k: v.clone().requires_grad_(True) for k, v in drawn.items()}
    l_ref = reference.loss(model, p_ref, tokens, 32)
    g_ref = torch.autograd.grad(l_ref, list(p_ref.values()))
    assert float(l_port) == pytest.approx(float(l_ref), rel=1e-5)
    for k, a, b in zip(p_port, g_port, g_ref):
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-6), k


def test_adamw_matches_the_port():
    from ompi_tpu_torch.models.optim import adamw

    gen = torch.Generator().manual_seed(1)
    params = {"a": torch.randn(5, 7, generator=gen),
              "b": torch.randn(3, generator=gen)}
    ours = {k: v.clone() for k, v in params.items()}
    opt = adamw(OPT["lr"], b1=OPT["b1"], b2=OPT["b2"], eps=OPT["eps"],
                weight_decay=OPT["weight_decay"])
    state = opt.init(params)
    ref = reference.AdamW(ours, OPT["lr"], OPT["b1"], OPT["b2"], OPT["eps"],
                          OPT["weight_decay"])
    for _ in range(3):
        grads = {k: torch.randn(v.shape, generator=gen)
                 for k, v in params.items()}
        updates, state = opt.update_(grads, state, params)
        for k in params:
            params[k] += updates[k]
        ref.step(ours, grads)
    for k in params:
        assert torch.allclose(params[k], ours[k], rtol=1e-6, atol=1e-7), k


def test_served_logits_match_the_port():
    from ompi_tpu_torch.models.transformer import make_forward
    from ompi_tpu_torch.models.weights import from_jax_params

    model = tiny_model()
    cfg, mesh = _port(model, 24)
    drawn = weights.make(model, 4, "cpu")
    tokens = torch.randint(0, model["vocab"], (2, 24),
                           generator=torch.Generator().manual_seed(2))
    full = make_forward(cfg, mesh)(from_jax_params(drawn, cfg, "cpu"),
                                   tokens)
    ours = reference.next_token_logits(model, drawn, tokens, 16)
    assert torch.allclose(full[:, 15:-1], ours, rtol=1e-4, atol=1e-5)


def test_the_float8_control_differs():
    model = tiny_model()
    drawn = weights.make(model, 5, "cpu")
    tokens = torch.randint(0, model["vocab"], (2, 24),
                           generator=torch.Generator().manual_seed(3))
    exact = reference.next_token_logits(model, drawn, tokens, 16)
    low = reference.next_token_logits(model, drawn, tokens, 16, "fp8")
    err = float((exact - low).abs().max())
    assert 1e-3 < err < 1.0
