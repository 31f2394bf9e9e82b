"""The port's KV-cache decode (ompi_tpu_torch.models.decode) against the
JAX package's, and against its own full forward, on the CPU.

The config is the JAX package's decode-test config
(tests/parallel/test_decode.py).  Greedy tokens must equal the JAX
decoder's exactly, and the cached decode must equal a token-by-token
full-forward greedy exactly (the cache-consistency contract).  Sampled
draws come from a torch.Generator and cannot equal jax.random's, so the
sampling tests check properties.  JAX is imported inside the test that
uses it, so that the card's test runs where JAX is absent.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from ompi_tpu_torch.models import transformer as T
from ompi_tpu_torch.models.decode import make_decoder
from ompi_tpu_torch.models.weights import from_jax_params
from ompi_tpu_torch.parallel.mesh import make_mesh

FIELDS = dict(vocab=97, d_model=64, n_heads=4, n_layers=2, d_ff=128,
              seq=64, attention="xla", compute_dtype="float32")
CFG = T.TransformerConfig(**FIELDS)


def _mesh():
    return make_mesh({"dp": 1, "sp": 1, "tp": 1}, device="cpu")


def _params(cfg=CFG):
    return from_jax_params(T.init_params(cfg), cfg, "cpu")


def _prompt(seed, t, b=4):
    return np.random.default_rng(seed).integers(
        0, CFG.vocab, size=(b, t)).astype(np.int32)


def _greedy_reference(fwd, params, prompt, max_new):
    """Grow the sequence one token at a time via full forwards."""
    cur = prompt
    for _ in range(max_new):
        logits = fwd(params, cur).numpy()
        nxt = logits[:, -1, :].argmax(-1).astype(np.int32)[:, None]
        cur = np.concatenate([cur, nxt], axis=1)
    return cur


@pytest.mark.parametrize("seed,t,max_new", [(0, 8, 5), (4, 7, 3)])
def test_greedy_tokens_equal_jax_decoder(seed, t, max_new):
    import jax

    from ompi_tpu.models import transformer as J
    from ompi_tpu.models.decode import make_decoder as jax_decoder
    from ompi_tpu.parallel.mesh import make_mesh as jax_mesh

    jcfg = J.TransformerConfig(**FIELDS)
    jmesh = jax_mesh({"dp": 1, "sp": 1, "tp": 1}, devices=jax.devices()[:1])
    prompt = _prompt(seed, t)
    want = np.asarray(jax_decoder(jcfg, jmesh, max_new=max_new)(
        J.init_params(jcfg), prompt))
    got = make_decoder(CFG, _mesh(), max_new=max_new)(_params(), prompt)
    assert got.dtype == torch.int32 and got.shape == (4, t + max_new)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("attention", ["xla", "flash"])
@pytest.mark.parametrize("seed,t,max_new", [(0, 8, 5), (4, 7, 3)])
def test_cached_decode_matches_full_forward(attention, seed, t, max_new):
    cfg = dataclasses.replace(CFG, attention=attention)
    params = _params(cfg)
    prompt = _prompt(seed, t)
    got = make_decoder(cfg, _mesh(), max_new=max_new)(params, prompt)
    np.testing.assert_array_equal(got.numpy()[:, :t], prompt)
    np.testing.assert_array_equal(
        got.numpy(),
        _greedy_reference(T.make_forward(cfg, _mesh()), params, prompt,
                          max_new))


def test_max_new_one_is_the_prefill_token():
    params, prompt = _params(), _prompt(1, 6)
    got = make_decoder(CFG, _mesh(), max_new=1)(params, prompt)
    want = _greedy_reference(T.make_forward(CFG, _mesh()), params, prompt, 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampled_decode_deterministic_and_valid():
    params, prompt = _params(), _prompt(2, 8)
    dec = make_decoder(CFG, _mesh(), max_new=6, temperature=0.8, top_k=10)
    a = dec(params, prompt, 7).numpy()
    b = dec(params, prompt, 7).numpy()
    c = dec(params, prompt, 8).numpy()
    np.testing.assert_array_equal(a, b)
    assert (a != c).any()          # different seed, different draws
    assert a.min() >= 0 and a.max() < CFG.vocab
    np.testing.assert_array_equal(a[:, :8], prompt)


def test_top_k_one_is_greedy():
    params, prompt = _params(), _prompt(3, 8)
    greedy = make_decoder(CFG, _mesh(), max_new=4)(params, prompt)
    top1 = make_decoder(CFG, _mesh(), max_new=4, temperature=1.0,
                        top_k=1)(params, prompt, 123)
    assert torch.equal(greedy, top1)


def test_sampling_validations_raise():
    with pytest.raises(ValueError, match="top_k"):
        make_decoder(CFG, _mesh(), max_new=2, top_k=5)
    with pytest.raises(ValueError, match="top_k"):
        make_decoder(CFG, _mesh(), max_new=2, temperature=1.0,
                     top_k=CFG.vocab + 1)
    with pytest.raises(ValueError, match="temperature"):
        make_decoder(CFG, _mesh(), max_new=2, temperature=-1.0)


class _SpMesh:
    shape = {"dp": 1, "sp": 2, "tp": 1}
    axis_names = ("dp", "sp", "tp")
    device = torch.device("cpu")


def test_decode_rejects_sp_and_missing_axes():
    with pytest.raises(ValueError, match="sp == 1"):
        make_decoder(CFG, _SpMesh(), max_new=2)
    with pytest.raises(ValueError, match="missing 'tp'"):
        make_decoder(CFG, make_mesh({"dp": 1, "sp": 1}, device="cpu"),
                     max_new=2)


@pytest.mark.gpu
def test_cached_decode_through_the_kernel_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    import importlib

    fa = importlib.import_module("ompi_tpu_torch.ops.flash_attention")
    cfg = dataclasses.replace(CFG, attention="flash")
    mesh = make_mesh({"dp": 1, "sp": 1, "tp": 1})
    params = from_jax_params(T.init_params(cfg), cfg, "cuda")
    prompt = _prompt(0, 8)
    before = fa.launch_count
    got = make_decoder(cfg, mesh, max_new=5)(params, prompt)
    assert fa.launch_count == before + cfg.n_layers
    fwd = T.make_forward(cfg, mesh)
    want = _greedy_reference(lambda p, x: fwd(p, x).cpu(), params, prompt, 5)
    np.testing.assert_array_equal(got.cpu().numpy(), want)
