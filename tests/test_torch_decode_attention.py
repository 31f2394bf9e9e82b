"""The port's cached decode attention (ompi_tpu_torch.ops.decode_attention).

On the CPU the wrapper runs its plain PyTorch version, which must be the
cached step's attention block as it was written inline in
``models/decode.py`` (kept below as ``_inline_block``), bit for bit.  The
kernel runs only on a CUDA card (marked ``gpu``): it is held against the
plain version, and the caches it writes against the plain version's bit
for bit.  Output tolerances: the kernel and the plain version both
attend in f32 and differ only in the order of summation, so f32 outputs
agree to 2e-5 (the repo's f32 flash tolerance); bf16 outputs are those
f32 values rounded to nearest, so they agree to one bf16 ulp (2^-7
relative).
"""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np
import pytest
import torch

da = importlib.import_module("ompi_tpu_torch.ops.decode_attention")

F32_TOL = 2e-5
BF16_RTOL = 2.0 ** -7


def _inline_block(q, k, v, kc, vc, pos, positions):
    """models/decode.py's attention block before the kernel, verbatim."""
    f32 = torch.float32
    hd = kc.shape[3]
    kc[:, pos] = k[:, 0].to(kc.dtype)
    vc[:, pos] = v[:, 0].to(vc.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(f32),
                     kc.to(f32)) * (hd ** -0.5)
    s = torch.where(positions <= pos, s, -1e30)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", w, vc.to(f32))
    return o.to(q.dtype)


def _inputs(b, tmax, h, hd, dtype, device, seed=0):
    """q, k, v (B, 1, H, hd), caches (B, Tmax, H, hd) filled in every slot
    (so an untouched slot is checkable), positions; from numpy."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            device=device, dtype=dtype)

    return (t(b, 1, h, hd), t(b, 1, h, hd), t(b, 1, h, hd),
            t(b, tmax, h, hd), t(b, tmax, h, hd),
            torch.arange(tmax, device=device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pos", [0, 5, 23])
def test_plain_equals_the_inline_block_bit_for_bit(dtype, pos):
    q, k, v, kc, vc, positions = _inputs(3, 24, 4, 16, dtype, "cpu", pos)
    kc2, vc2 = kc.clone(), vc.clone()
    got = da.decode_attention(q, k, v, kc, vc, pos, positions)
    want = _inline_block(q, k, v, kc2, vc2, pos, positions)
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got, want)
    assert torch.equal(kc, kc2) and torch.equal(vc, vc2)
    assert torch.equal(kc[:, pos], k[:, 0])


def _bad(case):
    """Arguments of decode_attention broken one way, on the CPU."""
    q, k, v, kc, vc, positions = _inputs(2, 16, 2, 16, torch.float32, "cpu")
    pos = 3
    if case == "dtype":
        q, k, v, kc, vc = (x.half() for x in (q, k, v, kc, vc))
    elif case == "mixed_dtype":
        q = q.to(torch.bfloat16)
    elif case in ("hd12", "hd264"):
        hd = 12 if case == "hd12" else 264
        q, k, v, kc, vc, positions = _inputs(2, 16, 2, hd, torch.float32,
                                             "cpu")
    elif case == "noncontiguous_cache":
        kc = kc.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "pos_at_tmax":
        pos = 16
    elif case == "negative_pos":
        pos = -1
    elif case == "positions":
        positions = positions[:8]
    elif case == "shape":
        v = v[:1]
    return q, k, v, kc, vc, pos, positions


@pytest.mark.parametrize("case,exc", [
    ("dtype", TypeError), ("mixed_dtype", ValueError), ("hd12", ValueError),
    ("hd264", ValueError), ("noncontiguous_cache", ValueError),
    ("pos_at_tmax", ValueError), ("negative_pos", ValueError),
    ("positions", ValueError), ("shape", ValueError)])
def test_wrapper_raises_on_what_the_kernel_does_not_take(case, exc):
    args = _bad(case)
    kc_before = args[3].clone()
    with pytest.raises(exc, match="decode attention"):
        da.decode_attention(*args)
    assert torch.equal(args[3], kc_before)        # nothing written


@pytest.mark.parametrize("b,tmax,h,hd", [
    (1, 9, 16, 8),          # one lane a key on the card
    (2, 33, 3, 24),         # a row that is not a power of two of lanes
    (5, 17, 2, 256),        # the widest head: a whole warp a key
    (16, 40, 16, 128),      # the flagship's heads
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_equals_the_inline_block_at_the_kernels_shapes(b, tmax, h,
                                                              hd, dtype):
    """The shapes the card tests hold the kernel to, with pos at the
    first, a middle and the last slot."""
    for pos in (0, tmax // 2, tmax - 1):
        q, k, v, kc, vc, positions = _inputs(b, tmax, h, hd, dtype, "cpu",
                                             pos)
        kc2, vc2 = kc.clone(), vc.clone()
        got = da.decode_attention(q, k, v, kc, vc, pos, positions)
        want = _inline_block(q, k, v, kc2, vc2, pos, positions)
        assert torch.equal(got, want)
        assert torch.equal(kc, kc2) and torch.equal(vc, vc2)


@pytest.mark.parametrize("case,exc", [
    ("pos_at_tmax", ValueError), ("negative_pos", ValueError),
    ("noncontiguous_cache", ValueError)])
def test_per_call_checks_hold_once_the_shape_is_planned(case, exc):
    """Shapes and dtypes are checked once a shape; pos and the layout are
    still checked on every call after a good one of the same shape."""
    q, k, v, kc, vc, pos, positions = _bad(case)
    good = _inputs(2, 16, 2, 16, torch.float32, "cpu")
    da.decode_attention(*good[:5], 3, good[5])
    kc_before = kc.clone()
    with pytest.raises(exc, match="decode attention"):
        da.decode_attention(q, k, v, kc, vc, pos, positions)
    assert torch.equal(kc, kc_before)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


def _against_plain(b, h, tmax, hd, dtype, pos, seed=0):
    q, k, v, kc, vc, positions = _inputs(b, tmax, h, hd, dtype, "cuda",
                                         seed)
    kc2, vc2 = kc.clone(), vc.clone()
    before = da.launch_count
    got = da.decode_attention(q, k, v, kc, vc, pos, positions)
    want = da.decode_attention_plain(q, k, v, kc2, vc2, pos, positions)
    torch.cuda.synchronize()
    assert da.launch_count == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=F32_TOL, rtol=F32_TOL)
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=1e-5,
                                   rtol=BF16_RTOL)
    # slot pos holds the new k/v, every other slot is as it was
    assert torch.equal(kc, kc2) and torch.equal(vc, vc2)
    assert torch.equal(kc[:, pos], k[:, 0]) and torch.equal(vc[:, pos],
                                                            v[:, 0])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 64, 128])
@pytest.mark.parametrize("b", [1, 16, 256])
def test_kernel_matches_plain_on_the_card(b, hd, dtype):
    _card()
    tmax = 640
    for pos in (0, 333, tmax - 1):
        _against_plain(b, 16, tmax, hd, dtype, pos, seed=pos)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [8, 24, 256])
def test_kernel_takes_every_head_dim_on_the_card(hd, dtype):
    """Head dims whose rows are not a power of two of lanes (24: a lane
    of four idle), one lane a key (8), and a whole warp a key (256)."""
    _card()
    for b, pos in ((16, 100), (256, 77)):
        _against_plain(b, 4, 130, hd, dtype, pos, seed=hd)


@pytest.mark.gpu
def test_decoder_launches_the_kernel_once_a_layer_a_step():
    _card()
    from ompi_tpu_torch.models import transformer as T
    from ompi_tpu_torch.models.decode import make_decoder
    from ompi_tpu_torch.models.weights import from_jax_params
    from ompi_tpu_torch.parallel.mesh import make_mesh

    cfg = T.TransformerConfig(vocab=97, d_model=64, n_heads=4, n_layers=2,
                              d_ff=128, seq=64, attention="xla",
                              compute_dtype="float32")
    mesh = make_mesh({"dp": 1, "sp": 1, "tp": 1}, device="cuda")
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab, size=(4, 8)).astype(np.int32)
    max_new = 6
    for c in (cfg, dataclasses.replace(cfg, compute_dtype="bfloat16")):
        params = from_jax_params(T.init_params(c), c, "cuda")
        before = da.launch_count
        out = make_decoder(c, mesh, max_new=max_new)(params, prompt)
        torch.cuda.synchronize()
        assert da.launch_count - before == c.n_layers * (max_new - 1)
        assert out.shape == (4, 8 + max_new)
        np.testing.assert_array_equal(out[:, :8].cpu().numpy(), prompt)
