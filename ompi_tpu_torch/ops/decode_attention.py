"""Cached decode attention: one new token against a layer's KV cache.

The attention block of the cached decode step (``models/decode.py``
``_step_layer``): the new token's k and v are stored into slot ``pos`` of
the layer's caches in place, and its q attends over the slots 0..pos in
f32.  On a CUDA tensor :func:`decode_attention` launches the hand-written
Hopper kernel in ``csrc/decode_attn.cu`` (built by ``_build`` at first
use), which does the cache write and the attention in one launch; on a
CPU tensor it runs the plain PyTorch version,
:func:`decode_attention_plain`, which is also what the kernel is held
against on the card.  There is no fallback between the two: a CUDA
tensor launches the kernel or raises.

The kernel replaces no TPU kernel: the JAX package computes this block
with plain einsums (``ompi_tpu/models/decode.py``).  It is bound by the
bytes of K and V: the plain version casts the whole cache to f32 and
copies it into the einsums' layout every layer of every step, where the
kernel reads each valid bf16 row once (the source's note says how).
"""

from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["decode_attention", "decode_attention_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 256

#: launches of the kernel so far (one a call)
launch_count = 0


def decode_attention_plain(q, k, v, kc, vc, pos: int, positions):
    """The block as the cached step ran it in plain PyTorch: write the
    token's k/v into slot ``pos`` of ``kc``/``vc`` in place, then attend
    in f32 over all Tmax slots with the slots after ``pos`` masked to
    -1e30, as in the JAX package.  → (B, 1, H, hd) in q's dtype."""
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


@functools.lru_cache(maxsize=64)
def _plan(q, k, v, kc, vc, positions, dtypes, device):
    """What both versions take, checked once a shape: q/k/v (B, 1, H, hd)
    and caches (B, Tmax, H, hd) on one device, all float32 or all
    bfloat16, hd a multiple of 8 up to 256, ``positions`` the (Tmax,)
    slot numbers.  The arguments are the operands' shapes, their dtypes
    and the cache's device; → (B, Tmax, H, hd)."""
    if len(kc) != 4:
        raise ValueError(f"decode attention: cache must be (B, Tmax, H, hd)"
                         f", got {tuple(kc)}")
    B, tmax, H, hd = kc
    dtype = dtypes[3]
    if dtype not in _DTYPES:
        raise TypeError(f"decode attention takes float32 or bfloat16, got "
                        f"{dtype}")
    if hd % 8 or not 0 < hd <= _MAX_HEAD_DIM:
        raise ValueError(f"decode attention takes a head dim that is a "
                         f"multiple of 8 up to {_MAX_HEAD_DIM}, got {hd}")
    for name, shape, t_dtype, want in (
            ("q", q, dtypes[0], (B, 1, H, hd)),
            ("k", k, dtypes[1], (B, 1, H, hd)),
            ("v", v, dtypes[2], (B, 1, H, hd)),
            ("vc", vc, dtypes[4], (B, tmax, H, hd))):
        if tuple(shape) != want or t_dtype != dtype:
            raise ValueError(f"decode attention: {name} is "
                             f"{tuple(shape)} {t_dtype}, want {want} "
                             f"{dtype}")
    if tuple(positions) != (tmax,):
        raise ValueError(f"decode attention: positions is "
                         f"{tuple(positions)}, want ({tmax},)")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"decode attention runs on cuda or cpu, not "
                         f"{device}")
    return B, tmax, H, hd


@functools.cache
def _fn():
    """The kernel's C entry point, built, loaded and bound once."""
    from ompi_tpu_torch.ops import _build

    fn = _build.load("decode_attn.cu").ompi_decode_attn
    vp, ci = ctypes.c_void_p, ctypes.c_int
    # q, k, v, kc, vc, pos, o, b, h, tmax, d, dtype, scale, stream
    fn.argtypes = [vp] * 5 + [ci, vp] + [ci] * 5 + [ctypes.c_float, vp]
    fn.restype = ci
    return fn


def _launch(q, k, v, kc, vc, pos: int, B: int, tmax: int, H: int, hd: int):
    global launch_count
    ptrs = [t.data_ptr() for t in (q, k, v, kc, vc)]
    if any(p % 16 for p in ptrs):
        raise ValueError("decode attention kernel: operands must be 16-byte "
                         "aligned")
    dev = kc.device
    o = torch.empty_like(q)
    with torch.cuda.device(dev):
        err = _fn()(*ptrs, pos, o.data_ptr(), B, H, tmax, hd,
                    _DTYPES[kc.dtype], hd ** -0.5,
                    torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode attention launch failed: CUDA error "
                           f"{err} (B={B} H={H} Tmax={tmax} hd={hd}, "
                           f"{kc.dtype})")
    launch_count += 1
    return o


def decode_attention(q, k, v, kc, vc, pos: int, positions):
    """Store the new token's k/v (B, 1, H, hd) into slot ``pos`` of the
    caches ``kc``/``vc`` (B, Tmax, H, hd) in place and attend its q
    (B, 1, H, hd) over the slots 0..pos → (B, 1, H, hd) in q's dtype.

    ``positions`` is the (Tmax,) slot numbers (``arange(Tmax)``), which
    the plain version masks with.  Shapes and dtypes are checked once a
    shape (``_plan``); ``pos``, contiguity and the device every call."""
    pos = int(pos)
    B, tmax, H, hd = _plan(
        q.shape, k.shape, v.shape, kc.shape, vc.shape, positions.shape,
        (q.dtype, k.dtype, v.dtype, kc.dtype, vc.dtype), kc.device)
    if not 0 <= pos < tmax:
        raise ValueError(f"decode attention: pos {pos} outside the cache's "
                         f"{tmax} slots")
    for t in (q, k, v, kc, vc, positions):
        if t.device != kc.device or not t.is_contiguous():
            raise ValueError("decode attention: operands must be contiguous "
                             "and on one device")
    if kc.device.type == "cpu":
        return decode_attention_plain(q, k, v, kc, vc, pos, positions)
    return _launch(q, k, v, kc, vc, pos, B, tmax, H, hd)
