"""Flash attention: blockwise online-softmax attention, forward only.

The port of ``ompi_tpu.ops.flash_attention``.  On a CUDA tensor the
wrapper launches the hand-written Hopper kernel in ``csrc/flash_fwd.cu``
(built by ``_build`` at first use); on a CPU tensor it runs the plain
PyTorch version, :func:`flash_attention_lse_reference`, which is also
what the kernel is held against on the card.  There is no fallback
between the two: a CUDA tensor launches the kernel or raises.

Public layout as in the JAX package: q (B, Tq, H, D), k/v (B, Tk, H, D)
→ out (B, Tq, H, D) in q's dtype and lse (B, H, Tq) float32.  The kernel
reads the (B·H, T, D) layout the JAX package's ``_to3`` makes.

This slice is forward only: the backward kernels and the recompute
backward come with the training slice (ROADMAP.md, port slice 1), so an
input that requires grad raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ompi_tpu_torch.core.config import VarType, register_var

__all__ = ["flash_attention", "flash_attention_lse",
           "flash_attention_lse_reference", "flash_fwd_3d", "flash_tiles"]

register_var("ops", "flash_block_q", VarType.INT, 128,
             "flash kernel q-block rows (tiling rule; t_q must tile by it)")
register_var("ops", "flash_block_k", VarType.INT, 128,
             "flash kernel k/v block size (tiling rule; t_k must tile by it)")

_NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)

#: kernel launches so far; chip_smoke.py zeroes it around the main path
launch_count = 0


def flash_tiles(t_q: int, t_k: int, block_q: int = 128,
                block_k: int = 128) -> bool:
    """True when these sequence lengths tile for :func:`flash_attention`
    (the single source of the tiling rule)."""
    return (t_q % min(block_q, t_q) == 0 and t_k % min(block_k, t_k) == 0
            and t_q > 0 and t_k > 0)


def _check_blocks(q, k, block_q, block_k):
    t_q, t_k = q.shape[1], k.shape[1]
    if not flash_tiles(t_q, t_k, block_q, block_k):
        raise ValueError(
            f"flash_attention: T ({t_q},{t_k}) must tile by blocks "
            f"({block_q},{block_k})")
    return min(block_q, t_q), min(block_k, t_k)


def _to3(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, D) → contiguous (B·H, T, D)."""
    b, t, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, t, d).contiguous()


def _from3(x3: torch.Tensor, b: int, h: int) -> torch.Tensor:
    bh, t, d = x3.shape
    return x3.view(b, h, t, d).permute(0, 2, 1, 3)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def attention_plain(q, k, v, causal: bool, q_offset: int, k_offset: int,
                    scale: float):
    """Materialized attention: (o (B, Tq, H, D) float32, lse (B, H, Tq)
    float32).  Products take the storage-dtype operands upcast to f32
    (exact for bf16) with f32 accumulation; the weights are rounded to
    the storage dtype before P·V, as in the kernel."""
    f32 = torch.float32
    t_q, t_k = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(f32), k.to(f32)) * scale
    if causal:
        qpos = q_offset + torch.arange(t_q, device=q.device)
        kpos = k_offset + torch.arange(t_k, device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        s = torch.where(mask, s, _NEG)
    m = s.amax(dim=-1)                                        # (B,H,Tq)
    w = torch.exp(s - m[..., None])
    if causal:
        w = torch.where(mask, w, 0.0)
    safe_l = w.sum(dim=-1).clamp_min(1e-30)
    o = torch.einsum("bhqk,bkhd->bqhd", w.to(q.dtype).to(f32), v.to(f32))
    o = o / safe_l.transpose(1, 2)[..., None]
    return o, m + torch.log(safe_l)


def flash_attention_lse_reference(q, k, v, causal: bool = True,
                                  q_offset=0, k_offset=0,
                                  scale: Optional[float] = None):
    """The plain version of the kernel: out in q's dtype, lse float32."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    o, lse = attention_plain(q, k, v, bool(causal), int(q_offset),
                             int(k_offset), float(scale))
    return o.to(q.dtype), lse


# ---------------------------------------------------------------------------
# kernel
# ---------------------------------------------------------------------------

def _kernel_fn():
    from ompi_tpu_torch.ops import _build

    lib = _build.load("flash_fwd.cu")
    fn = lib.ompi_flash_fwd
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ctypes.c_float,
                   ci, ci, ci, vp]
    fn.restype = ci
    return fn


def flash_fwd_3d(q3, k3, v3, q_offset: int, k_offset: int, scale: float,
                 causal: bool):
    """Launch the kernel on (B·H, T, D) CUDA tensors → (o3 (B·H, Tq, D)
    in the storage dtype, lse (B·H, Tq) float32)."""
    global launch_count
    bh, t_q, d = q3.shape
    t_k = k3.shape[1]
    if q3.dtype not in _DTYPES:
        raise TypeError(f"flash kernel takes float32 or bfloat16, "
                        f"got {q3.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {_HEAD_DIMS}, "
                         f"got {d}")
    for name, t in (("k", k3), ("v", v3)):
        if t.shape != (bh, t_k, d) or t.dtype != q3.dtype:
            raise ValueError(f"flash kernel: {name} is {tuple(t.shape)} "
                             f"{t.dtype}, want {(bh, t_k, d)} {q3.dtype}")
    for t in (q3, k3, v3):
        if (t.device.type != "cuda" or t.device != q3.device
                or not t.is_contiguous()):
            raise ValueError("flash kernel: q/k/v must be contiguous and "
                             "on one CUDA device")
    fn = _kernel_fn()
    o3 = torch.empty_like(q3)
    lse = torch.empty((bh, t_q), dtype=torch.float32, device=q3.device)
    with torch.cuda.device(q3.device):
        stream = torch.cuda.current_stream(q3.device).cuda_stream
        err = fn(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
                 o3.data_ptr(), lse.data_ptr(), bh, t_q, t_k, d,
                 _DTYPES[q3.dtype], float(scale), int(bool(causal)),
                 int(q_offset), int(k_offset), stream)
    if err != 0:
        raise RuntimeError(f"flash kernel launch failed: CUDA error {err} "
                           f"(shape bh={bh} tq={t_q} tk={t_k} d={d}, "
                           f"{q3.dtype})")
    launch_count += 1
    return o3, lse


# ---------------------------------------------------------------------------
# public op
# ---------------------------------------------------------------------------

def flash_attention(q, k, v, causal: bool = True, q_offset=0, k_offset=0,
                    scale: Optional[float] = None, block_q: int = 128,
                    block_k: int = 128):
    """Blockwise-streamed exact attention.  Same contract as
    parallel.attention.local_attention: q (B, Tq, H, D), k/v (B, Tk, H, D)
    → (B, Tq, H, D); offsets give global positions for causal masking of
    sequence slices.  Shapes must tile (Tq % block_q == 0,
    Tk % block_k == 0, blocks shrinking to T)."""
    out, _ = flash_attention_lse(q, k, v, causal=causal, q_offset=q_offset,
                                 k_offset=k_offset, scale=scale,
                                 block_q=block_q, block_k=block_k)
    return out


def flash_attention_lse(q, k, v, causal: bool = True, q_offset=0,
                        k_offset=0, scale: Optional[float] = None,
                        block_q: int = 128, block_k: int = 128):
    """:func:`flash_attention` that also returns the per-row logsumexp
    ((B, H, Tq) float32), the merge state of ring attention.

    ``block_q``/``block_k`` fix the tiling rule the caller is held to, as
    in the JAX package; the kernel's own tiles are chosen for the card and
    mask their ragged edge themselves."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    _check_blocks(q, k, block_q, block_k)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention is forward-only in the port for now: its "
            "backward kernels come with the training slice (ROADMAP.md, "
            "port slice 1)")
    devs = {t.device for t in (q, k, v)}
    if len(devs) != 1:
        raise ValueError(f"q/k/v on different devices: {devs}")
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_lse_reference(
            q, k, v, causal=causal, q_offset=q_offset, k_offset=k_offset,
            scale=scale)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {dev}")
    b, t_q, h, _ = q.shape
    o3, lse = flash_fwd_3d(_to3(q), _to3(k), _to3(v), int(q_offset),
                           int(k_offset), float(scale), bool(causal))
    return _from3(o3, b, h), lse.view(b, h, t_q)
