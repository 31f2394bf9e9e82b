"""Flash attention: blockwise online-softmax attention, forward and backward.

The port of ``ompi_tpu.ops.flash_attention``.  On a CUDA tensor the
wrappers launch the hand-written Hopper kernels in ``csrc/flash_fwd.cu``
(forward) and ``csrc/flash_bwd.cu`` (the dq and dk/dv kernels of the
backward), built by ``_build`` at first use; on a CPU tensor they run the
plain PyTorch versions, :func:`flash_attention_lse_reference` and
:func:`flash_bwd_reference`, which are also what the kernels are held
against on the card.  There is no fallback between the two: a CUDA
tensor launches the kernel or raises.

Public layout as in the JAX package: q (B, Tq, H, D), k/v (B, Tk, H, D)
→ out (B, Tq, H, D) in q's dtype and lse (B, H, Tq) float32.  The kernels
read the (B·H, T, D) layout the JAX package's ``_to3`` makes.

Autodiff: :class:`_Flash` (the counterpart of the JAX package's
``jax.custom_vjp``) saves q, k, v, out and lse.  Its backward is, with
``ops_flash_bwd_kernel`` on, the two backward kernels recomputing p
blockwise from the saved lse; with it off (the default, as in the JAX
package), the materialized recompute in plain PyTorch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ompi_tpu_torch.core.config import VarType, register_var

__all__ = ["flash_attention", "flash_attention_lse",
           "flash_attention_lse_reference", "flash_bwd_reference",
           "flash_bwd_dq_reference", "flash_bwd_dkv_reference",
           "flash_bwd_recompute", "flash_fwd_3d", "flash_bwd_3d",
           "flash_bwd_dq_3d", "flash_bwd_dkv_3d", "flash_tiles"]

register_var("ops", "flash_block_q", VarType.INT, 128,
             "flash kernel q-block rows (tiling rule; t_q must tile by it)")
register_var("ops", "flash_block_k", VarType.INT, 128,
             "flash kernel k/v block size (tiling rule; t_k must tile by it)")
register_var("ops", "flash_bwd_kernel", VarType.BOOL, False,
             "use the pallas backward kernels for flash attention "
             "(recompute-from-lse, O(T·D) memory) instead of the "
             "materialized pure-XLA backward")

_NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)

#: launches of each kernel so far (forward, dq, dk/dv); chip_smoke.py
#: zeroes them around the main path
launch_count = 0
dq_launch_count = 0
dkv_launch_count = 0


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


def _keep(t_q: int, t_k: int, q_offset: int, k_offset: int, device):
    """(Tq, Tk) causal mask on global positions."""
    qpos = q_offset + torch.arange(t_q, device=device)
    kpos = k_offset + torch.arange(t_k, device=device)
    return qpos[:, None] >= kpos[None, :]


# ---------------------------------------------------------------------------
# plain PyTorch versions
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
        mask = _keep(t_q, t_k, q_offset, k_offset, q.device)
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
    """The plain version of the forward kernel: out in q's dtype, lse
    float32."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    o, lse = attention_plain(q, k, v, bool(causal), int(q_offset),
                             int(k_offset), float(scale))
    return o.to(q.dtype), lse


def _bwd_p_ds(q3, k3, v3, g3, lse, dm, q_offset, k_offset, scale, causal):
    """p (f32) recomputed from the SAVED lse (not renormalised) and masked
    twice, and ds = p·(dp − dm)·scale rounded to q's dtype, as the
    kernels make them."""
    f32 = torch.float32
    s = torch.matmul(q3.to(f32), k3.to(f32).transpose(1, 2)) * scale
    if causal:
        keep = _keep(q3.shape[1], k3.shape[1], int(q_offset), int(k_offset),
                     q3.device)
        s = torch.where(keep, s, _NEG)
    p = torch.exp(s - lse[..., None])
    if causal:
        p = torch.where(keep, p, 0.0)
    dp = torch.matmul(g3.to(f32), v3.to(f32).transpose(1, 2))
    ds = (p * (dp - dm[..., None]) * scale).to(q3.dtype).to(f32)
    return p, ds


def _dq_from(ds, q3, k3):
    return torch.matmul(ds, k3.to(torch.float32)).to(q3.dtype)


def _dkv_from(p, ds, q3, k3, v3, g3):
    f32 = torch.float32
    pc = p.to(g3.dtype).to(f32)
    dk = torch.matmul(ds.transpose(1, 2), q3.to(f32))
    dv = torch.matmul(pc.transpose(1, 2), g3.to(f32))
    return dk.to(k3.dtype), dv.to(v3.dtype)


def flash_bwd_dq_reference(q3, k3, v3, g3, lse, dm, q_offset: int,
                           k_offset: int, scale: float, causal: bool):
    """The plain version of the dq kernel: dq = ds·k, same contract as
    :func:`flash_bwd_dq_3d`."""
    _, ds = _bwd_p_ds(q3, k3, v3, g3, lse, dm, q_offset, k_offset, scale,
                      causal)
    return _dq_from(ds, q3, k3)


def flash_bwd_dkv_reference(q3, k3, v3, g3, lse, dm, q_offset: int,
                            k_offset: int, scale: float, causal: bool):
    """The plain version of the dk/dv kernel: dk = dsᵀ·q, dv = pcᵀ·g with
    pc = p rounded to g's dtype, same contract as
    :func:`flash_bwd_dkv_3d`."""
    p, ds = _bwd_p_ds(q3, k3, v3, g3, lse, dm, q_offset, k_offset, scale,
                      causal)
    return _dkv_from(p, ds, q3, k3, v3, g3)


def flash_bwd_reference(q3, k3, v3, g3, lse, dm, q_offset: int,
                        k_offset: int, scale: float, causal: bool):
    """The plain version of the two backward kernels, same contract as
    :func:`flash_bwd_3d`: (B·H, T, D) q/k/v/g, (B·H, Tq) f32 lse and dm
    → (dq3, dk3, dv3) in the storage dtypes.  p is recomputed from the
    SAVED lse (not renormalised), masked twice; ds is rounded to q's
    dtype and p to g's before their products, as in the kernels."""
    p, ds = _bwd_p_ds(q3, k3, v3, g3, lse, dm, q_offset, k_offset, scale,
                      causal)
    return (_dq_from(ds, q3, k3), *_dkv_from(p, ds, q3, k3, v3, g3))


def flash_bwd_recompute(q, k, v, out, g, g_lse, q_offset: int,
                        k_offset: int, scale: float, causal: bool):
    """The default backward (``ops_flash_bwd_kernel`` off), as the JAX
    package's materialized recompute: rebuild s and a renormalised p, fold
    the lse cotangent ``g_lse`` (or None) into the residual.  (B, T, H, D)
    layout; returns (dq, dk, dv) in the storage dtypes."""
    f32 = torch.float32
    t_q, t_k = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(f32), k.to(f32)) * scale
    if causal:
        keep = _keep(t_q, t_k, int(q_offset), int(k_offset), q.device)
        s = torch.where(keep, s, _NEG)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    p = e / e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    if causal:
        p = torch.where(keep, p, 0.0)
    gf = g.to(f32)
    pc = p.to(q.dtype).to(f32)
    dv = torch.einsum("bhqk,bqhd->bkhd", pc, gf)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, v.to(f32))
    delta = torch.einsum("bqhd,bqhd->bqh", gf, out.to(f32)).transpose(1, 2)
    resid = dp - delta[..., None]
    if g_lse is not None:
        resid = resid + g_lse.to(f32)[..., None]
    ds = (p * resid * scale).to(q.dtype).to(f32)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.to(f32))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.to(f32))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

_vp, _ci = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _fwd_fn():
    """The forward's C entry point, built, loaded and bound once."""
    from ompi_tpu_torch.ops import _build

    fn = _build.load("flash_fwd.cu").ompi_flash_fwd
    fn.argtypes = [_vp] * 5 + [_ci] * 5 + [ctypes.c_float] + [_ci] * 3 + [_vp]
    fn.restype = _ci
    return fn


@functools.cache
def _bwd_fns():
    """The dq and dk/dv C entry points, built, loaded and bound once."""
    from ompi_tpu_torch.ops import _build

    lib = _build.load("flash_bwd.cu")
    tail = [_ci] * 5 + [ctypes.c_float] + [_ci] * 3 + [_vp]
    dq, dkv = lib.ompi_flash_bwd_dq, lib.ompi_flash_bwd_dkv
    dq.argtypes = [_vp] * 7 + tail
    dkv.argtypes = [_vp] * 8 + tail
    dq.restype = dkv.restype = _ci
    return dq, dkv


def _check_kernel_inputs(q3, k3, v3, *rest):
    """The kernels take contiguous (B·H, T, D) q/k/v (and g) on one CUDA
    device, float32 or bfloat16, head_dim in ``_HEAD_DIMS``; ``rest`` are
    (name, tensor, shape, dtype) of the other operands."""
    bh, t_q, d = q3.shape
    t_k = k3.shape[1]
    if q3.dtype not in _DTYPES:
        raise TypeError(f"flash kernel takes float32 or bfloat16, "
                        f"got {q3.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {_HEAD_DIMS}, "
                         f"got {d}")
    want = [("k", k3, (bh, t_k, d), q3.dtype), ("v", v3, (bh, t_k, d),
                                                 q3.dtype), *rest]
    for name, t, shape, dtype in want:
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"flash kernel: {name} is {tuple(t.shape)} "
                             f"{t.dtype}, want {shape} {dtype}")
    for t in (q3, *(w[1] for w in want)):
        if (t.device.type != "cuda" or t.device != q3.device
                or not t.is_contiguous()):
            raise ValueError("flash kernel: operands must be contiguous and "
                             "on one CUDA device")


def _raise_on(err: int, what: str, q3, t_k: int) -> None:
    if err != 0:
        bh, t_q, d = q3.shape
        raise RuntimeError(f"{what} launch failed: CUDA error {err} (shape "
                           f"bh={bh} tq={t_q} tk={t_k} d={d}, {q3.dtype})")


def flash_fwd_3d(q3, k3, v3, q_offset: int, k_offset: int, scale: float,
                 causal: bool):
    """Launch the forward kernel on (B·H, T, D) CUDA tensors → (o3
    (B·H, Tq, D) in the storage dtype, lse (B·H, Tq) float32)."""
    global launch_count
    _check_kernel_inputs(q3, k3, v3)
    bh, t_q, d = q3.shape
    t_k = k3.shape[1]
    fn = _fwd_fn()
    o3 = torch.empty_like(q3)
    lse = torch.empty((bh, t_q), dtype=torch.float32, device=q3.device)
    with torch.cuda.device(q3.device):
        stream = torch.cuda.current_stream(q3.device).cuda_stream
        err = fn(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
                 o3.data_ptr(), lse.data_ptr(), bh, t_q, t_k, d,
                 _DTYPES[q3.dtype], float(scale), int(bool(causal)),
                 int(q_offset), int(k_offset), stream)
    _raise_on(err, "flash kernel", q3, t_k)
    launch_count += 1
    return o3, lse


def _bwd_args(q3, k3, v3, g3, lse, dm, q_offset, k_offset, scale, causal):
    """Check the backward kernels' operands; → (input pointers, scalar
    arguments) of the C entry points."""
    bh, t_q, d = q3.shape
    _check_kernel_inputs(q3, k3, v3, ("g", g3, (bh, t_q, d), q3.dtype),
                         ("lse", lse, (bh, t_q), torch.float32),
                         ("dm", dm, (bh, t_q), torch.float32))
    ins = (q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), g3.data_ptr(),
           lse.data_ptr(), dm.data_ptr())
    return ins, (bh, t_q, k3.shape[1], d, _DTYPES[q3.dtype], float(scale),
                 int(bool(causal)), int(q_offset), int(k_offset))


def flash_bwd_dq_3d(q3, k3, v3, g3, lse, dm, q_offset: int, k_offset: int,
                    scale: float, causal: bool):
    """Launch the dq kernel on (B·H, T, D) contiguous CUDA tensors (g like
    q), with ``lse`` and ``dm`` (B·H, Tq) float32 → dq3 in q's dtype."""
    global dq_launch_count
    ins, args = _bwd_args(q3, k3, v3, g3, lse, dm, q_offset, k_offset,
                          scale, causal)
    dq3 = torch.empty_like(q3)
    with torch.cuda.device(q3.device):
        stream = torch.cuda.current_stream(q3.device).cuda_stream
        err = _bwd_fns()[0](*ins, dq3.data_ptr(), *args, stream)
    _raise_on(err, "flash dq kernel", q3, k3.shape[1])
    dq_launch_count += 1
    return dq3


def flash_bwd_dkv_3d(q3, k3, v3, g3, lse, dm, q_offset: int, k_offset: int,
                     scale: float, causal: bool):
    """Launch the dk/dv kernel on the operands of :func:`flash_bwd_dq_3d`
    → (dk3, dv3) in k's and v's dtype."""
    global dkv_launch_count
    ins, args = _bwd_args(q3, k3, v3, g3, lse, dm, q_offset, k_offset,
                          scale, causal)
    dk3 = torch.empty_like(k3)
    dv3 = torch.empty_like(v3)
    with torch.cuda.device(q3.device):
        stream = torch.cuda.current_stream(q3.device).cuda_stream
        err = _bwd_fns()[1](*ins, dk3.data_ptr(), dv3.data_ptr(), *args,
                            stream)
    _raise_on(err, "flash dk/dv kernel", q3, k3.shape[1])
    dkv_launch_count += 1
    return dk3, dv3


def flash_bwd_3d(q3, k3, v3, g3, lse, dm, q_offset: int, k_offset: int,
                 scale: float, causal: bool):
    """The dq kernel, then the dk/dv kernel → (dq3, dk3, dv3)."""
    args = (q3, k3, v3, g3, lse, dm, q_offset, k_offset, scale, causal)
    return (flash_bwd_dq_3d(*args), *flash_bwd_dkv_3d(*args))


def _bwd_kernel_wanted() -> bool:
    from ompi_tpu_torch.core.config import var_registry

    return bool(var_registry.get("ops_flash_bwd_kernel"))


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

def _forward(q, k, v, q_offset, k_offset, scale, causal):
    if q.device.type == "cpu":
        return flash_attention_lse_reference(
            q, k, v, causal=causal, q_offset=q_offset, k_offset=k_offset,
            scale=scale)
    b, t_q, h, _ = q.shape
    o3, lse = flash_fwd_3d(_to3(q), _to3(k), _to3(v), q_offset, k_offset,
                           scale, causal)
    return _from3(o3, b, h), lse.view(b, h, t_q)


def _backward_kernels(q, k, v, out, lse, g, g_lse, q_offset, k_offset,
                      scale, causal):
    """``ops_flash_bwd_kernel`` on: dm = rowsum(g·out) − g_lse in f32
    from the STORED out, then the dq and dk/dv kernels (their plain
    version for a CPU tensor)."""
    f32 = torch.float32
    b, t_q, h, _ = q.shape
    q3, g3 = _to3(q), _to3(g)
    dm = (g3.to(f32) * _to3(out).to(f32)).sum(dim=-1)         # (B·H, Tq)
    if g_lse is not None:
        dm = dm - g_lse.reshape(b * h, t_q).to(f32)
    lse3 = lse.reshape(b * h, t_q).contiguous()
    run = flash_bwd_reference if q.device.type == "cpu" else flash_bwd_3d
    dq3, dk3, dv3 = run(q3, _to3(k), _to3(v), g3, lse3, dm.contiguous(),
                        q_offset, k_offset, scale, causal)
    return _from3(dq3, b, h), _from3(dk3, b, h), _from3(dv3, b, h)


class _Flash(torch.autograd.Function):
    """(q, k, v, q_offset, k_offset, scale, causal) → (out, lse).  The
    offsets, scale and causal flag are plain Python values and get no
    gradient.  The backward reads ``ops_flash_bwd_kernel`` when it runs;
    an absent cotangent (None) for either output is taken as zero."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, k_offset, scale, causal):
        out, lse = _forward(q, k, v, q_offset, k_offset, scale, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (q_offset, k_offset, scale, causal)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        if g is None and g_lse is None:
            return (None,) * 7
        if g is None:
            g = torch.zeros_like(out)
        if _bwd_kernel_wanted():
            grads = _backward_kernels(q, k, v, out, lse, g, g_lse,
                                      *ctx.args)
        else:
            grads = flash_bwd_recompute(q, k, v, out, g, g_lse, *ctx.args)
        return (*grads, None, None, None, None)


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
    Tk % block_k == 0, blocks shrinking to T).  Differentiable."""
    out, _ = flash_attention_lse(q, k, v, causal=causal, q_offset=q_offset,
                                 k_offset=k_offset, scale=scale,
                                 block_q=block_q, block_k=block_k)
    return out


def flash_attention_lse(q, k, v, causal: bool = True, q_offset=0,
                        k_offset=0, scale: Optional[float] = None,
                        block_q: int = 128, block_k: int = 128):
    """:func:`flash_attention` that also returns the per-row logsumexp
    ((B, H, Tq) float32), the merge state of ring attention; both outputs
    are differentiable.

    ``block_q``/``block_k`` fix the tiling rule the caller is held to, as
    in the JAX package; the kernels' own tiles are chosen for the card and
    mask their ragged edge themselves."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    _check_blocks(q, k, block_q, block_k)
    devs = {t.device for t in (q, k, v)}
    if len(devs) != 1:
        raise ValueError(f"q/k/v on different devices: {devs}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu, "
                         f"not {q.device}")
    return _Flash.apply(q, k, v, int(q_offset), int(k_offset), float(scale),
                        bool(causal))
