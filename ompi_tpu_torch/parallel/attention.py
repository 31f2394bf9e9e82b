"""Attention over local blocks, and the sequence-parallel entry points.

The port of ``ompi_tpu.parallel.attention``.  ``local_attention`` picks
the hand-written flash kernel (``ompi_tpu_torch.ops``) or the
materialized plain path; ``ring_attention``, ``ulysses_attention`` and
``gathered_attention`` keep their signatures and, at sp == 1, reduce to
``local_attention`` exactly as the JAX package's degenerate-axis paths
do.  At sp > 1 each rank passes its sequence block: ring attention
rotates K/V one hop at a time and merges the hops by their logsumexp,
Ulysses re-shards sequence to heads with an all-to-all, and gathered
attention all-gathers K/V.  Every path is differentiable: the flash
path through the kernels' ``torch.autograd.Function`` (a ring hop's lse
cotangent included), the materialized path through plain autograd, the
exchanges through ``parallel.collectives``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ompi_tpu_torch.mpi import trace
from ompi_tpu_torch.parallel.collectives import all_gather, all_to_all, shift

__all__ = ["local_attention", "local_attention_lse", "ring_attention",
           "ulysses_attention", "gathered_attention"]


def _flash_blocks(t_q: int, t_k: int) -> tuple[int, int]:
    """Resolve the ops_flash_block_q/k vars against this shape:
    non-positive values and non-tiling combinations fall back (each side
    independently) to the kernel's 128 default.  flash_tiles stays the
    single source of the tiling rule."""
    from ompi_tpu_torch.core.config import var_registry
    from ompi_tpu_torch.ops.flash_attention import flash_tiles

    bq = int(var_registry.get("ops_flash_block_q") or 128)
    bk = int(var_registry.get("ops_flash_block_k") or 128)
    if bq <= 0:
        bq = 128
    if bk <= 0:
        bk = 128
    if not flash_tiles(t_q, t_k, bq, bk):
        if flash_tiles(t_q, t_k, bq, 128):
            bk = 128
        elif flash_tiles(t_q, t_k, 128, bk):
            bq = 128
        else:
            bq = bk = 128
    return bq, bk


def _flash_wanted(impl: str, t_q: int, t_k: int, bq: int = 128,
                  bk: int = 128, device: Optional[torch.device] = None
                  ) -> bool:
    """Route to the flash kernel?  "auto" = yes for a CUDA tensor whose
    shape tiles at the resolved block sizes (CPU tensors keep the
    materialized path); "flash" = required, raise if untileable (a CPU
    tensor then runs the kernel's plain version); "jnp" = never."""
    from ompi_tpu_torch.ops.flash_attention import flash_tiles

    if impl not in ("auto", "flash", "jnp"):
        raise ValueError(f"impl must be auto, flash or jnp, got {impl!r}")
    if impl == "jnp":
        return False
    tiles = flash_tiles(t_q, t_k, bq, bk)
    if impl == "flash":
        if not tiles:
            raise ValueError("flash impl needs block-tiling shapes")
        return True
    return tiles and device is not None and device.type == "cuda"


def local_attention(q, k, v, causal: bool = True, q_offset=0, k_offset=0,
                    scale: Optional[float] = None, impl: str = "auto"):
    """Plain attention over local blocks; offsets give global positions for
    causal masking when the blocks are slices of a longer sequence.

    Shapes: q (B, Tq, H, D), k/v (B, Tk, H, D) → (B, Tq, H, D) in q's
    dtype.  ``impl``: "flash" = the flash kernel, "jnp" = materialized
    scores (the name the JAX package gives it), "auto" = flash for a CUDA
    tensor whose shape tiles, materialized otherwise.
    """
    with trace.model_span("attention"):
        o, _ = local_attention_lse(q, k, v, causal=causal,
                                   q_offset=q_offset, k_offset=k_offset,
                                   scale=scale, impl=impl)
        return o.to(q.dtype)


def local_attention_lse(q, k, v, causal: bool = True, q_offset=0,
                        k_offset=0, scale: Optional[float] = None,
                        impl: str = "auto"):
    """:func:`local_attention` that also returns the (B, H, Tq) f32
    logsumexp.  Output dtype follows q for flash, f32 for jnp."""
    from ompi_tpu_torch.ops.flash_attention import (attention_plain,
                                                    flash_attention_lse)

    scale = scale if scale is not None else q.shape[-1] ** -0.5
    bq, bk = _flash_blocks(q.shape[1], k.shape[1])
    if _flash_wanted(impl, q.shape[1], k.shape[1], bq, bk, q.device):
        return flash_attention_lse(q, k, v, causal=causal,
                                   q_offset=q_offset, k_offset=k_offset,
                                   scale=scale, block_q=bq, block_k=bk)
    return attention_plain(q, k, v, bool(causal), int(q_offset),
                           int(k_offset), float(scale))


def _axis(comm, axis: Optional[str]) -> tuple[str, int]:
    """(axis name, its size)."""
    ax = axis or comm.axes[-1]
    return ax, int(comm.mesh.shape[ax])


def _ring_step(q, k_blk, v_blk, out, lse, q_offset: int, k_offset: int,
               causal: bool = True, scale: Optional[float] = None,
               impl: str = "auto"):
    """One hop of ring attention: my queries against the K/V block held
    now, at their global offsets, merged into the running (out (B, Tq,
    H, D) float32, lse (B, H, Tq) float32) by logsumexp, the
    blockwise-attention identity; ``out=None`` starts the merge with
    this hop.  A hop whose keys all lie after my queries (causal) gives
    O = 0 and lse ≈ -1e30, so its merge weight is 0, in the forward and
    the backward.  Returns the new (out, lse)."""
    o_i, lse_i = local_attention_lse(q, k_blk, v_blk, causal=causal,
                                     q_offset=q_offset, k_offset=k_offset,
                                     scale=scale, impl=impl)
    o_i = o_i.to(torch.float32)
    if out is None:
        return o_i, lse_i
    lse_new = torch.logaddexp(lse, lse_i)
    c_old = torch.exp(lse - lse_new).transpose(1, 2)[..., None]
    c_new = torch.exp(lse_i - lse_new).transpose(1, 2)[..., None]
    return out * c_old + o_i * c_new, lse_new


def ring_attention(comm, q, k, v, axis: Optional[str] = None,
                   causal: bool = True, scale: Optional[float] = None,
                   impl: str = "auto"):
    """Exact attention over a sequence sharded along ``axis``: q, k, v are
    this rank's (B, T, H, D) blocks of it.

    At hop i I hold the K/V block of rank src = (my − i) mod sp, attend
    my queries to it at offsets (my·T, src·T) (:func:`_ring_step`), and
    pass it one hop on (r → r+1), so after sp hops every (query, key)
    pair has met; the merge accumulates in float32.  At sp == 1 the ring
    is degenerate and this is :func:`local_attention`."""
    ax, sp = _axis(comm, axis)
    if sp == 1:
        return local_attention(q, k, v, causal=causal, scale=scale,
                               impl=impl)
    my, T = comm.mesh.coord(ax), q.shape[1]
    kv = torch.stack([k, v])          # one exchange a hop for both
    out = lse = None
    for i in range(sp):
        src = (my - i) % sp
        out, lse = _ring_step(q, kv[0], kv[1], out, lse, my * T, src * T,
                              causal=causal, scale=scale, impl=impl)
        if i < sp - 1:
            kv = shift(comm, kv, 1, ax)
    return out.to(q.dtype)


def ulysses_attention(comm, q, k, v, axis: Optional[str] = None,
                      causal: bool = True, scale: Optional[float] = None,
                      impl: str = "auto"):
    """All-to-all sequence parallelism: re-shard q, k, v from sequence to
    heads (one all-to-all), attend over the whole sequence locally,
    re-shard back.  Exact; needs heads % sp == 0.  At sp == 1 the
    resharding is the identity and this is :func:`local_attention`."""
    ax, sp = _axis(comm, axis)
    if q.shape[2] % sp:
        raise ValueError(f"ulysses needs heads ({q.shape[2]}) divisible "
                         f"by sp ({sp})")
    if sp == 1:
        return local_attention(q, k, v, causal=causal, scale=scale,
                               impl=impl)
    # (3, B, T/sp, H, D) → (3, B, T, H/sp, D)
    qkv = all_to_all(comm, torch.stack([q, k, v]), ax, split_dim=3,
                     concat_dim=2)
    o = local_attention(*qkv.unbind(0), causal=causal, scale=scale,
                        impl=impl)
    # (B, T, H/sp, D) → (B, T/sp, H, D)
    return all_to_all(comm, o, ax, split_dim=1, concat_dim=2)


def gathered_attention(comm, q, k, v, axis: Optional[str] = None,
                       causal: bool = True, scale: Optional[float] = None):
    """Reference implementation: all-gather K/V along the sequence and
    attend my queries at their global offset (O(T) memory a rank, what
    ring attention avoids).  At sp == 1 this is :func:`local_attention`."""
    ax, sp = _axis(comm, axis)
    if sp == 1:
        return local_attention(q, k, v, causal=causal, scale=scale)
    kv = all_gather(comm, torch.stack([k, v]), ax, dim=2)
    return local_attention(q, kv[0], kv[1], causal=causal,
                           q_offset=comm.mesh.coord(ax) * q.shape[1],
                           k_offset=0, scale=scale)
