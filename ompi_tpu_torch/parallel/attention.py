"""Attention over local blocks, and the sequence-parallel entry points.

The port of ``ompi_tpu.parallel.attention``.  ``local_attention`` picks
the hand-written flash kernel (``ompi_tpu_torch.ops``) or the
materialized plain path; ``ring_attention``, ``ulysses_attention`` and
``gathered_attention`` keep their signatures and, at sp == 1, reduce to
``local_attention`` exactly as the JAX package's degenerate-axis paths
do.  Their sp > 1 forms (K/V rotation, all_to_all resharding, all_gather)
come with the multi-rank training slice (ROADMAP.md queue 1 item 3) and
raise until then.  Every path is differentiable: the
flash path through the kernels' ``torch.autograd.Function``, the
materialized path through plain autograd.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["local_attention", "local_attention_lse", "ring_attention",
           "ulysses_attention", "gathered_attention"]

_LATER = ("sequence-parallel attention at sp > 1 comes with the "
          "multi-rank training slice (ROADMAP.md queue 1 item 3)")


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
    o, _ = local_attention_lse(q, k, v, causal=causal, q_offset=q_offset,
                               k_offset=k_offset, scale=scale, impl=impl)
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


def _sp(comm, axis: Optional[str]) -> int:
    return int(comm.mesh.shape[axis or comm.axes[-1]])


def ring_attention(comm, q, k, v, axis: Optional[str] = None,
                   causal: bool = True, scale: Optional[float] = None,
                   impl: str = "auto"):
    """Exact attention over a sequence sharded along ``axis``; at sp == 1
    the ring is degenerate and this is :func:`local_attention`."""
    if _sp(comm, axis) != 1:
        raise NotImplementedError(f"ring_attention: {_LATER}")
    return local_attention(q, k, v, causal=causal, scale=scale, impl=impl)


def ulysses_attention(comm, q, k, v, axis: Optional[str] = None,
                      causal: bool = True, scale: Optional[float] = None,
                      impl: str = "auto"):
    """All-to-all sequence parallelism; at sp == 1 the resharding is the
    identity and this is :func:`local_attention`."""
    sp = _sp(comm, axis)
    if q.shape[2] % sp:
        raise ValueError(f"ulysses needs heads ({q.shape[2]}) divisible "
                         f"by sp ({sp})")
    if sp != 1:
        raise NotImplementedError(f"ulysses_attention: {_LATER}")
    return local_attention(q, k, v, causal=causal, scale=scale, impl=impl)


def gathered_attention(comm, q, k, v, axis: Optional[str] = None,
                       causal: bool = True, scale: Optional[float] = None):
    """Reference implementation (all-gather K/V, attend); at sp == 1 this
    is :func:`local_attention`."""
    if _sp(comm, axis) != 1:
        raise NotImplementedError(f"gathered_attention: {_LATER}")
    return local_attention(q, k, v, causal=causal, scale=scale)
