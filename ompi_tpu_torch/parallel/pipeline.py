"""Pipeline parallelism: a GPipe microbatch schedule over a ``pp`` axis
(the port of ``ompi_tpu.parallel.pipeline``).

The fifth parallelism dimension (dp/sp/tp/ep/pp): layers shard into
stages over ``pp``; activations flow stage→stage through single-hop
permutes (the neighbor-exchange wire pattern of the reference's
chain/pipeline broadcast, coll_base_bcast.c:257), and M microbatches keep
every stage busy outside the (pp−1)-tick fill/drain bubbles.

Where the JAX package runs one ``lax.fori_loop`` of M+pp−1 ticks inside
``shard_map``, a port rank is one stage and runs the same ticks as an
eager loop: at tick t stage d computes microbatch ``m = t − d``
(garbage outside [0, M), discarded by masking — the bubble cost), then
the activations hop one stage forward while stage 0 injects the next
microbatch.  Outputs accumulate on the last stage and a final masked sum
over pp replicates them.

The gradient is the sequential chain's:

- the hop is :func:`~ompi_tpu_torch.parallel.collectives.permute`, whose
  backward sends each cotangent one stage back;
- the final sum is :func:`~ompi_tpu_torch.parallel.collectives.sum_forward`
  (identity backward): every rank holds and differentiates the same
  replicated output, and only the last stage's unmasked copy passes its
  cotangent on (a sum in both directions would scale every gradient by
  pp);
- the choices between stages and ticks are ``torch.where`` on masks, as
  the reference's ``jnp.where``, never Python branches on the stage: every
  rank builds the same graph, so every rank runs every hop's backward (a
  collective) in the same order, passing zeros where its branch was
  masked.

``x`` is used only by stage 0's injection, so its gradient lives on rank
0 and is zero elsewhere.
"""

from __future__ import annotations

from typing import Callable

__all__ = ["gpipe"]


def gpipe(comm, stage_fn: Callable, stage_params, x, microbatches: int,
          axis: str = "pp"):
    """Run ``stage_fn(stage_params, h)`` as a pp-deep pipeline; every rank
    of ``comm``'s ``axis`` makes the call.

    - ``comm``: a ``DeviceCommunicator`` whose axes include ``axis``
      (``DeviceCommunicator.sub((axis,))`` or a world communicator).
    - ``stage_params``: THIS rank's stage weights.
    - ``x``: (B, ...) input, the same on every rank (or valid on stage 0 —
      others' copies are ignored); B must divide by ``microbatches``.
    - returns (B, ...) output of the full stage chain, replicated.

    Activations must keep the same shape through every stage (uniform
    pipelines — the GPipe assumption).
    """
    import torch

    from ompi_tpu_torch.parallel.collectives import permute, sum_forward

    if axis not in comm.axes:
        raise ValueError(f"axis {axis!r} not bound to this communicator "
                         f"(axes {comm.axes})")
    pp = int(comm.mesh.shape[axis])
    d = comm.mesh.coord(axis)
    B = x.shape[0]
    M = microbatches
    if B % M:
        raise ValueError(f"batch {B} not divisible by {M} microbatches")
    mb = B // M
    x_mb = x.reshape((M, mb) + tuple(x.shape[1:]))
    if pp == 1:
        return stage_fn(stage_params, x)

    perm = [(i, i + 1) for i in range(pp - 1)]  # stage d → d+1 (no wrap)
    last = pp - 1

    def flag(v: bool):
        return torch.tensor(v, device=x.device)

    first = flag(d == 0)
    cur = torch.where(first, x_mb[0], torch.zeros_like(x_mb[0]))
    slots = list(torch.zeros_like(x_mb).unbind(0))
    ticks = M + pp - 1
    for t in range(ticks):
        y = stage_fn(stage_params, cur)          # bubbles compute garbage
        m = t - d                                # my microbatch this tick
        # last stage: write finished microbatch m into its output slot
        m_clamp = min(max(m, 0), M - 1)
        valid_out = flag(d == last and 0 <= m < M)
        slots[m_clamp] = torch.where(valid_out, y, slots[m_clamp])
        if t == ticks - 1:
            break                    # the last hop's result is never read
        # hop one stage forward; stage 0 injects the next microbatch
        shifted = permute(comm, y, perm, axis)
        cur = torch.where(first, x_mb[min(t + 1, M - 1)], shifted)
    out = torch.stack(slots)
    # replicate: every slot was written exactly once, on the last stage
    out = sum_forward(comm, torch.where(flag(d == last), out,
                                        torch.zeros_like(out)), (axis,))
    return out.reshape((B,) + tuple(x.shape[1:]))
