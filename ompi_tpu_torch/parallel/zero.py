"""ZeRO-1: the optimizer state sharded over a mesh axis.

The port of ``ompi_tpu.parallel.zero``.  The optimizer's persistent
state (the f32 master weights and the Adam moments) is replicated over
the data-parallel ranks unless it is sharded: with ZeRO stage 1 each rank
of the axis keeps and updates 1/n of every leaf, then the updated parts
are all-gathered over the axis into the live parameters.

Each leaf is flattened and padded to a multiple of n, and rank c of the
axis owns the c-th of its n equal parts.  A leaf that the axis already
shards (a tp block under ZeRO over tp) is kept whole: its local block is
already 1/n of the leaf.  A tp- or ep-sharded leaf is flattened as its
local block, so the live parameters keep their tp and ep shardings, as
the JAX package's regather to ``param_specs`` does.  The parts of all leaves
travel in one all-gather a step.
"""

from __future__ import annotations

import torch

__all__ = ["zero1_wrap"]


def _part(x: torch.Tensor, n: int, c: int) -> torch.Tensor:
    """The c-th of n equal parts of x flattened and zero-padded to a
    multiple of n, as float32."""
    flat = x.detach().reshape(-1).to(torch.float32)
    size = -(-flat.numel() // n)
    pad = size * n - flat.numel()
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat[c * size:(c + 1) * size].clone()


def zero1_wrap(opt, mesh, axis: str, specs: dict):
    """Wrap an optimizer (``models.optim.AdamW``) into a ZeRO-1 update
    over ``axis`` of ``mesh``.

    Returns (init, update):
      init(params) -> {"opt": inner state, "master": {leaf: f32 part}},
                      every part 1-D, 1/n of its (padded) leaf;
      update(grads, opt_state, params) -> the new opt_state, after
                      writing the updated parameters into ``params`` in
                      place (rounded to their storage dtype).

    ``grads`` are the gradients summed over the data-parallel ranks;
    ``specs`` maps every leaf to its ``PartitionSpec``-like tuple
    (``transformer.param_specs(cfg, mesh)``; a leaf whose spec names
    ``axis`` is kept whole).
    """
    from ompi_tpu_torch.mpi.device_comm import DeviceCommunicator

    if axis not in mesh.shape:
        raise ValueError(
            f"zero1 axis {axis!r} is not a mesh axis "
            f"(have {tuple(mesh.shape)}); set zero1_axis to one of "
            f"those or None")
    n = int(mesh.shape[axis])
    me = mesh.coord(axis)
    comm = DeviceCommunicator(mesh, (axis,), name=f"zero1.{axis}")

    def split(key: str) -> bool:
        return axis not in specs[key]

    def mine(key: str, x: torch.Tensor) -> torch.Tensor:
        if split(key):
            return _part(x, n, me)
        return x.detach().reshape(-1).to(torch.float32).clone()

    def init(params: dict) -> dict:
        master = {k: mine(k, p) for k, p in params.items()}
        return {"opt": opt.init(master), "master": master}

    def update(grads: dict, opt_state: dict, params: dict) -> dict:
        g = {k: mine(k, grads[k]) for k in grads}
        master = opt_state["master"]
        updates, inner = opt.update_(g, opt_state["opt"], master)
        with torch.no_grad():
            for k, u in updates.items():
                master[k].add_(u)
            whole = [k for k in params if not split(k)]
            parted = [k for k in params if split(k)]
            for k in whole:
                params[k].copy_(master[k].view(params[k].shape))
            if parted:
                buf = torch.cat([master[k] for k in parted])
                rows = (comm.allgather(buf[None], axis=0)
                        if n > 1 else buf[None])            # (n, Σ parts)
                off = 0
                for k in parted:
                    size = master[k].numel()
                    full = rows[:, off:off + size].reshape(-1)
                    params[k].copy_(full[:params[k].numel()]
                                    .view(params[k].shape))
                    off += size
        return {"opt": inner, "master": master}

    return init, update
