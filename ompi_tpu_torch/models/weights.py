"""Load the JAX package's parameter dict into the port, and back out.

``from_jax_params`` takes the dict that ``init_params`` (either package's)
returns, or one taken from the JAX package as numpy arrays
(``{k: np.asarray(v)}``), and returns the port's parameters: torch tensors
on one device.  For serving, the matrices are cast once to the compute
dtype and the ``ln*`` scales kept in float32 (casting ``emb`` before the
embedding gather gives the same values as the JAX package's cast after
it).  For training (``train=True``), every leaf is a leaf tensor with
``requires_grad`` in the STORAGE dtype, as the JAX package trains it:
float32, or bfloat16 under ``cfg.param_dtype = "bfloat16"`` (rounded to
nearest even, as ``ml_dtypes`` does).  ``to_numpy_params`` gives the f32
numpy dict back, to compare with the JAX package's.

On a mesh (``mesh=``), a rank keeps the block of each sharded leaf at
its coordinates (``transformer.param_specs``: tp blocks of the attention
and dense FFN weights, ep blocks of the MoE experts), and
``to_numpy_params(..., mesh=)`` gathers the blocks back over those axes
(a ``DeviceCommunicator`` allgather) into whole leaves.

The optimizer state crosses too: ``from_jax_opt_state`` takes the JAX
package's optax AdamW state as numpy leaves in ``jax.tree_util.tree_leaves``
order and returns the state the port's train step keeps, and
``to_numpy_opt_state`` gives those leaves back, so a snapshot the JAX
package wrote resumes in the port.  The JAX package's layouts:

- plain (f32 storage):     (count, mu[k]…, nu[k]…)   — optax's
  ``(ScaleByAdamState(count, mu, nu), EmptyState(), EmptyState())``;
- master weights (``param_dtype`` bf16) or ZeRO-1: ``{"master": …,
  "opt": …}``, so the master leaves come first (``"master" < "opt"``),
  then count, mu, nu;
- a learning-rate schedule adds one more count leaf at the end
  (``ScaleByScheduleState``), equal to the first;

with every dict's leaves in sorted key order.  Under ZeRO-1 the JAX
package's master, mu and nu leaves are (n, m/n): each whole leaf
flattened and zero-padded to a multiple of the zero axis's size n; the
port's rank keeps the 1-D part of its own tp/ep block
(``parallel.zero``), which is recut here from the whole leaf.
"""

from __future__ import annotations

import numpy as np
import torch

from ompi_tpu_torch.models.transformer import (TransformerConfig,
                                               _store_dtype, param_specs,
                                               torch_dtype)
from ompi_tpu_torch.parallel.mesh import local_block, resolve_device

__all__ = ["from_jax_params", "to_numpy_params", "from_jax_opt_state",
           "to_numpy_opt_state"]


def _tensor(arr) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        return arr
    arr = np.ascontiguousarray(np.asarray(arr))
    if not arr.flags.writeable:  # JAX exports read-only views
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16, as JAX exports it
        return torch.from_numpy(arr.view(np.uint16).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(arr)


def from_jax_params(params: dict, cfg: TransformerConfig, device="cuda",
                    train: bool = False, mesh=None) -> dict:
    """numpy parameter dict → the port's dict of tensors on ``device``
    (serving dtypes, or trainable storage-dtype leaves with ``train``);
    with ``mesh``, each leaf cut to this rank's tp or ep block."""
    dev = resolve_device(device)
    if mesh is not None:
        specs = param_specs(cfg, mesh)
        # a tensor (on any device) is cut where it lies
        params = {name: local_block(
            arr if isinstance(arr, torch.Tensor) else np.asarray(arr),
            mesh, specs.get(name, ()))
                  for name, arr in params.items()}
    if train:
        store = torch_dtype(cfg.param_dtype or "float32")
        # a copy: the step updates these in place
        return {name: _tensor(arr).to(dev, store, copy=True)
                .requires_grad_(True) for name, arr in params.items()}
    cdt = torch_dtype(cfg.compute_dtype)
    out = {}
    for name, arr in params.items():
        t = _tensor(arr).to(dev)
        out[name] = (t.to(torch.float32) if name.startswith("ln")
                     else t.to(cdt))
    return out


def to_numpy_params(params: dict, mesh=None) -> dict:
    """The port's tensors → a dict of float32 numpy arrays on the host;
    with ``mesh``, the tp and ep blocks gathered over their ranks into
    whole leaves (every rank of the mesh makes the call).  A dict with
    the gate leaf ``wg`` is the MoE family's."""
    params = dict(params)
    if mesh is not None:
        from ompi_tpu_torch.mpi.device_comm import DeviceCommunicator

        moe = TransformerConfig(moe_experts=1) if "wg" in params else None
        for ax in ("tp", "ep"):
            if int(mesh.shape.get(ax, 1)) == 1:
                continue
            comm = DeviceCommunicator(mesh, (ax,), name=f"weights.{ax}")
            for name, spec in param_specs(moe, mesh).items():
                if name in params and ax in spec:
                    params[name] = comm.allgather(params[name].detach(),
                                                  axis=spec.index(ax))
    return {name: t.detach().to(torch.float32).cpu().numpy()
            for name, t in params.items()}


def _has_master(cfg: TransformerConfig) -> bool:
    """Whether the step keeps an f32 master copy: ZeRO-1, or a storage
    dtype other than f32 (``transformer._make_step_body``)."""
    return bool(cfg.zero1_axis) or _store_dtype(cfg) is not None


def _shapes(like: dict) -> dict:
    """{leaf: whole shape} from a dict of leaves or of shapes."""
    return {k: v if isinstance(v, tuple) else tuple(np.shape(v))
            for k, v in like.items()}


def _zero1(cfg: TransformerConfig, mesh):
    """(axis, n, my coordinate, specs) of the ZeRO-1 axis, or None."""
    if not cfg.zero1_axis:
        return None
    if mesh is None:
        raise ValueError("a ZeRO-1 state needs the mesh= it is sharded on")
    ax = cfg.zero1_axis
    return ax, int(mesh.shape[ax]), mesh.coord(ax), param_specs(cfg, mesh)


def _local(full: torch.Tensor, mesh, spec) -> torch.Tensor:
    return full if mesh is None else local_block(full, mesh, spec)


def from_jax_opt_state(leaves, cfg: TransformerConfig, like: dict,
                       device="cuda", mesh=None):
    """The JAX package's AdamW state (numpy leaves in tree_leaves order)
    → the port's: an ``AdamWState``, or ``{"opt": AdamWState, "master":
    {leaf: f32}}`` under master weights or ZeRO-1.  ``like`` names the
    model's leaves and gives their whole shapes (the JAX parameter dict,
    or ``{leaf: shape}``).  With ``mesh`` each rank keeps its tp/ep block
    (and under ZeRO-1 its part of it); ``count`` stays on the CPU."""
    from ompi_tpu_torch.models.optim import AdamWState

    dev = resolve_device(device)
    keys = sorted(like)
    shapes = _shapes(like)
    specs = param_specs(cfg, mesh)
    z = _zero1(cfg, mesh)
    leaves = list(leaves)
    nk = len(keys)
    master = dict(zip(keys, leaves[:nk])) if _has_master(cfg) else None
    rest = leaves[nk:] if master is not None else leaves
    if len(rest) not in (1 + 2 * nk, 2 + 2 * nk):
        raise ValueError(f"{len(leaves)} leaves do not hold an AdamW state "
                         f"of {nk} parameters")
    # the step count: 0-d, or (1,) as the sharded store records a scalar
    count = torch.tensor(int(torch.as_tensor(rest[0]).reshape(())),
                         dtype=torch.int32)

    def mine(k, leaf, dtype):
        t = _tensor(leaf)
        if z is not None:      # (n, m/n) of the whole leaf → my part
            ax, n, c, zspecs = z
            full = t.reshape(-1)[:int(np.prod(shapes[k]))].reshape(shapes[k])
            flat = local_block(full, mesh, zspecs[k]).reshape(-1)
            if ax not in zspecs[k]:
                size = -(-flat.numel() // n)
                flat = torch.nn.functional.pad(
                    flat, (0, size * n - flat.numel()))[c * size:
                                                        (c + 1) * size]
            t = flat
        else:
            t = _local(t, mesh, specs.get(k, ()))
        return t.to(dev, dtype, copy=True)

    f32 = torch.float32
    mu_dtype = torch_dtype(cfg.adam_mu_dtype) if cfg.adam_mu_dtype else f32
    state = AdamWState(
        count=count,
        mu={k: mine(k, v, mu_dtype) for k, v in zip(keys, rest[1:1 + nk])},
        nu={k: mine(k, v, f32)
            for k, v in zip(keys, rest[1 + nk:1 + 2 * nk])})
    if master is None:
        return state
    return {"opt": state,
            "master": {k: mine(k, v, f32) for k, v in master.items()}}


def to_numpy_opt_state(opt_state, cfg: TransformerConfig, like: dict,
                       mesh=None) -> list:
    """The port's AdamW state → the JAX package's leaves (tree_leaves
    order, numpy; bf16 moments as float32, to be cast with ``astype`` to
    the JAX leaf's dtype); with ``mesh`` the blocks and ZeRO-1 parts are
    gathered from every rank of the mesh, which all make the call."""
    from ompi_tpu_torch.mpi.device_comm import DeviceCommunicator

    keys = sorted(like)
    shapes = _shapes(like)
    specs = param_specs(cfg, mesh)
    z = _zero1(cfg, mesh)

    def block_shape(k):
        shape = list(shapes[k])
        for dim, ax in enumerate(specs.get(k, ())):
            if mesh is not None and ax is not None:
                shape[dim] //= int(mesh.shape.get(ax, 1))
        return shape

    def whole(k, t):
        t = t.detach()
        if z is not None:
            ax, n, _, zspecs = z
            if ax not in zspecs[k] and n > 1:
                comm = DeviceCommunicator(mesh, (ax,), name="opt.zero1")
                t = comm.allgather(t[None], axis=0).reshape(-1)
            t = t[:int(np.prod(block_shape(k)))].reshape(block_shape(k))
        if mesh is not None:
            for ax in ("tp", "ep"):
                spec = specs.get(k, ())
                if ax in spec and int(mesh.shape.get(ax, 1)) > 1:
                    comm = DeviceCommunicator(mesh, (ax,), name=f"opt.{ax}")
                    t = comm.allgather(t, axis=spec.index(ax))
        arr = t.to(torch.float32 if t.dtype == torch.bfloat16 else t.dtype
                   ).cpu().numpy()
        if z is not None:       # the JAX package's (n, m/n) layout
            n = z[1]
            flat = arr.reshape(-1)
            flat = np.pad(flat, (0, -(-flat.size // n) * n - flat.size))
            arr = flat.reshape(n, -1)
        return arr

    if _has_master(cfg):
        inner, master = opt_state["opt"], opt_state["master"]
        out = [whole(k, master[k]) for k in keys]
    else:
        inner, out = opt_state, []
    out.append(np.asarray(int(inner.count), np.int32))
    out += [whole(k, inner.mu[k]) for k in keys]
    out += [whole(k, inner.nu[k]) for k in keys]
    return out


def train_state(params: dict, opt_state, cfg: TransformerConfig,
                mesh=None) -> dict:
    """The training state as the JAX package's snapshots hold it
    (tests/ckpt/test_full_stack_resume.py): ``{"p_<leaf>": whole
    parameter (tensor, storage dtype), "k<i>": the i-th optimizer leaf}``,
    the same on every rank of ``mesh`` (which all make the call).  Write
    it with ``ckpt.SnapshotStore.write_rank``; the step count is leaf
    k0, or the first leaf after the master weights."""
    if mesh is None:
        whole = {k: t.detach() for k, t in params.items()}
    else:
        whole = {k: torch.from_numpy(v).to(params[k].dtype)
                 for k, v in to_numpy_params(params, mesh=mesh).items()}
    leaves = to_numpy_opt_state(opt_state, cfg, whole, mesh=mesh)
    return {**{f"p_{k}": v for k, v in whole.items()},
            **{f"k{i}": v for i, v in enumerate(leaves)}}


def from_train_state(blobs: dict, cfg: TransformerConfig, device="cuda",
                     mesh=None):
    """(params, opt_state) for the port's train step from a snapshot in
    the JAX package's layout (:func:`train_state`, or one the JAX package
    wrote): trainable storage-dtype parameters and the optimizer state,
    on ``device``, cut to this rank's blocks and parts on ``mesh``."""
    like = {k[2:]: v for k, v in blobs.items() if k.startswith("p_")}
    leaves = [blobs[f"k{i}"] for i in range(sum(
        1 for k in blobs if k[:1] == "k" and k[1:].isdigit()))]
    params = from_jax_params(
        {k: _tensor(v).to(torch.float32) for k, v in like.items()}, cfg,
        device, train=True, mesh=mesh)
    return params, from_jax_opt_state(leaves, cfg, _shapes(like), device,
                                      mesh)
