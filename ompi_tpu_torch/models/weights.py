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
"""

from __future__ import annotations

import numpy as np
import torch

from ompi_tpu_torch.models.transformer import (TransformerConfig,
                                               param_specs, torch_dtype)
from ompi_tpu_torch.parallel.mesh import local_block, resolve_device

__all__ = ["from_jax_params", "to_numpy_params"]


def _tensor(arr) -> torch.Tensor:
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
        params = {name: local_block(np.asarray(arr), mesh,
                                    specs.get(name, ()))
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
