"""The snapshot-sequence store over ``torch.distributed.checkpoint`` (DCP)
— the port's counterpart of the JAX package's ``ckpt/orbax_store.py``.

Orbax is JAX's: the port keeps the same contract over PyTorch's own
distributed checkpoint, for users whose PyTorch stacks already manage
checkpoints with DCP, while keeping this framework's sequence/commit
semantics.  The names map one to one:

    OrbaxStore(base_dir, job)          → DcpStore(base_dir, job, mesh=None)
    .save(seq, state, force=True)      → .save(seq, state, force=True)
    .restore(seq, abstract_state=None) → .restore(seq, template=None)
    .latest()                          → .latest()
    jax.Array with a NamedSharding     → DTensor (``sharded(block, mesh,
                                         axis)``: this rank's block,
                                         Shard(0) over the mesh axis)
    jax.ShapeDtypeStruct template      → a template of tensors/DTensors
                                         of the shapes to read into

One DCP checkpoint is saved per snapshot sequence, preserving the state's
nesting (nested dicts; keys must not contain "/", the store's separator).
Two things differ from orbax and are handled here:

- **Commit atomicity.** Orbax writes into a temporary directory and
  renames it; ``dcp.save`` writes in place.  So the store saves into
  ``snapshot_<seq>.partial`` and rank 0 renames it after every rank has
  written (a barrier), so ``latest()`` never sees a half-written snapshot.
- **Replicated-tensor dedup.** DCP treats a plain tensor that has one key
  on every rank as replicated and writes one rank's copy.  Per-rank data
  (a ZeRO-1 part, a tp block) must be a DTensor — ``sharded(...)`` —
  or it silently loses all ranks' parts but one.

Leaves may be tensors (any device), DTensors, numpy arrays and numpy or
Python scalars (the last two become CPU tensors, 0-d for a scalar); other
values are pickled by DCP.  ``restore`` with no template builds one from
the checkpoint's metadata and returns whole CPU tensors on every rank;
with a template each leaf is read into the template's tensor (on its
device, with its sharding) and the template's structure is returned.
Every rank of the mesh makes each call.
"""

from __future__ import annotations

import os
import shutil
import warnings
from typing import Any, Optional

__all__ = ["DcpStore", "sharded"]

_SEP = "/"


def _device_mesh(mesh):
    """The DTensor ``DeviceMesh`` of a port ``Mesh`` (same ranks, shape
    and axis names), made once per mesh by every rank (it makes process
    groups)."""
    dm = getattr(mesh, "_dcp_device_mesh", None)
    if dm is None:
        import torch
        from torch.distributed.device_mesh import DeviceMesh

        dm = DeviceMesh(mesh.device.type,
                        torch.as_tensor(mesh.devices, dtype=torch.int64),
                        mesh_dim_names=tuple(mesh.axis_names))
        mesh._dcp_device_mesh = dm
    return dm


def sharded(block, mesh, axis: str, dim: int = 0):
    """This rank's ``block`` of a leaf split along ``dim`` over the mesh
    axis ``axis`` (replicated over the other axes), as a DTensor that DCP
    saves once per block: the port's ``P(axis)`` sharding."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    placements = [Shard(dim) if a == axis else Replicate()
                  for a in mesh.axis_names]
    return DTensor.from_local(block, _device_mesh(mesh), placements,
                              run_check=False)


def _flatten(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        k = str(k)
        if _SEP in k:
            raise ValueError(f"checkpoint key {k!r} contains {_SEP!r}, the "
                             f"store's separator of nested keys")
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + k + _SEP))
        else:
            out[prefix + k] = v
    return out


def _unflatten(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        *path, leaf = key.split(_SEP)
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _leaf(v):
    """A leaf as DCP stores it: tensors as they are, numpy arrays and
    scalars as CPU tensors, anything else as is (pickled)."""
    import numpy as np
    import torch

    if isinstance(v, torch.Tensor):
        return v
    if isinstance(v, np.ndarray):
        return torch.from_numpy(np.require(v, requirements="C"))
    if isinstance(v, (bool, int, float, np.generic)):
        return torch.as_tensor(v)
    return v


class DcpStore:
    """Snapshot-sequence store backed by torch.distributed.checkpoint."""

    def __init__(self, base_dir: str, job: str = "job", mesh=None) -> None:
        self.base = os.path.join(os.path.abspath(base_dir), job)
        self.mesh = mesh
        self.rank = mesh.rank if mesh is not None else 0
        if self.rank == 0:
            os.makedirs(self.base, exist_ok=True)
        self._barrier()

    def _barrier(self) -> None:
        if self.mesh is not None and self.mesh.world_size > 1:
            self.mesh.host_barrier()

    def snapshot_dir(self, seq: int) -> str:
        return os.path.join(self.base, f"snapshot_{seq}")

    def save(self, seq: int, state: Any, force: bool = True) -> str:
        """Write one snapshot (blocking; atomic: every rank writes into
        ``snapshot_<seq>.partial``, then rank 0 renames it)."""
        import torch.distributed.checkpoint as dcp

        flat = {k: _leaf(v) for k, v in _flatten(state).items()}
        path = self.snapshot_dir(seq)
        tmp = path + ".partial"
        if self.rank == 0:
            if os.path.exists(path) and not force:
                raise FileExistsError(f"snapshot {seq} exists: {path}")
            shutil.rmtree(tmp, ignore_errors=True)
        self._barrier()
        with warnings.catch_warnings():   # one process: no group, by design
            warnings.filterwarnings("ignore", "torch.distributed is disabled")
            dcp.save(flat, checkpoint_id=tmp)
        self._barrier()
        if self.rank == 0:
            shutil.rmtree(path, ignore_errors=True)
            os.replace(tmp, path)
        self._barrier()
        return path

    def _template(self, path: str) -> dict:
        """A flat template of whole CPU tensors from the checkpoint's
        metadata (None for a pickled leaf)."""
        import torch
        from torch.distributed.checkpoint import FileSystemReader
        from torch.distributed.checkpoint.metadata import (
            TensorStorageMetadata)

        md = FileSystemReader(path).read_metadata()
        return {k: (torch.empty(tuple(m.size), dtype=m.properties.dtype)
                    if isinstance(m, TensorStorageMetadata) else None)
                for k, m in md.state_dict_metadata.items()}

    def restore(self, seq: int, template: Optional[Any] = None) -> Any:
        """Read a snapshot.  With ``template`` (the state's structure, each
        leaf a tensor or DTensor of the shape, dtype, device and sharding
        to read into), leaves restore into those tensors; without, into
        whole CPU tensors."""
        import torch.distributed.checkpoint as dcp

        path = self.snapshot_dir(seq)
        flat = (self._template(path) if template is None else
                {k: _leaf(v) for k, v in _flatten(template).items()})
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", "torch.distributed is disabled")
            dcp.load(flat, checkpoint_id=path)
        return _unflatten(flat)

    def latest(self) -> Optional[int]:
        """Highest committed snapshot sequence, or None (a
        ``.partial`` directory is not committed)."""
        seqs = []
        try:
            for name in os.listdir(self.base):
                if name.startswith("snapshot_"):
                    try:
                        seqs.append(int(name.split("_", 1)[1]))
                    except ValueError:
                        pass
        except OSError:
            return None
        return max(seqs) if seqs else None
