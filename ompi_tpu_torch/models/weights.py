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
"""

from __future__ import annotations

import numpy as np
import torch

from ompi_tpu_torch.models.transformer import TransformerConfig, torch_dtype
from ompi_tpu_torch.parallel.mesh import resolve_device

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
                    train: bool = False) -> dict:
    """numpy parameter dict → the port's dict of tensors on ``device``
    (serving dtypes, or trainable storage-dtype leaves with ``train``)."""
    dev = resolve_device(device)
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


def to_numpy_params(params: dict) -> dict:
    """The port's tensors → a dict of float32 numpy arrays on the host."""
    return {name: t.detach().to(torch.float32).cpu().numpy()
            for name, t in params.items()}
