"""Load the JAX package's parameter dict into the port.

``from_jax_params`` takes the dict that ``init_params`` (either package's)
returns, or one taken from the JAX package as numpy arrays
(``{k: np.asarray(v)}``), and returns the port's parameters: torch tensors
on one device, the matrices cast once to the compute dtype and the
``ln*`` scales kept in float32.  Casting ``emb`` before the embedding
gather gives the same values as the JAX package's cast after it.
"""

from __future__ import annotations

import numpy as np
import torch

from ompi_tpu_torch.models.transformer import TransformerConfig, torch_dtype
from ompi_tpu_torch.parallel.mesh import resolve_device

__all__ = ["from_jax_params"]


def _tensor(arr) -> torch.Tensor:
    arr = np.ascontiguousarray(np.asarray(arr))
    if not arr.flags.writeable:  # JAX exports read-only views
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16, as JAX exports it
        return torch.from_numpy(arr.view(np.uint16).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(arr)


def from_jax_params(params: dict, cfg: TransformerConfig,
                    device="cuda") -> dict:
    """numpy parameter dict → the port's dict of tensors on ``device``."""
    dev = resolve_device(device)
    cdt = torch_dtype(cfg.compute_dtype)
    out = {}
    for name, arr in params.items():
        t = _tensor(arr).to(dev)
        out[name] = (t.to(torch.float32) if name.startswith("ln")
                     else t.to(cdt))
    return out
