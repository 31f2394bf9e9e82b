"""Flagship models of the port (lazy re-exports, as in the JAX package)."""

from __future__ import annotations

import importlib
from typing import Any

_LAZY = {
    "TransformerConfig": ("ompi_tpu_torch.models.transformer",
                          "TransformerConfig"),
    "init_params": ("ompi_tpu_torch.models.transformer", "init_params"),
    "make_forward": ("ompi_tpu_torch.models.transformer", "make_forward"),
    "make_loss_fn": ("ompi_tpu_torch.models.transformer", "make_loss_fn"),
    "make_train_step": ("ompi_tpu_torch.models.transformer",
                        "make_train_step"),
    "make_train_loop": ("ompi_tpu_torch.models.transformer",
                        "make_train_loop"),
    "param_specs": ("ompi_tpu_torch.models.transformer", "param_specs"),
    "shard_tokens": ("ompi_tpu_torch.models.transformer", "shard_tokens"),
    "make_decoder": ("ompi_tpu_torch.models.decode", "make_decoder"),
    "ArraySource": ("ompi_tpu_torch.models.data", "ArraySource"),
    "MemmapSource": ("ompi_tpu_torch.models.data", "MemmapSource"),
    "train_stream": ("ompi_tpu_torch.models.data", "train_stream"),
    "from_jax_params": ("ompi_tpu_torch.models.weights", "from_jax_params"),
    "to_numpy_params": ("ompi_tpu_torch.models.weights", "to_numpy_params"),
    "switch_moe": ("ompi_tpu_torch.parallel.moe", "switch_moe"),
    "moe_params": ("ompi_tpu_torch.parallel.moe", "moe_params"),
}

__all__ = sorted(_LAZY)


def __getattr__(name: str) -> Any:
    try:
        mod, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}") from None
    return getattr(importlib.import_module(mod), attr)
