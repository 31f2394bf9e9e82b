"""Parallelism layer of the port: mesh, differentiable collectives,
tensor-parallel layers, sequence-parallel attention, switch-MoE expert
parallelism, the GPipe pipeline and ZeRO-1.  The names below load on
first use, so that ``init()`` can reach ``parallel.multihost`` without
importing torch."""

import importlib

_LAZY = {"Mesh": "mesh", "make_mesh": "mesh", "mesh_shape_for": "mesh",
         "moe_params": "moe", "switch_moe": "moe", "gpipe": "pipeline"}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    if name in _LAZY:
        mod = importlib.import_module(f"{__name__}.{_LAZY[name]}")
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
