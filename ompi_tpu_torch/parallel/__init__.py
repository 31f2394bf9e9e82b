"""Parallelism layer of the port: mesh, differentiable collectives,
tensor-parallel layers, sequence-parallel attention, switch-MoE expert
parallelism and ZeRO-1."""

from ompi_tpu_torch.parallel.mesh import Mesh, make_mesh, mesh_shape_for
from ompi_tpu_torch.parallel.moe import moe_params, switch_moe

__all__ = ["Mesh", "make_mesh", "mesh_shape_for", "moe_params",
           "switch_moe"]
