"""Parallelism layer of the port: mesh, differentiable collectives,
tensor-parallel layers, sequence-parallel attention and ZeRO-1."""

from ompi_tpu_torch.parallel.mesh import Mesh, make_mesh, mesh_shape_for

__all__ = ["Mesh", "make_mesh", "mesh_shape_for"]
