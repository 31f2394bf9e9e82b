"""Parallelism layer of the port: mesh, tensor-parallel layers and
attention (sequence-parallel entry points at sp == 1 in this slice)."""

from ompi_tpu_torch.parallel.mesh import Mesh, make_mesh, mesh_shape_for

__all__ = ["Mesh", "make_mesh", "mesh_shape_for"]
