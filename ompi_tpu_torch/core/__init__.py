"""Core services of the port: the typed configuration-variable registry."""

from ompi_tpu_torch.core.config import register_var, var_registry

__all__ = ["register_var", "var_registry"]
