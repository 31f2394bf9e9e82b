"""Example MPI programs of the port, run under its launcher:
``python -m ompi_tpu_torch.tools.tpurun -np 4 -- python -m
ompi_tpu_torch.examples.ring``."""
