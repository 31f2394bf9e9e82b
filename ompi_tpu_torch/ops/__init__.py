"""Hand-written Hopper kernels for the port's hot ops.

Each kernel's CUDA source lives under ``csrc/`` and is built with nvcc at
first use (``_build``); beside it, in the same module, is its plain
PyTorch version, which CPU tensors take and which the kernel is held
against on the card.
"""

from ompi_tpu_torch.ops.flash_attention import (flash_attention,
                                                flash_attention_lse)

__all__ = ["flash_attention", "flash_attention_lse"]
