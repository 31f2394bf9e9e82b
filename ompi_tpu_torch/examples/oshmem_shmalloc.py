"""Symmetric-heap allocation (≈ examples/oshmem_shmalloc.c): every PE
allocates the same-shaped block from the symmetric heap, fills it, and
frees it — the collective-allocation contract shmalloc/shfree promise.

Run:  python -m ompi_tpu_torch.tools.tpurun -np 4 -- \\
          python -m ompi_tpu_torch.examples.oshmem_shmalloc
The port's counterpart of the repo's ``examples/oshmem_shmalloc.py``.
"""

import numpy as np

from ompi_tpu_torch import shmem


def main() -> None:
    shmem.init()
    me = shmem.my_pe()
    # shmem.array is the shmalloc analog: symmetric (same shape/dtype on
    # every PE, collectively allocated, same heap index everywhere)
    block = shmem.array((256,), dtype=np.float64)
    block[:] = float(me)
    shmem.barrier_all()
    assert (np.asarray(block[:]) == float(me)).all()
    shmem.free(block)
    print(f"PE {me}: shmalloc/shfree ok")
    shmem.finalize()


if __name__ == "__main__":
    main()
