"""Max reduction across PEs (≈ examples/oshmem_max_reduction.c):
every PE fills a symmetric array with rank-dependent values; max_to_all
leaves the elementwise maximum on every PE.

Run:  python -m ompi_tpu_torch.tools.tpurun -np 4 -- \\
          python -m ompi_tpu_torch.examples.oshmem_max_reduction
The port's counterpart of the repo's ``examples/oshmem_max_reduction.py``.
"""

import numpy as np

from ompi_tpu_torch import shmem
from ompi_tpu_torch.mpi import op as op_mod

N = 8


def main() -> None:
    shmem.init()
    me, n = shmem.my_pe(), shmem.n_pes()
    src = shmem.array((N,), dtype=np.int64)
    src[:] = me + np.arange(N)
    shmem.barrier_all()
    shmem.to_all(src, op=op_mod.MAX)
    expected = (n - 1) + np.arange(N)
    assert (src[:] == expected).all(), (src[:], expected)
    print(f"PE {me}: max reduction ok: {src[:].tolist()}")
    shmem.finalize()


if __name__ == "__main__":
    main()
