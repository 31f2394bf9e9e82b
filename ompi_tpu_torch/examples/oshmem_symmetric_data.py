"""Symmetric data access (≈ examples/oshmem_symmetric_data.c): PE 0 gets
every other PE's symmetric array contents and verifies them.

Run:  python -m ompi_tpu_torch.tools.tpurun -np 4 -- \\
          python -m ompi_tpu_torch.examples.oshmem_symmetric_data
The port's counterpart of the repo's ``examples/oshmem_symmetric_data.py``.
"""

import numpy as np

from ompi_tpu_torch import shmem

N = 6


def main() -> None:
    shmem.init()
    me, n = shmem.my_pe(), shmem.n_pes()
    data = shmem.array((N,), dtype=np.int64)
    data[:] = me * 100 + np.arange(N)
    shmem.barrier_all()
    if me == 0:
        for pe in range(n):
            got = data.get(pe)
            want = pe * 100 + np.arange(N)
            assert (got == want).all(), (pe, got)
        print(f"PE 0: verified symmetric data on all {n} PEs")
    shmem.barrier_all()
    shmem.finalize()


if __name__ == "__main__":
    main()
