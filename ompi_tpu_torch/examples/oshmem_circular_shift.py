"""Circular shift through the symmetric heap (≈ examples/oshmem_circular_shift.c):
each PE puts its value into the next PE's symmetric slot; after the barrier
every PE holds its left neighbor's value.

Run:  python -m ompi_tpu_torch.tools.tpurun -np 4 -- \\
          python -m ompi_tpu_torch.examples.oshmem_circular_shift
The port's counterpart of the repo's ``examples/oshmem_circular_shift.py``.
"""

import numpy as np

from ompi_tpu_torch import shmem


def main() -> None:
    shmem.init()
    me, n = shmem.my_pe(), shmem.n_pes()
    dest = shmem.array((1,), dtype=np.int64)
    next_pe = (me + 1) % n
    dest.put(next_pe, np.array([me + 10]))
    dest.barrier()  # completes all puts everywhere
    want = ((me - 1) % n) + 10
    assert int(dest[0]) == want, (int(dest[0]), want)
    print(f"PE {me}: circular shift ok (got {int(dest[0])})")
    shmem.finalize()


if __name__ == "__main__":
    main()
