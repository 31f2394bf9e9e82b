"""Strided puts (≈ examples/oshmem_strided_puts.c): PE 0 writes every other
element of PE 1's symmetric array with shmem_iput semantics.

Run:  python -m ompi_tpu_torch.tools.tpurun -np 2 -- \\
          python -m ompi_tpu_torch.examples.oshmem_strided_puts
The port's counterpart of the repo's ``examples/oshmem_strided_puts.py``.
"""

import numpy as np

from ompi_tpu_torch import shmem


def main() -> None:
    shmem.init()
    me = shmem.my_pe()
    assert shmem.n_pes() >= 2, "needs at least 2 PEs"
    dest = shmem.array((10,), dtype=np.int64)
    if me == 0:
        dest.iput(1, np.array([1, 2, 3, 4, 5]), target_stride=2)
    dest.barrier()
    if me == 1:
        got = dest[:].tolist()
        assert got[::2] == [1, 2, 3, 4, 5], got
        print(f"PE 1: strided put ok: {got}")
    shmem.finalize()


if __name__ == "__main__":
    main()
