"""Helper program: SHMEM atomics across PEs (the port's copy of
``tests/shmem/_atomic_prog.py``; run under the port's tpurun)."""

import numpy as np

from ompi_tpu_torch import shmem
from ompi_tpu_torch.shmem import api as shmem_api

shmem.init()
me, n = shmem.my_pe(), shmem.n_pes()
counter = shmem.array((1,), dtype=np.int64)
shmem.barrier_all()

tickets = [int(shmem.atomic_fetch_add(counter, 0, 1)) for _ in range(5)]
counter.barrier()

gathered = shmem_api._comm().allgather(np.array(tickets, dtype=np.int64))
if me == 0:
    allt = sorted(np.asarray(gathered).ravel().tolist())
    assert allt == list(range(5 * n)), allt
    assert int(counter[0]) == 5 * n
    print("fetch_add tickets unique:", len(allt))
shmem.barrier_all()
shmem.finalize()
