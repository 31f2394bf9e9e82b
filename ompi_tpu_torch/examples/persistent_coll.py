"""Persistent & partitioned round trip (the port's counterpart of the
repo's ``examples/persistent_coll_demo.py``): bind ONE allreduce plan,
Start it N times, verify every iteration, then a pairwise-ring
partitioned psend/precv exchange with out-of-order Pready.

The port has no trace plane yet, so in place of the bind/start/fallback
counters each rank prints the plan's ``provider`` (``shm`` on one host,
``nbc`` or ``host`` with ``--mca coll_shm_enable 0``) and ``algorithm``.

Run:  python -m ompi_tpu_torch.tools.tpurun -np 4 -- \\
          python -m ompi_tpu_torch.examples.persistent_coll
"""

from __future__ import annotations

import numpy as np

import ompi_tpu_torch
from ompi_tpu_torch.mpi.request import start_all


def main() -> None:
    comm = ompi_tpu_torch.init()
    rank, size = comm.rank, comm.size
    comm.barrier()

    N = 16
    x = np.zeros(64)
    req = comm.allreduce_init(x)
    total = None
    for k in range(N):
        x[...] = np.arange(64.0) + rank + k
        req.start()
        total = req.wait()
        want = np.arange(64.0) * size + sum(range(size)) + size * k
        assert np.array_equal(total, want), (k, total, want)
    print(f"rank {rank}: persistent ok sum={float(total.sum()):.0f} "
          f"provider={req.provider} algorithm={req.algorithm} "
          f"starts={N}", flush=True)

    # partitioned pairwise ring: send to the right, receive from the
    # left, partitions readied out of order
    sbuf = np.arange(32.0) + rank
    rbuf = np.zeros(32)
    ps = comm.psend_init(sbuf, dest=(rank + 1) % size, tag=1,
                         partitions=4)
    pr = comm.precv_init(rbuf, source=(rank - 1) % size, tag=1,
                         partitions=4)
    start_all([ps, pr])
    for i in (2, 0, 3, 1):
        ps.pready(i)
    ps.wait()
    pr.wait()
    assert np.array_equal(rbuf, np.arange(32.0) + (rank - 1) % size), rbuf
    print(f"rank {rank}: partitioned ok", flush=True)

    comm.barrier()
    ompi_tpu_torch.finalize()


if __name__ == "__main__":
    main()
