"""On-node collective round trip: allreduce + bcast + barrier + allgather
through whatever coll component owns the slots, printing a verifiable
answer per rank plus the coll/shm arena pvars (the port's copy of the
repo's ``examples/shm_coll_demo.py``, printing the same line).  Pass
``--mca coll_shm_enable 0`` for the coll/host fallback: the pvars then
read 0/0.

Run:  python -m ompi_tpu_torch.tools.tpurun -np 4 -- python -m ompi_tpu_torch.examples.shm_coll_demo
"""

from __future__ import annotations

import numpy as np

import ompi_tpu_torch


def main() -> None:
    comm = ompi_tpu_torch.init()
    rank, size = comm.rank, comm.size

    comm.barrier()
    total = comm.allreduce(np.arange(8.0) + rank)
    want_total = np.arange(8.0) * size + sum(range(size))
    assert np.array_equal(total, want_total), (total, want_total)

    seen = comm.bcast(np.array([3.0, 1.0, 4.0, 1.0, 5.0])
                      if rank == 0 else None, root=0)
    assert np.array_equal(seen, [3.0, 1.0, 4.0, 1.0, 5.0]), seen

    gathered = comm.allgather(np.array([rank * rank]))
    assert np.array_equal(gathered.reshape(-1),
                          [r * r for r in range(size)]), gathered

    # one large allreduce so the segmented pipeline runs too
    big = comm.allreduce(np.ones(200_000) * (rank + 1))
    assert float(big[0]) == sum(range(1, size + 1)), big[0]
    comm.barrier()

    from ompi_tpu_torch.mpi import trace

    fanin = trace.counters["coll_shm_fanin_total"]
    fanout = trace.counters["coll_shm_fanout_total"]
    fallback = trace.counters["coll_shm_fallback_total"]
    provider = comm.coll.providers.get("allreduce", "?")
    print(f"rank {rank}: coll ok sum={float(total.sum()):.0f} "
          f"provider={provider} fanin={fanin} fanout={fanout} "
          f"fallback={fallback}", flush=True)

    ompi_tpu_torch.finalize()


if __name__ == "__main__":
    main()
