"""Ring message pass over the symmetric heap with wait_until
(≈ examples/ring_oshmem_c.c): a counter circulates the PE ring; PE 0
decrements it each lap; each PE exits after its final put (PE 0's
closing 0-put lands in an already-exited neighbor's slot, completed by
finalize's collective teardown — the reference behaves the same way).

Run:  python -m ompi_tpu_torch.tools.tpurun -np 4 -- \\
          python -m ompi_tpu_torch.examples.ring_oshmem
The port's counterpart of the repo's ``examples/ring_oshmem.py``.
"""

import numpy as np

from ompi_tpu_torch import shmem


def main() -> None:
    shmem.init()
    me, n = shmem.my_pe(), shmem.n_pes()
    rbuf = shmem.array((1,), dtype=np.int64)
    rbuf[:] = -1
    shmem.barrier_all()  # everyone's rbuf exists before the first put
    nxt = (me + 1) % n
    message = 10
    if me == 0:
        print(f"PE 0 puts message {message} to {nxt} ({n} PEs in ring)")
        rbuf.put(nxt, np.array([message]))
    while message > 0:
        rbuf.wait_until("eq", message)
        if me == 0:
            message -= 1
            print(f"PE 0 decremented value: {message}")
        rbuf.put(nxt, np.array([message]))
        if me != 0:
            message -= 1
    shmem.finalize()
    print(f"PE {me} exiting")


if __name__ == "__main__":
    main()
