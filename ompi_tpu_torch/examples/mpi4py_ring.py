"""The classic ring example written against the mpi4py API — runs here
unchanged except for the import line (was: ``from mpi4py import MPI``);
the port's copy of the repo's ``examples/mpi4py_ring.py``, printing the
same lines.

≈ the reference's examples/ring_c.c:1-79, via the compat facade.

Run:  python -m ompi_tpu_torch.tools.tpurun -np 4 -- \
          python -m ompi_tpu_torch.examples.mpi4py_ring
"""

import numpy as np

from ompi_tpu_torch.compat import MPI


def main() -> None:
    comm = MPI.COMM_WORLD
    rank = comm.Get_rank()
    size = comm.Get_size()
    next_rank = (rank + 1) % size
    prev_rank = (rank - 1) % size

    msg = np.array([10], dtype=np.int32)
    if rank == 0:
        print(f"Process 0 sending {msg[0]} to {next_rank}, "
              f"tag 201 ({size} processes in ring)")
        comm.Send([msg, MPI.INT], dest=next_rank, tag=201)

    while True:
        comm.Recv([msg, MPI.INT], source=prev_rank, tag=201)
        if rank == 0:
            msg[0] -= 1
            print(f"Process 0 decremented value: {msg[0]}")
        comm.Send([msg, MPI.INT], dest=next_rank, tag=201)
        if msg[0] == 0:
            print(f"Process {rank} exiting")
            break

    # rank 0 drains the final message still circling the ring
    if rank == 0:
        comm.Recv([msg, MPI.INT], source=prev_rank, tag=201)

    MPI.Finalize()


if __name__ == "__main__":
    main()
