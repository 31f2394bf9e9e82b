"""Ring message pass — behavioral equivalent of the reference's
examples/ring_c.c:1-79; the port's copy of the repo's ``examples/ring.py``,
printing the same lines: rank 0 injects a counter,
each rank forwards around the ring decrementing at rank 0 until it reaches 0.

Run:  python -m ompi_tpu_torch.tools.tpurun -np 4 -- python -m ompi_tpu_torch.examples.ring
"""

import numpy as np

import ompi_tpu_torch


def main() -> None:
    comm = ompi_tpu_torch.init()
    rank, size = comm.rank, comm.size
    next_rank = (rank + 1) % size
    prev_rank = (rank - 1) % size

    if rank == 0:
        message = np.array([10], dtype=np.int32)
        print(f"Process 0 sending {int(message[0])} to {next_rank}, "
              f"tag 201 ({size} processes in ring)")
        comm.send(message, dest=next_rank, tag=201)
        print("Process 0 sent to", next_rank)

    while True:
        message = comm.recv(source=prev_rank, tag=201)
        if rank == 0:
            message = message - 1
            print(f"Process 0 decremented value: {int(message[0])}")
        if int(message[0]) == 0 and rank != 0:
            print(f"Process {rank} exiting")
            comm.send(message, dest=next_rank, tag=201)
            break
        comm.send(message, dest=next_rank, tag=201)
        if rank == 0 and int(message[0]) == 0:
            print(f"Process {rank} exiting")
            # absorb the final message so no rank blocks forever
            comm.recv(source=prev_rank, tag=201)
            break

    ompi_tpu_torch.finalize()


if __name__ == "__main__":
    main()
