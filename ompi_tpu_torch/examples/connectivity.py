"""All-pairs connectivity check (≈ examples/connectivity_c.c): every ordered
pair exchanges a token; verbose mode prints each edge.

Run:  python -m ompi_tpu_torch.tools.tpurun -np 4 -- \\
          python -m ompi_tpu_torch.examples.connectivity [-v]
The port's counterpart of the repo's ``examples/connectivity.py``.
"""

import sys

import numpy as np

import ompi_tpu_torch


def main() -> None:
    verbose = "-v" in sys.argv
    comm = ompi_tpu_torch.init()
    rank, size = comm.rank, comm.size
    for i in range(size):
        for j in range(i + 1, size):
            if rank == i:
                token = np.array([j], dtype=np.int32)
                comm.send(token, dest=j, tag=i)
                back = comm.recv(source=j, tag=j)
                assert int(back[0]) == i
                if verbose:
                    print(f"Checking connection between ranks {i} and {j}")
            elif rank == j:
                tok = comm.recv(source=i, tag=i)
                assert int(tok[0]) == j
                comm.send(np.array([i], dtype=np.int32), dest=i, tag=j)
    comm.barrier()
    if rank == 0:
        print(f"Connectivity test on {size} processes PASSED.")
    ompi_tpu_torch.finalize()


if __name__ == "__main__":
    main()
