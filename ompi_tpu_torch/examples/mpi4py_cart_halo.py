"""2-D halo exchange through the mpi4py facade's Cartesian topology —
the canonical stencil-code skeleton, unchanged from how it reads under
mpi4py (only the import differs); the port's copy of the repo's
``examples/mpi4py_cart_halo.py``, printing the same lines.

Run:  python -m ompi_tpu_torch.tools.tpurun -np 4 -- \
          python -m ompi_tpu_torch.examples.mpi4py_cart_halo
"""

import numpy as np

from ompi_tpu_torch.compat import MPI


def main() -> None:
    comm = MPI.COMM_WORLD
    dims = MPI.Compute_dims(comm.Get_size(), 2)
    cart = comm.Create_cart(dims, periods=[True, True])
    coords = cart.coords

    # local tile with a 1-cell halo; interior filled with my rank
    n = 4
    tile = np.full((n + 2, n + 2), -1.0)
    tile[1:-1, 1:-1] = float(cart.Get_rank())

    for direction in (0, 1):
        src, dst = cart.Shift(direction, 1)
        recv_lo, recv_hi = np.zeros(n), np.zeros(n)
        if direction == 0:
            send_lo, send_hi = tile[1, 1:-1].copy(), tile[-2, 1:-1].copy()
        else:
            send_lo, send_hi = tile[1:-1, 1].copy(), tile[1:-1, -2].copy()
        # exchange both faces (periodic: neighbors always exist)
        cart.Sendrecv(send_hi, dst, 0, recv_lo, src, 0)
        cart.Sendrecv(send_lo, src, 1, recv_hi, dst, 1)
        if direction == 0:
            tile[0, 1:-1], tile[-1, 1:-1] = recv_lo, recv_hi
        else:
            tile[1:-1, 0], tile[1:-1, -1] = recv_lo, recv_hi

    lo0, _ = cart.Shift(0, 1)
    assert tile[0, 1] == float(lo0), (tile[0, 1], lo0)
    print(f"rank {cart.Get_rank()} coords {coords}: halo exchange ok "
          f"(north face from rank {int(tile[0, 1])})")
    MPI.Finalize()


if __name__ == "__main__":
    main()
