"""2-D halo exchange over a periodic Cartesian topology — the canonical
stencil-code skeleton of the repo's ``examples/mpi4py_cart_halo.py``,
written through the port's ``Communicator`` (the facade's version is
``examples/mpi4py_cart_halo.py``).

Each rank holds an n×n tile with a one-cell halo, its interior filled
with its cart rank; for each dimension it exchanges both faces with its
two neighbors (``cart_shift`` + ``sendrecv``), then checks that every
halo face holds the neighbor's rank.

Run:  python -m ompi_tpu_torch.tools.tpurun -np 4 -- \\
          python -m ompi_tpu_torch.examples.cart_halo
"""

from __future__ import annotations

import numpy as np

import ompi_tpu_torch
from ompi_tpu_torch.mpi import topo


def halo_exchange(comm, n: int = 4) -> dict:
    """Exchange the halos of one tile on ``comm``'s periodic 2-D cart and
    check them: {"rank", "coords", "faces" (checked, 4)}."""
    dims = topo.dims_create(comm.size, 2)
    cart = comm.cart_create(dims, periods=[True, True])
    me = cart.rank
    tile = np.full((n + 2, n + 2), -1.0)
    tile[1:-1, 1:-1] = float(me)

    for direction in (0, 1):
        src, dst = cart.cart_shift(direction, 1)
        if direction == 0:
            send_lo, send_hi = tile[1, 1:-1].copy(), tile[-2, 1:-1].copy()
        else:
            send_lo, send_hi = tile[1:-1, 1].copy(), tile[1:-1, -2].copy()
        # both faces (periodic: the neighbors always exist)
        recv_lo = cart.sendrecv(send_hi, dst, source=src, sendtag=0,
                                recvtag=0)
        recv_hi = cart.sendrecv(send_lo, src, source=dst, sendtag=1,
                                recvtag=1)
        if direction == 0:
            tile[0, 1:-1], tile[-1, 1:-1] = recv_lo, recv_hi
        else:
            tile[1:-1, 0], tile[1:-1, -1] = recv_lo, recv_hi

    faces = 0
    for direction, lo_face, hi_face in (
            (0, tile[0, 1:-1], tile[-1, 1:-1]),
            (1, tile[1:-1, 0], tile[1:-1, -1])):
        src, dst = cart.cart_shift(direction, 1)
        assert np.all(lo_face == float(src)), (direction, lo_face, src)
        assert np.all(hi_face == float(dst)), (direction, hi_face, dst)
        faces += 2
    return {"rank": me, "coords": cart.cart_coords(me), "faces": faces}


def main() -> None:
    comm = ompi_tpu_torch.init()
    got = halo_exchange(comm)
    print(f"rank {got['rank']} coords {got['coords']}: halo exchange ok "
          f"({got['faces']} faces)", flush=True)
    ompi_tpu_torch.finalize()


if __name__ == "__main__":
    main()
