"""Collective MPI-IO of a block-distributed matrix — the repo's
``examples/mpiio_darray.py``, written through the port's
``Communicator`` and ``mpi.io`` (the mpi4py facade's ``MPI.File`` wraps
the same ``mpi.io.File``).

Each rank owns one block of an N×N float64 matrix on a √P×√P process
grid; a darray file view lets every rank write its block to the ONE
shared file with a single collective call (the fcoll aggregators turn
the interleaved row segments into large contiguous file writes), then
read it back through the same view.

Run:  python -m ompi_tpu_torch.tools.tpurun -np 4 -- \\
          python -m ompi_tpu_torch.examples.mpiio_darray
"""

from __future__ import annotations

import math
import os
import tempfile

import numpy as np

import ompi_tpu_torch
from ompi_tpu_torch.mpi import datatype as dt
from ompi_tpu_torch.mpi import io as mio


def main() -> None:
    comm = ompi_tpu_torch.init()
    rank, size = comm.rank, comm.size
    q = int(math.isqrt(size))
    assert q * q == size, "run with a square process count (1, 4, 9, ...)"

    n = 8 * q                      # global matrix side; 8x8 block per rank
    # unique per-run file (a fixed name would collide across or between
    # runs — MODE_CREATE doesn't truncate); rank 0 names it, all agree
    # (the name travels as its bytes in a fixed-size array)
    name = np.zeros(4096, np.uint8)
    if rank == 0:
        fd, path = tempfile.mkstemp(suffix=".darray.bin")
        os.close(fd)
        raw = path.encode()
        name[:len(raw)] = np.frombuffer(raw, np.uint8)
    name = np.asarray(comm.bcast(name, root=0))
    path = bytes(name[name != 0]).decode()

    try:
        view = dt.create_darray(
            size, rank, [n, n],
            [dt.DISTRIBUTE_BLOCK, dt.DISTRIBUTE_BLOCK],
            [dt.DISTRIBUTE_DFLT_DARG, dt.DISTRIBUTE_DFLT_DARG],
            [q, q], dt.FLOAT64).commit()

        # my block, filled with rank-stamped values
        block = np.full((n // q) * (n // q), float(rank), np.float64)
        block += np.arange(block.size) / 1000.0

        f = mio.File.open(comm, path, mio.MODE_RDWR | mio.MODE_CREATE)
        f.set_view(disp=0, etype=dt.FLOAT64, filetype=view)
        f.write_at_all(0, block)
        back = f.read_at_all(0, block.size)
        f.close()
        assert np.array_equal(back, block), "roundtrip mismatch"

        # rank 0 checks the assembled global matrix on disk
        comm.barrier()
        if rank == 0:
            disk = np.fromfile(path, np.float64).reshape(n, n)
            b = n // q
            for r in range(size):
                pr, pc = divmod(r, q)
                got = disk[pr * b:(pr + 1) * b, pc * b:(pc + 1) * b]
                assert abs(got[0, 0] - float(r)) < 1e-9, (r, got[0, 0])
            print(f"darray collective IO ok: {n}x{n} matrix, {size} ranks, "
                  f"one shared file", flush=True)
    finally:
        comm.barrier()
        if rank == 0:
            try:
                os.unlink(path)
            except OSError:
                pass
    ompi_tpu_torch.finalize()


if __name__ == "__main__":
    main()
