"""Flight-recorder demo: exercise every traced layer of the host plane
(the port's counterpart of the repo's ``examples/trace_demo.py``).

Touches p2p (eager AND rendezvous), a collective, a derived datatype
pack, a shared file (MPI-IO) and an RMA window's fence epoch, so a
traced run produces spans in the pml, btl, coll, datatype, io and osc
categories, with send→recv flow ids on every p2p message.  A
``monitoring.Monitor`` counts the traffic per peer; rank 0 prints the
job's sent-bytes matrix (``monitoring.gather_matrix``).

Run:  python -m ompi_tpu_torch.tools.tpurun -np 4 --trace -- \\
          python -m ompi_tpu_torch.examples.trace_demo
Then: python -m ompi_tpu_torch.tools.trace_export --dir "$TMPDIR" \\
          -o trace.json
and load trace.json in chrome://tracing or ui.perfetto.dev.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np

import ompi_tpu_torch
from ompi_tpu_torch.mpi import datatype as dt
from ompi_tpu_torch.mpi import io as mpiio
from ompi_tpu_torch.mpi import monitoring
from ompi_tpu_torch.mpi import osc


def main() -> None:
    comm = ompi_tpu_torch.init()
    rank, size = comm.rank, comm.size
    peer = (rank + 1) % size
    left = (rank - 1) % size
    mon = monitoring.Monitor(comm.pml, size).attach()

    # p2p: one eager message and one past the eager limit (rendezvous)
    rreq = comm.irecv(source=left, tag=1)
    comm.send(np.arange(64, dtype=np.float64), dest=peer, tag=1)
    rreq.wait()
    big = np.ones(128 * 1024, dtype=np.float32)     # 512 KiB > eager limit
    rreq = comm.irecv(np.empty_like(big), source=left, tag=2)
    comm.send(big, dest=peer, tag=2)
    rreq.wait()

    # coll: an allreduce plus the barrier
    total = comm.allreduce(np.full(8, rank, dtype=np.int64))
    comm.barrier()

    # datatype: a strided vector type, committed + packed on the wire
    vec = dt.INT32.vector(count=16, blocklength=2, stride=4).commit()
    buf = np.arange(64, dtype=np.int32)
    rreq = comm.irecv(np.empty(32, np.int32), source=left, tag=3,
                      datatype=dt.INT32, count=32)
    comm.send(buf, dest=peer, tag=3, datatype=vec, count=1)
    got = rreq.wait()
    assert np.array_equal(got, buf.reshape(16, 4)[:, :2].ravel()), got

    # io: per-rank write + read-back through a shared file
    path = os.path.join(
        tempfile.gettempdir(),
        f"otpu_trace_demo_{os.environ.get('OMPI_TPU_JOBID', 0)}.bin")
    fh = mpiio.File(comm, path, mpiio.MODE_RDWR | mpiio.MODE_CREATE)
    fh.set_view(etype=dt.FLOAT64)
    fh.write_at(rank * 16, np.full(16, float(rank), dtype=np.float64))
    back = fh.read_at(rank * 16, 16)
    fh.close()
    assert np.array_equal(back, np.full(16, float(rank))), back
    if rank == 0:
        try:
            os.unlink(path)
        except OSError:
            pass

    # osc: a fence epoch with a put
    win = osc.Window(comm, buffer=np.zeros(8, dtype=np.float64))
    win.fence()
    win.put(peer, np.full(8, float(rank + 1)))
    win.fence()
    assert np.array_equal(win.buf, np.full(8, float(left + 1))), win.buf
    win.free()

    mon.detach()
    matrix = monitoring.gather_matrix(comm, mon, "sent_bytes")
    print(f"rank {rank}: allreduce={int(total[0])}, demo done", flush=True)
    if rank == 0:
        print("MONITOR " + json.dumps(
            {"sent_bytes": np.asarray(matrix).tolist()}), flush=True)
    ompi_tpu_torch.finalize()


if __name__ == "__main__":
    main()
