"""RMA demo: fence, PSCW epochs, get_accumulate, request ops, dynamic
windows (≈ the reference's one-sided usage in its test suites; MPI-3.1
ch. 11 semantics).  The port's counterpart of the repo's
``examples/rma_pscw.py``.

Run:  python -m ompi_tpu_torch.tools.tpurun -np 4 -- \\
          python -m ompi_tpu_torch.examples.rma_pscw
"""

import numpy as np

import ompi_tpu_torch


def main() -> None:
    ompi_tpu_torch.init()
    comm = ompi_tpu_torch.COMM_WORLD
    rank, size = comm.rank, comm.size

    # -- fence + get_accumulate: a shared atomic counter --------------------
    win = ompi_tpu_torch.Window(comm, size=1, dtype=np.int64)
    win.fence()
    ticket = int(win.get_accumulate(0, np.array([1]), ompi_tpu_torch.SUM)[0])
    win.fence()
    total = int(win.get(0, count=1)[0])
    assert total == size, (total, size)
    print(f"rank {rank}: ticket={ticket} total={total}")
    win.free()

    # -- PSCW: even ranks expose, odd ranks access --------------------------
    win = ompi_tpu_torch.Window(comm, size=size, dtype=np.int64)
    evens = list(range(0, size, 2))
    odds = list(range(1, size, 2))
    if rank % 2 == 0:
        win.post(odds)
        win.wait()
        got = win.buf[: len(odds)].tolist()
        assert got == [o + 1 for o in odds], got
        print(f"rank {rank}: PSCW exposure saw {got}")
    else:
        win.start(evens)
        for t in evens:
            win.rput(t, np.array([rank + 1]), offset=rank // 2).wait()
        win.complete()
    comm.barrier()
    win.free()

    # -- dynamic window -----------------------------------------------------
    win = ompi_tpu_torch.Window.create_dynamic(comm, dtype=np.float64)
    region = np.zeros(4)
    base = win.attach(region)
    bases = [int(np.asarray(b)[0]) for b in comm.allgather(np.array([base]))]
    win.fence()
    right = (rank + 1) % size
    win.put(right, np.full(4, float(rank)), offset=bases[right])
    win.fence()
    assert region.tolist() == [float((rank - 1) % size)] * 4, region
    win.detach(base)
    win.free()
    print(f"rank {rank}: dynamic window ok")

    ompi_tpu_torch.finalize()


if __name__ == "__main__":
    main()
