"""Matched probe: a multi-threaded task-pull server.

    python -m ompi_tpu_torch.tools.tpurun -np 4 -- \\
        python -m ompi_tpu_torch.examples.mprobe_task_queue

Rank 0 runs TWO worker threads pulling tasks from any source with
``mprobe`` — the MPI-3 matched probe is the only thread-safe way to
probe-then-receive with wildcards: the probe atomically detaches the
message, so the sibling thread can never steal it between the probe and
the receive (a plain probe+recv pair races exactly there).
The port's counterpart of the repo's ``examples/mprobe_task_queue.py``.
"""

import threading

import numpy as np

import ompi_tpu_torch

TASKS_PER_RANK = 8


def main() -> None:
    comm = ompi_tpu_torch.init()
    if comm.size < 2:
        raise SystemExit("need at least 2 ranks")
    if comm.rank == 0:
        target = (comm.size - 1) * TASKS_PER_RANK
        got: list = []
        lock = threading.Lock()

        def worker(wid: int) -> None:
            while True:
                with lock:
                    if len(got) >= target:
                        return
                try:
                    msg, st = comm.mprobe(source=-1, tag=7, timeout=0.2)
                except TimeoutError:
                    continue                  # re-check the done counter
                task = comm.mrecv(message=msg)
                with lock:
                    got.append((wid, st.source, int(task[0])))

        ts = [threading.Thread(target=worker, args=(w,)) for w in (0, 1)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        per_worker = {w: sum(1 for x in got if x[0] == w) for w in (0, 1)}
        tasks = sorted(x[2] for x in got)
        expect = sorted(r * 100 + i for r in range(1, comm.size)
                        for i in range(TASKS_PER_RANK))
        assert tasks == expect, "every task delivered exactly once"
        print(f"rank 0 processed {len(got)} tasks across workers "
              f"{per_worker} — no duplicates, no losses")
    else:
        for i in range(TASKS_PER_RANK):
            comm.send(np.array([comm.rank * 100 + i], np.int64),
                      dest=0, tag=7)
    comm.barrier()
    ompi_tpu_torch.finalize()


if __name__ == "__main__":
    main()
