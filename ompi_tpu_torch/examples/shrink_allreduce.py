"""shrink_allreduce — the ULFM shrink-and-continue recipe, end to end; the
port's copy of the repo's ``examples/shrink_allreduce.py``, printing the
same lines.

An iterative allreduce loop that loses a rank mid-run (an injected kill
from a fault plan, or nothing when run without one), detects the failure,
revokes the communicator so every survivor unblocks, agrees on the
failed set, shrinks to the survivor communicator, restores from the last
*agreed* checkpoint snapshot, and finishes with the correct sum.

Run it under the notify errmgr policy so the runtime propagates the
death instead of killing the job:

    python -m ompi_tpu_torch.tools.tpurun -np 4 --mca errmgr notify \
        --mca faultinject_plan "rank=2:kill@step=3" \
        -- python -m ompi_tpu_torch.examples.shrink_allreduce

Protocol per step (the canonical ULFM loop):

1. every rank contributes ``id*10 + step`` (id = its ORIGINAL world
   rank, stable across shrinks) to an allreduce;
2. a rank whose allreduce raised PROC_FAILED/REVOKED calls
   ``comm.revoke()`` IMMEDIATELY — this is the load-bearing ULFM move:
   a peer still blocked inside the collective is waiting on a *survivor*
   that already errored out, and only the revocation's poison unblocks
   it (the failure alone never would);
3. every rank votes ``comm.agree(step_succeeded)`` — a step only counts
   when EVERY member completed it, so survivors can never commit a sum
   the failure made inconsistent;
4. agreed → checkpoint (step, acc) and advance;  not agreed →
   ``shrink()`` to the survivors, restore the last agreed snapshot, and
   repeat the step on the smaller world.

The final acc on every survivor equals: full-world sums for the steps
agreed before the kill, survivor-only sums after.
"""

import os
import sys
import time

import numpy as np

import ompi_tpu_torch
from ompi_tpu_torch.ckpt.store import SnapshotStore
from ompi_tpu_torch.mpi.constants import (
    ERR_PROC_FAILED, ERR_REVOKED, MPIException,
)
from ompi_tpu_torch.testing import faultinject



def main() -> int:
    comm = ompi_tpu_torch.init()
    my_id = comm.rank        # stable identity; comm.rank changes on shrink
    steps = int(os.environ.get("SHRINK_DEMO_STEPS", "6"))
    ckpt_dir = os.environ.get("CKPT_DIR")
    store = (SnapshotStore(ckpt_dir, job=f"rank{my_id}")
             if ckpt_dir else None)

    acc, step, shrinks = 0.0, 0, 0
    while step < steps:
        faultinject.step()   # a plan's kill@step fires here (or no-op)
        ok = True
        t_op = time.monotonic()
        try:
            got = comm.allreduce(np.array([float(my_id * 10 + step)]))
            result = float(got[0])
        except MPIException as e:
            if e.error_class not in (ERR_PROC_FAILED, ERR_REVOKED):
                raise
            ok, result = False, 0.0
            # time-to-error: how long the collective blocked before the
            # failure surfaced (it stays in the detector window, nowhere
            # near the 60 s coll_shm_timeout)
            print(f"id {my_id} detect_dt={time.monotonic() - t_op:.2f}",
                  flush=True)
            # revoke BEFORE agreeing: survivors still blocked in the
            # collective are waiting on ranks that already errored out —
            # the revocation is what unblocks them into the agree below
            comm.revoke()
        try:
            agreed = comm.agree(ok)
        except MPIException as e:
            if e.error_class != ERR_PROC_FAILED:
                raise
            agreed = False
        if agreed:
            acc += result
            if store is not None:
                store.write_rank(step, 0, {"step": np.int64(step),
                                           "acc": np.float64(acc)})
                store.commit(step, 1)
            step += 1
            continue
        # somebody failed this step: drop the dead, rewind to the last
        # agreed snapshot, redo the step on the survivor communicator
        comm.revoke()   # idempotent; covers an agree()==False-only path
        old_members = set(comm.group.ranks)
        comm = comm.shrink()
        lost = sorted(old_members - set(comm.group.ranks))
        shrinks += 1
        if store is not None and store.latest() is not None:
            seq = store.latest()
            state = store.load_rank(seq, 0)
            step, acc = int(state["step"]) + 1, float(state["acc"])
        else:
            step, acc = 0, 0.0
        print(f"id {my_id}: shrank to size {comm.size} (lost {lost}); "
              f"resuming at step {step}", flush=True)

    print(f"id {my_id} final acc={acc:.0f} size={comm.size} "
          f"shrinks={shrinks}", flush=True)
    ompi_tpu_torch.finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
