"""Multi-PE program exercising the OSHMEM extensions: distributed locks,
wait_until, strided iput/iget, active-set collectives.  Run under tpurun;
asserts internally and prints markers the test greps for (the port's copy
of ``tests/shmem/_ext_prog.py``)."""

import numpy as np

from ompi_tpu_torch import shmem
from ompi_tpu_torch.mpi import op as op_mod

shmem.init()
me, n = shmem.my_pe(), shmem.n_pes()
assert n == 4

# -- wait_until: PE 0 waits for a flag put by PE n-1 ------------------------
flag = shmem.array(1, dtype=np.int64)
shmem.barrier_all()
if me == n - 1:
    flag.put(0, np.array([42]))
if me == 0:
    flag.wait_until("eq", 42, timeout=30)
shmem.barrier_all()
if me == 0:
    print("wait_until ok")

# -- lock: mutual exclusion around a read-modify-write ----------------------
counter = shmem.array(1, dtype=np.int64)
lock = shmem.Lock()
shmem.barrier_all()
for _ in range(5):
    with lock:
        # no explicit quiet: clear_lock must embed one (OpenSHMEM §9.9) —
        # this loop is the regression test for that release guarantee
        v = int(counter.get(0, 1)[0])
        counter.put(0, np.array([v + 1]))
shmem.barrier_all()
if me == 0:
    total = int(counter[0])
    assert total == 5 * n, total
    print("lock mutual exclusion ok")

# -- test_lock: only one PE can win an uncontended attempt ------------------
tl = shmem.Lock()
shmem.barrier_all()
won = shmem.test_lock(tl)
wins = shmem.array(n, dtype=np.int64)
for pe in range(n):
    wins.put(pe, np.array([1 if won else 0]), offset=me)
wins.barrier()
assert int(np.sum(wins[:])) == 1, wins[:]
if won:
    shmem.clear_lock(tl)
shmem.barrier_all()
if me == 0:
    print("test_lock single winner ok")

# -- iput/iget: strided remote access ---------------------------------------
grid = shmem.array(16, dtype=np.float64)
shmem.barrier_all()
if me == 1:
    grid.iput(0, np.array([1.0, 2.0, 3.0, 4.0]), target_stride=4)
grid.barrier()   # fence: deliver
if me == 0:
    assert grid[:].tolist()[0:16:4] == [1.0, 2.0, 3.0, 4.0]
    back = grid.iget(0, count=4, source_stride=4)
    assert back.tolist() == [1.0, 2.0, 3.0, 4.0]
    print("iput/iget strided ok")
shmem.barrier_all()

# -- active-set collectives: odd PEs only -----------------------------------
data = shmem.array(2, dtype=np.int64)
data[:] = me
shmem.barrier_all()
odd_set = (1, 1, 2)          # PEs 1 and 3 (start=1, stride 2^1, size 2)
if me % 2 == 1:
    shmem.broadcast_active(data, root_pe=3, active_set=odd_set)
    assert data[:].tolist() == [3, 3], data[:]
    got = shmem.collect_active(data, active_set=odd_set)
    assert got.tolist() == [3, 3, 3, 3]
    data[:] = me
    shmem.to_all_active(data, op=op_mod.SUM, active_set=odd_set)
    assert data[:].tolist() == [4, 4], data[:]
shmem.barrier_all()
if me == 1:
    print("active-set collectives ok")

shmem.barrier_all()
shmem.finalize()
