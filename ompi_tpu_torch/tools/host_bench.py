"""Host-plane probes: point-to-point ping-pong and the host collectives,
run as the ranks of a job of the port's launcher.

    python -m ompi_tpu_torch.tools.tpurun -np 4 --mca pml_eager_limit 4096 \\
        -- python -m ompi_tpu_torch.tools.host_bench
    python -m ompi_tpu_torch.tools.host_bench --proc

Under the launcher, ranks 0 and 1 bounce a buffer of each size (8 B,
4 KiB, 1 MiB, 64 MiB by default) between them: two processes of one
host, so over the shm rings by default, over tcp with ``--mca btl
self,tcp``; the row's ``transport`` is the route rank 0's endpoint took
to rank 1.  With ``--proc`` (no launcher) two ranks on threads of this
one process do (the proc BTL).  Each size runs in blocks of round trips
and reports the median over blocks of the half round trip (µs) and of
the bandwidth (GB/s), the protocol (eager or rendezvous, from
``pml_eager_limit``), and whether the data came back bit for bit.
``--sizes ''`` skips the ping-pong.

Then every rank of the job runs allreduce, bcast, allgather, alltoall,
reduce_scatter_block and scan on ``--mib`` MiB a rank of float32 holding
small integers (every order of summation is exact) and of int32, each
result held bit for bit against numpy on the same data, then allreduce
once under each forced ``coll_host_allreduce_algorithm``; each call
reports its provider (``shm`` or ``host``) and its path (``arena`` when
the communicator's coll/shm arena carried it, else ``host``).
``--mib 0`` skips the collectives.  Every rank also reports its
``init()`` wall time, and rank 0 which native executors loaded.  One
``host_bench {json}`` line is printed (by rank 0); the exit code is 1
when a result differs.
"""

from __future__ import annotations

import argparse
import json
import statistics
import threading
import time

import numpy as np

SIZES = (8, 4 << 10, 1 << 20, 64 << 20)
ALLREDUCE_ALGORITHMS = ("recursive_doubling", "ring", "segmented_ring",
                        "linear")


def _plan(nbytes: int) -> tuple[int, int]:
    """(blocks, round trips a block) for one size."""
    if nbytes <= 4096:
        return 5, 200
    if nbytes <= 1 << 20:
        return 5, 10
    return 3, 2


def pingpong(comm, sizes=SIZES) -> list[dict]:
    """Rank 0 ↔ rank 1 round trips (the other ranks only join the
    barriers); rank 0 returns the rows."""
    from ompi_tpu_torch.core.config import var_registry

    rows = []
    peer = 1 - comm.rank
    for nbytes in sizes:
        if comm.rank > 1:
            comm.barrier()
            continue
        x = (np.arange(nbytes, dtype=np.uint64) * 2654435761 % 251).astype(
            np.uint8)
        back = np.empty_like(x)
        blocks, reps = _plan(nbytes)
        comm.barrier()
        half_us, ok = [], True
        for _ in range(blocks + 1):       # the first block warms up
            t0 = time.perf_counter()
            for _ in range(reps):
                if comm.rank == 0:
                    comm.send(x, dest=peer, tag=1)
                    comm.recv(back, source=peer, tag=2)
                else:
                    comm.recv(back, source=peer, tag=1)
                    comm.send(back, dest=peer, tag=2)
            dt = time.perf_counter() - t0
            half_us.append(dt / reps / 2 * 1e6)
            if comm.rank == 0:
                ok = ok and back.tobytes() == x.tobytes()
                back[:] = 0
        half_us = half_us[1:]
        med = statistics.median(half_us)
        rows.append({"bytes": nbytes, "blocks": blocks, "round_trips": reps,
                     "half_rtt_us": med,
                     "half_rtt_us_blocks": half_us,
                     "gb_s": nbytes / (med * 1e-6) / 1e9,
                     "protocol": ("eager" if nbytes <= var_registry.get(
                         "pml_eager_limit") else "rendezvous"),
                     "bitwise": ok})
    return rows


def _proc_pingpong(sizes) -> list[dict]:
    """Two ranks on threads of this process, over the proc BTL."""
    from ompi_tpu_torch.mpi.comm import Communicator
    from ompi_tpu_torch.mpi.group import Group
    from ompi_tpu_torch.mpi.pml import PmlOb1

    pmls = [PmlOb1(r) for r in range(2)]
    for p in pmls:
        p.set_peers({r: q.address for r, q in enumerate(pmls)})
    comms = [Communicator(Group(range(2)), cid=0, my_world_rank=r,
                          name="pingpong", pml=pmls[r]) for r in range(2)]
    out: list = [None, None]

    def rank(r):
        out[r] = pingpong(comms[r], sizes)

    ts = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    for p in pmls:
        p.close()
    return out[0]


def _arena_ops(comm) -> int:
    """The communicator's coll/shm arena operation count (this rank's
    arrive counter: it advances once per arena round), 0 before the
    arena exists."""
    arena = getattr(getattr(comm, "_coll_shm_state", None), "arena", None)
    return arena._arr if arena is not None else 0


def _rank_data(rank: int, n: int, dtype) -> np.ndarray:
    rng = np.random.default_rng(100 + rank)
    return rng.integers(-8, 8, size=n, dtype=np.int32).astype(dtype)


def colls(comm, mib: float) -> dict:
    """Every rank checks its own results; rank 0 returns the report."""
    from ompi_tpu_torch.core.config import var_registry
    from ompi_tpu_torch.mpi import op

    size, r = comm.size, comm.rank
    n = int(mib * (1 << 20)) // 4 // size * size
    out = {"bytes_per_rank": n * 4, "ranks": size, "calls": []}

    def timed(name, dtype, fn, want):
        comm.barrier()
        ops = _arena_ops(comm)
        t0 = time.perf_counter()
        got = fn()
        dt = time.perf_counter() - t0
        arena = _arena_ops(comm) > ops
        got = np.asarray(got)
        ok = (got.dtype == want.dtype and got.shape == want.shape
              and got.tobytes() == want.tobytes())
        oks = comm.allgather(np.array([ok]))
        times = comm.allgather(np.array([dt]))
        paths = comm.allgather(np.array([arena]))
        out["calls"].append({"coll": name, "dtype": np.dtype(dtype).name,
                             "bitwise": bool(oks.all()),
                             "provider": comm.coll.providers[
                                 name.split(":")[0]],
                             "path": "arena" if paths.all() else "host",
                             "seconds_max": float(times.max())})

    for dtype in (np.float32, np.int32):
        data = [_rank_data(k, n, dtype) for k in range(size)]
        mine = data[r]
        total = data[0].copy()
        for k in range(1, size):
            total += data[k]
        timed("allreduce", dtype, lambda: comm.allreduce(mine, op.SUM),
              total)
        timed("bcast", dtype,
              lambda: comm.bcast(mine if r == 0 else None, root=0), data[0])
        timed("allgather", dtype, lambda: comm.allgather(mine),
              np.stack(data))
        blocks = [np.split(d, size) for d in data]
        timed("alltoall", dtype, lambda: comm.alltoall(mine),
              np.concatenate([blocks[k][r] for k in range(size)]))
        timed("reduce_scatter_block", dtype,
              lambda: comm.reduce_scatter_block(mine, op.SUM),
              np.split(total, size)[r])
        prefix = data[0].copy()
        for k in range(1, r + 1):
            prefix += data[k]
        timed("scan", dtype, lambda: comm.scan(mine, op.SUM), prefix)
        if dtype is np.float32:
            for alg in ALLREDUCE_ALGORITHMS:
                var_registry.set("coll_host_allreduce_algorithm", alg)
                timed(f"allreduce:{alg}", dtype,
                      lambda: comm.allreduce(mine, op.SUM), total)
            var_registry.set("coll_host_allreduce_algorithm", "")
        del data, blocks
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="host_bench")
    p.add_argument("--proc", action="store_true",
                   help="ping-pong between two ranks on threads of this "
                        "process only (no launcher)")
    p.add_argument("--mib", type=float, default=64.0)
    p.add_argument("--sizes", default=",".join(map(str, SIZES)))
    args = p.parse_args(argv)
    sizes = [int(s) for s in args.sizes.split(",") if s]
    if args.proc:
        rows = _proc_pingpong(sizes)
        print("host_bench " + json.dumps({"transport": "proc",
                                          "rows": rows}), flush=True)
        return 0 if all(row["bitwise"] for row in rows) else 1
    t0 = time.perf_counter()
    import ompi_tpu_torch
    import ompi_tpu_torch.mpi.runtime  # noqa: F401 — torch, numpy, the PML

    t_import = time.perf_counter()
    from ompi_tpu_torch import _native

    comm = ompi_tpu_torch.init()
    init_s = time.perf_counter() - t_import
    res = {"transport": comm.pml.endpoint.route(1 - min(comm.rank, 1)),
           "native": {"convertor": _native.available(),
                      "arena": _native.arena_available(),
                      "net": _native.net_available(),
                      "fastdss": _native.fastdss() is not None,
                      "engine": comm.pml._eng is not None},
           "rows": pingpong(comm, sizes), "calls": []}
    if args.mib > 0:
        res.update(colls(comm, args.mib))
    inits = comm.allgather(np.array([init_s, t_import - t0]))
    res["init_s"] = inits[:, 0].tolist()
    res["import_s"] = inits[:, 1].tolist()
    if comm.rank == 0:
        print("host_bench " + json.dumps(res), flush=True)
    ompi_tpu_torch.finalize()
    ok = all(c["bitwise"] for c in res["calls"]) and all(
        row["bitwise"] for row in res["rows"])
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
