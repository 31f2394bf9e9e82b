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

``--nbc`` runs the nonblocking, persistent and partitioned operations
and the topologies instead (``--mib`` MiB a rank, ``--part-mib`` MiB a
part for the v and w forms), each result held bit for bit against the
blocking call or numpy: every ``i*`` collective; ``allreduce_init``
started 16 times with its ``provider`` and ``algorithm``, and µs per
``start``+``wait`` beside one-shot ``allreduce`` at 4 KiB and at
``--mib``; every other ``*_init`` kind once at ``--part-mib``; a
ping-pong of ``send_init``/``recv_init`` against ``isend``/``irecv``
and the blocking ``send``/``recv`` at 8 B and ``--mib`` between ranks 0
and 1; ``psend_init``/``precv_init`` at ``--mib`` in 8 partitions
readied out of order (GB/s); and on a
periodic 2×2 cart the neighbor collectives, their ``ineighbor_*``
forms and ``neighbor_alltoall_init`` at ``--part-mib`` with the halo
exchange of ``examples/cart_halo.py``.  ``--nbc persistent`` runs only
the ``allreduce_init`` rows.  ``--overlap`` (a ``--gpu`` job) posts an
``iallreduce`` of ``--mib`` MiB of host memory, keeps the rank's card
busy with a loop of bf16 GEMMs calling ``test()`` between launches, and
times the collective alone, the loop alone and both together; then, in
a torch.profiler window with one deliberate control copy, it checks
that ``iallreduce``, ``allreduce_init``, ``psend_init`` and
``neighbor_alltoall`` refuse a CUDA tensor with no device-to-host copy.
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
    p.add_argument("--nbc", nargs="?", const="all", default=None,
                   choices=["all", "persistent"],
                   help="the nonblocking/persistent/partitioned/topology "
                        "rows instead of the ping-pong and collectives")
    p.add_argument("--part-mib", type=float, default=1.0)
    p.add_argument("--overlap", action="store_true",
                   help="iallreduce overlapped with GEMMs on the card "
                        "(under tpurun --gpu)")
    args = p.parse_args(argv)
    if args.nbc or args.overlap:
        return _slice_main(args)
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


# ---------------------------------------------------------------------------
# nonblocking, persistent and partitioned operations, topologies
# ---------------------------------------------------------------------------

def _same(got, want) -> bool:
    got, want = np.asarray(got), np.asarray(want)
    return (got.dtype == want.dtype and got.shape == want.shape
            and got.tobytes() == want.tobytes())


def _all(comm, ok: bool) -> bool:
    """True when ``ok`` holds on every rank."""
    return bool(comm.allgather(np.array([bool(ok)])).all())


def _tmax(comm, seconds: float) -> float:
    return float(comm.allgather(np.array([seconds])).max())


def nbc_calls(comm, mib: float, part_mib: float) -> list[dict]:
    """Every ``i*`` collective at ``mib`` MiB a rank (the v and w forms at
    ``part_mib`` MiB a part), each against its blocking call."""
    from ompi_tpu_torch.mpi import datatype as dt_mod
    from ompi_tpu_torch.mpi import op

    size, r = comm.size, comm.rank
    n = int(mib * (1 << 20)) // 4 // size * size
    m = int(part_mib * (1 << 20)) // 4
    mine = _rank_data(r, n, np.float32)
    part = _rank_data(r, m, np.float32)
    parts = [part[: m - d] for d in range(size)]
    rows = []

    def row(name, post, blocking, equal=None):
        comm.barrier()
        t0 = time.perf_counter()
        got = post().wait()
        t_nb = time.perf_counter() - t0
        comm.barrier()
        t0 = time.perf_counter()
        want = blocking()
        t_b = time.perf_counter() - t0
        ok = (equal or _same_nested)(got, want)
        rows.append({"coll": name, "bitwise": _all(comm, ok),
                     "seconds_max": _tmax(comm, t_nb),
                     "blocking_seconds_max": _tmax(comm, t_b)})

    row("ibarrier", comm.ibarrier, comm.barrier, lambda a, b: a is b)
    row("ibcast", lambda: comm.ibcast(mine if r == 0 else None, root=0),
        lambda: comm.bcast(mine if r == 0 else None, root=0))
    row("ireduce", lambda: comm.ireduce(mine, op.SUM, root=0),
        lambda: comm.reduce(mine, op.SUM, root=0))
    row("iallreduce", lambda: comm.iallreduce(mine, op.SUM),
        lambda: comm.allreduce(mine, op.SUM))
    row("igather", lambda: comm.igather(mine, root=0),
        lambda: comm.gather(mine, root=0))
    full = np.concatenate([_rank_data(k, n // size, np.float32)
                           for k in range(size)]) if r == 0 else None
    row("iscatter", lambda: comm.iscatter(full, root=0),
        lambda: comm.scatter(full, root=0))
    del full
    row("iallgather", lambda: comm.iallgather(mine),
        lambda: comm.allgather(mine))
    row("ialltoall", lambda: comm.ialltoall(mine),
        lambda: comm.alltoall(mine))
    row("ireduce_scatter", lambda: comm.ireduce_scatter(mine, op.SUM),
        lambda: comm.reduce_scatter(mine, op.SUM))
    row("ireduce_scatter_block",
        lambda: comm.ireduce_scatter_block(mine, op.SUM),
        lambda: comm.reduce_scatter_block(mine, op.SUM))
    row("iscan", lambda: comm.iscan(mine, op.SUM),
        lambda: comm.scan(mine, op.SUM))
    row("iexscan", lambda: comm.iexscan(mine, op.SUM),
        lambda: comm.exscan(mine, op.SUM))
    row("iallgatherv", lambda: comm.iallgatherv(parts[r]),
        lambda: comm.allgatherv(parts[r]))
    row("ialltoallv", lambda: comm.ialltoallv(parts),
        lambda: comm.alltoallv(parts))
    row("igatherv", lambda: comm.igatherv(parts[r], root=0),
        lambda: comm.gatherv(parts[r], root=0))
    row("iscatterv", lambda: comm.iscatterv(parts if r == 0 else None,
                                            root=0),
        lambda: comm.scatterv(parts if r == 0 else None, root=0))
    f32 = dt_mod.FLOAT32
    got_w = [np.zeros(m, np.float32) for _ in range(size)]
    want_w = [np.zeros(m, np.float32) for _ in range(size)]
    send_w = [(part, f32, m - d) for d in range(size)]
    row("ialltoallw",
        lambda: comm.ialltoallw(send_w, [(got_w[k], f32, m - r)
                                         for k in range(size)]),
        lambda: comm.alltoallw(send_w, [(want_w[k], f32, m - r)
                                        for k in range(size)]),
        lambda a, b: _same_nested(got_w, want_w))
    return rows


def _same_nested(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, list) or isinstance(b, list):
        return (isinstance(a, list) and isinstance(b, list)
                and len(a) == len(b)
                and all(_same_nested(x, y) for x, y in zip(a, b)))
    return _same(a, b)


def _per_op_us(comm, run, iters: int) -> float:
    """µs per call of ``run`` over ``iters`` calls (after one warm-up),
    the slowest rank's."""
    run()
    comm.barrier()
    t0 = time.perf_counter()
    for _ in range(iters):
        run()
    return _tmax(comm, (time.perf_counter() - t0) / iters * 1e6)


def persistent_rows(comm, mib: float, part_mib: float,
                    every_kind: bool = True) -> dict:
    """``allreduce_init`` started 16 times at ``mib`` MiB (each result
    against numpy), µs per start+wait against one-shot allreduce at
    4 KiB and ``mib`` MiB, and every other ``*_init`` once."""
    from ompi_tpu_torch.mpi import op

    size, r = comm.size, comm.rank
    n = int(mib * (1 << 20)) // 4
    data = [_rank_data(k, n, np.float32) for k in range(size)]
    total = data[0].copy()
    for k in range(1, size):
        total += data[k]
    buf = data[r].copy()
    comm.barrier()
    t0 = time.perf_counter()
    req = comm.allreduce_init(buf, op.SUM)
    bind_s = time.perf_counter() - t0
    ok = True
    starts = 16
    for k in range(starts):
        buf[...] = data[r] + np.float32(k)
        req.start()
        got = req.wait()
        ok = ok and _same(got, total + np.float32(size * k))
    out = {"bytes": n * 4, "starts": starts, "provider": req.provider,
           "algorithm": req.algorithm, "bitwise": _all(comm, ok),
           "bind_seconds_max": _tmax(comm, bind_s)}
    buf[...] = data[r]
    del data
    timing = {}
    for label, nbytes, iters in (("4KiB", 4096, 2000),
                                 (f"{mib:g}MiB", n * 4, 8)):
        x = buf[: nbytes // 4]
        q = req if nbytes == n * 4 else comm.allreduce_init(x, op.SUM)

        def start_wait():
            q.start()
            q.wait()

        timing[label] = {
            "bytes": nbytes, "iters": iters,
            "provider": q.provider, "algorithm": q.algorithm,
            "persistent_us": _per_op_us(comm, start_wait, iters),
            "oneshot_us": _per_op_us(
                comm, lambda: comm.allreduce(x, op.SUM), iters)}
        if q is not req:
            q.free()
    req.free()
    out["per_op"] = timing
    if every_kind:
        out["kinds"] = _every_init(comm, part_mib)
    return out


def _every_init(comm, part_mib: float) -> list[dict]:
    """Every other ``*_init`` kind once, against its blocking call."""
    from ompi_tpu_torch.mpi import op

    size, r = comm.size, comm.rank
    m = int(part_mib * (1 << 20)) // 4 // size * size
    x = _rank_data(r, m, np.float32)
    parts = [x[: m // size - d] for d in range(size)]
    land = np.zeros_like(x)
    cart = comm.cart_create([size], periods=[True])
    nparts = [x[: m // 2], x[m // 2:]]
    kinds = [
        ("barrier", comm.barrier_init(), lambda: None),
        ("bcast", comm.bcast_init(x if r == 0 else land, root=0),
         lambda: comm.bcast(x if r == 0 else None, root=0)),
        ("reduce", comm.reduce_init(x, op.SUM, root=0),
         lambda: comm.reduce(x, op.SUM, root=0)),
        ("allgather", comm.allgather_init(x), lambda: comm.allgather(x)),
        ("alltoall", comm.alltoall_init(x), lambda: comm.alltoall(x)),
        ("alltoallv", comm.alltoallv_init(parts),
         lambda: comm.alltoallv(parts)),
        ("reduce_scatter", comm.reduce_scatter_init(x, op.SUM),
         lambda: comm.reduce_scatter(x, op.SUM)),
        ("neighbor_alltoall", cart.neighbor_alltoall_init(nparts),
         lambda: cart.neighbor_alltoall(nparts)),
        ("neighbor_alltoallv", cart.neighbor_alltoallv_init(nparts[::-1]),
         lambda: cart.neighbor_alltoallv(nparts[::-1])),
    ]
    rows = []
    for name, q, blocking in kinds:
        comm.barrier()
        t0 = time.perf_counter()
        q.start()
        got = q.wait()
        dt = time.perf_counter() - t0
        want = blocking()
        rows.append({"kind": name, "provider": q.provider,
                     "bitwise": _all(comm, _same_nested(got, want)),
                     "seconds_max": _tmax(comm, dt)})
        q.free()
    return rows


_P2P_MODES = ("persistent", "isend_irecv", "send_recv")


def p2p_persistent_rows(comm, sizes=(8, 64 << 20)) -> list[dict]:
    """Ranks 0 ↔ 1: half round trip of send_init/recv_init against
    isend/irecv and the blocking send/recv (whose recv drains its own
    rings, the receiver-pull; a request's wait() blocks on its event);
    the other ranks only join the barriers."""
    rows = []
    peer = 1 - comm.rank
    for nbytes in sizes:
        if comm.rank > 1:
            for _ in range(len(_P2P_MODES) + 1):   # one a mode, one a size
                comm.barrier()
            continue
        x = (np.arange(nbytes, dtype=np.uint64) * 2654435761 % 251).astype(
            np.uint8)
        back = np.empty_like(x)
        blocks, reps = _plan(nbytes)
        row = {"bytes": nbytes, "blocks": blocks, "round_trips": reps}
        for mode in _P2P_MODES:
            if mode == "persistent":
                s_buf = x if comm.rank == 0 else back
                sreq = comm.send_init(s_buf, dest=peer,
                                      tag=11 if comm.rank == 0 else 12)
                rreq = comm.recv_init(back, source=peer,
                                      tag=12 if comm.rank == 0 else 11)

                def trip():
                    if comm.rank == 0:
                        rreq.start()
                        sreq.start()
                        sreq.wait()
                        rreq.wait()
                    else:
                        rreq.start()
                        rreq.wait()
                        sreq.start()
                        sreq.wait()
            elif mode == "isend_irecv":
                def trip():
                    if comm.rank == 0:
                        rr = comm.irecv(back, source=peer, tag=12)
                        comm.isend(x, dest=peer, tag=11).wait()
                        rr.wait()
                    else:
                        comm.irecv(back, source=peer, tag=11).wait()
                        comm.isend(back, dest=peer, tag=12).wait()
            else:
                def trip():
                    if comm.rank == 0:
                        comm.send(x, dest=peer, tag=11)
                        comm.recv(back, source=peer, tag=12)
                    else:
                        comm.recv(back, source=peer, tag=11)
                        comm.send(back, dest=peer, tag=12)
            comm.barrier()
            half_us, ok = [], True
            for _ in range(blocks + 1):      # the first block warms up
                t0 = time.perf_counter()
                for _ in range(reps):
                    trip()
                half_us.append((time.perf_counter() - t0) / reps / 2 * 1e6)
                if comm.rank == 0:
                    ok = ok and back.tobytes() == x.tobytes()
                    back[:] = 0
            row[mode] = {"half_rtt_us": statistics.median(half_us[1:]),
                         "half_rtt_us_blocks": half_us[1:],
                         "bitwise": ok}
        rows.append(row)
        comm.barrier()
    return rows


def partitioned_rows(comm, mib: float, partitions: int = 8,
                     iters: int = 5) -> dict:
    """Rank 0 psends ``mib`` MiB to rank 1 in ``partitions`` partitions,
    readied in a shuffled order each time; GB/s from the receiver's
    start-to-wait time (median over ``iters``)."""
    import random

    nbytes = int(mib * (1 << 20))
    out = {"bytes": nbytes, "partitions": partitions, "iters": iters}
    if comm.rank > 1:
        comm.barrier()
        return out
    base = (np.arange(nbytes, dtype=np.uint64) * 2654435761 % 251).astype(
        np.uint8)
    secs, ok, orders = [], True, []
    if comm.rank == 0:
        buf = np.zeros(nbytes, np.uint8)
        req = comm.psend_init(buf, dest=1, tag=200, partitions=partitions)
        for it in range(iters):
            np.add(base, np.uint8(it), out=buf)
            order = list(range(partitions))
            random.Random(it).shuffle(order)
            orders.append(order)
            comm.recv(source=1, tag=201)           # receiver posted
            req.start()
            for i in order:
                req.pready(i)
            req.wait()
    else:
        buf = np.zeros(nbytes, np.uint8)
        req = comm.precv_init(buf, source=0, tag=200,
                              partitions=partitions)
        for it in range(iters):
            req.start()
            t0 = time.perf_counter()
            comm.send(np.zeros(0, np.uint8), dest=0, tag=201)
            req.wait()
            secs.append(time.perf_counter() - t0)
            ok = ok and buf.tobytes() == (base + np.uint8(it)).tobytes()
    got = comm.sendrecv(np.array(secs + [float(ok)]), 1 - comm.rank,
                        source=1 - comm.rank) if comm.rank <= 1 else None
    comm.barrier()
    if comm.rank == 0:
        secs, ok = list(got[:-1]), bool(got[-1])
        med = statistics.median(secs)
        out.update(seconds=secs, seconds_median=med,
                   gb_s=nbytes / med / 1e9, bitwise=ok, wire_tag_user=200,
                   pready_orders=orders)
    return out


def topo_rows(comm, part_mib: float) -> dict:
    """A periodic 2×2 cart: the neighbor collectives, their ineighbor_*
    forms and neighbor_alltoall_init at ``part_mib`` MiB, against numpy;
    then the halo exchange of ``examples/cart_halo.py``."""
    from ompi_tpu_torch.examples.cart_halo import halo_exchange

    m = int(part_mib * (1 << 20)) // 4
    cart = comm.cart_create([2, 2], periods=[True, True])
    me = cart.rank

    def part(rank, j, size=m):
        return _rank_data(rank * 16 + j, size, np.float32)

    srcs, _ = cart.topo.neighbors(me)
    mine = part(me, 15)
    parts = [part(me, j) for j in range(4)]
    vparts = [part(me, j, m - 1000 * j) for j in range(4)]
    # a cart block j lands in the receiver's slot j ^ 1 (same dim, the
    # other side)
    want_ag = [part(s, 15) for s in srcs]
    want_a2a = [part(s, i ^ 1) for i, s in enumerate(srcs)]
    want_a2av = [part(s, i ^ 1, m - 1000 * (i ^ 1))
                 for i, s in enumerate(srcs)]
    rows = {}

    def check(name, fn, want):
        comm.barrier()
        t0 = time.perf_counter()
        got = fn()
        dt = time.perf_counter() - t0
        rows[name] = {"bitwise": _all(comm, _same_nested(got, want)),
                      "seconds_max": _tmax(comm, dt)}

    check("neighbor_allgather", lambda: cart.neighbor_allgather(mine),
          want_ag)
    check("neighbor_alltoall", lambda: cart.neighbor_alltoall(parts),
          want_a2a)
    check("neighbor_alltoallv", lambda: cart.neighbor_alltoallv(vparts),
          want_a2av)
    check("ineighbor_allgather",
          lambda: cart.ineighbor_allgather(mine).wait(), want_ag)
    check("ineighbor_alltoall",
          lambda: cart.ineighbor_alltoall(parts).wait(), want_a2a)
    check("ineighbor_alltoallv",
          lambda: cart.ineighbor_alltoallv(vparts).wait(), want_a2av)
    init = cart.neighbor_alltoall_init(parts)

    def started():
        init.start()
        return init.wait()

    check("neighbor_alltoall_init", started, want_a2a)
    rows["neighbor_alltoall_init"]["provider"] = init.provider
    halo = halo_exchange(comm)
    return {"dims": [2, 2], "periods": [True, True], "bytes": m * 4,
            "calls": rows,
            "halo_faces": int(comm.allgather(
                np.array([halo["faces"]])).sum())}


def overlap(comm, mib: float, gemms: int = 60, dim: int = 8192) -> dict:
    """(--gpu) iallreduce of host memory overlapped with bf16 GEMMs on
    this rank's card, and the refusals of a CUDA tensor."""
    import torch

    from ompi_tpu_torch.core.buffer import BufferLocationError
    from ompi_tpu_torch.examples.device_allreduce import _dtoh_copies
    from ompi_tpu_torch.mpi import op

    size, r = comm.size, comm.rank
    n = int(mib * (1 << 20)) // 4
    data = [_rank_data(k, n, np.float32) for k in range(size)]
    total = data[0].copy()
    for k in range(1, size):
        total += data[k]
    mine = data[r]
    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(device=dev).manual_seed(7 + r)
    a = torch.randn(dim, dim, device=dev, dtype=torch.bfloat16, generator=g)
    b = torch.randn(dim, dim, device=dev, dtype=torch.bfloat16, generator=g)
    c = torch.empty(dim, dim, device=dev, dtype=torch.bfloat16)

    def gemm_loop(req=None) -> int:
        tests = 0
        for _ in range(gemms):
            torch.mm(a, b, out=c)
            if req is not None:
                req.test()
                tests += 1
        return tests

    gemm_loop()                           # warm: cuBLAS's first call
    comm.iallreduce(mine, op.SUM).wait()  # warm: the schedule's first run
    torch.cuda.synchronize()
    rows = {}
    comm.barrier()
    t0 = time.perf_counter()
    got = comm.iallreduce(mine, op.SUM).wait()
    rows["iallreduce_alone_s"] = time.perf_counter() - t0
    ok = _same(got, total)
    comm.barrier()
    t0 = time.perf_counter()
    gemm_loop()
    torch.cuda.synchronize()
    rows["gemm_alone_s"] = time.perf_counter() - t0
    comm.barrier()
    t0 = time.perf_counter()
    req = comm.iallreduce(mine, op.SUM)
    tests = gemm_loop(req)
    t_loop = time.perf_counter() - t0
    got = req.wait()
    t_wait = time.perf_counter() - t0
    torch.cuda.synchronize()
    rows["both_s"] = time.perf_counter() - t0
    rows["both_launch_loop_s"] = t_loop
    rows["both_wait_s"] = t_wait
    rows["tests_between_launches"] = tests
    ok = ok and _same(got, total)
    flops = 2.0 * dim ** 3 * gemms
    rows["gemm_tflops_alone"] = flops / rows["gemm_alone_s"] / 1e12
    del data

    # the refusals: no device-to-host copy in the window but the control
    t = torch.ones(4 * size, device=dev)
    cart = comm.cart_create([size], periods=[True])
    errors = {}

    def refuse():
        for name, call in (
                ("iallreduce", lambda: comm.iallreduce(t)),
                ("allreduce_init", lambda: comm.allreduce_init(t)),
                ("psend_init", lambda: comm.psend_init(
                    t, dest=(r + 1) % size, tag=5, partitions=2)),
                ("neighbor_alltoall",
                 lambda: cart.neighbor_alltoall([t, t]))):
            try:
                call()
                errors[name] = None
            except BufferLocationError as e:
                errors[name] = str(e)

    _, copies = _dtoh_copies(refuse, t)
    per_rank = comm.allgather(np.array(
        [rows["iallreduce_alone_s"], rows["gemm_alone_s"], rows["both_s"],
         rows["both_wait_s"], float(ok)]))
    return {"rank": r, "bytes": n * 4, "gemms": gemms, "gemm_dim": dim,
            "gemm_dtype": "bfloat16", "card": torch.cuda.get_device_name(),
            **rows, "bitwise": bool(per_rank[:, 4].all()),
            "per_rank": per_rank[:, :4].tolist(),
            "refusals": errors, "dtoh_copies_in_refusals": copies}


def _slice_main(args) -> int:
    import ompi_tpu_torch

    comm = ompi_tpu_torch.init()
    res = {"ranks": comm.size, "transport": comm.pml.endpoint.route(
        (comm.rank + 1) % comm.size)}
    t0 = time.perf_counter()
    if args.overlap:
        res["overlap"] = overlap(comm, args.mib)
        ok = (res["overlap"]["bitwise"]
              and res["overlap"]["dtoh_copies_in_refusals"] == 0
              and all(res["overlap"]["refusals"].values()))
        print("host_bench " + json.dumps(res), flush=True)
    elif args.nbc == "persistent":
        res["persistent"] = persistent_rows(comm, args.mib, args.part_mib,
                                            every_kind=False)
        ok = res["persistent"]["bitwise"]
    else:
        steps = (("nbc", lambda: nbc_calls(comm, args.mib, args.part_mib)),
                 ("persistent", lambda: persistent_rows(
                     comm, args.mib, args.part_mib)),
                 ("p2p_persistent", lambda: p2p_persistent_rows(
                     comm, (8, int(args.mib * (1 << 20))))),
                 ("partitioned", lambda: partitioned_rows(comm, args.mib)),
                 ("topo", lambda: topo_rows(comm, args.part_mib)))
        res["seconds"] = {}
        for name, fn in steps:
            t = time.perf_counter()
            res[name] = fn()
            res["seconds"][name] = time.perf_counter() - t
        ok = (all(c["bitwise"] for c in res["nbc"])
              and res["persistent"]["bitwise"]
              and all(k["bitwise"] for k in res["persistent"]["kinds"])
              and all(c["bitwise"] for c in res["topo"]["calls"].values()))
        if comm.rank == 0:
            ok = ok and res["partitioned"]["bitwise"] and all(
                row[m]["bitwise"] for row in res["p2p_persistent"]
                for m in _P2P_MODES)
    res["wall_s"] = time.perf_counter() - t0
    if comm.rank == 0 and not args.overlap:
        print("host_bench " + json.dumps(res), flush=True)
    ompi_tpu_torch.finalize()
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
