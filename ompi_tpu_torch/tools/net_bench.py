"""Inter-node transport microbench: native tcp plane vs python plane.

Pingpong latency and small-message rate over real loopback sockets
between two ranks forced to ``--mca btl self,tcp`` (no shm, no proc
shortcut — the same frames a cross-host pair would exchange, minus the
wire).  Both planes run in the SAME world, alternating per rep: every
rank flips ``btl_tcp_native`` between barriers, so the two
configurations share scheduling fate (the var is read per call — the
sockets never change, only who drains them).

Two world shapes:

- default: **loopback fake-host worlds** — ``tpurun --plm sim --hosts
  2`` spawns each rank as its own process on a distinct simulated host
  (shm refuses across the OMPI_TPU_FAKE_HOST boundary), so every rank
  owns a full interpreter.  This is the deployment shape the native
  plane exists for: the GIL the native writer/poller release belongs
  to application code, not to the other rank's transport.
- ``--inproc``: the two ranks are threads in one interpreter (the test
  harness shape).  Useful as a floor/contrast: here both planes fight
  over ONE GIL and the native plane's release only helps the peer.

Per row: p50/p99 of per-op RTT over a synchronized loop, best-of-reps
per mode.  The msgrate burst additionally captures the
``btl_tcp_native_batched_frames_total / btl_tcp_native_writes_total``
delta ratio — >1 means the submission ring actually coalesced frames
into batched writev calls, the whole point of the native writer.

Rows append to ``build/ompi_tpu_torch/bench/NET_BENCH.jsonl`` (the
pack_bench convention; ``--out`` picks another file).  The world is the
port's launcher's; neither the tool nor its ranks import torch.

Run: ``python -m ompi_tpu_torch.tools.net_bench [--quick] [--inproc]
[--guard|--guard-kill]``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

from ompi_tpu_torch.core.config import var_registry
from ompi_tpu_torch.mpi import trace

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
#: where the rows go by default (gitignored; never the repo's
#: reference ``*_BENCH.jsonl``)
OUT_DIR = os.path.join(REPO, "build", "ompi_tpu_torch", "bench")
_OUT = os.path.join(OUT_DIR, "NET_BENCH.jsonl")


# ---------------------------------------------------------------- bodies
# Run identically under both world shapes.  Every rank flips the var:
# in a fake-host world each process owns its own registry; in-process
# the two threads just write the same value twice.

def _pp_samples(comm, nbytes: int, iters: int, reps: int):
    """Pingpong RTT samples per mode; returns the sample dict on rank 0,
    None elsewhere."""
    samples: dict[bool, list[list[float]]] = {True: [], False: []}
    x = np.zeros(max(nbytes, 1), dtype=np.uint8)[:nbytes]
    if comm.rank == 0 and nbytes:
        x[:] = 42
    for _rep in range(reps):
        for native in (True, False):
            var_registry.set("btl_tcp_native", native)
            comm.barrier()
            # warm the route/plane outside the timed loop
            if comm.rank == 0:
                comm.send(x, dest=1, tag=1)
                comm.recv(x, source=1, tag=2)
            else:
                comm.recv(x, source=0, tag=1)
                comm.send(x, dest=0, tag=2)
            ts = []
            for _ in range(iters):
                if comm.rank == 0:
                    t0 = time.perf_counter()
                    comm.send(x, dest=1, tag=1)
                    comm.recv(x, source=1, tag=2)
                    ts.append(time.perf_counter() - t0)
                else:
                    comm.recv(x, source=0, tag=1)
                    comm.send(x, dest=0, tag=2)
            if comm.rank == 0:
                samples[native].append(ts)
    comm.barrier()
    return samples if comm.rank == 0 else None


def _mr_samples(comm, nbytes: int, burst: int, reps: int):
    """Msgrate burst: rank 0 isends `burst` frames, rank 1 pre-posts the
    recvs and acks; returns (rates, native counter deltas) on rank 0."""
    rates: dict[bool, list[float]] = {True: [], False: []}
    deltas: list[dict] = []
    x = np.zeros(nbytes, dtype=np.uint8)
    for _rep in range(reps):
        for native in (True, False):
            var_registry.set("btl_tcp_native", native)
            comm.barrier()
            if comm.rank == 0:
                before = {k: trace.counters[k] for k in
                          ("btl_tcp_native_writes_total",
                           "btl_tcp_native_batched_frames_total")}
                t0 = time.perf_counter()
                reqs = [comm.isend(x, dest=1, tag=i % 8)
                        for i in range(burst)]
                for r in reqs:
                    r.wait()
                # the far side acks completion via a frame so the
                # rate includes delivery, not just enqueue
                comm.recv(source=1, tag=99)
                dt = time.perf_counter() - t0
                rates[native].append(burst / dt)
                if native:
                    deltas.append({
                        k: trace.counters[k] - v
                        for k, v in before.items()})
            else:
                reqs = [comm.irecv(np.empty(nbytes, np.uint8),
                                   source=0, tag=i % 8)
                        for i in range(burst)]
                for r in reqs:
                    r.wait()
                comm.send(np.zeros(1, np.uint8), dest=0, tag=99)
    comm.barrier()
    return (rates, deltas) if comm.rank == 0 else None


# ------------------------------------------------------------------- rows

def _pp_rows(samples, nbytes: int, iters: int, reps: int,
             world: str) -> list[dict]:
    rows = []
    for native in (True, False):
        best = min(samples[native], key=statistics.median)
        rows.append({
            "bench": "tcp_pingpong", "world": world,
            "mode": "native" if native else "python",
            "payload_bytes": nbytes,
            "iters": iters, "reps": reps,
            "p50_us": round(statistics.median(best) * 1e6, 1),
            "p99_us": round(
                sorted(best)[max(0, int(len(best) * 0.99) - 1)] * 1e6, 1),
        })
    return rows


def _mr_rows(rates, deltas, nbytes: int, burst: int, reps: int,
             world: str) -> list[dict]:
    writes = sum(d["btl_tcp_native_writes_total"] for d in deltas)
    frames = sum(d["btl_tcp_native_batched_frames_total"] for d in deltas)
    rows = []
    for native in (True, False):
        rows.append({
            "bench": "tcp_msgrate", "world": world,
            "mode": "native" if native else "python",
            "payload_bytes": nbytes, "burst": burst, "reps": reps,
            "msgs_per_s": round(max(rates[native])),
            **({"writes": writes, "batched_frames": frames,
                "batch_ratio": round(frames / writes, 2) if writes else 0.0}
               if native else {}),
        })
    return rows


# ----------------------------------------------------- fake-host worlds

def _child_main(args) -> None:
    """Rank program inside a tpurun fake-host world: run the body, rank
    0 prints one NBDATA json line the parent parses out of the IOF."""
    import ompi_tpu_torch

    comm = ompi_tpu_torch.init()
    if args.child == "pingpong":
        s = _pp_samples(comm, args.nbytes, args.iters, args.reps)
        data = s and {"native": s[True], "python": s[False]}
    else:
        r = _mr_samples(comm, args.nbytes, args.burst, args.reps)
        data = r and {"rates": {"native": r[0][True], "python": r[0][False]},
                      "deltas": r[1]}
    if data is not None:
        print("NBDATA " + json.dumps(data), flush=True)
    ompi_tpu_torch.finalize()


def _fakehost_world(child: str, timeout: float = 600.0, **kw) -> dict:
    """Spawn one 2-rank / 2-fake-host world via tpurun and return rank
    0's NBDATA payload."""
    env = dict(os.environ)
    env.pop("OMPI_TPU_RANK", None)
    cmd = [sys.executable, "-m", "ompi_tpu_torch.tools.tpurun",
           "-np", "2", "--plm", "sim", "--hosts", "2",
           "--mca", "btl", "self,tcp", "--",
           sys.executable, "-m", "ompi_tpu_torch.tools.net_bench",
           "--child", child]
    for k, v in kw.items():
        cmd += [f"--{k}", str(v)]
    r = subprocess.run(cmd, capture_output=True, text=True,
                       timeout=timeout, env=env, cwd=REPO)
    if r.returncode != 0:
        raise RuntimeError(
            f"fake-host world failed rc={r.returncode}:\n"
            f"{r.stdout[-2000:]}\n{r.stderr[-2000:]}")
    for line in r.stdout.splitlines():
        if "NBDATA " in line:  # IOF may prefix a [job,rank] tag
            return json.loads(line.split("NBDATA ", 1)[1])
    raise RuntimeError("no NBDATA line in world output:\n"
                       + r.stdout[-2000:])


def bench_pingpong_fakehost(nbytes: int, iters: int, reps: int) -> list[dict]:
    d = _fakehost_world("pingpong", nbytes=nbytes, iters=iters, reps=reps)
    return _pp_rows({True: d["native"], False: d["python"]},
                    nbytes, iters, reps, world="fakehost")


def bench_msgrate_fakehost(nbytes: int, burst: int, reps: int) -> list[dict]:
    d = _fakehost_world("msgrate", nbytes=nbytes, burst=burst, reps=reps)
    return _mr_rows({True: d["rates"]["native"], False: d["rates"]["python"]},
                    d["deltas"], nbytes, burst, reps, world="fakehost")


# ------------------------------------------------------ in-process world

def _run_world(n: int, fn, timeout: float = 600.0) -> list:
    """In-process n-rank world (tests/torch_host_harness.run_ranks,
    inlined so the tool has no test-tree import)."""
    from ompi_tpu_torch.mpi.comm import Communicator
    from ompi_tpu_torch.mpi.group import Group
    from ompi_tpu_torch.mpi.pml import PmlOb1

    pmls = [PmlOb1(r) for r in range(n)]
    addrs = {r: p.address for r, p in enumerate(pmls)}
    for p in pmls:
        p.set_peers(addrs)
    comms = [Communicator(Group(range(n)), cid=0, pml=pmls[r],
                          my_world_rank=r, name=f"netbench{n}")
             for r in range(n)]
    results: list = [None] * n
    errors: list = []

    def runner(rank: int) -> None:
        try:
            results[rank] = fn(comms[rank])
        except BaseException as e:  # noqa: BLE001
            errors.append((rank, e))

    threads = [threading.Thread(target=runner, args=(r,), daemon=True)
               for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    try:
        if any(t.is_alive() for t in threads):
            raise TimeoutError(f"bench ranks hung (errors: {errors})")
        if errors:
            raise errors[0][1]
    finally:
        if not any(t.is_alive() for t in threads):
            for p in pmls:
                p.close()
    return results


def bench_pingpong_inproc(nbytes: int, iters: int, reps: int) -> list[dict]:
    res = _run_world(2, lambda c: _pp_samples(c, nbytes, iters, reps))
    return _pp_rows(res[0], nbytes, iters, reps, world="inproc")


def bench_msgrate_inproc(nbytes: int, burst: int, reps: int) -> list[dict]:
    rates, deltas = _run_world(
        2, lambda c: _mr_samples(c, nbytes, burst, reps))[0]
    return _mr_rows(rates, deltas, nbytes, burst, reps, world="inproc")


def main() -> None:
    ap = argparse.ArgumentParser(
        description="native-vs-python tcp plane latency/msgrate")
    ap.add_argument("--quick", action="store_true",
                    help="CI smoke sizing: fewer sizes, fewer iters")
    ap.add_argument("--inproc", action="store_true",
                    help="two ranks as threads in ONE interpreter "
                    "(shared GIL) instead of fake-host processes")
    ap.add_argument("--guard", action="store_true",
                    help="preflight: refuse to bench when hours-old "
                    "PPID-1 orphaned ompi_tpu processes poison the box")
    ap.add_argument("--guard-kill", action="store_true",
                    help="like --guard but SIGKILL the orphans and "
                    "proceed")
    ap.add_argument("--out", default=_OUT)
    # internal: rank-program mode inside a tpurun fake-host world
    ap.add_argument("--child", choices=("pingpong", "msgrate"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--nbytes", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--iters", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--reps", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--burst", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args()

    if args.child:
        _child_main(args)
        return

    if args.guard or args.guard_kill:
        from ompi_tpu_torch.tools import killorphans

        if not killorphans.preflight("net_bench", kill=args.guard_kill):
            sys.exit(2)

    if args.quick:
        sizes = [1 << 10, 64 << 10]
        iters, reps, burst = 100, 2, 500
    else:
        sizes = [1 << 10, 64 << 10, 1 << 20]
        iters, reps, burst = 300, 3, 2000

    world = "inproc" if args.inproc else "fakehost"
    pingpong = bench_pingpong_inproc if args.inproc else \
        bench_pingpong_fakehost
    msgrate = bench_msgrate_inproc if args.inproc else bench_msgrate_fakehost

    if args.inproc:
        # registers the btl framework-selection var as a side effect
        from ompi_tpu_torch.mpi import pml as _pml  # noqa: F401

        var_registry.set("btl_", "self,tcp")
    rows: list[dict] = []
    try:
        for nbytes in sizes:
            it = max(20, iters // 10) if nbytes >= (1 << 20) else iters
            rows += pingpong(nbytes, it, reps)
        rows += msgrate(512, burst, reps)
    finally:
        if args.inproc:
            var_registry.set("btl_", "")
            var_registry.set("btl_tcp_native", True)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a", encoding="utf-8") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    print(f"{len(rows)} rows -> {args.out}")

    by = {(r["bench"], r["payload_bytes"], r["mode"]): r for r in rows}
    wins = 0
    for nbytes in sizes:
        nat = by[("tcp_pingpong", nbytes, "native")]
        py = by[("tcp_pingpong", nbytes, "python")]
        speedup = py["p50_us"] / nat["p50_us"] if nat["p50_us"] else 0.0
        wins += speedup >= 1.5
        print(f"pingpong {nbytes:>8}B: native {nat['p50_us']:>7}us  "
              f"python {py['p50_us']:>7}us  ({speedup:.2f}x)")
    nat = by[("tcp_msgrate", 512, "native")]
    py = by[("tcp_msgrate", 512, "python")]
    print(f"msgrate 512B x{nat['burst']}: native {nat['msgs_per_s']} "
          f"msg/s  python {py['msgs_per_s']} msg/s  "
          f"batch_ratio {nat.get('batch_ratio')}")
    ok = wins >= 2 and (nat.get("batch_ratio") or 0) > 1
    print(f"acceptance ({world}): {'PASS' if ok else 'FAIL'} "
          f"(pingpong >=1.5x at {wins} rows; batching "
          f"{nat.get('batch_ratio')})")


if __name__ == "__main__":
    main()
