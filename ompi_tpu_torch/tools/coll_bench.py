"""On-node collective microbench: coll/shm arena vs coll/host p2p.

Latency-vs-size for allreduce / bcast / barrier on an in-process
multi-rank world (the port's test harness topology, ``tests/torch_host_harness``:
one PML per rank,
real matching, real shm-BTL rings for the host path — the same rig the
58 µs/hop scheduler-floor number was measured on), run twice per
config: once with the coll/shm arena enabled and once forced to
coll/host (``coll_shm_enable 0``).  The per-op number is wall time of
a synchronized loop divided by iterations, best of ``--reps`` runs —
the two-point/best-of discipline bench.py uses, collective form.

Rows append to ``build/ompi_tpu_torch/bench/COLL_BENCH.jsonl`` (the
pack_bench convention — append-only, one JSON object per line; ``--out``
picks another file) so the shm-vs-host crossover table stays
reproducible.  The host plane imports no torch, and neither does the
tool.

Run: ``python -m ompi_tpu_torch.tools.coll_bench [--quick] [--ranks 4]``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

import numpy as np

from ompi_tpu_torch.core.config import var_registry
from ompi_tpu_torch.mpi.coll import shm as _shm  # noqa: F401 — register vars
from ompi_tpu_torch.mpi.comm import Communicator
from ompi_tpu_torch.mpi.group import Group
from ompi_tpu_torch.mpi.pml import PmlOb1

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
#: where the rows go by default (gitignored; never the repo's
#: reference ``*_BENCH.jsonl``)
OUT_DIR = os.path.join(REPO, "build", "ompi_tpu_torch", "bench")
_OUT = os.path.join(OUT_DIR, "COLL_BENCH.jsonl")


def _hist_percentiles(before: dict, after: dict, base: str,
                      label: str = "") -> tuple[float, float]:
    """(p50 µs, p99 µs) of one histogram family's delta between two
    ``trace.hists_snapshot()`` snapshots, summed over the series whose
    key carries ``label`` (e.g. ``slot="allreduce"``) — the per-size-row
    tail the mean alone hides."""
    from ompi_tpu_torch.mpi import trace

    counts = [0] * trace.HIST_NBUCKETS
    for key, vec in after.items():
        if not (key == base or key.startswith(base + "{")):
            continue
        if label and label not in key:
            continue
        b = before.get(key)
        for i in range(trace.HIST_NBUCKETS):
            counts[i] += vec[i] - (b[i] if b else 0)
    return (round(trace.hist_quantile_ns(counts, 0.50) / 1e3, 1),
            round(trace.hist_quantile_ns(counts, 0.99) / 1e3, 1))


def _run_world(n: int, fn, timeout: float = 300.0) -> list:
    """In-process n-rank world (tests/torch_host_harness.run_ranks,
    inlined so the tool has no test-tree import)."""
    pmls = [PmlOb1(r) for r in range(n)]
    addrs = {r: p.address for r, p in enumerate(pmls)}
    for p in pmls:
        p.set_peers(addrs)
    comms = [Communicator(Group(range(n)), cid=0, pml=pmls[r],
                          my_world_rank=r, name=f"bench{n}")
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


def _make_x(comm, coll: str, nbytes: int):
    """The per-rank send buffer for one size row.  ``payload_bytes``
    is the TOTAL sendbuf (for alltoall that is p blocks of nbytes/p —
    the MoE-dispatch accounting, where the row size is what one rank
    ships, not what one peer receives)."""
    if not nbytes:
        return None
    if coll == "alltoall":
        per = max(nbytes // 8 // comm.size, 1)
        return (np.arange(per * comm.size, dtype=np.float64)
                .reshape(comm.size, per) + comm.rank)
    return np.arange(max(nbytes // 8, 1), dtype=np.float64) + comm.rank


def _coll_op(comm, coll: str, x, i: int) -> None:
    if coll == "allreduce":
        comm.allreduce(x)
    elif coll == "bcast":
        # rotating root (the IMB discipline): iteration i's root
        # was a receiver in iteration i-1, so a fixed root can't
        # run ahead enqueueing asynchronous sends — the loop
        # measures per-op completion, not enqueue throughput
        root = i % comm.size
        comm.bcast(x if comm.rank == root else None, root=root)
    elif coll == "alltoall":
        comm.alltoall(x)
    elif coll == "reduce_scatter":
        comm.reduce_scatter(x)
    else:
        comm.barrier()


def _time_coll(n: int, coll: str, nbytes: int, iters: int,
               reps: int) -> float:
    """Per-op µs: synchronized loop wall time / iters, best of reps."""

    def body(comm):
        x = _make_x(comm, coll, nbytes)

        def one(i: int) -> None:
            _coll_op(comm, coll, x, i)

        best = float("inf")
        comm.barrier()                       # warm transports + arena
        one(0)
        for _ in range(reps):
            comm.barrier()
            t0 = time.perf_counter()
            for i in range(iters):
                one(i)
            best = min(best, time.perf_counter() - t0)
        return best / iters * 1e6

    # the slowest rank's best defines the collective's latency
    return max(_run_world(n, body))


def _time_coll_pair(n: int, coll: str, nbytes: int, iters: int,
                    reps: int) -> tuple[float, float, str]:
    """(persistent µs, one-shot µs, provider): BOTH modes timed in the
    same rank world, alternating per rep, so they share scheduling
    fate — on an oversubscribed box the rank threads phase-lock into
    per-run patterns that would otherwise dominate a between-run
    comparison.  Persistent = Start/wait over ONE bound plan (bind
    outside the timed loop); one-shot = the dispatch path, fixed root
    0 both sides (the bound plan pins one root, and the one-shot
    arena bcast root waits all readers per op anyway)."""
    elems = max(nbytes // 8, 1) if nbytes else 0

    def body(comm):
        if nbytes:
            x = np.arange(elems, dtype=np.float64) + comm.rank
        if coll == "allreduce":
            req = comm.allreduce_init(x)
        elif coll == "bcast":
            req = comm.bcast_init(
                x if comm.rank == 0 else np.empty_like(x), root=0)
        else:
            req = comm.barrier_init()

        def one_persistent() -> None:
            req.start()
            req.wait()

        def one_dispatch() -> None:
            if coll == "allreduce":
                comm.allreduce(x)
            elif coll == "bcast":
                comm.bcast(x if comm.rank == 0 else None, root=0)
            else:
                comm.barrier()

        comm.barrier()                       # warm transports + slots
        one_persistent()
        one_dispatch()
        best_p = best_o = float("inf")
        for _ in range(reps):
            for fn, which in ((one_persistent, "p"),
                              (one_dispatch, "o")):
                comm.barrier()
                t0 = time.perf_counter()
                for _i in range(iters):
                    fn()
                dt = time.perf_counter() - t0
                if which == "p":
                    best_p = min(best_p, dt)
                else:
                    best_o = min(best_o, dt)
        return best_p / iters * 1e6, best_o / iters * 1e6, req.provider

    results = _run_world(n, body)
    return (max(r[0] for r in results), max(r[1] for r in results),
            results[0][2])


def bench_persistent_config(n: int, coll: str, nbytes: int, iters: int,
                            reps: int, quick: bool) -> list[dict]:
    """One size row pair: bound-plan Start steady state vs per-op
    dispatch (fixed root both sides), plus the bind/start pvar
    accounting the acceptance gate reads."""
    from ompi_tpu_torch.mpi import trace

    b0 = trace.counters["coll_persistent_binds_total"]
    s0 = trace.counters["coll_persistent_starts_total"]
    h0 = trace.hists_snapshot()
    p_us, o_us, provider = _time_coll_pair(n, coll, nbytes, iters, reps)
    h1 = trace.hists_snapshot()
    # per-mode tails: persistent Starts land in coll_pstart_ns, the
    # one-shot dispatch path in coll_dispatch_ns
    pcts = {
        "persistent": _hist_percentiles(h0, h1, "coll_pstart_ns",
                                        label=f'kind="{coll}"'),
        "oneshot": _hist_percentiles(h0, h1, "coll_dispatch_ns",
                                     label=f'slot="{coll}"'),
    }
    # in-process ranks share the process counters: normalize per rank
    binds_pr = (trace.counters["coll_persistent_binds_total"] - b0) / n
    starts_pr = (trace.counters["coll_persistent_starts_total"] - s0) / n
    speedup = o_us / p_us if p_us else float("inf")
    rows = []
    for mode, us in (("persistent", p_us), ("oneshot", o_us)):
        rows.append({
            "p50_us": pcts[mode][0],
            "p99_us": pcts[mode][1],
            "bench": "coll_bench",
            "coll": coll,
            "ranks": n,
            "payload_bytes": nbytes,
            "component": provider if mode == "persistent" else "dispatch",
            "mode": mode,
            "per_op_us": round(us, 2),
            "persistent_speedup": round(speedup, 2),
            "binds_per_rank": binds_pr,
            "starts_per_rank": starts_pr,
            "iters": iters,
            "reps": reps,
            "n_cores": os.cpu_count(),
            "quick": quick,
            "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        })
    print(f"{coll:>9} {nbytes:>9}B x{n}: Start {p_us:9.1f}us "
          f"(p99 {pcts['persistent'][1]:.0f})  "
          f"per-op {o_us:9.1f}us (p99 {pcts['oneshot'][1]:.0f})  "
          f"({speedup:.2f}x)  [{provider}: binds={binds_pr:.0f} "
          f"starts={starts_pr:.0f}]")
    return rows


def _time_coll_native_pair(n: int, coll: str, nbytes: int, iters: int,
                           reps: int) -> tuple[float, float]:
    """(native µs, python µs): the SAME arena path with the native
    executor on vs off, alternating per rep in the SAME rank world
    (shared fate — the alternation matters doubly here because the
    native side's whole point is scheduler behavior).
    Rank 0 flips ``coll_shm_native`` between barriers; the arena reads
    it per call."""

    def body(comm):
        x = _make_x(comm, coll, nbytes)

        def one(i: int) -> None:
            _coll_op(comm, coll, x, i)

        best = {"nat": float("inf"), "py": float("inf")}
        comm.barrier()
        one(0)
        for _ in range(reps):
            for mode, native in (("nat", True), ("py", False)):
                comm.barrier()
                if comm.rank == 0:
                    var_registry.set("coll_shm_native", native)
                comm.barrier()   # everyone sees the flip before timing
                t0 = time.perf_counter()
                for i in range(iters):
                    one(i)
                best[mode] = min(best[mode],
                                 time.perf_counter() - t0)
        if comm.rank == 0:
            var_registry.set("coll_shm_native", True)
        return best["nat"] / iters * 1e6, best["py"] / iters * 1e6

    results = _run_world(n, body)
    return (max(r[0] for r in results), max(r[1] for r in results))


def bench_native_config(n: int, coll: str, nbytes: int, iters: int,
                        reps: int, quick: bool) -> list[dict]:
    """One size row pair: native arena executor vs the python arena
    path (the GIL-free data plane's acceptance comparison)."""
    nat_us, py_us = _time_coll_native_pair(n, coll, nbytes, iters, reps)
    speedup = py_us / nat_us if nat_us else float("inf")
    rows = []
    for mode, us in (("native", nat_us), ("python", py_us)):
        rows.append({
            "bench": "coll_bench",
            "coll": coll,
            "ranks": n,
            "payload_bytes": nbytes,
            "component": "shm",
            "mode": mode,
            "per_op_us": round(us, 2),
            "native_speedup": round(speedup, 2),
            "iters": iters,
            "reps": reps,
            "n_cores": os.cpu_count(),
            "quick": quick,
            "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        })
    print(f"{coll:>9} {nbytes:>9}B x{n}: native {nat_us:9.1f}us  "
          f"python {py_us:9.1f}us  ({speedup:.2f}x)")
    return rows


def _time_segpar_pair(n: int, nbytes: int, iters: int,
                      reps: int) -> tuple[float, float]:
    """(segment_parallel µs, root_fold µs) for a persistent arena
    allreduce — BOTH plans bound in the same world, alternated per
    rep (shared fate)."""
    elems = max(nbytes // 8, 1)

    def body(comm):
        x = np.arange(elems, dtype=np.float64) + comm.rank
        if comm.rank == 0:
            var_registry.set("coll_shm_allreduce_algorithm",
                             "root_fold")
        comm.barrier()
        req_root = comm.allreduce_init(x)
        if comm.rank == 0:
            var_registry.set("coll_shm_allreduce_algorithm",
                             "segment_parallel")
        comm.barrier()
        req_seg = comm.allreduce_init(x)
        if comm.rank == 0:
            var_registry.set("coll_shm_allreduce_algorithm", "")
        assert req_root.algorithm == "root_fold", req_root.algorithm
        assert req_seg.algorithm == "segment_parallel", req_seg.algorithm
        best = {"root": float("inf"), "seg": float("inf")}
        for req in (req_root, req_seg):
            req.start()
            req.wait()
        for _ in range(reps):
            for mode, req in (("root", req_root), ("seg", req_seg)):
                comm.barrier()
                t0 = time.perf_counter()
                for _i in range(iters):
                    req.start()
                    req.wait()
                best[mode] = min(best[mode],
                                 time.perf_counter() - t0)
        req_root.free()
        req_seg.free()
        return best["seg"] / iters * 1e6, best["root"] / iters * 1e6

    results = _run_world(n, body)
    return (max(r[0] for r in results), max(r[1] for r in results))


def bench_segpar_config(n: int, nbytes: int, iters: int, reps: int,
                        quick: bool) -> list[dict]:
    """One size row pair: cooperative segment-parallel allreduce vs
    the single-rank root fold over bound persistent plans."""
    seg_us, root_us = _time_segpar_pair(n, nbytes, iters, reps)
    speedup = root_us / seg_us if seg_us else float("inf")
    rows = []
    for mode, us in (("segment_parallel", seg_us),
                     ("root_fold", root_us)):
        rows.append({
            "bench": "coll_bench",
            "coll": "allreduce",
            "ranks": n,
            "payload_bytes": nbytes,
            "component": "shm-persistent",
            "mode": mode,
            "per_op_us": round(us, 2),
            "segpar_speedup": round(speedup, 2),
            "iters": iters,
            "reps": reps,
            "n_cores": os.cpu_count(),
            "quick": quick,
            "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        })
    print(f"allreduce {nbytes:>9}B x{n}: segpar {seg_us:9.1f}us  "
          f"root_fold {root_us:9.1f}us  ({speedup:.2f}x)")
    return rows


def _time_neighbor_pair(n: int, nbytes: int, iters: int,
                        reps: int) -> tuple[float, float]:
    """(persistent µs, one-shot µs) for a 2-D periodic halo exchange
    (neighbor_alltoall on a dims_create cart, one ``nbytes`` face per
    edge) — BOTH modes in the same rank world, alternating per rep
    (shared fate), the stencil-loop steady state the persistent
    neighbor plan exists for."""
    per = max(nbytes // 8, 1)

    def body(comm):
        from ompi_tpu_torch.mpi import topo

        dims = topo.dims_create(n, 2)
        cart = topo.cart_create(comm, dims, periods=[True, True])
        parts = [np.arange(per, dtype=np.float64) + cart.rank
                 for _ in range(2 * cart.topo.ndims)]
        req = cart.neighbor_alltoall_init(parts)
        best = {"p": float("inf"), "o": float("inf")}
        cart.barrier()
        req.start()
        req.wait()
        cart.neighbor_alltoall(parts)
        for _ in range(reps):
            for which in ("p", "o"):
                cart.barrier()
                t0 = time.perf_counter()
                for _i in range(iters):
                    if which == "p":
                        req.start()
                        req.wait()
                    else:
                        cart.neighbor_alltoall(parts)
                best[which] = min(best[which],
                                  time.perf_counter() - t0)
        req.free()
        return best["p"] / iters * 1e6, best["o"] / iters * 1e6

    results = _run_world(n, body)
    return (max(r[0] for r in results), max(r[1] for r in results))


def bench_neighbor_config(n: int, nbytes: int, iters: int, reps: int,
                          quick: bool) -> list[dict]:
    """One halo size row pair: persistent neighbor Start vs the
    per-op neighbor_alltoall dispatch."""
    p_us, o_us = _time_neighbor_pair(n, nbytes, iters, reps)
    speedup = o_us / p_us if p_us else float("inf")
    rows = []
    for mode, us in (("persistent", p_us), ("oneshot", o_us)):
        rows.append({
            "bench": "coll_bench",
            "coll": "neighbor_alltoall",
            "ranks": n,
            "payload_bytes": nbytes,
            "component": "topo" if mode == "persistent" else "dispatch",
            "mode": mode,
            "per_op_us": round(us, 2),
            "persistent_speedup": round(speedup, 2),
            "iters": iters,
            "reps": reps,
            "n_cores": os.cpu_count(),
            "quick": quick,
            "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        })
    print(f"neighbor2d {nbytes:>8}B x{n}: Start {p_us:9.1f}us  "
          f"per-op {o_us:9.1f}us  ({speedup:.2f}x)")
    return rows


def bench_config(n: int, coll: str, nbytes: int, iters: int, reps: int,
                 quick: bool) -> list[dict]:
    from ompi_tpu_torch.mpi import trace

    rows = []
    for component, enable in (("shm", True), ("host", False)):
        var_registry.set("coll_shm_enable", enable)
        h0 = trace.hists_snapshot()
        us = _time_coll(n, coll, nbytes, iters, reps)
        # per-size tail from the dispatch histogram (the in-process
        # ranks share the process-wide series; the slot label scopes
        # the delta to THIS collective, not the sync barriers)
        p50, p99 = _hist_percentiles(
            h0, trace.hists_snapshot(), "coll_dispatch_ns",
            label=f'slot="{coll}"')
        rows.append({
            "bench": "coll_bench",
            "coll": coll,
            "ranks": n,
            "payload_bytes": nbytes,
            "component": component,
            "per_op_us": round(us, 2),
            "p50_us": p50,
            "p99_us": p99,
            "iters": iters,
            "reps": reps,
            "n_cores": os.cpu_count(),
            "quick": quick,
            "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        })
    var_registry.set("coll_shm_enable", True)
    a, b = rows[0]["per_op_us"], rows[1]["per_op_us"]
    speedup = b / a if a else float("inf")
    for r in rows:
        r["shm_speedup"] = round(speedup, 2)
    print(f"{coll:>9} {nbytes:>9}B x{n}: shm {a:9.1f}us "
          f"(p50 {rows[0]['p50_us']:.0f} p99 {rows[0]['p99_us']:.0f})  "
          f"host {b:9.1f}us "
          f"(p50 {rows[1]['p50_us']:.0f} p99 {rows[1]['p99_us']:.0f})  "
          f"({speedup:.2f}x)")
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(
        description="on-node shm-vs-host collective latency")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--quick", action="store_true",
                    help="CI smoke sizing: fewer sizes, fewer iters")
    ap.add_argument("--persistent", action="store_true",
                    help="bind-once sweep: persistent Start steady "
                    "state vs per-op dispatch (fixed root)")
    ap.add_argument("--native", action="store_true",
                    help="GIL-free data-plane sweep: arena with the "
                    "native executor vs the python arena path, plus "
                    "segment-parallel vs root-fold persistent "
                    "allreduce at >=1MiB (all shared-fate)")
    ap.add_argument("--families", default="classic",
                    help="comma list of sweep families: 'classic' "
                    "(allreduce/bcast/barrier — the default flow) "
                    "and/or 'dense' (alltoall + reduce_scatter "
                    "shm-vs-host and native-on/off, plus the 2-D "
                    "neighbor halo persistent-vs-dispatch pair)")
    ap.add_argument("--guard", action="store_true",
                    help="preflight: refuse to bench when hours-old "
                    "PPID-1 orphaned ompi_tpu processes poison the box")
    ap.add_argument("--guard-kill", action="store_true",
                    help="like --guard but SIGKILL the orphans and "
                    "proceed")
    ap.add_argument("--out", default=_OUT)
    args = ap.parse_args()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)

    if args.guard or args.guard_kill:
        from ompi_tpu_torch.tools import killorphans

        if not killorphans.preflight("coll_bench",
                                     kill=args.guard_kill):
            sys.exit(2)

    if args.quick:
        sizes = [64, 8 << 10, 256 << 10]
        iters, reps = 30, 2
    else:
        sizes = [8, 64, 1 << 10, 8 << 10, 64 << 10, 256 << 10, 1 << 20]
        iters, reps = 50, 3

    families = {f.strip() for f in args.families.split(",") if f.strip()}

    if "dense" in families:
        # alltoall rows are TOTAL sendbuf bytes (p blocks of size/p);
        # the 4KiB–4MiB sweep crosses the arena slot cap on purpose —
        # above it coll/shm falls back to host and the speedup column
        # honestly flattens to ~1x (the crossover the PERF table shows)
        dense_sizes = ([8 << 10, 64 << 10] if args.quick
                       else [4 << 10, 16 << 10, 64 << 10, 256 << 10,
                             1 << 20, 4 << 20])
        rows = []
        for coll in ("alltoall", "reduce_scatter"):
            for nbytes in dense_sizes:
                it = max(5, iters // 4) if nbytes >= (256 << 10) \
                    else iters
                rows += bench_config(args.ranks, coll, nbytes, it,
                                     reps, args.quick)
        # shared-fate native on/off over the same arena route
        nat_sizes = ([16 << 10] if args.quick
                     else [16 << 10, 64 << 10, 256 << 10])
        for coll in ("alltoall", "reduce_scatter"):
            for nbytes in nat_sizes:
                rows += bench_native_config(args.ranks, coll, nbytes,
                                            iters, reps, args.quick)
        for nbytes in ([8 << 10] if args.quick
                       else [4 << 10, 64 << 10]):
            rows += bench_neighbor_config(args.ranks, nbytes, iters,
                                          reps, args.quick)
        with open(args.out, "a", encoding="utf-8") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
        print(f"{len(rows)} rows -> {args.out}")
        for coll in ("alltoall", "reduce_scatter"):
            wins = sum(1 for r in rows
                       if r["coll"] == coll and r["component"] == "shm"
                       and "shm_speedup" in r
                       and r["payload_bytes"] >= (16 << 10)
                       and r["shm_speedup"] > 1.0)
            print(f"{coll}: arena beats host pairwise at {wins} "
                  f">=16KiB size(s)")
            if not args.quick and wins < 1:
                print(f"WARNING: expected an arena win >=16KiB "
                      f"for {coll}")
        if "classic" not in families:
            return

    if args.native:
        # the GIL-bound band the native plane targets, bracketed by one
        # small and one large size for the honest-crossover table
        nat_sizes = ([8 << 10, 64 << 10] if args.quick
                     else [64, 8 << 10, 16 << 10, 32 << 10, 64 << 10,
                           256 << 10])
        rows = bench_native_config(args.ranks, "barrier", 0, iters,
                                   reps, args.quick)
        for coll in ("allreduce", "bcast"):
            for nbytes in nat_sizes:
                it = max(5, iters // 4) if nbytes >= (256 << 10) \
                    else iters
                rows += bench_native_config(args.ranks, coll, nbytes,
                                            it, reps, args.quick)
        for nbytes in ([1 << 20] if args.quick
                       else [1 << 20, 2 << 20, 4 << 20]):
            rows += bench_segpar_config(args.ranks, nbytes,
                                        max(5, iters // 5), reps,
                                        args.quick)
        with open(args.out, "a", encoding="utf-8") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
        print(f"{len(rows)} rows -> {args.out}")
        wins = {(r["coll"], r["payload_bytes"]) for r in rows
                if r["mode"] == "native"
                and (8 << 10) <= r["payload_bytes"] <= (64 << 10)
                and r["native_speedup"] >= 1.5}
        print(f"native >=1.5x at {len(wins)} of the 8-64KiB "
              f"size rows (acceptance wants >=3)")
        seg_wins = sum(1 for r in rows if r["mode"] == "segment_parallel"
                       and r["segpar_speedup"] > 1.0)
        print(f"segment-parallel beats root-fold at {seg_wins} "
              f">=1MiB size(s)")
        return

    if args.persistent:
        # small payloads get extra reps: both modes are measured as
        # best-of, and scheduler noise on an oversubscribed box only
        # ever ADDS latency, so more reps tightens the floor estimate
        # where the dispatch-overhead difference is smallest
        small_reps = reps * 2
        rows = bench_persistent_config(args.ranks, "barrier", 0, iters,
                                       small_reps, args.quick)
        for coll in ("allreduce", "bcast"):
            for nbytes in sizes:
                it = max(5, iters // 4) if nbytes >= (256 << 10) \
                    else iters
                rp = small_reps if nbytes <= 8192 else reps
                rows += bench_persistent_config(args.ranks, coll,
                                                nbytes, it, rp,
                                                args.quick)
        with open(args.out, "a", encoding="utf-8") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
        print(f"{len(rows)} rows -> {args.out}")
        small_wins = {
            (r["coll"], r["payload_bytes"]) for r in rows
            if r["mode"] == "persistent" and r["payload_bytes"] <= 8192
            and r["persistent_speedup"] >= 2.0}
        for coll in ("allreduce", "bcast"):
            n_wins = sum(1 for c, _ in small_wins if c == coll)
            print(f"{coll}: persistent >=2x at {n_wins} small "
                  f"(<=8KiB) payload size(s)")
            if n_wins < 1:
                print(f"WARNING: expected a >=2x small-payload win "
                      f"for {coll}")
        return

    rows = bench_config(args.ranks, "barrier", 0, iters, reps, args.quick)
    for coll in ("allreduce", "bcast"):
        for nbytes in sizes:
            it = max(5, iters // 4) if nbytes >= (256 << 10) else iters
            rows += bench_config(args.ranks, coll, nbytes, it, reps,
                                 args.quick)

    with open(args.out, "a", encoding="utf-8") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    print(f"{len(rows)} rows -> {args.out}")

    wins = {(r["coll"], r["payload_bytes"]) for r in rows
            if r["component"] == "shm" and r["shm_speedup"] > 1.0}
    for coll in ("allreduce", "bcast"):
        n_wins = sum(1 for c, _ in wins if c == coll)
        print(f"{coll}: shm faster at {n_wins} payload size(s)")
        if n_wins < 2:
            print(f"WARNING: expected shm to win >=2 sizes for {coll}")


if __name__ == "__main__":
    main()
