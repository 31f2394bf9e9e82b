"""Pack/unpack convertor microbench — one JSON line per config.

Times the host datatype hot path over run counts {1, 1k, 100k, 1M} for
the two plan families the run-coalescing convertor compiles to:

- ``vector``:   FLOAT64.vector(n, 1, 2) — an affine layout, plans to a
                strided progression (zero per-run metadata).
- ``hindexed``: gapped 8B runs — plans to coalesced absolute (offsets,
                lengths) arrays with the uniform-length fast path.
- ``ragged``:   alternating 8B/16B runs — the generic wide-run memcpy
                loop (no fixed-width specialization possible).

Per config it reports the cold first pack (constructor + commit + plan
compile + copy), then slope-timed steady-state ``pack_into`` (the
memoryview variant the transports use — no bytes materialization),
``pack`` (bytes-returning) and ``unpack``.  Slope timing: the same
call at two rep counts, cost = (t_hi - t_lo) / (reps_hi - reps_lo), so
per-call constants cancel (the bench.py two-point method, host-side).

Rows append to ``build/ompi_tpu_torch/bench/PACK_BENCH.jsonl``
(append-only, one JSON object per line; ``--out`` picks another file)
so the headline stays reproducible and future regressions are visible.
Run: ``python -m ompi_tpu_torch.tools.pack_bench [--runs 1,1000,...]``.
The port's datatype engine is numpy on the host: the tool imports no
torch.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from ompi_tpu_torch.mpi import datatype as dt
from ompi_tpu_torch.mpi.datatype import DerivedDatatype

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
#: where the rows go by default (gitignored; never the repo's
#: reference ``*_BENCH.jsonl``)
OUT_DIR = os.path.join(REPO, "build", "ompi_tpu_torch", "bench")
_OUT = os.path.join(OUT_DIR, "PACK_BENCH.jsonl")


def _make(layout: str, runs: int):
    """(datatype, buffer bytes needed) for ``runs`` runs, committed —
    construction + commit time is the COLD number, so this is timed."""
    if layout == "vector":
        return dt.FLOAT64.vector(runs, 1, 2).commit()
    if layout == "hindexed":
        # gapped, non-abutting 8B runs (offset 4 keeps the item-boundary
        # merge away so the run count stays honest)
        offs = np.arange(runs, dtype=np.int64) * 24 + 4
        cnts = np.full(runs, 8, np.int64)
        t = DerivedDatatype(dt.BYTE, (offs, cnts), pattern_unit="bytes",
                            name=f"hindexed({runs})")
        return t.commit()
    if layout == "ragged":
        offs = np.arange(runs, dtype=np.int64) * 32 + 4
        cnts = np.where(np.arange(runs) % 2 == 0, 8, 16).astype(np.int64)
        t = DerivedDatatype(dt.BYTE, (offs, cnts), pattern_unit="bytes",
                            name=f"ragged({runs})")
        return t.commit()
    raise ValueError(layout)


def _slope_ms(fn, reps_lo: int, reps_hi: int) -> float:
    """Per-call milliseconds by the two-point slope (constants cancel)."""
    fn()   # warm

    def timed(reps: int) -> float:
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            best = min(best, time.perf_counter() - t0)
        return best

    t_lo, t_hi = timed(reps_lo), timed(reps_hi)
    return max(t_hi - t_lo, 1e-9) / (reps_hi - reps_lo) * 1e3


def bench_config(layout: str, runs: int) -> dict:
    t0 = time.perf_counter()
    t = _make(layout, runs)                      # constructor + commit =
    commit_ms = (time.perf_counter() - t0) * 1e3  # descriptor + plan compile
    plan = t.pack_plan(1)
    src = np.random.default_rng(0).integers(
        0, 256, max(plan.span, 8)).astype(np.uint8)
    t0 = time.perf_counter()
    cold = t.pack(src, 1)                        # first pack, plan warm
    first_pack_ms = (time.perf_counter() - t0) * 1e3
    total = len(cold)
    out = np.empty(total, np.uint8)
    dst = np.empty_like(src)
    reps = (2, 10) if runs >= 100_000 else (10, 50)
    row = {
        "bench": "pack_bench",
        "layout": layout,
        "runs": runs,
        "payload_bytes": total,
        "plan": t.pack_plan(1).kind,
        "native": dt._native_convertor(max(total, 1 << 30)) is not None,
        "commit_ms": round(commit_ms, 3),
        "first_pack_ms": round(first_pack_ms, 3),
        "pack_into_ms": round(_slope_ms(
            lambda: t.pack_into(src, 1, out), *reps), 4),
        "pack_ms": round(_slope_ms(lambda: t.pack(src, 1), *reps), 4),
        "unpack_ms": round(_slope_ms(
            lambda: t.unpack(out, dst, 1), *reps), 4),
        "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    row["pack_into_gibps"] = round(
        total / (row["pack_into_ms"] / 1e3) / 2**30, 3)
    return row


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--runs", default="1,1000,100000,1000000",
                    help="comma-separated run counts")
    ap.add_argument("--layouts", default="vector,hindexed,ragged")
    ap.add_argument("--out", default=_OUT)
    args = ap.parse_args()
    run_counts = [int(x) for x in args.runs.split(",") if x.strip()]
    rows = []
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    for layout in args.layouts.split(","):
        for n in run_counts:
            row = bench_config(layout, n)
            rows.append(row)
            print(json.dumps(row), flush=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    head = [r for r in rows if r["runs"] == max(run_counts)]
    for r in head:
        print(f"# {r['layout']} @ {r['runs']} runs: "
              f"pack_into {r['pack_into_ms']}ms "
              f"({r['pack_into_gibps']} GiB/s), commit+first "
              f"{r['commit_ms']}+{r['first_pack_ms']}ms", file=sys.stderr)


if __name__ == "__main__":
    main()
