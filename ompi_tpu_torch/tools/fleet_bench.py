"""Control-plane scale bench: the simulated fleet under correlated loss.

Boots :class:`ompi_tpu_torch.testing.simfleet.SimFleet` worlds of increasing
size (all in ONE process — stub ranks, real HNP) and measures what the
control plane costs as the world grows:

- **boot_s** — register → wire → ready for the whole tree
- **rack kill** (``--kill-frac`` of the daemons, mid-tree band, one
  tick): **adopt_s** convergence time, **reparent_epochs /
  reparent_orphans / reparent_frames** — the storm-bound assertion is
  frames == orphans + adopter-groups, one epoch per correlated loss
- **false_positive_ranks** — ranks declared dead whose daemon survived
  (must be 0: the heartbeat grace + world-scaled windows at work)
- **doctor** fleet capture: **doctor_rows** (the O(hosts ×
  doctor_rows_per_daemon) fan-in bound) and **doctor_s**
- **metrics storm** (every daemon pushes a full snapshot in one wave):
  **agg_merges / agg_sheds / agg_shed_rows** and **merge_ns_total** —
  the shed-and-count valve's ledger

Rows append to ``build/ompi_tpu_torch/bench/FLEET_BENCH.jsonl`` (the
pack_bench convention; ``--out`` picks another file).  The fleet is the
port's (``ompi_tpu_torch.testing.simfleet``); the tool imports no torch.
``--assert`` turns the CI invariants into the exit code, so the
fleet-smoke job fails loudly instead of shipping a regression:
adoption under ``--adopt-budget`` seconds, zero false-positive rank
deaths, zero self-failed daemons, exactly one reparent epoch, and
frames <= 2x orphans.

Run: ``python -m ompi_tpu_torch.tools.fleet_bench [--quick] [--assert]
[--worlds 25,50,100] [--guard|--guard-kill]``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
#: where the rows go by default (gitignored; never the repo's
#: reference ``*_BENCH.jsonl``)
OUT_DIR = os.path.join(REPO, "build", "ompi_tpu_torch", "bench")
_OUT = os.path.join(OUT_DIR, "FLEET_BENCH.jsonl")


def bench_world(n_daemons: int, ranks_per_daemon: int, kill_frac: float,
                seed: int, adopt_budget: float) -> dict:
    from ompi_tpu_torch.testing.simfleet import SimFleet

    n_ranks = n_daemons * ranks_per_daemon
    row: dict = {
        "bench": "fleet", "n_daemons": n_daemons, "n_ranks": n_ranks,
        "kill_frac": kill_frac, "seed": seed, "ok": True,
    }
    fleet = SimFleet(n_daemons=n_daemons, n_ranks=n_ranks, seed=seed,
                     hb_period=0.5, hb_timeout=3.0,
                     agg_budget_rows=max(64, n_ranks // 2))
    t0 = time.monotonic()
    fleet.start(timeout=max(60.0, n_daemons))
    row["boot_s"] = round(time.monotonic() - t0, 4)
    try:
        victims = fleet.rack(max(1, int(n_daemons * kill_frac)))
        row["killed_daemons"] = len(victims)
        fleet.rack_kill(victims)
        adopt_s = fleet.wait_adopted(timeout=adopt_budget)
        row["adopt_s"] = None if adopt_s is None else round(adopt_s, 4)
        st = fleet.stats()
        row["reparent_epochs"] = st["reparent_epochs_total"]
        row["reparent_orphans"] = st["reparent_orphans_total"]
        row["reparent_frames"] = st["reparent_frames_total"]
        row["false_positive_ranks"] = len(
            fleet.false_positive_rank_deaths())
        row["self_failed_daemons"] = len(fleet.self_failed())
        row["hb_ticks"] = st["hb_ticks_total"]
        row["hb_scanned"] = st["hb_scanned_total"]

        t0 = time.monotonic()
        rows, seen = fleet.collect_doctor(timeout=15.0)
        row["doctor_s"] = round(time.monotonic() - t0, 4)
        row["doctor_rows"] = len(rows)
        row["doctor_replied"] = len(seen)

        fleet.metrics_storm(full=True)
        time.sleep(1.0)
        st = fleet.stats()
        row["agg_merges"] = st["agg_merges_total"]
        row["agg_merge_ns"] = st["agg_merge_ns_total"]
        row["agg_sheds"] = st["agg_sheds_total"]
        row["agg_shed_rows"] = st["agg_shed_rows_total"]
        row["live_daemons"] = st["live_daemons"]
    finally:
        fleet.stop()

    # the CI invariants (reported per row; --assert folds them into rc)
    failures = []
    if row["adopt_s"] is None:
        failures.append(f"adoption did not converge in {adopt_budget}s")
    if row["false_positive_ranks"]:
        failures.append(
            f"{row['false_positive_ranks']} healthy rank(s) declared "
            f"dead")
    if row["self_failed_daemons"]:
        failures.append(
            f"{row['self_failed_daemons']} surviving daemon(s) gave up")
    if row["reparent_epochs"] != 1:
        failures.append(
            f"{row['reparent_epochs']} reparent epochs for ONE "
            f"correlated loss (want 1 batched round)")
    if row["reparent_frames"] > 2 * max(1, row["reparent_orphans"]):
        failures.append(
            f"{row['reparent_frames']} reparent frames for "
            f"{row['reparent_orphans']} orphans (bound: 2x)")
    if row["doctor_replied"] < row["live_daemons"]:
        failures.append(
            f"doctor: {row['doctor_replied']}/{row['live_daemons']} "
            f"daemons replied")
    row["ok"] = not failures
    row["failures"] = failures
    return row


def main() -> None:
    ap = argparse.ArgumentParser(
        description="simulated-fleet control-plane scale bench")
    ap.add_argument("--quick", action="store_true",
                    help="CI smoke sizing: fewer/smaller worlds")
    ap.add_argument("--worlds", default="",
                    help="comma list of daemon counts (overrides sizing)")
    ap.add_argument("--ranks-per-daemon", type=int, default=10)
    ap.add_argument("--kill-frac", type=float, default=0.16,
                    help="fraction of daemons killed in one tick")
    ap.add_argument("--adopt-budget", type=float, default=30.0,
                    help="seconds full adoption must land within")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--assert", dest="strict", action="store_true",
                    help="nonzero exit when any invariant fails")
    ap.add_argument("--guard", action="store_true",
                    help="preflight: refuse to bench when hours-old "
                    "PPID-1 orphaned ompi_tpu processes poison the box")
    ap.add_argument("--guard-kill", action="store_true",
                    help="like --guard but SIGKILL the orphans and "
                    "proceed")
    ap.add_argument("--out", default=_OUT)
    args = ap.parse_args()

    if args.guard or args.guard_kill:
        from ompi_tpu_torch.tools import killorphans

        if not killorphans.preflight("fleet_bench",
                                     kill=args.guard_kill):
            sys.exit(2)

    if args.worlds:
        worlds = [int(w) for w in args.worlds.split(",") if w.strip()]
    elif args.quick:
        worlds = [25, 100]
    else:
        worlds = [25, 50, 100, 200]

    stamp = time.time()
    rows = []
    ok = True
    for n in worlds:
        row = bench_world(n, args.ranks_per_daemon, args.kill_frac,
                          args.seed, args.adopt_budget)
        row["ts"] = stamp
        rows.append(row)
        ok = ok and row["ok"]
        status = "ok" if row["ok"] else "FAIL " + "; ".join(
            row["failures"])
        print(f"[fleet_bench] {n} daemons / {row['n_ranks']} ranks: "
              f"boot {row['boot_s']}s, adopt {row['adopt_s']}s, "
              f"{row['reparent_frames']} frames / "
              f"{row['reparent_orphans']} orphans, doctor "
              f"{row['doctor_rows']} rows — {status}")

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    print(f"[fleet_bench] {len(rows)} row(s) -> {args.out}")
    if args.strict and not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
