"""Cross-rank straggler report: who is everyone waiting for? (The
port's copy of the repo's ``tools/straggler_report.py``, its offline
mode.)

It reads the per-rank flight-recorder dumps
(``ompi_tpu_trace_<jobid>_rank<r>.json``, written by ``--trace`` runs and
crash dumps), pulls each rank's histogram vectors out of
``otherData.hists``, and runs the straggler panel
(``runtime.metrics.straggler_panel``) over the whole run.  The rank with
the LOWEST share of the job's total collective wait time is the one
every other rank spent its wait time waiting for — the last arriver
barely waits.

Run: ``python -m ompi_tpu_torch.tools.straggler_report --dir /tmp``.
The live mode (``--uri``, the DVM's ``/status`` panel) comes with the
DVM, ROADMAP.md Queue 1 item 6.15.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys

from ompi_tpu_torch.runtime.metrics import straggler_panel

_DUMP_RE = re.compile(r"ompi_tpu_trace_(\d+)_rank(\d+)\.json$")


def _print_panel(jobid, panel: dict, out=sys.stdout) -> None:
    print(f"job {jobid}  [signal: {panel['signal']}, window "
          f"{panel['window_s']:.1f}s]", file=out)
    print(f"  {'rank':>5} {'wait_ms':>12} {'publish_ms':>12} "
          f"{'wait_share':>11}", file=out)
    for rank in sorted(panel["ranks"], key=int):
        row = panel["ranks"][rank]
        mark = "  <- suspect" if (panel["suspect"] is not None
                                  and int(rank)
                                  == int(panel["suspect"])) else ""
        print(f"  {rank:>5} {row['wait_ms']:>12.3f} "
              f"{row['publish_ms']:>12.3f} {row['wait_share']:>11.4f}"
              f"{mark}", file=out)
    skew = panel["skew"]
    print(f"  max/median wait: {panel['max_wait_ms']:.3f}/"
          f"{panel['median_wait_ms']:.3f} ms"
          + (f"  (skew {skew:.2f}x)" if skew is not None else ""),
          file=out)
    if panel["suspect"] is not None:
        print(f"  slowest rank: {panel['suspect']} (lowest wait share "
              f"— the rank the others wait for)", file=out)
    else:
        print("  no suspect (single rank or no wait-time data)",
              file=out)


def _sums_from_hists(hists: dict) -> tuple[float, float, float]:
    """(arena-wait sum, publish sum, coll-dispatch sum) in ns from one
    rank's dumped series map (label variants folded per base)."""
    wait = pub = busy = 0.0
    for key, vec in hists.items():
        base = key.split("{", 1)[0]
        if not vec:
            continue
        if base == "coll_arena_wait_ns":
            wait += vec[-1]
        elif base == "coll_ppublish_ns":
            pub += vec[-1]
        elif base == "coll_dispatch_ns":
            busy += vec[-1]
    return wait, pub, busy


def report_offline(trace_dir: str) -> int:
    by_job: dict[int, dict[int, tuple[float, float, float]]] = {}
    for path in sorted(glob.glob(
            os.path.join(trace_dir, "ompi_tpu_trace_*_rank*.json"))):
        m = _DUMP_RE.search(path)
        if not m:
            continue
        jobid, rank = int(m.group(1)), int(m.group(2))
        try:
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
            hists = doc.get("otherData", {}).get("hists", {})
        except (OSError, ValueError):
            continue
        by_job.setdefault(jobid, {})[rank] = _sums_from_hists(hists)
    if not by_job:
        print(f"no per-rank dumps with histogram data under "
              f"{trace_dir!r}")
        return 1
    for jobid in sorted(by_job):
        ranks = by_job[jobid]
        waits = {r: w for r, (w, _p, _b) in ranks.items()}
        signal = "arena_wait"
        if not any(waits.values()):
            waits = {r: b for r, (_w, _p, b) in ranks.items()}
            signal = "coll_dispatch"
        pubs = {r: p for r, (_w, p, _b) in ranks.items()}
        panel = straggler_panel(waits, pubs, signal, window_s=0.0)
        if panel is None:
            continue
        _print_panel(jobid, panel)
    return 0


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(
        description="per-rank collective wait/publish breakdown with a "
                    "named straggler suspect")
    ap.add_argument("--dir", required=True,
                    help="directory of per-rank "
                    "ompi_tpu_trace_*_rank*.json dumps")
    args = ap.parse_args(argv)
    return report_offline(args.dir)


if __name__ == "__main__":
    sys.exit(main())
