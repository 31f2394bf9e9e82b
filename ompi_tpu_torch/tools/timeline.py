"""Fetch a cross-rank timeline — live from a running world, or
postmortem from crash dumps (the port's copy of the repo's
``tools/timeline.py``).

Live mode (a DVM with ``--metrics-port`` is up and a job is running):

    python -m ompi_tpu_torch.tools.timeline -o trace.json
    python -m ompi_tpu_torch.tools.timeline --uri http://127.0.0.1:9301 --tail 4096

pulls ``/timeline`` — the HNP xcasts TAG_TIMELINE, every orted gathers
bounded flight-recorder tails from its live ranks, and the reply is one
merged, skew-corrected (measured clock offsets) Chrome trace with
cross-rank flow arrows.  The default --uri is read from the DVM's
``<uri>.metrics`` file, like the scrape endpoint's other clients.

Postmortem mode (the world is gone; finalize/abort dumps remain):

    python -m ompi_tpu_torch.tools.timeline --dir $TMPDIR --jobid 7 -o trace.json
    python -m ompi_tpu_torch.tools.timeline --dir $TMPDIR --offsets offsets.json

delegates to ``trace_export``'s merge over the per-rank dump files
(wall-anchor or ``--offsets`` measured correction).

Either way the output loads in chrome://tracing and
https://ui.perfetto.dev.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import urllib.request

from ompi_tpu_torch.tools import trace_export


def default_metrics_uri() -> "str | None":
    """The DVM's recorded scrape address (``<uri>.metrics``), if a DVM
    is up with the observability plane armed."""
    from ompi_tpu_torch.runtime.clean import default_uri_path

    try:
        with open(default_uri_path() + ".metrics", encoding="utf-8") as f:
            return f.read().strip() or None
    except OSError:
        return None


def fetch_live(uri: str, tail: int, timeout: float = 30.0) -> dict:
    """One live /timeline capture from the DVM's scrape endpoint."""
    url = f"{uri.rstrip('/')}/timeline?tail={int(tail)}"
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.load(resp)


def main(argv: "list[str] | None" = None) -> int:
    p = argparse.ArgumentParser(
        description="Fetch a merged cross-rank timeline (live /timeline "
                    "capture or postmortem dump merge).")
    p.add_argument("--uri", default=None,
                   help="DVM metrics endpoint (default: the address in "
                        "the DVM's <uri>.metrics file)")
    p.add_argument("--tail", type=int, default=2048,
                   help="per-rank recorder tail to pull (live mode)")
    p.add_argument("--dir", default=None,
                   help="postmortem: merge ompi_tpu_trace_*.json dumps "
                        "from this directory instead of a live capture")
    p.add_argument("--jobid", type=int, default=None,
                   help="with --dir: only this job's dumps")
    p.add_argument("--offsets", default=None, metavar="FILE",
                   help="with --dir: JSON map rank → measured offset ns "
                        "(see trace_export --offsets)")
    p.add_argument("-o", "--output", default="ompi_tpu_timeline.json")
    p.add_argument("--validate", action="store_true",
                   help="also run the exporter's schema + causality "
                        "validator on the result; nonzero exit on "
                        "problems")
    args = p.parse_args(argv)

    if args.dir:
        paths = sorted(glob.glob(os.path.join(
            args.dir, trace_export.dump_glob(args.jobid))))
        if not paths:
            print("timeline: no dumps found", file=sys.stderr)
            return 2
        offsets = None
        if args.offsets:
            with open(args.offsets, encoding="utf-8") as f:
                offsets = {int(r): float(v)
                           for r, v in json.load(f).items()
                           if v is not None}
        doc = trace_export.merge(paths, offsets=offsets)
        source = f"{len(paths)} dump(s)"
    else:
        uri = args.uri or default_metrics_uri()
        if not uri:
            print("timeline: no --uri and no DVM <uri>.metrics file "
                  "found (start one with: tpurun --dvm-start "
                  "--metrics-port 0), or use --dir for postmortem "
                  "merges", file=sys.stderr)
            return 2
        try:
            doc = fetch_live(uri, args.tail)
        except OSError as e:
            print(f"timeline: cannot reach {uri}/timeline ({e})",
                  file=sys.stderr)
            return 2
        source = f"live capture from {uri}"
        other = doc.get("otherData") or {}
        if other.get("idle"):
            print("timeline: DVM is idle (no job running, no cached "
                  "capture) — nothing to plot", file=sys.stderr)
            return 3
        if other.get("stale"):
            print("timeline: no job running — serving the cached last "
                  "capture", file=sys.stderr)

    problems = trace_export.validate(doc)
    problems += trace_export.causality_problems(
        doc.get("traceEvents") or [])
    problems += (doc.get("otherData") or {}).get(
        "causality_problems") or []
    if args.validate and problems:
        for pr in problems:
            print(f"timeline: INVALID: {pr}", file=sys.stderr)
        return 1
    for pr in problems:
        print(f"timeline: WARNING: {pr}", file=sys.stderr)

    with open(args.output, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    events = doc.get("traceEvents") or []
    n_spans = sum(1 for e in events if e.get("ph") == "X")
    n_flows = sum(1 for e in events if e.get("ph") == "s")
    other = doc.get("otherData") or {}
    print(f"timeline: wrote {args.output} — {len(events)} events "
          f"({n_spans} spans, {n_flows} flow arrows) from {source}; "
          f"clock domain: {other.get('clock_domain', '?')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
