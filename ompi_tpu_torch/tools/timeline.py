"""Merge a cross-rank timeline postmortem from crash dumps (the port's
copy of the repo's ``tools/timeline.py``, its ``--dir`` mode):

    python -m ompi_tpu_torch.tools.timeline --dir $TMPDIR --jobid 7 \
        -o trace.json
    python -m ompi_tpu_torch.tools.timeline --dir $TMPDIR \
        --offsets offsets.json

delegates to ``trace_export``'s merge over the per-rank dump files
(wall-anchor or ``--offsets`` measured correction).  The output loads
in chrome://tracing and https://ui.perfetto.dev.  The live mode
(``--uri``, the DVM's ``/timeline`` capture) comes with the DVM,
ROADMAP.md Queue 1 item 6.15b.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from ompi_tpu_torch.tools import trace_export


def main(argv: "list[str] | None" = None) -> int:
    p = argparse.ArgumentParser(
        description="Merge a cross-rank timeline from per-rank dumps.")
    p.add_argument("--dir", required=True,
                   help="merge ompi_tpu_trace_*.json dumps from this "
                        "directory")
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
