#!/usr/bin/env python
"""Merge per-rank flight-recorder dumps into one Chrome/Perfetto trace
(the port's copy of the repo's ``tools/trace_export.py``, whole: the dump
format is the same in both packages, so it merges either's dumps).

Each rank (``OMPI_TPU_TRACE=1`` / ``tpurun --trace``) flushes a
standalone JSON file at finalize/abort:

    ${TMPDIR}/ompi_tpu_trace_<jobid>_rank<r>.json

This tool merges any number of them into a single trace JSON that
chrome://tracing and https://ui.perfetto.dev load directly — one pid per
rank (named ``rank N``), one tid per category (named after the
category), events globally sorted by timestamp.

    python -m ompi_tpu_torch.tools.trace_export -o merged.json \
        $TMPDIR/ompi_tpu_trace_*_rank*.json
    python -m ompi_tpu_torch.tools.trace_export -o merged.json \
        --dir $TMPDIR --jobid 7

With ``--onto PROFILE`` the dumps are laid onto a ``torch.profiler``
Chrome trace instead (:func:`onto_profile`): the ring's spans, the
model path's ``model`` spans among them, on the clock of the
profiler's kernels.

    python -m ompi_tpu_torch.tools.trace_export -o both.json \
        --onto trace.json $TMPDIR/ompi_tpu_trace_*_rank0.json
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys

_RANK_RE = re.compile(r"ompi_tpu_trace_(\d+)_rank(-?\d+)\.json$")


def dump_glob(jobid: "int | None" = None) -> str:
    """The per-rank dump filename glob (THE place the pattern lives
    beside _RANK_RE — hang_doctor's offline mode imports both
    instead of re-hardcoding trace.default_path's format)."""
    return (f"ompi_tpu_trace_{jobid}_rank*.json" if jobid is not None
            else "ompi_tpu_trace_*_rank*.json")

# keep in sync with ompi_tpu_torch.mpi.trace.CATEGORIES (the exporter must not
# import the package: it runs standalone in CI validation steps)
CATEGORIES = ("pml", "btl", "coll", "osc", "io", "ckpt", "datatype",
              "runtime", "errmgr", "model")

#: span names that carry a flow id (``args.fl``) — the send/recv halves
#: of one message; each cross-rank pair becomes a Perfetto flow arrow
FLOW_SEND_SPANS = ("eager_send", "rndv_send")
FLOW_RECV_SPANS = ("eager_recv", "rndv_recv")

#: instant names carrying ``args.tc`` — the two ends of one RML envelope
#: (keep in sync with ompi_tpu_torch.runtime.timeline)
RML_SEND_NAME = "rml_send"
RML_RECV_NAME = "rml_recv"


def _load(path: str) -> tuple[int, list[dict], dict]:
    """→ (rank, events, otherData) from one per-rank dump."""
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    if isinstance(doc, list):          # bare event list: rank from name
        events, other = doc, {}
    else:
        events = doc.get("traceEvents", [])
        other = doc.get("otherData", {}) or {}
    rank = other.get("rank")
    if rank is None:
        m = _RANK_RE.search(os.path.basename(path))
        rank = int(m.group(2)) if m else -1
    if "jobid" not in other:
        m = _RANK_RE.search(os.path.basename(path))
        if m:
            other = dict(other, jobid=int(m.group(1)))
    return int(rank), events, other


def merge(paths: list[str],
          offsets: "dict[int, float] | None" = None) -> dict:
    """Merge per-rank dumps into one Chrome trace document.

    Clock correction, in preference order:

    - ``offsets`` (``--offsets FILE``): MEASURED per-rank monotonic
      offsets to a common root clock (ns, added to each rank's
      timestamps) — what the clock-sync plane publishes per rank as
      ``rank_clock_to_root_ns`` on the DVM's ``/status``;
    - wall anchors: when no measured offsets are given and the dumps'
      wall-vs-monotonic anchors differ by >10 s (ranks on different
      hosts), every rank is shifted onto the wall axis instead of just
      warning — NTP-grade, but a timeline instead of fiction;
    - none: shared-host dumps (anchors agree) merge raw.

    After correction every send→recv flow pair is checked for
    causality (a recv span ending before its matching send means the
    correction failed); violations land in
    ``otherData.causality_problems`` and are printed as warnings.
    """
    all_events: list[dict] = []
    meta: list[dict] = []
    per_rank: dict[int, dict] = {}
    seen_tids: dict[int, set[int]] = {}
    rank_events: dict[int, list[dict]] = {}
    jobids: set = set()
    for path in paths:
        rank, events, other = _load(path)
        jobids.add(other.get("jobid"))
        if rank in per_rank:
            # two dumps claim the same rank — almost certainly dumps of
            # DIFFERENT jobs in one TMPDIR; their monotonic clocks share
            # no base, so the merged timeline would be fiction
            print(f"trace_export: WARNING: rank {rank} appears in more "
                  f"than one input ({path}); pass --jobid to select one "
                  f"job's dumps", file=sys.stderr)
        per_rank[rank] = {k: other.get(k) for k in
                          ("events_total", "dropped", "counters",
                           "clock_offset_ns",
                           # the collective-recorder tail rides the
                           # merge so one artifact feeds both Perfetto
                           # and the offline hang doctor
                           "collrec", "collrec_total")}
        meta.append({"ph": "M", "name": "process_name", "pid": rank,
                     "tid": 0, "args": {"name": f"rank {rank}"}})
        tids = seen_tids.setdefault(rank, set())
        mine = rank_events.setdefault(rank, [])
        for ev in events:
            ev = dict(ev)
            ev["pid"] = rank           # one pid per rank, always
            all_events.append(ev)
            mine.append(ev)
            tids.add(int(ev.get("tid", 0)))
    if len(jobids - {None}) > 1:
        print(f"trace_export: WARNING: merging dumps from several jobs "
              f"{sorted(j for j in jobids if j is not None)} — their "
              f"timelines are not comparable; pass --jobid",
              file=sys.stderr)
    # event ts are per-machine CLOCK_MONOTONIC; widely differing
    # wall-vs-monotonic anchors mean ranks ran on different hosts (or
    # across reboots) — correct rather than merely warn
    clock_domain = "monotonic_shared"
    anchors = {r: v.get("clock_offset_ns") for r, v in per_rank.items()
               if isinstance(v.get("clock_offset_ns"), (int, float))}
    if offsets:
        clock_domain = "root_monotonic"
        for rank, evs in rank_events.items():
            shift_us = float(offsets.get(rank, 0)) / 1000.0
            per_rank[rank]["applied_offset_ns"] = offsets.get(rank, 0)
            for ev in evs:
                if "ts" in ev:
                    ev["ts"] = float(ev["ts"]) + shift_us
    elif anchors and max(anchors.values()) - min(anchors.values()) \
            > 10_000_000_000:   # >10 s skew: different hosts
        clock_domain = "wall"
        base = min(anchors.values())
        for rank, evs in rank_events.items():
            off = anchors.get(rank)
            if off is None:
                continue   # no anchor: this rank's dump stays raw
            shift_us = float(off - base) / 1000.0
            per_rank[rank]["applied_offset_ns"] = off - base
            for ev in evs:
                if "ts" in ev:
                    ev["ts"] = float(ev["ts"]) + shift_us
    for rank, tids in seen_tids.items():
        for tid in sorted(tids):
            name = CATEGORIES[tid] if tid < len(CATEGORIES) else "other"
            meta.append({"ph": "M", "name": "thread_name", "pid": rank,
                         "tid": tid, "args": {"name": name}})
    problems = causality_problems(all_events)
    for pr in problems:
        print(f"trace_export: WARNING: {pr}", file=sys.stderr)
    all_events.extend(flow_events(all_events))
    if all_events:
        # measured offsets can legally push early events below zero;
        # Perfetto wants a non-negative axis
        base_ts = min(float(e.get("ts", 0.0)) for e in all_events)
        if base_ts < 0:
            for ev in all_events:
                ev["ts"] = float(ev.get("ts", 0.0)) - base_ts
    all_events.sort(key=lambda e: float(e.get("ts", 0.0)))
    return {
        "displayTimeUnit": "ns",
        "otherData": {"ranks": sorted(per_rank),
                      "clock_domain": clock_domain,
                      "causality_problems": problems,
                      "per_rank": {str(r): v
                                   for r, v in sorted(per_rank.items())}},
        "traceEvents": meta + all_events,
    }


#: a dump's pid in a profiler trace: this + its rank (kineto's pids are
#: the process's and the devices' ids)
ONTO_PID_BASE = 1 << 30


def onto_profile(profile: dict, paths: list[str]) -> dict:
    """A ``torch.profiler`` Chrome trace with flight-recorder dumps laid
    onto its clock.  The profiler's ``ts`` (µs) plus its
    ``baseTimeNanoseconds`` is Unix-epoch time; a dump's ``ts`` is
    CLOCK_MONOTONIC, and its ``clock_offset_ns`` the wall clock less the
    monotonic one, so a ring event moves to
    ``(monotonic + clock_offset_ns − baseTimeNanoseconds) / 1000``.
    Each dump becomes process ``ONTO_PID_BASE + rank`` (named
    ``flight recorder, rank N``), one thread per category."""
    base = profile.get("baseTimeNanoseconds")
    if not isinstance(base, (int, float)):
        raise ValueError("the profiler trace has no baseTimeNanoseconds")
    added: list[dict] = []
    for path in paths:
        rank, events, other = _load(path)
        offset = other.get("clock_offset_ns")
        if not isinstance(offset, (int, float)):
            raise ValueError(f"{path}: the dump has no clock_offset_ns")
        shift_us = (offset - base) / 1000.0
        pid = ONTO_PID_BASE + rank
        added.append({"ph": "M", "name": "process_name", "pid": pid,
                      "tid": 0,
                      "args": {"name": f"flight recorder, rank {rank}"}})
        tids = set()
        for ev in events:
            ev = dict(ev, pid=pid)
            if "ts" in ev:
                ev["ts"] = float(ev["ts"]) + shift_us
            tids.add(int(ev.get("tid", 0)))
            added.append(ev)
        for tid in sorted(tids):
            name = CATEGORIES[tid] if tid < len(CATEGORIES) else "other"
            added.append({"ph": "M", "name": "thread_name", "pid": pid,
                          "tid": tid, "args": {"name": name}})
    return dict(profile,
                traceEvents=list(profile.get("traceEvents", [])) + added)


def flow_events(events: list[dict]) -> list[dict]:
    """Cross-rank flow arrows (``ph s``/``t``/``f``), three families:

    - p2p: every ``{eager,rndv}_send`` span whose ``(args.tc,
      args.fl)`` matches an ``{eager,rndv}_recv`` span on another rank
      — send→recv arrows that make inter-rank waits visible;
    - collective rounds: every rank's ``coll``-category span of one
      ``(cid, seq)`` chained in completion order;
    - RML envelopes: ``rml_send``/``rml_recv`` instants paired by the
      ``(trace_id, span_id)`` envelope stamp.

    Flow endpoints must land INSIDE their span (Chrome binds a flow
    event to the slice enclosing its ts on that pid/tid), so the start
    rides just before the send span's end and the finish (``bp: "e"``,
    bind-to-enclosing) just before the recv span's end — the arrow runs
    from "payload handed to the wire" to "payload delivered"."""
    sends: dict = {}
    recvs: dict = {}
    colls: dict = {}
    rml_s: dict = {}
    rml_r: dict = {}
    for ev in events:
        args = ev.get("args") or {}
        name = ev.get("name")
        if ev.get("ph") == "X":
            fl = args.get("fl")
            if fl is not None:
                # scoped by the trace id when the header carried one:
                # flow ids from different jobs must not stitch
                key = (args.get("tc"), fl)
                if name in FLOW_SEND_SPANS:
                    sends.setdefault(key, ev)
                elif name in FLOW_RECV_SPANS:
                    recvs.setdefault(key, ev)
            if ev.get("cat") == "coll" and "seq" in args \
                    and "cid" in args:
                colls.setdefault((args["cid"], args["seq"]),
                                 []).append(ev)
        elif name == RML_SEND_NAME and args.get("tc") is not None:
            rml_s.setdefault(tuple(args["tc"]), ev)
        elif name == RML_RECV_NAME and args.get("tc") is not None:
            rml_r.setdefault(tuple(args["tc"]), ev)
    out: list[dict] = []
    for key, sev in sends.items():
        rev = recvs.get(key)
        if rev is None or rev.get("pid") == sev.get("pid"):
            continue   # no recv half, or a self-send — no arrow to draw
        # s anchors at the send span's START: the transfer happens
        # somewhere inside the send call, and a fast receiver can
        # legitimately finish unpacking before the sender's span closes
        # (anchoring s at send END would read that as a backward arrow)
        s_ts = float(sev["ts"])
        f_ts = float(rev["ts"]) + max(0.0, float(rev.get("dur", 0.0)))
        if f_ts < s_ts:
            # recv span ends before the send even STARTED: residual
            # clock skew (the merge reports it as a causality problem).
            # Both endpoints must land INSIDE their spans to bind, so
            # no placement exists — skip the pair rather than draw an
            # arrow anchored to the wrong slice
            continue
        tc, fl = key
        fid = f"{tc}:{fl}" if tc is not None else fl
        common = {"cat": "flow", "name": "msg", "id": fid}
        out.append({**common, "ph": "s", "ts": s_ts,
                    "pid": sev["pid"], "tid": sev.get("tid", 0)})
        out.append({**common, "ph": "f", "bp": "e", "ts": f_ts,
                    "pid": rev["pid"], "tid": rev.get("tid", 0)})
    for (cid, seq), group in colls.items():
        # one span per pid (keep the earliest), chained in end order:
        # the arrow path from first-done to last-done rank of one
        # collective round — where the path waits is the straggler
        by_pid: dict = {}
        for ev in group:
            cur = by_pid.get(ev.get("pid"))
            if cur is None or float(ev.get("ts", 0)) < float(
                    cur.get("ts", 0)):
                by_pid[ev.get("pid")] = ev
        chain = sorted(
            by_pid.values(),
            key=lambda e: float(e.get("ts", 0))
            + max(0.0, float(e.get("dur", 0.0))))
        if len(chain) < 2:
            continue   # single-rank round: nothing to stitch
        common = {"cat": "flow", "name": "coll_round",
                  "id": f"coll:{cid}:{seq}"}
        for i, ev in enumerate(chain):
            ph = "s" if i == 0 else ("f" if i == len(chain) - 1 else "t")
            step = {**common, "ph": ph,
                    "ts": float(ev.get("ts", 0))
                    + max(0.0, float(ev.get("dur", 0.0))),
                    "pid": ev["pid"], "tid": ev.get("tid", 0)}
            if ph == "f":
                step["bp"] = "e"
            out.append(step)
    for key, sev in rml_s.items():
        rev = rml_r.get(key)
        if rev is None or rev.get("pid") == sev.get("pid"):
            continue
        s_ts, f_ts = float(sev.get("ts", 0)), float(rev.get("ts", 0))
        if f_ts < s_ts:
            continue
        common = {"cat": "flow", "name": "rml",
                  "id": f"rml:{key[0]}:{key[1]}"}
        out.append({**common, "ph": "s", "ts": s_ts,
                    "pid": sev["pid"], "tid": sev.get("tid", 0)})
        out.append({**common, "ph": "f", "bp": "e", "ts": f_ts,
                    "pid": rev["pid"], "tid": rev.get("tid", 0)})
    return out


def causality_problems(events: list[dict]) -> list[str]:
    """Post-correction sanity: a recv span that ENDS before its
    matching send span even STARTED means the applied clock correction
    failed to restore causality (data cannot finish arriving before
    the send call began; comparing span ENDS would false-positive on
    every fast receiver outpacing a slow sender).  One line per
    violated pair; the validator asserts the list empty."""
    sends: dict = {}
    recvs: dict = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        args = ev.get("args") or {}
        fl = args.get("fl")
        if fl is None:
            continue
        key = (args.get("tc"), fl)
        if ev.get("name") in FLOW_SEND_SPANS:
            sends.setdefault(key, ev)
        elif ev.get("name") in FLOW_RECV_SPANS:
            recvs.setdefault(key, ev)
    problems = []
    for key, sev in sends.items():
        rev = recvs.get(key)
        if rev is None or rev.get("pid") == sev.get("pid"):
            continue
        s_start = float(sev["ts"])
        r_end = float(rev["ts"]) + max(0.0, float(rev.get("dur", 0.0)))
        if r_end < s_start:
            problems.append(
                f"flow {key[1]}: recv on rank {rev.get('pid')} ends "
                f"{s_start - r_end:.1f}us before its send on rank "
                f"{sev.get('pid')} even started — clock correction "
                f"failed to restore causality")
    return problems


def validate(doc: dict) -> list[str]:
    """Chrome-trace shape checks; returns a list of problems (empty =
    valid).  What the CI smoke job runs against the merged artifact."""
    problems = []
    if doc.get("displayTimeUnit") not in ("ms", "ns"):
        problems.append("displayTimeUnit must be 'ms' or 'ns'")
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return problems + ["traceEvents must be a list"]
    last_ts = None
    for i, ev in enumerate(events):
        ph = ev.get("ph")
        # full Chrome phase alphabet: duration, complete, instant,
        # counter, async, flow, sample, object, metadata, memory, mark
        if ph not in ("B", "E", "X", "i", "I", "C", "b", "e", "n",
                      "s", "t", "f", "P", "N", "O", "D", "M", "v", "V",
                      "R"):
            problems.append(f"event {i}: unknown ph {ph!r}")
            continue
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"event {i}: bad ts {ts!r}")
            continue
        if last_ts is not None and ts < last_ts:
            problems.append(f"event {i}: ts not monotonic "
                            f"({ts} < {last_ts})")
        last_ts = ts
        if ph == "X" and not isinstance(ev.get("dur"), (int, float)):
            problems.append(f"event {i}: complete span without dur")
        for key in ("name", "pid", "tid"):
            if key not in ev:
                problems.append(f"event {i}: missing {key}")
    return problems


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        description="Merge per-rank ompi_tpu flight-recorder dumps into "
                    "one Chrome/Perfetto trace JSON.")
    p.add_argument("inputs", nargs="*", help="per-rank trace dump files")
    p.add_argument("--dir", default=None,
                   help="scan this directory for ompi_tpu_trace_*.json "
                        "instead of naming files")
    p.add_argument("--jobid", type=int, default=None,
                   help="with --dir: only this job's dumps")
    p.add_argument("-o", "--output", default="ompi_tpu_trace_merged.json")
    p.add_argument("--offsets", default=None, metavar="FILE",
                   help="JSON map rank → measured monotonic offset to "
                        "the root clock in ns (the clock-sync plane's "
                        "rank_clock_to_root_ns values); applied to each "
                        "rank's timestamps at merge")
    p.add_argument("--validate", action="store_true",
                   help="only validate the merged document; nonzero exit "
                        "on schema problems")
    p.add_argument("--onto", default=None, metavar="PROFILE",
                   help="lay the dumps onto this torch.profiler Chrome "
                        "trace's clock (beside its kernels) instead of "
                        "merging them on their own")
    p.add_argument("--validate-file", default=None, metavar="FILE",
                   help="validate an EXISTING merged trace JSON (e.g. a "
                        "saved /timeline response) instead of merging; "
                        "nonzero exit on schema or causality problems")
    args = p.parse_args(argv)

    if args.validate_file:
        with open(args.validate_file, encoding="utf-8") as f:
            doc = json.load(f)
        problems = validate(doc)
        problems += causality_problems(doc.get("traceEvents") or [])
        problems += (doc.get("otherData") or {}).get(
            "causality_problems") or []
        for pr in problems:
            print(f"trace_export: INVALID: {pr}", file=sys.stderr)
        if problems:
            return 1
        n = len(doc.get("traceEvents") or [])
        n_flows = sum(1 for e in doc.get("traceEvents") or []
                      if e.get("ph") == "s")
        print(f"trace_export: {args.validate_file} valid "
              f"({n} events, {n_flows} flow arrows)")
        return 0

    paths = list(args.inputs)
    if args.dir:
        paths += sorted(glob.glob(os.path.join(args.dir,
                                               dump_glob(args.jobid))))
    # dedupe (order-preserving): positional inputs may overlap --dir's
    # glob, and a double-loaded rank would double every event
    paths = list(dict.fromkeys(os.path.abspath(p) for p in paths))
    if not paths:
        print("trace_export: no input dumps found", file=sys.stderr)
        return 2

    if args.onto:
        with open(args.onto, encoding="utf-8") as f:
            doc = onto_profile(json.load(f), paths)
        with open(args.output, "w", encoding="utf-8") as f:
            json.dump(doc, f)
        print(f"trace_export: wrote {args.output} — {len(paths)} dump(s) "
              f"onto {args.onto}")
        return 0

    offsets = None
    if args.offsets:
        with open(args.offsets, encoding="utf-8") as f:
            raw = json.load(f)
        offsets = {int(r): float(v) for r, v in raw.items()
                   if v is not None}

    doc = merge(paths, offsets=offsets)
    problems = validate(doc)
    problems += doc["otherData"].get("causality_problems") or []
    if args.validate:
        for pr in problems:
            print(f"trace_export: INVALID: {pr}", file=sys.stderr)
        if problems:
            return 1
        print(f"trace_export: {len(paths)} dump(s) valid "
              f"({len(doc['traceEvents'])} events)")
        return 0
    # merge mode: schema problems are warnings — a post-mortem merge
    # must never throw away a recoverable trace
    for pr in problems:
        print(f"trace_export: WARNING: {pr}", file=sys.stderr)
    with open(args.output, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    n_spans = sum(1 for e in doc["traceEvents"] if e.get("ph") == "X")
    n_flows = sum(1 for e in doc["traceEvents"] if e.get("ph") == "s")
    cats = sorted({e.get("cat") for e in doc["traceEvents"]
                   if e.get("cat")})
    print(f"trace_export: wrote {args.output} — "
          f"{len(doc['traceEvents'])} events ({n_spans} spans, "
          f"{n_flows} flow arrows) from "
          f"{len(paths)} rank(s); categories: {', '.join(cats)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
