"""Live cross-rank timeline merge — skew-corrected Chrome traces (the
port's copy of the JAX package's ``runtime/timeline.py``, whole: the
merge, its flow edges and ``causality_problems``; the orteds measure
their clock offsets (``runtime/clocksync.py``) and answer a standing
DVM's TAG_TIMELINE capture, whose ``/timeline`` endpoint serves the
merge (``runtime/dvm.py``); ``tools/timeline.py`` reads it with
``--uri`` or merges crash dumps with ``--dir``).

≈ the post-mortem merge in tools/trace_export.py, lifted into the
control plane: the HNP's ``/timeline`` endpoint xcasts TAG_TIMELINE,
every orted pulls a bounded flight-recorder tail from each live rank
(runtime/doctor.py's "tl" query) and stamps it with the daemon's
MEASURED offset-to-root (runtime/clocksync.py), and this module folds
the replies into one Perfetto-loadable document.

Two jobs post-mortem merges cannot do:

- **Measured skew correction.**  Dump merges only have each rank's
  wall-vs-monotonic anchor; a live capture carries the clock-sync
  plane's pingpong-measured monotonic offsets, so cross-host event
  ordering is correct to ~rtt/2 instead of NTP-grade seconds.  When
  any capture lacks a measured offset (sync disabled, window still
  filling) the merge degrades to the wall anchors and says so in
  ``otherData.clock_domain``.
- **Causal flow edges.**  Send→recv arrows from the flow ids the PML
  stamps into match headers, round arrows chaining every rank's span
  of one collective (same ``(cid, seq)``), and RML envelope arrows
  from the ``(trace_id, span_id)`` pair OOB messages carry.

Self-contained by design: the DVM imports this at HNP runtime where
``ompi_tpu_torch.mpi`` may never load (no job ran yet), and tests feed it
synthetic captures — so it touches neither the MPI layer nor tools/.
"""

from __future__ import annotations

from typing import Any, Optional

__all__ = ["merge_captures", "flow_events", "causality_problems"]

# keep in sync with ompi_tpu_torch.mpi.trace.CATEGORIES (see module docstring
# for why this is a copy, not an import)
CATEGORIES = ("pml", "btl", "coll", "osc", "io", "ckpt", "datatype",
              "runtime", "errmgr")

#: span names carrying ``args.fl`` — the send/recv halves of one
#: message (keep in sync with tools/trace_export.py)
FLOW_SEND_SPANS = ("eager_send", "rndv_send")
FLOW_RECV_SPANS = ("eager_recv", "rndv_recv")

#: instant names carrying ``args.tc`` — the two ends of one RML envelope
RML_SEND_NAME = "rml_send"
RML_RECV_NAME = "rml_recv"


def _span_end(ev: dict) -> float:
    """A flow endpoint must land INSIDE its span (Chrome binds flows to
    the slice enclosing the ts), so anchors ride just before span end."""
    return float(ev.get("ts", 0.0)) + max(0.0, float(ev.get("dur", 0.0)))


def flow_events(events: list[dict]) -> list[dict]:
    """Causal arrows for a merged event list (events must already carry
    their final ``pid``/``ts``):

    - p2p: ``{eager,rndv}_send`` → ``{eager,rndv}_recv`` paired by
      ``args.fl`` (scoped by ``args.tc`` when the header carried the
      trace id — flow ids from different jobs must not collide);
    - collective rounds: every rank's ``coll``-category span of one
      ``(cid, seq)`` chained rank-to-rank in time order (``s``/``t``/
      ``f``) — the arrow path makes the straggler visible;
    - RML envelopes: ``rml_send`` → ``rml_recv`` instants paired by the
      ``(trace_id, span_id)`` stamp.
    """
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
                key = (args.get("tc"), fl)
                if name in FLOW_SEND_SPANS:
                    sends.setdefault(key, ev)
                elif name in FLOW_RECV_SPANS:
                    recvs.setdefault(key, ev)
            if ev.get("cat") == "coll" and "seq" in args and "cid" in args:
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
            continue   # no recv half, or a self-send — no arrow
        # s anchors at the send span's START: the transfer happens
        # somewhere inside the send call, and a fast receiver can
        # legitimately finish before the sender's span closes
        s_ts, f_ts = float(sev.get("ts", 0.0)), _span_end(rev)
        if f_ts < s_ts:
            # recv ends before the send even started: residual skew,
            # no binding placement exists (see causality_problems —
            # the merge reports these)
            continue
        tc, fl = key
        fid = f"{tc}:{fl}" if tc is not None else fl
        common = {"cat": "flow", "name": "msg", "id": fid}
        out.append({**common, "ph": "s", "ts": s_ts,
                    "pid": sev["pid"], "tid": sev.get("tid", 0)})
        out.append({**common, "ph": "f", "bp": "e", "ts": f_ts,
                    "pid": rev["pid"], "tid": rev.get("tid", 0)})
    for (cid, seq), group in colls.items():
        # one span per pid (a rank re-entering the same (cid, seq) is a
        # recorder artifact — keep the earliest), chained in end order
        by_pid: dict = {}
        for ev in group:
            cur = by_pid.get(ev.get("pid"))
            if cur is None or float(ev.get("ts", 0)) < float(
                    cur.get("ts", 0)):
                by_pid[ev.get("pid")] = ev
        chain = sorted(by_pid.values(), key=_span_end)
        if len(chain) < 2:
            continue   # single-rank round: nothing to stitch
        common = {"cat": "flow", "name": "coll_round",
                  "id": f"coll:{cid}:{seq}"}
        for i, ev in enumerate(chain):
            ph = "s" if i == 0 else ("f" if i == len(chain) - 1 else "t")
            step = {**common, "ph": ph, "ts": _span_end(ev),
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
    """Post-correction sanity: a recv span that ENDS before its matching
    send span even STARTED means the applied offsets failed to restore
    causality (data cannot finish arriving before the send call began;
    comparing span ENDS would false-positive on every fast receiver
    outpacing a slow sender).  Returns one line per violated pair —
    what the merge surfaces and the exporter's validator asserts
    empty."""
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
        s_start = float(sev.get("ts", 0.0))
        r_end = _span_end(rev)
        if r_end < s_start:
            problems.append(
                f"flow {key[1]}: recv on rank {rev.get('pid')} ends "
                f"{s_start - r_end:.1f}us before its send on rank "
                f"{sev.get('pid')} even started — clock correction "
                f"failed to restore causality")
    return problems


def merge_captures(captures: list[dict],
                   jobid: Optional[int] = None) -> dict[str, Any]:
    """Fold TAG_TIMELINE_REPLY capture rows (trace.timeline_capture
    dicts, each stamped with the serving daemon's ``clock_to_root_ns``)
    into one Chrome trace document.

    Clock domain: when EVERY responding capture carries a measured
    offset, all timestamps shift onto the root daemon's monotonic
    clock (``clock_domain: "root_monotonic"``); otherwise every rank
    falls back to its wall anchor (``clock_domain: "wall"``) — mixing
    the two axes would fabricate ordering.
    """
    rows = [c for c in captures if isinstance(c, dict)]
    live = [c for c in rows if not c.get("no_response")]
    measured = bool(live) and all(
        isinstance(c.get("clock_to_root_ns"), (int, float))
        for c in live)
    domain = "root_monotonic" if measured else "wall"
    all_events: list[dict] = []
    meta: list[dict] = []
    per_rank: dict[int, dict] = {}
    trace_ids = set()
    for cap in sorted(rows, key=lambda c: int(c.get("rank", -1))):
        rank = int(cap.get("rank", -1))
        info = {k: cap.get(k) for k in
                ("events_total", "dropped", "capacity",
                 "clock_to_root_ns", "clock_offset_ns", "truncated",
                 "counters", "collrec")}
        if cap.get("no_response"):
            info["no_response"] = True
            per_rank[rank] = info
            continue
        per_rank[rank] = info
        if cap.get("trace_id"):
            trace_ids.add(cap["trace_id"])
        off_ns = (cap.get("clock_to_root_ns") if measured
                  else cap.get("clock_offset_ns"))
        shift_us = float(off_ns or 0) / 1000.0
        meta.append({"ph": "M", "name": "process_name", "pid": rank,
                     "tid": 0, "args": {"name": f"rank {rank}"}})
        tids = set()
        for ev in cap.get("events") or []:
            ev = dict(ev)
            ev["pid"] = rank
            if "ts" in ev:
                ev["ts"] = float(ev["ts"]) + shift_us
            all_events.append(ev)
            tids.add(int(ev.get("tid", 0)))
        for tid in sorted(tids):
            name = CATEGORIES[tid] if tid < len(CATEGORIES) else "other"
            meta.append({"ph": "M", "name": "thread_name", "pid": rank,
                         "tid": tid, "args": {"name": name}})
    problems = causality_problems(all_events)
    all_events.extend(flow_events(all_events))
    if all_events:
        # Perfetto wants a non-negative, roughly-sorted axis; measured
        # offsets can legally shift early events below zero
        base = min(float(e.get("ts", 0.0)) for e in all_events)
        if base < 0:
            for ev in all_events:
                ev["ts"] = float(ev.get("ts", 0.0)) - base
    all_events.sort(key=lambda e: float(e.get("ts", 0.0)))
    n_flows = sum(1 for e in all_events if e.get("ph") == "s")
    return {
        "displayTimeUnit": "ns",
        "otherData": {
            "jobid": jobid,
            "trace_id": (sorted(trace_ids)[0] if trace_ids else None),
            "clock_domain": domain,
            "ranks": sorted(per_rank),
            "flow_edges": n_flows,
            "causality_problems": problems,
            "per_rank": {str(r): v for r, v in sorted(per_rank.items())},
        },
        "traceEvents": meta + all_events,
    }
