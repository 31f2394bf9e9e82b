"""hang_doctor — "my job is stuck: which rank, in which collective,
waiting on whom?" answered postmortem (the port's copy of the repo's
``tools/hang_doctor.py``, its offline mode).

It reads the per-rank crash trace dumps
(``ompi_tpu_trace_<jobid>_rank<r>.json`` — their ``otherData.collrec``
recorder tails) and runs the hang doctor's analyzer, so the postmortem
works from artifacts alone:

    python -m ompi_tpu_torch.tools.hang_doctor --dir $TMPDIR --jobid 7

``--expect kind[:rank]`` turns the run into an assertion (CI / chaos
drivers): exit 0 only when the verdict matches.  The live mode
(``--uri``, a capture through the DVM's ``/doctor`` endpoint) comes with
the DVM, ROADMAP.md Queue 1 item 6.15.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from ompi_tpu_torch.runtime import doctor
from ompi_tpu_torch.tools import trace_export  # owns the dump file pattern

_RANK_RE = trace_export._RANK_RE


# ---------------------------------------------------------------------------
# offline mode (crash trace dumps)
# ---------------------------------------------------------------------------

def _cur_from_tail(rank: int, tail: list) -> dict | None:
    """Reconstruct the recorder head from a dump's record tail: the
    newest post and whether its (cid, seq) ever completed."""
    posts: list[tuple[int, int, str]] = []
    done_keys = set()
    err_keys = set()
    for rec in tail:
        try:
            _ts, r, cid, seq, kind, phase = rec[:6]
        except (TypeError, ValueError):
            continue
        if int(r) != rank:
            continue
        if phase == "post":
            posts.append((int(cid), int(seq), str(kind)))
        elif phase == "done":
            done_keys.add((int(cid), int(seq)))
        elif phase == "err":
            # an err-closed op (coll_shm_timeout, revoke) is a FAILED
            # wait, not a completion — its wait-for evidence stands
            err_keys.add((int(cid), int(seq)))
    if not posts:
        return None
    # the wedged op is the newest UNCLOSED post — NOT simply the newest
    # post: a composed outer collective's nested sub-dispatch may have
    # completed after it (the live path resolves this via the recorder
    # stack; offline must re-derive it).  Failing that, the newest
    # err-closed post (a failed wait still carries its edge), else the
    # newest post outright.
    closed = done_keys | err_keys
    pick = next((p for p in reversed(posts)
                 if (p[0], p[1]) not in closed), None)
    if pick is None:
        pick = next((p for p in reversed(posts)
                     if (p[0], p[1]) in err_keys), posts[-1])
    cid, seq, kind = pick
    cur = {"cid": cid, "seq": seq, "kind": kind,
           "done": (cid, seq) in done_keys}
    if (cid, seq) in err_keys:
        cur["err"] = True
    return cur


def offline_captures(paths: list[str]) -> list[dict]:
    captures = []
    for path in paths:
        try:
            with open(path, encoding="utf-8") as f:
                dump = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"hang_doctor: skipping {path}: {e}", file=sys.stderr)
            continue
        other = (dump.get("otherData") or {}) if isinstance(dump, dict) \
            else {}
        rank = other.get("rank")
        if rank is None:
            m = _RANK_RE.search(os.path.basename(path))
            rank = int(m.group(2)) if m else -1
        tail = other.get("collrec") or []
        cap = {"rank": int(rank), "collrec": tail,
               "stuck": (other.get("counters") or {})
               .get("coll_stuck_events_total", 0)}
        cur = _cur_from_tail(int(rank), tail)
        if cur is not None:
            cap["cur"] = cur
        captures.append(cap)
    return captures


def offline_doc(dump_dir: str, jobid: int | None) -> dict:
    pat = trace_export.dump_glob(jobid)
    paths = sorted(glob.glob(os.path.join(dump_dir, pat)))
    if not paths:
        raise SystemExit(f"hang_doctor: no trace dumps matching {pat} "
                         f"under {dump_dir}")
    jobids = {m.group(1) for p in paths
              for m in (_RANK_RE.search(os.path.basename(p)),) if m}
    if jobid is None and len(jobids) > 1:
        print(f"hang_doctor: WARNING: dumps from several jobs "
              f"{sorted(jobids)} — pass --jobid", file=sys.stderr)
    doc = doctor.analyze(offline_captures(paths))
    doc["trigger"] = "offline"
    doc["dumps"] = [os.path.basename(p) for p in paths]
    return doc


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------

def render(doc: dict) -> str:
    v = doc.get("verdict") or {}
    kind = v.get("kind", "?")
    lines = [f"hang doctor verdict: {kind.upper()}"
             + (f" — rank {v['rank']}" if "rank" in v else "")]
    if v.get("detail"):
        lines.append(f"  {v['detail']}")
    if "op_seq" in v or "in" in v:
        lines.append(f"  in: {v.get('in', v.get('kinds'))}"
                     f"#{v.get('op_seq')} (cid {v.get('cid')})")
    if v.get("kinds"):
        lines.append("  kinds by rank: " + ", ".join(
            f"{r}={k}" for r, k in sorted(v["kinds"].items())))
    if v.get("cycle"):
        lines.append("  cycle: " + " -> ".join(map(str, v["cycle"])))
    if v.get("waiters"):
        lines.append("  waiters: " + ", ".join(
            f"{r}->{t}" for r, t in sorted(v["waiters"].items()) if t))
    if v.get("proc"):
        lines.append(f"  /proc evidence: {v['proc']}")
    stack = v.get("stack")
    if stack:
        lines.append("  stack of the named rank:")
        lines += ["    " + ln for ln in stack.strip().splitlines()[-14:]]
    no_resp = doc.get("no_response")
    if no_resp:
        lines.append(f"  no response from ranks {no_resp} "
                     f"(frozen pids cannot answer)")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dir", required=True,
                   help="directory holding per-rank "
                        "ompi_tpu_trace_*_rank*.json crash dumps")
    p.add_argument("--jobid", type=int, default=None,
                   help="with --dir: only this job's dumps")
    p.add_argument("--json", action="store_true",
                   help="print the raw verdict document")
    p.add_argument("--expect", default=None, metavar="KIND[:RANK]",
                   help="assert the verdict (e.g. straggler:2 or "
                        "mismatch); nonzero exit on a miss")
    args = p.parse_args(argv)

    doc = offline_doc(args.dir, args.jobid)
    print(json.dumps(doc, indent=1) if args.json else render(doc))
    if args.expect:
        want_kind, _, want_rank = args.expect.partition(":")
        v = doc.get("verdict") or {}
        if v.get("kind") != want_kind:
            print(f"hang_doctor: EXPECT FAILED: verdict "
                  f"{v.get('kind')!r} != {want_kind!r}", file=sys.stderr)
            return 1
        if want_rank and int(v.get("rank", -1)) != int(want_rank):
            print(f"hang_doctor: EXPECT FAILED: rank "
                  f"{v.get('rank')} != {want_rank}", file=sys.stderr)
            return 1
        print(f"hang_doctor: expectation {args.expect!r} met")
    return 0


if __name__ == "__main__":
    sys.exit(main())
