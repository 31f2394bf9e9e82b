"""killorphans — find (and optionally reap) orphaned ompi_tpu processes
(the port's copy of the repo's ``tools/killorphans.py``, which
``chaos_soak --guard`` runs).

The bench-poisoning failure mode that bit twice (CHANGES.md, PRs 9-10):
a dead session leaves PPID-1 ranks/orteds/chaos children spinning —
dozens of them eating most of the box — and every later benchmark or
tier-1 run silently measures scheduler contention instead of the code.
Both incidents were diagnosed by hand with ``ps -eo pid,ppid,etime``;
this tool makes the check mechanical:

- ``python -m ompi_tpu_torch.tools.killorphans``            list suspects (exit 1 if any)
- ``python -m ompi_tpu_torch.tools.killorphans --kill``     SIGKILL suspects
- ``python -m ompi_tpu_torch.tools.killorphans --min-age 600``  age floor in seconds

A *suspect* is a process that (a) has been re-parented to init
(PPID 1 — its launching session is gone), (b) has an ompi_tpu-shaped
command line (the patterns below), (c) is older than ``--min-age``
(default 1 h: a legitimately daemonized standing DVM is excluded by
pattern, but the age floor keeps a just-started run safe regardless),
and (d) is not this process or an ancestor of it.

``preflight()`` is the library form: tools that measure (coll_bench,
chaos_soak) call it under ``--guard`` to refuse to bench a poisoned
box — orphans ADD latency noise, so a guard failure means the numbers
would have been garbage, not merely slow.
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time
from typing import Optional

#: command-line fragments that mark a process as OURS — anchored to
#: this repo's actual entry points ("ompi_tpu" rides the module path
#: of every rank/orted we spawn; the tool scripts match by file name),
#: NOT loose tokens: a bare "orted" would reap a genuine Open MPI
#: daemon, and a bare "coll_bench" would match `tail -f
#: coll_bench.log`.  The standing DVM (tpurun --dvm-start) is
#: deliberately daemonized and EXCLUDED — killing a live pool because
#: its launcher exited would be a bug.
PATTERNS = ("ompi_tpu", "tpurun", "chaos_soak", "coll_bench.py")
EXCLUDE = ("--dvm-start", "killorphans")

#: default age floor: an hours-old PPID-1 rank is debris, a
#: seconds-old one may be a worker mid-handoff
DEFAULT_MIN_AGE_S = 3600.0


def _my_ancestry() -> set:
    """This process and its ancestors — never suspects (the guard may
    itself run under a tool whose name matches the patterns)."""
    pids = set()
    pid = os.getpid()
    for _ in range(32):
        pids.add(pid)
        try:
            with open(f"/proc/{pid}/stat", encoding="utf-8",
                      errors="replace") as f:
                # field 4 (after the parenthesized comm, which may
                # contain spaces) is ppid
                stat = f.read()
            pid = int(stat.rsplit(")", 1)[1].split()[1])
        except (OSError, IndexError, ValueError):
            break
        if pid <= 1:
            break
    return pids


def find_orphans(min_age_s: float = DEFAULT_MIN_AGE_S) -> list[dict]:
    """PPID-1 ompi_tpu-shaped processes older than ``min_age_s``:
    ``[{pid, age_s, args}, ...]``, oldest first."""
    try:
        out = subprocess.run(
            ["ps", "-eo", "pid=,ppid=,etimes=,args="],
            capture_output=True, text=True, timeout=10).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    mine = _my_ancestry()
    orphans = []
    for line in out.splitlines():
        fields = line.split(None, 3)
        if len(fields) < 4:
            continue
        try:
            pid, ppid, age = int(fields[0]), int(fields[1]), int(fields[2])
        except ValueError:
            continue
        args = fields[3]
        if (ppid != 1 or pid in mine or age < min_age_s
                or not any(p in args for p in PATTERNS)
                or any(e in args for e in EXCLUDE)):
            continue
        orphans.append({"pid": pid, "age_s": age, "args": args[:160]})
    orphans.sort(key=lambda o: -o["age_s"])
    return orphans


def kill_orphans(orphans: list[dict]) -> int:
    """SIGKILL every suspect; returns how many signals landed."""
    n = 0
    for o in orphans:
        try:
            os.kill(o["pid"], signal.SIGKILL)
            n += 1
        except (ProcessLookupError, PermissionError):
            pass
    return n


def preflight(tool: str, kill: bool = False,
              min_age_s: float = DEFAULT_MIN_AGE_S,
              out=sys.stderr) -> bool:
    """Bench-guard: True ⇒ the box is clean (or was just cleaned).
    False ⇒ orphans are present and were NOT killed — the caller
    should refuse to produce numbers (they would measure the orphans'
    scheduler noise, not the code)."""
    orphans = find_orphans(min_age_s)
    if not orphans:
        return True
    print(f"{tool}: {len(orphans)} orphaned ompi_tpu process(es) "
          f"(PPID 1, >{min_age_s / 3600:.1f}h old) are eating this box:",
          file=out)
    for o in orphans:
        print(f"  pid {o['pid']:>7}  age {o['age_s'] / 3600:6.1f}h  "
              f"{o['args']}", file=out)
    if kill:
        n = kill_orphans(orphans)
        print(f"{tool}: killed {n}/{len(orphans)} "
              f"(guard --kill)", file=out)
        time.sleep(0.2)   # give the scheduler a beat to reap
        return True
    print(f"{tool}: refusing to bench a poisoned box — run "
          f"`python -m ompi_tpu_torch.tools.killorphans --kill` (or pass the tool's "
          f"--guard-kill) first", file=out)
    return False


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        description="find/kill hours-old PPID-1 orphaned ompi_tpu "
        "ranks and orteds (the bench-poisoning debris dead sessions "
        "leave behind)")
    ap.add_argument("--kill", action="store_true",
                    help="SIGKILL the suspects instead of only listing")
    ap.add_argument("--min-age", type=float, default=DEFAULT_MIN_AGE_S,
                    help="age floor in seconds (default 3600)")
    args = ap.parse_args(argv)

    orphans = find_orphans(args.min_age)
    if not orphans:
        print("no orphaned ompi_tpu processes")
        return 0
    for o in orphans:
        print(f"pid {o['pid']:>7}  age {o['age_s'] / 3600:6.1f}h  "
              f"{o['args']}")
    if args.kill:
        n = kill_orphans(orphans)
        print(f"killed {n}/{len(orphans)}")
        return 0
    print(f"{len(orphans)} suspect(s); re-run with --kill to reap")
    return 1


if __name__ == "__main__":
    sys.exit(main())
