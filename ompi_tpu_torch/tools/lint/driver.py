"""The ompi-lint driver — build the index once, run every checker,
apply the baseline, exit with the OR of failing checkers' bits.

Usage::

    python -m ompi_tpu_torch.tools.lint         # full tree, all checkers
    python -m ompi_tpu_torch.tools.lint --checker frame-op --checker pmix-rpc
    python -m ompi_tpu_torch.tools.lint --root tests/fixtures/lint/bad_frame_op
    python -m ompi_tpu_torch.tools.lint --write-baseline  # grandfather findings
    python -m ompi_tpu_torch.tools.lint --list  # checker catalogue + bits

The mypy gate (``--strict`` over the typed core surface, see
``STRICT_SURFACE``) runs when mypy is importable and is skipped with a
note otherwise — mypy is an optional dependency, installed by the
lint CI job.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

from ompi_tpu_torch.tools.lint import checkers
from ompi_tpu_torch.tools.lint.baseline import DEFAULT_PATH, Baseline
from ompi_tpu_torch.tools.lint.finding import Finding
from ompi_tpu_torch.tools.lint.index import ProjectIndex

#: packages indexed on a full-tree run (repo-root relative)
DEFAULT_PACKAGES = ["ompi_tpu_torch"]
#: never index: the linter itself (its fixtures are deliberately bad)
DEFAULT_EXCLUDE = ["ompi_tpu_torch/tools/lint"]

#: the mypy --strict surface: the checker-indexed core the lint package
#: itself leans on (config-var registry, MCA selection, pvar specs)
STRICT_SURFACE = [
    "ompi_tpu_torch/core/config.py",
    "ompi_tpu_torch/core/mca.py",
    "ompi_tpu_torch/mpi/mpit.py",
    "ompi_tpu_torch/mpi/trace.py",
]


def run(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ompi_tpu_torch.tools.lint",
        description="project-invariant static analysis for ompi_tpu_torch")
    ap.add_argument("--root", default=None,
                    help="tree root to lint (default: repo root; "
                    "point at a fixture tree to lint it instead)")
    ap.add_argument("--checker", action="append", dest="only",
                    metavar="NAME", help="run only these checkers "
                    "(repeatable; default: all)")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline file (default {DEFAULT_PATH})")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline (report everything)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write current findings as the new baseline")
    ap.add_argument("--no-mypy", action="store_true",
                    help="skip the mypy --strict gate")
    ap.add_argument("--list", action="store_true",
                    help="list checkers + exit-code bits and exit")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)

    if args.write_baseline and args.root and not args.baseline:
        # a fixture-tree run must not overwrite the repo's baseline
        ap.error("--write-baseline with --root needs an explicit "
                 "--baseline (refusing to overwrite the repo default)")

    if args.list:
        for name, (bit, fn) in sorted(checkers.ALL.items(),
                                      key=lambda kv: kv[1][0]):
            doc = (sys.modules[fn.__module__].__doc__ or "").strip()
            head = doc.splitlines()[0] if doc else ""
            print(f"  {name:<14} bit {bit:<3} {head}")
        print(f"  {'mypy-strict':<14} bit {checkers.MYPY_BIT:<3} "
              f"mypy --strict over {len(STRICT_SURFACE)} core modules")
        return 0

    repo_root = args.root or _repo_root()
    full_tree = args.root is None
    index = ProjectIndex.build(
        repo_root,
        packages=DEFAULT_PACKAGES if full_tree else None,
        exclude=DEFAULT_EXCLUDE if full_tree else None)

    selected = args.only or sorted(checkers.ALL)
    unknown = [n for n in selected if n not in checkers.ALL]
    if unknown:
        ap.error(f"unknown checker(s): {unknown}; see --list")

    all_findings: list[Finding] = []
    per_checker: dict[str, list[Finding]] = {}
    for name in selected:
        _bit, fn = checkers.ALL[name]
        got = fn(index)
        per_checker[name] = got
        all_findings += got

    if args.write_baseline:
        path = args.baseline or DEFAULT_PATH
        # merge-write: existing justifications survive, and a --checker
        # subset run cannot delete other checkers' entries
        Baseline.write(path, all_findings,
                       keep=Baseline.load(path).entries,
                       ran=set(selected))
        print(f"wrote {len(all_findings)} finding(s) to {path}")
        return 0

    # a --root (fixture-tree) run must not read the REPO's baseline
    # either: its entries could grandfather identical fingerprints in
    # the fixture and its justified entries would all read as stale
    if args.no_baseline or (args.root and not args.baseline):
        baseline = Baseline({})
    else:
        baseline = Baseline.load(args.baseline)

    exit_code = 0
    total_new = total_old = 0
    for name in selected:
        bit, _fn = checkers.ALL[name]
        new, old, _stale = baseline.split(per_checker[name])
        total_new += len(new)
        total_old += len(old)
        for f in new:
            print(f.render())
        if not args.quiet:
            for f in old:
                print(f"(grandfathered) {f.render()}")
        if new:
            exit_code |= bit

    # staleness is a property of the WHOLE run: an entry is stale only
    # when no checker produced it — so it is checked globally, and only
    # when every checker ran (a --checker subset would false-flag the
    # other checkers' grandfathered entries)
    if not args.only:
        _new, _old, stale = baseline.split(all_findings)
        all_bits = 0
        for _name, (bit, _fn) in checkers.ALL.items():
            all_bits |= bit
        for fp in stale:
            owner = fp.split(":", 1)[0]
            print(f"stale baseline entry {fp!r}: no current finding "
                  f"matches — remove it with the fix")
            if owner in checkers.ALL:
                exit_code |= checkers.ALL[owner][0]
            else:
                # renamed/typo'd checker prefix: attributing it to any
                # one family would lie — raise every bit and let the
                # printed fingerprint do the naming
                exit_code |= all_bits

    mypy_note = ""
    # the mypy gate belongs to FULL runs only, like the stale check — a
    # --checker subset must not fail on a family it did not select
    if not args.no_mypy and full_tree and not args.only:
        ok, mypy_note = _run_mypy(repo_root)
        if not ok:
            exit_code |= checkers.MYPY_BIT

    if not args.quiet or exit_code:
        n_ck = len(selected)
        print(f"ompi-lint: {n_ck} checker(s), {total_new} new finding(s)"
              f", {total_old} grandfathered"
              + (f"; {mypy_note}" if mypy_note else ""))
    return exit_code


def _repo_root() -> str:
    # ompi_tpu_torch/tools/lint/driver.py → the repo root is three dirs
    # up from lint/
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))


def _run_mypy(repo_root: str) -> tuple[bool, str]:
    """mypy --strict over STRICT_SURFACE.  Skipped (ok=True) when mypy
    is not installed (an optional dependency; the lint CI job installs
    it)."""
    try:
        import mypy  # noqa: F401
    except ImportError:
        return True, "mypy not installed — strict gate skipped"
    cfg = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "mypy.ini")
    cmd = [sys.executable, "-m", "mypy", "--config-file", cfg,
           *STRICT_SURFACE]
    proc = subprocess.run(cmd, cwd=repo_root, capture_output=True,
                          text=True)
    if proc.returncode != 0:
        sys.stdout.write(proc.stdout)
        sys.stderr.write(proc.stderr)
        return False, f"mypy --strict FAILED over {len(STRICT_SURFACE)} modules"
    return True, f"mypy --strict clean over {len(STRICT_SURFACE)} modules"
