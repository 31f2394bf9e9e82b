"""ompi-lint — project-invariant static analysis for the ompi_tpu_torch tree.

The stack spans five concurrency planes (PML reader threads, gossip
beats, daemon heartbeats, arena waits, launcher reapers) and several
cross-file name registries (MCA config vars, pvar counters, rml tags,
FT frame ops, PMIx RPCs).  Most of the bugs review keeps catching are
*mechanically checkable*: an RPC issued from a reader thread, a frame
``op`` with no dispatch branch, a config var read that was never
registered, a lock taken under another lock in the opposite order.
This package is the tooling that checks them, so protocol invariants
are enforced by CI instead of by reading code (the same discipline the
reference's memchecker/valgrind integration carries for opal).

Two checker families:

- **Registry/protocol exhaustiveness** (cross-file symbol-table
  passes): ``var-registry``, ``pvar-spec``, ``rml-tag``, ``frame-op``,
  ``pmix-rpc``.
- **Thread-context safety** (call-graph reachability):
  ``reader-thread`` (blocking calls on transport reader paths),
  ``lock-order`` (lock-acquisition cycles + RPC/sleep under lock).

Run ``python -m ompi_tpu_torch.tools.lint`` from the repo root.  Each checker owns an
exit-code bit (see ``ompi_tpu_torch.tools.lint.checkers.ALL``); the driver exits with
the OR of every failing checker, so CI logs show *which* invariant
broke.  Findings can be grandfathered into ``ompi_tpu_torch/tools/lint/baseline.json``
(see ``--write-baseline``); the baseline is meant to stay empty or
carry a justification per entry.

Suppression: a finding on a line ending in ``# lint: <rule>-ok`` is
intentional and skipped (e.g. ``# lint: reader-ok`` on a call a reader
thread is explicitly allowed to make).
"""

from __future__ import annotations

__all__ = ["main"]


def main(argv: list[str] | None = None) -> int:
    from ompi_tpu_torch.tools.lint.driver import run

    return run(argv)
