"""Finding — one reported invariant violation.

A finding's ``fingerprint`` is deliberately line-number-free: baselines
must survive unrelated edits above the finding, so the identity is
(checker, rule, symbol) — the *what*, not the *where*.  The location is
carried separately for display.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Finding:
    checker: str          # e.g. "var-registry"
    rule: str             # e.g. "unregistered-read"
    symbol: str           # the offending name (var/tag/op/rpc/lock path)
    message: str          # human-readable one-liner
    path: str = ""        # repo-relative file
    line: int = 0

    @property
    def fingerprint(self) -> str:
        return f"{self.checker}:{self.rule}:{self.symbol}"

    def render(self) -> str:
        loc = f"{self.path}:{self.line}: " if self.path else ""
        return f"{loc}[{self.checker}/{self.rule}] {self.message}"
