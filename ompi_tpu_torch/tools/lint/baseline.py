"""Baseline file — grandfathered findings.

Format (``ompi_tpu_torch/tools/lint/baseline.json``)::

    {
      "findings": [
        {"fingerprint": "lock-order:cycle:a.B._lock->c.D._lock",
         "justification": "why this one is accepted"}
      ]
    }

A finding whose fingerprint appears here is reported as *grandfathered*
and does not fail the run.  Entries are expected to carry a
justification — an empty baseline is the goal state; a justified one is
the escape hatch for accepted-risk findings the fix would regress.
Stale entries (fingerprints no current finding produces) fail the run:
a fixed finding must leave the baseline with the fix, or the file rots
into a blanket waiver.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Optional

from ompi_tpu_torch.tools.lint.finding import Finding

DEFAULT_PATH = os.path.join(os.path.dirname(__file__), "baseline.json")


class Baseline:
    def __init__(self, entries: dict[str, str]) -> None:
        #: fingerprint → justification
        self.entries = entries

    @classmethod
    def load(cls, path: str | None) -> "Baseline":
        path = path or DEFAULT_PATH
        if not os.path.exists(path):
            return cls({})
        with open(path, encoding="utf-8") as fh:
            doc = json.load(fh)
        entries: dict[str, str] = {}
        for ent in doc.get("findings", ()):
            entries[str(ent["fingerprint"])] = str(
                ent.get("justification", ""))
        return cls(entries)

    @staticmethod
    def write(path: str, findings: Iterable[Finding],
              keep: Optional[dict[str, str]] = None,
              ran: Optional[set[str]] = None) -> None:
        """Write ``findings`` as the baseline, preserving every
        justification in ``keep`` (fingerprint → text) and carrying
        over ``keep`` entries for checkers that did NOT run — a
        ``--checker`` subset rewrite must not delete other checkers'
        grandfathered findings.  ``ran`` is the set of checker names
        that executed (default: inferred from the findings — wrong for
        a ran-but-now-clean checker, so the driver passes it
        explicitly: a subset run that FIXED its findings must drop
        them, not carry them into a stale-entry failure)."""
        keep = keep or {}
        entries: dict[str, str] = {}
        ran_checkers = (set(ran) if ran is not None
                        else {f.checker for f in findings})
        for f in set(findings):
            entries[f.fingerprint] = keep.get(
                f.fingerprint, "TODO: justify or fix")
        for fp, just in keep.items():
            if fp.split(":", 1)[0] not in ran_checkers \
                    and fp not in entries:
                entries[fp] = just
        doc = {
            "findings": [
                {"fingerprint": fp, "justification": just}
                for fp, just in sorted(entries.items())
            ],
        }
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(doc, fh, indent=2, sort_keys=True)
            fh.write("\n")

    def split(self, findings: list[Finding]
              ) -> tuple[list[Finding], list[Finding], list[str]]:
        """→ (new, grandfathered, stale-fingerprints)."""
        new, old = [], []
        seen: set[str] = set()
        for f in findings:
            if f.fingerprint in self.entries:
                old.append(f)
                seen.add(f.fingerprint)
            else:
                new.append(f)
        stale = sorted(set(self.entries) - seen)
        return new, old, stale
