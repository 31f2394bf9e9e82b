"""pvar-spec — always-on counters/histograms and their catalogue tuples
(`_COUNTER_SPECS` / `_HIST_SPECS`) agree in both directions.

``trace.count(name)`` does ``counters[name] += 1`` and
``trace.record_hist(name, …)`` opens ``hists`` series validated against
``_HIST_SPECS`` — an undeclared name is a KeyError on a hot path, and a
spec nobody records is a dead pvar that exports a forever-zero metric
and rots the catalogue.  Checks:

- ``undeclared-counter``: a ``count("x")`` bump (or ``counters["x"]``
  access) naming no ``_COUNTER_SPECS`` entry.  F-string names must
  match ≥1 spec.
- ``dead-pvar``: a ``_COUNTER_SPECS`` entry never bumped anywhere.
- ``undeclared-hist``: a ``record_hist("x", …)`` naming no
  ``_HIST_SPECS`` entry (f-string names expanded like counters).
- ``dead-hist``: a ``_HIST_SPECS`` entry with no recording site.
- ``unknown-agg-metric``: an ``AGG_METRICS`` entry (the per-job
  aggregated-metric family the DVM scrape endpoint sums across ranks
  as ``ompi_tpu_job_*``) naming no ``_COUNTER_SPECS`` counter — a
  renamed counter would otherwise silently vanish from the scrape
  surface while the aggregate kept exporting a forever-zero sum.
- ``unknown-agg-hist``: the same cross-check for ``AGG_HISTS`` (the
  per-job element-wise histogram sums) against ``_HIST_SPECS``.
"""

from __future__ import annotations

import ast
import re
from typing import Optional

from ompi_tpu_torch.tools.lint.finding import Finding
from ompi_tpu_torch.tools.lint.index import (ProjectIndex, fstring_regex, iter_calls,
                              literal_str)

CHECKER = "pvar-spec"


def run(index: ProjectIndex) -> list[Finding]:
    findings: list[Finding] = []
    specs = collect_specs(index, "_COUNTER_SPECS")
    if specs is not None:
        findings += _check_family(
            index, specs, arg_fn=_count_arg,
            undeclared_kind="undeclared-counter",
            dead_kind="dead-pvar",
            spec_tuple="_COUNTER_SPECS", verb="bumped",
            record_verb="count() call", subscript_store="counters")
        for name, path, line in collect_agg_names(index, "AGG_METRICS"):
            if name not in specs[0]:
                findings.append(Finding(
                    CHECKER, "unknown-agg-metric", name,
                    f"AGG_METRICS entry {name!r} names no "
                    f"_COUNTER_SPECS counter — the per-job "
                    f"ompi_tpu_job_ sum on the scrape endpoint would "
                    f"export forever-zero (renamed counter?)",
                    path, line))
    hspecs = collect_specs(index, "_HIST_SPECS")
    if hspecs is not None:
        findings += _check_family(
            index, hspecs, arg_fn=_record_hist_arg,
            undeclared_kind="undeclared-hist",
            dead_kind="dead-hist",
            spec_tuple="_HIST_SPECS", verb="recorded",
            record_verb="record_hist() call", subscript_store="hists")
        for name, path, line in collect_agg_names(index, "AGG_HISTS"):
            if name not in hspecs[0]:
                findings.append(Finding(
                    CHECKER, "unknown-agg-hist", name,
                    f"AGG_HISTS entry {name!r} names no _HIST_SPECS "
                    f"histogram — the per-job ompi_tpu_job_ bucket sum "
                    f"on the scrape endpoint would export forever-zero "
                    f"(renamed histogram?)", path, line))
    return findings


def _check_family(index: ProjectIndex,
                  specs: tuple[set[str], str, dict[str, int]],
                  arg_fn, undeclared_kind: str, dead_kind: str,
                  spec_tuple: str, verb: str, record_verb: str,
                  subscript_store: str) -> list[Finding]:
    """The both-directions discipline for one spec catalogue: every
    recording site names a declared spec (literal or f-string), every
    declared spec has a recording site."""
    spec_names, spec_mod, spec_line = specs
    findings: list[Finding] = []
    used: set[str] = set()

    for mod in index.modules.values():
        for call in iter_calls(mod.tree):
            arg = arg_fn(mod, call)
            if arg is None:
                continue
            lit = literal_str(arg)
            if lit is not None:
                if lit in spec_names:
                    used.add(lit)
                elif not mod.suppressed(call, "pvar"):
                    findings.append(Finding(
                        CHECKER, undeclared_kind, lit,
                        f"{lit!r} {verb} but not declared in "
                        f"{spec_tuple}", mod.path, call.lineno))
                continue
            rx = fstring_regex(arg)
            if rx is not None:
                hits = {n for n in spec_names if re.match(rx, n)}
                if hits:
                    used |= hits
                elif not mod.suppressed(call, "pvar"):
                    findings.append(Finding(
                        CHECKER, undeclared_kind, rx,
                        f"dynamic name {rx!r} matches no {spec_tuple} "
                        f"entry", mod.path, call.lineno))
        # counters["x"] / hists["x"] subscripts also keep a spec alive
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Subscript) \
                    and _is_store(node.value, subscript_store):
                lit = literal_str(node.slice)
                if lit is not None and lit in spec_names:
                    used.add(lit)

    for name in sorted(set(spec_names) - used):
        findings.append(Finding(
            CHECKER, dead_kind, name,
            f"{spec_tuple} entry {name!r} is never {verb} by any "
            f"{record_verb}", spec_mod, spec_line.get(name, 0)))
    return findings


def collect_specs(index: ProjectIndex, tuple_name: str = "_COUNTER_SPECS"
                  ) -> Optional[tuple[set[str], str, dict[str, int]]]:
    """A spec catalogue tuple (``_COUNTER_SPECS`` / ``_HIST_SPECS``) →
    (names, path, name→line)."""
    for mod in index.modules.values():
        for node in mod.tree.body:
            if not (isinstance(node, ast.Assign)
                    and any(isinstance(t, ast.Name)
                            and t.id == tuple_name
                            for t in node.targets)):
                continue
            if not isinstance(node.value, (ast.Tuple, ast.List)):
                continue
            names: set[str] = set()
            lines: dict[str, int] = {}
            for el in node.value.elts:
                if isinstance(el, (ast.Tuple, ast.List)) and el.elts:
                    nm = literal_str(el.elts[0])
                    if nm is not None:
                        names.add(nm)
                        lines[nm] = el.lineno
            return names, mod.path, lines
    return None


def collect_agg_metrics(index: ProjectIndex
                        ) -> list[tuple[str, str, int]]:
    """Back-compat alias: the ``AGG_METRICS`` entries."""
    return collect_agg_names(index, "AGG_METRICS")


def collect_agg_names(index: ProjectIndex, tuple_name: str
                      ) -> list[tuple[str, str, int]]:
    """Every ``AGG_METRICS``/``AGG_HISTS`` tuple's string entries →
    [(name, path, line)] — the aggregated name families the DVM
    scrape endpoint exports per job."""
    out: list[tuple[str, str, int]] = []
    for mod in index.modules.values():
        for node in mod.tree.body:
            if not (isinstance(node, ast.Assign)
                    and any(isinstance(t, ast.Name)
                            and t.id == tuple_name
                            for t in node.targets)):
                continue
            if not isinstance(node.value, (ast.Tuple, ast.List)):
                continue
            for el in node.value.elts:
                nm = literal_str(el)
                if nm is not None:
                    out.append((nm, mod.path, el.lineno))
    return out


def _count_arg(mod, call: ast.Call) -> Optional[ast.expr]:
    """The name argument of a counter bump: ``trace.count(x)`` /
    ``trace_mod.count(x)`` / bare ``count(x)`` imported from the trace
    module.  Plain ``<anything-else>.count(x)`` (str/list methods) is
    not a bump."""
    f = call.func
    if not call.args:
        return None
    if isinstance(f, ast.Attribute) and f.attr == "count":
        recv = f.value
        if isinstance(recv, ast.Name) and "trace" in recv.id:
            return call.args[0]
        return None
    if isinstance(f, ast.Name) and f.id == "count":
        src = mod.from_imports.get("count")
        if src is not None and "trace" in src[0]:
            return call.args[0]
        if "count" in mod.functions:   # the trace module itself
            return call.args[0]
    return None


def _record_hist_arg(mod, call: ast.Call) -> Optional[ast.expr]:
    """The name argument of a histogram record: ``trace.record_hist(x,
    …)`` / bare ``record_hist(x, …)`` imported from the trace module."""
    f = call.func
    if not call.args:
        return None
    if isinstance(f, ast.Attribute) and f.attr == "record_hist":
        recv = f.value
        if isinstance(recv, ast.Name) and "trace" in recv.id:
            return call.args[0]
        return None
    if isinstance(f, ast.Name) and f.id == "record_hist":
        src = mod.from_imports.get("record_hist")
        if src is not None and "trace" in src[0]:
            return call.args[0]
        if "record_hist" in mod.functions:   # the trace module itself
            return call.args[0]
    return None


def _is_store(node: ast.expr, store: str) -> bool:
    if isinstance(node, ast.Name):
        return node.id == store
    if isinstance(node, ast.Attribute):
        return node.attr == store
    return False
