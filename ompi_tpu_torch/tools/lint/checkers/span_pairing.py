"""span-pairing — every recorder open has a close on every exit path.

The collective recorder's protocol is open/close: ``seq =
trace.coll_post(...)`` marks an operation in flight, and either
``trace.coll_done(...)`` (success) or ``trace.coll_err(...)`` (raise
path) must retire it.  A post without a done leaves the recorder head
"in flight" forever — the hang doctor then reports a phantom stuck
collective on a healthy rank; a post with a done but NO err path does
the same thing the first time the collective body raises.  The flight
recorder's span timing has the same shape: a ``t0 = trace.begin()``
stamp that no ``trace.complete(...)`` (or ``record_hist``) ever
consumes is a span opened and never closed — dead timing code.

Scope: the pairing may legitimately spread across methods (nbc's
request object posts in ``__init__`` and retires in its completion
callback) or across closures (persistent collectives retire inside
the started op's callback), so each rule checks the enclosing
function's full subtree first, then the enclosing class, then the
module — only a miss at EVERY level is a finding.

- ``unpaired-post``: ``coll_post`` with no reachable ``coll_done``.
- ``no-err-path``: ``coll_post`` + ``coll_done`` but no ``coll_err``
  anywhere in scope — the raise path leaks an in-flight op.
- ``unmatched-begin``: ``trace.begin()`` with no ``trace.complete``/
  ``record_hist`` in scope.

Waiver: ``# lint: span-ok`` on (or above) the opening call.
"""

from __future__ import annotations

import ast
from typing import Optional

from ompi_tpu_torch.tools.lint.finding import Finding
from ompi_tpu_torch.tools.lint.index import ModuleInfo, ProjectIndex, iter_calls

CHECKER = "span-pairing"

#: call names this checker pairs (open → closers)
_OPENERS = {
    "coll_post": (("coll_done",), ("coll_err",)),
    "begin": (("complete", "record_hist"), ()),
}
_ALL_NAMES = frozenset(
    {op for op in _OPENERS}
    | {n for done, err in _OPENERS.values() for n in done + err})


def run(index: ProjectIndex) -> list[Finding]:
    findings: list[Finding] = []
    for mod in index.modules.values():
        if mod.name.endswith("mpi.trace"):
            continue   # the definitions themselves, not call sites
        mod_names = _scan(mod, mod.tree)
        if not any(op in mod_names for op in _OPENERS):
            continue
        for fi, cls_node in _functions(mod):
            fn_calls = _scan_calls(mod, fi.node)
            fn_names = {n for n, _c in fn_calls}
            if not any(op in fn_names for op in _OPENERS):
                continue
            cls_names = (_scan(mod, cls_node)
                         if cls_node is not None else set())
            chain = (fn_names, cls_names, set(mod_names))
            for op, (done_names, err_names) in _OPENERS.items():
                if op not in fn_names:
                    continue
                call = next(c for n, c in fn_calls if n == op)
                if mod.suppressed(call, "span"):
                    continue
                closed = any(d in names for names in chain
                             for d in done_names)
                if not closed:
                    kind = ("unpaired-post" if op == "coll_post"
                            else "unmatched-begin")
                    closers = "/".join(done_names)
                    findings.append(Finding(
                        CHECKER, kind, f"{mod.name}.{fi.node.name}",
                        f"{op}() in {fi.node.name}() has no matching "
                        f"{closers} in the function, its class, or the "
                        f"module — the opened span/op never closes",
                        mod.path, call.lineno))
                elif err_names and not any(
                        e in names for names in chain
                        for e in err_names):
                    findings.append(Finding(
                        CHECKER, "no-err-path",
                        f"{mod.name}.{fi.node.name}",
                        f"{op}() in {fi.node.name}() pairs with "
                        f"{done_names[0]} but nothing calls "
                        f"{err_names[0]} — the first raise inside the "
                        f"collective body leaks an in-flight op (the "
                        f"hang doctor reads it as a phantom hang)",
                        mod.path, call.lineno))
    return findings


def _functions(mod: ModuleInfo):
    """Every indexed function with its enclosing class node (None for
    module-level defs).  Nested closures are NOT listed separately —
    they are part of their enclosing function's subtree."""
    for fi in mod.functions.values():
        yield fi, None
    for ci in mod.classes.values():
        for fi in ci.methods.values():
            yield fi, ci.node


def _scan(mod: ModuleInfo, tree: ast.AST) -> set[str]:
    return {n for n, _c in _scan_calls(mod, tree)}


def _scan_calls(mod: ModuleInfo,
                tree: ast.AST) -> list[tuple[str, ast.Call]]:
    """Trace-module recorder calls in the subtree → [(name, call)]."""
    out: list[tuple[str, ast.Call]] = []
    for call in iter_calls(tree):
        name = _trace_call(mod, call)
        if name is not None:
            out.append((name, call))
    return out


def _trace_call(mod: ModuleInfo, call: ast.Call) -> Optional[str]:
    """``trace.coll_post(...)`` / ``trace_mod.begin()`` / bare names
    imported from the trace module → the call name; None otherwise
    (``str.count``-style lookalikes must not match)."""
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr in _ALL_NAMES:
        recv = f.value
        if isinstance(recv, ast.Name) and "trace" in recv.id:
            return f.attr
        return None
    if isinstance(f, ast.Name) and f.id in _ALL_NAMES:
        src = mod.from_imports.get(f.id)
        if src is not None and "trace" in src[0]:
            return f.id
    return None
