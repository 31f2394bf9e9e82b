"""pmix-rpc — client RPC names exist on the server, with enough args.

The PMIx wire protocol is stringly-typed: ``PMIxClient._rpc("cmd", …)``
frames a tuple, ``PMIxServer._handle`` switches on the literal.  An
unknown cmd raises server-side ("unknown command") and surfaces as a
PMIxError at every caller; a branch unpacking more args than a client
sends is a per-call ValueError (the PR-7 ``report_failed``
legacy-probe class).  Checks:

- ``unknown-rpc``: a client ``_rpc("x", …)`` with no ``cmd == "x"``
  branch in ``_handle``.
- ``arity-mismatch``: a client call passing fewer args than the
  branch's *unconditional* accesses require (fixed tuple-unpacks,
  unguarded ``args[i]`` subscripts, ``args[:k]`` slices; accesses
  under a ``len(args)`` guard are optional by construction).
- ``dead-rpc``: a ``_handle`` branch no client call ever names.
"""

from __future__ import annotations

import ast
from typing import Optional

from ompi_tpu_torch.tools.lint.finding import Finding
from ompi_tpu_torch.tools.lint.index import ProjectIndex, iter_calls, literal_str

CHECKER = "pmix-rpc"


def run(index: ProjectIndex) -> list[Finding]:
    handle = _find_handler(index)
    if handle is None:
        return []
    branches, handle_path = handle

    calls: dict[str, list[tuple[int, str, int]]] = {}
    for mod in index.modules.values():
        for call in iter_calls(mod.tree):
            f = call.func
            if not (isinstance(f, ast.Attribute) and f.attr == "_rpc"
                    and call.args):
                continue
            cmd = literal_str(call.args[0])
            if cmd is None:
                continue
            argc = len(call.args) - 1
            if any(isinstance(a, ast.Starred) for a in call.args):
                argc = -1   # variadic forward: arity unknowable
            calls.setdefault(cmd, []).append(
                (argc, mod.path, call.lineno))

    findings: list[Finding] = []
    for cmd, sites in sorted(calls.items()):
        if cmd not in branches:
            for _argc, path, line in sites:
                findings.append(Finding(
                    CHECKER, "unknown-rpc", cmd,
                    f"client sends RPC {cmd!r} but the server _handle "
                    f"has no branch for it", path, line))
            continue
        required, _line = branches[cmd]
        for argc, path, line in sites:
            if argc >= 0 and argc < required:
                findings.append(Finding(
                    CHECKER, "arity-mismatch", cmd,
                    f"RPC {cmd!r} sent with {argc} arg(s) but the "
                    f"server branch unconditionally reads {required}",
                    path, line))
    for cmd, (_req, line) in sorted(branches.items()):
        if cmd not in calls:
            findings.append(Finding(
                CHECKER, "dead-rpc", cmd,
                f"server _handle has a branch for {cmd!r} but no "
                f"client ever sends it", handle_path, line))
    return findings


def _find_handler(index: ProjectIndex
                  ) -> Optional[tuple[dict[str, tuple[int, int]], str]]:
    """The ``_handle(self, cmd, args)`` dispatcher →
    {cmd literal: (required arity, line)}."""
    for fi in index.iter_functions():
        if fi.qualname.rsplit(".", 1)[-1] != "_handle" or fi.cls is None:
            continue
        args = fi.node.args.args
        names = [a.arg for a in args]
        if names[-2:] != ["cmd", "args"]:
            continue
        branches: dict[str, tuple[int, int]] = {}
        for node in ast.walk(fi.node):
            if not (isinstance(node, ast.If)
                    and isinstance(node.test, ast.Compare)):
                continue
            t = node.test
            if not (isinstance(t.left, ast.Name) and t.left.id == "cmd"
                    and len(t.ops) == 1
                    and isinstance(t.ops[0], ast.Eq)):
                continue
            cmd = literal_str(t.comparators[0])
            if cmd is None:
                continue
            req = max((_required_arity(stmt) for stmt in node.body),
                      default=0)
            branches[cmd] = (req, node.lineno)
        return branches, index.modules[fi.module].path
    return None


def _required_arity(node: ast.AST, guarded: bool = False) -> int:
    """Max index of ``args`` this subtree unconditionally needs —
    accesses under a ``len(args)`` guard (``if``/conditional
    expression) count as optional."""
    if isinstance(node, ast.If):
        g = guarded or _mentions_len_args(node.test)
        req = _required_arity(node.test, guarded)
        for sub in node.body + node.orelse:
            req = max(req, _required_arity(sub, g))
        return req
    if isinstance(node, ast.IfExp):
        g = guarded or _mentions_len_args(node.test)
        return max(_required_arity(node.test, guarded),
                   _required_arity(node.body, g),
                   _required_arity(node.orelse, g))
    req = 0
    # tuple-unpack of args: a, b, c = args (optional under a guard,
    # same as subscripts — the legacy-fallback pattern unpacks inside
    # an `if len(args) >= n:` arm)
    if not guarded and isinstance(node, ast.Assign) \
            and isinstance(node.value, ast.Name) \
            and node.value.id == "args":
        for tgt in node.targets:
            if isinstance(tgt, ast.Tuple):
                req = max(req, len(tgt.elts))
    if (not guarded and isinstance(node, ast.Subscript)
            and isinstance(node.value, ast.Name)
            and node.value.id == "args"):
        sl = node.slice
        if isinstance(sl, ast.Constant) and isinstance(sl.value, int):
            req = max(req, sl.value + 1)
        elif isinstance(sl, ast.Slice) \
                and isinstance(sl.upper, ast.Constant) \
                and isinstance(sl.upper.value, int) \
                and sl.lower is None:
            req = max(req, sl.upper.value)
    for child in ast.iter_child_nodes(node):
        req = max(req, _required_arity(child, guarded))
    return req


def _mentions_len_args(test: ast.expr) -> bool:
    for sub in ast.walk(test):
        if (isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Name)
                and sub.func.id == "len" and sub.args
                and isinstance(sub.args[0], ast.Name)
                and sub.args[0].id == "args"):
            return True
    return False
