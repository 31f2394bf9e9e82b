"""frame-op — every emitted frame type/op literal has a dispatch branch.

Two wire planes ride header dicts through the BTLs:

- the PML data/control plane: ``{"t": "<type>", …}`` frames dispatched
  by ``_on_frame``'s if-chain;
- the FT/gossip control plane: ``{"t": "ft", "op": "<op>", …}`` frames
  dispatched by ``on_ft_frame``.

Both dispatchers end in ``_log.error("unknown …")`` — so an emitted
literal with no branch is a frame that silently vanishes at every
receiver (the PR-7 class of bug: a new gossip op added on the send
side only).  Checks:

- ``unhandled-op``: an emitted ``op``/``t`` literal with no comparison
  branch in the matching dispatcher.
- ``unemitted-branch``: a dispatcher branch for a literal nothing in
  the tree emits (dead protocol arm).
"""

from __future__ import annotations

import ast
from typing import Optional

from ompi_tpu_torch.tools.lint.finding import Finding
from ompi_tpu_torch.tools.lint.index import ProjectIndex, literal_str

CHECKER = "frame-op"

#: (plane, dispatch function name, header key, emit-filter, assumed)
#: emit-filter: a dict literal participates when f(keys) is true;
#: ``assumed`` supplies the keys a non-dict-literal emission form
#: (``hdr["op"] = …`` / ``hdr.update(op=…)``) cannot carry — the "op"
#: key only exists on t="ft" frames, so those forms are ft emissions
_PLANES = (
    ("ft", "on_ft_frame", "op",
     lambda keys: keys.get("t") == "ft", {"t": "ft"}),
    ("pml", "_on_frame", "t",
     lambda keys: True, {}),
)


def run(index: ProjectIndex) -> list[Finding]:
    findings: list[Finding] = []
    for plane, dispatch_name, key, emit_ok, assumed in _PLANES:
        emitted = _collect_emitted(index, key, emit_ok, assumed)
        dispatched = _collect_dispatched(index, dispatch_name, key)
        if dispatched is None:
            continue   # no dispatcher in this tree — plane not present
        branch_lits, disp_path, disp_line = dispatched
        for lit, (path, line) in sorted(emitted.items()):
            if lit not in branch_lits:
                findings.append(Finding(
                    CHECKER, "unhandled-op", f"{plane}:{lit}",
                    f"frame {key}={lit!r} is emitted but "
                    f"{dispatch_name} has no branch for it — the frame "
                    f"is dropped at every receiver", path, line))
        for lit in sorted(branch_lits - set(emitted)):
            findings.append(Finding(
                CHECKER, "unemitted-branch", f"{plane}:{lit}",
                f"{dispatch_name} dispatches {key}={lit!r} but nothing "
                f"in the tree emits it (dead protocol arm)",
                disp_path, disp_line))
    return findings


# -- emit side -------------------------------------------------------------

def _collect_emitted(index: ProjectIndex, key: str, emit_ok,
                     assumed: dict) -> dict[str, tuple[str, int]]:
    out: dict[str, tuple[str, int]] = {}

    def emit(lit: Optional[str], keys: dict, mod, node) -> None:
        if lit is not None and emit_ok(keys) \
                and not mod.suppressed(node, "frame"):
            out.setdefault(lit, (mod.path, node.lineno))

    for mod in index.modules.values():
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Dict):
                keys: dict[str, Optional[str]] = {}
                vals: dict[str, ast.expr] = {}
                for k, v in zip(node.keys, node.values):
                    kl = literal_str(k) if k is not None else None
                    if kl is not None:
                        keys[kl] = literal_str(v)
                        vals[kl] = v
                if key in keys:
                    for lit in _value_literals(vals[key]):
                        emit(lit, {**keys, key: lit}, mod, node)
            elif isinstance(node, ast.Assign):
                # hdr["t"] = "eager" style emission
                for tgt in node.targets:
                    if (isinstance(tgt, ast.Subscript)
                            and literal_str(tgt.slice) == key):
                        for lit in _value_literals(node.value):
                            emit(lit, {**assumed, key: lit}, mod, node)
            elif isinstance(node, ast.Call):
                # hdr.update(t="rndv", …) style emission
                f = node.func
                if isinstance(f, ast.Attribute) and f.attr == "update":
                    for kw in node.keywords:
                        if kw.arg == key:
                            for lit in _value_literals(kw.value):
                                emit(lit, {**assumed, key: lit},
                                     mod, node)
    return out


def _value_literals(node: ast.expr) -> list[str]:
    """The literal(s) an emitted value can take — plain constants plus
    both arms of a conditional (``"rndv" if big else "eager"``)."""
    lit = literal_str(node)
    if lit is not None:
        return [lit]
    if isinstance(node, ast.IfExp):
        return _value_literals(node.body) + _value_literals(node.orelse)
    return []


# -- dispatch side ---------------------------------------------------------

def _collect_dispatched(index: ProjectIndex, dispatch_name: str,
                        key: str
                        ) -> Optional[tuple[set[str], str, int]]:
    for fi in index.iter_functions():
        if fi.qualname.rsplit(".", 1)[-1] != dispatch_name:
            continue
        mod = index.modules[fi.module]
        lits = _branch_literals(fi.node, key)
        return lits, mod.path, fi.node.lineno
    return None


def _branch_literals(func: ast.AST, key: str) -> set[str]:
    """String literals the dispatcher compares the header key against:
    tracks ``x = hdr[key]`` / ``x = hdr.get(key)`` bindings, then
    collects literals from ``x == "lit"`` / ``x != "lit"`` /
    ``x in ("a", "b")`` comparisons (and the direct
    ``hdr.get(key) == "lit"`` form)."""
    tracked: set[str] = set()
    for node in ast.walk(func):
        if isinstance(node, ast.Assign) and _reads_key(node.value, key,
                                                      set()):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    tracked.add(tgt.id)
    lits: set[str] = set()
    for node in ast.walk(func):
        if not isinstance(node, ast.Compare):
            continue
        operands = [node.left, *node.comparators]
        if not any(_reads_key(op, key, tracked) for op in operands):
            continue
        for op in operands:
            lit = literal_str(op)
            if lit is not None:
                lits.add(lit)
            elif isinstance(op, (ast.Tuple, ast.List, ast.Set)):
                for el in op.elts:
                    el_lit = literal_str(el)
                    if el_lit is not None:
                        lits.add(el_lit)
    return lits


def _reads_key(node: ast.expr, key: str, tracked: set[str]) -> bool:
    if isinstance(node, ast.Name):
        return node.id in tracked
    if isinstance(node, ast.Subscript):
        return literal_str(node.slice) == key
    if isinstance(node, ast.Call):
        f = node.func
        return (isinstance(f, ast.Attribute) and f.attr == "get"
                and bool(node.args)
                and literal_str(node.args[0]) == key)
    return False
