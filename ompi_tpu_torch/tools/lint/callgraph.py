"""Call graph + lock-acquisition analysis over the project index.

Name resolution is deliberately conservative (this is a linter, not a
type checker):

- ``self.m(...)`` resolves within the enclosing class, then its
  project-local base classes.
- ``f(...)`` resolves to a same-module function or a ``from x import f``
  target.
- ``mod.f(...)`` resolves through the import table.
- ``obj.m(...)`` (non-self receiver) resolves ONLY when exactly one
  project class defines ``m`` — an ambiguous method name produces no
  edge rather than a speculative one, so reachability findings are
  real paths, not artifacts of name collisions.

Lock analysis: a *lock node* is ``module.Class.attr`` for every
``self.attr = threading.Lock()/RLock()/Condition()`` assignment (or
``module.NAME`` for module-level locks).  Each ``with <lock>:`` block
yields the set of locks acquired *inside* it — directly nested withs
plus everything transitively acquired by calls in the body — producing
a directed acquisition-order graph.  Self-edges are dropped (the graph
has no instance identity: parent→child traversal over two instances of
one class is legitimate nesting, and RLock/Condition re-entry is legal),
cycles between distinct locks are lock-order inversions.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from ompi_tpu_torch.tools.lint.index import (ClassInfo, FunctionInfo, ModuleInfo,
                              ProjectIndex, iter_calls,
                              iter_calls_shallow)

__all__ = ["CallGraph", "CallSite", "LockAnalysis"]

#: method names that live on ubiquitous stdlib objects (Popen, file,
#: socket, Event, Queue, dict, …): a non-self attribute call with one of
#: these names is far more likely stdlib than the single project method
#: that happens to share it, so unique-name resolution skips them — a
#: speculative edge here turns into a phantom reachability finding
#: (e.g. ``proc.poll()`` on a Popen resolving to ``ShmRingReader.poll``).
_STDLIB_ATTR_DENY = frozenset({
    "poll", "wait", "communicate", "kill", "terminate", "send", "recv",
    "sendall", "accept", "connect", "close", "join", "start", "run",
    "get", "put", "pop", "append", "add", "remove", "discard", "clear",
    "update", "keys", "values", "items", "read", "write", "flush",
    "seek", "tell", "acquire", "release", "notify", "notify_all",
    "set", "is_set", "fileno", "copy", "index", "count", "insert",
    "post",
    "extend", "sort", "split", "strip", "encode", "decode", "lower",
    "upper", "format", "setdefault", "submit", "result", "cancel",
})


class CallSite:
    __slots__ = ("caller", "call", "targets", "receiver")

    def __init__(self, caller: FunctionInfo, call: ast.Call,
                 targets: list[FunctionInfo], receiver: str) -> None:
        self.caller = caller
        self.call = call
        self.targets = targets      # resolved project callees ([] if none)
        self.receiver = receiver    # receiver source text ("" for bare f())


class CallGraph:
    @classmethod
    def of(cls, index: ProjectIndex) -> "CallGraph":
        """The index's call graph, built once — reader-thread and
        lock-order both need it, and the build (every call site in the
        tree resolved) dominates lint wall-clock if repeated."""
        graph = getattr(index, "_callgraph", None)
        if graph is None:
            graph = cls(index)
            index._callgraph = graph  # type: ignore[attr-defined]
        return graph

    def __init__(self, index: ProjectIndex) -> None:
        self.index = index
        #: caller qualname → ordered call sites
        self.sites: dict[str, list[CallSite]] = {}
        #: caller qualname → set of callee qualnames
        self.edges: dict[str, set[str]] = {}
        self._reach_memo: dict[str, set[str]] = {}
        for fi in index.iter_functions():
            self._build_function(fi)

    # -- construction ----------------------------------------------------

    def _build_function(self, fi: FunctionInfo) -> None:
        mod = self.index.modules[fi.module]
        sites: list[CallSite] = []
        edges: set[str] = set()
        # shallow walk: a nested def is another stack (thread target /
        # deferred callback) — its calls are not this function's calls
        for call in iter_calls_shallow(fi.node):
            targets, recv = self._resolve(mod, fi, call)
            sites.append(CallSite(fi, call, targets, recv))
            edges.update(t.qualname for t in targets)
        self.sites[fi.qualname] = sites
        self.edges[fi.qualname] = edges

    def _resolve(self, mod: ModuleInfo, fi: FunctionInfo,
                 call: ast.Call) -> tuple[list[FunctionInfo], str]:
        func = call.func
        if isinstance(func, ast.Name):
            t = self._resolve_bare(mod, func.id)
            return ([t] if t else []), ""
        if not isinstance(func, ast.Attribute):
            return [], ""
        recv = func.value
        recv_text = _safe_unparse(recv)
        meth = func.attr
        # self.m() → enclosing class, then project-local bases
        if isinstance(recv, ast.Name) and recv.id == "self" and fi.cls:
            t = self._resolve_method(self.index.classes[fi.cls], meth)
            if t is not None:
                return [t], recv_text
            return self._resolve_unique(meth), recv_text
        # mod.f() → import table
        if isinstance(recv, ast.Name):
            target_mod = self.index.resolve_module(mod, recv.id)
            if target_mod is not None:
                if meth in target_mod.functions:
                    return [target_mod.functions[meth]], recv_text
                if meth in target_mod.classes:   # Mod.Class(...) ctor
                    ctor = target_mod.classes[meth].methods.get("__init__")
                    return ([ctor] if ctor else []), recv_text
                return [], recv_text
        # obj.m() → unique project method name only
        return self._resolve_unique(meth), recv_text

    def _resolve_bare(self, mod: ModuleInfo, name: str
                      ) -> Optional[FunctionInfo]:
        if name in mod.functions:
            return mod.functions[name]
        if name in mod.classes:   # local Class(...) ctor
            return mod.classes[name].methods.get("__init__")
        if name in mod.from_imports:
            src, orig = mod.from_imports[name]
            target = self.index.find_module(src) if src else None
            if target is not None:
                if orig in target.functions:
                    return target.functions[orig]
                if orig in target.classes:
                    return target.classes[orig].methods.get("__init__")
        return None

    def _resolve_method(self, ci: ClassInfo, meth: str
                        ) -> Optional[FunctionInfo]:
        if meth in ci.methods:
            return ci.methods[meth]
        for base in ci.bases:
            bci = self.index.find_class(base.rsplit(".", 1)[-1])
            if bci is not None and bci.qualname != ci.qualname:
                t = self._resolve_method(bci, meth)
                if t is not None:
                    return t
        return None

    def _resolve_unique(self, meth: str) -> list[FunctionInfo]:
        if meth in _STDLIB_ATTR_DENY:
            return []
        cands = self.index.methods_by_name.get(meth, [])
        return [cands[0]] if len(cands) == 1 else []

    def edges_excluding(self, rule: str) -> dict[str, set[str]]:
        """Call-graph edges, minus call sites waived with an explicit
        ``# lint: <rule>-ok`` comment — the per-edge escape hatch for
        contracts the analysis cannot see (e.g. a callee that only
        blocks when a flag argument says so)."""
        out: dict[str, set[str]] = {}
        for qn, sites in self.sites.items():
            fi = self.index.functions[qn]
            mod = self.index.modules[fi.module]
            tgts = out.setdefault(qn, set())
            for cs in sites:
                if cs.targets and mod.suppressed(cs.call, rule):
                    continue
                tgts.update(t.qualname for t in cs.targets)
        return out

    # -- reachability -----------------------------------------------------

    def reachable(self, start: str) -> set[str]:
        """All qualnames reachable from ``start`` (inclusive)."""
        memo = self._reach_memo.get(start)
        if memo is not None:
            return memo
        seen: set[str] = set()
        stack = [start]
        while stack:
            qn = stack.pop()
            if qn in seen:
                continue
            seen.add(qn)
            stack.extend(self.edges.get(qn, ()))
        self._reach_memo[start] = seen
        return seen

    def shortest_path(self, start: str, goal_set: set[str]
                      ) -> Optional[list[str]]:
        """BFS path start → any member of goal_set (for messages)."""
        from collections import deque

        prev: dict[str, Optional[str]] = {start: None}
        q = deque([start])
        while q:
            qn = q.popleft()
            if qn in goal_set:
                path = [qn]
                while prev[path[-1]] is not None:
                    path.append(prev[path[-1]])  # type: ignore[arg-type]
                return list(reversed(path))
            for nxt in sorted(self.edges.get(qn, ())):
                if nxt not in prev:
                    prev[nxt] = qn
                    q.append(nxt)
        return None


# ---------------------------------------------------------------------------
# lock analysis
# ---------------------------------------------------------------------------

class LockAnalysis:
    """Direct + transitive lock acquisitions per function, and the
    acquisition-order edges between distinct lock nodes."""

    def __init__(self, graph: CallGraph,
                 modules: Optional[set[str]] = None) -> None:
        self.graph = graph
        self.index = graph.index
        self.modules = modules    # restrict analysis to these modules
        #: edges minus `# lint: lock-ok`-waived call sites
        self.edges = graph.edges_excluding("lock")
        #: qualname → [(lock_id, kind, With-node)]
        self.direct: dict[str, list[tuple[str, str, ast.With]]] = {}
        self._trans: Optional[dict[str, frozenset[str]]] = None
        for fi in self.index.iter_functions():
            if modules is not None and fi.module not in modules:
                continue
            self.direct[fi.qualname] = list(self._direct_locks(fi))

    def _direct_locks(self, fi: FunctionInfo
                      ) -> Iterator[tuple[str, str, ast.With]]:
        # same nested-def pruning as the call graph: a closure's locks
        # are acquired on the closure's (usually another thread's) stack
        stack = list(ast.iter_child_nodes(fi.node))
        nodes: list[ast.AST] = []
        while stack:
            sub = stack.pop()
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                continue
            nodes.append(sub)
            stack.extend(ast.iter_child_nodes(sub))
        for node in nodes:
            if not isinstance(node, ast.With):
                continue
            for item in node.items:
                got = self._lock_id(fi, item.context_expr)
                if got is not None:
                    yield got[0], got[1], node

    def _lock_id(self, fi: FunctionInfo, expr: ast.expr
                 ) -> Optional[tuple[str, str]]:
        """``with self._lock`` / ``with _module_lock`` → (id, kind)."""
        if isinstance(expr, ast.Attribute) \
                and isinstance(expr.value, ast.Name):
            attr = expr.attr
            if expr.value.id == "self" and fi.cls:
                ci = self.index.classes[fi.cls]
                kind = self._class_lock(ci, attr)
                if kind is not None:
                    return f"{fi.cls}.{attr}", kind
                return None
            # obj.lock: unique lock-attr name across project classes
            owners = [(ci, k) for ci in self.index.classes.values()
                      for a, k in ci.lock_attrs.items() if a == attr]
            if len(owners) == 1:
                ci, kind = owners[0]
                return f"{ci.qualname}.{attr}", kind
            return None
        if isinstance(expr, ast.Name):
            mod = self.index.modules[fi.module]
            # module-level lock: NAME = threading.Lock() at top level
            for node in mod.tree.body:
                if isinstance(node, ast.Assign) \
                        and isinstance(node.value, ast.Call):
                    from ompi_tpu_torch.tools.lint.index import _lock_factory_name

                    fac = _lock_factory_name(node.value.func)
                    if fac is None:
                        continue
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name) \
                                and tgt.id == expr.id:
                            return f"{mod.name}.{expr.id}", fac
        return None

    def _class_lock(self, ci: ClassInfo, attr: str) -> Optional[str]:
        if attr in ci.lock_attrs:
            return ci.lock_attrs[attr]
        for base in ci.bases:
            bci = self.index.find_class(base.rsplit(".", 1)[-1])
            if bci is not None and bci.qualname != ci.qualname:
                k = self._class_lock(bci, attr)
                if k is not None:
                    return k
        return None

    def transitive(self, qualname: str) -> frozenset[str]:
        """Locks ``qualname`` may acquire, directly or via any callee.

        Computed as one global fixpoint rather than a memoized DFS: a
        lazy DFS with a cycle guard permanently memoizes an INCOMPLETE
        set for every non-root member of a call cycle (mutually
        recursive helpers), silently hiding their locks from cycle
        detection and the reader-shared set."""
        if self._trans is None:
            locks: dict[str, set[str]] = {
                qn: {lid for lid, _k, _n in d}
                for qn, d in self.direct.items()}
            changed = True
            while changed:
                changed = False
                for qn, callees in self.edges.items():
                    cur = locks.setdefault(qn, set())
                    n = len(cur)
                    for c in callees:
                        got = locks.get(c)
                        if got:
                            cur |= got
                    if len(cur) != n:
                        changed = True
            self._trans = {qn: frozenset(s) for qn, s in locks.items()}
        return self._trans.get(qualname, frozenset())

    def held_call_sites(self, fi: FunctionInfo
                        ) -> Iterator[tuple[str, CallSite]]:
        """(held_lock_id, call site) for every call lexically inside a
        with-lock block of ``fi``."""
        sites = self.graph.sites.get(fi.qualname, [])
        for lid, _kind, wnode in self.direct.get(fi.qualname, ()):
            body_calls = {id(c) for stmt in wnode.body
                          for c in iter_calls_shallow(stmt)}
            for site in sites:
                if id(site.call) in body_calls:
                    yield lid, site


def _safe_unparse(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:  # noqa: BLE001 — display-only
        return "<?>"
