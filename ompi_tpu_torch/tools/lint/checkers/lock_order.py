"""lock-order — acquisition-order cycles and blocking work under locks.

Builds the lock-acquisition graph across ``mpi/`` + ``runtime/`` (the
two packages whose locks nest across module boundaries): a directed
edge A→B for every path that acquires B while holding A — directly
nested ``with`` blocks plus everything transitively acquired by calls
made inside a ``with A`` body.  Checks:

- ``cycle``: a cycle between *distinct* locks (AB/BA inversion — the
  deadlock needs two threads, which is exactly why review keeps
  missing it).  Self-edges are not reported: the graph has no instance
  identity (parent→child traversal over two instances of one class is
  legitimate ordered nesting) and RLock/Condition re-entry is legal.
- ``rpc-under-lock``: a blocking PMIx RPC reachable with a lock held —
  the lock is held across a server round-trip, so every other thread
  needing it stalls on the network.
- ``sleep-under-lock``: ``time.sleep`` with a lock held (backoff loops
  belong outside the critical section; ``Condition.wait`` releases and
  is fine).

The blocking-under-lock rules apply only to *reader-shared* locks —
locks some transport reader path also acquires.  A lock that exists to
serialize an intentionally-blocking operation against its own kind
(``Window._origin_lock`` "serializes blocking ops", the once-per-
process ``runtime._lock`` held across the init modex) is that design,
not a finding; a reader-shared lock held across a sleep or an RPC
stalls the frame pipeline, which is the bug class this hunts.

Waive an intentional edge with ``# lint: lock-ok`` on the call line.
"""

from __future__ import annotations

import ast

from ompi_tpu_torch.tools.lint.callgraph import CallGraph, LockAnalysis
from ompi_tpu_torch.tools.lint.checkers.reader_thread import (_augment_with_sinks,
                                               _entry_points,
                                               _reachable, _short,
                                               _shortest)
from ompi_tpu_torch.tools.lint.finding import Finding
from ompi_tpu_torch.tools.lint.index import ProjectIndex, walk_shallow

CHECKER = "lock-order"

#: packages whose locks participate (dotted-name fragments); fixture
#: trees are small enough that everything participates
_SCOPE_FRAGMENTS = ("mpi", "runtime", "core")


def run(index: ProjectIndex) -> list[Finding]:
    scoped = {name for name in index.modules
              if any(f".{frag}." in f".{name}."
                     for frag in _SCOPE_FRAGMENTS)} or set(index.modules)
    graph = CallGraph.of(index)
    locks = LockAnalysis(graph, modules=scoped)
    findings: list[Finding] = []
    findings += _check_cycles(index, graph, locks)
    findings += _check_blocking_under_lock(index, graph, locks)
    return findings


# -- acquisition-order cycles ----------------------------------------------

def _check_cycles(index: ProjectIndex, graph: CallGraph,
                  locks: LockAnalysis) -> list[Finding]:
    #: lock A → {lock B: (example function, line)}
    edges: dict[str, dict[str, tuple[str, int]]] = {}
    for qn, acquired in locks.direct.items():
        fi = index.functions[qn]
        mod = index.modules[fi.module]
        for lid, _kind, wnode in acquired:
            inner: set[str] = set()
            # directly nested with-locks (shallow: a closure's withs
            # run on the closure's stack — same pruning as the call
            # graph, or the approved spawn-and-return hand-off would
            # fabricate an acquisition edge that cannot deadlock)
            for sub in walk_shallow(wnode):
                if not isinstance(sub, ast.With):
                    continue
                for item in sub.items:
                    got = locks._lock_id(fi, item.context_expr)
                    if got is not None:
                        inner.add(got[0])
            # locks acquired by calls made while held
            for held, site in locks.held_call_sites(fi):
                if held != lid:
                    continue
                if mod.suppressed(site.call, "lock"):
                    continue
                for t in site.targets:
                    inner |= locks.transitive(t.qualname)
            for b in inner:
                if b != lid:
                    edges.setdefault(lid, {}).setdefault(
                        b, (qn, wnode.lineno))

    findings = []
    for cycle in _find_cycles(edges):
        ordered = sorted(cycle)
        sym = "->".join(_short(x) for x in ordered)
        # any edge inside the SCC serves as the example location (the
        # sorted order is canonical, not a walkable path)
        ex_fn, ex_line = next(
            edges[a][b] for a in ordered for b in edges.get(a, {})
            if b in cycle and b != a)
        fi = index.functions[ex_fn]
        findings.append(Finding(
            CHECKER, "cycle", sym,
            f"lock-order inversion among {{{', '.join(ordered)}}} "
            f"(one edge via {ex_fn})",
            fi.path, ex_line))
    return findings


def _find_cycles(edges: dict[str, dict[str, tuple[str, int]]]
                 ) -> list[list[str]]:
    """Distinct elementary cycles via SCC decomposition (one finding
    per strongly connected component with ≥2 locks)."""
    # Tarjan
    adj = {a: sorted(bs) for a, bs in edges.items()}
    idx: dict[str, int] = {}
    low: dict[str, int] = {}
    stack: list[str] = []
    on: set[str] = set()
    out: list[list[str]] = []
    counter = [0]

    def strong(v: str) -> None:
        idx[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on.add(v)
        for w in adj.get(v, ()):
            if w not in idx:
                strong(w)
                low[v] = min(low[v], low[w])
            elif w in on:
                low[v] = min(low[v], idx[w])
        if low[v] == idx[v]:
            comp = []
            while True:
                w = stack.pop()
                on.discard(w)
                comp.append(w)
                if w == v:
                    break
            if len(comp) > 1:
                out.append(sorted(comp))

    all_nodes = set(adj) | {b for bs in adj.values() for b in bs}
    for v in sorted(all_nodes):
        if v not in idx:
            strong(v)
    return out


# -- blocking work under a held lock ---------------------------------------

def _check_blocking_under_lock(index: ProjectIndex, graph: CallGraph,
                               locks: LockAnalysis) -> list[Finding]:
    edges, sink_sites = _augment_with_sinks(index, graph, rule="lock")
    reader_locks = _reader_shared_locks(graph, locks,
                                        _entry_points(index, graph))
    findings = []
    reported: set[str] = set()
    for qn in sorted(locks.direct):
        fi = index.functions[qn]
        mod = index.modules[fi.module]
        for held, site in locks.held_call_sites(fi):
            if held not in reader_locks:
                continue
            if mod.suppressed(site.call, "lock"):
                continue
            sinks_here: dict[str, list[str]] = {}
            # the call itself may be a sink edge of qn at this site…
            for sink in ("<sink:rpc>", "<sink:sleep>"):
                if (mod.path, site.call.lineno) in \
                        sink_sites.get((qn, sink), ()):
                    sinks_here[sink] = [qn]
            # …or reachable through the callee
            for t in site.targets:
                reach = _reachable(edges, t.qualname)
                for sink in reach & {"<sink:rpc>", "<sink:sleep>"}:
                    path = _shortest(edges, t.qualname, sink) or []
                    sinks_here.setdefault(sink, [qn] + path[:-1])
            for sink, chain in sorted(sinks_here.items()):
                rule = ("rpc-under-lock" if sink == "<sink:rpc>"
                        else "sleep-under-lock")
                what = ("a blocking PMIx RPC" if sink == "<sink:rpc>"
                        else "time.sleep")
                sym = f"{_short(held)}@{_short(qn)}"
                if f"{rule}:{sym}" in reported:
                    continue
                reported.add(f"{rule}:{sym}")
                via = " -> ".join(_short(q) for q in chain)
                findings.append(Finding(
                    CHECKER, rule, sym,
                    f"{what} reachable while holding {held} "
                    f"(via {via})", mod.path, site.call.lineno))
    return findings


def _reader_shared_locks(graph: CallGraph, locks: LockAnalysis,
                         entries: set[str]) -> set[str]:
    """Locks acquired anywhere on a reader-thread path (directly or via
    calls) — the set for which blocking-while-held stalls the frame
    pipeline."""
    shared: set[str] = set()
    for entry in entries:
        shared |= locks.transitive(entry)
    return shared
