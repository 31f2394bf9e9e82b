"""reader-thread — no blocking calls on transport reader paths.

The contract every transport layer repeats ("BTL reader thread: never
block, sends only via the worker queue") is exactly the reference's
event-loop-callback discipline — and the same violation was fixed
twice (an adoption notice RPC'd straight from ``peer_reincarnated`` on
a reader thread).  This checker makes the rule mechanical: classify
every function reachable from a reader-thread entry point and flag

- ``rpc-on-reader``: a blocking PMIx RPC (``PMIxClient._rpc`` or any
  client method that transitively calls it),
- ``sleep-on-reader``: ``time.sleep``,
- ``subprocess-on-reader``: any ``subprocess.*`` call,
- ``park-on-reader``: a native GIL-released park
  (``_native/arena.c``'s ``ompi_tpu_arena_wait*`` /
  ``ompi_tpu_ring_wait_any`` via ctypes) — the APPROVED blocking form
  for a read/poll loop's own idle window (those entries are exempt,
  any depth: parking is the loop's job), but still a block that must
  not ride a frame-dispatch path (``_on_frame``/``on_ft_frame``/rml
  callbacks), where it would stall every peer behind one wait

on those paths.  Entry points are (a) the configured transport read
loops below and (b) every callback registered via ``register_recv``
(rml handlers run on the link reader thread, per the RmlNode module
doc).

A call a reader path is *allowed* to make (hand-off wrappers, spawn-
and-return helpers) is waived with ``# lint: reader-ok`` on the call
line; paths through a thread-spawn boundary (``threading.Thread``
targets are separate stacks) are not followed because the Thread
constructor only stores the callable — the call graph never links
through it.
"""

from __future__ import annotations

import ast

from ompi_tpu_torch.tools.lint.callgraph import CallGraph
from ompi_tpu_torch.tools.lint.finding import Finding
from ompi_tpu_torch.tools.lint.index import FunctionInfo, ProjectIndex, iter_calls

CHECKER = "reader-thread"

#: qualname suffixes of the transport read loops (entry points beyond
#: the auto-collected register_recv callbacks).  Fixture trees provide
#: their own read loops under the same names.
ENTRY_SUFFIXES = (
    "._read_loop",        # RmlNode / TcpBTL link readers
    "._accept_loop",      # listener threads (same no-block contract)
    "._poll_loop",        # btl_shm ring poller
    "._on_frame",         # PML frame dispatch (called by BTL readers)
    ".on_ft_frame",       # FT control dispatch (same thread)
)

_SINK_RULES = {
    "<sink:rpc>": ("rpc-on-reader",
                   "a blocking PMIx RPC"),
    "<sink:sleep>": ("sleep-on-reader",
                     "time.sleep"),
    "<sink:subprocess>": ("subprocess-on-reader",
                          "a subprocess call"),
    "<sink:native-park>": ("park-on-reader",
                           "a native GIL-released park"),
}

#: the ctypes entry points of _native/arena.c that BLOCK (bounded
#: slices, but blocks nonetheless) — recognized as sinks wherever the
#: library handle is called through an attribute
NATIVE_PARK_ATTRS = frozenset({
    "ompi_tpu_arena_wait", "ompi_tpu_arena_wait_all",
    "ompi_tpu_arena_wait_change", "ompi_tpu_ring_wait_any",
    # btl/tcp native plane: bounded GIL-released network parks
    "ompi_tpu_net_poll", "ompi_tpu_net_recv_into", "ompi_tpu_net_writev",
    "ompi_tpu_net_send3",
})


def run(index: ProjectIndex) -> list[Finding]:
    graph = CallGraph.of(index)
    edges, sink_sites = _augment_with_sinks(index, graph)
    entries = _entry_points(index, graph)

    findings: list[Finding] = []
    reported: set[tuple[str, str]] = set()
    for entry in sorted(entries):
        reach = _reachable(edges, entry)
        for sink, (rule, what) in sorted(_SINK_RULES.items()):
            if sink not in reach:
                continue
            path = _shortest(edges, entry, sink)
            via = path[-2] if path and len(path) >= 2 else entry
            if (sink == "<sink:sleep>" and via == entry
                    and entry.rsplit(".", 1)[-1].endswith("_loop")):
                continue   # a read/poll loop's own idle pacing sleep
            if (sink == "<sink:native-park>"
                    and entry.rsplit(".", 1)[-1].endswith("_loop")):
                # the GIL-released park IS the approved idle form for a
                # poll/read loop (any depth: the park helper is one hop)
                continue
            key = (rule, f"{entry}->{via}")
            if key in reported:
                continue
            reported.add(key)
            site = (sink_sites.get((via, sink)) or [("", 0)])[0]
            chain = " -> ".join(_short(q) for q in (path or [entry]))
            findings.append(Finding(
                CHECKER, rule, f"{_short(entry)}->{_short(via)}",
                f"reader-thread entry {_short(entry)} reaches {what}: "
                f"{chain}", site[0], site[1]))
    return findings


# -- entry points ----------------------------------------------------------

#: attribute hooks invoked from link reader threads (RmlNode calls
#: ``on_peer_lost`` straight from ``_read_loop``; ProcBTL calls
#: ``on_fast`` — the PML's compiled fast-lane dispatch — from its
#: reader) — an assignment ``x.on_peer_lost = self._cb`` makes
#: ``_cb`` a reader entry
HOOK_ATTRS = ("on_peer_lost", "on_fast", "on_frame", "on_ctrl")


def _entry_points(index: ProjectIndex, graph: CallGraph) -> set[str]:
    entries: set[str] = set()

    def add(target: FunctionInfo | None) -> None:
        if target is not None:
            tmod = index.modules[target.module]
            if not tmod.suppressed(target.node, "reader"):
                entries.add(target.qualname)

    for fi in index.iter_functions():
        qn = fi.qualname
        if any(qn.endswith(sfx) for sfx in ENTRY_SUFFIXES):
            mod = index.modules[fi.module]
            if not mod.suppressed(fi.node, "reader"):
                entries.add(qn)
    for fi in index.iter_functions():
        mod = index.modules[fi.module]
        # register_recv callbacks run on the rml link reader thread —
        # including what a lambda wrapper calls (`lambda o, p:
        # self._on_x(...)` is the common adapter form)
        for call in iter_calls(fi.node):
            f = call.func
            if not (isinstance(f, ast.Attribute)
                    and f.attr == "register_recv"
                    and len(call.args) >= 2):
                continue
            cb = call.args[1]
            if isinstance(cb, ast.Lambda):
                for inner in iter_calls(cb.body):
                    targets, _recv = graph._resolve(mod, fi, inner)
                    for t in targets:
                        add(t)
                continue
            add(_resolve_callback(graph, fi, cb))
        # reader-thread hook attributes (x.on_peer_lost = self._cb)
        for node in ast.walk(fi.node):
            if not isinstance(node, ast.Assign):
                continue
            for tgt in node.targets:
                if isinstance(tgt, ast.Attribute) \
                        and tgt.attr in HOOK_ATTRS:
                    add(_resolve_callback(graph, fi, node.value))
    return entries


def _resolve_callback(graph: CallGraph, caller: FunctionInfo,
                      cb: ast.expr) -> FunctionInfo | None:
    if isinstance(cb, ast.Attribute) and isinstance(cb.value, ast.Name) \
            and cb.value.id == "self" and caller.cls:
        ci = graph.index.classes[caller.cls]
        return graph._resolve_method(ci, cb.attr)
    if isinstance(cb, ast.Name):
        mod = graph.index.modules[caller.module]
        return graph._resolve_bare(mod, cb.id)
    return None


# -- sinks -----------------------------------------------------------------

def _augment_with_sinks(index: ProjectIndex, graph: CallGraph,
                        rule: str = "reader"
                        ) -> tuple[dict[str, set[str]],
                                   dict[tuple[str, str],
                                        list[tuple[str, int]]]]:
    """A copy of the call-graph edges with pseudo sink nodes wired in,
    minus ``# lint: <rule>-ok``-waived call sites.
    Returns (edges, (caller, sink) → EVERY call-site location) — all
    sites, because a consumer may need to know whether one specific
    call (e.g. the one under a lock) is the sink, not merely that the
    function contains one somewhere."""
    rpc_methods = _rpc_method_names(index, graph)
    edges = graph.edges_excluding(rule)
    sites: dict[tuple[str, str], list[tuple[str, int]]] = {}

    for qn, call_sites in graph.sites.items():
        fi = graph.index.functions[qn]
        mod = index.modules[fi.module]
        for cs in call_sites:
            f = cs.call.func
            sink = None
            if isinstance(f, ast.Attribute):
                recv = cs.receiver.lower()
                if f.attr == "sleep" and recv.endswith("time"):
                    sink = "<sink:sleep>"
                elif recv.split(".")[-1] == "subprocess" \
                        or (f.attr == "Popen"
                            and "subprocess" in recv):
                    sink = "<sink:subprocess>"
                elif f.attr in rpc_methods and _rpc_receiver(
                        recv, f.attr):
                    sink = "<sink:rpc>"
                elif f.attr == "_rpc" and cs.targets \
                        and any(t.qualname.endswith("._rpc")
                                for t in cs.targets):
                    sink = "<sink:rpc>"
                elif f.attr in NATIVE_PARK_ATTRS:
                    sink = "<sink:native-park>"
            elif isinstance(f, ast.Name):
                # bare-imported forms: `from time import sleep`,
                # `from subprocess import run/Popen/check_call…`
                src = str(mod.from_imports.get(f.id, ("", ""))[0])
                orig = str(mod.from_imports.get(f.id, ("", f.id))[1])
                if src == "time" and orig == "sleep":
                    sink = "<sink:sleep>"
                elif src == "subprocess":
                    sink = "<sink:subprocess>"
            if sink is None:
                continue
            if mod.suppressed(cs.call, rule):
                continue
            edges.setdefault(qn, set()).add(sink)
            sites.setdefault((qn, sink), []).append(
                (mod.path, cs.call.lineno))
    return edges, sites


#: rpc method names that also live on dicts/queues/etc. — for these the
#: receiver must literally BE the client, not merely mention one
#: (``self._client_epoch.get(...)`` is a dict read, not an RPC)
_GENERIC_RPC_NAMES = frozenset(
    {"get", "put", "abort", "fence", "barrier", "finalize", "set"})


def _rpc_receiver(recv: str, attr: str) -> bool:
    """Does the receiver text plausibly denote the PMIx client?"""
    last = recv.split(".")[-1]
    if attr in _GENERIC_RPC_NAMES:
        return last in ("client", "_client") or last.endswith("pmix")
    return "client" in recv or "pmix" in recv


def _rpc_method_names(index: ProjectIndex, graph: CallGraph
                      ) -> set[str]:
    """Method names of the client class (the one defining ``_rpc``)
    that transitively reach ``_rpc`` — each is a blocking RPC."""
    names: set[str] = set()
    for ci in index.classes.values():
        if "_rpc" not in ci.methods:
            continue
        rpc_qn = ci.methods["_rpc"].qualname
        for mname, mfi in ci.methods.items():
            if rpc_qn in graph.reachable(mfi.qualname):
                names.add(mname)
    names.discard("__init__")   # construction is a connect, not a call
    return names


# -- graph helpers ---------------------------------------------------------

def _reachable(edges: dict[str, set[str]], start: str) -> set[str]:
    seen: set[str] = set()
    stack = [start]
    while stack:
        qn = stack.pop()
        if qn in seen:
            continue
        seen.add(qn)
        stack.extend(edges.get(qn, ()))
    return seen


def _shortest(edges: dict[str, set[str]], start: str,
              goal: str) -> list[str] | None:
    from collections import deque

    prev: dict[str, str | None] = {start: None}
    q = deque([start])
    while q:
        qn = q.popleft()
        if qn == goal:
            path = [qn]
            while prev[path[-1]] is not None:
                path.append(prev[path[-1]])  # type: ignore[arg-type]
            return list(reversed(path))
        for nxt in sorted(edges.get(qn, ())):
            if nxt not in prev:
                prev[nxt] = qn
                q.append(nxt)
    return None


def _short(qualname: str) -> str:
    parts = qualname.split(".")
    return ".".join(parts[-2:]) if len(parts) > 1 else qualname
