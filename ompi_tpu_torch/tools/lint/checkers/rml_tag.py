"""rml-tag — every tag sent over the rml bus has a recv handler.

``RmlNode._deliver`` drops a tagged message with no registered handler
(a verbose log line nobody reads) — so a sent-but-never-registered tag
is a protocol message that silently vanishes, and a TAG_* constant
nobody sends or receives is dead wire protocol.  Checks:

- ``unhandled-send``: a ``TAG_X`` constant passed to
  ``xcast/send_up/send_direct/send_hop/send_child`` with no
  ``register_recv(TAG_X, …)`` anywhere in the tree.
- ``dead-tag``: a ``TAG_X = "…"`` definition neither sent nor
  registered anywhere (wire protocol that can never fire).
- ``unsent-handler``: a handler registered for a tag nothing ever
  sends (dead dispatch arm).
- ``unknown-tag``: a ``TAG_*`` name sent or registered that no bus
  module defines (a typo'd constant would be an AttributeError at
  runtime — on the failure path where it was finally exercised).

Forwarded/variable tags (``xcast(tag, …)`` relays) are ignored, and
only ``TAG_*`` constants defined in a *bus module* (one whose classes
offer ``register_recv``) participate — the coll p2p tag space and
compat constants are MPI message tags, not bus wire protocol.
"""

from __future__ import annotations

import ast

from ompi_tpu_torch.tools.lint.finding import Finding
from ompi_tpu_torch.tools.lint.index import ProjectIndex, iter_calls

CHECKER = "rml-tag"
_SEND_FUNCS = ("xcast", "send_up", "send_direct", "send_hop",
               "send_child")


def run(index: ProjectIndex) -> list[Finding]:
    defined: dict[str, tuple[str, int]] = {}   # TAG name → (path, line)
    sent: dict[str, tuple[str, int]] = {}
    registered: dict[str, tuple[str, int]] = {}

    # TAG_* constants participate only when defined in a *bus* module —
    # one whose classes offer register_recv (rml.py).  Other TAG_
    # namespaces (the coll p2p tag space, compat constants) are MPI
    # message tags, not bus wire protocol.
    bus_modules = {
        mod.name for mod in index.modules.values()
        if any("register_recv" in ci.methods
               for ci in mod.classes.values())}
    for mod in index.modules.values():
        if mod.name in bus_modules:
            for node in mod.tree.body:
                if isinstance(node, ast.Assign):
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name) \
                                and tgt.id.startswith("TAG_"):
                            defined.setdefault(tgt.id,
                                               (mod.path, node.lineno))
    for mod in index.modules.values():
        for call in iter_calls(mod.tree):
            fname = _func_name(call)
            if fname in _SEND_FUNCS:
                for tag in _tag_args(call):
                    sent.setdefault(tag, (mod.path, call.lineno))
            elif fname == "register_recv":
                for tag in _tag_args(call):
                    registered.setdefault(tag, (mod.path, call.lineno))

    findings: list[Finding] = []
    for tag, (path, line) in sorted({**sent, **registered}.items()):
        if tag not in defined:
            findings.append(Finding(
                CHECKER, "unknown-tag", tag,
                f"{tag} is used on the bus but defined in no bus "
                f"module (typo?)", path, line))
    sent = {t: v for t, v in sent.items() if t in defined}
    registered = {t: v for t, v in registered.items() if t in defined}
    for tag, (path, line) in sorted(sent.items()):
        if tag not in registered:
            findings.append(Finding(
                CHECKER, "unhandled-send", tag,
                f"{tag} is sent but no register_recv handler exists "
                f"anywhere — the message is silently dropped",
                path, line))
    for tag, (path, line) in sorted(defined.items()):
        if tag not in sent and tag not in registered:
            findings.append(Finding(
                CHECKER, "dead-tag", tag,
                f"{tag} is defined but never sent or handled",
                path, line))
    for tag, (path, line) in sorted(registered.items()):
        if tag in defined and tag not in sent:
            findings.append(Finding(
                CHECKER, "unsent-handler", tag,
                f"a handler is registered for {tag} but nothing ever "
                f"sends it", path, line))
    return findings


def _func_name(call: ast.Call) -> str:
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


def _tag_args(call: ast.Call) -> list[str]:
    out = []
    for arg in call.args:
        if isinstance(arg, ast.Name) and arg.id.startswith("TAG_"):
            out.append(arg.id)
        elif isinstance(arg, ast.Attribute) \
                and arg.attr.startswith("TAG_"):
            out.append(arg.attr)
    return out
