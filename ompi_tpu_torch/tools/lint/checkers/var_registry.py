"""var-registry — every MCA config-var read names a registered variable.

``VarRegistry.get()`` raises ``KeyError`` on an unregistered name, so an
unregistered read is a latent crash on a code path nobody has driven
yet (registration happens at import time of the owning module; a read
in module A of a var registered by module B that A never imports is the
classic failure).  Checks:

- ``unregistered-read``: ``var_registry.get/lookup/set("x")`` /
  ``get_var/set_var("x")`` with no matching ``register_var`` anywhere
  in the tree.  F-string names become regexes and must match ≥1
  registered var.
- ``type-mismatch``: a read of a STRING/STRING_LIST-typed var wrapped
  directly in ``int()``/``float()`` — the coercion will raise on the
  default the moment the var is unset-but-truthy.
- ``unknown-env-read``: an ``OMPI_TPU_*`` environment variable read
  whose name is never *produced* anywhere (no env-dict key, no
  ``environ[...] =`` store, no declared constant) — a typo'd env name
  reads as silently-unset forever.
"""

from __future__ import annotations

import ast
import re
from typing import Optional

from ompi_tpu_torch.tools.lint.finding import Finding
from ompi_tpu_torch.tools.lint.index import (ModuleInfo, ProjectIndex, fstring_regex,
                              iter_calls, literal_str)

CHECKER = "var-registry"
ENV_PREFIX = "OMPI_TPU_"

#: numeric coercions that break on string-typed values
_NUMERIC_WRAPPERS = ("int", "float")
#: registry read/write entry points: attribute form + bare-import form
_REG_ATTR_FUNCS = ("get", "lookup", "set")
_REG_BARE_FUNCS = ("get_var", "set_var")


def run(index: ProjectIndex) -> list[Finding]:
    registered, dynamic = collect_registrations(index)
    findings: list[Finding] = []
    findings += _check_reads(index, registered, dynamic)
    findings += _check_env(index)
    return findings


# -- registration side -----------------------------------------------------

def collect_registrations(index: ProjectIndex
                          ) -> tuple[dict[str, str], list[str]]:
    """(full var name → registered type, dynamic-name regexes).

    Literal registrations land in the dict (synonyms included, mapped
    to the same type).  Registrations whose framework or name is
    computed (loops registering ``f"host_{name}_algorithm"``, the MCA
    framework-selection var built from ``self.name``) become anchored
    regexes with wildcards for the computed parts."""
    out: dict[str, str] = {}
    dynamic: list[str] = []
    for mod in index.modules.values():
        for call in iter_calls(mod.tree):
            if _call_name(call) != "register_var":
                continue
            args = call.args
            if len(args) < 2:
                continue
            fw, name = literal_str(args[0]), literal_str(args[1])
            vtype = _vtype_text(args[2]) if len(args) > 2 else ""
            if fw is not None and name is not None:
                # mirror Var.full_name exactly: keyed on FRAMEWORK
                # truthiness (a frameworkless var is just its name)
                full = f"{fw}_{name}" if fw else name
                out[full] = vtype
            else:
                fw_rx = _part_regex(args[0])
                nm_rx = _part_regex(args[1])
                # mirror Var.full_name: f"{fw}_{name}" when name else fw
                _add_dynamic(dynamic, f"^{fw_rx}_{nm_rx}$" if nm_rx
                             else f"^{fw_rx}_$")
            for kw in call.keywords:
                if kw.arg == "synonyms" \
                        and isinstance(kw.value, (ast.Tuple, ast.List)):
                    for el in kw.value.elts:
                        syn = literal_str(el)
                        if syn is not None:
                            out[syn] = vtype
                        else:
                            rx = _part_regex(el)
                            if rx:
                                _add_dynamic(dynamic, f"^{rx}$")
    return out, dynamic


def _add_dynamic(dynamic: list[str], rx: str) -> None:
    """Keep a dynamic-registration regex only when it retains SOME
    literal content — a pure-wildcard pattern ('^.+?$' from a fully
    computed synonym) would match every read and void the checker."""
    if rx.replace(".+?", "").strip("^$"):
        dynamic.append(rx)


def _part_regex(node: ast.expr) -> str:
    """One register_var argument → regex fragment: literals escaped,
    f-string interpolations and plain names become wildcards."""
    lit = literal_str(node)
    if lit is not None:
        return re.escape(lit)
    rx = fstring_regex(node)
    if rx is not None:
        return rx[1:-1]   # strip the anchors; caller re-anchors
    return ".+?"


def _vtype_text(node: ast.expr) -> str:
    lit = literal_str(node)
    if lit is not None:
        return lit
    if isinstance(node, ast.Attribute):       # VarType.DOUBLE
        return node.attr.lower()
    return ""


def _call_name(call: ast.Call) -> str:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return ""


# -- read side -------------------------------------------------------------

def _registry_read_name(call: ast.Call) -> Optional[ast.expr]:
    """The name-argument node of a registry read/write, else None."""
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr in _REG_ATTR_FUNCS:
        recv = f.value
        recv_txt = recv.id if isinstance(recv, ast.Name) else (
            recv.attr if isinstance(recv, ast.Attribute) else "")
        if "registry" not in recv_txt:
            return None   # dict.get / env.get / etc.
        # only the VAR registry: pvar_registry.lookup takes pvar names
        if "var_registry" not in recv_txt or "pvar" in recv_txt:
            return None
        return call.args[0] if call.args else None
    if isinstance(f, ast.Name) and f.id in _REG_BARE_FUNCS:
        return call.args[0] if call.args else None
    return None


def _check_reads(index: ProjectIndex, registered: dict[str, str],
                 dynamic: list[str]) -> list[Finding]:
    findings: list[Finding] = []
    names = sorted(registered)
    for mod in index.modules.values():
        wrappers = _numeric_wrapper_map(mod)
        for call in iter_calls(mod.tree):
            arg = _registry_read_name(call)
            if arg is None:
                continue
            lit = literal_str(arg)
            if lit is not None:
                if lit not in registered \
                        and not any(re.match(rx, lit)
                                    for rx in dynamic):
                    if mod.suppressed(call, "var"):
                        continue
                    findings.append(Finding(
                        CHECKER, "unregistered-read", lit,
                        f"config var {lit!r} is read but never "
                        f"registered (register_var)",
                        mod.path, call.lineno))
                elif lit in registered:
                    findings += _type_check(mod, call, lit,
                                            registered[lit], wrappers)
                continue
            rx = fstring_regex(arg)
            if rx is not None:
                # a dynamic read matches a literal registration, or a
                # dynamic registration with the same literal skeleton
                if not any(re.match(rx, n) for n in names) \
                        and not any(_skeleton(rx) == _skeleton(d)
                                    for d in dynamic):
                    if mod.suppressed(call, "var"):
                        continue
                    findings.append(Finding(
                        CHECKER, "unregistered-read", rx,
                        f"dynamic config-var read {rx!r} matches no "
                        f"registered variable",
                        mod.path, call.lineno))
            # non-literal, non-f-string args are uncheckable; skip
    return findings


def _skeleton(rx: str) -> str:
    """A name-regex reduced to its literal skeleton (wildcards
    unified) so dynamic reads and dynamic registrations compare."""
    return rx.replace(".+?", "*")


def _numeric_wrapper_map(mod: ModuleInfo) -> dict[int, str]:
    """id(inner read call) → wrapping numeric coercion name, for reads
    written as ``int(var_registry.get("x"))`` (also through a single
    ``or`` default: ``int(get(...) or 0)``)."""
    out: dict[int, str] = {}
    for call in iter_calls(mod.tree):
        fn = call.func
        if not (isinstance(fn, ast.Name)
                and fn.id in _NUMERIC_WRAPPERS and call.args):
            continue
        inner = call.args[0]
        if isinstance(inner, ast.BoolOp):
            inner = inner.values[0]
        if isinstance(inner, ast.Call):
            out[id(inner)] = fn.id
    return out


def _type_check(mod: ModuleInfo, call: ast.Call, name: str, vtype: str,
                wrappers: dict[int, str]) -> list[Finding]:
    wrap = wrappers.get(id(call))
    if wrap and vtype in ("string", "string_list"):
        if mod.suppressed(call, "var"):
            return []
        return [Finding(
            CHECKER, "type-mismatch", name,
            f"{vtype}-typed var {name!r} wrapped in {wrap}() — "
            f"coercion raises on non-numeric values",
            mod.path, call.lineno)]
    return []


# -- environment side ------------------------------------------------------

def _check_env(index: ProjectIndex) -> list[Finding]:
    produced: set[str] = set()
    reads: list[tuple[ModuleInfo, ast.AST, str]] = []
    for mod in index.modules.values():
        for node in ast.walk(mod.tree):
            # reads: environ.get("X") / environ["X"] loads
            if isinstance(node, ast.Call):
                f = node.func
                if (isinstance(f, ast.Attribute)
                        and f.attr in ("get", "pop", "setdefault")
                        and _is_environ(f.value) and node.args):
                    nm = _env_name(mod, node.args[0])
                    if nm:
                        if f.attr == "get":
                            reads.append((mod, node, nm))
                        else:   # pop/setdefault touch implies produced
                            produced.add(nm)
            elif isinstance(node, ast.Subscript):
                nm = _env_name(mod, node.slice)
                if not nm:
                    continue
                if _is_environ(node.value):
                    if isinstance(node.ctx, ast.Store):
                        produced.add(nm)
                    elif isinstance(node.ctx, ast.Del):
                        produced.add(nm)
                    else:
                        reads.append((mod, node, nm))
                elif isinstance(node.ctx, ast.Store):
                    # env["X"] = … on any dict builds a child environment
                    produced.add(nm)
            elif isinstance(node, ast.Dict):
                for k in node.keys:
                    nm = k is not None and _env_name(mod, k)
                    if nm:
                        produced.add(nm)
            elif isinstance(node, (ast.Tuple, ast.List, ast.Set)):
                # passthrough tables: ("OMPI_TPU_RESTART", …)
                for el in node.elts:
                    nm = _env_name(mod, el)
                    if nm:
                        produced.add(nm)
            elif isinstance(node, ast.Assign):
                v = literal_str(node.value)
                if v and v.startswith(ENV_PREFIX):
                    produced.add(v)   # ENV_URI = "OMPI_TPU_HNP_URI"
    findings = []
    for mod, node, nm in reads:
        if nm.startswith(ENV_PREFIX + "MCA_"):
            continue   # the registry's own env channel, always dynamic
        if nm not in produced and not mod.suppressed(node, "env"):
            findings.append(Finding(
                CHECKER, "unknown-env-read", nm,
                f"env var {nm!r} is read but never produced or "
                f"declared anywhere in the tree (typo?)",
                mod.path, getattr(node, "lineno", 0)))
    return findings


def _is_environ(node: ast.expr) -> bool:
    txt = ""
    if isinstance(node, ast.Attribute):
        txt = node.attr
    elif isinstance(node, ast.Name):
        txt = node.id
    return txt == "environ"


def _env_name(mod: ModuleInfo, node: ast.expr) -> Optional[str]:
    lit = literal_str(node)
    if lit is None and isinstance(node, ast.Name):
        lit = mod.constants.get(node.id)
    if lit is not None and lit.startswith(ENV_PREFIX):
        return lit
    return None
