"""Project index — parsed ASTs + symbol tables every checker shares.

One parse of the tree, then cheap cross-file passes: modules, classes,
functions (by qualname and by bare method name), imports, and the AST
utilities the checkers lean on (string-literal extraction, f-string →
regex, receiver text, suppression comments).
"""

from __future__ import annotations

import ast
import os
import re
from typing import Iterator, Optional

__all__ = ["ProjectIndex", "ModuleInfo", "ClassInfo", "FunctionInfo",
           "literal_str", "fstring_regex", "call_target_text",
           "iter_calls", "LOCK_FACTORIES"]

#: threading factories whose product counts as a lock for the
#: lock-order analysis (Condition wraps a lock; Event does NOT).
LOCK_FACTORIES = ("Lock", "RLock", "Condition")


class FunctionInfo:
    """One def (module-level function or method)."""

    __slots__ = ("qualname", "module", "path", "node", "cls")

    def __init__(self, qualname: str, module: str, path: str,
                 node: ast.AST, cls: Optional[str]) -> None:
        self.qualname = qualname    # "pkg.mod.Class.meth" / "pkg.mod.func"
        self.module = module        # dotted module name
        self.path = path            # repo-relative file path
        self.node = node            # ast.FunctionDef / AsyncFunctionDef
        self.cls = cls              # "pkg.mod.Class" or None

    def __repr__(self) -> str:
        return f"FunctionInfo({self.qualname})"


class ClassInfo:
    __slots__ = ("qualname", "module", "node", "bases", "methods",
                 "lock_attrs")

    def __init__(self, qualname: str, module: str,
                 node: ast.ClassDef) -> None:
        self.qualname = qualname
        self.module = module
        self.node = node
        self.bases: list[str] = []          # base-class name texts
        self.methods: dict[str, FunctionInfo] = {}
        #: attr name → factory ("Lock"/"RLock"/"Condition") for
        #: ``self.<attr> = threading.Lock()`` style assignments
        self.lock_attrs: dict[str, str] = {}


class ModuleInfo:
    __slots__ = ("name", "path", "tree", "source_lines", "imports",
                 "from_imports", "functions", "classes", "constants")

    def __init__(self, name: str, path: str, tree: ast.Module,
                 source_lines: list[str]) -> None:
        self.name = name
        self.path = path
        self.tree = tree
        self.source_lines = source_lines
        #: local alias → dotted module ("rml" → "ompi_tpu_torch.runtime.rml")
        self.imports: dict[str, str] = {}
        #: local name → (dotted module, original name)
        self.from_imports: dict[str, tuple[str, str]] = {}
        self.functions: dict[str, FunctionInfo] = {}   # bare name → info
        self.classes: dict[str, ClassInfo] = {}        # bare name → info
        #: module-level NAME = "string constant" bindings
        self.constants: dict[str, str] = {}

    def line(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.source_lines):
            return self.source_lines[lineno - 1]
        return ""

    def suppressed(self, node: ast.AST, rule: str) -> bool:
        """True when the node's line — or the line just above, for
        statements whose waiver comment won't fit inline — carries an
        explicit ``# lint: <rule>-ok`` waiver.  Several rules may share
        one comment: ``# lint: reader-ok lock-ok``."""
        lineno = getattr(node, "lineno", 0)
        for text in (self.line(lineno), self.line(lineno - 1)):
            if "lint:" in text:
                tokens = text.rsplit("lint:", 1)[1].split()
                if f"{rule}-ok" in tokens:
                    return True
        return False


class ProjectIndex:
    """The parsed tree: every .py under the roots, symbol tables built."""

    def __init__(self, root: str) -> None:
        self.root = root
        self.modules: dict[str, ModuleInfo] = {}
        self.functions: dict[str, FunctionInfo] = {}   # qualname → info
        self.classes: dict[str, ClassInfo] = {}        # qualname → info
        self.methods_by_name: dict[str, list[FunctionInfo]] = {}

    # -- construction ----------------------------------------------------

    @classmethod
    def build(cls, root: str, packages: Optional[list[str]] = None,
              exclude: Optional[list[str]] = None) -> "ProjectIndex":
        """Parse every .py under ``root`` (restricted to ``packages``
        top-level dirs when given), skipping ``exclude`` path prefixes,
        __pycache__, and hidden dirs."""
        idx = cls(root)
        exclude = [os.path.normpath(e) for e in (exclude or [])]
        for path in sorted(cls._walk(root, packages, exclude)):
            idx._add_file(path)
        idx._link()
        return idx

    @staticmethod
    def _walk(root: str, packages: Optional[list[str]],
              exclude: list[str]) -> Iterator[str]:
        tops = packages if packages else [""]
        for top in tops:
            base = os.path.join(root, top) if top else root
            for dirpath, dirnames, filenames in os.walk(base):
                rel = os.path.relpath(dirpath, root)
                dirnames[:] = [
                    d for d in dirnames
                    if d != "__pycache__" and not d.startswith(".")
                    and os.path.normpath(os.path.join(rel, d))
                    not in exclude]
                if os.path.normpath(rel) in exclude:
                    continue
                for fn in filenames:
                    if fn.endswith(".py"):
                        yield os.path.join(dirpath, fn)

    def _module_name(self, path: str) -> str:
        rel = os.path.relpath(path, self.root)
        parts = rel[:-3].split(os.sep)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        return ".".join(parts) if parts else "__root__"

    def _add_file(self, path: str) -> None:
        with open(path, encoding="utf-8") as fh:
            src = fh.read()
        try:
            tree = ast.parse(src, filename=path)
        except SyntaxError:
            return  # not this tool's job; py_compile/pytest will say so
        name = self._module_name(path)
        rel = os.path.relpath(path, self.root)
        mod = ModuleInfo(name, rel, tree, src.splitlines())
        self.modules[name] = mod
        self._index_module(mod)

    def _index_module(self, mod: ModuleInfo) -> None:
        for node in mod.tree.body:
            self._index_stmt(mod, node)
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                self._index_import(mod, node)

    def _index_stmt(self, mod: ModuleInfo, node: ast.stmt) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            qn = f"{mod.name}.{node.name}"
            fi = FunctionInfo(qn, mod.name, mod.path, node, None)
            mod.functions[node.name] = fi
            self.functions[qn] = fi
        elif isinstance(node, ast.ClassDef):
            cqn = f"{mod.name}.{node.name}"
            ci = ClassInfo(cqn, mod.name, node)
            ci.bases = [ast.unparse(b) for b in node.bases]
            mod.classes[node.name] = ci
            self.classes[cqn] = ci
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    mqn = f"{cqn}.{sub.name}"
                    fi = FunctionInfo(mqn, mod.name, mod.path, sub,
                                      cqn)
                    ci.methods[sub.name] = fi
                    self.functions[mqn] = fi
                    self.methods_by_name.setdefault(sub.name, []).append(fi)
            self._find_lock_attrs(ci)
        elif isinstance(node, ast.Assign):
            # module-level string constants + module-level locks
            val = literal_str(node.value)
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and val is not None:
                    mod.constants[tgt.id] = val

    def _find_lock_attrs(self, ci: ClassInfo) -> None:
        """``self.<attr> = threading.Lock()`` (Lock/RLock/Condition)
        anywhere in the class body → a lock attribute."""
        for node in ast.walk(ci.node):
            if not (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)):
                continue
            fac = _lock_factory_name(node.value.func)
            if fac is None:
                continue
            for tgt in node.targets:
                if (isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"):
                    ci.lock_attrs[tgt.attr] = fac

    def _index_import(self, mod: ModuleInfo,
                      node: ast.Import | ast.ImportFrom) -> None:
        if isinstance(node, ast.Import):
            for alias in node.names:
                mod.imports[alias.asname or alias.name.split(".")[0]] = \
                    alias.name
        else:
            src = node.module or ""
            if node.level:  # relative import: resolve against the module
                base = mod.name.split(".")
                # drop the module leaf + (level-1) further packages
                base = base[: max(0, len(base) - node.level)]
                src = ".".join(base + ([src] if src else []))
            for alias in node.names:
                mod.from_imports[alias.asname or alias.name] = \
                    (src, alias.name)

    def _link(self) -> None:
        pass  # reserved for cross-module fixups

    # -- queries ----------------------------------------------------------

    def iter_functions(self) -> Iterator[FunctionInfo]:
        yield from self.functions.values()

    def resolve_module(self, mod: ModuleInfo, alias: str
                       ) -> Optional[ModuleInfo]:
        """A local name used as ``alias.x`` → the project module it
        refers to (via ``import m as alias`` or ``from p import m``)."""
        dotted = mod.imports.get(alias)
        if dotted is None and alias in mod.from_imports:
            src, orig = mod.from_imports[alias]
            dotted = f"{src}.{orig}" if src else orig
        if dotted is None:
            return None
        # exact hit, else try the tail (index roots may strip a prefix)
        if dotted in self.modules:
            return self.modules[dotted]
        for name, m in self.modules.items():
            if name == dotted or name.endswith("." + dotted) \
                    or dotted.endswith("." + name):
                return m
        return None

    def find_module(self, suffix: str) -> Optional[ModuleInfo]:
        """Module by dotted-name suffix ('mpi.trace')."""
        for name, m in self.modules.items():
            if name == suffix or name.endswith("." + suffix):
                return m
        return None

    def find_class(self, name: str) -> Optional[ClassInfo]:
        """Class by bare name, unique across the project."""
        hits = [c for qn, c in self.classes.items()
                if qn.rsplit(".", 1)[-1] == name]
        return hits[0] if len(hits) == 1 else None


def _lock_factory_name(func: ast.expr) -> Optional[str]:
    """'threading.Lock' / bare 'Lock' / 'RLock' / 'Condition' → name."""
    if isinstance(func, ast.Attribute) and func.attr in LOCK_FACTORIES:
        return func.attr
    if isinstance(func, ast.Name) and func.id in LOCK_FACTORIES:
        return func.id
    return None


# ---------------------------------------------------------------------------
# AST utilities
# ---------------------------------------------------------------------------

def literal_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def fstring_regex(node: ast.AST) -> Optional[str]:
    """A JoinedStr (f-string) → anchored regex: literal parts escaped,
    each interpolation a non-greedy wildcard.  None for non-f-strings."""
    if not isinstance(node, ast.JoinedStr):
        return None
    parts = []
    for v in node.values:
        if isinstance(v, ast.Constant) and isinstance(v.value, str):
            parts.append(re.escape(v.value))
        else:
            parts.append(".+?")
    return "^" + "".join(parts) + "$"


def call_target_text(call: ast.Call) -> str:
    """The call's func expression as source text ('self.detector.poll')."""
    try:
        return ast.unparse(call.func)
    except Exception:  # noqa: BLE001 — display-only helper
        return "<?>"


def iter_calls(node: ast.AST) -> Iterator[ast.Call]:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            yield sub


def walk_shallow(node: ast.AST) -> Iterator[ast.AST]:
    """``ast.walk`` minus subtrees of nested def/lambda — a nested
    function is another stack (thread target / deferred callback), so
    anything inside it must not be attributed to ``node``'s own
    execution."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        sub = stack.pop()
        if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
            continue
        yield sub
        stack.extend(ast.iter_child_nodes(sub))


def iter_calls_shallow(node: ast.AST) -> Iterator[ast.Call]:
    """Calls lexically in ``node``'s own body — subtrees of nested
    def/lambda are pruned.  The call graph uses this: a closure passed
    as a ``threading.Thread`` target runs on ANOTHER stack (the
    spawn-and-return hand-off every reader handler is supposed to use),
    so its calls must not be attributed to the enclosing function."""
    for sub in walk_shallow(node):
        if isinstance(sub, ast.Call):
            yield sub
