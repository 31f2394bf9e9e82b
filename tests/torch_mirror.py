"""Run a JAX-package test body through both packages.

``mirror(fn, port)`` returns ``fn`` — a test function of a module under
``tests/mpi`` — rebuilt over a copy of its module's globals in which
every name that came from the JAX package (``ompi_tpu.*``: modules,
classes, functions) is the port's object of the same path, the JAX
package's in-process harness (``tests.mpi.harness``) is the port's
(``tests.torch_host_harness``), and every function defined in that
module is rebuilt the same way, so the body's helpers, fixtures and
nested functions all run on the port.  An ``import`` inside a body is
translated the same way (the rebuilt globals carry an ``__import__``
that maps the names), and so is the package name in the body's string
constants (a child program a spawn case writes and launches imports
the port; a path ``examples/<name>.py`` is the port's example of that
name); the repo's linter (``tools.lint``, its modules and the
``python -m tools.lint`` a body launches) is the port's
(``ompi_tpu_torch.tools.lint``).  With ``port=False`` the body runs on
the JAX package, over its own objects.  Either way the logic is the reference's own bytecode,
so every assertion it makes is kept.

The harness entry points named in ``record`` are wrapped so that each
call's return value (every rank's results) is appended to ``out``: a
case runs once per package and the two records are compared.  A helper
the body imported from another test module named in ``follow`` is
rebuilt over that module's globals the same way, and a
``contextlib.contextmanager`` helper is rebuilt through the function it
wraps.

``cases(mod)`` lists every test function of a reference module as
``pytest.param`` cases, its ``parametrize`` marks and its own
parametrised fixtures expanded, and ``run_case`` runs one of them on one
package: the module's fixtures are rebuilt and run over the mirrored
globals, a parameter value that is a JAX-package object is the port's,
and any other fixture (``tmp_path``, ``monkeypatch``) is pytest's.
"""

from __future__ import annotations

import builtins
import contextlib
import importlib
import inspect
import itertools
import re
import sys
import types
from typing import Any, Callable

import pytest

_MODULES = {"tests.mpi.harness": "tests.torch_host_harness",
            "tools.lint": "ompi_tpu_torch.tools.lint"}
_PKG = re.compile(r"\bompi_tpu\b")
_LINT = re.compile(r"(?<![\w.])tools\.lint\b")
_EXAMPLE = re.compile(r"^examples/(\w+\.py)$")


def _port_name(name: str) -> str:
    if name in _MODULES:
        return _MODULES[name]
    if name.startswith("tools.lint."):
        return _MODULES["tools.lint"] + name[len("tools.lint"):]
    if name == "ompi_tpu" or name.startswith("ompi_tpu."):
        return "ompi_tpu_torch" + name[len("ompi_tpu"):]
    return name


def _port_of(value: Any, key: str) -> Any:
    """The port's object for a JAX-package object bound to ``key``, else
    ``value``.  A module maps by its name, a class or function by its
    module and qualified name, an instance (a registry, a constant
    object) by its class's module and the name it is bound to."""
    if isinstance(value, types.ModuleType):
        name = _port_name(value.__name__)
        return value if name == value.__name__ else \
            importlib.import_module(name)
    mod = getattr(value, "__module__", None)
    qual = getattr(value, "__qualname__", None)
    if not isinstance(mod, str):
        return value
    name = _port_name(mod)
    if name == mod:
        return value
    obj: Any = importlib.import_module(name)
    if not isinstance(qual, str):
        return getattr(obj, key)
    for part in qual.split("."):
        obj = getattr(obj, part)
    return obj


def _port_code(code: types.CodeType) -> types.CodeType:
    """``code`` with the package name in its string constants (and its
    nested functions') rewritten to the port's."""
    consts = tuple(
        _port_code(c) if isinstance(c, types.CodeType)
        else _port_str(c) if isinstance(c, str) else c
        for c in code.co_consts)
    return code.replace(co_consts=consts)


def _port_str(s: str) -> str:
    s = _EXAMPLE.sub(r"ompi_tpu_torch/examples/\1", s)
    return _LINT.sub("ompi_tpu_torch.tools.lint",
                     _PKG.sub("ompi_tpu_torch", s))


def _is_jax_package(value: Any) -> bool:
    name = (value.__name__ if isinstance(value, types.ModuleType)
            else getattr(value, "__module__", None))
    return isinstance(name, str) and (
        name in ("ompi_tpu", "tools.lint")
        or name.startswith(("ompi_tpu.", "tools.lint.")))


def _holds_jax_package(value: Any) -> bool:
    if isinstance(value, (list, tuple)):
        return any(_holds_jax_package(v) for v in value)
    return _is_jax_package(value)


def _port_import(name, globals=None, locals=None, fromlist=(), level=0):
    return builtins.__import__(_port_name(name), globals, locals, fromlist,
                               level)


def _rebuild(v: types.FunctionType, g: dict, port: bool) -> Callable:
    if v.__code__.co_filename == contextlib.__file__ and hasattr(
            v, "__wrapped__"):
        return contextlib.contextmanager(_rebuild(v.__wrapped__, g, port))
    code = _port_code(v.__code__) if port else v.__code__
    f = types.FunctionType(code, g, v.__name__, v.__defaults__,
                           v.__closure__)
    f.__kwdefaults__ = v.__kwdefaults__
    return f


def mirror(fn: Callable, port: bool, out: list,
           record: tuple = ("run_ranks", "_run_two_jobs"),
           follow: tuple = (), extra: dict | None = None) -> Callable:
    """``fn`` rebuilt over its module's globals for one package; the
    harness entry points in ``record`` append their results to ``out``,
    and helpers imported from the test modules in ``follow`` are rebuilt
    over their own modules' globals.  On the port, ``extra`` rebinds
    module globals the JAX package made that no name maps (a library
    handle the JAX package's loader returned)."""
    ref = sys.modules[fn.__module__]
    g: dict = dict(vars(ref))
    if port:
        for k, v in list(g.items()):
            if not k.startswith("__"):
                g[k] = (_port_value(v) if isinstance(v, (list, tuple))
                        else _port_of(v, k))
        g.update(extra or {})
        left = sorted(k for k, v in g.items() if _holds_jax_package(v))
        assert not left, f"no port counterpart for {left}"
        g["__builtins__"] = dict(vars(builtins), __import__=_port_import)
    for k, v in list(g.items()):
        if not isinstance(v, types.FunctionType):
            continue
        if v.__module__ == ref.__name__:
            g[k] = _rebuild(v, g, port)
        elif v.__module__ in follow:
            g[k] = mirror(v, port, out, record, extra=extra)
    for k in record:
        if k in g:
            g[k] = _recording(g[k], out)
    return g[fn.__name__]


def _recording(run: Callable, out: list) -> Callable:
    def wrapped(*args, **kwargs):
        res = run(*args, **kwargs)
        out.append(res)
        return res

    return wrapped


# ---------------------------------------------------------------------------
# cases of a reference module
# ---------------------------------------------------------------------------

def _fixtures(mod) -> dict:
    """The fixtures a reference module defines: name → (function,
    params, ids, autouse)."""
    out = {}
    for k, v in vars(mod).items():
        marker = getattr(v, "_fixture_function_marker", None)
        if marker is not None:
            out[marker.name or k] = (v._get_wrapped_function(),
                                     marker.params, marker.ids,
                                     marker.autouse)
    return out


def _ident(v: Any, i: int, name: str) -> str:
    if v is None or isinstance(v, (bool, int, float, str)):
        return str(v)
    return f"{name}{i}"


def _axes(fn, fix: dict) -> list[list[tuple[dict, str]]]:
    """One axis a ``parametrize`` mark or parametrised fixture: its
    cases as (argument values, id part)."""
    axes = []
    for mark in reversed(getattr(fn, "pytestmark", [])):
        if mark.name != "parametrize":
            continue
        names, values = mark.args[0], mark.args[1]
        if isinstance(names, str):
            names = [n.strip() for n in names.split(",") if n.strip()]
        ids = mark.kwargs.get("ids")
        axis = []
        for i, v in enumerate(values):
            if hasattr(v, "values") and hasattr(v, "marks"):
                v = v.values if len(names) > 1 else v.values[0]
            vals = tuple(v) if len(names) > 1 else (v,)
            if ids is not None and not callable(ids):
                part = str(ids[i])
            else:
                part = "-".join(_ident(x, i, n) for x, n in zip(vals, names))
            axis.append((dict(zip(names, vals)), part))
        axes.append(axis)
    for p in inspect.signature(fn).parameters:
        if p in fix and fix[p][1] is not None:
            params, ids = fix[p][1], fix[p][2]
            axes.append([({"@" + p: i},
                          str(ids[i]) if ids else _ident(v, i, p))
                         for i, v in enumerate(params)])
    return axes


def cases(mod, skip: tuple = ()) -> list:
    """Every test function of ``mod`` (less ``skip``) as
    ``pytest.param(name, params)`` cases with the reference's own ids."""
    fix = _fixtures(mod)
    out = []
    for name, fn in vars(mod).items():
        if not (name.startswith("test_") and inspect.isfunction(fn)
                and fn.__module__ == mod.__name__) or name in skip:
            continue
        axes = _axes(fn, fix)
        for combo in itertools.product(*axes):
            params: dict = {}
            for d, _ in combo:
                params.update(d)
            ident = name + ("[" + "-".join(p for _, p in combo) + "]"
                            if combo else "")
            out.append(pytest.param(name, params, id=ident))
    return out


def _port_value(v: Any) -> Any:
    """The port's counterpart of a parameter value a reference module
    made: a JAX-package module, class or function maps by name, an
    instance (an op, a constant) by the name its module binds it to;
    containers map item by item."""
    if isinstance(v, (list, tuple)):
        return type(v)(_port_value(x) for x in v)
    if not _is_jax_package(v):
        return v
    if isinstance(v, types.ModuleType) or hasattr(v, "__qualname__"):
        return _port_of(v, "")
    src = sys.modules[type(v).__module__]
    key = next(k for k, x in vars(src).items() if x is v)
    return _port_of(v, key)


def run_case(mod, name: str, params: dict, port: bool, request,
             out: list, follow: tuple = (),
             fixtures: dict | None = None,
             extra: dict | None = None) -> Any:
    """Run the reference case ``name`` of ``mod`` on one package.  A
    fixture the module defines runs rebuilt over the mirrored globals
    (its parameter from ``params``); ``fixtures`` overrides one by name
    with a fixture function of the caller's; pytest supplies the rest."""
    fn = mirror(getattr(mod, name), port, out, follow=follow, extra=extra)
    g = fn.__globals__
    fix = _fixtures(mod)
    fixtures = fixtures or {}
    with contextlib.ExitStack() as stack:
        got: dict = {}

        def value(p: str) -> Any:
            if p in got:
                return got[p]
            if p in params:
                got[p] = _port_value(params[p]) if port else params[p]
            elif p in fixtures or p in fix:
                f = fixtures[p] if p in fixtures else \
                    _rebuild(fix[p][0], g, port)
                i = params.get("@" + p)
                kw = {}
                for q in inspect.signature(f).parameters:
                    kw[q] = (types.SimpleNamespace(
                        param=None if i is None else fix[p][1][i],
                        node=request.node, getfixturevalue=value)
                        if q == "request" else value(q))
                res = f(**kw)
                if inspect.isgenerator(res):
                    gen = res
                    res = next(gen)
                    stack.callback(next, gen, None)
                got[p] = res
            else:
                got[p] = request.getfixturevalue(p)
            return got[p]

        for p, (_f, _params, _ids, autouse) in fix.items():
            if autouse:
                value(p)
        kw = {p: value(p) for p in inspect.signature(fn).parameters}
        return fn(**kw)


def both_case(mod, name: str, params: dict, request, follow: tuple = (),
              fixtures: dict | None = None,
              extra: dict | None = None) -> None:
    """Run the reference case on the JAX package, then on the port; the
    results its harness calls returned must be equal, bit for bit
    (compared in repr order: a body may run two harnesses on threads,
    which finish in either order).  A ``tmp_path`` gives each run a
    directory of its own."""
    from tests.test_torch_host_p2p import _same

    outs = []
    for port in (False, True):
        fx = dict(fixtures or {})
        if "tmp_path" in inspect.signature(getattr(mod, name)).parameters \
                or "tmp_path" in _fixture_args(mod):
            sub = request.getfixturevalue("tmp_path") / (
                "port" if port else "jax")
            sub.mkdir(exist_ok=True)
            fx.setdefault("tmp_path", _const(sub))
        out: list = []
        run_case(mod, name, params, port, request, out, follow, fx,
                 extra if port else None)
        outs.append(sorted(out, key=repr))
    _same(outs[0], outs[1])


def _const(v: Any) -> Callable[[], Any]:
    return lambda: v


def _fixture_args(mod) -> set:
    return {q for f, *_ in _fixtures(mod).values()
            for q in inspect.signature(f).parameters}
