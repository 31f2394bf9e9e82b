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
the port).  With ``port=False`` the body runs on the JAX package, over
its own objects.  Either way the logic is the reference's own bytecode,
so every assertion it makes is kept.

The harness entry points named in ``record`` are wrapped so that each
call's return value (every rank's results) is appended to ``out``: a
case runs once per package and the two records are compared.
"""

from __future__ import annotations

import builtins
import importlib
import re
import sys
import types
from typing import Any, Callable

_MODULES = {"tests.mpi.harness": "tests.torch_host_harness"}
_PKG = re.compile(r"\bompi_tpu\b")


def _port_name(name: str) -> str:
    if name in _MODULES:
        return _MODULES[name]
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
        else _PKG.sub("ompi_tpu_torch", c) if isinstance(c, str) else c
        for c in code.co_consts)
    return code.replace(co_consts=consts)


def _is_jax_package(value: Any) -> bool:
    name = (value.__name__ if isinstance(value, types.ModuleType)
            else getattr(value, "__module__", None))
    return isinstance(name, str) and (name == "ompi_tpu"
                                      or name.startswith("ompi_tpu."))


def _port_import(name, globals=None, locals=None, fromlist=(), level=0):
    return builtins.__import__(_port_name(name), globals, locals, fromlist,
                               level)


def mirror(fn: Callable, port: bool, out: list,
           record: tuple = ("run_ranks", "_run_two_jobs")) -> Callable:
    """``fn`` rebuilt over its module's globals for one package; the
    harness entry points in ``record`` append their results to ``out``."""
    ref = sys.modules[fn.__module__]
    g: dict = dict(vars(ref))
    if port:
        for k, v in list(g.items()):
            if not k.startswith("__"):
                g[k] = _port_of(v, k)
        left = sorted(k for k, v in g.items() if _is_jax_package(v))
        assert not left, f"no port counterpart for {left}"
        g["__builtins__"] = dict(vars(builtins), __import__=_port_import)
    for k, v in list(g.items()):
        if isinstance(v, types.FunctionType) and v.__module__ == ref.__name__:
            code = _port_code(v.__code__) if port else v.__code__
            f = types.FunctionType(code, g, v.__name__,
                                   v.__defaults__, v.__closure__)
            f.__kwdefaults__ = v.__kwdefaults__
            g[k] = f
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
