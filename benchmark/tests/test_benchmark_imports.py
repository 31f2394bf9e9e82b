"""Nothing under benchmark/ imports JAX or the JAX package, and the
reference imports nothing of the program: each imported module's
top-level name (the part before the first dot) is compared whole, since
the port's name begins with the JAX package's."""

from __future__ import annotations

import ast
import os

from benchmark import core

from .conftest import REAL

JAX = {"jax", "jaxlib", "flax", "ompi_tpu"}
#: the reference and the harness modules it may use
REFERENCE = ("reference.py", "checks.py", "weights.py", "roofline.py")


def _imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
            out |= {f"{node.module}.{a.name}" for a in node.names}
    return out


def _sources():
    for d, _, files in os.walk(REAL):
        if ".pycache" in d or "__pycache__" in d:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere():
    for path in _sources():
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & JAX, (path, tops & JAX)


def test_reference_imports_nothing_of_the_program():
    for name in REFERENCE:
        tops = {m.split(".")[0] for m in _imports(os.path.join(REAL, name))}
        assert "ompi_tpu_torch" not in tops and not tops & JAX, name
        assert tops <= {"__future__", "math", "statistics", "torch",
                        "benchmark", "typing"}, (name, tops)
        for m in _imports(os.path.join(REAL, name)):
            if m.startswith("benchmark."):
                assert m.split(".")[1] + ".py" in REFERENCE, (name, m)


def test_forbidden_modules_compares_whole_names():
    assert core.forbidden_modules(["ompi_tpu_torch", "ompi_tpu_torch.ops",
                                   "jaxtyping", "numpy"]) == []
    assert core.forbidden_modules(["jax.numpy", "ompi_tpu.models",
                                   "flax", "torch"]) == [
        "flax", "jax.numpy", "ompi_tpu.models"]
