"""The port's sanitizer run (``ompi_tpu_torch/tools/asan_native.sh``), the
counterpart of the repo's ``tools/asan_native.sh``: the four native
executors built with ASan/UBSan to the port loader's own hash-named
paths (``_fastdss_torch-<soabi>`` included), each loaded from its
sanitized, instrumented file, and the port's native tests run clean
under the preloaded runtimes.

The sanitized libraries take the normal ones' paths, so the script runs
here in a copy of the tree under ``tmp_path`` (the two packages, the
tests and the pytest settings); the repo's own
``build/ompi_tpu_torch/native/`` is left as it was, and the copy's
hash-named files are gone when the script exits.  The default list of
test files (a few minutes on a CPU) is the ``slow`` case.
"""

from __future__ import annotations

import os
import pathlib
import re
import shutil
import subprocess

import pytest

from ompi_tpu_torch import _native

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCRIPT = "ompi_tpu_torch/tools/asan_native.sh"
LIBS = ("convertor", "fastdss", "arena", "net")


def _copy_tree(dst: pathlib.Path) -> pathlib.Path:
    ignore = shutil.ignore_patterns("__pycache__", "*.pyc")
    for d in ("ompi_tpu", "ompi_tpu_torch", "tests"):
        shutil.copytree(ROOT / d, dst / d, ignore=ignore)
    shutil.copy(ROOT / "pyproject.toml", dst / "pyproject.toml")
    return dst


def _listing(path: str) -> dict:
    if not os.path.isdir(path):
        return {}
    return {e.name: e.stat().st_mtime_ns for e in os.scandir(path)}


def _run(tree: pathlib.Path, args, timeout: float):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PYTEST_", "PYTHONPATH"))}
    return subprocess.run(["bash", SCRIPT, *args], cwd=tree, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _check_run(tree: pathlib.Path, r) -> None:
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    build = tree / "build" / "ompi_tpu_torch" / "native"
    loaded = dict(re.findall(r"^loaded sanitized (\w+): (\S+)$", r.stdout,
                             re.M))
    assert sorted(loaded) == sorted(LIBS), r.stdout[-3000:]
    for name, path in loaded.items():
        assert pathlib.Path(path).parent == build, (name, path)
    assert pathlib.Path(loaded["fastdss"]).name.startswith("_fastdss_torch-")
    inst = re.findall(r"^instrumented: (\S+) \((\d+) __asan_ imports\)$",
                      r.stdout, re.M)
    assert sorted(p for p, _ in inst) == sorted(loaded.values())
    assert all(int(n) > 0 for _, n in inst)
    assert re.search(r"^\d+ passed", r.stdout, re.M), r.stdout[-2000:]
    assert "== ASan/UBSan native run clean" in r.stdout
    # the trap removed every sanitized library
    for path in loaded.values():
        assert not os.path.exists(path), path


def test_sanitized_native_tests_run_clean_in_a_copy(tmp_path):
    before = _listing(_native.BUILD_DIR)
    tree = _copy_tree(tmp_path / "tree")
    r = _run(tree, ["tests/test_torch_native.py",
                    "tests/test_torch_mirror_native.py"], timeout=600)
    _check_run(tree, r)
    assert _listing(_native.BUILD_DIR) == before


@pytest.mark.slow  # the script's whole default list: a few minutes
def test_sanitized_default_list_runs_clean_in_a_copy(tmp_path):
    before = _listing(_native.BUILD_DIR)
    tree = _copy_tree(tmp_path / "tree")
    r = _run(tree, [], timeout=1500)
    _check_run(tree, r)
    assert _listing(_native.BUILD_DIR) == before


def test_script_refuses_a_package_from_another_tree(tmp_path):
    """Run from a directory that holds no ``ompi_tpu_torch``, with the
    repo's on the path: the script stops before it builds anything, so
    it never writes the sanitized libraries into another checkout."""
    before = _listing(_native.BUILD_DIR)
    shutil.copytree(ROOT / "ompi_tpu_torch" / "tools",
                    tmp_path / "ompi_tpu_torch" / "tools",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run(["bash", SCRIPT], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 1
    assert "not from this checkout" in r.stderr
    # the refusal itself stops the script, not an unset path after it
    assert "unbound variable" not in r.stderr
    assert "sanitized build" not in r.stdout
    assert _listing(_native.BUILD_DIR) == before
