"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each source under ``csrc/`` has a plain C interface and is compiled, at
first use and from the sources in this checkout only, into its own shared
library for ``sm_90a``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o <lib> <source>

Libraries land in ``build/ompi_tpu_torch/`` at the repository root (listed
in ``.gitignore``), named by a hash of the source and the flags, so an
edited source rebuilds and an unchanged one loads from disk.  The build
writes to a temporary name and renames, so concurrent first uses do not
see a half-written library.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC", "build", "load", "nvcc_path", "ptxas_info"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ompi_tpu_torch"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = (ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v")

_lock = threading.Lock()
#: one lock per source, so different sources build concurrently
_source_locks: dict[str, threading.Lock] = {}
_loaded: dict[str, ctypes.CDLL] = {}
#: ``-Xptxas -v`` lines of each source built in this process (with the
#: stack-frame/spill line of each kernel)
ptxas_info: dict[str, list[str]] = {}


def nvcc_path() -> str:
    """The CUDA compiler; raises with a clear message when it is missing."""
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "the port's CUDA kernels are built at first use with nvcc, which "
        "was not found on PATH or under $CUDA_HOME/bin; install the CUDA "
        "toolkit or pass CPU tensors for the plain PyTorch path")


def _headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` (if not built yet) and return the path of
    its shared library."""
    src = CSRC / source
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in [src, *_headers()]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    lib = BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"
    log = lib.with_suffix(".ptxas.txt")
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {source} (exit "
                               f"{proc.returncode}):\n{proc.stderr[-4000:]}")
        log.write_text(proc.stderr)
        os.replace(tmp, lib)
    if log.exists():
        ptxas_info[source] = [ln.strip() for ln in
                              log.read_text().splitlines()
                              if "ptxas" in ln or "spill" in ln]
    return lib


def load(source: str) -> ctypes.CDLL:
    """Build (once) and load the library of ``csrc/<source>``; calls for
    different sources build in parallel."""
    with _lock:
        lock = _source_locks.setdefault(source, threading.Lock())
    with lock:
        if source not in _loaded:
            _loaded[source] = ctypes.CDLL(str(build(source)))
        return _loaded[source]
