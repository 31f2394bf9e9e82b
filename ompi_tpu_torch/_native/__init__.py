"""Native-code loader: compiles and loads the four host executors on
demand (the port's copy of the JAX package's ``_native/__init__.py``).

≈ the reference's native OPAL core — where it ships compiled C, we ship
C/C++ compiled on first use with ``g++`` (the host compiler ``nvcc``
needs anyway; there is no wheel-building step).  The port compiles its
OWN copies of the sources — ``convertor.cpp`` (the datatype pack/unpack
walk), ``arena.c`` (the coll/shm arena and the shm ring parks),
``net.c`` (the native tcp plane) and ``fastdss.c`` (the DSS codec, the
shm ring framing and the PML's matching engine, a CPython extension
named ``_fastdss_torch`` so that it loads beside the JAX package's
``_fastdss`` in one process) — all from this directory, never the JAX
package's.

Libraries land in ``build/ompi_tpu_torch/native/`` at the repository
root (ignored by git), named by a hash of their source (and, for the
CPython extension, the interpreter ABI), so an edited source rebuilds
and an unchanged one loads from disk.  An exclusive-create lock makes N
simultaneously-launched ranks build once; a lock older than the compile
timeout is debris from a killed builder and is taken over.  Every entry
point degrades to the pure-Python path when a compiler is unavailable
or ``OMPI_TPU_NO_NATIVE=1``: the native layer is an accelerator, never a
requirement.  Each component re-reads its own switch
(``btl_shm_native``, ``coll_shm_native``, ``btl_tcp_native``,
``pml_native_match``).

The span rings (``spans_enable``/``spans_drain``: begin–end stamps of
the GIL-released parks in ``arena.c`` and ``net.c``) are armed by
``mpi.trace.enable`` and drained into its flight recorder
(``trace.drain_native_spans``: at flush, on the metrics push cadence and
in a live capture).  This module imports neither torch nor numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from typing import Optional

#: external knob: set to "1" to force the numpy/python fallbacks
ENV_NO_NATIVE = "OMPI_TPU_NO_NATIVE"

_ABI = 2
_ARENA_ABI = 3
_NET_ABI = 3
_DIR = os.path.dirname(os.path.abspath(__file__))
#: where the libraries are built: ``build/ompi_tpu_torch/native`` at the
#: repository root, beside the CUDA kernels' builds (listed in .gitignore)
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "ompi_tpu_torch", "native")
_SRC = os.path.join(_DIR, "convertor.cpp")
_FASTDSS_SRC = os.path.join(_DIR, "fastdss.c")
_ARENA_SRC = os.path.join(_DIR, "arena.c")
_NET_SRC = os.path.join(_DIR, "net.c")

_lib: Optional[ctypes.CDLL] = None
_tried = False
_fastdss = None
_fastdss_tried = False
_arena: Optional[ctypes.CDLL] = None
_arena_tried = False
_net: Optional[ctypes.CDLL] = None
_net_tried = False
_net_py: Optional[ctypes.PyDLL] = None


def _hash_name(src: str, stem: str) -> str:
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"{stem}-{digest}.so")


def _so_path() -> str:
    return _hash_name(_SRC, "_convertor")


_LOCK_STALE_S = 150.0   # > the 120 s compile timeout: a lock this old
# belongs to a builder that was killed mid-compile


def _lock_age(lock: str) -> float:
    try:
        return time.time() - os.path.getmtime(lock)
    except OSError:
        return 0.0


def _build(so: str, src: str = _SRC,
           extra_flags: tuple = ()) -> bool:
    """Compile once across concurrent ranks (O_EXCL lock + wait).  A lock
    older than the compile timeout is debris from a killed builder — it is
    removed and the build retried, instead of every later process stalling
    30 s and silently degrading to the numpy path forever."""
    lock = so + ".lock"
    try:
        os.makedirs(os.path.dirname(so), exist_ok=True)
        fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        # someone else is building: wait for the .so (or their failure)
        for _ in range(300):
            if os.path.exists(so):
                return True
            if not os.path.exists(lock):      # builder gave up
                return os.path.exists(so)
            if _lock_age(lock) > _LOCK_STALE_S:
                try:
                    os.unlink(lock)           # stale: take over
                except OSError:
                    pass
                return _build(so, src, extra_flags)
            # one-time memoized compile wait (first use per machine,
            # during single-threaded bring-up) — not a steady-state
            # blocking path
            time.sleep(0.1)   # lint: reader-ok lock-ok
        return os.path.exists(so)
    except OSError:
        return False
    try:
        os.close(fd)
        tmp = so + ".tmp"
        # one-time memoized compile (see lib()'s _tried gate) — not a
        # steady-state blocking path
        proc = subprocess.run(   # lint: reader-ok lock-ok
            ["g++", "-O3", "-shared", "-fPIC", *extra_flags,
             "-o", tmp, src],
            capture_output=True, timeout=120)
        if proc.returncode != 0:
            return False
        os.replace(tmp, so)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        try:
            os.unlink(lock)
        except OSError:
            pass


def lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, or None (numpy fallback)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get(ENV_NO_NATIVE) == "1":
        return None
    so = _so_path()
    if not os.path.exists(so) and not _build(so):
        return None
    try:
        cdll = ctypes.CDLL(so)
        cdll.ompi_tpu_native_abi.restype = ctypes.c_int64
        if cdll.ompi_tpu_native_abi() != _ABI:
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64 = ctypes.c_int64
        i64p = ctypes.POINTER(ctypes.c_int64)
        # per-item walk (+ uniform-length hint + packed item size, ABI 2)
        cdll.ompi_tpu_pack.argtypes = [u8p, u8p, i64, i64, i64p, i64p, i64,
                                       i64, i64]
        cdll.ompi_tpu_pack.restype = None
        cdll.ompi_tpu_unpack.argtypes = [u8p, u8p, i64, i64, i64p, i64p,
                                         i64, i64, i64]
        cdll.ompi_tpu_unpack.restype = None
        # coalesced absolute-run plan walk
        cdll.ompi_tpu_pack_runs.argtypes = [u8p, u8p, i64p, i64p, i64, i64]
        cdll.ompi_tpu_pack_runs.restype = None
        cdll.ompi_tpu_unpack_runs.argtypes = [u8p, u8p, i64p, i64p, i64,
                                              i64]
        cdll.ompi_tpu_unpack_runs.restype = None
        # strided progressions (vector-class plans, no run metadata)
        cdll.ompi_tpu_pack_strided.argtypes = [u8p, u8p, i64, i64, i64]
        cdll.ompi_tpu_pack_strided.restype = None
        cdll.ompi_tpu_unpack_strided.argtypes = [u8p, u8p, i64, i64, i64]
        cdll.ompi_tpu_unpack_strided.restype = None
        _lib = cdll
    except OSError:
        _lib = None
    return _lib


def available() -> bool:
    return lib() is not None


def arena() -> Optional[ctypes.CDLL]:
    """The arena/ring executor library, or None (python fallback).

    Plain-C ctypes like the convertor — unlike the per-frame fastdss
    codec, every call here either parks (waits: the ~1 µs ctypes
    marshalling cost vanishes into the park) or moves a payload (the
    copy/fold dominates), so the C-API route's extra complexity buys
    nothing.  What ctypes DOES buy is the whole point: the GIL is
    released for the duration of each call, so waits, publishes, and
    folds stop serializing against the other in-process threads."""
    global _arena, _arena_tried
    if _arena is not None or _arena_tried:
        return _arena
    _arena_tried = True
    if os.environ.get(ENV_NO_NATIVE) == "1":
        return None
    so = _hash_name(_ARENA_SRC, "_arena")
    if not os.path.exists(so) and not _build(so, src=_ARENA_SRC):
        return None
    try:
        cdll = ctypes.CDLL(so)
        cdll.ompi_tpu_arena_abi.restype = ctypes.c_int64
        if cdll.ompi_tpu_arena_abi() != _ARENA_ABI:
            return None
        i64, u64, vp = ctypes.c_int64, ctypes.c_uint64, ctypes.c_void_p
        # pointers travel as raw integer addresses (c_void_p): every
        # mapped-segment address is computed Python-side, and arrays of
        # slot pointers ride (c_void_p * n) blocks
        cdll.ompi_tpu_arena_wait.argtypes = [vp, i64, u64, i64, i64]
        cdll.ompi_tpu_arena_wait.restype = i64
        cdll.ompi_tpu_arena_wait_all.argtypes = [vp, i64, i64, i64, u64,
                                                 i64, i64]
        cdll.ompi_tpu_arena_wait_all.restype = i64
        cdll.ompi_tpu_arena_wait_change.argtypes = [vp, u64, i64, i64]
        cdll.ompi_tpu_arena_wait_change.restype = i64
        cdll.ompi_tpu_arena_wake.argtypes = [vp, i64]
        cdll.ompi_tpu_arena_wake.restype = None
        cdll.ompi_tpu_ring_wait_any.argtypes = [vp, vp, i64, i64, i64]
        cdll.ompi_tpu_ring_wait_any.restype = i64
        cdll.ompi_tpu_arena_publish.argtypes = [vp, vp, i64, vp, i64, u64]
        cdll.ompi_tpu_arena_publish.restype = None
        cdll.ompi_tpu_arena_publish_strided.argtypes = [vp, vp, i64, i64,
                                                        i64, vp, i64, u64]
        cdll.ompi_tpu_arena_publish_strided.restype = None
        cdll.ompi_tpu_arena_copy_blocks.argtypes = [vp, vp, vp, i64, vp,
                                                    i64, u64]
        cdll.ompi_tpu_arena_copy_blocks.restype = None
        cdll.ompi_tpu_arena_fold.argtypes = [vp, vp, i64, i64, i64, i64]
        cdll.ompi_tpu_arena_fold.restype = i64
        cdll.ompi_tpu_arena_spans_enable.argtypes = [i64]
        cdll.ompi_tpu_arena_spans_enable.restype = None
        cdll.ompi_tpu_arena_spans_drain.argtypes = [vp, i64]
        cdll.ompi_tpu_arena_spans_drain.restype = i64
        cdll.ompi_tpu_arena_spans_enable(_span_min_ns)  # pending arm
        _arena = cdll
    except OSError:
        _arena = None
    return _arena


def arena_available() -> bool:
    return arena() is not None


#: net.c's EOF sentinel (outside the errno range, so every other
#: negative return is unambiguously -errno)
NET_EOF = -4096


def net() -> Optional[ctypes.CDLL]:
    """The network executor library, or None (pure-python plane).

    Same plain-C ctypes shape as the arena: every entry either parks
    (the poll/backpressure waits) or moves a payload (the writev drain,
    the rndv landing recv), so ctypes' marshalling cost vanishes and
    the GIL release is the entire point — a writer draining a burst of
    frames or a poller parked across every connection no longer
    serializes against the in-process ranks."""
    global _net, _net_tried
    if _net is not None or _net_tried:
        return _net
    _net_tried = True
    if os.environ.get(ENV_NO_NATIVE) == "1":
        return None
    so = _hash_name(_NET_SRC, "_net")
    if not os.path.exists(so) and not _build(so, src=_NET_SRC):
        return None
    try:
        cdll = ctypes.CDLL(so)
        cdll.ompi_tpu_net_abi.restype = ctypes.c_int64
        if cdll.ompi_tpu_net_abi() != _NET_ABI:
            return None
        i64, vp = ctypes.c_int64, ctypes.c_void_p
        # buffers travel as raw integer addresses, iovec lists as
        # (c_uint64 * 2n) (addr, len) pair blocks — no ctypes structs
        cdll.ompi_tpu_net_writev.argtypes = [i64, vp, i64, i64]
        cdll.ompi_tpu_net_writev.restype = i64
        # send3: ctypes passes bytes objects straight through vp
        # params (address extraction happens in C, not Python) — the
        # single-crossing latency path
        cdll.ompi_tpu_net_send3.argtypes = [
            i64, vp, i64, vp, i64, vp, i64, i64]
        cdll.ompi_tpu_net_send3.restype = i64
        cdll.ompi_tpu_net_poll.argtypes = [vp, i64, vp, i64, i64]
        cdll.ompi_tpu_net_poll.restype = i64
        cdll.ompi_tpu_net_read.argtypes = [i64, vp, i64]
        cdll.ompi_tpu_net_read.restype = i64
        cdll.ompi_tpu_net_recv_into.argtypes = [i64, vp, i64, i64]
        cdll.ompi_tpu_net_recv_into.restype = i64
        cdll.ompi_tpu_net_scan.argtypes = [vp, i64, vp, i64]
        cdll.ompi_tpu_net_scan.restype = i64
        cdll.ompi_tpu_net_spans_enable.argtypes = [i64]
        cdll.ompi_tpu_net_spans_enable.restype = None
        cdll.ompi_tpu_net_spans_drain.argtypes = [vp, i64]
        cdll.ompi_tpu_net_spans_drain.restype = i64
        cdll.ompi_tpu_net_spans_enable(_span_min_ns)  # pending arm
        _net = cdll
    except OSError:
        _net = None
    return _net


def net_available() -> bool:
    return net() is not None


def net_nogil() -> Optional[ctypes.PyDLL]:
    """The SAME library through a PyDLL handle: calls keep the GIL.

    For a small-frame sendmsg(MSG_DONTWAIT) that's the faster calling
    convention on a busy interpreter — releasing the GIL for a ~2us
    syscall invites another runnable thread (the peer's poller, woken
    by this very send) to steal the interpreter, and the sender then
    waits out that thread's whole dispatch pass to get it back.  Safe
    ONLY for entries that cannot block: callers must pass slice_ns=0
    so send3 returns on the first EAGAIN instead of parking in poll()
    while holding the interpreter hostage."""
    global _net_py
    if _net_py is not None:
        return _net_py
    if net() is None:   # shares the build/ABI gate (and NO_NATIVE)
        return None
    try:
        pdll = ctypes.PyDLL(_hash_name(_NET_SRC, "_net"))
        i64, vp = ctypes.c_int64, ctypes.c_void_p
        pdll.ompi_tpu_net_send3.argtypes = [
            i64, vp, i64, vp, i64, vp, i64, i64]
        pdll.ompi_tpu_net_send3.restype = i64
        _net_py = pdll
    except OSError:
        _net_py = None
    return _net_py


# -- native span rings ------------------------------------------------------
#
# arena.c and net.c stamp begin–end timestamps of their GIL-released
# parks into small per-thread rings; the trace plane
# (``mpi.trace.drain_native_spans``) drains them into its flight
# recorder.  The arm state
# lives here so a caller can arm BEFORE either library is loaded (the
# load applies the pending value).

#: current arm threshold: spans shorter than this are dropped in C;
#: < 0 disarms recording entirely (the default)
_span_min_ns = -1

#: native kind codes → recorder span names, per library (must mirror
#: the SPAN_KIND_* constants in each .c file)
_ARENA_SPAN_NAMES = {1: "arena_wait", 2: "arena_wait_all",
                     3: "arena_wait_change", 4: "ring_wait"}
_NET_SPAN_NAMES = {1: "net_writev", 2: "net_send3",
                   3: "net_poll", 4: "net_recv_into"}

_SPAN_DRAIN_CAP = 4096
_span_buf = None


def spans_enable(min_ns: int) -> None:
    """Arm (min_ns >= 0: record parks at least that long, in ns) or
    disarm (min_ns < 0) the native span rings in both executor libs.
    Safe before either library is loaded — the value is applied at
    load time — and a no-op when native is unavailable."""
    global _span_min_ns
    _span_min_ns = int(min_ns)
    if _arena is not None:
        _arena.ompi_tpu_arena_spans_enable(_span_min_ns)
    if _net is not None:
        _net.ompi_tpu_net_spans_enable(_span_min_ns)


def spans_drain(limit: int = 1024) -> list:
    """Drain completed native park spans from both libraries.

    Returns [(name, t0_ns, t1_ns), ...] in per-ring order (t0/t1 are
    CLOCK_MONOTONIC ns, the flight recorder's clock).  Single-drainer
    contract: callers serialize."""
    global _span_buf
    out: list = []
    limit = min(int(limit), _SPAN_DRAIN_CAP)
    if limit <= 0 or (_arena is None and _net is None):
        return out
    if _span_buf is None:
        _span_buf = (ctypes.c_uint64 * (3 * _SPAN_DRAIN_CAP))()
    buf = _span_buf
    for cdll, drain, names in (
            (_arena, "ompi_tpu_arena_spans_drain", _ARENA_SPAN_NAMES),
            (_net, "ompi_tpu_net_spans_drain", _NET_SPAN_NAMES)):
        if cdll is None:
            continue
        got = int(getattr(cdll, drain)(buf, limit - len(out)))
        for i in range(got):
            kind = buf[3 * i]
            out.append((names.get(kind, f"k{kind}"),
                        int(buf[3 * i + 1]), int(buf[3 * i + 2])))
        if len(out) >= limit:
            break
    return out


def addr_of(mv) -> Optional[int]:
    """Raw address of a writable buffer's first byte — the mapped
    segment base every native arena/ring offset is relative to.  The
    ctypes object is dropped immediately so the buffer export does not
    outlive the call (mmap.close() would otherwise raise BufferError)."""
    try:
        c = ctypes.c_char.from_buffer(mv)
    except (TypeError, ValueError, BufferError):
        return None
    addr = ctypes.addressof(c)
    del c     # refcount GC releases the export immediately
    return addr


#: shared spin burst for every native park (arena flag waits, btl ring
#: parks): on a 1-2 core host even a GIL-free spin steals the
#: publisher's quantum, so those hosts go straight to the bounded
#: block (measured: spins=0 beat every burst size on small boxes)
PARK_SPINS = 4000 if (os.cpu_count() or 1) > 2 else 0


def fastdss():
    """The compiled DSS codec extension module, or None.

    A real CPython extension (not ctypes): the codec is called once per
    control-plane frame, where ctypes marshalling was measured to cost
    more than the work saved — the C API's ~100 ns call overhead is what
    makes native pay at this granularity."""
    global _fastdss, _fastdss_tried
    if _fastdss is not None or _fastdss_tried:
        return _fastdss
    _fastdss_tried = True
    if os.environ.get(ENV_NO_NATIVE) == "1":
        return None
    import sysconfig

    # the name must carry the interpreter ABI: unlike the plain-C ctypes
    # helpers, this is a real CPython extension — loading a .so built for
    # another Python version would dlopen mismatched object layouts
    soabi = sysconfig.get_config_var("SOABI") or "abi-unknown"
    so = _hash_name(_FASTDSS_SRC, f"_fastdss_torch-{soabi}")
    inc = sysconfig.get_paths().get("include")
    if not inc or not os.path.exists(os.path.join(inc, "Python.h")):
        return None
    if not os.path.exists(so) and not _build(
            so, src=_FASTDSS_SRC, extra_flags=("-I" + inc,)):
        return None
    try:
        import importlib.machinery
        import importlib.util

        loader = importlib.machinery.ExtensionFileLoader(
            "_fastdss_torch", so)
        spec = importlib.util.spec_from_file_location(
            "_fastdss_torch", so, loader=loader)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        # self-check against a known vector before trusting it
        # a DSS round-trip vector, not a wire frame  # lint: frame-ok
        probe = {"t": "x", "n": 1, "f": 1.5, "l": [1, "a"], "b": b"\x00",
                 "none": None, "tt": (True, False)}
        if mod.unpack(mod.pack((probe,)), 1) != [probe]:
            return None
        _fastdss = mod
    except Exception:  # noqa: BLE001 — any load failure → python codec
        _fastdss = None
    return _fastdss
