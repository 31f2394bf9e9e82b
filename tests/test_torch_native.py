"""The port's native executors (``ompi_tpu_torch/_native``: the loader,
``fastdss.c``, ``convertor.cpp``, ``arena.c`` and ``net.c``, built with
g++ from the port's own copies) against their Python branches in the port
and against the JAX package's compiled ones on the same seeded inputs
(mirrors tests/mpi/test_native.py, test_native_arena.py,
test_native_match.py and test_native_net.py).
"""

from __future__ import annotations

import ctypes
import importlib
import os
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from ompi_tpu import _native as jnative
from ompi_tpu.core import dss as jdss
from ompi_tpu.mpi import datatype as jdt
from ompi_tpu_torch import _native
from ompi_tpu_torch.core import dss
from ompi_tpu_torch.core.config import var_registry as pvars
from ompi_tpu_torch.mpi import datatype as pdt
from ompi_tpu_torch.mpi import op as pop
from ompi_tpu_torch.mpi.btl import TcpBTL, _send_all
from tests.torch_host_harness import run_ranks as prun

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- the loader -----------------------------------------------------------------

def test_all_four_build_from_the_ports_sources_and_load():
    assert _native.available() and _native.arena_available()
    assert _native.net_available() and _native.fastdss() is not None
    assert _native.lib().ompi_tpu_native_abi() == _native._ABI
    assert _native.arena().ompi_tpu_arena_abi() == _native._ARENA_ABI
    assert _native.net().ompi_tpu_net_abi() == _native._NET_ABI
    assert _native.PARK_SPINS == jnative.PARK_SPINS
    libs = [f for f in os.listdir(_native.BUILD_DIR) if f.endswith(".so")]
    for so in libs:
        assert so.startswith(("_convertor-", "_arena-", "_net-",
                              "_fastdss_torch-")), so
    assert len(libs) >= 4


def test_both_packages_codecs_load_together_and_pass_their_self_checks():
    """The JAX package's ``_fastdss`` and the port's ``_fastdss_torch``
    live in one process as two modules, each with its own Engine type."""
    mine, theirs = _native.fastdss(), jnative.fastdss()
    assert mine is not None and theirs is not None and mine is not theirs
    assert mine.__name__ == "_fastdss_torch" and theirs.__name__ == "_fastdss"
    assert mine.Engine is not theirs.Engine
    assert mine.Engine.__module__ == "_fastdss_torch"
    assert _native.BUILD_DIR not in (theirs.__file__ or "")
    probe = {"t": "x", "n": 1, "f": 1.5, "l": [1, "a"], "b": b"\x00",
             "none": None, "tt": (True, False)}
    for mod in (mine, theirs):
        assert mod.unpack(mod.pack((probe,)), 1) == [probe]


def test_no_native_env_leaves_every_executor_unloaded():
    code = ("from ompi_tpu_torch import _native as n; "
            "print(n.lib(), n.arena(), n.net(), n.fastdss(), "
            "n.available(), n.net_nogil())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ, "OMPI_TPU_NO_NATIVE": "1"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["None"] * 4 + ["False", "None"]


def test_addr_of_and_spans_are_inert_until_armed():
    buf = bytearray(16)
    addr = _native.addr_of(memoryview(buf))
    assert addr == ctypes.addressof(ctypes.c_char.from_buffer(buf))
    assert _native.addr_of(memoryview(b"ro")) is None
    assert _native.spans_drain() == []


# -- fastdss: the DSS codec --------------------------------------------------

def _value(rng, depth=0):
    kind = int(rng.integers(0, 9 if depth < 3 else 6))
    if kind == 0:
        return int(rng.integers(-2**62, 2**62))
    if kind == 1:
        return float(rng.standard_normal())
    if kind == 2:
        return "".join(chr(int(c)) for c in rng.integers(32, 900, 5))
    if kind == 3:
        return bytes(rng.integers(0, 256, int(rng.integers(0, 40)),
                                  dtype=np.uint8))
    if kind == 4:
        return [None, True, False][int(rng.integers(3))]
    if kind == 5:
        return -1
    if kind == 6:
        return [_value(rng, depth + 1) for _ in range(int(rng.integers(4)))]
    if kind == 7:
        return tuple(_value(rng, depth + 1)
                     for _ in range(int(rng.integers(4))))
    return {f"k{i}": _value(rng, depth + 1)
            for i in range(int(rng.integers(5)))}


@pytest.mark.parametrize("seed", range(4))
def test_codec_bytes_equal_python_and_the_jax_packages(seed, monkeypatch):
    rng = np.random.default_rng(seed)
    values = [_value(rng) for _ in range(40)]
    fast, jfast = _native.fastdss(), jnative.fastdss()
    wire = fast.pack(tuple(values))
    assert wire == jfast.pack(tuple(values))
    monkeypatch.setattr(dss, "_fast", None)
    monkeypatch.setattr(dss, "_fast_tried", True)      # the Python codec
    assert dss.pack(*values) == wire
    assert dss.unpack(wire) == values
    monkeypatch.undo()
    assert fast.unpack(wire, -1) == values
    assert dss.unpack(wire, n=3) == values[:3]
    with pytest.raises(dss.DSSError):
        dss.unpack(wire[:-1])


def test_codec_hands_ndarrays_to_the_python_branch():
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    wire = dss.pack({"a": arr}, 5)
    assert wire == jdss.pack({"a": arr}, 5)
    got = dss.unpack(wire)
    assert got[1] == 5 and got[0]["a"].tobytes() == arr.tobytes()


# -- convertor.cpp: the pack/unpack walk ---------------------------------------

def _types(M):
    f8 = M.dt.FLOAT64
    return {
        "vector": f8.vector(40, 3, 7).commit(),        # strided, blocks of 24 B
        "vector1": M.dt.INT32.vector(300, 1, 3).commit(),   # uniform 4 B
        "indexed": f8.indexed([2, 1, 5, 3], [0, 4, 9, 20]).commit(),
        "hindexed": M.dt.INT16.hindexed([30, 70, 10],
                                        [0, 100, 300]).commit(),
    }


@pytest.mark.parametrize("name", ["vector", "vector1", "indexed",
                                  "hindexed"])
@pytest.mark.parametrize("count", [1, 8])
def test_convertor_plans_equal_numpy_and_the_jax_package(name, count,
                                                         monkeypatch):
    P = type("P", (), {"dt": pdt})
    J = type("J", (), {"dt": jdt})
    pt, jt = _types(P)[name], _types(J)[name]
    plan = pt.pack_plan(count)
    assert plan.kind in ("strided", "runs")
    if count > 1:                        # large enough for the native walk
        assert plan.total >= pdt._NATIVE_MIN_BYTES
    rng = np.random.default_rng(count)
    src = rng.integers(0, 256, pt.extent * count + 64, dtype=np.uint8)
    calls = []
    pdt.stats.add_listener(lambda kind, nb: calls.append((kind, nb)))
    try:
        native = pt.pack(src, count)
        dst_n = np.zeros_like(src)
        pt.unpack(native, dst_n, count)
        monkeypatch.setattr(pdt, "_native_convertor", lambda nbytes: None)
        plain = pt.pack(src, count)
        dst_p = np.zeros_like(src)
        pt.unpack(plain, dst_p, count)
    finally:
        pdt.stats._listeners.clear()
    assert native == plain == jt.pack(src, count)
    assert dst_n.tobytes() == dst_p.tobytes()
    dst_j = np.zeros_like(src)
    jt.unpack(native, dst_j, count)
    assert dst_n.tobytes() == dst_j.tobytes()
    assert calls == [("pack", plan.total), ("unpack", plan.total)] * 2


# -- arena.c: fold and publish ---------------------------------------------------

_CODES = {"i1": 0, "i2": 1, "i4": 2, "i8": 3, "u1": 4, "u2": 5, "u4": 6,
          "u8": 7, "f4": 8, "f8": 9}
_OPCODES = {"SUM": 0, "PROD": 1, "MIN": 2, "MAX": 3}


@pytest.mark.parametrize("dtype", sorted(_CODES))
@pytest.mark.parametrize("op", sorted(_OPCODES))
def test_arena_fold_equals_the_numpy_chain_and_the_jax_package(dtype, op):
    rng = np.random.default_rng(_CODES[dtype] * 7 + _OPCODES[op])
    n, k = 1537, 4
    dt = np.dtype(dtype)
    if dt.kind == "f":
        srcs = [(rng.standard_normal(n) * 5).astype(dt) for _ in range(k)]
        srcs[1][3] = np.nan
    else:
        srcs = [rng.integers(0, 120, n).astype(dt) for _ in range(k)]
    acc = srcs[0]
    for s in srcs[1:]:                     # the numpy rank-ordered chain
        acc = getattr(pop, op).host(acc, s)
    outs = []
    for lib in (_native.arena(), jnative.arena()):
        out = np.empty(n, dt)
        ptrs = (ctypes.c_void_p * k)(*[s.ctypes.data for s in srcs])
        rc = lib.ompi_tpu_arena_fold(out.ctypes.data, ctypes.addressof(ptrs),
                                     k, n, _CODES[dtype], _OPCODES[op])
        assert rc == 0
        outs.append(out)
    assert outs[0].tobytes() == outs[1].tobytes()
    assert outs[0].tobytes() == np.asarray(acc, dt).tobytes()


def test_arena_publish_copies_and_stores_the_flag():
    ex = _native.arena()
    seg = np.zeros(64 + 4096, np.uint8)
    base = seg.ctypes.data
    src = np.arange(300, dtype=np.float64)
    ex.ompi_tpu_arena_publish(base + 64, src.ctypes.data, src.nbytes,
                              base, 2, 7)
    flags = seg[:64].view(np.uint64)
    assert int(flags[2]) == 7
    assert seg[64:64 + src.nbytes].tobytes() == src.tobytes()
    m = np.arange(200.0).reshape(20, 10)[::2, 3:7]    # 10 blocks of 32 B
    ex.ompi_tpu_arena_publish_strided(base + 64, m.ctypes.data, 10, 32, 160,
                                      base, 3, 9)
    assert int(flags[3]) == 9
    assert seg[64:64 + m.nbytes].tobytes() == np.ascontiguousarray(
        m).tobytes()
    assert ex.ompi_tpu_arena_wait(base, 3, 9, 0, 1_000_000) == 1
    assert ex.ompi_tpu_arena_wait(base, 3, 10, 0, 1_000_000) == 0


# -- net.c: scan and writev --------------------------------------------------------

def _frame(header: dict, payload: bytes) -> bytes:
    hdr = dss.pack(header)
    return struct.pack("<II", len(hdr) + len(payload), len(hdr)) \
        + hdr + payload


def _py_scan(buf: bytes):
    out, off = [], 0
    while len(buf) - off >= 8:
        total, hlen = struct.unpack_from("<II", buf, off)
        if len(buf) - off - 8 < total:
            break
        out.append((off, total, hlen))
        off += 8 + total
    return out


def _scan(lib, buf: bytes, max_frames: int = 64):
    arr = np.frombuffer(buf, np.uint8) if buf else np.zeros(1, np.uint8)
    out = (ctypes.c_uint64 * (3 * max_frames))()
    nf = lib.ompi_tpu_net_scan(arr.ctypes.data, len(buf),
                               ctypes.addressof(out), max_frames)
    assert nf >= 0, nf
    return [(out[3 * i], out[3 * i + 1], out[3 * i + 2])
            for i in range(nf)]


def test_scan_equals_python_and_the_jax_package_at_every_split():
    rng = np.random.default_rng(7)
    stream = b"".join(
        _frame({"t": "x", "i": int(i)},
               bytes(rng.integers(0, 256, int(n), dtype=np.uint8)))
        for i, n in enumerate(rng.integers(0, 300, 10)))
    mine, theirs = _native.net(), jnative.net()
    for cut in range(0, len(stream) + 1, 3):
        want = _py_scan(stream[:cut])
        assert _scan(mine, stream[:cut]) == want
        assert _scan(theirs, stream[:cut]) == want


def _drain(sock, n):
    out = bytearray()
    while len(out) < n:
        chunk = sock.recv(n - len(out))
        if not chunk:
            break
        out += chunk
    return bytes(out)


def test_writev_puts_the_python_planes_bytes_on_the_wire():
    """The same iovec list through net.c's writev (tiny SO_SNDBUF: forced
    partial writes) and through the Python plane's ``_send_all``."""
    rng = np.random.default_rng(3)
    parts = [bytes(rng.integers(0, 256, int(n), dtype=np.uint8))
             for n in (8, 40, 70_000, 3, 150_000)]
    want = b"".join(parts)
    lib = _native.net()
    for native in (True, False):
        a, b = socket.socketpair()
        a.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 4096)
        got = []
        t = threading.Thread(target=lambda: got.append(_drain(b, len(want))))
        t.start()
        if native:
            keep = [np.frombuffer(p, np.uint8) for p in parts]
            flat = [(k.ctypes.data, k.nbytes) for k in keep]
            written, idx, off = 0, 0, 0
            while written < len(want):
                n = len(flat) - idx
                pa = (ctypes.c_uint64 * (2 * n))()
                for j, (addr, ln) in enumerate(flat[idx:]):
                    pa[2 * j], pa[2 * j + 1] = addr, ln
                pa[0] += off
                pa[1] -= off
                w = lib.ompi_tpu_net_writev(a.fileno(), pa, n, 20_000_000)
                assert w >= 0
                written += w
                off += w
                while idx < len(flat) and off >= flat[idx][1]:
                    off -= flat[idx][1]
                    idx += 1
        else:
            _send_all(a, *parts)
        t.join(timeout=30)
        a.close()
        b.close()
        assert got == [want]


class _Collector:
    def __init__(self):
        self.frames = []
        self.lock = threading.Lock()

    def __call__(self, peer, hdr, payload):
        with self.lock:
            self.frames.append((peer, hdr, bytes(payload)))

    def wait(self, n, timeout=30.0):
        deadline = time.time() + timeout
        while time.time() < deadline:
            with self.lock:
                if len(self.frames) >= n:
                    return list(self.frames)
            time.sleep(0.002)
        raise AssertionError(f"wanted {n} frames, got {len(self.frames)}")


def test_tcp_planes_flip_frame_by_frame_in_order():
    """A fuzzed battery (empty, eager, rendezvous-sized and memoryview
    payloads) arrives bit for bit and in order while ``btl_tcp_native``
    flips per frame over one socket."""
    rng = np.random.default_rng(11)
    ca, cb = _Collector(), _Collector()
    a, b = TcpBTL(0, ca), TcpBTL(1, cb)
    a.set_peers({1: b.address})
    b.set_peers({0: a.address})
    assert a._native_ok and b._native_ok
    sent = []
    try:
        for i in range(40):
            n = int(rng.choice([0, 1, 64, 1500, 70_000, 150_000]))
            data = bytes(rng.integers(0, 256, n, dtype=np.uint8))
            payload = memoryview(bytearray(data)) if i % 5 == 0 else data
            pvars.set("btl_tcp_native", bool(i % 3))
            a.send(1, {"t": "fz", "i": i}, payload)
            sent.append((i, data))
        got = cb.wait(len(sent))
        assert [(h["i"], p) for _pr, h, p in got] == sent
    finally:
        pvars.set("btl_tcp_native", True)
        a.close()
        b.close()


def test_no_native_env_keeps_tcp_on_the_python_plane(monkeypatch):
    monkeypatch.setenv("OMPI_TPU_NO_NATIVE", "1")
    mod = importlib.reload(_native)
    try:
        assert mod.net() is None
        ca, cb = _Collector(), _Collector()
        a, b = TcpBTL(0, ca), TcpBTL(1, cb)
        a.set_peers({1: b.address})
        try:
            assert not a._native_ok and not b._native_ok
            a.send(1, {"t": "x"}, b"payload")
            assert cb.wait(1)[0][1:] == ({"t": "x"}, b"payload")
        finally:
            a.close()
            b.close()
    finally:
        monkeypatch.delenv("OMPI_TPU_NO_NATIVE")
        importlib.reload(mod)


def test_rendezvous_lands_directly_over_native_tcp():
    """A forced-tcp world: rendezvous payloads above the landing floor
    arrive through the poller's zero-copy sink, and the data is right."""
    n = 1 << 16

    def body(c):
        if c.rank == 0:
            c.send(np.arange(n, dtype=np.float64), 1, tag=4)
            return None
        buf = np.zeros(n, np.float64)
        c.recv(buf=buf, source=0, tag=4)
        return buf.tobytes()

    got = prun(2, body, btl="^proc,shm")[1]
    assert got == np.arange(n, dtype=np.float64).tobytes()


# -- the matching engine ----------------------------------------------------------

@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_engine_holds_out_of_order_frames_and_releases_them(pkg):
    fast = (_native if pkg == "port" else jnative).fastdss()
    e = fast.Engine()
    h = {"t": "eager", "tag": 1, "cid": 0}
    assert e.incoming(3, {**h, "seq": 2}, b"c") == []          # held
    assert [a[0] for a in e.incoming(3, {**h, "seq": 0}, b"a")] == [
        "unexpected"]
    assert [a[0] for a in e.incoming(3, {**h, "seq": 1}, b"b")] == [
        "unexpected", "unexpected"]
    hits = [e.improbe(0, 3, 1) for _ in range(3)]
    assert [bytes(x[2]) for x in hits] == [b"a", b"b", b"c"]


def test_pml_native_match_selects_the_engine():
    old = pvars.get("pml_native_match")
    try:
        for flag in (True, False):
            pvars.set("pml_native_match", flag)
            got = prun(2, lambda c: c.pml._eng is not None)
            assert got == [flag, flag]
    finally:
        pvars.set("pml_native_match", old)
