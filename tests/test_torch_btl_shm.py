"""The port's btl/shm (``ompi_tpu_torch.mpi.btl_shm``) and core/shmseg
against the JAX package's: the SPSC ring mechanics (round trip, unlink,
wrap-around, backpressure, ``FrameTooBig``), a ring written by one package
and drained by the other (the same layout and framing), the endpoint's
routing and MCA gating, the dead-receiver and pid-liveness probes, a frame
larger than half a ring riding tcp (and the ring-size hint when tcp is
off), two real processes over the rings, and a mixed-traffic soak, with
the native frame engine on and off (mirrors tests/core/test_shmseg.py,
tests/mpi/test_btl_shm.py, test_native_match.py:184 and
test_shm_soak_mixed.py, cut to a few hundred frames).
"""

from __future__ import annotations

import multiprocessing as mp
import os
import random
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import pytest

from ompi_tpu.core import shmseg as jshmseg
from ompi_tpu.core.config import var_registry as jvars
from ompi_tpu.mpi import btl_shm as jshm
from ompi_tpu_torch.core import shmseg
from ompi_tpu_torch.core.config import var_registry as pvars
from ompi_tpu_torch.mpi import btl_shm as pshm
from ompi_tpu_torch.mpi.btl import BtlEndpoint
from ompi_tpu_torch.mpi.btl_shm import FrameTooBig, PeerDeadError, ShmBTL
from ompi_tpu_torch.mpi.constants import MPIException
from tests.mpi.harness import run_ranks as jrun
from tests.test_torch_host_p2p import _same
from tests.torch_host_harness import run_ranks as prun


@pytest.fixture(params=[True, False], ids=["native", "python"])
def native(request):
    """The shm framing and the matching engine compiled (the default) or
    on their Python branches, in both packages."""
    names = ("btl_shm_native", "pml_native_match")
    old = [(reg, n, reg.get(n)) for reg in (jvars, pvars) for n in names]
    for reg, n, _ in old:
        reg.set(n, request.param)
    yield request.param
    for reg, n, value in old:
        reg.set(n, value)


# -- core/shmseg --------------------------------------------------------------

def test_segment_round_trip_and_unlink():
    with shmseg.create("torch_seg_rt", 4096) as seg:
        assert seg.size == 4096
        seg.buf[:5] = b"hello"
        att = shmseg.attach(seg.path)
        try:
            assert att.size == 4096 and bytes(att.buf[:5]) == b"hello"
            att.buf[5:7] = b"!!"
            assert bytes(seg.buf[:7]) == b"hello!!"
        finally:
            att.detach()
    assert not os.path.exists(seg.path)
    assert shmseg.backing_dir() == jshmseg.backing_dir()


def test_segments_cross_between_the_packages():
    """Same header (magic, size): each package attaches the other's."""
    for make, att in ((shmseg.create, jshmseg.attach),
                      (jshmseg.create, shmseg.attach)):
        with make(f"torch_seg_x{time.monotonic_ns()}", 256) as seg:
            seg.buf[:3] = b"abc"
            other = att(seg.path)
            assert other.size == 256 and bytes(other.buf[:3]) == b"abc"
            other.detach()


def test_attach_survives_unlink_and_rejects_garbage(tmp_path):
    seg = shmseg.create("torch_seg_unlink", 128)
    att = shmseg.attach(seg.path)
    seg.buf[:3] = b"abc"
    seg.close()
    assert bytes(att.buf[:3]) == b"abc"
    att.detach()
    junk = tmp_path / "junk"
    junk.write_bytes(b"\x00" * 64)
    with pytest.raises(OSError):
        shmseg.attach(str(junk))
    with pytest.raises(OSError):
        shmseg.attach(os.path.join(shmseg.backing_dir(), "no-such-seg"))
    with pytest.raises(OSError):
        shmseg.attach_retry(str(tmp_path / "late"), timeout=0.05)


# -- the ring -----------------------------------------------------------------

def _pair(writer_mod, reader_mod, capacity=1 << 16):
    inbox = tempfile.mkdtemp(prefix="torch-shmtest-")
    w = writer_mod.ShmRingWriter(inbox, my_id=3, capacity=capacity)
    r = reader_mod.ShmRingReader(os.path.join(inbox, "ring_3"), peer=3)
    return w, r, inbox


def _close(w, r, inbox):
    w.close()
    r.close()
    os.rmdir(inbox)


_MODS = {"port": pshm, "jax": jshm}


@pytest.mark.parametrize("writer,reader", [("port", "port"),
                                           ("port", "jax"),
                                           ("jax", "port")])
def test_ring_wraps_around_between_the_packages(writer, reader, native):
    """200 frames through a 4 KiB ring (far more bytes than capacity),
    framed by one package and drained by the other: the same headers and
    payloads in order, and the reader unlinked the ring file."""
    w, r, inbox = _pair(_MODS[writer], _MODS[reader], capacity=4096)
    assert os.listdir(inbox) == []          # the reader unlinked the ring
    rng = np.random.default_rng(7)
    sent, got = [], []
    cb = lambda p, h, pl: got.append((p, h, bytes(pl)))  # noqa: E731
    for i in range(200):
        hdr = {"i": i, "t": "eager", "tag": int(rng.integers(-3, 50)),
               "dt": "<f4", "shp": [i % 5, 2], "x": [1.5, None, "s"]}
        payload = rng.integers(0, 256, size=i % 97).astype(np.uint8)
        w.send(hdr, payload.tobytes())
        sent.append((3, hdr, payload.tobytes()))
        r.poll(cb)
    while r.poll(cb):
        pass
    assert got == sent
    _close(w, r, inbox)


def test_ring_backpressure_blocks_until_drained(native):
    w, r, inbox = _pair(pshm, pshm, capacity=4096)
    done = threading.Event()

    def producer():
        for i in range(50):
            w.send({"i": i}, b"x" * 300)     # ~16 KB through a 4 KB ring
        done.set()

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    got = []
    deadline = time.time() + 10
    while len(got) < 50 and time.time() < deadline:
        r.poll(lambda p, h, pl: got.append(h["i"]))
    t.join(timeout=5)
    assert done.is_set() and got == list(range(50))
    _close(w, r, inbox)


def test_frame_larger_than_half_the_ring_raises(native):
    w, r, inbox = _pair(pshm, pshm, capacity=4096)
    with pytest.raises(FrameTooBig):
        w.send({}, b"y" * 3000)
    assert w.try_send({}, b"z" * 100) is True      # a small one fits
    _close(w, r, inbox)


# -- the BTL and the endpoint --------------------------------------------------

def test_btl_discovers_a_new_ring_and_rejects_unreachable_cards():
    frames = []
    rx = ShmBTL(0, lambda p, h, pl: frames.append((p, h, bytes(pl))))
    tx = ShmBTL(1, lambda p, h, pl: None)
    try:
        assert not tx.connect(5, "otherhost|/nonexistent/dir")
        assert not tx.connect(6, f"{tx.hostname}|/nonexistent/dir")
        assert tx.connect(0, rx.address)
        tx.send(0, {"t": "probe"}, b"data")
        deadline = time.time() + 5
        while not frames and time.time() < deadline:
            time.sleep(0.01)
        assert frames == [(1, {"t": "probe"}, b"data")]
    finally:
        tx.close()
        rx.close()


def test_endpoint_gating_and_routes():
    import ompi_tpu_torch.mpi.btl  # noqa: F401 — registers btl_

    old = pvars.get("btl_")
    try:
        pvars.set("btl_", "^shm")
        ep = BtlEndpoint(0, lambda p, h, pl: None)
        assert ep.shm_btl is None and ";shm=" not in ep.address
        ep.close()
        pvars.set("btl_", "^proc")
        a = BtlEndpoint(0, lambda p, h, pl: None)
        b = BtlEndpoint(1, lambda p, h, pl: None)
        assert ";shm=" in a.address and ";proc=" not in a.address
        cards = {0: a.address, 1: b.address}
        a.set_peers(cards)
        assert a.route(0) == "self" and a.route(1) == "shm"
        assert a.peer_alive(1) is True
        a.close()
        b.close()
    finally:
        pvars.set("btl_", old)


def test_dead_receiver_is_detected_not_silently_lost():
    a = ShmBTL(0, lambda *x: None)
    b = ShmBTL(1, lambda *x: None)
    try:
        host, inbox, _ = b.address.split("|")
        assert a.connect(1, f"{host}|{inbox}|{2**22 + 12345}")
        with pytest.raises(PeerDeadError):
            a.send(1, {"t": "eager", "seq": 0}, b"x")
        with pytest.raises(PeerDeadError):
            a.try_send(1, {"t": "eager", "seq": 1}, b"y")
        a.drop_peer(1)
        assert a.connect(1, f"{host}|{inbox}|{os.getpid()}")
        a.send(1, {"t": "eager", "seq": 0}, b"x")
    finally:
        a.close()
        b.close()


def test_probe_alive_answers_from_the_card_pid():
    btl = ShmBTL(0, lambda *a: None)
    try:
        inbox = tempfile.mkdtemp(prefix="torch-shmprobe-")
        p = subprocess.Popen([sys.executable, "-c", "pass"])
        p.wait()
        assert btl.probe_alive(7, f"{btl.hostname}|{inbox}|{p.pid}") is False
        live = f"{btl.hostname}|{inbox}|{os.getppid() or os.getpid()}"
        assert btl.probe_alive(8, live) is True
        assert btl.probe_alive(9) is None
        assert btl.probe_alive(10, f"not-{btl.hostname}|{inbox}|1") is None
        os.rmdir(inbox)
    finally:
        btl.close()


def test_frame_above_half_the_ring_rides_tcp():
    """Rendezvous fragments bigger than half a 64 KiB ring ride tcp (the
    PML reorders by seq) and arrive intact, and a small message after
    them still takes the ring (the hint with tcp off:
    ``test_oversize_send_without_tcp_names_the_hint_in_the_endpoint``)."""
    names = ("btl_shm_ring_size", "pml_frag_size")
    old = [(n, pvars.get(n)) for n in names]
    pvars.set("btl_shm_ring_size", 64 << 10)
    pvars.set("pml_frag_size", 48 << 10)
    n = 1 << 15                                  # 256 KiB of float64

    def body(c):
        if c.rank == 0:
            c.send(np.arange(n, dtype=np.float64), 1, tag=9)
            c.send(np.arange(8, dtype=np.int32), 1, tag=10)
            return c.pml.endpoint.route(1)
        out = c.recv(source=0, tag=9)
        small = c.recv(source=0, tag=10)
        return out.tobytes(), small.tobytes()

    try:
        route, (big, small) = prun(2, body, btl="^proc")
    finally:
        for name, value in old:
            pvars.set(name, value)
    assert route == "shm"
    assert big == np.arange(n, dtype=np.float64).tobytes()
    assert small == np.arange(8, dtype=np.int32).tobytes()


# -- p2p over the rings --------------------------------------------------------

def _wildcards(c, comm_size):
    """Rank 0 receives one message from every peer with ANY_SOURCE, then
    an eager (4 KiB) and a rendezvous (256 KiB) message from each peer
    with ANY_TAG, which must arrive in the order they were sent."""
    if c.rank == 0:
        got = [c.recv(source=-1, tag=7).tobytes()
               for _ in range(comm_size - 1)]
        ordered = []
        for src in range(1, comm_size):
            for _ in range(2):
                ordered.append(c.recv(source=src, tag=-2).tobytes())
        return sorted(got), ordered
    rng = np.random.default_rng(c.rank)
    c.send(np.full(5, c.rank, np.int64), 0, tag=7)
    c.send(rng.normal(size=512).astype(np.float64), 0, tag=3)
    c.send(rng.normal(size=1 << 15).astype(np.float64), 0, tag=4)
    return None


def test_wildcards_and_order_over_the_rings_equal_the_jax_package(native):
    for n in (2, 4):
        ref = jrun(n, lambda c: _wildcards(c, n))
        port = prun(n, lambda c: _wildcards(c, n), btl="^proc")
        _same(ref, port)


def _child(c2p, p2c, native):
    from ompi_tpu_torch.core.config import var_registry
    from ompi_tpu_torch.mpi.comm import Communicator
    from ompi_tpu_torch.mpi.group import Group
    from ompi_tpu_torch.mpi.pml import PmlOb1

    var_registry.set("pml_native_match", native)
    var_registry.set("btl_shm_native", native)
    pml = PmlOb1(1)
    c2p.put(pml.address)
    pml.set_peers(p2c.get(timeout=60))
    comm = Communicator(Group(range(2)), cid=0, pml=pml, my_world_rank=1)
    buf = np.zeros(16, np.int32)
    for _ in range(50):
        comm.recv(buf=buf, source=0, tag=1)
        buf += 1
        comm.send(buf, dest=0, tag=1)
    big = comm.recv(source=0, tag=2)
    comm.send(big[::-1].copy(), dest=0, tag=2)
    c2p.put(pml.endpoint.route(0))
    pml.close()


def test_two_processes_round_trip_over_the_rings(native):
    """The deployment shape: two processes of one host, the fused drain
    and receiver-pull path end to end, eager and rendezvous."""
    from ompi_tpu_torch.mpi.comm import Communicator
    from ompi_tpu_torch.mpi.group import Group
    from ompi_tpu_torch.mpi.pml import PmlOb1

    ctx = mp.get_context("spawn")
    c2p, p2c = ctx.Queue(), ctx.Queue()
    proc = ctx.Process(target=_child, args=(c2p, p2c, native), daemon=True)
    proc.start()
    pml = PmlOb1(0)
    try:
        peers = {0: pml.address, 1: c2p.get(timeout=60)}
        p2c.put(peers)
        pml.set_peers(peers)
        comm = Communicator(Group(range(2)), cid=0, pml=pml,
                            my_world_rank=0)
        msg = np.zeros(16, np.int32)
        for _ in range(50):
            comm.send(msg, dest=1, tag=1)
            msg = comm.recv(source=1, tag=1)
        assert (np.asarray(msg) == 50).all()
        big = np.random.default_rng(3).normal(size=1 << 16)
        comm.send(big, dest=1, tag=2)
        back = comm.recv(source=1, tag=2)
        assert back.tobytes() == big[::-1].tobytes()
        assert pml.endpoint.route(1) == "shm"
        assert c2p.get(timeout=30) == "shm"
        proc.join(timeout=30)
        assert not proc.is_alive() and proc.exitcode == 0
    finally:
        pml.close()
        if proc.is_alive():
            proc.kill()


def test_mixed_traffic_soak_over_the_rings(native):
    """Random sizes (eager and rendezvous), standard and sync modes,
    rotating peers and interleaved barriers on 4 ranks: every element of
    every message carries its stamp."""
    n = 4

    def body(c):
        rng = random.Random(c.rank)
        for it in range(60):
            peer = (c.rank + 1 + it % (n - 1)) % n
            size = rng.choice([1, 7, 64, 1024, 5000, 70000])
            mode = rng.choice(["standard", "standard", "sync"])
            sreq = c.pml.isend(np.full(size, c.rank * 1000 + it, np.int64),
                               c.world_rank(peer), it % 11, c.cid,
                               mode=mode)
            src = (c.rank - 1 - it % (n - 1)) % n
            got = c.pml.recv(None, c.world_rank(src), it % 11, c.cid)
            assert (got == src * 1000 + it).all(), (c.rank, it)
            sreq.wait(timeout=60)
            if it % 25 == 24:
                c.barrier()
        c.barrier()
        return c.pml.endpoint.route((c.rank + 1) % n)

    assert prun(n, body, timeout=120.0, btl="^proc") == ["shm"] * n


def test_oversize_send_without_tcp_names_the_hint_in_the_endpoint():
    """BtlEndpoint.send with tcp off and a frame above half the ring:
    MPIException naming the ring-size variable."""
    import ompi_tpu_torch.mpi.btl  # noqa: F401

    old = [(n, pvars.get(n)) for n in ("btl_", "btl_shm_ring_size")]
    pvars.set("btl_", "^proc,tcp")
    pvars.set("btl_shm_ring_size", 8192)
    try:
        a = BtlEndpoint(0, lambda *x: None)
        b = BtlEndpoint(1, lambda *x: None)
        a.set_peers({0: a.address, 1: b.address})
        with pytest.raises(MPIException) as e:
            a.send(1, {"t": "data"}, b"q" * 6000)
        assert "btl_shm_ring_size" in str(e.value)
        assert not a.try_send_inline(1, {"t": "data"}, b"q" * 6000)
        a.close()
        b.close()
    finally:
        for name, value in old:
            pvars.set(name, value)
