"""One-sided device put/get/bcast between ranks: the port of
``ompi_tpu.ops.remote_dma`` (kernels #4-#6).

≈ opal/mca/btl/btl.h:970 (btl_put), :1007 (btl_get): bytes move only
src→dst, not through a collective.  The JAX package's Pallas kernels
start an inter-chip DMA and wait on its semaphores; here each rank's
window is a symmetric window (``ops/symmetric.py``) that every peer has
mapped, and the hand-written kernels of ``csrc/remote_dma.cu`` copy
straight into (put, bcast) or out of (get) the peer's memory, with a
sequence-numbered flag handshake in place of the semaphores.

Two layers:

- **kernel level** — :func:`put_kernel`, :func:`get_kernel`,
  :func:`bcast_kernel` copy ``source`` into one landing (or several) on
  one card, with the flag words of a :class:`Sync`; :func:`signal_wait`
  is the passive side of a call.  Each copy launch adds one to its
  counter (``put_launch_count``, ``get_launch_count``,
  ``bcast_launch_count``).  Their plain versions are
  ``landing.copy_(source)`` (:func:`copy_plain`).  Put and get launch by
  a plan made here (:func:`copy_plan`): TMA bulk copies through a
  shared-memory ring on a persistent grid where the source and the
  landing are 16-byte aligned, a byte loop for any other pair.
- **rank level** — :func:`window_put`, :func:`window_get`,
  :func:`fetch_bcast` resolve the peers' mapped windows and run one call
  of the protocol on this rank.  Every rank of the communicator makes
  every call (SPMD; the flags count calls).  A window's flag words are
  addresses fixed at allocation, so a put or get builds no tensor view.
  On the CPU the same contract runs over gloo send/recv on the device
  group (the plain version the tests hold against the JAX package); a
  CUDA window launches the kernels or raises.

The ops update the window in place and return it, so call sites read
like the reference's functional form (``win = window_put(win, ...)``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import struct
import types
from typing import Optional, Sequence

import torch

from ompi_tpu_torch.mpi.constants import MPIException
from ompi_tpu_torch.ops import symmetric

__all__ = ["window_put", "window_get", "fetch_bcast", "put_kernel",
           "get_kernel", "bcast_kernel", "signal_wait", "copy_plain",
           "Sync", "CopyPlan", "copy_plan", "grid_for"]

#: copy-kernel launches so far; chip_smoke.py zeroes them around the
#: main path
put_launch_count = 0
get_launch_count = 0
bcast_launch_count = 0

THREADS = 256              # csrc/remote_dma.cu kThreads
MAX_PEERS = 8              # csrc/remote_dma.cu kMaxPeers
MAX_BLOCKS = 132 * 8       # the push: one wave of 256-thread blocks on an H100
#: put and get: chunks of STAGE_BYTES through a ring of STAGES stages a
#: block, AHEAD bulk loads in flight (so STAGES - AHEAD stores may still
#: read their stages); the best of a sweep on an H100 (PERF.md §6)
STAGES = 4
STAGE_BYTES = 16 << 10
AHEAD = 2
MAX_STAGES = 8             # csrc/remote_dma.cu kMaxStages
MAX_RING_BYTES = 200 << 10  # csrc/remote_dma.cu kMaxRingBytes
#: a bulk block: thread 0 drives the ring, the next 15 copy a ragged tail
RING_THREADS = 32
_PUT, _GET = 0, 1
#: ``RingCall`` of csrc/remote_dma.cu: src, land, wait, release, counter,
#: status, seq, target, plan, stream, kind, device (packed: one pointer
#: crosses ctypes instead of twelve arguments, which cost more than the
#: launch)
_CALL = struct.Struct("<QQQQQQqQQQii")
_STATUS = {1: "a ready flag never came (the peer did not reach the call)",
           2: "a done flag never came (the peer did not finish the copy)"}

_vp = ctypes.c_void_p
_vpp = ctypes.POINTER(ctypes.c_void_p)


def grid_for(nbytes: int) -> int:
    """Blocks of one push: enough for 16 bytes a thread, at most one wave
    (the loop is grid-stride)."""
    return max(1, min(MAX_BLOCKS, -(-int(nbytes) // (16 * THREADS))))


class _PlanC(ctypes.Structure):
    """``Plan`` of csrc/remote_dma.cu, field for field."""

    _fields_ = [("nbytes", ctypes.c_ulonglong), ("body", ctypes.c_ulonglong),
                ("stage", ctypes.c_int),
                ("stages", ctypes.c_int), ("ahead", ctypes.c_int),
                ("grid", ctypes.c_int), ("threads", ctypes.c_int),
                ("smem", ctypes.c_int), ("bulk", ctypes.c_int)]


@dataclasses.dataclass(frozen=True)
class CopyPlan:
    """The launch of one put or get of ``nbytes``.

    Bulk: the body [0, body) is cut into chunks of ``stage`` bytes, and
    chunk g, [g·stage, min((g+1)·stage, body)), goes to block g mod grid,
    through a ring of ``stages`` stages (``smem`` bytes of shared memory,
    ``ahead`` loads in flight); the last block's first threads copy the
    tail [body, nbytes), under 16 bytes.  Byte
    path (``bulk`` false, ``body`` 0): a grid-stride byte loop over the
    whole message.  ``address`` is that of the plan as the C entry reads
    it."""

    nbytes: int
    bulk: bool
    grid: int
    threads: int
    body: int = 0
    stage: int = 0
    stages: int = 0
    ahead: int = 0
    smem: int = 0

    def __post_init__(self) -> None:
        c = _PlanC(self.nbytes, self.body, self.stage,
                   self.stages, self.ahead, self.grid, self.threads,
                   self.smem, int(self.bulk))
        object.__setattr__(self, "_c", c)
        object.__setattr__(self, "address", ctypes.addressof(c))


def copy_plan(nbytes: int, src_ptr: int, dst_ptr: int, sms: int) -> CopyPlan:
    """The launch of a put or get of ``nbytes`` from address ``src_ptr``
    to ``dst_ptr`` on a card of ``sms`` SMs, chosen from sizes and
    alignment alone (a pure function; the CPU tests check it).

    Both addresses 16-byte aligned: bulk, the body ⌊n/16⌋·16 in chunks
    of STAGE_BYTES (one chunk below that), dealt round-robin to at most
    one block an SM.  Chunk-cyclic rather than one contiguous range a
    block: the SMs then work on neighbouring chunks, which measured
    faster on an H100; chunk sizes that are not multiples of 128 bytes,
    cut to even out the blocks' last round, measured slower (PERF.md
    §6).  Any other pair: the byte loop, at most one 256-thread block an
    SM."""
    return _plan(int(nbytes), not (int(src_ptr) | int(dst_ptr)) & 15,
                 int(sms))


@functools.lru_cache(maxsize=1024)
def _plan(nbytes: int, bulk: bool, sms: int) -> CopyPlan:
    if not bulk:
        return CopyPlan(nbytes, False, max(1, min(sms, -(-nbytes // THREADS))),
                        THREADS)
    body = nbytes // 16 * 16
    stage = min(STAGE_BYTES, max(16, body))
    chunks = -(-body // stage)
    grid = max(1, min(sms, chunks))
    stages = min(STAGES, max(1, -(-chunks // grid)))
    return CopyPlan(nbytes, True, grid, RING_THREADS, body, stage, stages,
                    min(AHEAD, stages), stages * stage)


@functools.cache
def _fns() -> types.SimpleNamespace:
    """The C entry points, loaded (and built at first use) once, and the
    current-stream lookup."""
    from ompi_tpu_torch.ops import _build

    lib = _build.load("remote_dma.cu")
    ring, copy, sig = lib.ompi_rma_ring, lib.ompi_rma_copy, lib.ompi_rma_signal
    ring.argtypes = [ctypes.c_char_p]
    copy.argtypes = [ctypes.c_int, ctypes.c_int, _vp, _vpp, ctypes.c_int,
                     ctypes.c_ulonglong, _vpp, ctypes.c_int, _vpp,
                     ctypes.c_int, _vp, ctypes.c_ulonglong, _vp,
                     ctypes.c_longlong, ctypes.c_int, _vp]
    sig.argtypes = [ctypes.c_int, _vp, _vp, _vp, ctypes.c_longlong, _vp]
    lib.ompi_rma_sms.argtypes = [ctypes.c_int]
    for fn in (ring, copy, sig, lib.ompi_rma_sms):
        fn.restype = ctypes.c_int
    if (lib.ompi_rma_call_bytes() != _CALL.size
            or lib.ompi_rma_plan_bytes() != ctypes.sizeof(_PlanC)):
        raise RuntimeError("remote_dma: csrc/remote_dma.cu's RingCall or Plan "
                           "does not match _CALL or _PlanC")

    @functools.cache
    def sms(dev: int) -> int:
        n = lib.ompi_rma_sms(dev)
        if n < 1:
            raise RuntimeError(f"remote_dma: no SM count for cuda:{dev}")
        return n

    return types.SimpleNamespace(
        ring=ring, copy=copy, signal=sig, sms=sms,
        stream=torch._C._cuda_getCurrentRawStream)


@dataclasses.dataclass
class Sync:
    """The flag words of one call, as 1-element int64 CUDA tensors:
    ``wait`` are acquired (until ≥ ``seq``) before the copy, ``release``
    are set to ``seq`` after it by the last block to arrive at
    ``counter``; ``arrived`` is the counter's value before the call (the
    kernel-level call advances it by the blocks it launched).  Timeouts
    land in ``status``.  Put and get take one wait and one release word
    at most."""

    wait: Sequence[torch.Tensor] = ()
    release: Sequence[torch.Tensor] = ()
    counter: Optional[torch.Tensor] = None
    status: Optional[torch.Tensor] = None
    seq: int = 0
    arrived: int = 0


_NO_SYNC = Sync()


def _ring(kind: int, dev: int, land: int, src: int, nbytes: int, wait,
          release, counter, status, seq: int, arrived: int) -> int:
    """Launch a put (kind 0) or get (1) of ``nbytes`` from address ``src``
    to ``land`` on card ``dev`` by its plan; the counter's value once the
    call's blocks have arrived (``arrived`` when nothing is released)."""
    global put_launch_count, get_launch_count
    f = _fns()
    plan = _plan(nbytes, not (src | land) & 15, f.sms(dev))
    target = arrived + plan.grid
    # the C entry sets the device itself
    err = f.ring(_CALL.pack(src, land, wait or 0, release or 0, counter or 0,
                            status or 0, seq, target, plan.address,
                            f.stream(dev), kind, dev))
    if err != 0:
        raise RuntimeError(f"remote_dma {('put', 'get')[kind]} kernel launch "
                           f"failed: CUDA error {err} ({plan})")
    if kind == _PUT:
        put_launch_count += 1
    else:
        get_launch_count += 1
    return target if release else arrived


def _addr(t: torch.Tensor, dev: int) -> int:
    """The address of a flag word, which must be one int64 on card
    ``dev``."""
    if t.dtype is not torch.int64 or t.numel() != 1 or t.get_device() != dev:
        raise ValueError(f"remote_dma: a flag word must be one int64 on "
                         f"cuda:{dev}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")
    return t.data_ptr()


def _one_sided(kind: int, landing: torch.Tensor, source: torch.Tensor,
               sync: Sync) -> None:
    """Check and launch one put or get on ``source``'s card."""
    name = ("put", "get")[kind]
    dev = source.get_device()               # -1 off the card
    if dev < 0 or landing.get_device() < 0:
        raise ValueError(f"remote_dma {name} kernel: CUDA tensors only, got "
                         f"{source.device} and {landing.device} (the plain "
                         "version is copy_plain)")
    if (landing.get_device() != dev or not source.is_contiguous()
            or not landing.is_contiguous()):
        raise ValueError(f"remote_dma {name}: operands must be contiguous "
                         f"and on cuda:{dev}")
    nbytes = source.nbytes
    if landing.nbytes != nbytes:
        raise ValueError(f"remote_dma {name}: landing of {landing.nbytes} "
                         f"bytes for a source of {nbytes}")
    if len(sync.wait) > 1 or len(sync.release) > 1:
        raise ValueError(f"remote_dma {name}: one wait and one release word "
                         "at most")
    wait = _addr(sync.wait[0], dev) if sync.wait else None
    release = _addr(sync.release[0], dev) if sync.release else None
    counter = None if sync.counter is None else _addr(sync.counter, dev)
    status = None if sync.status is None else _addr(sync.status, dev)
    if (wait or release) and status is None:
        raise ValueError(f"remote_dma {name}: a handshake needs a status "
                         "word")
    if release and counter is None:
        raise ValueError(f"remote_dma {name}: releasing needs a counter")
    arrived = _ring(kind, dev, landing.data_ptr(), source.data_ptr(), nbytes,
                    wait, release, counter, status, sync.seq, sync.arrived)
    if release:
        sync.arrived = arrived


def put_kernel(landing: torch.Tensor, source: torch.Tensor,
               sync: Sync = None) -> None:
    """Kernel #4 on one card: ``landing`` ← ``source`` (bytes), after the
    ``sync.wait`` flag and before its ``release`` flag."""
    _one_sided(_PUT, landing, source, sync or _NO_SYNC)


def get_kernel(landing: torch.Tensor, source: torch.Tensor,
               sync: Sync = None) -> None:
    """Kernel #5 on one card: ``landing`` ← ``source`` (a peer's mapped
    window at rank level)."""
    _one_sided(_GET, landing, source, sync or _NO_SYNC)


def _ptrs(ts: Sequence[torch.Tensor]):
    return (_vp * max(1, len(ts)))(*[t.data_ptr() for t in ts])


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_words(sync: Sync, dev: torch.device) -> None:
    for t in (*sync.wait, *sync.release,
              *(w for w in (sync.counter, sync.status) if w is not None)):
        if t.dtype != torch.int64 or t.numel() != 1 or t.device != dev:
            raise ValueError(f"remote_dma: a flag word must be one int64 on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if len(sync.wait) > MAX_PEERS or len(sync.release) > MAX_PEERS:
        raise ValueError(f"remote_dma: at most {MAX_PEERS} flags a call")


def bcast_kernel(landings: Sequence[torch.Tensor], source: torch.Tensor,
                 sync: Sync = None) -> None:
    """Kernel #6 on one card: every landing ← ``source``, each 16 bytes
    of the source loaded once and stored to every landing."""
    global bcast_launch_count
    landings, sync = list(landings), sync or Sync()
    dev = source.device
    if dev.type != "cuda":
        raise ValueError(f"remote_dma bcast kernel: CUDA tensors only, got "
                         f"{dev} (the plain version is copy_plain)")
    if not 1 <= len(landings) <= MAX_PEERS:
        raise ValueError(f"remote_dma bcast: 1..{MAX_PEERS} landings, got "
                         f"{len(landings)}")
    nbytes = source.numel() * source.element_size()
    for t in (source, *landings):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"remote_dma bcast: operands must be "
                             f"contiguous and on {dev}")
        if t.numel() * t.element_size() != nbytes:
            raise ValueError(f"remote_dma bcast: landing of "
                             f"{t.numel() * t.element_size()} bytes for a "
                             f"source of {nbytes}")
    _check_words(sync, dev)
    if (sync.wait or sync.release) and sync.status is None:
        raise ValueError("remote_dma bcast: a handshake needs a status word")
    if sync.release and sync.counter is None:
        raise ValueError("remote_dma bcast: releasing needs a counter")
    grid = grid_for(nbytes)
    target = sync.arrived + grid
    # the C entry sets the device itself
    err = _fns().copy(2, dev.index, source.data_ptr(), _ptrs(landings),
                      len(landings), nbytes, _ptrs(sync.wait),
                      len(sync.wait), _ptrs(sync.release), len(sync.release),
                      _ptr(sync.counter), target, _ptr(sync.status),
                      sync.seq, grid,
                      torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"remote_dma bcast kernel launch failed: CUDA "
                           f"error {err} ({nbytes} bytes)")
    if sync.release:
        sync.arrived = target
    bcast_launch_count += 1


def _signal(dev: int, release: int, wait: int, status: int, seq: int) -> None:
    """The passive side of a call on card ``dev``, by addresses."""
    f = _fns()
    err = f.signal(dev, release, wait, status, seq, f.stream(dev))
    if err != 0:
        raise RuntimeError(f"remote_dma signal/wait launch failed: CUDA "
                           f"error {err}")


def signal_wait(release: Sequence[torch.Tensor],
                wait: Sequence[torch.Tensor], status: torch.Tensor,
                seq: int) -> None:
    """The passive side of a call: set the one ``release`` word to
    ``seq``, then wait until the one ``wait`` word reaches it (one thread
    on the card)."""
    if not status.is_cuda:
        raise ValueError(f"remote_dma signal/wait: CUDA flag words only, got "
                         f"{status.device}")
    if len(release) != 1 or len(wait) != 1:
        raise ValueError("remote_dma signal/wait: one release and one wait "
                         "word")
    dev = status.get_device()
    _signal(dev, _addr(release[0], dev), _addr(wait[0], dev),
            _addr(status, dev), seq)


def copy_plain(landings: Sequence[torch.Tensor], source: torch.Tensor):
    """The plain version of the three copy kernels: each landing
    ``copy_`` the source."""
    for t in landings:
        t.copy_(source)


# ---------------------------------------------------------------------------
# rank level
# ---------------------------------------------------------------------------

def _ranks(comm, *ranks: int) -> tuple[int, int]:
    n, me = comm.size, comm.rank()
    for r in ranks:
        if not 0 <= int(r) < n:
            raise MPIException(f"remote_dma: rank {r} outside a communicator "
                               f"of {n}")
    return n, me


def _finish(w: symmetric.SymmetricWindow, what: str) -> None:
    """Wait for this rank's part of the call and raise on a timeout the
    kernel reported (the per-op quiet of the reference)."""
    code = int(w.status.item())
    if code:
        raise RuntimeError(f"remote_dma {what}: spin bound passed on rank "
                           f"{w.mesh.rank} (call {w.seq}): {_STATUS[code]}")


def _on_card(w: symmetric.SymmetricWindow, t: torch.Tensor,
             what: str) -> torch.Tensor:
    """``t``, contiguous, which must lie on the window's card."""
    t = t.contiguous()
    if t.get_device() != w.device_index:
        raise ValueError(f"{what}: the value is on {t.device}, the window on "
                         f"cuda:{w.device_index}")
    return t


def window_put(win, value, src: int, dst: int, comm):
    """One-sided put: rank ``src`` writes ``value`` into rank ``dst``'s
    window; every other rank's window is unchanged.  Updates ``win`` in
    place and returns it.  dst returns once the bytes have landed.

    ≈ btl.h:970 mca_btl_base_module_put_fn_t with the window as the
    registered remote segment.
    """
    if tuple(win.shape) != tuple(value.shape) or win.dtype != value.dtype:
        raise ValueError(
            f"window_put: value {tuple(value.shape)}/{value.dtype} must "
            f"match the window shard {tuple(win.shape)}/{win.dtype}")
    _, me = _ranks(comm, src, dst)
    if win.device.type == "cpu":
        if src == dst:
            if me == src:
                win.copy_(value)
        elif me == src:
            comm._p2p([(value, dst)], [])
        elif me == dst:
            comm._p2p([], [(win, src)])
        return win
    w = symmetric.lookup(comm.mesh, win)
    seq = w.next_seq()
    dev = w.device_index
    if src == dst:
        if me == src:
            put_kernel(win, value.contiguous())
    elif me == src:
        value = _on_card(w, value, "window_put")
        w.arrived = _ring(_PUT, dev, w.ptrs[dst], value.data_ptr(), w.nbytes,
                          w.ready_ptrs[me][dst], w.done_ptrs[dst][src],
                          w.counter_ptr, w.status_ptr, seq, w.arrived)
        _finish(w, "put")
    elif me == dst:
        _signal(dev, w.ready_ptrs[src][dst], w.done_ptrs[dst][src],
                w.status_ptr, seq)
        _finish(w, "put")
    return win


def window_get(win, src: int, dst: int, comm):
    """One-sided get: rank ``dst`` fetches rank ``src``'s window into a
    new tensor; every other rank (src included) gets its own window back
    (the window itself, not a copy).  ``src``'s window is untouched and
    may be reused once the call returns there.

    ≈ btl.h:1007 mca_btl_base_module_get_fn_t.  The TPU kernel pushes
    from the serving chip; here dst pulls through its mapping of src's
    window, with the same result.
    """
    _, me = _ranks(comm, src, dst)
    if me != dst:
        out = win
    else:
        out = torch.empty_like(win)
    if win.device.type == "cpu":
        if src == dst:
            if me == dst:
                out.copy_(win)
        elif me == src:
            comm._p2p([(win, dst)], [])
        elif me == dst:
            comm._p2p([], [(out, src)])
        return out
    w = symmetric.lookup(comm.mesh, win)
    seq = w.next_seq()
    dev = w.device_index
    if src == dst:
        if me == dst:
            get_kernel(out, win)
    elif me == dst:
        w.arrived = _ring(_GET, dev, out.data_ptr(), w.ptrs[src], w.nbytes,
                          w.ready_ptrs[me][src], w.done_ptrs[src][dst],
                          w.counter_ptr, w.status_ptr, seq, w.arrived)
        _finish(w, "get")
    elif me == src:
        _signal(dev, w.ready_ptrs[dst][src], w.done_ptrs[src][dst],
                w.status_ptr, seq)
        _finish(w, "get")
    return out


def fetch_bcast(x, root: int, comm):
    """Root's buffer delivered to every rank by explicit one-sided pushes
    from root (n-1 copies in one kernel, no tree, no reduction).  ``x`` is
    a symmetric window; it is overwritten in place on every rank but root
    and returned."""
    n, me = _ranks(comm, root)
    peers = [p for p in range(n) if p != root]
    if x.device.type == "cpu":
        if me == root:
            comm._p2p([(x, p) for p in peers], [])
        elif peers:
            comm._p2p([], [(x, root)])
        return x
    if len(peers) > MAX_PEERS:
        raise MPIException(f"fetch_bcast: at most {MAX_PEERS} peers, got "
                           f"{len(peers)}")
    w = symmetric.lookup(comm.mesh, x)
    seq = w.next_seq()
    if not peers:
        return x
    if me == root:
        sync = Sync(wait=[w.ready(p) for p in peers],
                    release=[w.done(root, at=p) for p in peers],
                    counter=w.counter, status=w.status, seq=seq,
                    arrived=w.arrived)
        bcast_kernel([w.data[p] for p in peers], x.contiguous(), sync)
        w.arrived = sync.arrived
    else:
        _signal(w.device_index, w.ready_ptrs[root][me], w.done_ptrs[me][root],
                w.status_ptr, seq)
    _finish(w, "fetch_bcast")
    return x
