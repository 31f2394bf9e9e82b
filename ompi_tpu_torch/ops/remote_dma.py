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
  ``landing.copy_(source)`` (:func:`copy_plain`).
- **rank level** — :func:`window_put`, :func:`window_get`,
  :func:`fetch_bcast` resolve the peers' mapped windows and run one call
  of the protocol on this rank.  Every rank of the communicator makes
  every call (SPMD; the flags count calls).  On the CPU the same contract
  runs over gloo send/recv on the device group (the plain version the
  tests hold against the JAX package); a CUDA window launches the kernels
  or raises.

The ops update the window in place and return it, so call sites read
like the reference's functional form (``win = window_put(win, ...)``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Sequence

import torch

from ompi_tpu_torch.mpi.constants import MPIException
from ompi_tpu_torch.ops import symmetric

__all__ = ["window_put", "window_get", "fetch_bcast", "put_kernel",
           "get_kernel", "bcast_kernel", "signal_wait", "copy_plain",
           "Sync", "grid_for"]

#: copy-kernel launches so far; chip_smoke.py zeroes them around the
#: main path
put_launch_count = 0
get_launch_count = 0
bcast_launch_count = 0

THREADS = 256              # csrc/remote_dma.cu kThreads
MAX_PEERS = 8              # csrc/remote_dma.cu kMaxPeers
MAX_BLOCKS = 132 * 8       # one wave of 256-thread blocks on an H100
_KIND = {"put": 0, "get": 1, "bcast": 2}
_STATUS = {1: "a ready flag never came (the peer did not reach the call)",
           2: "a done flag never came (the peer did not finish the copy)"}

_vp = ctypes.c_void_p
_vpp = ctypes.POINTER(ctypes.c_void_p)


def grid_for(nbytes: int) -> int:
    """Blocks of one copy: enough for 16 bytes a thread, at most one wave
    (the loop is grid-stride)."""
    return max(1, min(MAX_BLOCKS, -(-int(nbytes) // (16 * THREADS))))


@functools.cache
def _fns():
    """The C entry points, loaded (and built at first use) once."""
    from ompi_tpu_torch.ops import _build

    lib = _build.load("remote_dma.cu")
    copy, sig = lib.ompi_rma_copy, lib.ompi_rma_signal_wait
    copy.argtypes = [ctypes.c_int, ctypes.c_int, _vp, _vpp, ctypes.c_int,
                     ctypes.c_ulonglong, _vpp, ctypes.c_int, _vpp,
                     ctypes.c_int, _vp, ctypes.c_ulonglong, _vp,
                     ctypes.c_longlong, ctypes.c_int, _vp]
    sig.argtypes = [ctypes.c_int, _vpp, ctypes.c_int, _vpp, ctypes.c_int,
                    _vp, ctypes.c_longlong, _vp]
    copy.restype = sig.restype = ctypes.c_int
    return copy, sig


@dataclasses.dataclass
class Sync:
    """The flag words of one call, as 1-element int64 CUDA tensors:
    ``wait`` are acquired (until ≥ ``seq``) before the copy, ``release``
    are set to ``seq`` after it by the last block to arrive at
    ``counter``; ``arrived`` is the counter's value before the call (the
    kernel-level call advances it).  Timeouts land in ``status``."""

    wait: Sequence[torch.Tensor] = ()
    release: Sequence[torch.Tensor] = ()
    counter: Optional[torch.Tensor] = None
    status: Optional[torch.Tensor] = None
    seq: int = 0
    arrived: int = 0


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


def _copy(kind: str, landings: Sequence[torch.Tensor], source: torch.Tensor,
          sync: Sync) -> None:
    """Check and launch one copy kernel on ``source``'s card."""
    dev = source.device
    if dev.type != "cuda":
        raise ValueError(f"remote_dma {kind} kernel: CUDA tensors only, got "
                         f"{dev} (the plain version is copy_plain)")
    if not 1 <= len(landings) <= MAX_PEERS:
        raise ValueError(f"remote_dma {kind}: 1..{MAX_PEERS} landings, got "
                         f"{len(landings)}")
    nbytes = source.numel() * source.element_size()
    for t in (source, *landings):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"remote_dma {kind}: operands must be "
                             f"contiguous and on {dev}")
        if t.numel() * t.element_size() != nbytes:
            raise ValueError(f"remote_dma {kind}: landing of "
                             f"{t.numel() * t.element_size()} bytes for a "
                             f"source of {nbytes}")
    _check_words(sync, dev)
    if (sync.wait or sync.release) and sync.status is None:
        raise ValueError(f"remote_dma {kind}: a handshake needs a status "
                         "word")
    if sync.release and sync.counter is None:
        raise ValueError(f"remote_dma {kind}: releasing needs a counter")
    grid = grid_for(nbytes)
    target = sync.arrived + grid
    copy, _ = _fns()
    # the C entry sets the device itself
    err = copy(_KIND[kind], dev.index, source.data_ptr(), _ptrs(landings),
               len(landings), nbytes, _ptrs(sync.wait), len(sync.wait),
               _ptrs(sync.release), len(sync.release), _ptr(sync.counter),
               target, _ptr(sync.status), sync.seq, grid,
               torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"remote_dma {kind} kernel launch failed: CUDA "
                           f"error {err} ({nbytes} bytes)")
    if sync.release:
        sync.arrived = target


def put_kernel(landing: torch.Tensor, source: torch.Tensor,
               sync: Sync = None) -> None:
    """Kernel #4 on one card: ``landing`` ← ``source`` (bytes), after the
    ``sync.wait`` flags and before its ``release`` flags."""
    global put_launch_count
    _copy("put", [landing], source, sync or Sync())
    put_launch_count += 1


def get_kernel(landing: torch.Tensor, source: torch.Tensor,
               sync: Sync = None) -> None:
    """Kernel #5 on one card: ``landing`` ← ``source`` (a peer's mapped
    window at rank level)."""
    global get_launch_count
    _copy("get", [landing], source, sync or Sync())
    get_launch_count += 1


def bcast_kernel(landings: Sequence[torch.Tensor], source: torch.Tensor,
                 sync: Sync = None) -> None:
    """Kernel #6 on one card: every landing ← ``source``, each 16 bytes
    of the source loaded once and stored to every landing."""
    global bcast_launch_count
    _copy("bcast", list(landings), source, sync or Sync())
    bcast_launch_count += 1


def signal_wait(release: Sequence[torch.Tensor],
                wait: Sequence[torch.Tensor], status: torch.Tensor,
                seq: int) -> None:
    """The passive side of a call: set ``release`` to ``seq``, then wait
    until every ``wait`` flag reaches it (one thread on the card)."""
    dev = status.device
    sync = Sync(wait=wait, release=release, status=status, seq=seq)
    _check_words(sync, dev)
    _, sig = _fns()
    err = sig(dev.index, _ptrs(release), len(release), _ptrs(wait),
              len(wait), status.data_ptr(), seq,
              torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"remote_dma signal/wait launch failed: CUDA "
                           f"error {err}")


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
    if src == dst:
        if me == src:
            put_kernel(win, value.contiguous())
    elif me == src:
        sync = Sync(wait=[w.ready(dst)], release=[w.done(src, at=dst)],
                    counter=w.counter, status=w.status, seq=seq,
                    arrived=w.arrived)
        put_kernel(w.data[dst], value.contiguous(), sync)
        w.arrived = sync.arrived
        _finish(w, "put")
    elif me == dst:
        signal_wait([w.ready(dst, at=src)], [w.done(src)], w.status, seq)
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
    if src == dst:
        if me == dst:
            get_kernel(out, win)
    elif me == dst:
        sync = Sync(wait=[w.ready(src)], release=[w.done(dst, at=src)],
                    counter=w.counter, status=w.status, seq=seq,
                    arrived=w.arrived)
        get_kernel(out, w.data[src], sync)
        w.arrived = sync.arrived
        _finish(w, "get")
    elif me == src:
        signal_wait([w.ready(src, at=dst)], [w.done(dst)], w.status, seq)
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
        signal_wait([w.ready(me, at=root)], [w.done(root)], w.status, seq)
    _finish(w, "fetch_bcast")
    return x
