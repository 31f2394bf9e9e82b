"""OSC — one-sided communication (MPI RMA windows) of the port (the port's
copy of the JAX package's ``mpi/osc.py``, whole).

≈ ompi/mca/osc (osc.h:370-408).  The reference has two strategies: map
windows onto RDMA put/get (osc/rdma, osc_rdma_comm.c:418,539) or emulate
over p2p (osc/pt2pt).  Host-path windows here are the pt2pt strategy
re-designed around an **active-message service**: each window runs a service
thread on a private dup of the communicator; PUT/GET/ACC/FETCH/LOCK requests
are applied atomically against the local buffer.  Synchronization:

- ``fence``  — active-target: an allreduce of sent-op counts tells each rank
  how many incoming ops to wait for, then a barrier (the standard
  counting-fence; the reference's pt2pt fence does the same bookkeeping).
- ``lock/unlock`` — passive-target: queued exclusive/shared locks at the
  target service; unlock flushes (waits until the target applied all my
  ops) before releasing.

``SharedWindow`` is osc/sm (one shared segment, direct load/store);
``DeviceWindow`` is osc/rdma on the card (the one-sided copy kernels of
``ops/remote_dma``).

The port differs from the JAX package in what an origin buffer may be.
Origin data (``put``, ``accumulate``, ``fetch_op``, the request ops,
``compare_swap``) may be a torch tensor: a CUDA tensor is made contiguous
on the card and comes to the host in ONE device-to-host copy, a CPU
tensor is viewed in place, and a tensor of a dtype numpy has no name for
(bf16, float8) is first converted to the window's dtype, on its own
device.  A window's buffer may be a contiguous CPU tensor, whose memory
the window then exposes; a CUDA tensor there raises (its memory is the
card's: ``DeviceWindow`` is the window for it).  ``get`` returns numpy.
The module imports torch only for a tensor the caller passed, and
``DeviceWindow`` loads it when it is constructed, so a host-plane rank
that uses windows never imports it.
"""

from __future__ import annotations

import itertools
import os
import struct
import threading
from typing import Any, Optional

import numpy as np

from ompi_tpu_torch.core import dss, output
from ompi_tpu_torch.core.buffer import (BITS_DTYPE, is_tensor, tensor_to_host,
                                         torch_dtype_name)
from ompi_tpu_torch.mpi import op as op_mod
from ompi_tpu_torch.mpi import trace as trace_mod
from ompi_tpu_torch.mpi.constants import ANY_SOURCE, ERR_REVOKED, MPIException
from ompi_tpu_torch.mpi.request import Request

__all__ = ["Window", "DeviceWindow", "SharedWindow"]

_log = output.get_stream("osc")

_shwin_nonce = itertools.count(1)  # SharedWindow segment disambiguation

# Reserved tags on the window's private comm, in a range disjoint from the
# collective tags (coll/base.py TAG_* 1..10) — the service thread's
# ANY_SOURCE receive must never match a collective running on the same comm.
_TAG_REQ = 500
_TAG_REPLY = 501
# request-returning ops (rget/rget_accumulate) carry a unique reply tag so
# several can be outstanding to the same target without reply cross-matching
_TAG_RDYN_BASE = 1000
_TAG_RDYN_SPAN = 1_000_000


# first byte of a raw-payload control frame; dss type tags are 1..10, so
# the two framings are distinguishable from the first byte
_RAW_MAGIC = 0xFF

# dtype kinds safe to ship by their ``.str`` descriptor (structured /
# extension dtypes lose information there and take the dss path instead)
_RAW_KINDS = frozenset("biufc")


def _ctrl_send(comm, dest: int, obj: Any, tag: int,
               payload: Optional[np.ndarray] = None) -> Request:
    """Send one control message.  ``payload`` (an ndarray) is appended RAW
    after the dss header and rehydrated as a zero-copy view on the far
    side — the plan-collapsed fast path for bulk put/get traffic: ONE
    staging copy of the data total, where dss-packing the array inside the
    tuple paid three (tobytes, buffer assembly, unpack copy)."""
    if payload is not None:
        pay = np.ascontiguousarray(payload)
        if pay.dtype.kind in _RAW_KINDS:
            hdr = dss.pack((obj, pay.dtype.str, list(pay.shape)))
            frame = np.empty(5 + len(hdr) + pay.nbytes, np.uint8)
            frame[0] = _RAW_MAGIC
            frame[1:5] = np.frombuffer(struct.pack("<I", len(hdr)),
                                       np.uint8)
            frame[5:5 + len(hdr)] = np.frombuffer(hdr, np.uint8)
            if pay.nbytes:
                frame[5 + len(hdr):] = pay.reshape(-1).view(np.uint8)
            return comm._coll_isend(frame, dest, tag)
        obj = (*obj, pay)   # exotic dtype: embed in the dss record
    buf = np.frombuffer(dss.pack(obj), dtype=np.uint8)
    return comm._coll_isend(buf, dest, tag)


def _decode_ctrl(arr: np.ndarray) -> Any:
    """Decode one received control frame; a raw-appended payload comes
    back as a zero-copy ndarray view into the frame, appended to the
    header tuple (so dispatch sees the same shape either way)."""
    arr = np.ascontiguousarray(arr).view(np.uint8).reshape(-1)
    if len(arr) and int(arr[0]) == _RAW_MAGIC:
        (hlen,) = struct.unpack_from("<I", arr, 1)
        obj, dtspec, shape = dss.unpack(
            arr[5:5 + hlen].tobytes(), n=1)[0]
        dtype = np.dtype(dtspec)
        n = 1
        for s in shape:
            n *= s
        view = np.frombuffer(arr, dtype=dtype, count=n,
                             offset=5 + hlen).reshape(shape)
        return (*obj, view)
    return dss.unpack(arr.tobytes(), n=1)[0]


def _ctrl_recv(comm, source: int, tag: int) -> Any:
    arr = comm._coll_irecv(None, source, tag).wait()
    return _decode_ctrl(arr)


def _check_predefined(op) -> None:
    """MPI rule: accumulate/fetch ops must be predefined (MPI-3.1 §11.3.4);
    the target rehydrates them by name, so user ops cannot travel."""
    if getattr(op_mod, op.name.upper(), None) is not op:
        raise MPIException(
            f"RMA accumulate requires a predefined op, got {op!r} "
            f"(user-defined ops are not valid for MPI_Accumulate)")


def stage_origin(data: Any, dtype: np.dtype, contiguous: bool = True
                 ) -> np.ndarray:
    """Host form of one origin buffer.  A tensor goes through
    ``tensor_to_host``: a dtype numpy has no name for (bf16, float8) is
    converted to ``dtype`` (the window's) on its own device, a CUDA tensor
    comes to the host in ONE device-to-host copy, a CPU tensor is viewed
    in place.  Anything else goes through ``np.ascontiguousarray`` (or
    ``np.asarray`` where ``contiguous`` is false, as the JAX package
    takes ``compare_swap``'s scalars)."""
    if not is_tensor(data):
        return np.ascontiguousarray(data) if contiguous else np.asarray(data)
    return np.ascontiguousarray(tensor_to_host(data, bits_to=dtype)[0])


def expose(buffer: Any, what: str) -> np.ndarray:
    """The numpy array a window exposes for ``buffer``: the array itself,
    or a contiguous CPU tensor's own memory.  A CUDA tensor and a tensor
    numpy cannot view (bf16, float8) raise — a host copy would decouple
    the window from the caller's tensor."""
    if not is_tensor(buffer):
        return np.asarray(buffer)
    if buffer.device.type != "cpu":
        raise MPIException(
            f"{what}: a {buffer.device.type} tensor lives in the card's "
            f"memory, which a host window cannot expose; use DeviceWindow "
            f"(ompi_tpu_torch.mpi.osc) for a window on the card, or pass "
            f"a CPU buffer")
    name = torch_dtype_name(buffer)
    if name in BITS_DTYPE:
        raise MPIException(
            f"{what}: numpy has no {name} dtype, so a host window cannot "
            f"expose this tensor's memory; pass a float32 buffer (puts of "
            f"{name} tensors are converted to the window's dtype)")
    if not buffer.is_contiguous():
        raise MPIException(
            f"{what}: the tensor must be contiguous; pass "
            f"tensor.contiguous() and keep a reference to it")
    return buffer.detach().numpy()


class _LockState:
    def __init__(self) -> None:
        self.holder: Optional[int] = None  # origin rank holding exclusive
        self.shared: set[int] = set()
        self.queue: list[tuple[int, bool]] = []  # (origin, exclusive)


class Window:
    """An RMA window over a local numpy buffer (collective constructor).

    ``buffer`` may also be a contiguous CPU tensor: the window exposes its
    memory, so remote puts land in the caller's tensor.

    ``create_dynamic`` builds a window with no initial memory; local regions
    are exposed with :meth:`attach` (local op, ≈ MPI_Win_attach) and remote
    ranks address them by the base offset attach returned — the analog of
    exchanging attached addresses out-of-band in MPI (MPI-3.1 §11.2.4).
    """

    def __init__(self, comm, size: Optional[int] = None,
                 buffer: Optional[np.ndarray] = None,
                 dtype=np.uint8, name: str = "win",
                 info=None, _dynamic: bool = False) -> None:
        self._dynamic = _dynamic
        # consulted info hints (≈ osc_rdma/osc_pt2pt reading win info):
        # no_locks=true promises the app never uses passive-target sync —
        # lock/unlock/lock_all then fail fast instead of running a
        # pointless lock service protocol
        self.info = info
        self._no_locks = bool(info) and str(
            info.get("no_locks") or "").lower() in ("true", "1")
        self._regions: dict[int, np.ndarray] = {}   # base offset → flat view
        self._next_base = 0
        if _dynamic:
            buffer = np.zeros(0, dtype=dtype)
        elif buffer is None:
            if size is None:
                raise MPIException("Window needs size= or buffer=")
            buffer = np.zeros(size, dtype=dtype)
        buffer = expose(buffer, "Window buffer")
        if not buffer.flags.c_contiguous:
            # a copy would silently decouple the window from the caller's
            # array (remote puts landing somewhere the caller never sees)
            raise MPIException(
                "Window buffer must be C-contiguous; pass a contiguous "
                "array (np.ascontiguousarray) and keep a reference to it")
        # flat VIEW (never a copy, given contiguity): RMA offsets address
        # elements in row-major order and range checks agree with indexing
        self.buf = buffer.reshape(-1)
        self._parent_comm = comm   # revocation coherence (see _check_ft)
        self.comm = comm.dup(name=f"{name}.osc")
        self.name = name
        self._buf_lock = threading.RLock()
        self._lock_state = _LockState()
        self._applied_from: dict[int, int] = {}   # origin → ops applied
        self._applied_total = 0
        self._sent_to = [0] * comm.size           # my ops per target
        self._cv = threading.Condition(self._buf_lock)
        self._errors: list[str] = []          # failed incoming put/acc ops
        self._service_dead = False
        self._epoch_reqs: list[Request] = []
        self._origin_lock = threading.Lock()      # serializes blocking ops
        self._ids = itertools.count(1)
        # PSCW epoch state (≈ osc.h:391-394 post/start/complete/wait)
        self._posts: set[int] = set()             # targets that posted to me
        self._pscw_done: set[int] = set()         # origins that completed
        self._access_group: Optional[list[int]] = None
        self._exposure_group: Optional[set[int]] = None
        self._service = threading.Thread(
            target=self._serve, name=f"osc-{name}-{comm.rank}", daemon=True)
        self._service.start()

    # -- dynamic windows ---------------------------------------------------

    @classmethod
    def create_dynamic(cls, comm, dtype=np.uint8,
                       name: str = "dynwin", info=None) -> "Window":
        """≈ MPI_Win_create_dynamic: a window with no memory attached;
        expose regions later with :meth:`attach` (collective constructor,
        local attach).  ``info`` hints (e.g. no_locks) apply as on a
        created window."""
        return cls(comm, name=name, dtype=dtype, info=info, _dynamic=True)

    def attach(self, array: np.ndarray) -> int:
        """≈ MPI_Win_attach (local): expose ``array`` (or a contiguous CPU
        tensor's memory) through this dynamic window and return its base
        offset — the "address" remote ranks use.  A one-element guard gap
        separates regions so an access can never silently span two
        attachments (MPI forbids spanning)."""
        if not self._dynamic:
            raise MPIException("attach is only valid on a dynamic window")
        array = expose(array, "attach")
        if not array.flags.c_contiguous:
            raise MPIException("attach needs a C-contiguous array")
        flat = array.reshape(-1)
        with self._cv:
            base = self._next_base
            self._regions[base] = flat
            self._next_base = base + flat.size + 1
        return base

    def detach(self, base: int) -> None:
        """≈ MPI_Win_detach (local)."""
        with self._cv:
            if self._regions.pop(base, None) is None:
                raise MPIException(f"detach: no region attached at {base}")

    def _locate(self, offset: int, count: int) -> np.ndarray:
        """Resolve [offset, offset+count) to a writable flat view — the
        window buffer itself, or the containing attached region of a
        dynamic window.  Caller holds ``_buf_lock``."""
        if not self._dynamic:
            self._check_range(offset, count)
            return self.buf[offset:offset + count]
        if count < 0:
            raise MPIException(f"negative RMA count {count}")
        for base, arr in self._regions.items():
            if base <= offset and offset + count <= base + arr.size:
                return arr[offset - base:offset - base + count]
        raise MPIException(
            f"RMA access [{offset}:{offset + count}] hits no attached "
            f"region of dynamic window {self.name!r}")

    # -- origin side -------------------------------------------------------

    def _origin(self, data: Any, contiguous: bool = True) -> np.ndarray:
        return stage_origin(data, self.buf.dtype, contiguous)

    def _track(self, target: int, req: Optional[Request] = None) -> None:
        """Count an issued op toward fence/flush totals; reap finished
        requests (amortized — a scan per op would be quadratic when the
        send worker lags the issue rate)."""
        self._sent_to[target] += 1
        if req is not None:
            self._epoch_reqs.append(req)
            if len(self._epoch_reqs) > 256:
                self._epoch_reqs = [
                    r for r in self._epoch_reqs if not r.done()]

    def _check_range(self, offset: int, count: int) -> None:
        if offset < 0 or count < 0 or offset + count > self.buf.size:
            raise MPIException(
                f"RMA access [{offset}:{offset + count}] outside window "
                f"of {self.buf.size} elements")

    def _recv_reply(self, source: int) -> Any:
        status, payload = _ctrl_recv(self.comm, source, _TAG_REPLY)
        if status == "err":
            raise MPIException(
                f"RMA op failed at rank {source}: {payload}")
        return payload

    def put(self, target: int, data: np.ndarray, offset: int = 0) -> None:
        """≈ MPI_Put: completes locally at the next sync (fence/unlock)."""
        data = self._origin(data)
        if target == self.comm.rank:
            self._apply_put(self.comm.rank, offset, data)  # raises pre-track
            self._track(target)
            return
        req = _ctrl_send(self.comm, target,
                         ("put", self.comm.rank, offset), _TAG_REQ,
                         payload=data)
        self._track(target, req)

    def put_strided(self, target: int, data: np.ndarray, offset: int = 0,
                    stride: int = 1) -> None:
        """Strided put: element i lands at ``offset + i*stride`` — one wire
        message and one counted op (the shmem_iput transport; the reference
        expresses this as a vector datatype over MPI_Put)."""
        data = self._origin(data).reshape(-1)
        if stride == 1:
            return self.put(target, data, offset)
        if stride < 1:
            raise MPIException(f"put_strided needs stride >= 1, got {stride}")
        if target == self.comm.rank:
            self._apply_put_strided(self.comm.rank, offset, stride, data)
            self._track(target)
            return
        req = _ctrl_send(self.comm, target,
                         ("puts", self.comm.rank, offset, stride),
                         _TAG_REQ, payload=data)
        self._track(target, req)

    def get(self, target: int, count: int, offset: int = 0) -> np.ndarray:
        """≈ MPI_Get (blocking convenience: data returns immediately)."""
        if target == self.comm.rank:
            with self._buf_lock:
                return self._locate(offset, count).copy()
        with self._origin_lock:
            _ctrl_send(self.comm, target,
                       ("get", self.comm.rank, offset, count), _TAG_REQ).wait()
            return np.asarray(self._recv_reply(target))

    def accumulate(self, target: int, data: np.ndarray, op=op_mod.SUM,
                   offset: int = 0) -> None:
        """≈ MPI_Accumulate: elementwise op applied atomically at target."""
        _check_predefined(op)
        data = self._origin(data)
        if target == self.comm.rank:
            self._apply_acc(self.comm.rank, offset, data, op.name)
            self._track(target)
            return
        req = _ctrl_send(self.comm, target,
                         ("acc", self.comm.rank, offset, op.name),
                         _TAG_REQ, payload=data)
        self._track(target, req)

    def fetch_op(self, target: int, value, op=op_mod.SUM,
                 offset: int = 0) -> np.ndarray:
        """≈ MPI_Fetch_and_op: atomic read-modify-write, returns old value."""
        _check_predefined(op)
        value = self._origin(value)
        if target == self.comm.rank:
            old = self._apply_fetch(self.comm.rank, offset, value, op.name)
            self._track(target)
            return old
        with self._origin_lock:
            self._track(target)
            _ctrl_send(self.comm, target,
                       ("fetch", self.comm.rank, offset, value, op.name),
                       _TAG_REQ).wait()
            return np.asarray(self._recv_reply(target))

    def _reply_tag(self) -> int:
        return _TAG_RDYN_BASE + (next(self._ids) % _TAG_RDYN_SPAN)

    def _async_reply(self, target: int, rtag: int) -> Request:
        """Post the reply receive for a request-returning op; the returned
        request completes with the decoded payload (or the target's error)."""
        inner = self.comm._coll_irecv(None, target, rtag)
        outer = Request(kind="rma")

        def _finish(r: Request) -> None:
            try:
                status, payload = _decode_ctrl(r.wait())
            except BaseException as e:          # transport failure
                outer.fail(e)
                return
            if status == "err":
                outer.fail(MPIException(
                    f"RMA op failed at rank {target}: {payload}"))
            else:
                outer.complete(np.asarray(payload))

        inner.add_completion_callback(_finish)
        return outer

    def get_accumulate(self, target: int, data: np.ndarray, op=op_mod.SUM,
                       offset: int = 0) -> np.ndarray:
        """≈ MPI_Get_accumulate: atomically fetch the target range and
        combine ``data`` into it; returns the pre-op contents.  ``NO_OP``
        gives an atomic get, ``REPLACE`` an atomic fetching put."""
        return self.rget_accumulate(target, data, op, offset).wait()

    # -- request-returning ops (≈ MPI_Rput/Rget/Raccumulate, MPI-3.1 §11.3.5;
    # completion of the request = local completion; remote completion still
    # needs flush/unlock/fence, exactly as in MPI) ------------------------

    def rput(self, target: int, data: np.ndarray, offset: int = 0) -> Request:
        """≈ MPI_Rput: the request completes when the origin buffer is
        reusable (the data is packed at issue, so that is immediate for the
        local case and send-completion otherwise)."""
        data = self._origin(data)
        if target == self.comm.rank:
            self._apply_put(self.comm.rank, offset, data)
            self._track(target)
            done = Request(kind="rma")
            done.complete(None)
            return done
        req = _ctrl_send(self.comm, target,
                         ("put", self.comm.rank, offset), _TAG_REQ,
                         payload=data)
        self._track(target, req)
        return req

    def raccumulate(self, target: int, data: np.ndarray, op=op_mod.SUM,
                    offset: int = 0) -> Request:
        """≈ MPI_Raccumulate."""
        _check_predefined(op)
        data = self._origin(data)
        if target == self.comm.rank:
            self._apply_acc(self.comm.rank, offset, data, op.name)
            self._track(target)
            done = Request(kind="rma")
            done.complete(None)
            return done
        req = _ctrl_send(self.comm, target,
                         ("acc", self.comm.rank, offset, op.name),
                         _TAG_REQ, payload=data)
        self._track(target, req)
        return req

    def rget(self, target: int, count: int, offset: int = 0) -> Request:
        """≈ MPI_Rget: ``request.wait()`` returns the fetched array.
        Several rgets may be outstanding to the same target (each reply
        rides a unique tag)."""
        if target == self.comm.rank:
            with self._buf_lock:
                out = self._locate(offset, count).copy()
            done = Request(kind="rma")
            done.complete(out)
            return done
        rtag = self._reply_tag()
        reply = self._async_reply(target, rtag)
        _ctrl_send(self.comm, target,
                   ("get2", self.comm.rank, offset, count, rtag), _TAG_REQ)
        return reply

    def rget_accumulate(self, target: int, data: np.ndarray, op=op_mod.SUM,
                        offset: int = 0) -> Request:
        """≈ MPI_Rget_accumulate: wait() returns the pre-op target range."""
        _check_predefined(op)
        data = self._origin(data)
        if target == self.comm.rank:
            old = self._apply_fetch(self.comm.rank, offset, data, op.name)
            self._track(target)
            done = Request(kind="rma")
            done.complete(old)
            return done
        rtag = self._reply_tag()
        reply = self._async_reply(target, rtag)
        self._track(target)
        _ctrl_send(self.comm, target,
                   ("fetch2", self.comm.rank, offset, data, op.name, rtag),
                   _TAG_REQ)
        return reply

    def compare_swap(self, target: int, compare, value,
                     offset: int = 0) -> np.ndarray:
        """≈ MPI_Compare_and_swap (single element)."""
        compare = self._origin(compare, contiguous=False)
        value = self._origin(value, contiguous=False)
        if target == self.comm.rank:
            old = self._apply_cswap(self.comm.rank, offset, compare, value)
            self._track(target)
            return old
        with self._origin_lock:
            self._track(target)
            _ctrl_send(self.comm, target,
                       ("cswap", self.comm.rank, offset, compare, value),
                       _TAG_REQ).wait()
            return np.asarray(self._recv_reply(target))

    # -- synchronization ---------------------------------------------------

    def _check_ft(self, what: str) -> None:
        """Epoch-entry ULFM gate: a window whose parent communicator was
        revoked is itself poisoned (the dup inherits the revocation here,
        so every member's epochs error coherently), and an already-revoked
        window refuses new epochs with MPI_ERR_REVOKED."""
        from ompi_tpu_torch.mpi import ft

        if (self.comm.pml.ft is None
                and self._parent_comm.pml.ft is None):
            return   # FT never engaged in this process: zero-cost exit
        if (ft.comm_is_revoked(self._parent_comm)
                and not ft.comm_is_revoked(self.comm)):
            ft.pml_ft(self.comm.pml).mark_revoked(self.comm.cid)
        if ft.comm_is_revoked(self.comm):
            raise MPIException(
                f"window {self.name!r}: {what} on a revoked communicator",
                error_class=ERR_REVOKED)

    def fence(self) -> None:
        """Active-target epoch boundary (≈ MPI_Win_fence)."""
        self._check_ft("fence")
        if trace_mod.active:   # epoch spans on the osc timeline
            with trace_mod.span("osc", "fence", rank=self.comm.pml.rank,
                                win=self.name):
                return self._fence_impl()
        return self._fence_impl()

    def _fence_impl(self) -> None:
        for r in self._epoch_reqs:
            r.wait()
        self._epoch_reqs.clear()
        # every rank learns how many ops target it: column sums of the
        # sent-counts matrix
        sent = np.array(self._sent_to, dtype=np.int64)
        incoming = self.comm.allreduce(sent, op=op_mod.SUM)
        expected = int(incoming[self.comm.rank])
        with self._cv:
            self._cv.wait_for(lambda: self._applied_total >= expected
                              or self._service_dead)
            if self._service_dead and self._applied_total < expected:
                raise MPIException(
                    f"window {self.name!r}: service stopped with "
                    f"{expected - self._applied_total} incoming ops pending")
            errors, self._errors = self._errors, []
        self.comm.barrier()
        if errors:
            raise MPIException(
                "RMA ops failed at this target during the epoch: "
                + "; ".join(errors))

    # -- PSCW (generalized active target, ≈ osc.h:391-394) ----------------

    def post(self, origins: list[int]) -> None:
        """≈ MPI_Win_post: expose this window to ``origins`` (nonblocking).
        Matching ``start`` calls at the origins unblock once this arrives."""
        self._check_ft("post")
        if self._exposure_group is not None:
            raise MPIException("MPI_Win_post while an exposure epoch is open")
        self._exposure_group = set(origins)
        for o in origins:
            _ctrl_send(self.comm, o, ("post", self.comm.rank), _TAG_REQ)
        if trace_mod.active:
            trace_mod.instant("osc", "post", rank=self.comm.pml.rank,
                              win=self.name, origins=list(origins))

    def start(self, targets: list[int]) -> None:
        """≈ MPI_Win_start: open an access epoch to ``targets``; blocks until
        every target's post arrived (the reference may defer this wait to the
        first op — blocking here keeps the semantics strict and simple)."""
        self._check_ft("start")
        if self._access_group is not None:
            raise MPIException("MPI_Win_start while an access epoch is open")
        want = set(targets)
        with self._cv:
            self._cv.wait_for(lambda: want <= self._posts
                              or self._service_dead)
            if not want <= self._posts:
                raise MPIException(
                    f"window {self.name!r}: service stopped while waiting "
                    f"for posts from {sorted(want - self._posts)}")
            self._posts -= want
        self._access_group = list(targets)

    def complete(self) -> None:
        """≈ MPI_Win_complete: end the access epoch — all my ops to the
        targets are locally complete and a completion marker is on the wire
        behind them (FIFO per channel ⇒ ordered after every op)."""
        if self._access_group is None:
            raise MPIException("MPI_Win_complete without MPI_Win_start")
        _t0 = trace_mod.begin() if trace_mod.active else 0
        for r in self._epoch_reqs:
            r.wait()
        self._epoch_reqs.clear()
        for t in self._access_group:
            _ctrl_send(self.comm, t,
                       ("pscw_done", self.comm.rank, self._sent_to[t]),
                       _TAG_REQ)
        if _t0 and trace_mod.active:
            trace_mod.complete("osc", "pscw_complete", _t0,
                               rank=self.comm.pml.rank, win=self.name,
                               targets=list(self._access_group))
        self._access_group = None

    def wait(self) -> None:
        """≈ MPI_Win_wait: end the exposure epoch — blocks until every origin
        in the post group completed (hence all their ops are applied here)."""
        if self._exposure_group is None:
            raise MPIException("MPI_Win_wait without MPI_Win_post")
        _t0 = trace_mod.begin() if trace_mod.active else 0
        want = self._exposure_group
        with self._cv:
            self._cv.wait_for(lambda: want <= self._pscw_done
                              or self._service_dead)
            if not want <= self._pscw_done:
                raise MPIException(
                    f"window {self.name!r}: service stopped with "
                    f"incomplete origins {sorted(want - self._pscw_done)}")
            self._pscw_done -= want
            errors, self._errors = self._errors, []
        self._exposure_group = None
        if _t0 and trace_mod.active:
            trace_mod.complete("osc", "pscw_wait", _t0,
                               rank=self.comm.pml.rank, win=self.name)
        if errors:
            raise MPIException(
                "RMA ops failed at this target during the PSCW epoch: "
                + "; ".join(errors))

    def test_epoch(self) -> bool:
        """≈ MPI_Win_test: nonblocking wait(); True ⇒ epoch closed."""
        if self._exposure_group is None:
            raise MPIException("MPI_Win_test without MPI_Win_post")
        with self._cv:
            if not self._exposure_group <= self._pscw_done:
                return False
        self.wait()
        return True

    def lock_all(self) -> None:
        """≈ MPI_Win_lock_all: shared lock on every rank."""
        for t in range(self.comm.size):
            self.lock(t, exclusive=False)

    def unlock_all(self) -> None:
        """≈ MPI_Win_unlock_all."""
        for t in range(self.comm.size):
            self.unlock(t)

    def flush_all(self) -> None:
        """≈ MPI_Win_flush_all: my ops are applied at every target."""
        for t in range(self.comm.size):
            self.flush(t)

    def flush_local(self, target: int) -> None:
        """≈ MPI_Win_flush_local: origin buffers reusable.  Ops here pack at
        issue, so local completion only needs the sends drained."""
        for r in self._epoch_reqs:
            r.wait()
        self._epoch_reqs.clear()

    def flush_local_all(self) -> None:
        """≈ MPI_Win_flush_local_all (local completion is target-agnostic
        here — see flush_local)."""
        self.flush_local(-1)

    def get_group(self):
        """≈ MPI_Win_get_group."""
        return self.comm.group

    def get_name(self) -> str:
        """≈ MPI_Win_get_name."""
        return self.name

    def set_name(self, name: str) -> None:
        """≈ MPI_Win_set_name."""
        self.name = str(name)

    def set_info(self, info) -> None:
        """≈ MPI_Win_set_info (hints stored; no_locks honored at create)."""
        self.info = info

    def get_info(self):
        """≈ MPI_Win_get_info."""
        from ompi_tpu_torch.mpi.info import Info

        return getattr(self, "info", None) or Info()

    def lock(self, target: int, exclusive: bool = True) -> None:
        """≈ MPI_Win_lock (passive target). A local target still goes
        through the service, keeping lock fairness uniform."""
        self._check_ft("lock")
        if self._no_locks:
            raise MPIException(
                "MPI_Win_lock on a window created with the no_locks=true "
                "info hint (the app promised no passive-target sync)",
                error_class=51)
        _t0 = trace_mod.begin() if trace_mod.active else 0
        with self._origin_lock:
            _ctrl_send(self.comm, target,
                       ("lock", self.comm.rank, bool(exclusive)),
                       _TAG_REQ).wait()
            self._recv_reply(target)  # grant
        if _t0 and trace_mod.active:
            trace_mod.complete("osc", "lock", _t0,
                               rank=self.comm.pml.rank, win=self.name,
                               target=target, exclusive=bool(exclusive))

    def unlock(self, target: int) -> None:
        """≈ MPI_Win_unlock: flush my ops at target, release the lock."""
        _t0 = trace_mod.begin() if trace_mod.active else 0
        with self._origin_lock:
            _ctrl_send(self.comm, target,
                       ("unlock", self.comm.rank, self._sent_to[target]),
                       _TAG_REQ).wait()
            self._recv_reply(target)  # flushed + released
        if _t0 and trace_mod.active:
            trace_mod.complete("osc", "unlock", _t0,
                               rank=self.comm.pml.rank, win=self.name,
                               target=target)

    def flush(self, target: int) -> None:
        """≈ MPI_Win_flush: wait until target applied all my ops."""
        if target == self.comm.rank or self._sent_to[target] == 0:
            return
        with self._origin_lock:
            _ctrl_send(self.comm, target,
                       ("flush", self.comm.rank, self._sent_to[target]),
                       _TAG_REQ).wait()
            self._recv_reply(target)

    def free(self) -> None:
        """Collective destructor (≈ MPI_Win_free)."""
        self.comm.barrier()
        _ctrl_send(self.comm, self.comm.rank, ("stop",), _TAG_REQ).wait()
        self._service.join(timeout=5)

    # -- target side (service thread) --------------------------------------

    def _serve(self) -> None:
        while True:
            try:
                msg = _ctrl_recv(self.comm, ANY_SOURCE, _TAG_REQ)
            except Exception as e:
                # a failed receive (peer death, transport teardown before
                # free()) must not leave waiters hanging silently: flag the
                # service as gone and wake them so fence() can raise
                with self._cv:
                    self._service_dead = True
                    self._cv.notify_all()
                _log.verbose(1, "window %r service stopped: %r",
                             self.name, e)
                return
            kind = msg[0]
            if kind == "stop":
                return
            try:
                self._dispatch(kind, msg)
            except Exception as e:
                self._dispatch_failed(kind, msg, e)

    def _dispatch_failed(self, kind: str, msg: tuple, e: Exception) -> None:
        """A bad op must not wedge the job: counted ops still bump the
        applied counter (so fences/flushes terminate) and reply-carrying
        ops turn the failure into the origin's exception."""
        origin = msg[1] if len(msg) > 1 else -1
        if kind in ("put", "puts", "acc", "fetch", "cswap", "fetch2"):
            with self._cv:
                if kind in ("put", "puts", "acc"):
                    # no reply channel: surface at this rank's next fence
                    self._errors.append(f"{kind} from rank {origin}: {e}")
                self._bump(origin)
        if kind in ("get", "fetch", "cswap", "lock", "unlock", "flush"):
            try:
                _ctrl_send(self.comm, origin, ("err", str(e)), _TAG_REPLY)
            except Exception:
                pass
        if kind in ("get2", "fetch2"):
            try:
                _ctrl_send(self.comm, origin, ("err", str(e)), msg[-1])
            except Exception:
                pass

    def _dispatch(self, kind: str, msg: tuple) -> None:
        if kind == "put":
            _, origin, offset, data = msg
            self._apply_put(origin, offset, data)
        elif kind == "puts":
            _, origin, offset, stride, data = msg
            self._apply_put_strided(origin, offset, stride, data)
        elif kind == "acc":
            _, origin, offset, opname, data = msg
            self._apply_acc(origin, offset, data, opname)
        elif kind == "get":
            _, origin, offset, count = msg
            with self._buf_lock:
                out = self._locate(offset, count).copy()
            _ctrl_send(self.comm, origin, ("ok",), _TAG_REPLY,
                       payload=out)
        elif kind == "get2":
            _, origin, offset, count, rtag = msg
            with self._buf_lock:
                out = self._locate(offset, count).copy()
            _ctrl_send(self.comm, origin, ("ok",), rtag, payload=out)
        elif kind == "fetch2":
            _, origin, offset, value, opname, rtag = msg
            old = self._apply_fetch(origin, offset, value, opname)
            _ctrl_send(self.comm, origin, ("ok",), rtag, payload=old)
        elif kind == "post":
            _, target = msg
            with self._cv:
                self._posts.add(target)
                self._cv.notify_all()
        elif kind == "pscw_done":
            # FIFO per (origin → me) channel on _TAG_REQ means every op the
            # origin issued this epoch was dispatched before this marker —
            # no applied-count handshake needed.  Validated explicitly (a
            # bare assert vanishes under -O, and an AssertionError swallowed
            # by the dispatch loop would hang the peer's Win_wait silently);
            # the epoch still completes so wait() returns with the error on
            # the record rather than deadlocking.
            _, origin, expected = msg
            with self._cv:
                applied = self._applied_from.get(origin, 0)
                if applied < expected:
                    # recorded on the epoch: the waiting Win_wait returns
                    # (no silent hang) but raises with this error
                    self._errors.append(
                        f"pscw_done from {origin} before its ops were "
                        f"applied ({applied} < {expected}) — per-channel "
                        f"FIFO violated")
                    _log.error("osc: %s", self._errors[-1])
                self._pscw_done.add(origin)
                self._cv.notify_all()
        elif kind == "fetch":
            _, origin, offset, value, opname = msg
            old = self._apply_fetch(origin, offset, value, opname)
            _ctrl_send(self.comm, origin, ("ok", old), _TAG_REPLY)
        elif kind == "cswap":
            _, origin, offset, compare, value = msg
            old = self._apply_cswap(origin, offset, compare, value)
            _ctrl_send(self.comm, origin, ("ok", old), _TAG_REPLY)
        elif kind == "lock":
            _, origin, exclusive = msg
            self._handle_lock(origin, exclusive)
        elif kind == "unlock":
            _, origin, expected = msg
            self._wait_applied(origin, expected)
            self._handle_unlock(origin)
            _ctrl_send(self.comm, origin, ("ok", None), _TAG_REPLY)
        elif kind == "flush":
            _, origin, expected = msg
            self._wait_applied(origin, expected)
            _ctrl_send(self.comm, origin, ("ok", None), _TAG_REPLY)
        else:
            raise MPIException(f"osc: unknown request {kind!r}")

    # -- local application (atomic under _buf_lock) ------------------------

    def _bump(self, origin: int) -> None:
        self._applied_from[origin] = self._applied_from.get(origin, 0) + 1
        self._applied_total += 1
        self._cv.notify_all()

    def _apply_put(self, origin: int, offset: int, data: np.ndarray) -> None:
        with self._cv:
            seg = self._locate(offset, len(data))
            seg[:] = data.astype(seg.dtype, copy=False)
            self._bump(origin)

    def _apply_put_strided(self, origin: int, offset: int, stride: int,
                           data: np.ndarray) -> None:
        with self._cv:
            span = (len(data) - 1) * stride + 1 if len(data) else 0
            seg = self._locate(offset, span)
            seg[::stride] = data.astype(seg.dtype, copy=False)
            self._bump(origin)

    def _apply_acc(self, origin: int, offset: int, data: np.ndarray,
                   opname: str) -> None:
        op = getattr(op_mod, opname.upper())
        with self._cv:
            seg = self._locate(offset, len(data))
            seg[:] = op.host(seg.copy(), data.astype(seg.dtype, copy=False))
            self._bump(origin)

    def _apply_fetch(self, origin: int, offset: int, value: np.ndarray,
                     opname: str) -> np.ndarray:
        op = getattr(op_mod, opname.upper())
        with self._cv:
            n = max(1, np.asarray(value).size)
            seg = self._locate(offset, n)
            old = seg.copy()
            seg[:] = op.host(
                old, np.asarray(value).astype(old.dtype, copy=False))
            self._bump(origin)
            return old

    def _apply_cswap(self, origin: int, offset: int, compare,
                     value) -> np.ndarray:
        with self._cv:
            seg = self._locate(offset, 1)
            old = seg.copy()
            if old[0] == np.asarray(compare).reshape(-1)[0]:
                seg[0] = np.asarray(value).reshape(-1)[0]
            self._bump(origin)
            return old

    def _wait_applied(self, origin: int, expected: int) -> None:
        with self._cv:
            self._cv.wait_for(
                lambda: self._applied_from.get(origin, 0) >= expected)

    # -- lock queueing -----------------------------------------------------

    def _handle_lock(self, origin: int, exclusive: bool) -> None:
        with self._cv:
            st = self._lock_state
            # new requests queue behind ANY waiter (even shared behind a
            # queued exclusive) — otherwise a stream of shared lockers
            # starves exclusive waiters forever
            grantable = (st.holder is None and not st.queue and
                         (exclusive is False or not st.shared))
            if grantable:
                if exclusive:
                    st.holder = origin
                else:
                    st.shared.add(origin)
            else:
                st.queue.append((origin, exclusive))
                return
        _ctrl_send(self.comm, origin, ("ok", None), _TAG_REPLY)

    def _handle_unlock(self, origin: int) -> None:
        grants = []
        with self._cv:
            st = self._lock_state
            if st.holder == origin:
                st.holder = None
            st.shared.discard(origin)
            while st.queue and st.holder is None:
                nxt, excl = st.queue[0]
                if excl:
                    if st.shared:
                        break
                    st.queue.pop(0)
                    st.holder = nxt
                    grants.append(nxt)
                    break
                st.queue.pop(0)
                st.shared.add(nxt)
                grants.append(nxt)
        for g in grants:
            _ctrl_send(self.comm, g, ("ok", None), _TAG_REPLY)


class DeviceWindow:
    """Device-resident RMA window: the osc/rdma strategy on the card.

    Collective allocation (≈ MPI_Win_allocate): every rank of ``dcomm``
    gets one ``local_shape`` part of a symmetric window, which its peers
    have mapped; ``put``/``get`` run the one-sided copy kernels of
    ``ops/remote_dma`` straight into and out of the peer's part, with no
    service thread and no active messages.  Every rank makes every call.

    Each process holds its own part (``array``), updated in place.  Per-op
    completion is implicit (each call drains its copy before returning on
    the ranks it touches); ``fence()`` is a device barrier.  torch and
    the device modules load when the first one is constructed.
    """

    def __init__(self, dcomm, local_shape, dtype=np.float32, fill=0):
        from ompi_tpu_torch.mpi.device_comm import torch_dtype

        self.comm = dcomm
        self.local_shape = tuple(int(s) for s in local_shape)
        self.array = dcomm.window(self.local_shape, torch_dtype(dtype), fill)

    @property
    def dtype(self):
        return self.array.dtype

    def _origin_value(self, data):
        """Origin-local data as a tensor on the window's device (every
        rank passes data of the window's shape; only the origin's is
        read)."""
        import torch

        value = torch.as_tensor(np.asarray(data) if not isinstance(
            data, torch.Tensor) else data).to(self.array.device,
                                              self.array.dtype)
        if tuple(value.shape) != self.local_shape:
            raise MPIException(
                f"DeviceWindow: data shape {tuple(value.shape)} must match "
                f"the window's local shape {self.local_shape}")
        return value.contiguous()

    def put(self, data, origin: int, target: int) -> None:
        """origin's ``data`` lands in target's part of the window (only the
        origin→target path moves bytes)."""
        self.array = self.comm.put(self.array, self._origin_value(data),
                                   int(origin), int(target))

    def get(self, origin: int, target: int):
        """origin fetches target's part one-sided.  Returns, as a numpy
        array, what this rank's call returns: target's part on origin, its
        own part on every other rank."""
        fetched = self.comm.get(self.array, int(target), int(origin))
        return fetched.cpu().numpy()

    def local(self, rank: int):
        """Host copy of this rank's current part (``rank`` must be the
        caller's: a process holds only its own part)."""
        me = self.comm.rank()
        if int(rank) != me:
            raise MPIException(
                f"DeviceWindow.local({rank}) on rank {me}: each process "
                "holds only its own part; gather the parts over the host "
                "group, or get() them one-sided")
        return self.array.cpu().numpy()

    def fence(self) -> None:
        """Active-target epoch boundary: a device barrier (the ops already
        completed per call; the fence orders epochs)."""
        self.comm.barrier()

    def free(self) -> None:
        """Collective: release the window on every rank."""
        from ompi_tpu_torch.ops import symmetric

        if self.array is not None:
            symmetric.free(self.comm.mesh, self.array)
        self.array = None


class SharedWindow:
    """≈ MPI_Win_allocate_shared + the osc/sm component: every rank of a
    shared-memory-domain communicator (MPI_Comm_split_type(
    COMM_TYPE_SHARED) — enforced) owns a contiguous slice of ONE shared
    segment, and any rank may load/store any slice directly — no
    messages, the memory IS the window (osc_sm_component.c's model).

    ``shared_query(rank)`` returns a numpy view of that rank's slice
    (zero-copy into the mapping).  ``sync()`` is the WIN_SYNC memory
    barrier + a communicator barrier; direct stores are visible to peers
    after it (x86 TSO + the mmap being literally the same pages).
    ``fetch_add(rank, offset8, delta)`` exposes the native u64 atomics
    on any aligned slot, the lock-free counter pattern osc/sm serves.

    The segment is named ``otpu-shwin-<name>-<uid>-t<nonce>``: the ``t``
    keeps the port's names apart from the JAX package's, whose per-process
    nonce counter runs beside this one when both live in one process.
    """

    def __init__(self, comm, local_size: int, dtype=np.uint8,
                 name: str = "shwin") -> None:
        self.comm = comm
        self.name = name
        self.dtype = np.dtype(dtype)
        keys = np.asarray(comm.allgather(np.array(
            [comm._my_host_key()], np.int64))).ravel()
        if len(set(int(k) for k in keys)) != 1:
            raise MPIException(
                "SharedWindow requires a single-host communicator "
                "(split_type(COMM_TYPE_SHARED) first)", error_class=3)
        # per-rank slices padded to 8 bytes so every slice start is a
        # valid atomic slot (fetch_add's alignment contract)
        nbytes = (int(local_size) * self.dtype.itemsize + 7) & ~7
        self._local_bytes = int(local_size) * self.dtype.itemsize
        # padded slice sizes AND unpadded extents: shared_query(rank) must
        # report rank's OWN requested extent (heterogeneous local_size —
        # e.g. rank 0 owns the whole node buffer, everyone else passes 0 —
        # is the core MPI_Win_allocate_shared use case)
        both = np.asarray(comm.allgather(np.array(
            [nbytes, self._local_bytes], np.int64))).reshape(-1, 2)
        sizes = both[:, 0]
        self._extents = both[:, 1]
        self._offsets = np.concatenate([[0], np.cumsum(sizes)])
        total = int(self._offsets[-1])
        # rank 0 creates (nonce'd name — concurrent windows must not
        # collide), everyone attaches; same discipline as sharedfp/sm.
        # backing_dir() falls back when /dev/shm is absent — it resolves
        # identically in every same-host process.
        from ompi_tpu_torch.core import shmseg

        base_dir = shmseg.backing_dir()
        safe = "".join(c for c in name if c.isalnum())[:16] or "shwin"
        self._seg = None
        err = ""
        # the create/attach outcome is AGREED collectively (the sharedfp
        # discipline): a rank-0 ENOSPC must raise on every rank, not
        # strand the others in the bcast/barrier below.  The name bcast
        # doubles as the outcome flag — empty name ⇒ create failed.
        if comm.rank == 0:
            nonce = os.getpid() << 16 | (next(_shwin_nonce) & 0xFFFF)
            seg_name = f"otpu-shwin-{safe}-{os.getuid()}-t{nonce:x}"
            try:
                self._seg = shmseg.create(seg_name, max(total, 8),
                                          dir=base_dir, publish=False)
                np.frombuffer(self._seg.buf, np.uint8)[:] = 0
                self._seg.publish()
            except OSError as e:
                err = str(e)
                seg_name = ""
            comm.bcast(np.frombuffer(
                seg_name.encode().ljust(96), np.uint8).copy(), root=0)
        else:
            raw = np.asarray(comm.bcast(np.zeros(96, np.uint8), root=0))
            seg_name = bytes(raw).rstrip(b"\x00").rstrip().decode()
            if not seg_name:
                err = "segment creation failed on rank 0"
            else:
                try:
                    self._seg = shmseg.attach(
                        os.path.join(base_dir, seg_name))
                except OSError as e:
                    err = str(e)
        ok = int(np.asarray(comm.allreduce(np.array(
            [0 if err else 1], np.int32), op=op_mod.MIN))[0])
        if not ok:
            if self._seg is not None:   # my attach worked; a peer's didn't
                try:
                    if comm.rank == 0:
                        self._seg.unlink()
                    self._seg.detach()
                except Exception:  # noqa: BLE001 — teardown best-effort
                    pass
                self._seg = None
            raise MPIException(
                "MPI_Win_allocate_shared: segment setup failed"
                + (f": {err}" if err else " on a peer rank"),
                error_class=16)
        comm.barrier()

    def shared_query(self, rank: int) -> np.ndarray:
        """Zero-copy view of ``rank``'s slice (≈ MPI_Win_shared_query) —
        the REQUESTED extent (padding bytes are not exposed)."""
        lo = int(self._offsets[rank])
        return np.frombuffer(self._seg.buf, np.uint8,
                             count=int(self._extents[rank]),
                             offset=lo).view(self.dtype)

    @property
    def local(self) -> np.ndarray:
        return self.shared_query(self.comm.rank)

    def sync(self) -> None:
        """≈ MPI_Win_sync + barrier: order my stores before peers read."""
        self.comm.barrier()

    def fetch_add(self, rank: int, offset8: int, delta: int) -> int:
        """Native u64 atomic fetch-add on an 8-byte-aligned slot of
        ``rank``'s slice (lock-free cross-process counters)."""
        from ompi_tpu_torch import _native

        fast = _native.fastdss()
        if fast is None:
            raise MPIException("native atomics unavailable",
                               error_class=16)
        return int(fast.atomic_add(
            self._seg.buf, int(self._offsets[rank]) + int(offset8) * 8,
            int(delta)))

    def free(self) -> None:
        self.comm.barrier()
        if self.comm.rank == 0:
            self._seg.unlink()
        try:
            self._seg.detach()
        except Exception:  # noqa: BLE001 — teardown best-effort
            pass
