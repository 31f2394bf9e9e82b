"""Communicators: group + context id + per-communicator collective table
(the port's trimmed copy of the JAX package's ``mpi/comm.py``).

≈ ompi/communicator (communicator.h:134-189: cid, local/remote groups, the
c_coll function table) and CID allocation (comm_cid.c:51-124).  The
collective table (``self.coll``) is installed by ``ompi_tpu_torch.mpi.coll``
at creation by priority query, as coll_base_comm_select.c:107.

A communicator carries two routes:

- the host route: point-to-point calls and collectives on host buffers
  (numpy arrays, bytes) go through its PML (``pml=``, the ob1 PML over
  the self/proc/shm/tcp BTLs) and coll/shm's arena or coll/host's
  algorithms.  ``init()`` builds
  ``COMM_WORLD`` this way; a hand-made one is
  ``Communicator(Group(range(n)), cid=0, my_world_rank=rank, pml=pml)``.
- the device route: a communicator bound to a ``DeviceCommunicator``
  (``comm.bind_device(device_world(mesh))``) runs its collectives on
  torch tensors there, through coll/xla, with no host copy.  A tensor is
  never staged through the PML: point-to-point calls refuse it.

CID allocation is deterministic: each parent carries a monotonic
per-parent counter and every member computes the same new cid with no
traffic (``dup``, ``create``, ``split``); ``create_group``, collective over
the new group's members only, derives its cid from a crc32 of (parent
cid, member world ranks, tag, call sequence) instead.  A communicator
made by ``split``, ``create`` or ``create_group`` has no device binding
(its group is not the mesh's); ``dup`` keeps it.

Errors route through the communicator's errhandler (``mpi.errhandler``:
ERRORS_RETURN by default, the ``MPIException`` propagating; a user
handler that returns True swallows a validation error and the call
becomes a no-op).  Attributes are cached under ``mpi.info.Keyval``s with
copy and delete callbacks, run by ``dup`` and ``free``.

Left out (ROADMAP.md Queue 1 item 6): nonblocking, persistent,
partitioned and neighbourhood collectives, the topologies and fault
tolerance (``shrink``).
"""

from __future__ import annotations

import threading
from typing import Any, Optional

import numpy as np

from ompi_tpu_torch.mpi import datatype as dt_mod
from ompi_tpu_torch.mpi import op as op_mod
from ompi_tpu_torch.mpi.constants import (ANY_SOURCE, ANY_TAG,
                                          COMM_TYPE_SHARED, PROC_NULL,
                                          UNDEFINED, MPIException)
from ompi_tpu_torch.mpi.datatype import Datatype
from ompi_tpu_torch.mpi.group import Group
# the PML's refusal, checked here as well so that a communicator with no
# PML refuses a tensor the same way
from ompi_tpu_torch.mpi.pml import MESSAGE_NO_PROC, _reject_device
from ompi_tpu_torch.mpi.request import CompletedRequest, Request, Status

__all__ = ["Communicator"]

# tag space: user tags ≥ 0; negative tags reserved for internal collectives
# (≈ the reference's MCA_COLL_BASE_TAG_* negative tag range)
_INTERNAL_TAG_BASE = -1000


class Communicator:
    """A group of ranks sharing an isolated message context."""

    def __init__(self, group: Group, cid: int, my_world_rank: int,
                 name: str = "comm", pml=None) -> None:
        self.group = group
        self.cid = cid
        self.pml = pml
        self._world_rank = my_world_rank
        self.name = name
        self.rank = group.rank_of(my_world_rank)
        self._cid_next = cid * 1024 + 1
        self._cg_seq: dict = {}   # create_group per-key call sequence
        self._lock = threading.Lock()
        self.coll = None  # installed by ompi_tpu_torch.mpi.coll.install()
        self.device = None  # bound DeviceCommunicator (coll/xla path)
        self.attrs: dict[Any, Any] = {}  # ≈ MPI attribute caching
        self._coll_shm_state = None  # coll/shm's cached arena/hierarchy
        # error policy (≈ ompi_errhandler; default mirrors ERRORS_RETURN —
        # the MPIException propagating IS the returned error code here)
        from ompi_tpu_torch.mpi import coll
        from ompi_tpu_torch.mpi import errhandler as _eh

        self.errhandler = _eh.ERRORS_RETURN

        coll.install(self)

    # -- basics ------------------------------------------------------------

    @property
    def size(self) -> int:
        return self.group.size

    def get_group(self) -> Group:
        """≈ MPI_Comm_group."""
        return self.group

    def get_name(self) -> str:
        """≈ MPI_Comm_get_name."""
        return self.name

    def set_name(self, name: str) -> None:
        """≈ MPI_Comm_set_name."""
        self.name = str(name)

    def world_rank(self, rank: int) -> int:
        return self.group.world_rank(rank)

    def _raise(self, exc: MPIException) -> None:
        """Route an error through the installed errhandler (which raises
        unless a user handler swallows it)."""
        self.errhandler.invoke(self, exc)

    def set_errhandler(self, eh) -> None:
        """≈ MPI_Comm_set_errhandler."""
        self.errhandler = eh

    def get_errhandler(self):
        return self.errhandler

    def _check_rank(self, rank: int, what: str = "rank") -> bool:
        """True when the op may proceed.  A user errhandler that swallows
        the error turns the operation into a no-op (proceeding with an
        invalid rank would negative-index into the group)."""
        if rank == PROC_NULL:
            return True
        if not 0 <= rank < self.size:
            self._raise(MPIException(
                f"{what} {rank} out of range for {self.name} "
                f"(size {self.size})", error_class=6))
            return False
        return True

    # -- point-to-point ----------------------------------------------------

    def isend(self, buf: Any, dest: int, tag: int = 0,
              datatype: Optional[Datatype] = None,
              count: Optional[int] = None) -> Request:
        return self._isend_mode("standard", buf, dest, tag, datatype, count)

    def send(self, buf: Any, dest: int, tag: int = 0,
             datatype: Optional[Datatype] = None,
             count: Optional[int] = None) -> None:
        self.isend(buf, dest, tag, datatype, count).wait()

    # send modes (≈ MPI_Ssend/Bsend/Rsend and their nonblocking forms)

    def _send_args_ok(self, dest: int, tag: int) -> bool:
        """Shared dest/tag validation for every send flavor. False ⇒ the
        caller should return a no-op request (error was routed through the
        errhandler, or dest is PROC_NULL)."""
        if not self._check_rank(dest, "dest"):
            return False
        if tag < 0:
            self._raise(MPIException(f"negative tag {tag} is reserved",
                                     error_class=4))
            return False  # swallowed: must not hit the internal tag space
        return dest != PROC_NULL

    def _isend_mode(self, mode: str, buf, dest, tag, datatype, count
                    ) -> Request:
        if not self._send_args_ok(dest, tag):
            return CompletedRequest()
        _reject_device(buf, "isend")
        return self.pml.isend(buf, self.world_rank(dest), tag, self.cid,
                              datatype, count, mode=mode)

    def issend(self, buf, dest: int, tag: int = 0, datatype=None,
               count=None) -> Request:
        """≈ MPI_Issend: completes once the matching recv is posted."""
        return self._isend_mode("sync", buf, dest, tag, datatype, count)

    def ssend(self, buf, dest: int, tag: int = 0, **kw) -> None:
        self.issend(buf, dest, tag, **kw).wait()

    def ibsend(self, buf, dest: int, tag: int = 0, datatype=None,
               count=None) -> Request:
        """≈ MPI_Ibsend: local completion against the attached buffer
        (``comm.pml.bsend_pool``, ``ompi_tpu_torch.mpi.pml.buffer_attach``)."""
        return self._isend_mode("buffered", buf, dest, tag, datatype, count)

    def bsend(self, buf, dest: int, tag: int = 0, **kw) -> None:
        self.ibsend(buf, dest, tag, **kw).wait()

    def irsend(self, buf, dest: int, tag: int = 0, datatype=None,
               count=None) -> Request:
        """≈ MPI_Irsend: erroneous (fails) unless the recv is posted."""
        return self._isend_mode("ready", buf, dest, tag, datatype, count)

    def rsend(self, buf, dest: int, tag: int = 0, **kw) -> None:
        self.irsend(buf, dest, tag, **kw).wait()

    def _recv_src(self, source: int) -> Optional[int]:
        """The PML source for a recv: a world rank, ANY_SOURCE, or None
        for an empty completed receive (PROC_NULL, or an error the
        errhandler swallowed)."""
        if source < 0 and source not in (ANY_SOURCE, PROC_NULL):
            self._raise(MPIException(
                f"source {source} is neither a rank nor "
                f"ANY_SOURCE/PROC_NULL", error_class=6))
            return None
        if source == PROC_NULL or (source >= 0
                                   and not self._check_rank(source,
                                                            "source")):
            return None
        return source if source < 0 else self.world_rank(source)

    def irecv(self, buf: Optional[np.ndarray] = None, source: int = 0,
              tag: int = ANY_TAG, datatype: Optional[Datatype] = None,
              count: Optional[int] = None) -> Request:
        src = self._recv_src(source)
        if src is None:
            return CompletedRequest(
                np.empty(0, dtype=(datatype or dt_mod.BYTE).base_np))
        if buf is not None:
            _reject_device(buf, "irecv")
        return self.pml.irecv(buf, src, tag, self.cid, datatype, count)

    def _group_status(self, status: Optional[Status], st: Status) -> None:
        """Copy ``st`` into ``status`` with the source as a group rank."""
        if status is not None:
            status.__dict__.update(st.__dict__)
            if status.source >= 0:
                status.source = self.group.rank_of(status.source)

    def recv(self, buf: Optional[np.ndarray] = None, source: int = 0,
             tag: int = ANY_TAG, datatype: Optional[Datatype] = None,
             count: Optional[int] = None,
             status: Optional[Status] = None) -> np.ndarray:
        req = self.irecv(buf, source, tag, datatype, count)
        # receiver-pull progress when the PML offers it: the blocked
        # thread drains its own shm rings instead of waiting for the
        # poller's futex handoff
        waiter = getattr(self.pml, "_progress_wait", None)
        out = waiter(req) if waiter is not None else req.wait()
        self._group_status(status, req.status)
        return out

    def sendrecv(self, sendbuf: Any, dest: int, recvbuf=None,
                 source: int = 0, sendtag: int = 0, recvtag: int = ANY_TAG,
                 status: Optional[Status] = None) -> np.ndarray:
        rreq = self.irecv(recvbuf, source, recvtag)
        sreq = self.isend(sendbuf, dest, sendtag)
        out = rreq.wait()
        sreq.wait()
        self._group_status(status, rreq.status)
        return out

    def sendrecv_replace(self, buf: Any, dest: int, source: int = 0,
                         sendtag: int = 0, recvtag: int = ANY_TAG,
                         status: Optional[Status] = None) -> np.ndarray:
        """≈ MPI_Sendrecv_replace: send ``buf`` to ``dest`` and receive
        into the SAME buffer from ``source``.  The wire copy is made
        before the receive can land, and the received data is written
        back into ``buf`` in place when it is a writable ndarray."""
        _reject_device(buf, "isend")
        arr = np.asarray(buf)
        staged = arr.copy()                  # sender-side staging copy
        out = self.sendrecv(staged, dest, None, source, sendtag, recvtag,
                            status)
        got = np.asarray(out)
        if got.size == 0 and arr.size != 0:
            # PROC_NULL source: the receive is a no-op, buf stays unchanged
            return buf if isinstance(buf, np.ndarray) else arr
        got = got.reshape(arr.shape).astype(arr.dtype, copy=False)
        if isinstance(buf, np.ndarray) and buf.flags.writeable:
            buf[...] = got
            return buf
        return got

    def probe(self, source: int = -1, tag: int = ANY_TAG,
              timeout: Optional[float] = None) -> Status:
        src = source if source < 0 else self.world_rank(source)
        st = self.pml.probe(src, tag, self.cid, timeout=timeout)
        if st.source >= 0:
            st.source = self.group.rank_of(st.source)
        return st

    def iprobe(self, source: int = -1, tag: int = ANY_TAG) -> Optional[Status]:
        src = source if source < 0 else self.world_rank(source)
        st = self.pml.iprobe(src, tag, self.cid)
        if st is not None and st.source >= 0:
            st.source = self.group.rank_of(st.source)
        return st

    # -- matched probe (≈ MPI_Mprobe/Improbe/Mrecv/Imrecv, mprobe.c:1) -----

    def _msg_no_proc(self):
        st = Status()
        st.source = PROC_NULL
        st.tag = ANY_TAG
        st.count = 0
        return MESSAGE_NO_PROC, st

    def mprobe(self, source: int = -1, tag: int = ANY_TAG,
               timeout: Optional[float] = None):
        """Blocking match-and-detach → (Message, Status).  The returned
        handle is consumed by exactly one mrecv/imrecv."""
        if source == PROC_NULL:
            return self._msg_no_proc()
        src = source if source < 0 else self.world_rank(source)
        msg, st = self.pml.mprobe(src, tag, self.cid, timeout=timeout)
        if st.source >= 0:
            st.source = self.group.rank_of(st.source)
        return msg, st

    def improbe(self, source: int = -1, tag: int = ANY_TAG):
        """Nonblocking match-and-detach → (Message, Status) or None."""
        if source == PROC_NULL:
            return self._msg_no_proc()
        src = source if source < 0 else self.world_rank(source)
        out = self.pml.improbe(src, tag, self.cid)
        if out is None:
            return None
        msg, st = out
        if st.source >= 0:
            st.source = self.group.rank_of(st.source)
        return msg, st

    def imrecv(self, buf=None, message=None, datatype=None,
               count=None) -> Request:
        # status.source must be the GROUP rank (as mrecv reports); the
        # detached message pins the sender, so the translation rides the
        # request into delivery
        src = None
        if message is not None and not message.no_proc \
                and message.peer >= 0:
            src = self.group.rank_of(message.peer)
        return self.pml.imrecv(buf, message, datatype, count,
                               status_source=src)

    def mrecv(self, buf=None, message=None, datatype=None, count=None,
              status: Optional[Status] = None) -> np.ndarray:
        out = self.pml.mrecv(buf, message, datatype, count, status)
        if status is not None and status.source >= 0:
            status.source = self.group.rank_of(status.source)
        return out

    # internal p2p on the reserved tag space (collectives use these)

    def _coll_isend(self, buf, dest: int, coll_tag: int) -> Request:
        return self.pml.isend(np.asarray(buf), self.world_rank(dest),
                              _INTERNAL_TAG_BASE - coll_tag, self.cid)

    def _coll_irecv(self, buf, source: int, coll_tag: int,
                    datatype=None, count=None) -> Request:
        src = source if source < 0 else self.world_rank(source)
        return self.pml.irecv(buf, src,
                              _INTERNAL_TAG_BASE - coll_tag, self.cid,
                              datatype, count)

    # -- collectives (delegate to the installed coll table) ----------------

    def barrier(self) -> None:
        self.coll.barrier(self)

    def bcast(self, buf, root: int = 0):
        return self.coll.bcast(self, buf, root)

    def reduce(self, sendbuf, op=None, root: int = 0):
        return self.coll.reduce(self, sendbuf, op or op_mod.SUM, root)

    def allreduce(self, sendbuf, op=None):
        return self.coll.allreduce(self, sendbuf, op or op_mod.SUM)

    def gather(self, sendbuf, root: int = 0):
        return self.coll.gather(self, sendbuf, root)

    def allgather(self, sendbuf):
        return self.coll.allgather(self, sendbuf)

    def scatter(self, sendbuf, root: int = 0):
        return self.coll.scatter(self, sendbuf, root)

    def alltoall(self, sendbuf):
        return self.coll.alltoall(self, sendbuf)

    def reduce_scatter(self, sendbuf, op=None):
        return self.coll.reduce_scatter(self, sendbuf, op or op_mod.SUM)

    def reduce_scatter_block(self, sendbuf, op=None):
        return self.coll.reduce_scatter_block(self, sendbuf,
                                              op or op_mod.SUM)

    def scan(self, sendbuf, op=None):
        return self.coll.scan(self, sendbuf, op or op_mod.SUM)

    def exscan(self, sendbuf, op=None):
        return self.coll.exscan(self, sendbuf, op or op_mod.SUM)

    def gatherv(self, sendbuf, root: int = 0):
        return self.coll.gatherv(self, sendbuf, root)

    def scatterv(self, sendparts, root: int = 0):
        return self.coll.scatterv(self, sendparts, root)

    def allgatherv(self, sendbuf):
        return self.coll.allgatherv(self, sendbuf)

    def alltoallv(self, sendparts):
        return self.coll.alltoallv(self, sendparts)

    def alltoallw(self, sendspecs, recvspecs) -> None:
        """≈ MPI_Alltoallw: per-peer (buf, datatype, count) triples on both
        sides (None = empty exchange); receive buffers filled in place.
        No component serves it on tensors, in the JAX package either."""
        return self.coll.alltoallw(self, sendspecs, recvspecs)

    # -- device path binding (coll/xla) ------------------------------------

    def bind_device(self, device_comm) -> "Communicator":
        """Bind a DeviceCommunicator: collectives on torch tensors then
        route through coll/xla over its mesh axes (zero host copies).
        Returns self for chaining.  ≈ installing coll/cuda's module on the
        comm — except the device path replaces the host algorithms instead
        of bounce-buffering into them.

        The device communicator must span the same ranks, with this rank
        at the same place: a one-process mesh bound to a job of N ranks
        would reduce this rank's data alone.  Raises ValueError if not."""
        if device_comm.size != self.size or device_comm.rank() != self.rank:
            raise ValueError(
                f"bind_device: {self.name} is rank {self.rank} of "
                f"{self.size} but the device communicator "
                f"{getattr(device_comm, 'name', '')!r} is rank "
                f"{device_comm.rank()} of {device_comm.size}: build the "
                f"mesh over the job's process group (tpurun --gpu, then "
                f"make_mesh())")
        self.device = device_comm
        return self

    # -- construction ------------------------------------------------------

    def _next_cid(self) -> int:
        """Deterministic collective CID: every member computes the same
        one with no traffic."""
        with self._lock:
            cid = self._cid_next
            self._cid_next += 1
            return cid

    # -- attributes, info, construction (≈ ompi/attribute, comm.c) ---------

    def test_inter(self) -> bool:
        """≈ MPI_Comm_test_inter (an intercommunicator would say True)."""
        return False

    def set_info(self, info) -> None:
        """≈ MPI_Comm_set_info: attach hints (stored; consulted by the
        layers that define comm hints)."""
        self.info = info

    def get_info(self):
        """≈ MPI_Comm_get_info."""
        from ompi_tpu_torch.mpi.info import Info

        return getattr(self, "info", None) or Info()

    def dup_with_info(self, info, name: Optional[str] = None
                      ) -> "Communicator":
        """≈ MPI_Comm_dup_with_info: dup, replacing (not inheriting) the
        info hints."""
        new = self.dup(name=name)
        new.info = info
        return new

    def set_attr(self, keyval, value: Any) -> None:
        """≈ MPI_Comm_set_attr."""
        self.attrs[keyval] = value

    def get_attr(self, keyval) -> Any:
        """≈ MPI_Comm_get_attr — None when not cached."""
        return self.attrs.get(keyval)

    def delete_attr(self, keyval) -> None:
        """≈ MPI_Comm_delete_attr — runs the delete callback."""
        if keyval in self.attrs:
            value = self.attrs.pop(keyval)
            if getattr(keyval, "delete_fn", None) is not None:
                keyval.delete_fn(self, value)

    def _copy_attrs(self, new: "Communicator") -> None:
        from ompi_tpu_torch.mpi.info import Keyval

        for kv, value in self.attrs.items():
            if isinstance(kv, Keyval):
                if kv.copy_fn is None:
                    continue        # MPI default: do NOT propagate
                keep, newval = kv.copy_fn(self, value)
                if keep:
                    new.attrs[kv] = newval
            # plain (non-Keyval) keys are internal; not propagated

    def dup(self, name: Optional[str] = None) -> "Communicator":
        """≈ MPI_Comm_dup — collective over this communicator: the copy
        takes the next deterministic cid (its own message context over
        the same PML); attributes propagate through their keyvals' copy
        callbacks, and the errhandler and the device binding carry over
        (same group ⇒ same mesh)."""
        new = Communicator(self.group, self._next_cid(), self._world_rank,
                           name or f"{self.name}.dup", pml=self.pml)
        self._copy_attrs(new)
        new.errhandler = self.errhandler
        new.device = self.device
        return new

    def idup(self, name: Optional[str] = None) -> tuple[Request,
                                                        "Communicator"]:
        """≈ MPI_Comm_idup: (request, newcomm).  CID agreement is
        deterministic (the per-parent counter), so the handle is fully
        formed and the request completes at once; callers written for
        slower allocators, which use the handle only after the request
        completes, stay correct."""
        new = self.dup(name)
        return CompletedRequest(new, kind="idup"), new

    def create(self, group: Group, name: Optional[str] = None
               ) -> Optional["Communicator"]:
        """≈ MPI_Comm_create — collective over this communicator (every
        rank burns the same cid); returns None on non-members."""
        cid = self._next_cid()
        if group.rank_of(self._world_rank) == UNDEFINED:
            return None
        return Communicator(group, cid, self._world_rank,
                            name or f"{self.name}.sub", pml=self.pml)

    def create_group(self, group: Group, tag: int = 0,
                     name: Optional[str] = None
                     ) -> Optional["Communicator"]:
        """≈ MPI_Comm_create_group: collective ONLY over the members of
        ``group``; non-members do not take part.  The cid cannot come from
        the parent's shared counter (non-members would fall behind), so
        every member derives it from (parent cid, member world ranks, tag,
        call sequence): a crc32 in the NEGATIVE cid namespace, which the
        counter-derived cids never reach, equal to the JAX package's for
        the same call.  The per-key call sequence gives repeated identical
        calls distinct contexts."""
        if group.rank_of(self._world_rank) == UNDEFINED:
            return None
        import zlib

        key = (self.cid, group.ranks, int(tag))
        with self._lock:   # THREAD_MULTIPLE: concurrent same-key calls
            seq = self._cg_seq.get(key, 0) + 1
            self._cg_seq[key] = seq
        desc = f"{self.cid}:{','.join(map(str, group.ranks))}:{tag}:{seq}"
        cid = -(1 + (zlib.crc32(desc.encode()) & 0x7FFFFFFF))
        return Communicator(group, cid, self._world_rank,
                            name or f"{self.name}.grp", pml=self.pml)

    def _my_host_key(self) -> int:
        """Shared-memory-domain identity (``core.sysinfo.host_identity``);
        tests may override it per communicator through
        ``comm._io_host_override`` (threads share os.environ)."""
        import zlib

        from ompi_tpu_torch.core.sysinfo import host_identity

        name = getattr(self, "_io_host_override", None) or host_identity()
        return zlib.crc32(str(name).encode()) & 0x7FFFFFFF

    def split_type(self, split_type: int = COMM_TYPE_SHARED, key: int = 0,
                   name: Optional[str] = None) -> Optional["Communicator"]:
        """≈ MPI_Comm_split_type(COMM_TYPE_SHARED): one communicator per
        shared-memory domain (host).  UNDEFINED returns None, like
        split."""
        if split_type == UNDEFINED:
            # still collective: peers' allgather inside split needs us
            return self.split(UNDEFINED, key, name)
        if split_type != COMM_TYPE_SHARED:
            raise MPIException(
                f"unknown split_type {split_type} (COMM_TYPE_SHARED)",
                error_class=3)
        return self.split(self._my_host_key(), key,
                          name or f"{self.name}.shared")

    def split(self, color: int, key: int = 0,
              name: Optional[str] = None) -> Optional["Communicator"]:
        """≈ MPI_Comm_split — collective over this communicator: an
        allgather of (color, key, world rank) over the parent's host
        route (as the reference's comm_split does), then a deterministic
        local partition."""
        mine = np.array([color, key, self._world_rank], dtype=np.int64)
        gathered = self.coll.allgather(self, mine)  # (size, 3)
        rows = [tuple(int(x) for x in row)
                for row in np.asarray(gathered).reshape(self.size, 3)]
        # distinct colors get distinct cids; every rank (members and
        # UNDEFINED alike) burns the same count to keep counters aligned
        colors = sorted({c for c, _, _ in rows if c != UNDEFINED})
        cid_base = self._next_cid()
        for _ in range(max(0, len(colors) - 1)):
            self._next_cid()
        if color == UNDEFINED:
            return None
        members = sorted((k, wr) for c, k, wr in rows if c == color)
        return Communicator(Group([wr for _, wr in members]),
                            cid_base + colors.index(color), self._world_rank,
                            name or f"{self.name}.split({color})",
                            pml=self.pml)

    def free(self) -> None:
        """≈ MPI_Comm_free: run the attributes' delete callbacks, then drop
        the device binding, the table and coll/shm's arena; the device
        groups belong to the mesh and the PML to the runtime, not to the
        communicator."""
        for kv in list(self.attrs):
            self.delete_attr(kv)
        self.device = None
        self.coll = None
        # flag + cache-clear under the comm lock, ATOMIC against coll/shm's
        # build completion: a state build in flight on another thread
        # decides cache-vs-close under the same lock, so whichever side
        # runs second sees the other's effect and the arena is closed
        # exactly once
        with self._lock:
            self._coll_freed = True
            st = self._coll_shm_state
            self._coll_shm_state = None
        if st is not None and hasattr(st, "close"):
            st.close()

    def __repr__(self) -> str:
        return (f"Communicator({self.name}, rank={self.rank}/{self.size}, "
                f"cid={self.cid})")
