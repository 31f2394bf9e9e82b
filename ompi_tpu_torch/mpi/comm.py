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

The host route also carries the nonblocking collectives (``i*``, the
libnbc-style schedules of ``mpi/coll/nbc.py``, progressed by
``test()``/``wait()``), the persistent collectives (``*_init``, plans
bound once by ``mpi/coll/persistent.py``), persistent and partitioned
point-to-point (``send_init``/``recv_init``, ``psend_init``/
``precv_init``) and the process topologies (``cart_create``,
``graph_create``, ``dist_graph_create*``, their queries and the
neighbor collectives, ``mpi/topo.py``; the topology rides ``comm.topo``).
Every one of them refuses a torch tensor with the PML's message.

Fault tolerance is the JAX package's ULFM surface (``mpi/ft.py``):
``revoke``, ``is_revoked``, ``agree``, ``shrink``, ``get_failed`` and
``ack_failed``.  A device-route collective has no revocation gate, as in
the JAX package's coll/xla: a device-plane job recovers by a restart
from its snapshots.

Left out: the mpi4py facade (item 6.11).
"""

from __future__ import annotations

import threading
from typing import Any, Optional

import numpy as np

from ompi_tpu_torch.mpi import datatype as dt_mod
from ompi_tpu_torch.mpi import op as op_mod
from ompi_tpu_torch.mpi import topo as topo_mod
from ompi_tpu_torch.mpi.coll import nbc, persistent
from ompi_tpu_torch.mpi.constants import (ANY_SOURCE, ANY_TAG,
                                          COMM_TYPE_SHARED, PROC_NULL,
                                          UNDEFINED, MPIException)
from ompi_tpu_torch.mpi.datatype import Datatype
from ompi_tpu_torch.mpi.group import Group
# the PML's refusal, checked here as well so that a communicator with no
# PML refuses a tensor the same way
from ompi_tpu_torch.mpi.pml import (MESSAGE_NO_PROC, PartitionedRecvRequest,
                                    PartitionedSendRequest, _reject_device)
from ompi_tpu_torch.mpi.request import (CompletedRequest, PersistentRequest,
                                        Request, Status)

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
        # bound persistent-collective plans (weakrefs): free() releases
        # their pinned slots and poisons later Starts
        self._persistent_colls: list = []
        self._pcoll_seq = 0   # persistent-collective tag sequence
        self._nbc_seq = 0     # nonblocking-collective tag sequence
        self.topo = None      # Cart/Graph/DistGraphTopology (mpi.topo)
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

    # persistent requests (≈ MPI_Send_init/Recv_init, pml.h:502-505)

    def send_init(self, buf, dest: int, tag: int = 0, datatype=None,
                  count=None, mode: str = "standard") -> PersistentRequest:
        """≈ MPI_Send_init: inactive persistent send; arm with .start().
        The buffer is re-read at each start."""
        if not self._send_args_ok(dest, tag):
            return PersistentRequest(CompletedRequest,
                                     kind="persistent-send")
        _reject_device(buf, "send_init")
        return PersistentRequest(
            lambda: self.pml.isend(buf, self.world_rank(dest), tag,
                                   self.cid, datatype, count, mode=mode),
            kind="persistent-send")

    def recv_init(self, buf=None, source: int = 0, tag: int = ANY_TAG,
                  datatype=None, count=None) -> PersistentRequest:
        """≈ MPI_Recv_init: inactive persistent recv; arm with .start()."""
        src = self._recv_src(source)
        if src is None:
            return PersistentRequest(
                lambda: CompletedRequest(
                    np.empty(0, dtype=(datatype or dt_mod.BYTE).base_np)),
                kind="persistent-recv")
        if buf is not None:
            _reject_device(buf, "recv_init")
        return PersistentRequest(
            lambda: self.pml.irecv(buf, src, tag, self.cid, datatype,
                                   count),
            kind="persistent-recv")

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

    # -- nonblocking collectives (libnbc-style schedules, mpi/coll/nbc) ----

    def ibarrier(self) -> Request:
        return nbc.ibarrier(self)

    def ibcast(self, buf, root: int = 0) -> Request:
        return nbc.ibcast(self, buf, root)

    def ireduce(self, sendbuf, op=None, root: int = 0) -> Request:
        return nbc.ireduce(self, sendbuf, op or op_mod.SUM, root)

    def iallreduce(self, sendbuf, op=None) -> Request:
        return nbc.iallreduce(self, sendbuf, op or op_mod.SUM)

    def igather(self, sendbuf, root: int = 0) -> Request:
        return nbc.igather(self, sendbuf, root)

    def iscatter(self, sendbuf, root: int = 0) -> Request:
        return nbc.iscatter(self, sendbuf, root)

    def iallgather(self, sendbuf) -> Request:
        return nbc.iallgather(self, sendbuf)

    def ialltoall(self, sendbuf) -> Request:
        return nbc.ialltoall(self, sendbuf)

    def ireduce_scatter(self, sendbuf, op=None) -> Request:
        return nbc.ireduce_scatter(self, sendbuf, op or op_mod.SUM)

    def iscan(self, sendbuf, op=None) -> Request:
        return nbc.iscan(self, sendbuf, op or op_mod.SUM)

    def iexscan(self, sendbuf, op=None) -> Request:
        return nbc.iexscan(self, sendbuf, op or op_mod.SUM)

    def iallgatherv(self, sendbuf) -> Request:
        return nbc.iallgatherv(self, sendbuf)

    def ialltoallv(self, sendparts) -> Request:
        return nbc.ialltoallv(self, sendparts)

    def igatherv(self, sendbuf, root: int = 0) -> Request:
        return nbc.igatherv(self, sendbuf, root)

    def iscatterv(self, sendparts, root: int = 0) -> Request:
        return nbc.iscatterv(self, sendparts, root)

    def ireduce_scatter_block(self, sendbuf, op=None) -> Request:
        return nbc.ireduce_scatter_block(self, sendbuf, op or op_mod.SUM)

    def ialltoallw(self, sendspecs, recvspecs) -> Request:
        return nbc.ialltoallw(self, sendspecs, recvspecs)

    # -- persistent collectives (≈ MPI_Barrier_init & friends, MPI-4 §6.12:
    #    bind once via coll/persistent, Start forever) ----------------------

    def barrier_init(self):
        """≈ MPI_Barrier_init: inactive persistent barrier; arm with
        .start() / start_all."""
        return persistent.barrier_init(self)

    def bcast_init(self, buf=None, root: int = 0):
        """≈ MPI_Bcast_init: the root's ``buf`` is re-read at each
        start; a non-root ndarray ``buf`` becomes the landing buffer
        filled at each wait."""
        return persistent.bcast_init(self, buf, root)

    def reduce_init(self, sendbuf, op=None, root: int = 0):
        """≈ MPI_Reduce_init."""
        return persistent.reduce_init(self, sendbuf, op or op_mod.SUM,
                                      root)

    def allreduce_init(self, sendbuf, op=None):
        """≈ MPI_Allreduce_init."""
        return persistent.allreduce_init(self, sendbuf, op or op_mod.SUM)

    def allgather_init(self, sendbuf):
        """≈ MPI_Allgather_init."""
        return persistent.allgather_init(self, sendbuf)

    def alltoall_init(self, sendbuf):
        """≈ MPI_Alltoall_init: ``sendbuf`` is re-read at each start."""
        return persistent.alltoall_init(self, sendbuf)

    def alltoallv_init(self, sendparts):
        """≈ MPI_Alltoallv_init: one (possibly None) part per rank."""
        return persistent.alltoallv_init(self, sendparts)

    def reduce_scatter_init(self, sendbuf, op=None):
        """≈ MPI_Reduce_scatter_init."""
        return persistent.reduce_scatter_init(self, sendbuf,
                                              op or op_mod.SUM)

    def neighbor_alltoall_init(self, sendparts):
        """≈ MPI_Neighbor_alltoall_init (needs an attached topology)."""
        return persistent.neighbor_alltoall_init(self, sendparts)

    def neighbor_alltoallv_init(self, sendparts):
        """≈ MPI_Neighbor_alltoallv_init."""
        return persistent.neighbor_alltoallv_init(self, sendparts)

    # -- partitioned point-to-point (≈ MPI_Psend_init/Precv_init, MPI-4 §4:
    #    Pready/Parrived ride the PML) -------------------------------------

    def psend_init(self, buf, dest: int, tag: int = 0,
                   partitions: int = 1):
        """≈ MPI_Psend_init: partitioned persistent send — start()
        activates, Pready(i) publishes partition i (a zero-copy view
        of the bound buffer), wait() completes once every partition
        was readied and sent."""
        if not self._send_args_ok(dest, tag):
            return PartitionedSendRequest(self.pml, buf, None, tag,
                                          self.cid, partitions)
        return self.pml.psend_init(buf, self.world_rank(dest), tag,
                                   self.cid, partitions)

    def precv_init(self, buf, source: int = 0, tag: int = 0,
                   partitions: int = 1):
        """≈ MPI_Precv_init: partitioned persistent recv into ``buf``;
        Parrived(i) polls partition i, wait() returns the filled
        buffer.  ANY_SOURCE is refused (matching is per channel)."""
        if source == ANY_SOURCE:
            self._raise(MPIException(
                "precv_init: ANY_SOURCE is not supported for "
                "partitioned receives (matching is per-channel)",
                error_class=6))
            src = None
        else:
            src = self._recv_src(source)
        if src is None:
            return PartitionedRecvRequest(self.pml, buf, None, tag,
                                          self.cid, partitions)
        return self.pml.precv_init(buf, src, tag, self.cid, partitions)

    # -- topologies (≈ ompi_communicator_t.c_topo; see mpi/topo.py) --------

    def cart_create(self, dims, periods=None, reorder: bool = False,
                    mesh_shape=None) -> Optional["Communicator"]:
        return topo_mod.cart_create(self, dims, periods, reorder,
                                    mesh_shape)

    def cart_sub(self, remain_dims) -> Optional["Communicator"]:
        return topo_mod.cart_sub(self, remain_dims)

    def graph_create(self, index, edges,
                     reorder: bool = False) -> Optional["Communicator"]:
        return topo_mod.graph_create(self, index, edges, reorder)

    def dist_graph_create_adjacent(self, sources, destinations,
                                   source_weights=None, dest_weights=None
                                   ) -> "Communicator":
        return topo_mod.dist_graph_create_adjacent(
            self, sources, destinations, source_weights, dest_weights)

    def dist_graph_create(self, sources, degrees, destinations,
                          weights=None) -> "Communicator":
        return topo_mod.dist_graph_create(self, sources, degrees,
                                          destinations, weights)

    def topo_test(self) -> Optional[str]:
        """≈ MPI_Topo_test: "cart" | "graph" | "dist_graph" | None."""
        return topo_mod.topo_test(self)

    def cart_get(self):
        """≈ MPI_Cart_get → (dims, periods, my coords)."""
        return topo_mod.cart_get(self)

    def cartdim_get(self) -> int:
        """≈ MPI_Cartdim_get."""
        return topo_mod.cartdim_get(self)

    def cart_rank(self, coords) -> int:
        """≈ MPI_Cart_rank."""
        return topo_mod._topo_of(self, "cart").rank(coords)

    def cart_coords(self, rank: int) -> list:
        """≈ MPI_Cart_coords."""
        return topo_mod._topo_of(self, "cart").coords(rank)

    def cart_shift(self, direction: int, disp: int = 1) -> tuple:
        """≈ MPI_Cart_shift → (source, dest) of this rank."""
        return topo_mod._topo_of(self, "cart").shift(self.rank, direction,
                                                     disp)

    def cart_map(self, dims, periods=None, mesh_shape=None) -> int:
        """≈ MPI_Cart_map."""
        return topo_mod.cart_map(self, dims, periods, mesh_shape)

    def graph_get(self):
        """≈ MPI_Graph_get → (index, edges)."""
        return topo_mod.graph_get(self)

    def graphdims_get(self):
        """≈ MPI_Graphdims_get → (nnodes, nedges)."""
        return topo_mod.graphdims_get(self)

    def graph_neighbors(self, rank: int) -> list:
        """≈ MPI_Graph_neighbors."""
        return topo_mod.graph_neighbors(self, rank)

    def graph_neighbors_count(self, rank: int) -> int:
        """≈ MPI_Graph_neighbors_count."""
        return topo_mod.graph_neighbors_count(self, rank)

    def graph_map(self, index, edges) -> int:
        """≈ MPI_Graph_map."""
        return topo_mod.graph_map(self, index, edges)

    def dist_graph_neighbors(self):
        """≈ MPI_Dist_graph_neighbors → (sources, destinations)."""
        return topo_mod.dist_graph_neighbors(self)

    def dist_graph_neighbors_count(self):
        """≈ MPI_Dist_graph_neighbors_count → (indegree, outdegree,
        weighted)."""
        return topo_mod.dist_graph_neighbors_count(self)

    def neighbor_allgather(self, sendbuf) -> list:
        return topo_mod.neighbor_allgather(self, sendbuf)

    def neighbor_allgatherv(self, sendbuf) -> list:
        return topo_mod.neighbor_allgatherv(self, sendbuf)

    def neighbor_alltoall(self, sendparts) -> list:
        return topo_mod.neighbor_alltoall(self, sendparts)

    def neighbor_alltoallv(self, sendparts) -> list:
        return topo_mod.neighbor_alltoallv(self, sendparts)

    def neighbor_alltoallw(self, sendspecs, recvspecs) -> None:
        return topo_mod.neighbor_alltoallw(self, sendspecs, recvspecs)

    def ineighbor_allgather(self, sendbuf) -> Request:
        return topo_mod.ineighbor_allgather(self, sendbuf)

    def ineighbor_allgatherv(self, sendbuf) -> Request:
        return topo_mod.ineighbor_allgatherv(self, sendbuf)

    def ineighbor_alltoall(self, sendparts) -> Request:
        return topo_mod.ineighbor_alltoall(self, sendparts)

    def ineighbor_alltoallv(self, sendparts) -> Request:
        return topo_mod.ineighbor_alltoallv(self, sendparts)

    # -- device path binding (coll/xla) ------------------------------------

    # -- fault tolerance (ULFM: ≈ MPIX_Comm_revoke/shrink/agree,
    #    mpi/ft.py — the extension-style API shipped ahead of
    #    standardization, MPI-Advance precedent) ---------------------------

    def revoke(self) -> None:
        """≈ MPIX_Comm_revoke: poison this communicator on every member —
        in-flight and future operations on it raise MPI_ERR_REVOKED.
        Not collective (any member may revoke after spotting a failure);
        propagates by flooding.  ``agree``/``shrink`` still work."""
        from ompi_tpu_torch.mpi import ft

        ft.comm_revoke(self)

    def is_revoked(self) -> bool:
        """True once this communicator was revoked (locally known)."""
        from ompi_tpu_torch.mpi import ft

        return ft.comm_is_revoked(self)

    def agree(self, flag: bool = True) -> bool:
        """≈ MPIX_Comm_agree: fault-tolerant AND of ``flag`` over the
        surviving members — every rank that returns gets the same value,
        retransmitted under message loss."""
        from ompi_tpu_torch.mpi import ft

        return ft.comm_agree(self, flag)

    def shrink(self, name: Optional[str] = None) -> "Communicator":
        """≈ MPIX_Comm_shrink: agree on the failed set, return a new
        communicator over the survivors (same deterministic-cid
        construction as create_group; the dead need not participate)."""
        from ompi_tpu_torch.mpi import ft

        return ft.comm_shrink(self, name)

    def get_failed(self) -> Group:
        """≈ MPIX_Comm_get_failed: group of members this process knows
        to be dead (local knowledge, monotonic — no agreement)."""
        from ompi_tpu_torch.mpi import ft

        return ft.comm_get_failed(self)

    def ack_failed(self, num_to_ack: Optional[int] = None) -> int:
        """≈ MPIX_Comm_ack_failed → how many failures are acknowledged."""
        from ompi_tpu_torch.mpi import ft

        return ft.comm_ack_failed(self, num_to_ack)

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

    # -- counter agreement (coll/shm epoch-sync prologue) ------------------

    def _counter_snapshot(self) -> tuple[int, int]:
        """(cid allocator position, persistent-coll tag sequence) — the
        per-parent counters whose derived values must MATCH across
        members for collectives to pair.  A selfheal-revived life
        restarts both at their base; the coll/shm build prologue
        MAX-agrees them over the members and merges back
        (:meth:`_counter_merge`), so the rebuilt hierarchy's split cids
        and a re-bound plan's tags land identically on survivors and
        the revived rank."""
        with self._lock:
            return self._cid_next, getattr(self, "_pcoll_seq", 0)

    def _counter_merge(self, cid_next: int, pcoll_seq: int) -> None:
        """Adopt the agreed (MAX) counter positions — monotone, so a
        stale merge can never rewind a counter."""
        with self._lock:
            self._cid_next = max(self._cid_next, int(cid_next))
            self._pcoll_seq = max(getattr(self, "_pcoll_seq", 0),
                                  int(pcoll_seq))

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
        """≈ MPI_Comm_free: run the attributes' delete callbacks, free
        every bound persistent-collective plan (their pinned slots
        detach; a later Start on them raises), then drop the device
        binding, the table and coll/shm's arena; the device groups belong
        to the mesh and the PML to the runtime, not to the
        communicator."""
        for kv in list(self.attrs):
            self.delete_attr(kv)
        for ref in self._persistent_colls:
            req = ref()
            if req is not None:
                req.free()
        self._persistent_colls = []
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
