"""Communicators: group + context id + per-communicator collective table
(the port's trimmed copy of the JAX package's ``mpi/comm.py``).

≈ ompi/communicator (communicator.h:134-189: cid, local/remote groups, the
c_coll function table).  The collective table (``self.coll``) is
installed by ``ompi_tpu_torch.mpi.coll`` at creation by priority query,
as coll_base_comm_select.c:107.

What the port keeps is the device route: a communicator bound to a
``DeviceCommunicator`` (``comm.bind_device(device_world(mesh))``) runs its
collectives on torch tensors there, through coll/xla, with no host copy.
A world communicator is
``Communicator(Group(range(world_size)), cid=0, my_world_rank=rank)``.

The host plane under the JAX package's communicator — the PML and its
transports, host collectives, nonblocking, persistent and neighbourhood
collectives, topologies, fault tolerance, attributes and ``split`` — is
not ported yet (ROADMAP.md Queue 1 item 6).  Point-to-point calls refuse
a tensor as the JAX package's PML refuses a device buffer, and raise
``NotImplementedError`` on a host buffer.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

from ompi_tpu_torch.core.buffer import (BufferKind, BufferLocationError,
                                        classify)
from ompi_tpu_torch.mpi import op as op_mod
from ompi_tpu_torch.mpi.constants import ANY_TAG
from ompi_tpu_torch.mpi.group import Group

__all__ = ["Communicator"]

_NO_HOST_PML = (
    "{what}: host point-to-point needs the host PML, which the port has "
    "not ported yet (ROADMAP.md Queue 1 item 6); on tensors use "
    "DeviceCommunicator.shift/permute/sendrecv")


def _reject_device(buf: Any, what: str) -> None:
    """Device buffers must NEVER silently host-stage through the PML (the
    reference's coll/cuda bounce-buffer anti-pattern this design forbids);
    the JAX package's ``pml._reject_device``."""
    kind = classify(buf)
    if kind is not BufferKind.HOST:
        raise BufferLocationError(
            f"pml.{what}: got a {kind.value} buffer; the host PML would "
            f"stage it through host memory. Use the device path instead "
            f"(comm.bind_device(device_world(mesh)) routes collectives "
            f"over NCCL/gloo; for p2p use DeviceCommunicator.shift/"
            f"permute/sendrecv), or .cpu().numpy() the tensor explicitly "
            f"if host staging is intended.")


class Communicator:
    """A group of ranks sharing an isolated message context."""

    def __init__(self, group: Group, cid: int, my_world_rank: int,
                 name: str = "comm") -> None:
        self.group = group
        self.cid = cid
        self._world_rank = my_world_rank
        self.name = name
        self.rank = group.rank_of(my_world_rank)
        self._cid_next = cid * 1024 + 1
        self._lock = threading.Lock()
        self.coll = None  # installed by ompi_tpu_torch.mpi.coll.install()
        self.device = None  # bound DeviceCommunicator (coll/xla path)
        from ompi_tpu_torch.mpi import coll

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

    # -- point-to-point (the host PML is not ported) -------------------------

    def _p2p(self, what: str, buf, recvbuf=None) -> None:
        if recvbuf is not None:
            _reject_device(recvbuf, "irecv")
        if buf is not None:
            _reject_device(buf, what)
        raise NotImplementedError(_NO_HOST_PML.format(what=what))

    def isend(self, buf: Any, dest: int, tag: int = 0, datatype=None,
              count: Optional[int] = None):
        self._p2p("isend", buf)

    def send(self, buf: Any, dest: int, tag: int = 0, datatype=None,
             count: Optional[int] = None) -> None:
        self._p2p("isend", buf)

    def irecv(self, buf=None, source: int = 0, tag: int = ANY_TAG,
              datatype=None, count: Optional[int] = None):
        self._p2p("irecv", buf)

    def recv(self, buf=None, source: int = 0, tag: int = ANY_TAG,
             datatype=None, count: Optional[int] = None, status=None):
        self._p2p("irecv", buf)

    def sendrecv(self, sendbuf: Any, dest: int, recvbuf=None,
                 source: int = 0, sendtag: int = 0, recvtag: int = ANY_TAG,
                 status=None):
        self._p2p("isend", sendbuf, recvbuf)

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
        of bounce-buffering into them."""
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

    def dup(self, name: Optional[str] = None) -> "Communicator":
        """≈ MPI_Comm_dup — collective over this communicator; the device
        binding carries over (same group ⇒ same mesh)."""
        new = Communicator(self.group, self._next_cid(), self._world_rank,
                           name or f"{self.name}.dup")
        new.device = self.device
        return new

    def free(self) -> None:
        """≈ MPI_Comm_free: drop the device binding and the table; the
        device groups belong to the mesh, not to the communicator."""
        self.device = None
        self.coll = None

    def __repr__(self) -> str:
        return (f"Communicator({self.name}, rank={self.rank}/{self.size}, "
                f"cid={self.cid})")
