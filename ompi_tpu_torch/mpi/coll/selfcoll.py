"""coll/self — collectives on size-1 communicators (≈ ompi/mca/coll/self;
the port's copy of the JAX package's ``mpi/coll/selfcoll.py``).

Every collective on a host buffer degenerates to a local identity/copy
(``alltoallw`` packs the send spec and unpacks it into the receive
spec in place, through coll/base's convertor helpers); the component is
eligible only when size == 1.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ompi_tpu_torch.core.mca import Component
from ompi_tpu_torch.mpi.coll import coll_framework
from ompi_tpu_torch.mpi.op import Op


@coll_framework.component
class SelfColl(Component):
    NAME = "self"
    PRIORITY = 90

    def query(self, comm=None, **ctx) -> Optional[int]:
        if comm is not None and comm.size == 1:
            return self.PRIORITY
        return None

    def coll_barrier(self, comm) -> None:
        return None

    def coll_bcast(self, comm, buf, root: int):
        return np.asarray(buf)

    def coll_reduce(self, comm, sendbuf, op: Op, root: int):
        return np.asarray(sendbuf)

    def coll_allreduce(self, comm, sendbuf, op: Op):
        return np.asarray(sendbuf)

    def coll_gather(self, comm, sendbuf, root: int):
        return np.asarray(sendbuf)[None]

    def coll_allgather(self, comm, sendbuf):
        return np.asarray(sendbuf)[None]

    def coll_scatter(self, comm, sendbuf, root: int):
        return np.asarray(sendbuf)

    def coll_alltoall(self, comm, sendbuf):
        return np.asarray(sendbuf)

    def coll_reduce_scatter(self, comm, sendbuf, op: Op):
        return np.asarray(sendbuf).reshape(-1)

    def coll_reduce_scatter_block(self, comm, sendbuf, op: Op):
        return np.asarray(sendbuf)

    def coll_scan(self, comm, sendbuf, op: Op):
        return np.asarray(sendbuf)

    def coll_exscan(self, comm, sendbuf, op: Op):
        return None  # rank 0's exscan result is undefined per MPI

    def coll_gatherv(self, comm, sendbuf, root: int):
        return [np.asarray(sendbuf)]

    def coll_scatterv(self, comm, sendparts, root: int):
        return np.asarray(sendparts[0])

    def coll_allgatherv(self, comm, sendbuf):
        return [np.asarray(sendbuf)]

    def coll_alltoallv(self, comm, sendparts):
        # None is MPI's zero-count entry, here as everywhere else
        if sendparts[0] is None:
            return [np.empty(0, np.uint8)]
        return [np.asarray(sendparts[0])]

    def coll_alltoallw(self, comm, sendspecs, recvspecs):
        from ompi_tpu_torch.mpi.coll.base import pack_spec, unpack_spec

        if sendspecs[0] is not None:
            unpack_spec(recvspecs[0], pack_spec(sendspecs[0]))
        return None
