"""Dynamic process management: connect/accept, spawn, intercommunicators
(the port's copy of the JAX package's ``mpi/dpm.py``, whole).

≈ ompi/dpm/dpm.c (MPI_Comm_connect/accept/spawn over ORTE+PMIx) and the
intercommunicator core (ompi/communicator).  Redesign for this stack:

- A *port* (MPI_Open_port) is a plain TCP rendezvous socket on the
  accepting leader; the connect/accept handshake exchanges each job's
  size and per-rank BTL addresses through it.
- Two independently-launched jobs both number ranks from 0, so each side
  installs the other's procs under *translated ids* (offset by its own
  world size) and registers a BTL alias so its frames arrive under the id
  the other side knows it by (btl.py set_alias).
- The resulting :class:`Intercomm` does p2p against the remote group,
  rooted bcast/barrier, and ``merge()`` into a plain intracommunicator
  (MPI_Intercomm_merge) — the merged communicator works because both
  sides agree on member *order* (low group first) while each process
  addresses members through its own namespace ids.
- ``spawn()`` launches a child job via the tpurun launcher with the
  parent's port in the environment; children find it with
  :func:`get_parent` (≈ MPI_Comm_get_parent).

CID agreement: the handshake carries both sides' DPM sequence numbers;
the intercomm cid is drawn from a reserved high window (1<<20) offset by
their max, so it can't collide with either side's intra-comm cids.

The protocol is the JAX package's: the environment names
(``OMPI_TPU_PARENT_PORT``, ``OMPI_TPU_NAME_DIR``,
``OMPI_TPU_MPMD_TABLE``), the cid windows, the intercomm collectives'
internal tags 700–705 and the 192-byte business card.  The port differs
in three places:

- ``spawn`` and ``spawn_multiple`` launch the port's ``tpurun`` (and its
  ``mpi/_mpmd_dispatch`` shim), and the child job gets the parent's
  environment WITHOUT the parent rank's own identity (its PMIx URI, rank,
  job, card and process-group rendezvous), which the child launcher then
  sets for each child rank.
- Elastic grow through a standing DVM (``OMPI_TPU_DVM_URI``) raises: the
  port's launcher has no DVM yet (ROADMAP.md item 6.15b).
- Send data may be a torch tensor: ``core.buffer.tensor_to_host`` views a
  CPU tensor and brings a CUDA tensor to the host in ONE device-to-host
  copy (bf16/float8 cross as their bits), as ``np.asarray`` brings a
  ``jax.Array`` to the host in the JAX package.  Received data is numpy.
  The module imports torch only for a tensor the caller passed.
"""

from __future__ import annotations

import os
import socket
import struct
import subprocess
import sys
import threading
from typing import Any, Optional, Sequence

import numpy as np

from ompi_tpu_torch.core import dss
from ompi_tpu_torch.core.buffer import host_array as _host
from ompi_tpu_torch.mpi.comm import (Communicator,
                                     _INTERNAL_TAG_BASE as _ITAG_BASE)
from ompi_tpu_torch.mpi.constants import (ANY_TAG, ERR_NAME, ERR_PORT,
                                          ERR_SERVICE, PROC_NULL,
                                          MPIException)
from ompi_tpu_torch.mpi.group import Group
from ompi_tpu_torch.mpi import op as op_mod
from ompi_tpu_torch.mpi.request import Request, Status

__all__ = ["Intercomm", "open_port", "close_port", "accept", "connect",
           "spawn", "spawn_multiple", "get_parent", "intercomm_create",
           "join", "ENV_PARENT_PORT",
           "publish_name", "unpublish_name", "lookup_name"]

ENV_PARENT_PORT = "OMPI_TPU_PARENT_PORT"
ENV_NAME_DIR = "OMPI_TPU_NAME_DIR"
ENV_MPMD_TABLE = "OMPI_TPU_MPMD_TABLE"
ENV_DVM_URI = "OMPI_TPU_DVM_URI"

#: a launched rank's own identity, which a spawned job must not inherit
#: from the parent rank that spawns it (its launcher sets each child's)
_RANK_ENV = ("OMPI_TPU_HNP_URI", "OMPI_TPU_RANK", "OMPI_TPU_SIZE",
             "OMPI_TPU_JOBID", "OMPI_TPU_LOCAL_RANK", "OMPI_TPU_CHIP",
             "OMPI_TPU_COORD", "OMPI_TPU_NHOSTS", "OMPI_TPU_RESTART")

_DPM_CID_BASE = 1 << 20
# combined tcp+shm business cards carry a filesystem path; 192B covers the
# longest inbox path tempfile generates (the reference's modex equivalently
# grows its byte-object values)
_CARD_BYTES = 192
_dpm_seq_lock = threading.Lock()
_dpm_seq = 0


def _next_dpm_seq() -> int:
    global _dpm_seq
    with _dpm_seq_lock:
        _dpm_seq += 1
        return _dpm_seq


# ---------------------------------------------------------------------------
# ports (≈ MPI_Open_port / MPI_Close_port)
# ---------------------------------------------------------------------------

class _Port:
    """A listening rendezvous socket on the accepting leader."""

    def __init__(self) -> None:
        self.sock = socket.create_server(("127.0.0.1", 0), backlog=8)
        host, port = self.sock.getsockname()
        self.name = f"{host}:{port}"

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


_ports: dict[str, _Port] = {}


def open_port() -> str:
    """≈ MPI_Open_port — returns the port name to hand to connectors."""
    p = _Port()
    _ports[p.name] = p
    return p.name


def close_port(name: str) -> None:
    p = _ports.pop(name, None)
    if p is not None:
        p.close()


# ---------------------------------------------------------------------------
# name service (≈ MPI_Publish_name / MPI_Lookup_name / MPI_Unpublish_name,
# ompi/mpi/c/publish_name.c → pmix publish; the ompi-server/orte-data-server
# role).  Realized as an atomic file registry so independently-launched jobs
# on a host (or on a shared filesystem) can rendezvous without a standing
# server — set OMPI_TPU_NAME_DIR to a shared path for cross-host lookup.
# ---------------------------------------------------------------------------

def _name_dir() -> str:
    import tempfile

    d = os.environ.get(ENV_NAME_DIR)
    if not d:
        d = os.path.join(tempfile.gettempdir(),
                         f"ompi_tpu_names-{os.getuid()}")
    os.makedirs(d, mode=0o700, exist_ok=True)
    return d


def _name_path(service_name: str) -> str:
    # service names are user strings; encode to a safe filename
    import base64

    enc = base64.urlsafe_b64encode(service_name.encode()).decode()
    return os.path.join(_name_dir(), enc)


def publish_name(service_name: str, port_name: str) -> None:
    """≈ MPI_Publish_name: bind ``service_name`` → ``port_name``.  Raises
    ERR_SERVICE if already published.  Publication is atomic (write-then-
    link): a concurrent lookup_name either sees the complete port or
    nothing — never a half-written file."""
    import tempfile

    path = _name_path(service_name)
    fd, tmp = tempfile.mkstemp(dir=_name_dir(), prefix=".pub-")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(port_name)
        try:
            os.link(tmp, path)  # atomic + fails if already published
        except FileExistsError:
            raise MPIException(
                f"publish_name: {service_name!r} is already published",
                error_class=ERR_SERVICE)
    finally:
        os.unlink(tmp)


def lookup_name(service_name: str) -> str:
    """≈ MPI_Lookup_name → the published port name (ERR_NAME if absent)."""
    try:
        with open(_name_path(service_name)) as f:
            return f.read()
    except FileNotFoundError:
        raise MPIException(
            f"lookup_name: {service_name!r} is not published",
            error_class=ERR_NAME)


def unpublish_name(service_name: str) -> None:
    """≈ MPI_Unpublish_name (ERR_SERVICE if not currently published)."""
    try:
        os.unlink(_name_path(service_name))
    except FileNotFoundError:
        raise MPIException(
            f"unpublish_name: {service_name!r} is not published",
            error_class=ERR_SERVICE)


def _send_blob(sock: socket.socket, obj: Any) -> None:
    blob = dss.pack(obj)
    sock.sendall(struct.pack("<I", len(blob)) + blob)


def _recv_blob(sock: socket.socket) -> Any:
    raw = b""
    while len(raw) < 4:
        chunk = sock.recv(4 - len(raw))
        if not chunk:
            raise MPIException("dpm handshake: connection closed")
        raw += chunk
    (n,) = struct.unpack("<I", raw)
    blob = b""
    while len(blob) < n:
        chunk = sock.recv(n - len(blob))
        if not chunk:
            raise MPIException("dpm handshake: connection closed")
        blob += chunk
    return dss.unpack(blob, n=1)[0]


# ---------------------------------------------------------------------------
# intercommunicator
# ---------------------------------------------------------------------------

class Intercomm:
    """Two disjoint groups sharing a message context (≈ MPI
    intercommunicator): ranks in p2p calls refer to the REMOTE group."""

    def __init__(self, local_comm: Communicator, remote_ids: Sequence[int],
                 cid: int, low: bool, name: str = "intercomm") -> None:
        self.local_comm = local_comm
        self.remote_ids = list(remote_ids)   # namespace ids, remote order
        self.cid = cid
        self.low = low                       # my group orders first
        self.name = name
        self.pml = local_comm.pml
        self.rank = local_comm.rank
        self._pending: list = []   # outstanding user p2p (disconnect waits)

    @property
    def size(self) -> int:
        return self.local_comm.size

    @property
    def remote_size(self) -> int:
        return len(self.remote_ids)

    # -- p2p against the remote group -------------------------------------

    def _track(self, req: Request) -> Request:
        """Remember outstanding user p2p so disconnect() can honor the
        MPI contract (all pending communication completes first)."""
        self._pending = [r for r in self._pending if not r.test()]
        self._pending.append(req)
        return req

    def isend(self, buf: Any, dest: int, tag: int = 0) -> Request:
        if dest == PROC_NULL:
            from ompi_tpu_torch.mpi.request import CompletedRequest

            return CompletedRequest()
        return self._track(self.pml.isend(_host(buf),
                                          self.remote_ids[dest], tag,
                                          self.cid))

    def send(self, buf: Any, dest: int, tag: int = 0) -> None:
        self.isend(buf, dest, tag).wait()

    def irecv(self, source: int = 0, tag: int = ANY_TAG) -> Request:
        src = self.remote_ids[source] if source >= 0 else source
        return self._track(self.pml.irecv(None, src, tag, self.cid))

    def recv(self, source: int = 0, tag: int = ANY_TAG,
             status: Optional[Status] = None) -> np.ndarray:
        req = self.irecv(source, tag)
        out = req.wait()
        if status is not None:
            status.__dict__.update(req.status.__dict__)
            if status.source >= 0:
                status.source = self.remote_ids.index(status.source)
        return out

    # -- internal p2p on the reserved (negative) tag space ----------------
    # ≈ the reference's MCA_COLL_BASE_TAG_* range: intercomm collectives
    # must never match user p2p on the same context id.

    _CTAG_BARRIER, _CTAG_BCAST, _CTAG_REDUCE = 700, 701, 702
    _CTAG_GATHER, _CTAG_SCATTER, _CTAG_XCHG = 703, 704, 705

    def _coll_isend(self, buf, dest: int, ctag: int) -> Request:
        return self.pml.isend(_host(buf), self.remote_ids[dest],
                              _ITAG_BASE - ctag, self.cid)

    def _check_remote_root(self, root, what: str) -> None:
        """Integer roots name a REMOTE rank; anything out of range (notably
        other negative constants) must raise, not wrap around remote_ids."""
        if not 0 <= root < self.remote_size:
            raise MPIException(
                f"intercomm {what} root {root} out of remote range "
                f"0..{self.remote_size - 1} (use 'root' on the receiving "
                f"rank, PROC_NULL on its group-mates)", error_class=6)

    def _coll_recv(self, source: int, ctag: int) -> np.ndarray:
        return self.pml.irecv(None, self.remote_ids[source],
                              _ITAG_BASE - ctag, self.cid).wait()

    # -- collectives (≈ ompi/mca/coll/inter/: each op is local-group
    # collectives stitched by a leader exchange) ---------------------------

    def barrier(self) -> None:
        """Both groups synchronized: local barriers + leader exchange."""
        self.local_comm.barrier()
        if self.rank == 0:
            sreq = self._coll_isend(np.zeros(0, np.uint8),
                                    0, self._CTAG_BARRIER)
            self._coll_recv(0, self._CTAG_BARRIER)
            sreq.wait()
        self.local_comm.barrier()

    def bcast(self, buf: Any = None, root: Any = None):
        """≈ intercomm MPI_Bcast: ``root='root'`` on the sending rank,
        an int (remote root rank) on the receiving group, PROC_NULL on the
        sending group's non-roots."""
        if root == "root":
            data = _host(buf)
            self._coll_isend(data, 0, self._CTAG_BCAST).wait()
            return data
        if root == PROC_NULL or root is None:
            return None
        if not 0 <= root < self.remote_size:
            raise MPIException(
                f"intercomm bcast root {root} out of remote range "
                f"(use 'root' on the sending rank, PROC_NULL on its "
                f"group-mates)", error_class=6)
        if self.rank == 0:
            out = self._coll_recv(root, self._CTAG_BCAST)
        else:
            out = None
        return self.local_comm.bcast(out, root=0)

    def reduce(self, sendbuf, op=None, root: Any = None):
        """≈ intercomm MPI_Reduce: the reduction of the OTHER group's data
        arrives at ``root='root'``; the contributing group passes the
        receiving rank's remote index as ``root`` (PROC_NULL on the root
        group's non-roots, which contribute nothing and get None)."""
        op = op if op is not None else op_mod.SUM
        if root == "root":
            # the contributing group's local rank 0 = my remote index 0
            return np.asarray(self._coll_recv(0, self._CTAG_REDUCE))
        if root == PROC_NULL or root is None:
            return None
        self._check_remote_root(root, "reduce")
        partial = self.local_comm.reduce(_host(sendbuf), op=op, root=0)
        if self.rank == 0:
            self._coll_isend(partial, root, self._CTAG_REDUCE).wait()
        return None

    def allreduce(self, sendbuf, op=None):
        """≈ intercomm MPI_Allreduce: group A's reduction lands on every
        rank of group B and vice versa (MPI-3.1 §5.2.3 swap semantics)."""
        op = op if op is not None else op_mod.SUM
        partial = self.local_comm.reduce(_host(sendbuf), op=op, root=0)
        if self.rank == 0:
            sreq = self._coll_isend(partial, 0, self._CTAG_XCHG)
            theirs = self._coll_recv(0, self._CTAG_XCHG)
            sreq.wait()
        else:
            theirs = None
        return self.local_comm.bcast(theirs, root=0)

    def allgather(self, sendbuf):
        """≈ intercomm MPI_Allgather: every rank receives the REMOTE
        group's contributions, stacked in remote rank order
        (shape ``(remote_size, *part_shape)``)."""
        mine = self.local_comm.gather(_host(sendbuf), root=0)
        if self.rank == 0:
            stacked = np.stack([np.asarray(p) for p in mine])
            sreq = self._coll_isend(stacked, 0, self._CTAG_XCHG)
            theirs = self._coll_recv(0, self._CTAG_XCHG)
            sreq.wait()
        else:
            theirs = None
        return np.asarray(self.local_comm.bcast(theirs, root=0))

    def gather(self, sendbuf=None, root: Any = None):
        """≈ intercomm MPI_Gather: ``root='root'`` receives a list of the
        remote group's contributions in remote rank order."""
        if root == "root":
            return [np.asarray(self._coll_recv(r, self._CTAG_GATHER))
                    for r in range(self.remote_size)]
        if root == PROC_NULL or root is None:
            return None
        self._check_remote_root(root, "gather")
        self._coll_isend(_host(sendbuf), root,
                         self._CTAG_GATHER).wait()
        return None

    def scatter(self, sendparts=None, root: Any = None):
        """≈ intercomm MPI_Scatter: ``root='root'`` sends part i to remote
        rank i; receiving-group ranks pass the root's remote index."""
        if root == "root":
            if len(sendparts) != self.remote_size:
                raise MPIException(
                    f"intercomm scatter needs {self.remote_size} parts, "
                    f"got {len(sendparts)}", error_class=6)
            reqs = [self._coll_isend(_host(p), r, self._CTAG_SCATTER)
                    for r, p in enumerate(sendparts)]
            for r in reqs:
                r.wait()
            return None
        if root == PROC_NULL or root is None:
            return None
        self._check_remote_root(root, "scatter")
        return np.asarray(self._coll_recv(root, self._CTAG_SCATTER))

    # -- merge (≈ MPI_Intercomm_merge) -------------------------------------

    def test_inter(self) -> bool:
        """≈ MPI_Comm_test_inter."""
        return True

    def remote_group(self) -> Group:
        """≈ MPI_Comm_remote_group: the remote side's ids as a Group."""
        return Group(self.remote_ids)

    def get_group(self) -> Group:
        """≈ MPI_Comm_group: the LOCAL group."""
        return self.local_comm.group

    def disconnect(self) -> None:
        """≈ MPI_Comm_disconnect: collective over BOTH groups; completes
        every pending p2p request issued through this intercomm, then
        synchronizes both sides before dropping the local resources —
        so no in-flight message can outlive the communicator."""
        for r in self._pending:
            r.wait()
        self._pending = []
        self.barrier()           # both groups, not just the local one
        self.remote_ids = []

    def merge(self, high: Optional[bool] = None) -> Communicator:
        """Collective on both groups: one intracommunicator, low group's
        ranks first (each process addresses members via its own namespace
        ids, but the ORDER is agreed, so rank numbering is global)."""
        high = (not self.low) if high is None else high
        local_ids = [self.local_comm.world_rank(r)
                     for r in range(self.size)]
        mine_first = not high
        ordered = (local_ids + self.remote_ids if mine_first
                   else self.remote_ids + local_ids)
        merged = Communicator(Group(ordered), self.cid + 1,
                              local_ids[self.rank],
                              name=f"{self.name}.merged", pml=self.pml)
        return merged

    def __repr__(self) -> str:
        return (f"Intercomm({self.name}, local={self.size}, "
                f"remote={self.remote_size}, cid={self.cid})")


# ---------------------------------------------------------------------------
# connect / accept (collective over each side's communicator)
# ---------------------------------------------------------------------------

def _exchange_over_port(sock: socket.socket, mine: dict,
                        first: bool) -> dict:
    if first:
        _send_blob(sock, mine)
        return _recv_blob(sock)
    theirs = _recv_blob(sock)
    _send_blob(sock, mine)
    return theirs


def _wire_remote(comm: Communicator, info: dict, my_info: dict
                 ) -> tuple[list[int], int]:
    """Install remote addresses + aliases; return (remote ids, cid)."""
    my_ns = my_info["ns_size"]           # my namespace base for them
    their_ns = info["ns_size"]
    remote_ids = [my_ns + i for i in range(info["size"])]
    peers = {my_ns + i: addr for i, addr in enumerate(info["addrs"])}
    comm.pml.set_peers(peers)
    for rid in remote_ids:
        # my id in THEIR namespace: their base + my rank in this comm
        # (the index they assign me from my position in the addrs list)
        comm.pml.endpoint.set_alias(rid, their_ns + comm.rank)
    cid = _DPM_CID_BASE + 2 * max(info["seq"], my_info["seq"])
    return remote_ids, cid


def _job_info(comm: Communicator) -> dict:
    """Collect this job's business cards on the leader and agree on the
    namespace base: one past every id this job's endpoints already know
    (world ranks AND ids installed by earlier connect/accept calls, so
    repeated dpm operations never collide)."""
    addr = comm.pml.address.encode()
    # outcome must be collective: a rank-local raise here would leave the
    # other ranks blocked in the gather below
    too_long = int(np.asarray(comm.allreduce(
        np.array([1 if len(addr) > _CARD_BYTES else 0], np.int32),
        op=_max_op()))[0])
    if too_long:
        raise MPIException(
            f"a BTL address exceeds the {_CARD_BYTES}-byte business-card "
            f"slot (mine: {comm.pml.address!r}); cannot exchange over "
            f"fixed-width gather")
    addr_rows = comm.gather(
        np.frombuffer(addr.ljust(_CARD_BYTES), np.uint8), root=0)
    addrs = None
    if comm.rank == 0:
        addrs = [bytes(np.asarray(r)).decode().strip() for r in addr_rows]
    known = max(comm.world_rank(comm.rank),
                comm.pml.endpoint.max_peer_id())
    ns = int(np.asarray(comm.allreduce(
        np.array([known + 1], np.int64), op=_max_op()))[0])
    return {"size": comm.size, "addrs": addrs, "ns_size": ns,
            "seq": _next_dpm_seq()}


def _max_op():
    return op_mod.MAX


def _finish_side(comm: Communicator, port_sock: Optional[socket.socket],
                 my_info: dict, low: bool, name: str) -> Intercomm:
    """Leader exchanged info; broadcast to the group and wire up."""
    if comm.rank == 0:
        theirs = _exchange_over_port(port_sock, my_info, first=not low)
        blob = dss.pack(theirs)
        arr = np.frombuffer(blob, np.uint8)
        comm.bcast(np.array([len(arr)], np.int64), root=0)
        comm.bcast(arr, root=0)
    else:
        n = int(np.asarray(comm.bcast(None, root=0))[0])
        arr = np.asarray(comm.bcast(None, root=0))[:n]
        theirs = dss.unpack(bytes(arr), n=1)[0]
    # seq agreement: every rank must derive the same cid — leaders' seqs
    # rode along in the exchanged dicts
    my_info = dict(my_info)
    my_info["seq"] = int(np.asarray(comm.bcast(
        np.array([my_info["seq"]], np.int64), root=0))[0])
    remote_ids, cid = _wire_remote(comm, theirs, my_info)
    ic = Intercomm(comm, remote_ids, cid, low=low, name=name)
    ic.barrier()     # both sides reachable before user traffic
    return ic


_spawned: list = []   # Popen handles of spawned launchers (not reaped here)

# intercomm_create cids live in their own window above the connect/accept
# block so the two families never collide
_ICC_CID_BASE = 1 << 21

# per-process next-free icc cid offset, agreed by MAX over every
# participant at creation (the reference's cid allocation discipline:
# ompi_comm_nextcid's max-agreement) — a per-pair sequence number would
# let two leader pairs with disjoint histories mint the same cid while
# sharing member processes, silently cross-matching traffic.
_icc_lock = threading.Lock()
_icc_next = [0]


def _icc_bump(cid_off: int) -> None:
    with _icc_lock:
        _icc_next[0] = max(_icc_next[0], cid_off + 1)


def intercomm_create(local_comm: Communicator, local_leader: int,
                     bridge_comm: Communicator, remote_leader: int,
                     tag: int = 0) -> Intercomm:
    """≈ MPI_Intercomm_create: build an intercommunicator from two
    disjoint groups of ONE world, leaders exchanging group info over
    ``bridge_comm`` p2p (dpm.c's same-job path — no sockets, no business
    cards: both groups already share the namespace and transports)."""
    me_leader = local_comm.rank == local_leader
    # collision-free cid: my group's max next-free offset (collective),
    # then leaders exchange and take the global max — any process that
    # ever saw offset k has bumped past it, so no member of the new
    # intercomm can hold an old intercomm with the same cid
    with _icc_lock:
        my_next = _icc_next[0]
    local_next = int(np.asarray(local_comm.allreduce(
        np.array([my_next], np.int64), op=_max_op()))[0])
    if me_leader:
        mine = np.array([local_comm.world_rank(r)
                         for r in range(local_comm.size)], np.int64)
        hdr = np.array([local_next, len(mine)], np.int64)
        sreq = bridge_comm.isend(np.concatenate([hdr, mine]),
                                 dest=remote_leader, tag=tag)
        got = np.asarray(bridge_comm.recv(source=remote_leader, tag=tag))
        sreq.wait()
        their_next, n = int(got[0]), int(got[1])
        remote = got[2:2 + n]
        cid = _ICC_CID_BASE + max(local_next, their_next)
        blob = np.concatenate([np.array([cid], np.int64), remote])
        local_comm.bcast(np.array([len(blob)], np.int64),
                         root=local_leader)
        local_comm.bcast(blob, root=local_leader)
    else:
        n = int(np.asarray(local_comm.bcast(None, root=local_leader))[0])
        blob = np.asarray(local_comm.bcast(None, root=local_leader))[:n]
        cid = int(blob[0])
        remote = blob[1:]
    _icc_bump(cid - _ICC_CID_BASE)
    # overlapping groups are erroneous in MPI — catch the common mistake
    local_ids = {local_comm.world_rank(r) for r in range(local_comm.size)}
    if local_ids & set(int(r) for r in remote):
        raise MPIException(
            "intercomm_create: local and remote groups overlap",
            error_class=5)
    low = min(local_ids) < min(int(r) for r in remote)
    ic = Intercomm(local_comm, [int(r) for r in remote], cid, low=low,
                   name=f"{local_comm.name}.icc")
    ic.barrier()
    return ic


def join(fd: int, comm: Optional[Communicator] = None) -> Intercomm:
    """≈ MPI_Comm_join: a 1×1 intercommunicator between the two processes
    at the ends of a connected socket (comm_join.c).  ``fd`` is the
    caller-owned socket file descriptor; side ordering derives from the
    socket's own address pair, so both ends decide consistently."""
    if comm is None:
        from ompi_tpu_torch.mpi import runtime as rt

        rt.init()
        comm = rt._state["self"]
    sock = socket.socket(fileno=os.dup(fd))  # caller keeps their fd
    try:
        # side ordering by explicit nonce exchange: socket addresses are
        # NOT usable here (AF_UNIX socketpairs report the same empty name
        # on both ends).  Both sides send 16 random bytes and compare —
        # exactly one side is "low"; a tie is astronomically unlikely and
        # rejected rather than mis-merged.
        mine = os.urandom(16)
        sock.sendall(mine)
        theirs = b""
        while len(theirs) < 16:
            chunk = sock.recv(16 - len(theirs))
            if not chunk:
                raise MPIException("join: peer closed during handshake")
            theirs += chunk
        if mine == theirs:
            raise MPIException("join: nonce tie; retry")
        low = mine < theirs
        my_info = _job_info(comm)
        return _finish_side(comm, sock, my_info, low=low,
                            name=f"{comm.name}.join")
    finally:
        sock.close()


def accept(comm: Communicator, port_name: Optional[str]) -> Intercomm:
    """≈ MPI_Comm_accept — collective; leader owns the port (non-leaders
    may pass None)."""
    my_info = _job_info(comm)
    sock = None
    if comm.rank == 0:
        port = _ports.get(port_name)
        if port is None:
            raise MPIException(f"unknown port {port_name}",
                               error_class=ERR_PORT)
        conn, _ = port.sock.accept()
        sock = conn
    try:
        return _finish_side(comm, sock, my_info, low=True,
                            name=f"{comm.name}.accept")
    finally:
        if sock is not None:
            sock.close()


def connect(comm: Communicator, port_name: str,
            timeout: float = 30.0) -> Intercomm:
    """≈ MPI_Comm_connect — collective; leader dials the port."""
    my_info = _job_info(comm)
    sock = None
    if comm.rank == 0:
        host, port = port_name.rsplit(":", 1)
        sock = socket.create_connection((host, int(port)), timeout=timeout)
    try:
        return _finish_side(comm, sock, my_info, low=False,
                            name=f"{comm.name}.connect")
    finally:
        if sock is not None:
            sock.close()


# ---------------------------------------------------------------------------
# spawn (≈ MPI_Comm_spawn) + get_parent
# ---------------------------------------------------------------------------

def _dvm_submit_args(child_env: dict) -> list:
    """Elastic grow on a standing pool: in the JAX package a job launched
    through a multi-tenant DVM carries ``OMPI_TPU_DVM_URI`` in its env and
    its spawns go back through the same pool (``--dvm-submit``).  The
    port's ``tpurun`` has no DVM yet (ROADMAP.md item 6.15b), so such a
    spawn raises rather than pass the launcher a flag it does not know.
    Outside a DVM this is a no-op."""
    uri = child_env.get(ENV_DVM_URI)
    if not uri:
        return []
    raise MPIException(
        f"spawn: this job runs under a DVM ({ENV_DVM_URI}={uri}), but the "
        f"port's tpurun has no --dvm-submit yet (ROADMAP.md item 6.15b); "
        f"unset {ENV_DVM_URI} to spawn through a private launcher",
        error_class=16)


def _child_env(env: Optional[dict] = None) -> dict:
    """The spawned job's environment: this process's, less its own rank
    identity (``_RANK_ENV``), plus the parent's port and ``env``."""
    child_env = {k: v for k, v in os.environ.items() if k not in _RANK_ENV}
    if env:
        child_env.update(env)
    return child_env


def spawn(comm: Communicator, argv: Sequence[str], maxprocs: int = 1,
          env: Optional[dict] = None, timeout: float = 120.0) -> Intercomm:
    """Launch `maxprocs` child procs running ``argv`` under the tpurun
    launcher; returns the parent↔children intercommunicator.  Children
    reach us via :func:`get_parent`."""
    port_name = None
    proc = None
    # every rank checks (the env is the job's): a refusal on the root
    # alone would leave the others blocked in accept
    child_env = _child_env(env)
    dvm = _dvm_submit_args(child_env)
    if comm.rank == 0:
        cmd = [sys.executable, "-m", "ompi_tpu_torch.tools.tpurun",
               *dvm, "-np", str(maxprocs), "--"] + list(argv)
        port_name = open_port()
        child_env[ENV_PARENT_PORT] = port_name
        proc = subprocess.Popen(cmd, env=child_env)
        _spawned.append(proc)   # keep the handle; launcher owns lifetime
    try:
        return accept(comm, port_name)
    finally:
        if port_name is not None:
            close_port(port_name)


def spawn_multiple(comm: Communicator,
                   commands: Sequence[Sequence[str]],
                   maxprocs: Sequence[int],
                   envs: Optional[Sequence[Optional[dict]]] = None,
                   timeout: float = 120.0) -> Intercomm:
    """≈ MPI_Comm_spawn_multiple: MPMD spawn — one child JOB whose world
    concatenates the command blocks (ranks 0..maxprocs[0]-1 run
    commands[0], the next maxprocs[1] run commands[1], …).  Realized by
    launching the job under a dispatch shim that execs each rank's argv
    from a table in the environment — the child world is a single job
    exactly as the reference's plm builds it (one orte_job_t, several
    app contexts)."""
    import json

    if len(commands) != len(maxprocs):
        raise MPIException("spawn_multiple: commands/maxprocs mismatch",
                           error_class=2)
    total = int(sum(maxprocs))
    port_name = None
    child_env = _child_env()
    dvm = _dvm_submit_args(child_env)
    if comm.rank == 0:
        port_name = open_port()
        child_env[ENV_PARENT_PORT] = port_name
        # per-COMMAND envs ride in the rank table (applied by the dispatch
        # shim pre-exec), not the job-wide environment — MPI's
        # spawn_multiple binds env/info to its command block
        table = []
        for i, (argv, n) in enumerate(zip(commands, maxprocs)):
            e = (envs[i] if envs and i < len(envs) else None) or {}
            table += [[list(argv), dict(e)]] * int(n)
        child_env[ENV_MPMD_TABLE] = json.dumps(table)
        cmd = [sys.executable, "-m", "ompi_tpu_torch.tools.tpurun",
               *dvm, "-np", str(total), "--", sys.executable, "-m",
               "ompi_tpu_torch.mpi._mpmd_dispatch"]
        proc = subprocess.Popen(cmd, env=child_env)
        _spawned.append(proc)
    try:
        return accept(comm, port_name)
    finally:
        if port_name is not None:
            close_port(port_name)


def get_parent(comm: Communicator) -> Optional[Intercomm]:
    """≈ MPI_Comm_get_parent — in a spawned job, the intercomm to the
    parent; None when not spawned.  Collective over the child world."""
    port = os.environ.get(ENV_PARENT_PORT)
    if not port:
        return None
    return connect(comm, port)
