"""MPI-IO: file handles, views, individual/collective/shared access (the
port's copy of the JAX package's ``mpi/io.py``: the same MCA variables,
components, file layouts and results).

≈ the reference's ``io`` framework — the native OMPIO implementation
(ompi/mca/io/ompio + ompi/mca/common/ompio's file-view and read/write
engine) with its sub-frameworks collapsed into one module:

- fs (open/close/delete; fs/ufs)            → :meth:`File.open` etc.
- fbtl (posix data movement)                → pread/pwrite on the fd
- fcoll (collective two-phase;
  fcoll/two_phase + dynamic)                → :meth:`File.write_at_all`
- sharedfp (shared file pointer;
  sharedfp/lockedfile + sm)                 → :meth:`File.write_shared`

File *views* (MPI_File_set_view: displacement + etype + filetype) reuse the
datatype engine: a filetype's compiled byte segments tile the file, and the
view maps a contiguous etype stream onto the holes — the same descriptor
walk the reference's common_ompio file-view engine does, vectorized over
runs instead of a per-byte loop.

Writes take numpy arrays, scalars and torch tensors on any device; reads
return numpy arrays, as in the JAX package.  A CPU tensor's bytes are
read in place (``Tensor.numpy()``, zero copy); a CUDA tensor is made
contiguous on the card and staged with ONE device-to-host copy of the
whole buffer, never one copy per file run.  A bfloat16 or float8 tensor
(no numpy dtype) travels as its bits: its bytes are written as they are,
never converted to the view's etype, and a ``BFLOAT16`` view reads back
the 2-byte words (``np.uint16``, the port's BFLOAT16 element).  The
nonblocking and split-collective writes stage a tensor's bytes in the
caller's thread before the request is queued, so the file holds the
values of call time and the worker thread never touches a CUDA tensor.
The module imports torch nowhere at module level: a host-plane rank that
writes numpy data never loads it.  Sharded checkpoint IO of array data
has its own layer over this one (``ckpt.store.ShardedSnapshotStore``).

Two-phase collective IO: every rank is an aggregator for an equal
contiguous file domain (the reference's default: one aggregator per node,
cb_buffer_size domains).  Requests are exchanged with alltoallv, aggregated
into large contiguous pread/pwrite calls, and routed back — turning N
small strided accesses into a few big sequential ones.

The mpi4py facade's ``File`` (``compat/MPI.py``) wraps this module's
``File``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Optional, Sequence

import numpy as np

from ompi_tpu_torch.core.buffer import is_tensor, tensor_to_host
from ompi_tpu_torch.core.config import VarType, register_var, var_registry
from ompi_tpu_torch.mpi import datatype as dt_mod
from ompi_tpu_torch.mpi import trace as trace_mod
from ompi_tpu_torch.mpi.constants import ERR_IO, MPIException
from ompi_tpu_torch.mpi.datatype import Datatype
from ompi_tpu_torch.mpi.request import CompletedRequest, Request

__all__ = [
    "File", "FileView",
    "MODE_RDONLY", "MODE_WRONLY", "MODE_RDWR", "MODE_CREATE", "MODE_EXCL",
    "MODE_APPEND", "MODE_DELETE_ON_CLOSE", "SEEK_SET", "SEEK_CUR", "SEEK_END",
]

# amode flags (values mirror MPI's spirit, not its ABI)
MODE_RDONLY = 0x01
MODE_WRONLY = 0x02
MODE_RDWR = 0x04
MODE_CREATE = 0x08
MODE_EXCL = 0x10
MODE_APPEND = 0x20
MODE_DELETE_ON_CLOSE = 0x40

SEEK_SET = 0
SEEK_CUR = 1
SEEK_END = 2

register_var("io", "twophase", VarType.BOOL, True,
             "use two-phase aggregation for collective IO "
             "(False: collective calls run as independent IO + barrier)")
register_var("io", "twophase_min_bytes", VarType.SIZE, 1,
             "minimum total bytes before two-phase aggregation kicks in")
register_var("io", "fcoll", VarType.STRING, "",
             "force a collective-IO component: individual | two_phase | "
             "dynamic | static | dynamic_gen2 (empty = auto-decide from "
             "the access pattern, like the reference's fcoll "
             "query/priority selection)")
register_var("io", "stripe_bytes", VarType.SIZE, 1 << 20,
             "file stripe width for the static (cyclic stripe->aggregator "
             "round-robin) and dynamic_gen2 (stripe-aligned payload "
             "domains) fcoll components; match the filesystem stripe for "
             "lock-contention-free aggregator writes")
register_var("io", "cb_aggregators_per_host", VarType.INT, 1,
             "collective-buffering aggregators per host (aggregators are "
             "the lowest ranks of each host in the job mapping, like "
             "OMPIO's one-per-node cb_nodes default)")
register_var("io", "fs_adaptive", VarType.BOOL, True,
             "adapt collective-IO defaults to the filesystem backing the "
             "file (the fs framework's job, ompi/mca/fs: fs/lustre tunes "
             "stripe-aware defaults; here: memory-backed fs prefer "
             "individual IO, network fs aggregate aggressively)")

# memory-backed: aggregation only adds exchange hops (no seek to amortize)
_FS_MEMORY = {"tmpfs", "ramfs", "devtmpfs"}
# network: per-client streams are expensive — aggregate aggressively
_FS_NETWORK = {"nfs", "nfs4", "lustre", "gpfs", "cifs", "smb2", "9p",
               "fuse.sshfs", "glusterfs", "beegfs"}


def _fs_type(path: str) -> str:
    """Filesystem type backing ``path`` (longest mount-prefix match in
    /proc/mounts; '' when undeterminable).  ≈ the detection the fs
    framework components do with statfs magic (fs_lustre.c checks the
    LL_SUPER_MAGIC the same way)."""
    try:
        real = os.path.realpath(path)
        best, best_type = "", ""
        with open("/proc/mounts", encoding="utf-8") as f:
            for line in f:
                parts = line.split()
                if len(parts) < 3:
                    continue
                mnt, typ = parts[1], parts[2]
                if real.startswith(mnt.rstrip("/") + "/") or real == mnt \
                        or mnt == "/":
                    if len(mnt) > len(best):
                        best, best_type = mnt, typ
        return best_type
    except OSError:
        return ""

# shared-file-pointer serialization for in-process ranks (threads share the
# process, so fcntl locks alone can't order them); keyed by realpath
_shfp_locks: dict[str, threading.Lock] = {}
_shfp_registry_lock = threading.Lock()


# -- data representations (≈ MPI_Register_datarep, io_ompio datarep) -------
#
# name → (read_conv, write_conv); each is f(raw_bytes, etype) -> bytes or
# None for identity.  Conversions must preserve byte count (the file-view
# byte-run arithmetic assumes it) — MPI's variable-size datareps are out of
# scope on this substrate and register_datarep enforces same-size by
# checking a probe conversion.

def _ext32_swap(raw: bytes, etype) -> bytes:
    import sys as _sys

    if _sys.byteorder == "big" or etype.size <= 1:
        return raw
    n = len(raw) // etype.size
    tail = raw[n * etype.size:]
    return dt_mod._swap_stream(etype, raw[:n * etype.size], n) + tail


_datareps: dict[str, tuple] = {
    "native": (None, None),
    "internal": (None, None),
    "external32": (_ext32_swap, _ext32_swap),
}


def register_datarep(name: str, read_conv=None, write_conv=None) -> None:
    """≈ MPI_Register_datarep: a user data representation usable in
    set_view.  ``read_conv(raw, etype) -> bytes`` converts file→native,
    ``write_conv`` native→file; byte count must be preserved."""
    if name in _datareps:
        raise MPIException(f"datarep {name!r} already registered",
                           error_class=ERR_IO)
    probe = bytes(8)
    for fn in (read_conv, write_conv):
        if fn is not None and len(fn(probe, dt_mod.BYTE)) != len(probe):
            raise MPIException(
                f"datarep {name!r}: conversion changed byte count "
                f"(unsupported here)", error_class=ERR_IO)
    _datareps[name] = (read_conv, write_conv)


def _shfp_lock(path: str) -> threading.Lock:
    with _shfp_registry_lock:
        return _shfp_locks.setdefault(path, threading.Lock())


import itertools as _it  # noqa: E402

_shfp_nonce = _it.count(1)   # per-process component of the sm open nonce


# -- sharedfp strategies (≈ ompi/mca/sharedfp components) -----------------

register_var("io", "sharedfp", VarType.STRING, "",
             "shared-file-pointer component: lockedfile | sm | individual "
             "(empty = auto: sm when every rank shares the host and the "
             "native atomics built, else lockedfile — the reference's "
             "sharedfp component split; individual is opt-in only, it "
             "relaxes the shared-pointer semantics)")


class _LockedFileSharedFp:
    """sharedfp/lockedfile: an 8-byte sidecar file guarded by a fcntl
    range lock (+ a thread lock for in-process ranks) — works on any
    shared filesystem, multi-host included."""

    name = "lockedfile"

    def __init__(self, path: str) -> None:
        self.path = path + ".ompi_tpu_shfp"

    def create(self, initial: int) -> None:
        self.store(initial)

    def attach(self) -> None:
        pass                     # the filesystem is the rendezvous

    def load(self) -> int:
        with open(self.path, "rb") as f:
            return int.from_bytes(f.read(8), "big")

    def store(self, val: int) -> None:
        with open(self.path, "wb") as f:
            f.write(int(val).to_bytes(8, "big"))

    def fetch_add(self, n: int) -> int:
        import fcntl

        with _shfp_lock(self.path):
            with open(self.path, "r+b") as f:
                fcntl.lockf(f, fcntl.LOCK_EX)
                try:
                    cur = int.from_bytes(f.read(8), "big")
                    f.seek(0)
                    f.write((cur + n).to_bytes(8, "big"))
                    f.flush()
                finally:
                    fcntl.lockf(f, fcntl.LOCK_UN)
        return cur

    def close(self, root: bool) -> None:
        if root:
            try:
                os.unlink(self.path)
            except OSError:
                pass


class _SmSharedFp:
    """sharedfp/sm: the pointer is an 8-byte counter in a shared-memory
    segment, advanced with native u64 atomics (fastdss.atomic_add) —
    lock-free fetch-add for same-host jobs, the reference's
    sharedfp/sm strategy."""

    name = "sm"

    def __init__(self, path: str) -> None:
        import zlib

        self._base = f"otpu-shfp-{os.getuid()}-{zlib.crc32(path.encode()):08x}"
        self._name = self._base
        self._seg = None
        self._fast = None

    def set_nonce(self, nonce: int) -> None:
        """Per-OPEN disambiguation (agreed collectively): MPI shared
        pointers belong to the open, so two concurrent opens of the same
        path must not share — or unlink — each other's counter.  The
        port's names carry a ``t`` before the nonce: a JAX-package open of
        the same path in the same process (whose nonce counter runs
        beside this one) never takes the same segment."""
        self._name = f"{self._base}-t{nonce:x}"

    @staticmethod
    def usable() -> bool:
        from ompi_tpu_torch import _native

        return (os.path.isdir("/dev/shm")
                and _native.fastdss() is not None)

    def _path(self) -> str:
        return os.path.join("/dev/shm", self._name)

    def create(self, initial: int) -> None:
        from ompi_tpu_torch import _native
        from ompi_tpu_torch.core import shmseg

        self._fast = _native.fastdss()
        # nonce names never collide with a crashed job's, so stale
        # segments need active GC: sweep siblings of this path older
        # than 10 min (their jobs are gone; live opens are short-lived)
        import glob

        for old in glob.glob(os.path.join("/dev/shm",
                                          self._base + "-*")):
            try:
                if time.time() - os.path.getmtime(old) > 600:
                    os.unlink(old)
            except OSError:
                pass
        # initialize BEFORE publishing: an attacher must never observe
        # the counter without its initial value
        self._seg = shmseg.create(self._name, 8, dir="/dev/shm",
                                  publish=False)
        self._fast.atomic_store(self._seg.buf, 0, int(initial))
        self._seg.publish()

    def attach(self) -> None:
        # no retry needed: the create outcome was broadcast before any
        # attacher runs, so the published segment already exists — and
        # retrying would stretch permanent errors (EACCES, corrupt
        # segment) into long stalls
        from ompi_tpu_torch import _native
        from ompi_tpu_torch.core import shmseg

        self._fast = _native.fastdss()
        self._seg = shmseg.attach(self._path())

    def load(self) -> int:
        return int(self._fast.atomic_load(self._seg.buf, 0))

    def store(self, val: int) -> None:
        self._fast.atomic_store(self._seg.buf, 0, int(val))

    def fetch_add(self, n: int) -> int:
        return int(self._fast.atomic_add(self._seg.buf, 0, int(n)))

    def close(self, root: bool) -> None:
        """EVERY rank detaches its mapping (a rank-0-only teardown would
        leak one live tmpfs mapping per open on every other rank); the
        root also unlinks the segment name."""
        if root:
            try:
                os.unlink(self._path())
            except OSError:
                pass
        if self._seg is not None:
            try:
                self._seg.detach()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
            self._seg = None


class _IndividualSharedFp:
    """sharedfp/individual: the reference's third strategy
    (ompi/mca/sharedfp/individual) — RELAXED shared-pointer semantics.
    Each rank spools its ``write_shared`` payloads to a local temp file
    with a timestamp per record; the global interleaving is reconstructed
    collectively at sync/close (and before any ordered op) by merging
    every rank's records in timestamp order.  Zero inter-process
    coordination per write — the fastest strategy when the program only
    ever *writes* through the shared pointer and can live with the order
    materializing at sync points.  ``read_shared``/``seek_shared`` are
    erroneous, exactly as in the reference (it implements only the write
    side).  Opt-in only (``--mca io sharedfp individual``): auto-selection
    must never silently weaken MPI semantics."""

    name = "individual"
    local_log = True      # File routes write_shared through log_write()

    def __init__(self, path: str) -> None:
        self.path = path
        self._spool = None              # local payload spool (tempfile)
        self._recs: list[tuple[int, int]] = []   # (t_ns, nbytes)
        self.merged_end = 0             # etype units; agreed at each merge
        # record append + spool write must be ONE step: under
        # THREAD_MULTIPLE two interleaved write_shared calls would
        # otherwise desync _recs order from spool byte order and the
        # merge would write the wrong bytes at each record's offset
        self._lock = threading.Lock()

    def create(self, initial: int) -> None:
        """LOCAL setup — every rank runs this (there is no shared state
        to rendezvous on; that is the point of the strategy)."""
        import tempfile

        self._spool = tempfile.TemporaryFile(prefix="otpu-shfp-ind-")
        self.merged_end = int(initial)

    def attach(self) -> None:
        pass   # nothing shared to attach to

    def log_write(self, raw: bytes) -> None:
        with self._lock:
            self._recs.append((time.time_ns(), len(raw)))
            self._spool.write(raw)

    def _unsupported(self) -> MPIException:
        return MPIException(
            "sharedfp/individual supports only write_shared and the "
            "ordered collectives; shared-pointer reads/seeks need the "
            "sm or lockedfile component", error_class=ERR_IO)

    def load(self) -> int:
        raise self._unsupported()

    def store(self, val: int) -> None:
        raise self._unsupported()

    def fetch_add(self, n: int) -> int:
        raise self._unsupported()

    def close(self, root: bool) -> None:
        if self._spool is not None:
            try:
                self._spool.close()
            except OSError:
                pass
            self._spool = None


class _Staged:
    """A write buffer on the host: ``arr`` is a numpy array, and ``bits``
    marks the raw bits of a dtype numpy has no name for (bf16, float8)."""

    __slots__ = ("arr", "bits")

    def __init__(self, arr: np.ndarray, bits: bool) -> None:
        self.arr = arr
        self.bits = bits


def _stage(data: Any, copy: bool) -> _Staged:
    """Host staging of one write buffer: a tensor by ``tensor_to_host``
    (one device-to-host copy for a CUDA tensor; bf16/float8 as their bits,
    never converted; a CPU tensor copied where ``copy``, for the
    nonblocking calls, whose bytes must be those of call time).  Anything
    else goes through ``np.asarray``."""
    if not is_tensor(data):
        return _Staged(np.asarray(data), False)
    return _Staged(*tensor_to_host(data, copy=copy))


class FileView:
    """displacement + etype + filetype (MPI_File_set_view).

    The filetype tiles the file starting at ``disp``; its payload byte runs
    (``segments()``) are the accessible holes.  Positions/counts are in
    etype units, as the MPI spec requires.
    """

    def __init__(self, disp: int = 0,
                 etype: Datatype = dt_mod.BYTE,
                 filetype: Optional[Datatype] = None) -> None:
        if filetype is None:
            filetype = etype
        if filetype.size % etype.size:
            raise MPIException(
                f"filetype size {filetype.size} not a multiple of etype "
                f"size {etype.size}", error_class=3)
        self.disp = int(disp)
        self.etype = etype
        self.filetype = filetype
        # payload runs per tile, array-native (a million-run filetype
        # must not materialize a tuple list here)
        self._run_starts, self._run_lens = filetype.segment_arrays()
        self._n_runs = len(self._run_starts)
        self._tile_bytes = filetype.size     # payload bytes per tile
        self._tile_extent = filetype.extent  # file bytes spanned per tile
        # prefix sums of run lengths for payload→file mapping
        self._run_cum = np.concatenate(
            [[0], np.cumsum(self._run_lens)]).astype(np.int64)

    @property
    def contiguous(self) -> bool:
        return (self._n_runs == 1 and int(self._run_starts[0]) == 0
                and self._tile_bytes == self._tile_extent)

    def payload_bytes_up_to(self, file_size: int) -> int:
        """How many payload bytes the view exposes below `file_size` — the
        inverse mapping needed by SEEK_END."""
        avail = file_size - self.disp
        if avail <= 0:
            return 0
        if self.contiguous:
            return avail
        tiles, within = divmod(avail, self._tile_extent)
        pay = tiles * self._tile_bytes
        # PREFIX of the declaration-ordered runs below `within` (a
        # non-monotone filetype's later runs may sit below it in the
        # file but are NOT readable payload prefix — the original
        # walk-with-break semantics)
        below = self._run_starts < within
        k = (len(below) if bool(below.all())
             else int(np.argmin(below)))
        pay += int(np.minimum(
            self._run_lens[:k],
            within - self._run_starts[:k]).sum())
        return pay

    def byte_runs(self, offset_etypes: int, nbytes: int
                  ) -> list[tuple[int, int]]:
        """File (offset, length) runs covering `nbytes` of payload starting
        at view position `offset_etypes` — the descriptor walk.

        Vectorized over the view's tile periodicity: the runs of every
        FULL tile are the filetype's segments shifted by tile·extent, so
        they expand with one broadcast instead of a python loop per run
        (a 20k-run strided view costs ~100 numpy calls, not ~80k)."""
        start = offset_etypes * self.etype.size
        if nbytes <= 0:
            return []
        if self.contiguous:
            return [(self.disp + start, nbytes)]
        end = start + nbytes
        tile0, w0 = divmod(start, self._tile_bytes)
        tile1, w1 = divmod(end, self._tile_bytes)   # w1 bytes into tile1

        def tile_slice(tile: int, lo: int, hi: int) -> tuple:
            """(starts, lens) of payload bytes [lo, hi) within one tile."""
            i0 = int(np.searchsorted(self._run_cum, lo, "right")) - 1
            i1 = int(np.searchsorted(self._run_cum, hi, "left"))
            s = self._run_starts[i0:i1].copy()
            ln = self._run_lens[i0:i1].copy()
            if len(s):
                head = lo - int(self._run_cum[i0])
                s[0] += head
                ln[0] -= head
                tail = int(self._run_cum[i1]) - hi
                ln[-1] -= tail
            base = self.disp + tile * self._tile_extent
            return base + s, ln

        parts = []
        if tile0 == tile1:
            parts.append(tile_slice(tile0, w0, w1))
        else:
            if w0:
                parts.append(tile_slice(tile0, w0, self._tile_bytes))
                first_full = tile0 + 1
            else:
                first_full = tile0
            if first_full < tile1:      # the full middle tiles, broadcast
                tiles = np.arange(first_full, tile1, dtype=np.int64)
                base = (self.disp + tiles[:, None] * self._tile_extent
                        + self._run_starts[None, :])
                lens = np.broadcast_to(self._run_lens[None, :], base.shape)
                parts.append((base.reshape(-1), lens.reshape(-1)))
            if w1:
                parts.append(tile_slice(tile1, 0, w1))
        starts = np.concatenate([p[0] for p in parts])
        lens = np.concatenate([p[1] for p in parts])
        keep = lens > 0
        starts, lens = starts[keep], lens[keep]
        if len(starts) == 0:
            return []
        # adjacency merge (runs touching across tile seams), vectorized:
        # a new group starts wherever the previous run doesn't reach us
        brk = np.empty(len(starts), bool)
        brk[0] = True
        np.not_equal(starts[1:], starts[:-1] + lens[:-1], out=brk[1:])
        g = np.flatnonzero(brk)
        gstarts = starts[g]
        glens = np.add.reduceat(lens, g)
        return list(zip(gstarts.tolist(), glens.tolist()))


def _coalesce(runs: list[tuple[int, int, bytes]]
              ) -> list[tuple[int, bytes]]:
    """Merge byte runs into maximal contiguous writes (stable sort keeps
    rank order on equal offsets; overlapping writes without atomicity are
    erroneous in MPI, so adjacency is the only case that matters)."""
    runs = sorted(runs, key=lambda r: r[0])
    out: list[tuple[int, bytearray]] = []
    for off, ln, data in runs:
        if out and out[-1][0] + len(out[-1][1]) == off:
            out[-1][1].extend(data[:ln])
        else:
            out.append((off, bytearray(data[:ln])))
    return [(o, bytes(b)) for o, b in out]


class File:
    """An open MPI file handle (≈ ompi_file_t + the ompio module state)."""

    def __init__(self, comm, path: str, amode: int) -> None:
        # private communicator for all file-internal traffic (ROMIO dups
        # for the same reason): the nonblocking-collective worker thread
        # runs collectives concurrently with the caller's thread, and on
        # the user's comm those could cross-match the user's same-tag
        # collectives.  Collective, so it must be the first comm op here.
        self.comm = comm.dup(name=f"{getattr(comm, 'name', 'comm')}.io")
        if hasattr(comm, "_io_host_override"):  # test/placement hook
            self.comm._io_host_override = comm._io_host_override
        self.path = os.path.abspath(path)
        self.amode = amode
        self.view = FileView()
        self._pos = 0                    # individual pointer, etype units
        self._atomicity = False
        self._closed = False
        self._fd: Optional[int] = None
        from ompi_tpu_torch.mpi.errhandler import ERRORS_RETURN
        from ompi_tpu_torch.mpi.info import Info

        self.errhandler = ERRORS_RETURN  # note: MPI's File default IS
        # ERRORS_RETURN (unlike comms) — here they agree
        self.info = Info()
        self._io_lock = threading.Lock()
        # fs framework: the filesystem kind steers collective-IO defaults
        self.fs_type = _fs_type(os.path.dirname(self.path) or ".")
        flags = os.O_RDWR if amode & (MODE_RDWR | MODE_WRONLY) else os.O_RDONLY
        # MPI_MODE_WRONLY still needs reads for read-modify on views; POSIX
        # O_WRONLY would break pread — open RDWR and gate in software
        if amode & MODE_CREATE:
            flags |= os.O_CREAT
        err = ""
        if amode & MODE_EXCL:
            # EXCL is a *collective* exists-check: rank 0 does the
            # exclusive create and broadcasts the outcome (a plain barrier
            # would hang the others if rank 0's open fails), then the rest
            # open the now-existing file
            if self.comm.rank == 0:
                try:
                    self._fd = os.open(self.path, flags | os.O_EXCL, 0o644)
                except OSError as e:
                    err = str(e)
            ok = self.comm.bcast(np.array([0 if err else 1], np.int8), root=0)
            if not int(np.asarray(ok)[0]):
                self.comm.free()   # uniform raise — don't leak the dup
                raise MPIException(
                    f"MPI_File_open({path}): "
                    f"{err or 'exclusive create failed on rank 0'}",
                    error_class=ERR_IO)
            if self.comm.rank != 0:
                try:
                    self._fd = os.open(self.path, flags & ~os.O_CREAT)
                except OSError as e:
                    err = str(e)
        else:
            try:
                self._fd = os.open(self.path, flags, 0o644)
            except OSError as e:
                err = str(e)
        # collective outcome check: a per-rank open failure (perms / path
        # visible on only some ranks / EXCL non-root open racing a delete)
        # must raise on EVERY rank — otherwise the survivors proceed to the
        # barrier below and the job hangs
        nfail = int(np.asarray(self.comm.allreduce(
            np.array([0 if not err else 1], np.int32)))[0])
        if nfail:
            if self._fd is not None and not err:
                os.close(self._fd)
                self._fd = None
            self.comm.free()       # uniform raise — don't leak the dup
            raise MPIException(
                f"MPI_File_open({path}): failed on {nfail} rank(s)"
                + (f": {err}" if err else ""), error_class=ERR_IO)
        if amode & MODE_APPEND:
            self._pos = os.fstat(self._fd).st_size // self.view.etype.size
        # shared file pointer: pick a sharedfp component collectively,
        # rank 0 creates/resets it (to EOF under APPEND — MPI requires
        # *all* pointers to start at end of file), everyone attaches.
        # A read-only mount (archived snapshot dir) cannot host the
        # lockedfile sidecar — record the failure and raise only if
        # shared-pointer ops are actually used, so plain reads of
        # immutable files work.
        self._shfp_err = ""
        try:
            self._shfp = self._select_sharedfp()
        except MPIException:
            os.close(self._fd)   # the raise is uniform across ranks
            self._fd = None      # (collectively agreed) — don't leak fd
            self.comm.free()     # ... or the comm dup'd above
            raise
        initial = int(self._pos if amode & MODE_APPEND else 0)
        if getattr(self._shfp, "local_log", False):
            # sharedfp/individual: per-rank local spool, nothing shared —
            # every rank creates its own (initial is identical: same
            # fstat of the same file); agreement happens below
            try:
                self._shfp.create(initial)
            except OSError as e:
                self._shfp_err = str(e)
        else:
            if self._shfp.name == "sm":
                # per-open nonce, rank 0's choice broadcast: concurrent
                # opens of one path must not collide on the segment name
                nonce = int(np.asarray(self.comm.bcast(np.array(
                    [os.getpid() << 16 | (next(_shfp_nonce) & 0xFFFF)],
                    np.int64), root=0))[0])
                self._shfp.set_nonce(nonce)
            if self.comm.rank == 0:
                try:
                    self._shfp.create(initial)
                except OSError as e:
                    self._shfp_err = str(e)
            # every rank must agree whether the pointer exists (shared ops
            # are collective-adjacent): broadcast the create outcome,
            # attach, then agree on the attach outcomes too — a single
            # rank with a broken pointer would otherwise raise
            # mid-collective while its peers block in the matching barrier
            flag = self.comm.bcast(np.array(
                [1 if not self._shfp_err else 0], np.int8), root=0)
            if not int(np.asarray(flag)[0]):
                if self.comm.rank != 0:
                    self._shfp_err = \
                        "shared-pointer creation failed on rank 0"
            elif self.comm.rank != 0:
                try:
                    self._shfp.attach()
                except OSError as e:
                    self._shfp_err = str(e)
        from ompi_tpu_torch.mpi import op as op_mod

        ok_everywhere = int(np.asarray(self.comm.allreduce(np.array(
            [0 if self._shfp_err else 1], np.int32),
            op=op_mod.MIN))[0])
        if not ok_everywhere and not self._shfp_err:
            self._shfp_err = "shared-pointer setup failed on a peer rank"
        self.comm.barrier()

    def _select_sharedfp(self):
        """Component choice, identical on every rank: forced var > auto
        (sm when every rank shares the host and the native atomics
        built — the sm/lockedfile split of ompi/mca/sharedfp).  The
        usable/host check is COLLECTIVE even when forced: a partially
        usable sm must fail uniformly, not strand peers in the open's
        bcast."""
        forced = var_registry.get("io_sharedfp") or ""
        if forced and forced not in ("sm", "lockedfile", "individual"):
            raise MPIException(
                f"unknown sharedfp component {forced!r} "
                f"(lockedfile/sm/individual)", error_class=3)
        keys = np.asarray(self.comm.allgather(np.array(
            [self._my_host_key(), 1 if _SmSharedFp.usable() else 0],
            np.int64))).reshape(-1, 2)
        sm_ok = (len(set(int(k) for k in keys[:, 0])) == 1
                 and int(keys[:, 1].min()) == 1)
        if forced == "individual":
            return _IndividualSharedFp(self.path)
        if forced == "sm":
            if not sm_ok:
                raise MPIException(
                    "io_sharedfp=sm forced but unusable (ranks span "
                    "hosts, or the native atomics did not build on "
                    "every rank)", error_class=3)
            return _SmSharedFp(self.path)
        if forced == "lockedfile":
            return _LockedFileSharedFp(self.path)
        return _SmSharedFp(self.path) if sm_ok \
            else _LockedFileSharedFp(self.path)

    # -- fs framework ------------------------------------------------------

    @classmethod
    def open(cls, comm, path: str, amode: int = MODE_RDONLY,
             info=None) -> "File":
        """≈ MPI_File_open — collective over comm.  Consulted ``info``
        hints: ``collective_buffering`` / ``romio_cb_write`` ("false"
        disables collective aggregation), ``cb_nodes`` (caps the
        aggregator count), ``fcoll`` (pins the collective component for
        this file).  Other hints are retrievable (MPI_File_get_info) but
        inert; global knobs live in the MCA registry (io_*)."""
        if amode & MODE_RDONLY and amode & (MODE_WRONLY | MODE_RDWR):
            raise MPIException("RDONLY combined with write mode",
                               error_class=3)
        f = cls(comm, path, amode)
        if info is not None:
            f.info = info
        return f

    def get_info(self):
        """≈ MPI_File_get_info."""
        return self.info

    def set_errhandler(self, eh) -> None:
        """≈ MPI_File_set_errhandler."""
        self.errhandler = eh

    def get_errhandler(self):
        return self.errhandler

    def close(self) -> None:
        """≈ MPI_File_close — collective."""
        if self._closed:
            return
        q = getattr(self, "_io_queue", None)
        if q is not None:      # drain + stop the nonblocking-IO worker
            q.put(None)
            self._io_thread.join(timeout=60.0)
            if self._io_thread.is_alive():
                # a queued collective IO op is stuck (e.g. a peer died
                # mid-collective).  Closing the fd now would hand the
                # worker a recycled descriptor — leak it instead and
                # surface the hang.
                self._closed = True
                raise MPIException(
                    f"MPI_File_close({self.path}): nonblocking-IO worker "
                    "still running after 60s — outstanding collective op "
                    "never completed (fd leaked, not closed)",
                    error_class=ERR_IO)
            self._io_queue = None
        self.sync()
        self.comm.barrier()
        os.close(self._fd)
        self._closed = True
        self._shfp.close(root=self.comm.rank == 0)
        if self.comm.rank == 0:
            if self.amode & MODE_DELETE_ON_CLOSE:
                try:
                    os.unlink(self.path)
                except OSError:
                    pass
        self.comm.barrier()
        self.comm.free()       # the private dup taken at open

    @staticmethod
    def delete(path: str) -> None:
        """≈ MPI_File_delete — local."""
        try:
            os.unlink(path)
        except OSError as e:
            raise MPIException(f"MPI_File_delete({path}): {e}",
                               error_class=ERR_IO) from None

    def set_size(self, size: int) -> None:
        """≈ MPI_File_set_size — collective."""
        self._check_open()
        if self.comm.rank == 0:
            os.ftruncate(self._fd, size)
        self.comm.barrier()

    def preallocate(self, size: int) -> None:
        """≈ MPI_File_preallocate — collective (grow-only truncate)."""
        self._check_open()
        if self.comm.rank == 0 and os.fstat(self._fd).st_size < size:
            os.ftruncate(self._fd, size)
        self.comm.barrier()

    def get_size(self) -> int:
        self._check_open()
        return os.fstat(self._fd).st_size

    def sync(self) -> None:
        """≈ MPI_File_sync.  With sharedfp/individual this is where the
        spooled shared-pointer writes land (collective merge) — callers
        of the individual component must treat sync as collective, which
        MPI requires of MPI_File_sync anyway."""
        self._check_open()
        self._shfp_merge()
        os.fsync(self._fd)

    def set_atomicity(self, flag: bool) -> None:
        self._atomicity = bool(flag)

    def get_atomicity(self) -> bool:
        return self._atomicity

    # -- view --------------------------------------------------------------

    def set_view(self, disp: int = 0, etype: Datatype = dt_mod.BYTE,
                 filetype: Optional[Datatype] = None,
                 datarep: str = "native") -> None:
        """≈ MPI_File_set_view — collective; resets both file pointers.
        ``datarep`` selects the file data representation: "native",
        "internal", "external32" (canonical big-endian), or a name
        registered with :func:`register_datarep`."""
        self._check_open()
        if datarep not in _datareps:
            self._err(MPIException(
                f"unknown datarep {datarep!r} (register_datarep first)",
                error_class=ERR_IO))
        self._shfp_merge()       # pending individual writes use the OLD view
        self.view = FileView(disp, etype, filetype)
        self._datarep = datarep
        self._pos = 0
        if getattr(self._shfp, "local_log", False):
            self._shfp.merged_end = 0
        elif not self._shfp_err:  # pointer unavailable (read-only mount):
            self._shfp_store(0)   # the reset is moot — only shared ops
        self.comm.barrier()       # would need it, and they raise anyway

    def get_view(self) -> tuple[int, Datatype, Datatype]:
        return self.view.disp, self.view.etype, self.view.filetype

    # -- individual IO (fbtl/posix equivalent) -----------------------------

    def _err(self, exc: MPIException) -> None:
        """Route through the file's errhandler (≈ invoking the handler
        installed by MPI_File_set_errhandler; raises unless swallowed)."""
        self.errhandler.invoke(self, exc)
        raise exc  # a swallowed file error still cannot proceed: the
        # access-mode/closed-fd condition persists

    def _check_open(self) -> None:
        if self._closed:
            self._err(MPIException("file is closed", error_class=ERR_IO))

    def _check_read(self) -> None:
        self._check_open()
        if self.amode & MODE_WRONLY:
            self._err(MPIException("file opened write-only",
                                   error_class=ERR_IO))

    def _check_write(self) -> None:
        self._check_open()
        if not self.amode & (MODE_WRONLY | MODE_RDWR):
            self._err(MPIException("file opened read-only",
                                   error_class=ERR_IO))

    def _as_bytes(self, data: Any):
        """User data → the byte stream the view consumes.  Returns a
        bytes-like object: a zero-copy memoryview of the caller's array
        when no conversion is needed (right dtype, C-contiguous, identity
        datarep — the plan-collapsed case), else materialized bytes.
        Callers only slice and hand it to pwrite/alltoallv within the
        call, so the view never outlives the caller's buffer (or, for a
        CUDA tensor, the host copy that staged it)."""
        staged = data if isinstance(data, _Staged) else _stage(data, False)
        arr = staged.arr
        if staged.bits:
            # bf16/float8 bits: the bytes ARE the data, whatever the etype
            arr = arr.reshape(-1).view(np.uint8)
        else:
            want = self.view.etype.base_np
            if arr.dtype != want:
                arr = arr.astype(want)
        wr = _datareps[getattr(self, "_datarep", "native")][1]
        if wr is None and arr.flags["C_CONTIGUOUS"]:
            return arr.reshape(-1).view(np.uint8).data
        raw = np.ascontiguousarray(arr).tobytes()
        return raw if wr is None else wr(raw, self.view.etype)

    def _from_bytes(self, raw: bytes) -> np.ndarray:
        rd = _datareps[getattr(self, "_datarep", "native")][0]
        if rd is not None:
            raw = rd(raw, self.view.etype)
        et = self.view.etype.base_np
        n = len(raw) // et.itemsize
        return np.frombuffer(bytearray(raw[:n * et.itemsize]),
                             dtype=et).copy()

    def read_at(self, offset: int, count: int) -> np.ndarray:
        """≈ MPI_File_read_at — offset/count in etype units of the view."""
        self._check_read()
        if trace_mod.active:
            with trace_mod.span("io", "read_at", rank=self.comm.pml.rank,
                                offset=offset,
                                nbytes=count * self.view.etype.size):
                return self._read_at_impl(offset, count)
        return self._read_at_impl(offset, count)

    def _read_at_impl(self, offset: int, count: int) -> np.ndarray:
        runs = self.view.byte_runs(offset, count * self.view.etype.size)
        rd = _datareps[getattr(self, "_datarep", "native")][0]
        if rd is None and len(runs) == 1 and hasattr(os, "preadv"):
            # plan-collapsed layout (contiguous view, or a single merged
            # run): ONE pread straight into the result array — skips the
            # bytes join + frombuffer + copy staging of the general path.
            # An EOF-short pread truncates the result, same as the
            # general path's short chunks.
            off, ln = runs[0]
            et = self.view.etype.base_np
            buf = np.empty(ln, np.uint8)
            got = os.preadv(self._fd, [memoryview(buf)], off)
            n = got // et.itemsize
            return buf[:n * et.itemsize].view(et)
        chunks = [os.pread(self._fd, ln, off) for off, ln in runs]
        return self._from_bytes(b"".join(chunks))

    def write_at(self, offset: int, data: Any) -> int:
        """≈ MPI_File_write_at — returns etypes written."""
        self._check_write()
        raw = self._as_bytes(data)
        if trace_mod.active:
            with trace_mod.span("io", "write_at", rank=self.comm.pml.rank,
                                offset=offset, nbytes=len(raw)):
                return self._write_raw_at(offset, raw)
        return self._write_raw_at(offset, raw)

    def _write_raw_at(self, offset: int, raw: bytes) -> int:
        runs = self.view.byte_runs(offset, len(raw))
        pos = 0
        for off, ln in runs:
            os.pwrite(self._fd, raw[pos:pos + ln], off)
            pos += ln
        return len(raw) // self.view.etype.size

    def _etypes_of(self, out: np.ndarray) -> int:
        """Etype count of a just-read element array (pointers advance in
        etype units, not base elements — they differ for derived etypes)."""
        return out.nbytes // self.view.etype.size

    def read(self, count: int) -> np.ndarray:
        """≈ MPI_File_read — individual pointer."""
        with self._io_lock:
            out = self.read_at(self._pos, count)
            self._pos += self._etypes_of(out)
        return out

    def write(self, data: Any) -> int:
        """≈ MPI_File_write — individual pointer."""
        with self._io_lock:
            n = self.write_at(self._pos, data)
            self._pos += n
        return n

    def seek(self, offset: int, whence: int = SEEK_SET) -> None:
        """≈ MPI_File_seek (etype units)."""
        with self._io_lock:
            if whence == SEEK_SET:
                self._pos = offset
            elif whence == SEEK_CUR:
                self._pos += offset
            elif whence == SEEK_END:
                self._pos = self.view.payload_bytes_up_to(
                    self.get_size()) // self.view.etype.size + offset
            else:
                raise MPIException(f"bad whence {whence}", error_class=3)

    def get_position(self) -> int:
        return self._pos

    # nonblocking variants: IO here is host-side and synchronous; MPI allows
    # immediate completion, so these return pre-completed requests (the
    # reference's ompio equally runs most iread/iwrite inline via progress)

    def iread_at(self, offset: int, count: int) -> Request:
        return CompletedRequest(self.read_at(offset, count), kind="iread")

    def iwrite_at(self, offset: int, data: Any) -> Request:
        return CompletedRequest(self.write_at(offset, data), kind="iwrite")

    def iread(self, count: int) -> Request:
        return CompletedRequest(self.read(count), kind="iread")

    def iwrite(self, data: Any) -> Request:
        return CompletedRequest(self.write(data), kind="iwrite")

    # -- nonblocking collective IO (≈ MPI_File_iread_all & co.) ------------
    #
    # The blocking collective runs on a per-file worker thread (one
    # thread, FIFO — issue order is completion order, the MPI requirement
    # for multiple outstanding collective IO ops on one handle).  All
    # ranks' workers meet inside the collective, so the caller's thread
    # never blocks — true split-phase, unlike the eager individual
    # i-ops above.

    def _io_async(self, kind: str, fn, *args) -> Request:
        import queue

        self._check_open()  # a post-close i-op must raise here, not
        # spawn a fresh worker that blocks on q.get() forever
        # a tensor may change (or its card stream move on) after the call
        # returns: its bytes are staged here, in the caller's thread
        args = tuple(_stage(a, True) if is_tensor(a) else a for a in args)
        q = getattr(self, "_io_queue", None)
        if q is None:
            q = self._io_queue = queue.Queue()

            def worker() -> None:
                while True:
                    item = q.get()
                    if item is None:
                        return
                    req, f, a = item
                    try:
                        req.complete(f(*a))
                    except BaseException as e:  # noqa: BLE001 — to waiter
                        req.fail(e)

            t = threading.Thread(target=worker, daemon=True,
                                 name=f"io-nbc-{os.path.basename(self.path)}")
            self._io_thread = t
            t.start()
        req = Request(kind=kind)
        q.put((req, fn, args))
        return req

    def _ordered_collective(self, kind: str, fn, *args):
        """Blocking collective ops go through the SAME FIFO as any
        outstanding nonblocking/split collective: MPI requires collective
        file ops on one handle to complete in issue order on every rank,
        and a caller-thread collective racing the worker's can invert
        order on some ranks only — cross-matching their fixed-tag
        traffic.  With no worker running, run inline (no queue spawn)."""
        if getattr(self, "_io_queue", None) is not None:
            return self._io_async(kind, fn, *args).wait()
        return fn(*args)

    def write_at_all(self, offset: int, data: Any) -> int:
        return self._ordered_collective(
            "write_at_all", self._write_at_all_impl, offset, data)

    def read_at_all(self, offset: int, count: int) -> np.ndarray:
        return self._ordered_collective(
            "read_at_all", self._read_at_all_impl, offset, count)

    def write_all(self, data: Any) -> int:
        return self._ordered_collective(
            "write_all", self._write_all_impl, data)

    def read_all(self, count: int) -> np.ndarray:
        return self._ordered_collective(
            "read_all", self._read_all_impl, count)

    def write_ordered(self, data: Any) -> int:
        return self._ordered_collective(
            "write_ordered", self._write_ordered_impl, data)

    def read_ordered(self, count: int) -> np.ndarray:
        return self._ordered_collective(
            "read_ordered", self._read_ordered_impl, count)

    def iread_all(self, count: int) -> Request:
        return self._io_async("iread_all", self._read_all_impl, count)

    def iwrite_all(self, data: Any) -> Request:
        return self._io_async("iwrite_all", self._write_all_impl, data)

    def iread_at_all(self, offset: int, count: int) -> Request:
        return self._io_async("iread_at_all", self._read_at_all_impl, offset,
                              count)

    def iwrite_at_all(self, offset: int, data: Any) -> Request:
        return self._io_async("iwrite_at_all", self._write_at_all_impl, offset,
                              data)

    def iread_shared(self, count: int) -> Request:
        return self._io_async("iread_shared", self.read_shared, count)

    def iwrite_shared(self, data: Any) -> Request:
        return self._io_async("iwrite_shared", self.write_shared, data)

    # -- split collectives (≈ MPI_File_read_all_begin/end family) ----------
    #
    # begin = issue the nonblocking collective; end = wait.  MPI allows at
    # most ONE outstanding split collective per file handle, and the end
    # call must match the begin kind.

    def _split_begin(self, kind: str, fn, *args) -> None:
        if getattr(self, "_split_req", None) is not None:
            self._err(MPIException(
                f"split collective {self._split_kind} already outstanding "
                f"on this file handle", error_class=ERR_IO))
        self._split_kind = kind
        self._split_req = self._io_async(kind, fn, *args)

    def _split_end(self, kind: str):
        req = getattr(self, "_split_req", None)
        if req is None or self._split_kind != kind:
            self._err(MPIException(
                f"{kind}_end without matching {kind}_begin",
                error_class=ERR_IO))
        self._split_req = None
        return req.wait()

    def read_all_begin(self, count: int) -> None:
        self._split_begin("read_all", self._read_all_impl, count)

    def read_all_end(self) -> np.ndarray:
        return self._split_end("read_all")

    def write_all_begin(self, data: Any) -> None:
        self._split_begin("write_all", self._write_all_impl, data)

    def write_all_end(self) -> int:
        return self._split_end("write_all")

    def read_at_all_begin(self, offset: int, count: int) -> None:
        self._split_begin("read_at_all", self._read_at_all_impl, offset, count)

    def read_at_all_end(self) -> np.ndarray:
        return self._split_end("read_at_all")

    def write_at_all_begin(self, offset: int, data: Any) -> None:
        self._split_begin("write_at_all", self._write_at_all_impl, offset, data)

    def write_at_all_end(self) -> int:
        return self._split_end("write_at_all")

    def read_ordered_begin(self, count: int) -> None:
        self._split_begin("read_ordered", self._read_ordered_impl, count)

    def read_ordered_end(self) -> np.ndarray:
        return self._split_end("read_ordered")

    def write_ordered_begin(self, data: Any) -> None:
        self._split_begin("write_ordered", self._write_ordered_impl, data)

    def write_ordered_end(self) -> int:
        return self._split_end("write_ordered")

    # -- handle inquiries (≈ file_get_amode.c & co.) -----------------------

    def get_amode(self) -> int:
        """≈ MPI_File_get_amode."""
        return self.amode

    def get_group(self):
        """≈ MPI_File_get_group: the group of the comm the file was
        opened on."""
        return self.comm.group

    def get_byte_offset(self, offset: int) -> int:
        """≈ MPI_File_get_byte_offset: view-relative offset (etype units)
        → absolute byte offset in the file."""
        runs = self.view.byte_runs(int(offset), self.view.etype.size)
        if not runs:
            return self.view.disp
        return runs[0][0]

    def get_type_extent(self, datatype: Datatype) -> int:
        """≈ MPI_File_get_type_extent: the datatype's extent in the file's
        current data representation (same-size representations here)."""
        return datatype.extent

    def set_info(self, info) -> None:
        """≈ MPI_File_set_info."""
        self.info = info

    # -- collective IO (the fcoll framework) -------------------------------
    #
    # ≈ ompi/mca/fcoll: selectable collective algorithms (individual /
    # two_phase / dynamic — the reference's fcoll components of the same
    # names) + OMPIO-style aggregator selection (one per host from the job
    # mapping, like cb_nodes defaulting to one aggregator per node).
    # Component choice: info hints > io_fcoll var > auto decision from the
    # allgathered access pattern (every rank computes the same answer from
    # the same collective data).

    @staticmethod
    def _stripe_bytes() -> int:
        """Configured stripe width with the registered default as the
        single fallback (shared by static routing, dynamic_gen2 bound
        snapping and the aggregator read coalescer)."""
        from ompi_tpu_torch.core.config import var_registry

        return int(var_registry.get("io_stripe_bytes")) or (1 << 20)

    def _my_host_key(self) -> int:
        """Stable host identity for aggregator grouping — THE single
        source (Communicator._my_host_key: shm BTL / split_type / IO all
        group by the same identity; tests override per-comm via
        ``comm._io_host_override``)."""
        return self.comm._my_host_key()

    def _aggregators(self) -> list[int]:
        """Aggregator ranks: the lowest ``io_cb_aggregators_per_host``
        ranks of each host (≈ OMPIO's one-aggregator-per-node default,
        mca_io_ompio_num_aggregators / cb_nodes).  The ``cb_nodes`` info
        hint caps the total.  Cached: the rank→host mapping is invariant
        for the communicator's lifetime, so the allgather runs once per
        file, not once per collective call."""
        cached = getattr(self, "_aggs_cache", None)
        if cached is not None:
            return cached
        from ompi_tpu_torch.core.config import var_registry

        comm = self.comm
        keys = np.asarray(comm.allgather(
            np.array([self._my_host_key()], np.int64))).ravel()
        per_host = int(var_registry.get("io_cb_aggregators_per_host") or 1)
        by_host: dict[int, list[int]] = {}
        for rank, k in enumerate(keys):
            by_host.setdefault(int(k), []).append(rank)
        aggs = sorted(r for ranks in by_host.values()
                      for r in ranks[:max(1, per_host)])
        cap = self.info.get("cb_nodes") if self.info else None
        if cap:
            try:
                aggs = aggs[:max(1, int(cap))]
            except ValueError:
                pass
        self._aggs_cache = aggs
        return aggs

    def _fcoll_component(self, my_nbytes: int, my_runs) -> str:
        """Pick individual | two_phase | dynamic | static | dynamic_gen2
        — identically on every rank (decision inputs are allgathered).
        Precedence: info hint (collective_buffering/romio_cb_write=
        disable → individual) > io_fcoll var > auto (≈ OMPIO's fcoll
        query: small or contiguous per-rank patterns go individual;
        on network filesystems stripe-aligned domains win — static for
        balanced loads, dynamic_gen2 for skewed; otherwise two_phase
        for balanced, dynamic for skewed)."""
        from ompi_tpu_torch.core.config import var_registry

        hint = ""
        if self.info:
            hint = (self.info.get("collective_buffering")
                    or self.info.get("romio_cb_write") or "")
        if str(hint).lower() in ("false", "disable", "0"):
            return "individual"
        forced = ""
        if self.info:
            forced = self.info.get("fcoll") or ""   # per-file pin
        forced = forced or var_registry.get("io_fcoll") or ""
        if forced:
            if forced not in ("individual", "two_phase", "dynamic",
                              "static", "dynamic_gen2"):
                raise MPIException(
                    f"unknown fcoll component {forced!r} (individual/"
                    f"two_phase/dynamic/static/dynamic_gen2)",
                    error_class=3)
            return forced
        if not var_registry.get("io_twophase"):
            return "individual"
        contig = 1 if (len(my_runs) <= 1) else 0
        stats = np.asarray(self.comm.allgather(np.array(
            [my_nbytes, contig], np.int64))).reshape(-1, 2)
        total = int(stats[:, 0].sum())
        # fs adaptation (≈ the fs framework's per-filesystem tuning,
        # fs_lustre.c): same answer on every rank — fs_type comes from
        # the shared path, and a split mount view would already break
        # shared-file IO in deeper ways
        adaptive = bool(var_registry.get("io_fs_adaptive"))
        if adaptive and self.fs_type in _FS_MEMORY:
            # memory-backed: every write is a memcpy — there is no seek
            # cost for aggregation to amortize, and the alltoallv
            # exchange costs more than the extra pwrite syscalls it
            # saves; individual IO wins for strided patterns too
            return "individual"
        min_bytes = int(var_registry.get("io_twophase_min_bytes"))
        if adaptive and self.fs_type in _FS_NETWORK:
            min_bytes = 1    # network fs: aggregate even small strided IO
        if total < min_bytes:
            return "individual"
        if int(stats[:, 1].min()) == 1:
            return "individual"   # everyone contiguous: direct IO wins
        nz = stats[:, 0][stats[:, 0] > 0]
        skewed = len(nz) and int(nz.max()) > 4 * int(nz.min())
        if adaptive and self.fs_type in _FS_NETWORK:
            # stripe-aligned domains keep each aggregator inside its own
            # filesystem stripes (the fcoll/static and dynamic_gen2
            # rationale: no two aggregators contend for one stripe lock)
            return "dynamic_gen2" if skewed else "static"
        if skewed:
            return "dynamic"      # skewed payloads → balance by bytes
        return "two_phase"

    def _domain_bounds(self, mode: str, my_runs, naggs: int
                       ) -> Optional[list[int]]:
        """Collective: ascending byte offsets b[0..naggs] partitioning
        the global extent into aggregator file domains.  two_phase =
        equal spans (fcoll/two_phase's static assignment); dynamic =
        equal *payload* per aggregator, boundaries derived from the
        allgathered run lists (fcoll/dynamic's data-driven domains).
        ``static`` routes cyclically by stripe (bounds only signal a
        non-empty extent); ``dynamic_gen2`` = dynamic's payload balance
        with every interior boundary snapped DOWN to a stripe multiple,
        so no two aggregator domains share a filesystem stripe (the
        fcoll/dynamic_gen2 refinement).  None ⇒ empty global extent."""
        comm = self.comm
        lo = my_runs[0][0] if my_runs else np.iinfo(np.int64).max
        hi = my_runs[-1][0] + my_runs[-1][1] if my_runs else 0
        ext = np.asarray(comm.allgather(np.array([lo, hi], np.int64)))
        glo, ghi = int(ext[:, 0].min()), int(ext[:, 1].max())
        if ghi <= glo:
            return None
        if mode not in ("dynamic", "dynamic_gen2"):
            dom = -(-(ghi - glo) // naggs)
            return [glo + i * dom for i in range(naggs)] + [ghi]
        # dynamic: payload-weighted boundaries need every rank's run
        # list — a ragged allgather (pad to the max count, like the
        # v-collectives' static-counts convention)
        flat = np.array([v for run in my_runs for v in run], np.int64)
        counts = np.asarray(comm.allgather(
            np.array([len(flat)], np.int64))).ravel()
        maxc = max(2, int(counts.max()))
        padded = np.zeros(maxc, np.int64)
        padded[:len(flat)] = flat
        stacked = np.asarray(comm.allgather(padded)).reshape(
            comm.size, maxc)
        runs: list[tuple[int, int]] = []
        for r in range(comm.size):
            arr = stacked[r, :int(counts[r])].reshape(-1, 2)
            runs.extend((int(o), int(ln)) for o, ln in arr)
        runs.sort()
        total = sum(ln for _, ln in runs)
        if total <= 0:
            return None
        share = -(-total // naggs)   # payload bytes per aggregator
        bounds = [glo]
        acc = 0
        for off, ln in runs:
            # place a boundary wherever cumulative payload crosses the
            # next share multiple (possibly several inside one long run)
            while acc + ln >= share * len(bounds) and len(bounds) < naggs:
                bounds.append(off + (share * len(bounds) - acc))
            acc += ln
        while len(bounds) < naggs:
            bounds.append(ghi)
        bounds.append(ghi)
        for i in range(1, len(bounds)):   # keep monotone under overlap
            bounds[i] = max(bounds[i], bounds[i - 1])
        if mode == "dynamic_gen2":
            stripe = self._stripe_bytes()
            for i in range(1, naggs):  # interior boundaries only
                bounds[i] = max(bounds[i] // stripe * stripe, bounds[0])
            for i in range(1, len(bounds)):
                bounds[i] = max(bounds[i], bounds[i - 1])
        return bounds

    def _route_to_aggregators(self, my_runs, bounds, aggs,
                              raw: Optional[bytes],
                              mode: str = "two_phase"):
        """Split my runs at domain boundaries and bucket (meta, payload)
        per destination rank.  raw=None ⇒ request-only (read path).
        ``static`` ignores the bounds partition and routes stripes
        round-robin: stripe k → aggregator k % naggs (fcoll/static's
        cyclic file domains).

        Also returns the ordered split sequence [(dest, take), …] — the
        read path's reassembly MUST walk the identical splits the
        requests were routed by, so the algorithm lives here once."""
        import bisect

        size = self.comm.size
        naggs = len(aggs)
        stripe = self._stripe_bytes() if mode == "static" else 0
        meta = [[] for _ in range(size)]
        payload = [[] for _ in range(size)] if raw is not None else None
        order: list[tuple[int, int]] = []

        # SPLIT phase, vectorized: most runs land whole inside one
        # domain/stripe — find the few that cross a boundary and expand
        # only those; the rest route with array math (a python loop per
        # run was the strided-view hot spot next to byte_runs)
        runs = np.asarray(my_runs, np.int64).reshape(-1, 2)
        offs, lens = runs[:, 0], runs[:, 1]
        if mode == "static":
            dom = offs // stripe
            dom_end = (dom + 1) * stripe
            idx = (dom % naggs).astype(np.int64)
        else:
            b = np.asarray(bounds, np.int64)
            idx = np.clip(np.searchsorted(b, offs, "right") - 1,
                          0, naggs - 1)
            dom_end = b[idx + 1]    # bounds has naggs+1 entries
        dom_end = np.maximum(dom_end, offs + 1)   # min take of 1
        crosses = offs + lens > dom_end
        if crosses.any():
            # expand crossing runs with the original per-run walk
            # (boundaries ≤ naggs, so crossers are few)
            exp_o, exp_l = [], []
            exp_i = []
            for off, ln in runs[crosses].tolist():
                while ln > 0:
                    if mode == "static":
                        i = (off // stripe) % naggs
                        de = (off // stripe + 1) * stripe
                    else:
                        i = min(max(bisect.bisect_right(bounds, off) - 1,
                                    0), naggs - 1)
                        de = (bounds[i + 1] if i + 1 < len(bounds)
                              else off + ln)
                    take = min(ln, max(de - off, 1))
                    exp_o.append(off)
                    exp_l.append(take)
                    exp_i.append(i)
                    off += take
                    ln -= take
            # stitch expanded pieces back in payload order
            pieces_o = [None] * len(runs)
            pieces_l = [None] * len(runs)
            pieces_i = [None] * len(runs)
            cross_rows = np.flatnonzero(crosses)
            keep_rows = np.flatnonzero(~crosses)
            for r in keep_rows.tolist():
                pieces_o[r] = [int(offs[r])]
                pieces_l[r] = [int(lens[r])]
                pieces_i[r] = [int(idx[r])]
            ci = 0
            for r in cross_rows.tolist():
                n_pieces = 0
                left = int(lens[r])
                while left > 0:
                    left -= exp_l[ci + n_pieces]
                    n_pieces += 1
                pieces_o[r] = exp_o[ci:ci + n_pieces]
                pieces_l[r] = exp_l[ci:ci + n_pieces]
                pieces_i[r] = exp_i[ci:ci + n_pieces]
                ci += n_pieces
            offs = np.array([o for p in pieces_o for o in p], np.int64)
            lens = np.array([v for p in pieces_l for v in p], np.int64)
            idx = np.array([v for p in pieces_i for v in p], np.int64)

        # BUCKET phase: runs arrive in payload order; per-destination
        # metadata is a boolean-mask gather and — when the view walks the
        # file monotonically (every nonpathological datatype) — each
        # domain's payload is ONE contiguous slice
        pay_pos = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
        dests = np.asarray(aggs, np.int64)[idx]
        order = list(zip(dests.tolist(), lens.tolist()))
        for d in np.unique(dests).tolist():
            rows = np.flatnonzero(dests == d)
            meta[d] = np.stack([offs[rows], lens[rows]], axis=1)
            if raw is not None:
                if len(rows) and np.array_equal(
                        rows, np.arange(rows[0], rows[0] + len(rows))):
                    lo = int(pay_pos[rows[0]])
                    hi = int(pay_pos[rows[-1] + 1])
                    payload[d] = [raw[lo:hi]]
                else:   # non-monotone view: per-run gather
                    payload[d] = [raw[int(pay_pos[r]):int(pay_pos[r + 1])]
                                  for r in rows.tolist()]
        return meta, payload, order

    def _write_at_all_impl(self, offset: int, data: Any) -> int:
        """≈ MPI_File_write_at_all — collective write through the
        selected fcoll component (ref: fcoll/two_phase/
        fcoll_two_phase_file_write_all.c, fcoll/dynamic)."""
        self._check_write()
        raw = self._as_bytes(data)
        if trace_mod.active:
            with trace_mod.span("io", "write_at_all",
                                rank=self.comm.pml.rank, offset=offset,
                                nbytes=len(raw)):
                return self._write_at_all_body(offset, raw)
        return self._write_at_all_body(offset, raw)

    def _write_at_all_body(self, offset: int, raw: bytes) -> int:
        my_runs = self.view.byte_runs(offset, len(raw))
        comp = self._fcoll_component(len(raw), my_runs)
        if comp == "individual":
            n = self._write_raw_at(offset, raw)
            self.comm.barrier()
            return n
        comm = self.comm
        size = comm.size
        aggs = self._aggregators()
        bounds = self._domain_bounds(comp, my_runs, len(aggs))
        if bounds is None:
            comm.barrier()
            return 0
        meta, payload, _order = self._route_to_aggregators(
            my_runs, bounds, aggs, raw, mode=comp)
        meta_arrs = [np.array(m, np.int64).reshape(-1, 2).ravel()
                     for m in meta]
        pay_arrs = [np.frombuffer(b"".join(p), np.uint8) for p in payload]
        got_meta = comm.alltoallv(meta_arrs)
        got_pay = comm.alltoallv(pay_arrs)
        # aggregation phase: maximal contiguous writes, rank order wins.
        # Vectorized when the incoming runs don't overlap (the only
        # MPI-legal case): scatter every source's payload into one
        # domain-span buffer with numpy indexing, then one pwrite per
        # contiguous group — no per-run python slicing.
        metas = [np.asarray(got_meta[r], np.int64).reshape(-1, 2)
                 for r in range(size)]
        pays = [np.asarray(got_pay[r], np.uint8) for r in range(size)]
        nonempty = [r for r in range(size) if len(metas[r])]
        if not nonempty:
            comm.barrier()
            return len(raw) // self.view.etype.size
        offs_all = np.concatenate([metas[r][:, 0] for r in nonempty])
        lens_all = np.concatenate([metas[r][:, 1] for r in nonempty])
        srt = np.argsort(offs_all, kind="stable")
        so, sl = offs_all[srt], lens_all[srt]
        no_overlap = bool(np.all(so[1:] >= so[:-1] + sl[:-1]))
        base = int(so[0])
        span = int(so[-1] + sl[-1]) - base
        total_pay = int(lens_all.sum())
        # the span buffer trades memory for vectorized assembly — only a
        # good trade while it stays payload-sized (a SPARSE view's domain
        # can span orders of magnitude more file than it touches; there
        # the per-run path's payload-proportional memory wins)
        if no_overlap and span <= max(4 * total_pay, 1 << 20):
            buf = np.empty(span, np.uint8)
            for r in nonempty:
                m, p = metas[r], pays[r]
                L = int(m[0, 1]) if len(m) else 0
                if len(m) >= 16 and L <= 65536 and (m[:, 1] == L).all():
                    # many small uniform runs: one fancy scatter beats
                    # len(m) python slice assignments (the index temp is
                    # 8x payload, bounded by the small-L gate)
                    gidx = ((m[:, 0] - base)[:, None]
                            + np.arange(L, dtype=np.int64)[None, :])
                    buf[gidx.reshape(-1)] = p[:len(m) * L]
                else:
                    cur = 0
                    for foff, fln in m.tolist():
                        buf[foff - base:foff - base + fln] = \
                            p[cur:cur + fln]
                        cur += fln
            # contiguous groups of the sorted runs → one pwrite each
            brk = np.empty(len(so), bool)
            brk[0] = True
            np.not_equal(so[1:], so[:-1] + sl[:-1], out=brk[1:])
            gi = np.flatnonzero(brk)
            gends = np.append(gi[1:], len(so)) - 1
            mv = memoryview(buf)
            for lo, hi in zip(so[gi].tolist(),
                              (so[gends] + sl[gends]).tolist()):
                os.pwrite(self._fd, mv[lo - base:hi - base], lo)
        else:   # sparse domain (span ≫ payload) or overlapping writes
            # (erroneous per MPI): the original payload-proportional
            # rank-order aggregation
            agg: list[tuple[int, int, bytes]] = []
            for r in nonempty:
                p = pays[r].tobytes()
                cur = 0
                for foff, fln in metas[r].tolist():
                    agg.append((foff, fln, p[cur:cur + fln]))
                    cur += fln
            for off, abuf in _coalesce(agg):
                os.pwrite(self._fd, abuf, off)
        comm.barrier()
        return len(raw) // self.view.etype.size

    def _read_at_all_impl(self, offset: int, count: int) -> np.ndarray:
        """≈ MPI_File_read_at_all — collective read through the selected
        fcoll component."""
        self._check_read()
        if trace_mod.active:
            with trace_mod.span("io", "read_at_all",
                                rank=self.comm.pml.rank, offset=offset,
                                nbytes=count * self.view.etype.size):
                return self._read_at_all_body(offset, count)
        return self._read_at_all_body(offset, count)

    def _read_at_all_body(self, offset: int, count: int) -> np.ndarray:
        nbytes = count * self.view.etype.size
        my_runs = self.view.byte_runs(offset, nbytes)
        comp = self._fcoll_component(nbytes, my_runs)
        if comp == "individual":
            out = self.read_at(offset, count)
            self.comm.barrier()
            return out
        comm = self.comm
        size = comm.size
        aggs = self._aggregators()
        bounds = self._domain_bounds(comp, my_runs, len(aggs))
        if bounds is None:
            comm.barrier()
            return self._from_bytes(b"")
        meta, _pay, order = self._route_to_aggregators(
            my_runs, bounds, aggs, None, mode=comp)
        meta_arrs = [np.array(m, np.int64).reshape(-1, 2).ravel()
                     for m in meta]
        got_meta = comm.alltoallv(meta_arrs)
        # aggregators read each requested run once (coalesced pread over
        # their domain slice) and reply per requester; a pread can come
        # up short at EOF, so a reply may be shorter than requested
        import bisect as _bisect

        # bounds-partitioned modes keep the single span pread per
        # requester (runs inside one contiguous domain — one syscall
        # beats many tiny ones); static's cyclic domains cap the merge
        # gap at one stripe so an aggregator doesn't read the whole
        # extent to serve every naggs-th stripe of it
        merge_gap = self._stripe_bytes() if comp == "static" else None
        replies = []
        for r in range(size):
            m = np.asarray(got_meta[r], np.int64).reshape(-1, 2)
            if not len(m):
                replies.append(np.empty(0, np.uint8))
                continue
            offs_, lens_ = m[:, 0], m[:, 1]
            # interval merge, vectorized (sort + running max of ends)
            srt = np.argsort(offs_, kind="stable")
            so, se = offs_[srt], offs_[srt] + lens_[srt]
            cme = np.maximum.accumulate(se)
            if merge_gap is None:
                blocks = [(int(so[0]), int(cme[-1]))]
            else:
                newb = np.empty(len(so), bool)
                newb[0] = True
                np.greater_equal(so[1:], cme[:-1] + merge_gap,
                                 out=newb[1:])
                gi = np.flatnonzero(newb)
                ends = np.append(gi[1:], len(so)) - 1
                blocks = list(zip(so[gi].tolist(),
                                  cme[ends].tolist()))
            data = {blo: os.pread(self._fd, bhi - blo, blo)
                    for blo, bhi in blocks}
            if len(blocks) == 1:
                blo, bhi = blocks[0]
                blob = data[blo]
                arr = np.frombuffer(blob, np.uint8)
                L = int(lens_[0]) if lens_.size else 0
                if (len(blob) == bhi - blo and len(lens_) >= 16
                        and L <= 65536 and (lens_ == L).all()):
                    # many small uniform runs, nothing EOF-short: one
                    # fancy gather replaces the per-run python slicing
                    # (same L gate as the write scatter — for few/large
                    # runs the slice loop below is cheaper)
                    gidx = ((offs_ - blo)[:, None]
                            + np.arange(L, dtype=np.int64)[None, :])
                    replies.append(arr[gidx.reshape(-1)])
                    continue
            starts = [b[0] for b in blocks]
            parts = []
            for o, ln in m.tolist():
                blo = blocks[_bisect.bisect_right(starts, o) - 1][0]
                blob = data[blo]   # may be EOF-short: slice shortens
                parts.append(blob[o - blo:o - blo + ln])
            replies.append(np.frombuffer(b"".join(parts), np.uint8))
        got_pay = comm.alltoallv(replies)
        # reassemble in my original run order by replaying the SAME split
        # sequence the requests were routed by (aggregators preserve
        # request order).  EOF truncation shortens exactly a greedy
        # suffix of an aggregator's ascending runs, so the per-run actual
        # length is derivable from what remains of the reply blob.
        blobs = [np.asarray(got_pay[r], np.uint8).tobytes()
                 for r in range(size)]
        dests_arr = np.array([d for d, _ in order], np.int64)
        takes_arr = np.array([t for _, t in order], np.int64)
        grouped = (len(dests_arr) == 0
                   or (np.count_nonzero(np.diff(dests_arr)) + 1
                       == len(np.unique(dests_arr))))
        full = all(len(blobs[d])
                   == int(takes_arr[dests_arr == d].sum())
                   for d in np.unique(dests_arr).tolist())
        if grouped and full:
            # monotone view, no EOF truncation: each destination owns one
            # consecutive span of the split order, so the output is its
            # blobs concatenated in first-appearance order
            seen: dict[int, bool] = {}
            for d in dests_arr.tolist():
                seen.setdefault(d, True)
            out = bytearray(b"".join(blobs[d] for d in seen))
        else:
            cursors = [0] * size
            out = bytearray()
            for dest, take in order:
                got = min(take, max(0, len(blobs[dest]) - cursors[dest]))
                out += blobs[dest][cursors[dest]:cursors[dest] + got]
                cursors[dest] += got
        comm.barrier()
        return self._from_bytes(bytes(out))

    def _write_all_impl(self, data: Any) -> int:
        """≈ MPI_File_write_all (individual pointer + collective)."""
        with self._io_lock:
            n = self._write_at_all_impl(self._pos, data)
            self._pos += n
        return n

    def _read_all_impl(self, count: int) -> np.ndarray:
        """≈ MPI_File_read_all."""
        with self._io_lock:
            out = self._read_at_all_impl(self._pos, count)
            self._pos += self._etypes_of(out)
        return out

    # -- shared file pointer (sharedfp/lockedfile equivalent) --------------

    def _shfp_guard(self) -> None:
        if self._shfp_err:
            raise MPIException(
                f"shared file pointer unavailable: the "
                f"{self._shfp.name} component could not be set up at "
                f"open ({self._shfp_err})", error_class=ERR_IO)

    def _shfp_load(self) -> int:
        self._shfp_guard()
        return self._shfp.load()

    def _shfp_store(self, val: int) -> None:
        self._shfp_guard()
        self._shfp.store(val)

    def _shfp_fetch_add(self, n: int) -> int:
        """Atomically reserve n etypes of the shared pointer."""
        self._shfp_guard()
        return self._shfp.fetch_add(n)

    def _shfp_merge(self) -> None:
        """COLLECTIVE: the 'collaborate' step of sharedfp/individual —
        reconstruct the global shared-pointer order of the individually
        spooled writes (timestamp order, rank breaking ties) and land
        them in the file.  Runs at sync/close, before ordered ops, and
        before a view change (pending writes belong to the OLD view).
        No-op for the coordinated components."""
        sh = self._shfp
        if not getattr(sh, "local_log", False) or self._shfp_err:
            return
        recs = sh._recs
        mine = (np.array(recs, np.int64) if recs
                else np.zeros((0, 2), np.int64))
        allrecs = self.comm.allgatherv(mine)
        entries = []   # (t_ns, rank, local_idx, nbytes)
        for r, arr in enumerate(allrecs):
            a = np.asarray(arr).reshape(-1, 2)
            for i in range(a.shape[0]):
                entries.append((int(a[i, 0]), r, i, int(a[i, 1])))
        if not entries:
            return
        entries.sort()
        es = self.view.etype.size
        pos = sh.merged_end
        my_offsets = {}
        for _t, r, i, nb in entries:
            if r == self.comm.rank:
                my_offsets[i] = pos
            pos += nb // es
        if recs:
            sh._spool.seek(0)
            for i, (_t, nb) in enumerate(recs):
                raw = sh._spool.read(nb)
                self._write_raw_at(my_offsets[i], raw)
            sh._spool.seek(0)
            sh._spool.truncate()
            sh._recs = []
        sh.merged_end = pos
        self.comm.barrier()

    def read_shared(self, count: int) -> np.ndarray:
        """≈ MPI_File_read_shared."""
        self._check_read()  # before reserving: a failed call must not
        start = self._shfp_fetch_add(count)  # advance the shared pointer
        return self.read_at(start, count)

    def write_shared(self, data: Any) -> int:
        """≈ MPI_File_write_shared."""
        self._check_write()
        raw = self._as_bytes(data)
        n = len(raw) // self.view.etype.size
        if getattr(self._shfp, "local_log", False):
            self._shfp_guard()
            self._shfp.log_write(raw)   # local spool; lands at the merge
            return n
        start = self._shfp_fetch_add(n)
        self._write_raw_at(start, raw)
        return n

    def seek_shared(self, offset: int, whence: int = SEEK_SET) -> None:
        """≈ MPI_File_seek_shared — collective (all must give same args)."""
        self._check_open()
        if getattr(self._shfp, "local_log", False):
            # raise UNIFORMLY before any collective step: with
            # sharedfp/individual a rank-0-only raise inside the body
            # would strand the other ranks in the closing barrier
            raise self._shfp._unsupported()
        if whence == SEEK_CUR:
            offset += self._shfp_load()
        elif whence == SEEK_END:
            offset += self.view.payload_bytes_up_to(
                self.get_size()) // self.view.etype.size
        elif whence != SEEK_SET:
            raise MPIException(f"bad whence {whence}", error_class=3)
        if self.comm.rank == 0:
            self._shfp_store(offset)
        self.comm.barrier()

    def get_position_shared(self) -> int:
        return self._shfp_load()

    # ordered mode: rank-ordered slots computed with an exscan of sizes

    def _ordered_base(self) -> tuple[int, bool]:
        """Start position for an ordered op: the coordinated components
        read the live pointer; sharedfp/individual first lands its
        pending spooled writes (the op is collective, so the merge is
        safe here) and uses the agreed merged end."""
        if getattr(self._shfp, "local_log", False):
            self._shfp_merge()
            self._shfp_guard()
            return self._shfp.merged_end, True
        return self._shfp_load(), False

    def _write_ordered_impl(self, data: Any) -> int:
        """≈ MPI_File_write_ordered — collective, rank order in file."""
        self._check_write()
        raw = self._as_bytes(data)
        n = len(raw) // self.view.etype.size
        sizes = np.asarray(self.comm.allgather(np.array([n], np.int64)))
        base, individual = self._ordered_base()
        my_off = base + int(sizes[:self.comm.rank].sum())
        self._write_raw_at(my_off, raw)
        self.comm.barrier()
        if individual:
            self._shfp.merged_end = base + int(sizes.sum())
        elif self.comm.rank == 0:
            self._shfp_store(base + int(sizes.sum()))
        self.comm.barrier()
        return n

    def _read_ordered_impl(self, count: int) -> np.ndarray:
        """≈ MPI_File_read_ordered."""
        self._check_read()
        sizes = np.asarray(self.comm.allgather(np.array([count], np.int64)))
        base, individual = self._ordered_base()
        my_off = base + int(sizes[:self.comm.rank].sum())
        out = self.read_at(my_off, count)
        self.comm.barrier()
        if individual:
            self._shfp.merged_end = base + int(sizes.sum())
        elif self.comm.rank == 0:
            self._shfp_store(base + int(sizes.sum()))
        self.comm.barrier()
        return out

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        return f"File({self.path!r}, amode={self.amode:#x})"
