"""Snapshot storage: central and staged layouts (the port's copy of the
JAX package's ``ckpt/store.py``; its files are the same files).

≈ orte/mca/sstore — the `central` component (every rank writes straight
into the shared snapshot root) and the `stage` component (ranks write to
fast node-local storage first; a filem/raw-equivalent *stage* step then
moves the file into the central root).

Layout (one job root, monotonically numbered snapshots):

    <base>/<job>/snapshot_<seq>/rank_<r>.npz      per-rank array shards
    <base>/<job>/snapshot_<seq>/metadata.json     written LAST by rank 0

The metadata file is the commit record (two-phase: a snapshot without it
is garbage and is ignored/cleaned) — the same "all ranks report, then the
coordinator marks the snapshot valid" protocol snapc/full runs over its
RML channels.

The format is byte-compatible with the JAX package's, so either package
reads the other's snapshots: the same npz per rank, the same keys, the
same ``metadata.json`` (seq, nranks, time, status and the caller's extra
fields), and the same sidecar dtype manifest for the dtypes numpy has no
name for.  The JAX package writes bfloat16 and float8 arrays (ml_dtypes)
as raw ``|V2``/``|V1`` void arrays and names their dtype in the manifest;
the port does the same without ml_dtypes: a bf16 tensor's bits are viewed
as int16 and then as ``V2`` to write, and viewed back into
``torch.bfloat16`` on load.

``write_rank`` takes torch tensors on any device, numpy arrays and
scalars.  ``load_rank`` returns numpy arrays, as the JAX package's does,
for every dtype numpy has; only the dtypes numpy cannot name without
ml_dtypes (bfloat16, float8) come back as CPU tensors of that dtype, and
only then is torch imported, so a host-plane rank that saves and loads
numpy data never loads torch.  The caller moves a leaf to the card with
an explicit ``torch.as_tensor(x).to(device)``.

``ShardedSnapshotStore`` writes ONE file per array through collective
MPI-IO (``mpi.io``): ``<name>.bin`` holds every rank's block at its byte
offset, and rank 0's ``metadata.json`` (``layout: "sharded-file"``)
records each block's offset, byte count, shape and dtype name.  The dtype
name of a bf16 or float8 tensor is the JAX package's (``"bfloat16"``),
so either package reads the other's sharded snapshots.  A CUDA tensor
leaves the card in one device-to-host copy per array.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from typing import Any, Optional

import numpy as np

from ompi_tpu_torch.core.buffer import BITS_DTYPE, is_tensor
from ompi_tpu_torch.mpi.constants import ERR_IO, MPIException

__all__ = ["SnapshotStore", "StagedStore", "ShardedSnapshotStore"]

_META = "metadata.json"

# npz serializes ml_dtypes arrays (bfloat16, float8_*) as raw void —
# bytes survive but the dtype name is dropped (loads back as |V2).
# Record the true dtype of such arrays in a SIDECAR MANIFEST entry
# (user keys are never renamed, so no user key can ever be
# misinterpreted or collide) and view the bytes back on load.
_DTYPE_MANIFEST = "__ompi_tpu_dtype_manifest__"

#: the dtypes numpy has no name for without ml_dtypes: their manifest name
#: → the integer of their width, whose bits they travel as
_EXOTIC = BITS_DTYPE


def _to_host(v: Any) -> tuple[np.ndarray, Optional[str]]:
    """(numpy array, manifest dtype name or None) of one state value."""
    if is_tensor(v):
        import torch

        # contiguous on the tensor's own device, then one copy to the host
        t = v.detach().contiguous().cpu()
        name = str(t.dtype).removeprefix("torch.")
        if name in _EXOTIC:
            arr = t.view(getattr(torch, _EXOTIC[name])).numpy()
            return arr.view(f"V{arr.dtype.itemsize}"), name
        return t.numpy(), None
    arr = np.asarray(v)
    if arr.dtype.kind == "V" and arr.dtype.names is None:
        try:   # an ml_dtypes array of the caller's: its name parses back
            if np.dtype(arr.dtype.name) == arr.dtype:
                return arr, arr.dtype.name
        except TypeError:
            pass   # plain void ('V4' etc.): stored raw
    return arr, None


def _tag_exotic(state: dict) -> dict:
    if _DTYPE_MANIFEST in state:
        raise MPIException(
            f"checkpoint key {_DTYPE_MANIFEST!r} is reserved for the "
            f"store's dtype manifest — rename it", error_class=ERR_IO)
    arrays, mapping = {}, {}
    for k, v in state.items():
        arrays[k], name = _to_host(v)
        if name is not None:
            mapping[k] = name
    if mapping:
        arrays[_DTYPE_MANIFEST] = np.array(json.dumps(mapping))
    return arrays


def _restored(arr: np.ndarray, name: Optional[str], key: str):
    """``arr`` as it was saved: the numpy array itself, or, when the
    manifest names a dtype numpy has no name for (bf16, float8), a CPU
    tensor of that dtype over the same bytes (torch is imported only
    then)."""
    if name is None:
        return arr
    if name not in _EXOTIC or arr.dtype.kind != "V":
        raise MPIException(
            f"restoring checkpoint array {key!r} as dtype {name!r}: "
            f"not a dtype the port knows, or not raw bytes "
            f"({arr.dtype})", error_class=ERR_IO)
    return _exotic_tensor(arr, name, key)


def _exotic_tensor(arr: np.ndarray, name: str, key: str):
    """A CPU tensor of dtype ``name`` (one of ``_EXOTIC``) over the bytes
    of ``arr``."""
    import torch

    bits = _EXOTIC[name]
    if arr.dtype.itemsize != np.dtype(bits).itemsize:
        raise MPIException(
            f"restoring checkpoint array {key!r} as dtype {name!r}: "
            f"{arr.dtype.itemsize}-byte elements", error_class=ERR_IO)
    # np.require keeps a 0-d array 0-d (ascontiguousarray would not)
    return torch.from_numpy(np.require(arr, requirements="C").view(
        bits)).view(getattr(torch, name))


def _untag_exotic(npz) -> dict:
    files = [k for k in npz.files if k != _DTYPE_MANIFEST]
    mapping: dict = {}
    if _DTYPE_MANIFEST in npz.files:
        try:
            mapping = json.loads(str(npz[_DTYPE_MANIFEST][()]))
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise MPIException(
                f"corrupt checkpoint dtype manifest: {e}",
                error_class=ERR_IO) from None
    return {k: _restored(npz[k], mapping.get(k), k) for k in files}


class SnapshotStore:
    """sstore/central: ranks write directly into the shared root."""

    def __init__(self, base_dir: str, job: str = "job") -> None:
        self.base = os.path.join(os.path.abspath(base_dir), job)
        os.makedirs(self.base, exist_ok=True)

    # -- paths -------------------------------------------------------------

    def snapshot_dir(self, seq: int) -> str:
        return os.path.join(self.base, f"snapshot_{seq}")

    def _rank_file(self, seq: int, rank: int) -> str:
        return os.path.join(self.snapshot_dir(seq), f"rank_{rank}.npz")

    # -- write path --------------------------------------------------------

    def write_rank(self, seq: int, rank: int,
                   state: dict[str, Any]) -> str:
        """Serialize one rank's state dict (atomic: tmp file + rename)."""
        d = self.snapshot_dir(seq)
        os.makedirs(d, exist_ok=True)
        arrays = _tag_exotic(state)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **arrays)
            os.replace(tmp, self._rank_file(seq, rank))
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return self._rank_file(seq, rank)

    def commit(self, seq: int, nranks: int,
               extra: Optional[dict] = None) -> None:
        """The coordinator's commit record — written only after every rank
        has reported success (two-phase; ≈ snapc marking the global
        snapshot valid)."""
        missing = [r for r in range(nranks)
                   if not os.path.exists(self._rank_file(seq, r))]
        if missing:
            raise MPIException(
                f"commit of snapshot {seq}: rank files missing for "
                f"{missing}", error_class=ERR_IO)
        meta = {"seq": seq, "nranks": nranks, "time": time.time(),
                "status": "committed"}
        if extra:
            meta.update(extra)
        tmp = os.path.join(self.snapshot_dir(seq), _META + ".tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, os.path.join(self.snapshot_dir(seq), _META))

    # -- read path ---------------------------------------------------------

    def metadata(self, seq: int) -> Optional[dict]:
        try:
            with open(os.path.join(self.snapshot_dir(seq), _META)) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return None

    def _seqs(self) -> list[int]:
        """Every snapshot directory's seq, committed or not."""
        try:
            names = os.listdir(self.base)
        except OSError:
            return []
        out = []
        for n in names:
            if n.startswith("snapshot_"):
                try:
                    out.append(int(n.split("_", 1)[1]))
                except ValueError:
                    continue
        return out

    def snapshots(self) -> list[int]:
        """All *committed* snapshot seqs, ascending."""
        return sorted(s for s in self._seqs()
                      if self.metadata(s) is not None)

    def latest(self) -> Optional[int]:
        s = self.snapshots()
        return s[-1] if s else None

    def load_rank(self, seq: int, rank: int) -> dict[str, Any]:
        """One rank's state: numpy arrays (CPU tensors for bf16 and
        float8, which numpy cannot name)."""
        if self.metadata(seq) is None:
            raise MPIException(
                f"snapshot {seq} is not committed", error_class=ERR_IO)
        try:
            with np.load(self._rank_file(seq, rank)) as z:
                return _untag_exotic(z)
        except OSError as e:
            raise MPIException(
                f"loading snapshot {seq} rank {rank}: {e}",
                error_class=ERR_IO) from None

    # -- lifecycle ---------------------------------------------------------

    def gc(self, keep_last: int) -> list[int]:
        """Drop old committed snapshots (and any uncommitted debris) —
        keep the newest `keep_last`. Returns removed seqs."""
        committed = self.snapshots()
        drop = committed[:-keep_last] if keep_last > 0 else committed
        removed = []
        for seq in drop:
            shutil.rmtree(self.snapshot_dir(seq), ignore_errors=True)
            removed.append(seq)
        # uncommitted debris older than the newest committed snapshot
        newest = committed[-1] if committed else None
        for seq in self._seqs():
            if (self.metadata(seq) is None and newest is not None
                    and seq < newest):
                shutil.rmtree(self.snapshot_dir(seq), ignore_errors=True)
                removed.append(seq)
        return removed


class StagedStore(SnapshotStore):
    """sstore/stage + filem/raw: write node-local first, then stage the
    finished file into the central root with an atomic move (same-fs) or
    copy+rename (cross-fs)."""

    def __init__(self, base_dir: str, local_dir: str,
                 job: str = "job") -> None:
        super().__init__(base_dir, job)
        self.local = os.path.abspath(local_dir)
        os.makedirs(self.local, exist_ok=True)

    def write_rank(self, seq: int, rank: int,
                   state: dict[str, Any]) -> str:
        arrays = _tag_exotic(state)
        local_path = os.path.join(self.local,
                                  f"stage_{seq}_rank_{rank}.npz")
        with open(local_path, "wb") as f:
            np.savez(f, **arrays)
        # filem/raw stage: move into the central snapshot dir
        d = self.snapshot_dir(seq)
        os.makedirs(d, exist_ok=True)
        dst = self._rank_file(seq, rank)
        try:
            os.replace(local_path, dst)
        except OSError:  # cross-filesystem: copy then atomic rename
            tmp = dst + ".tmp"
            shutil.copyfile(local_path, tmp)
            os.replace(tmp, dst)
            os.unlink(local_path)
        return dst


class ShardedSnapshotStore(SnapshotStore):
    """Single-file sharded checkpoints over collective MPI-IO.

    Where :class:`SnapshotStore` writes one ``rank_<r>.npz`` per rank
    (the reference's sstore/central file-per-proc layout), this store
    writes ONE file per array: each rank's block lands at its byte
    displacement through an MPI file view, and the write is a collective
    ``write_at_all`` — so it flows through the fcoll aggregation layer
    (on multi-host jobs: one OS writer per host, per the job mapping)
    instead of N independent OS streams.

    Blocks may be ragged in SHAPE (per-rank shapes are allgathered and
    recorded in the commit metadata, so ``load`` returns exactly the
    block this rank saved — or any requested rank's block after a
    respawn); the DTYPE of each named array must agree across ranks,
    validated collectively at save time.  ``load`` returns what
    ``load_rank`` of :class:`SnapshotStore` does: numpy arrays, and CPU
    tensors for bf16 and float8.
    """

    #: numpy's own limit is 32; the allgathered shape record carries 16
    MAX_NDIM = 16

    def __init__(self, base_dir: str, comm, job: str = "job") -> None:
        super().__init__(base_dir, job)
        self.comm = comm

    def _array_file(self, seq: int, name: str) -> str:
        if "/" in name or name.startswith("."):
            raise MPIException(f"bad array name {name!r}", error_class=3)
        return os.path.join(self.snapshot_dir(seq), f"{name}.bin")

    def write_rank(self, seq: int, rank: int, state: dict[str, Any]) -> str:
        raise MPIException(
            "ShardedSnapshotStore is collective — use save(seq, state) "
            "(the per-rank write_rank/commit protocol belongs to the "
            "file-per-rank stores)", error_class=3)

    def commit(self, seq: int, nranks: int,
               extra: Optional[dict] = None) -> None:
        raise MPIException(
            "ShardedSnapshotStore commits inside save()", error_class=3)

    def save(self, seq: int, state: dict[str, Any],
             extra: Optional[dict] = None) -> None:
        """Collective: every rank passes its LOCAL block per array name;
        blocks are concatenated in rank order in one shared file each.
        Rank 0 writes the commit record after all writes complete."""
        import zlib

        from ompi_tpu_torch.mpi import io as mio
        from ompi_tpu_torch.mpi.info import Info

        comm = self.comm
        # validate BEFORE the first collective: a raise after peers have
        # entered an allgather would strand them
        arrays, dtypes = {}, {}
        for name in sorted(state):
            host, exotic = _to_host(state[name])
            arr = np.ascontiguousarray(host)
            if arr.ndim > self.MAX_NDIM:
                raise MPIException(
                    f"array {name!r} has ndim {arr.ndim} > "
                    f"{self.MAX_NDIM} (shape-record limit)", error_class=3)
            arrays[name] = arr
            dtypes[name] = exotic or str(arr.dtype)
        d = self.snapshot_dir(seq)
        if comm.rank == 0:
            os.makedirs(d, exist_ok=True)
        comm.barrier()
        # the store's point is the aggregated shared-file write path, so
        # pin the collective component (the auto decision would classify
        # each rank's single contiguous run as individual IO)
        hints = Info({"fcoll": "two_phase"})
        shards_meta: dict[str, list] = {}
        for name, arr in arrays.items():
            # allgather per-rank (nbytes, ndim, shape…, dtype-crc)
            shp = np.zeros(2 + self.MAX_NDIM + 1, np.int64)
            shp[0] = arr.nbytes
            shp[1] = arr.ndim
            shp[2:2 + arr.ndim] = arr.shape
            shp[-1] = zlib.crc32(dtypes[name].encode())
            allm = np.asarray(comm.allgather(shp)).reshape(
                comm.size, len(shp))
            if len(set(int(c) for c in allm[:, -1])) != 1:
                raise MPIException(
                    f"array {name!r}: dtype differs across ranks "
                    f"(blocks may be ragged in shape, not dtype)",
                    error_class=3)
            offs = np.concatenate([[0], np.cumsum(allm[:, 0])])
            f = mio.File.open(comm, self._array_file(seq, name),
                              mio.MODE_RDWR | mio.MODE_CREATE,
                              info=hints)
            f.set_view(disp=int(offs[comm.rank]))
            f.write_at_all(0, arr.reshape(-1).view(np.uint8))
            f.close()
            shards_meta[name] = [{
                "rank": r,
                "offset": int(offs[r]),
                "nbytes": int(allm[r, 0]),
                "shape": [int(s) for s in
                          allm[r, 2:2 + int(allm[r, 1])]],
                "dtype": dtypes[name],
            } for r in range(comm.size)]
        comm.barrier()
        if comm.rank == 0:
            meta = {"seq": seq, "nranks": comm.size, "time": time.time(),
                    "status": "committed", "layout": "sharded-file",
                    "arrays": shards_meta}
            if extra:
                meta.update(extra)
            tmp = os.path.join(d, _META + ".tmp")
            with open(tmp, "w") as fh:
                json.dump(meta, fh)
            os.replace(tmp, os.path.join(d, _META))
        comm.barrier()

    def load(self, seq: int, rank: Optional[int] = None) -> dict[str, Any]:
        """Collective read of each rank's own block (``rank`` overrides,
        e.g. a revived rank pulling its predecessor's shard).  Routed
        through read_at_all so aggregators coalesce the disk reads."""
        from ompi_tpu_torch.mpi import io as mio
        from ompi_tpu_torch.mpi.info import Info

        meta = self.metadata(seq)
        if meta is None:
            raise MPIException(
                f"snapshot {seq} is not committed", error_class=ERR_IO)
        r = self.comm.rank if rank is None else int(rank)
        out: dict[str, Any] = {}
        hints = Info({"fcoll": "two_phase"})
        for name, shards in meta["arrays"].items():
            rec = shards[r]
            f = mio.File.open(self.comm, self._array_file(seq, name),
                              mio.MODE_RDONLY, info=hints)
            f.set_view(disp=rec["offset"])
            raw = f.read_at_all(0, rec["nbytes"])
            f.close()
            # a read returns a fresh array: view its bytes, no copy
            raw = np.ascontiguousarray(raw).view(np.uint8)
            dtype = rec["dtype"]
            if dtype in _EXOTIC:
                out[name] = _exotic_tensor(
                    raw.view(_EXOTIC[dtype]).reshape(rec["shape"]), dtype,
                    name)
            else:
                out[name] = raw.view(np.dtype(dtype)).reshape(rec["shape"])
        return out

    def load_rank(self, seq: int, rank: int) -> dict[str, Any]:
        """SnapshotStore-compatible accessor (used by restart plumbing)."""
        return self.load(seq, rank=rank)
