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
scalars; ``load_rank`` returns CPU tensors (the caller moves them with an
explicit ``.to(device)``), and numpy arrays for what torch cannot hold
(strings, records, raw void).  The module imports torch only inside the
functions that touch tensors.

Left out: ``ShardedSnapshotStore`` (one file per array through collective
MPI-IO) waits for the port's ``mpi/io`` (ROADMAP.md Queue 1 item 6.12).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from typing import Any, Optional

import numpy as np

from ompi_tpu_torch.core.buffer import is_tensor
from ompi_tpu_torch.mpi.constants import ERR_IO, MPIException

__all__ = ["SnapshotStore", "StagedStore"]

_META = "metadata.json"

# npz serializes ml_dtypes arrays (bfloat16, float8_*) as raw void —
# bytes survive but the dtype name is dropped (loads back as |V2).
# Record the true dtype of such arrays in a SIDECAR MANIFEST entry
# (user keys are never renamed, so no user key can ever be
# misinterpreted or collide) and view the bytes back on load.
_DTYPE_MANIFEST = "__ompi_tpu_dtype_manifest__"

#: the dtypes numpy has no name for without ml_dtypes: their manifest name
#: (ml_dtypes' and torch's alike) → the integer of their width, whose
#: bits they travel as
_EXOTIC = {"bfloat16": "int16", "float8_e4m3fn": "uint8",
           "float8_e5m2": "uint8", "float8_e4m3fnuz": "uint8",
           "float8_e5m2fnuz": "uint8"}


def _to_host(v: Any) -> tuple[np.ndarray, Optional[str]]:
    """(numpy array, manifest dtype name or None) of one state value."""
    if is_tensor(v):
        import torch

        t = v.detach().cpu().contiguous()
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


def _as_tensor(arr: np.ndarray, name: Optional[str], key: str):
    """A CPU tensor of ``arr`` (its bytes viewed as ``name`` when the
    manifest names one), or ``arr`` itself when torch cannot hold it."""
    import torch

    if name is not None:
        if name not in _EXOTIC or arr.dtype.kind != "V":
            raise MPIException(
                f"restoring checkpoint array {key!r} as dtype {name!r}: "
                f"not a dtype the port knows, or not raw bytes "
                f"({arr.dtype})", error_class=ERR_IO)
        bits = _EXOTIC[name]
        if arr.dtype.itemsize != np.dtype(bits).itemsize:
            raise MPIException(
                f"restoring checkpoint array {key!r} as dtype {name!r}: "
                f"{arr.dtype.itemsize}-byte elements", error_class=ERR_IO)
        return torch.from_numpy(np.require(arr, requirements="C").view(
            bits)).view(getattr(torch, name))
    try:   # np.require keeps a 0-d array 0-d (ascontiguousarray would not)
        return torch.from_numpy(np.require(arr, requirements="C"))
    except TypeError:   # strings, records, raw void: no torch dtype
        return arr


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
    return {k: _as_tensor(npz[k], mapping.get(k), k) for k in files}


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
        """One rank's state: CPU tensors (numpy arrays where torch has no
        dtype)."""
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
