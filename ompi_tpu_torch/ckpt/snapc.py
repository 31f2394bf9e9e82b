"""Snapshot coordination: collective checkpoint/restart + manager (the
port's copy of the JAX package's ``ckpt/snapc.py``).

≈ orte/mca/snapc/full (snapc.h:47-166): the coordinator that quiesces the
job, has every process dump its image, collects success reports, and marks
the global snapshot valid.  The protocol runs over the collective layer:

    checkpoint(comm, state):
      barrier            — quiesce ≈ crcp/bkmrk drain (step boundary: SPMD
                           programs have no in-flight user traffic here)
      write_rank         — ≈ crs checkpoint of this process
      allreduce(MIN ok)  — every rank's success report
      rank0 commit       — the snapc "global snapshot valid" record
      barrier            — restart-safety: nobody races ahead of the commit

Tensors on the card are pulled to host by the store; the store loads
numpy arrays (CPU tensors for bf16 and float8, which numpy cannot name),
and ``restore_fn(name, leaf)`` (e.g. ``lambda k, x:
torch.as_tensor(x).to("cuda")``) places each leaf back — the checkpoint
layer is deliberately ignorant of placement, exactly as sstore is
ignorant of what's in an image.

``CheckpointManager(async_save=True)`` copies every leaf to host memory
before ``save`` returns, so the background thread never holds a live
tensor that the training step updates in place (AdamW's ``update_``):
a tensor on the card is copied into a pinned host buffer that the
manager keeps for the next save of the same key (allocated once), with
one device synchronize before ``save`` returns; a CPU tensor is cloned
and a numpy array copied.  This module imports no torch: a tensor is
recognised through ``core.buffer.is_tensor``.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, Optional

import numpy as np

from ompi_tpu_torch.ckpt.store import SnapshotStore
from ompi_tpu_torch.core.buffer import is_tensor
from ompi_tpu_torch.mpi import trace as trace_mod
from ompi_tpu_torch.mpi.constants import ERR_IO, MPIException

__all__ = ["checkpoint", "restart", "restart_incarnation", "auto_restore",
           "CheckpointManager"]


def restart_incarnation() -> int:
    """The ``OMPI_TPU_RESTART`` life number the errmgr stamped on this
    process — 0 for a first life, n for the n-th revival (errmgr
    respawn/selfheal)."""
    return int(os.environ.get("OMPI_TPU_RESTART") or 0)


def auto_restore(comm, store: SnapshotStore,
                 restore_fn: Optional[Callable[[str, Any], Any]]
                 = None, rank: Optional[int] = None
                 ) -> Optional[tuple[int, dict[str, Any]]]:
    """``OMPI_TPU_RESTART``-keyed revival restore (the errmgr
    respawn/selfheal rejoin): when this process is a revived incarnation
    and a committed snapshot exists, load THIS rank's view of the latest
    one and return ``(seq, state)``; None on a first life (or when
    nothing was ever committed — the revived rank recomputes from 0).

    Deliberately NON-collective, unlike :func:`restart`: the survivors
    are mid-step and cannot pair a collective restore with the revived
    rank — each life reads only its own committed shard.  The in-flight
    gap between the snapshot and the failure point is the message log's
    job (``ckpt.msglog`` auto-replay on the peer-revived event).

    ``rank`` overrides the in-store rank key (apps using one store PER
    rank pass 0 — they keyed the store path by rank instead).
    """
    if not restart_incarnation():
        return None
    seq = store.latest()
    if seq is None:
        return None
    if trace_mod.active:
        trace_mod.instant("ckpt", "auto_restore", rank=comm.pml.rank,
                          seq=int(seq), life=restart_incarnation())
    state = store.load_rank(seq, comm.rank if rank is None else rank)
    if restore_fn is not None:
        state = {k: restore_fn(k, v) for k, v in state.items()}
    return seq, state


def checkpoint(comm, store: SnapshotStore, state: dict[str, Any],
               seq: Optional[int] = None,
               keep_last: Optional[int] = None,
               extra_meta: Optional[dict] = None) -> int:
    """Collective: snapshot every rank's `state` dict; returns the seq.

    All-or-nothing: if any rank fails to write, no commit record is
    created and the snapshot is invisible to restart.
    """
    if trace_mod.active:
        with trace_mod.span("ckpt", "checkpoint", rank=comm.pml.rank,
                            seq=-1 if seq is None else int(seq),
                            arrays=len(state)):
            return _checkpoint_impl(comm, store, state, seq, keep_last,
                                    extra_meta)
    return _checkpoint_impl(comm, store, state, seq, keep_last, extra_meta)


def _checkpoint_impl(comm, store, state, seq, keep_last, extra_meta) -> int:
    if seq is None:
        latest = store.latest()
        # all ranks compute the same next seq from the committed history,
        # then agree on the max (defensive against stale directory listings
        # on shared filesystems)
        mine = (latest + 1) if latest is not None else 0
        agreed = comm.allreduce(np.array([mine], np.int64), op=_MAX())
        seq = int(np.asarray(agreed)[0])
    comm.barrier()                      # quiesce at the step boundary
    if hasattr(store, "save"):
        # collective single-file store (ShardedSnapshotStore): save() is
        # the whole write+commit protocol — per-rank write_rank/commit
        # do not apply to the shared-file layout
        store.save(seq, state, extra=extra_meta)
        if comm.rank == 0 and keep_last is not None:
            try:
                store.gc(keep_last)
            except Exception:  # noqa: BLE001 — best-effort, like below
                pass
        return seq
    ok = 1
    err = ""
    try:
        store.write_rank(seq, comm.rank, state)
    except Exception as e:  # noqa: BLE001 — must still participate below
        ok = 0
        err = str(e)
    agreed = comm.allreduce(np.array([ok], np.int64), op=_MIN())
    if not int(np.asarray(agreed)[0]):
        raise MPIException(
            f"checkpoint {seq} failed"
            + (f" on this rank: {err}" if err else " on a peer rank"),
            error_class=ERR_IO)
    # commit success must be agreed too: if rank 0's commit throws (e.g. a
    # peer's file not yet visible on a laggy shared fs), a bare barrier
    # would strand every other rank — broadcast the outcome instead
    commit_ok = 1
    commit_err = ""
    if comm.rank == 0:
        try:
            store.commit(seq, comm.size, extra_meta)
        except Exception as e:  # noqa: BLE001 — reported collectively
            commit_ok = 0
            commit_err = str(e)
        if commit_ok and keep_last is not None:
            try:
                store.gc(keep_last)   # best-effort: a failed cleanup must
            except Exception:         # not report a durable commit as
                pass                  # failed (restart would load it)
    flag = comm.bcast(np.array([commit_ok], np.int8), root=0)
    if not int(np.asarray(flag)[0]):
        raise MPIException(
            f"checkpoint {seq} commit failed on rank 0"
            + (f": {commit_err}" if commit_err else ""),
            error_class=ERR_IO)
    return seq


def restart(comm, store: SnapshotStore, seq: Optional[int] = None,
            restore_fn: Optional[Callable[[str, Any], Any]] = None,
            ) -> tuple[int, dict[str, Any]]:
    """Collective: load the latest (or given) committed snapshot.

    ``restore_fn(name, host_leaf)`` re-places each leaf (a CPU tensor, or
    a numpy array where torch has no dtype: ``.to("cuda")``, a dtype
    cast, ...); default returns the host leaf.
    """
    if trace_mod.active:
        with trace_mod.span("ckpt", "restart", rank=comm.pml.rank,
                            seq=-1 if seq is None else int(seq)):
            return _restart_impl(comm, store, seq, restore_fn)
    return _restart_impl(comm, store, seq, restore_fn)


def _restart_impl(comm, store, seq, restore_fn):
    if seq is None:
        # rank 0 decides (directory listings may race GC on shared fs)
        mine = store.latest()
        chosen = comm.bcast(
            np.array([mine if mine is not None else -1], np.int64), root=0)
        seq = int(np.asarray(chosen)[0])
        if seq < 0:
            raise MPIException("no committed snapshot to restart from",
                               error_class=ERR_IO)
    state = store.load_rank(seq, comm.rank)
    if restore_fn is not None:
        state = {k: restore_fn(k, v) for k, v in state.items()}
    comm.barrier()
    return seq, state


class CheckpointManager:
    """Step-driven convenience (≈ orbax CheckpointManager, carrying the
    snapc policy knobs): checkpoint every `interval` steps, keep the last
    `keep_last`, optionally writing in a background thread (async save —
    the barrier cost stays, the serialization cost moves off the step
    path)."""

    def __init__(self, comm, store: SnapshotStore, interval: int = 1,
                 keep_last: int = 2, async_save: bool = False) -> None:
        if interval < 1:
            raise MPIException("interval must be >= 1")
        # private communicator (MPI library idiom): async saves run their
        # collectives from a background thread, which would cross-match
        # with the application's traffic on the same cid
        self.comm = comm.dup(name=f"{comm.name}.ckpt")
        self.store = store
        self.interval = interval
        self.keep_last = keep_last
        self.async_save = async_save
        self._pending: Optional[threading.Thread] = None
        self._pending_err: list[BaseException] = []
        # pinned host staging of the async save, one buffer per key,
        # reused by every later save of that key (same shape and dtype)
        self._staging: dict[str, Any] = {}

    def should_checkpoint(self, step: int) -> bool:
        return step % self.interval == 0

    def maybe_checkpoint(self, step: int,
                         state: dict[str, Any]) -> Optional[int]:
        if not self.should_checkpoint(step):
            return None
        return self.save(step, state)

    def save(self, step: int, state: dict[str, Any]) -> int:
        self.wait()                      # one outstanding async save max
        if not self.async_save:
            return checkpoint(self.comm, self.store, state, seq=step,
                              keep_last=self.keep_last)
        # snapshot the host copies NOW (the caller may update the leaves
        # in place right after), then serialize in the background
        host = self._host_copy(state)

        def work() -> None:
            try:
                checkpoint(self.comm, self.store, host, seq=step,
                           keep_last=self.keep_last)
            except BaseException as e:  # noqa: BLE001 — reported at wait()
                self._pending_err.append(e)

        self._pending = threading.Thread(target=work, daemon=True)
        self._pending.start()
        return step

    def _host_copy(self, state: dict[str, Any]) -> dict[str, Any]:
        """Every leaf copied to host memory, complete when this returns:
        a tensor on the card lands in this key's pinned staging buffer
        (one synchronize for the whole state), a CPU tensor is cloned, a
        numpy array or scalar copied."""
        host: dict[str, Any] = {}
        on_card = False
        for k, v in state.items():
            if is_tensor(v) and v.device.type != "cpu":
                buf = self._staging.get(k)
                if (buf is None or buf.shape != v.shape
                        or buf.dtype != v.dtype):
                    import torch

                    buf = self._staging[k] = torch.empty(
                        v.shape, dtype=v.dtype, device="cpu",
                        pin_memory=True)
                buf.copy_(v.detach(), non_blocking=True)
                host[k] = buf
                on_card = True
            elif is_tensor(v):
                host[k] = v.detach().clone()
            else:
                host[k] = np.asarray(v).copy()
        if on_card:
            import torch

            torch.cuda.synchronize()
        return host

    def wait(self) -> None:
        """Block until the outstanding async save (if any) lands; re-raise
        its failure here."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._pending_err:
            raise self._pending_err.pop(0)

    def restore(self, seq: Optional[int] = None,
                restore_fn: Optional[Callable] = None
                ) -> tuple[int, dict[str, Any]]:
        self.wait()
        return restart(self.comm, self.store, seq, restore_fn)

    def auto_restore(self, restore_fn: Optional[Callable] = None,
                     rank: Optional[int] = None
                     ) -> Optional[tuple[int, dict[str, Any]]]:
        """``OMPI_TPU_RESTART``-keyed revival restore (see module-level
        :func:`auto_restore`): non-collective latest-snapshot load when
        this process is an errmgr-revived incarnation, else None.
        ``rank`` overrides the in-store rank key, exactly as on the
        module function (per-rank stores pass 0)."""
        return auto_restore(self.comm, self.store, restore_fn, rank)


def _MAX():
    from ompi_tpu_torch.mpi import op as op_mod

    return op_mod.MAX


def _MIN():
    from ompi_tpu_torch.mpi import op as op_mod

    return op_mod.MIN
