"""Checkpoint/restart of the port: snapshot stores.

≈ the reference's storage layer (orte/mca/sstore/{central,stage} +
filem/raw), as the JAX package's ``ompi_tpu.ckpt``:

- ``SnapshotStore`` / ``StagedStore`` (``ckpt.store``): an npz per rank
  and a commit record, byte-compatible with the JAX package's, so either
  package resumes the other's snapshots (bf16 and float8 leaves
  included, with no ml_dtypes);
- ``ShardedSnapshotStore`` (``ckpt.store``): one file per array written
  through collective MPI-IO (``mpi.io``), the JAX package's
  ``sharded-file`` layout;
- ``DcpStore`` (``ckpt.dcp_store``): the counterpart of the JAX package's
  ``OrbaxStore`` over ``torch.distributed.checkpoint`` (OrbaxStore →
  DcpStore, ``abstract_state`` → ``template``, a sharded jax.Array → a
  DTensor made by ``sharded``);
- ``snapc`` (``ckpt.snapc``): coordinated ``checkpoint``/``restart``,
  ``auto_restore`` of an errmgr-revived life and the step-driven
  ``CheckpointManager``;
- ``msglog`` (``ckpt.msglog``): the pessimist message log
  (``MessageLog``) and the wildcard match order (``EventLog``).
"""

from ompi_tpu_torch.ckpt.dcp_store import DcpStore, sharded
from ompi_tpu_torch.ckpt.msglog import EventLog, MessageLog
from ompi_tpu_torch.ckpt.snapc import (CheckpointManager, auto_restore,
                                       checkpoint, restart,
                                       restart_incarnation)
from ompi_tpu_torch.ckpt.store import (ShardedSnapshotStore, SnapshotStore,
                                       StagedStore)

__all__ = ["SnapshotStore", "StagedStore", "ShardedSnapshotStore",
           "DcpStore", "sharded",
           "checkpoint", "restart", "auto_restore", "restart_incarnation",
           "CheckpointManager", "MessageLog", "EventLog"]
