"""Checkpoint/restart of the port: snapshot stores.

≈ the reference's storage layer (orte/mca/sstore/{central,stage} +
filem/raw), as the JAX package's ``ompi_tpu.ckpt``:

- ``SnapshotStore`` / ``StagedStore`` (``ckpt.store``): an npz per rank
  and a commit record, byte-compatible with the JAX package's, so either
  package resumes the other's snapshots (bf16 and float8 leaves
  included, with no ml_dtypes);
- ``DcpStore`` (``ckpt.dcp_store``): the counterpart of the JAX package's
  ``OrbaxStore`` over ``torch.distributed.checkpoint`` (OrbaxStore →
  DcpStore, ``abstract_state`` → ``template``, a sharded jax.Array → a
  DTensor made by ``sharded``).

Left out until their dependencies are ported (ROADMAP.md Queue 1 item
6): ``ShardedSnapshotStore`` (collective MPI-IO, item 6.12), and
``snapc`` (coordinated checkpoint/restart) and ``msglog`` (message
logging), which need the trace and fault-tolerance layers (item 6.10).
"""

from ompi_tpu_torch.ckpt.dcp_store import DcpStore, sharded
from ompi_tpu_torch.ckpt.store import SnapshotStore, StagedStore

__all__ = ["SnapshotStore", "StagedStore", "DcpStore", "sharded"]
