"""coll/xla — the device collective component (MCA slot ≈
ompi/mca/coll/cuda; the port's copy of the JAX package's
``mpi/coll/xla.py``).

The reference's coll/cuda (coll_cuda_allreduce.c:30-69) intercepts device
buffers, stages them through host bounce buffers, and delegates to the
CPU algorithms.  This component is the inversion of that slot: device
buffers never cross to the host — every collective runs on the
communicator's bound ``DeviceCommunicator`` (NCCL on the card, gloo for a
CPU mesh).  The module and component keep the JAX package's name, ``xla``,
and its configuration variables, so one ``--mca coll ^xla`` or
``OMPI_TPU_MCA_coll_xla_allreduce_algorithm`` setting reads the same in
both packages.

One buffer kind reaches this component: DEVICE, a ``torch.Tensor`` that
is this rank's shard (a port rank is a process that owns one device).  So
where the JAX package wraps a call on a global array in a
``shard_map``, this component calls the ``DeviceCommunicator`` method on
the shard directly, and the decision layer reads the tensor's own bytes
as the per-shard size.  A tensor on another device than the bound mesh's raises
``BufferLocationError``; it is never moved with ``.to()``.

Selection: ``--mca coll xla`` forces this path exclusively (host buffers
then error); ``--mca coll ^xla`` removes it (device buffers then raise
``BufferLocationError`` at the dispatcher).
"""

from __future__ import annotations

import os
from typing import Optional

from ompi_tpu_torch.core.buffer import BufferLocationError, is_tensor
from ompi_tpu_torch.core.config import VarType, register_var, var_registry
from ompi_tpu_torch.core.mca import Component
from ompi_tpu_torch.mpi.coll import coll_framework, rules
from ompi_tpu_torch.mpi.constants import MPIException
from ompi_tpu_torch.mpi.op import Op

__all__ = ["XlaColl"]


def _dev_nbytes(buf: torch.Tensor) -> int:
    """Byte size of this rank's shard."""
    return buf.numel() * buf.element_size()


#: measured crossovers from the card (written by the port's tools/tune.py,
#: ROADMAP.md Queue 1 item 6); absent until then, so the fixed decision
#: runs.  The JAX package's file holds TPU measurements and is not used.
_MEASURED_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "xla_measured_rules.conf")
#: [(path, RuleSet | None)] — the file is read once per process: it ships
#: with the package, and a stat in every call (as the JAX package makes)
#: cost ~0.1 ms a collective on a slow filesystem
_measured_cache: list = []


def _measured_rules(dc):
    """The shipped measured-crossover RuleSet, or None when the file is
    absent, empty of rules, or was measured on another platform than the
    bound mesh's ("cuda" on the card, "cpu" otherwise)."""
    if not (_measured_cache and _measured_cache[0][0] == _MEASURED_PATH):
        try:
            loaded = rules.load_rules(_MEASURED_PATH)
        except (OSError, MPIException):  # absent, or a bad file: no rules
            loaded = None
        _measured_cache[:] = [(_MEASURED_PATH, loaded)]
    rs = _measured_cache[0][1]
    if (rs is None or len(rs) == 0
            or rs.meta.get("platform") != (
                "cuda" if dc.mesh.device.type == "cuda" else "cpu")):
        return None
    return rs


def _device_comm(comm):
    dc = getattr(comm, "device", None)
    if dc is None:
        raise BufferLocationError(
            f"{comm.name}: device buffer in a collective but no device "
            f"communicator is bound; call comm.bind_device(device_comm) "
            f"(e.g. device_world(mesh)) so coll/xla knows the mesh axes")
    return dc


def _same_device(dev: torch.device, mesh_dev: torch.device) -> bool:
    if dev == mesh_dev:
        return True
    if dev.type != mesh_dev.type:
        return False
    if dev.type != "cuda" or mesh_dev.index is None:
        return True
    import torch

    return (dev.index if dev.index is not None
            else torch.cuda.current_device()) == mesh_dev.index


def _check_device(comm, dc, buf) -> None:
    """A tensor on another device than the bound mesh's raises; the port
    never moves it (no fallback that hides the device)."""
    parts = buf if isinstance(buf, (list, tuple)) else (buf,)
    for t in parts:
        if is_tensor(t) and not _same_device(
                t.device, dc.mesh.device):
            raise BufferLocationError(
                f"{comm.name}: a tensor on {t.device} in a collective over "
                f"a mesh on {dc.mesh.device}; the device path moves no "
                f"tensor between devices — create it on {dc.mesh.device} "
                f"or bind a communicator whose mesh is on {t.device}")


def _run(comm, method: str, buf, *args, **kw):
    """One DeviceCommunicator method on this rank's shard."""
    dc = _device_comm(comm)
    _check_device(comm, dc, buf)
    return getattr(dc, method)(buf, *args, **kw)


@coll_framework.component
class XlaColl(Component):
    """Device collectives with a tuned-style decision layer.

    ≈ coll/tuned's fixed decision (coll_tuned_decision_fixed.c:44-87)
    transposed to the device path: per collective the choice is between
    the native collective (all_reduce / all_gather / broadcast —
    latency-optimal, the library picks its algorithm) and an explicit
    two-phase or neighbour form whose communication shape favours
    bandwidth or a slow axis.  The selection is (per-shard bytes × comm
    size × axis kind), overridable per collective by config var or a
    dynamic rules file."""

    NAME = "xla"
    PRIORITY = 60        # above host (40); the dispatcher routes by buffer
    HANDLES = frozenset({"device"})

    # "qint8" (EQuARX-style int8 wire format, device_comm.allreduce_qint8)
    # is in the menu for forcing/tuning but is LOSSY and never chosen by
    # the auto decision
    ALGORITHMS = {
        "allreduce": ("psum", "rs_ag", "segmented", "qint8"),
        "allgather": ("all_gather", "ring"),
        "bcast": ("psum_mask", "ring"),
    }
    # collective → algorithm → DeviceCommunicator method
    _IMPL = {
        "allreduce": {"psum": "allreduce", "rs_ag": "allreduce_rs_ag",
                      "segmented": "allreduce_segmented",
                      "qint8": "allreduce_qint8"},
        "allgather": {"all_gather": "allgather", "ring": "allgather_ring"},
        "bcast": {"psum_mask": "bcast", "ring": "bcast_ring"},
    }
    # algorithms that change RESULTS, not just schedules: forceable, but
    # never auto-picked (_decide never returns them from a file)
    LOSSY = {"allreduce": frozenset({"qint8"})}

    def register_params(self) -> None:
        register_var("coll", "xla_dcn_axes", VarType.STRING, "",
                     "comma-separated mesh axis names that cross DCN "
                     "(inter-slice); collectives over them prefer "
                     "neighbor-shaped algorithms (ring/2-phase)")
        register_var("coll", "xla_allreduce_large", VarType.SIZE, 32 << 20,
                     "allreduce: at/above this PER-SHARD byte size switch "
                     "to the 2-phase reduce_scatter+all_gather form "
                     "(bandwidth-optimal ring shape; below, the fused "
                     "all_reduce wins on latency)")
        register_var("coll", "xla_dynamic_rules", VarType.STRING, "",
                     "path to a dynamic rules file for the DEVICE path "
                     "(same format as coll_host_dynamic_rules)")
        for name in self.ALGORITHMS:
            register_var("coll", f"xla_{name}_algorithm", VarType.STRING, "",
                         f"force a device {name} algorithm (empty = decide "
                         f"by size/axis kind)")

    def query(self, comm=None, **ctx) -> Optional[int]:
        return self.PRIORITY

    # -- decision layer ----------------------------------------------------

    def _crosses_dcn(self, dc) -> bool:
        spec = var_registry.get("coll_xla_dcn_axes") or ""
        dcn = {a.strip() for a in spec.split(",") if a.strip()}
        return bool(dcn.intersection(dc.axes))

    def _decide(self, coll: str, comm, dc, nbytes: int) -> str:
        """forced var > user rules file > shipped measured rules > fixed
        (per-shard bytes × size × axis kind)."""
        valid = self.ALGORITHMS[coll]
        dcn = self._crosses_dcn(dc)
        alg = var_registry.get(f"coll_xla_{coll}_algorithm")
        src = f"config var coll_xla_{coll}_algorithm"
        if not alg:
            path = var_registry.get("coll_xla_dynamic_rules")
            if path:
                alg = rules.load_rules(path).lookup(coll, dc.size, nbytes)
                src = f"rules file {path}"
        if not alg and not dcn:
            # measured crossovers, consulted only when the file's platform
            # matches the bound mesh's AND this communicator's size is
            # within 2× of the measured one
            rs = _measured_rules(dc)
            if rs is not None:
                try:
                    meta_n = int(rs.meta.get("n_devices", 0))
                except ValueError:
                    meta_n = 0
                if meta_n and meta_n / 2 <= dc.size <= meta_n * 2:
                    alg = rs.lookup(coll, dc.size, nbytes)
                    src = "measured rules (xla_measured_rules.conf)"
        if alg:
            if alg not in valid:
                raise MPIException(
                    f"unknown device {coll} algorithm {alg!r} (from {src}); "
                    f"valid: {', '.join(valid)}")
            if (alg in self.LOSSY.get(coll, frozenset())
                    and not src.startswith("config var")):
                # a rules FILE must not silently change results; lossy
                # algorithms are an explicit per-run opt-in only
                raise MPIException(
                    f"device {coll} algorithm {alg!r} (from {src}) is "
                    f"lossy and may only be forced via the "
                    f"coll_xla_{coll}_algorithm config var")
            return alg
        # fixed decision: neighbor-shaped on DCN axes or huge payloads;
        # the native collective otherwise
        if coll == "allreduce":
            large = var_registry.get("coll_xla_allreduce_large")
            return "rs_ag" if (dcn or nbytes >= large) else "psum"
        if coll == "allgather":
            return "ring" if dcn else "all_gather"
        return "ring" if dcn else "psum_mask"

    def _run_decided(self, coll: str, comm, buf, *args, **kw):
        dc = _device_comm(comm)
        # the decision unit is PER-SHARD bytes, and the tensor already is
        # this rank's shard (the JAX package divides its global array
        # by the mesh size to reach the same unit)
        alg = self._decide(coll, comm, dc, _dev_nbytes(buf))
        return _run(comm, self._IMPL[coll][alg], buf, *args, **kw)

    # -- table slots (device implementations) ------------------------------

    def coll_barrier(self, comm) -> None:
        _device_comm(comm).barrier()

    def coll_bcast(self, comm, buf, root: int):
        return self._run_decided("bcast", comm, buf, root)

    def coll_reduce(self, comm, sendbuf, op: Op, root: int):
        return _run(comm, "reduce", sendbuf, op, root)

    def coll_allreduce(self, comm, sendbuf, op: Op):
        # both impls take (x, op); rs_ag falls back to psum for non-SUM
        return self._run_decided("allreduce", comm, sendbuf, op)

    def coll_gather(self, comm, sendbuf, root: int):
        return _run(comm, "gather", sendbuf, root)

    def coll_allgather(self, comm, sendbuf):
        return self._run_decided("allgather", comm, sendbuf)

    def coll_scatter(self, comm, sendbuf, root: int):
        return _run(comm, "scatter", sendbuf, root)

    def coll_alltoall(self, comm, sendbuf):
        return _run(comm, "alltoall", sendbuf)

    def coll_reduce_scatter(self, comm, sendbuf, op: Op):
        return _run(comm, "reduce_scatter", sendbuf, op)

    def coll_reduce_scatter_block(self, comm, sendbuf, op: Op):
        return _run(comm, "reduce_scatter", sendbuf, op)

    def coll_scan(self, comm, sendbuf, op: Op):
        return _run(comm, "scan", sendbuf, op)

    def coll_exscan(self, comm, sendbuf, op: Op):
        return _run(comm, "exscan", sendbuf, op)

    # v-collectives: through the MPI API the device path sees one uniform
    # shard per rank, so these lower to the dense forms; ragged counts are
    # first-class on DeviceCommunicator (allgatherv/scatterv/alltoallv with
    # a counts vector → pad+mask)

    def coll_gatherv(self, comm, sendbuf, root: int):
        return _run(comm, "gatherv", sendbuf, None, root)

    def coll_scatterv(self, comm, sendparts, root: int):
        return _run(comm, "scatterv", sendparts, None, root)

    def coll_allgatherv(self, comm, sendbuf):
        return _run(comm, "allgatherv", sendbuf)

    def coll_alltoallv(self, comm, sendparts):
        return _run(comm, "alltoallv", sendparts)
