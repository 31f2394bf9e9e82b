"""coll — the collectives framework (the port's trimmed copy of the JAX
package's ``mpi/coll/__init__.py``).

≈ ompi/mca/coll: a per-communicator function table filled by
priority-ordered component query (coll.h:426-530,
coll_base_comm_select.c:107,270).  For each function the highest-priority
component providing it wins.

Components here:
- ``self`` — size-1 communicators, host buffers: every collective is a
  local copy (≈ coll/self).
- ``host`` — the tuned host algorithms over the communicator's PML
  (≈ coll/tuned + coll/base), for host buffers on more than one rank.
- ``shm``  — single-copy on-node collectives through a per-communicator
  shared-memory arena (barrier, bcast, reduce, allreduce, allgather, the
  alltoall family, reduce_scatter and scan), hierarchical (intra-node
  arena + inter-node coll/host) on mixed-host communicators (≈ coll/sm +
  the HiCCL decomposition), for host buffers on ranks that share a host.
- ``xla``  — the device path (≈ the coll/cuda slot, inverted): collectives
  on torch tensors run on the communicator's bound ``DeviceCommunicator``
  (NCCL on the card, gloo on the CPU), with no host copy.

Left out of the JAX package's dispatch: the trace plane (the flight
recorder, spans and dispatch histograms; ROADMAP.md Queue 1 item 6.9) and
the fault injector's collective triggers (item 6.10).

Buffer-location dispatch: each table slot is a dispatcher that routes by
``core.buffer.classify()`` — HOST buffers to the best host-capable
component, DEVICE buffers to the best device-capable one; a buffer with no
component for its location raises ``BufferLocationError`` instead of
silently staging.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional

from ompi_tpu_torch.core.buffer import (BufferKind, BufferLocationError,
                                        classify)
from ompi_tpu_torch.core.mca import Component, Framework

if TYPE_CHECKING:
    from ompi_tpu_torch.mpi.comm import Communicator

__all__ = ["coll_framework", "install", "CollModule", "COLL_FUNCTIONS"]

coll_framework = Framework("coll", "collective operations")

# the function table slots (≈ mca_coll_base_comm_coll_t)
COLL_FUNCTIONS = (
    "barrier", "bcast", "reduce", "allreduce", "gather", "allgather",
    "scatter", "alltoall", "reduce_scatter", "reduce_scatter_block", "scan",
    "exscan", "gatherv", "scatterv", "allgatherv", "alltoallv",
    "alltoallw",
)

# slots whose first argument is a data buffer (everything but barrier)
_BUFFER_SLOTS = frozenset(COLL_FUNCTIONS) - {"barrier"}


class CollModule:
    """The per-communicator collective table. Attributes are bound
    dispatchers choosing host vs device providers per buffer location."""

    def __init__(self) -> None:
        # slot → component name serving host buffers (introspection)
        self.providers: dict[str, str] = {}
        # slot → component name serving device buffers
        self.device_providers: dict[str, str] = {}


def _handles(comp: Component) -> frozenset:
    return getattr(comp, "HANDLES", frozenset({"host"}))


def _make_dispatch(slot: str, host_fn, host_name: Optional[str],
                   dev_fn, dev_name: Optional[str]):
    def dispatch(comm, buf, *args, **kw):
        if classify(buf) is BufferKind.HOST:
            if host_fn is None:
                raise BufferLocationError(
                    f"{slot}: host buffer but no host-capable coll "
                    f"component selected (directive excludes "
                    f"host/self; device path [{dev_name}] needs torch "
                    f"tensors)")
            return host_fn(comm, buf, *args, **kw)
        if dev_fn is None:
            raise BufferLocationError(
                f"{slot}: device buffer but no device-capable coll "
                f"component selected (have [{host_name}]; enable "
                f"coll/xla and comm.bind_device(...) for the device "
                f"path, or .cpu().numpy() the tensor if host staging is "
                f"intended)")
        return dev_fn(comm, buf, *args, **kw)

    dispatch.__name__ = f"coll_{slot}_dispatch"
    return dispatch


def install(comm: "Communicator") -> None:
    """Fill comm.coll by priority query (≈ coll_base_comm_select)."""
    # import registers the components
    from ompi_tpu_torch.mpi.coll import host as _host  # noqa: F401
    from ompi_tpu_torch.mpi.coll import selfcoll as _selfcoll  # noqa: F401
    from ompi_tpu_torch.mpi.coll import shm as _shm  # noqa: F401
    from ompi_tpu_torch.mpi.coll import xla as _xla  # noqa: F401

    module = CollModule()
    ranked = coll_framework.select_all(comm=comm)
    for slot in COLL_FUNCTIONS:
        host_fn = host_name = dev_fn = dev_name = None
        for comp in ranked:
            fn = getattr(comp, f"coll_{slot}", None)
            if fn is None:
                continue
            caps = _handles(comp)
            if host_fn is None and "host" in caps:
                host_fn, host_name = fn, comp.NAME
            if dev_fn is None and "device" in caps:
                dev_fn, dev_name = fn, comp.NAME
        if slot in _BUFFER_SLOTS:
            setattr(module, slot,
                    _make_dispatch(slot, host_fn, host_name, dev_fn,
                                   dev_name))
        elif host_fn is None and dev_fn is None:
            setattr(module, slot, _unimplemented(slot))
        else:
            # barrier, no buffer to classify: the host provider wins, as
            # in the JAX package, on a communicator with a PML to run it
            # over; one with none (a device-only communicator,
            # ``Communicator(...).bind_device(...)``) takes the device's
            host_ok = host_fn is not None and (
                dev_fn is None or getattr(comm, "pml", None) is not None)
            setattr(module, slot, host_fn if host_ok else dev_fn)
        if host_name:
            module.providers[slot] = host_name
        if dev_name:
            module.device_providers[slot] = dev_name
    comm.coll = module


def _unimplemented(slot: str):
    def stub(comm, *a, **kw):
        from ompi_tpu_torch.mpi.constants import MPIException

        raise MPIException(
            f"no coll component provides {slot} for {comm.name}")

    return stub
