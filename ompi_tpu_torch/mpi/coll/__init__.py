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

Every dispatch, host route and device route alike, passes the one
choke point ``_run_recorded``: the collective flight recorder's post and
done/err (always on), the ``coll_dispatch_ns`` histogram labelled slot,
provider and log2 size bucket, and the ``coll`` span with cid and seq
when the timeline is armed.  Left out of the JAX package's dispatch: the
fault injector's ``@coll`` triggers (ROADMAP.md Queue 1 item 6.10).

Buffer-location dispatch: each table slot is a dispatcher that routes by
``core.buffer.classify()`` — HOST buffers to the best host-capable
component, DEVICE buffers to the best device-capable one; a buffer with no
component for its location raises ``BufferLocationError`` instead of
silently staging.
"""

from __future__ import annotations

import time
from typing import TYPE_CHECKING, Optional

from ompi_tpu_torch.core.buffer import (BufferKind, BufferLocationError,
                                        classify)
from ompi_tpu_torch.core.mca import Component, Framework
from ompi_tpu_torch.mpi import trace as trace_mod

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


#: position of the root argument within a dispatcher's ``*args`` (after
#: the buffer) — mirrors Communicator's positional call shapes so the
#: recorder signature catches divergent-root mismatches
_ROOT_ARG = {"bcast": 0, "gather": 0, "scatter": 0, "gatherv": 0,
             "scatterv": 0, "reduce": 1}


def _run_recorded(comm, slot: str, kind: str, sig: int,
                  provider: Optional[str], nbytes: int, fn, fargs, fkw):
    """The ONE choke point: flight-recorder post/done (always-on, the
    hang doctor's evidence), the per-collective span (timeline) and the
    dispatch-latency histogram labeled provider + log2 size bucket
    (szb).  A device-only communicator (no PML) records under its world
    rank."""
    pml = comm.pml
    rank = pml.rank if pml is not None else comm._world_rank
    seq = trace_mod.coll_post(rank, comm.cid, kind, sig, provider,
                              nbytes)
    t0 = (trace_mod.begin()
          if trace_mod.hist_active or trace_mod.active else 0)
    try:
        ret = fn(comm, *fargs, **fkw)
        trace_mod.coll_done(rank, comm.cid, seq, kind)
        return ret
    except BaseException as e:
        trace_mod.coll_err(rank, comm.cid, seq, kind, type(e).__name__)
        raise
    finally:
        # span + histogram land on the raise path too: the one
        # collective that FAILED is exactly the sample a postmortem
        # trace needs
        if t0:
            now = time.monotonic_ns()
            if trace_mod.hist_active:
                szb = nbytes.bit_length()
                trace_mod.record_hist(
                    "coll_dispatch_ns", now - t0,
                    labels=f'slot="{slot}",provider="{provider}",'
                           f'szb="{szb}"')
            if trace_mod.active:
                # cid+seq is the cross-rank round key: the timeline
                # merge chains every rank's span of one collective
                trace_mod.complete(
                    "coll", slot, t0, rank=rank, provider=provider,
                    comm=comm.name, cid=comm.cid, size=comm.size,
                    seq=seq)


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
            fn, provider = host_fn, host_name
        else:
            if dev_fn is None:
                raise BufferLocationError(
                    f"{slot}: device buffer but no device-capable coll "
                    f"component selected (have [{host_name}]; enable "
                    f"coll/xla and comm.bind_device(...) for the device "
                    f"path, or .cpu().numpy() the tensor if host staging "
                    f"is intended)")
            fn, provider = dev_fn, dev_name
        nbytes = int(getattr(buf, "nbytes", 0))
        if root_pos is not None:
            # Communicator passes root positionally (comm.py) — pull it
            # from its slot-specific position so a divergent-root
            # collective signs differently across ranks
            if len(args) > root_pos:
                root = args[root_pos]
            else:
                root = kw.get("root", -1)
            root = root if isinstance(root, int) else -1
        else:
            root = -1
        sig = trace_mod.collrec_sig(
            slot, getattr(buf, "dtype", None), nbytes, root)
        return _run_recorded(comm, slot, slot, sig, provider, nbytes,
                             fn, (buf, *args), kw)

    root_pos = _ROOT_ARG.get(slot)
    dispatch.__name__ = f"coll_{slot}_dispatch"
    return dispatch


def _make_traced_barrier(fn, provider):
    """Barrier has no buffer to classify; wrap the provider directly so
    the epoch still shows up on the recorder, the coll timeline and the
    dispatch histogram — a barrier's latency IS the wait for the last
    arriver."""
    sig = trace_mod.collrec_sig("barrier", None, 0)

    def barrier(comm, *args, **kw):
        return _run_recorded(comm, "barrier", "barrier", sig, provider,
                             0, fn, args, kw)

    return barrier


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
            setattr(module, slot, _make_traced_barrier(
                *((host_fn, host_name) if host_ok else (dev_fn, dev_name))))
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
