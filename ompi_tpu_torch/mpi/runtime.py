"""MPI init/finalize and the world communicator (the port's trimmed copy
of the JAX package's ``mpi/runtime.py``).

≈ ompi/runtime/ompi_mpi_init.c:375 — the bring-up sequence (:482-941):
identity from the environment (≈ ess/env reading PMIx), the job-wide
device view when the launcher named a rendezvous
(``parallel/multihost.py``: the rank's card and one ``torch.distributed``
group), PML selection (:655), the modex business-card exchange
(:673-703), world communicator construction with the collective table
(:934), and the final barrier.

Outside tpurun (no rendezvous URI) init degenerates to a singleton world,
like mpirun-less ./a.out singleton init in the reference.

The trace plane's hooks are the JAX package's: init arms the flight
recorder (``tpurun --trace`` / ``OMPI_TPU_TRACE=1``, with the SIGTERM
flush under a launcher), bridges the PML's events onto the timeline,
re-reads ``trace_hist_enable``, starts the metrics push when an
``OMPI_TPU_METRICS_URI`` is set and arms the hang-doctor responder under
a launcher; finalize stops the responder and the push and flushes the
dump; ``abort`` writes the crash dump.

The fault-tolerance branches are the JAX package's: under the ``notify``
or ``selfheal`` errmgr policy, or ``ft_enable``, init arms the ULFM
failure detector (``ft.attach_runtime``); a respawned life
(``OMPI_TPU_RESTART``) binds its card without rejoining the process
group, re-announces its business card to the survivors
(``announce_rebind``) and skips the init barrier they passed in its
previous life; finalize rendezvouses on the PMIx fence and leaves the
process group gracefully (under a watchdog) only when no death or
revival was seen.

The thread-level queries (``init_thread``, ``query_thread``,
``is_thread_main``) and ``pcontrol`` are the JAX package's: the runtime
is thread-safe throughout, so the level provided is always
``THREAD_MULTIPLE``.
"""

from __future__ import annotations

import atexit
import os
import sys
import threading
from typing import Optional

from ompi_tpu_torch.core import output
from ompi_tpu_torch.mpi.comm import Communicator
from ompi_tpu_torch.mpi.constants import MPIException
from ompi_tpu_torch.mpi.group import Group
from ompi_tpu_torch.mpi.pml import pml_framework
from ompi_tpu_torch.runtime import pmix

__all__ = ["init", "finalize", "initialized", "finalized", "abort",
           "COMM_WORLD", "COMM_SELF", "get_world", "wtime", "wtick",
           "init_thread", "query_thread", "is_thread_main", "pcontrol",
           "THREAD_SINGLE", "THREAD_FUNNELED", "THREAD_SERIALIZED",
           "THREAD_MULTIPLE",
           "get_processor_name", "get_version", "get_library_version"]

_log = output.get_stream("mpi")
_lock = threading.Lock()
_state: dict = {"world": None, "self": None, "client": None, "pml": None,
                "finalized": False, "main_thread": None}

COMM_WORLD: Optional[Communicator] = None
COMM_SELF: Optional[Communicator] = None

# MPI thread levels (mpi.h ordering: SINGLE < FUNNELED < SERIALIZED < MULTIPLE)
THREAD_SINGLE = 0
THREAD_FUNNELED = 1
THREAD_SERIALIZED = 2
THREAD_MULTIPLE = 3


def initialized() -> bool:
    return _state["world"] is not None


def finalized() -> bool:
    """≈ MPI_Finalized."""
    return bool(_state["finalized"])


def init_thread(required: int = THREAD_MULTIPLE
                ) -> tuple[Communicator, int]:
    """≈ MPI_Init_thread → (COMM_WORLD, provided).  This runtime is
    thread-safe throughout (per-object locks instead of a global progress
    lock), so provided is always THREAD_MULTIPLE."""
    return init(), THREAD_MULTIPLE


def query_thread() -> int:
    """≈ MPI_Query_thread."""
    return THREAD_MULTIPLE


def is_thread_main() -> bool:
    """≈ MPI_Is_thread_main: is this the thread that called init()?"""
    return threading.get_ident() == _state["main_thread"]


def pcontrol(level: int, *args) -> None:
    """≈ MPI_Pcontrol: profiling-level hook.  Like the reference's
    (ompi/mpi/c/pcontrol.c — an empty body), the default library takes no
    action; monitoring consumers may read the stored level."""
    _state["pcontrol_level"] = int(level)


def init() -> Communicator:
    """Bring up MPI; returns COMM_WORLD. Idempotent."""
    global COMM_WORLD, COMM_SELF
    with _lock:
        if _state["world"] is not None:
            return _state["world"]

        under_launcher = pmix.ENV_URI in os.environ
        if under_launcher:
            client = pmix.PMIxClient()
            rank, size = client.rank, client.size
        else:
            client, rank, size = None, 0, 1

        # job-wide device view: bind the rank's card and join the job's
        # process group (≈ the modex feeding transport bring-up,
        # pmix.h:384-407), before any CUDA work of this process; a no-op
        # unless the launcher exported a coordinator (tpurun --gpu).
        # A RESPAWNED rank must NOT rejoin: the group's store slot and
        # NCCL's communicator cannot take a new incarnation of a member.
        # The revived rank binds its card and runs on its own; the device
        # plane heals at the next job (or a restart from its snapshots).
        from ompi_tpu_torch.core.config import var_registry as _vars
        from ompi_tpu_torch.parallel import multihost

        restarted = bool(os.environ.get("OMPI_TPU_RESTART"))
        if restarted or not _vars.get("multihost_auto_init"):
            if multihost.is_multihost_env():
                _log.verbose(1, "%s: skipping the process group's join "
                             "(card bound, one-process device view)",
                             "respawned rank" if restarted
                             else "multihost_auto_init 0")
            multihost.bind_card_from_env()
        else:
            multihost.initialize_from_env()

        pml = pml_framework.select().create(rank)

        # flight recorder (tpurun --trace / OMPI_TPU_TRACE=1): arm the
        # per-rank ring buffer, bridge the PML's PERUSE hooks onto the
        # timeline, and install the SIGTERM flush so the launcher's
        # abort path (SIGTERM → grace → SIGKILL) still yields a readable
        # trace from every rank
        from ompi_tpu_torch.mpi import trace as _trace

        jobid = int(os.environ.get(pmix.ENV_JOBID, "0") or 0)
        if _trace.env_enabled() or _trace.active:
            # enable() is idempotent and stamps rank/jobid onto an
            # already-armed recorder; a NEW pml per init epoch needs its
            # own bridge (finalize detached the previous epoch's)
            _trace.enable(rank=rank, jobid=jobid,
                          install_signal=under_launcher)
            _trace.attach_pml(pml)
            _trace.instant("runtime", "init", rank=rank, size=size)

        # latency-histogram plane: re-read trace_hist_enable into the
        # module flag the record sites check
        _trace.refresh_hist_enable()

        # metrics uplink (independent of the timeline): armed when a
        # collector URI was exported and the push period is on
        _trace.start_metrics_push(jobid, rank)

        # hang-doctor responder: the rank-side capture endpoint (UDP,
        # port registered with the PMIx server via the 'doctor' RPC),
        # armed under a launcher only
        if under_launcher:
            from ompi_tpu_torch.runtime import doctor as _doctor

            _doctor.start_responder(rank, jobid=jobid, pml=pml,
                                    client=client)

        if size > 1:
            assert client is not None
            # modex: publish my BTL business card, fence, learn everyone's
            # (≈ ompi_mpi_init.c:673-703)
            client.put("btl.addr", pml.address)
            cards = client.fence(collect=True)
            peers = {
                r: cards[f"btl.addr@{r}"] for r in range(size) if r != rank
            }
            pml.set_peers(peers)
            if restarted:
                # errmgr/respawn revival: survivors hold my DEAD
                # incarnation's card — re-announce so they re-route and
                # reset the wire-seq space toward me
                pml.announce_rebind(peers)
            # ULFM failure detector: under the notify or selfheal errmgr
            # policies (or forced via ft_enable) peer deaths reported by
            # the control plane surface as MPI_ERR_PROC_FAILED instead
            # of a hang / full retry-window stall — and under selfheal
            # the same detector's revive listeners flip the peer back
            # alive when the errmgr's revive lands.  Off under plain
            # respawn by default: its dead-set is transient while a rank
            # revives and nothing user-visible consumes it.
            # both modules register their config vars on import — the
            # launcher has them, this app process may not yet
            from ompi_tpu_torch.mpi import ft as ft_mod
            from ompi_tpu_torch.runtime import errmgr as _errmgr_mod  # noqa: F401

            # token match, not substring: the selection var supports
            # comma lists and ^exclusion ("--mca errmgr ^notify" must
            # NOT arm the detector)
            selected = {t.strip()
                        for t in str(_vars.get("errmgr") or "").split(",")}
            if _vars.get("ft_enable") or selected & {"notify", "selfheal"}:
                ft_mod.attach_runtime(pml, client)

        world = Communicator(Group(range(size)), cid=0, my_world_rank=rank,
                             name="WORLD", pml=pml)
        selfc = Communicator(Group([rank]), cid=1, my_world_rank=rank,
                             name="SELF", pml=pml)
        _state.update(world=world, self=selfc, client=client, pml=pml)
        COMM_WORLD, COMM_SELF = world, selfc
        _log.verbose(1, "init complete: rank %d/%d", rank, size)

        # final barrier: everyone reachable before user code runs.  A
        # RESPAWNED rank skips it — the survivors passed this barrier in a
        # previous epoch and will not pair it again (they rendezvous with
        # the revived rank at the finalize fence instead).
        if size > 1 and not restarted:
            world.barrier()
        if client is not None:
            client.ready()
        _state["main_thread"] = threading.get_ident()
        _state["finalized"] = False
        atexit.register(_atexit_finalize)
        return world


def get_world() -> Communicator:
    if _state["world"] is None:
        raise MPIException("MPI not initialized (call ompi_tpu_torch.init())")
    return _state["world"]


def finalize(_collective: bool = True) -> None:
    """Tear down: final rendezvous, close transports (≈ ompi_mpi_finalize)."""
    global COMM_WORLD, COMM_SELF
    with _lock:
        world = _state["world"]
        if world is None:
            return
        from ompi_tpu_torch.parallel import multihost

        # a death or a respawn anywhere in the job means one member of
        # the process group is gone or never rejoined — its teardown
        # could wait on it.  Decided AFTER the final rendezvous (whose
        # frames carry a revived peer's incarnation stamp); ranks can
        # still disagree in narrow races, which multihost.shutdown's
        # watchdog bounds: the worst case is a logged delay, not a hang.
        pml = _state["pml"]

        def graceful() -> bool:
            ft = getattr(pml, "ft", None)
            return not (getattr(pml, "incarnation", 0)
                        or any(getattr(pml, "_peer_inc", {}).values())
                        or (ft is not None
                            and ft.detector.dead_ranks()))

        try:
            if world.size > 1 and _collective:
                client = _state["client"]
                # Rendezvous on the PMIx CONTROL PLANE, not a p2p
                # barrier: after a respawn, a barrier frame stamped
                # before its sender adopted a LATE revival's incarnation
                # is epoch-fenced (or died in the old incarnation's
                # inbox), and finalize's barrier is the one collective
                # that cannot be re-run.  The control plane tracked every
                # death and revival (fences re-evaluate on death; a
                # revived rank re-ran the init fence, so epoch counters
                # align) — the reference's runtime-mediated shutdown.
                if client is not None:
                    client.fence()
                else:
                    world.barrier()
            if _collective:
                # leave the process group while every live rank is still
                # here (post-rendezvous)
                multihost.shutdown(graceful=graceful())
        finally:
            # no-op if already left (a non-collective finalize skips the
            # group's teardown: a peer may be gone)
            multihost.shutdown(graceful=False)
            from ompi_tpu_torch.mpi import trace as _trace
            from ompi_tpu_torch.runtime import doctor as _doctor

            _doctor.stop_responder()   # re-armed by a later init epoch
            # final full metrics push: a short job's last counter state
            # still reaches the collector before the rank is gone
            _trace.stop_metrics_push(flush=True)
            pml = _state["pml"]
            if _trace.active:
                # a clean teardown flushes too: a tpurun --trace run
                # reads the per-rank dumps after a clean exit
                _trace.instant("runtime", "finalize",
                               rank=getattr(pml, "rank", -1))
                try:
                    _trace.flush()
                except Exception:  # noqa: BLE001 — teardown continues
                    pass
                _trace.detach_pml(pml)   # a re-init epoch re-arms fresh
            if pml is not None:
                pml.close()
            client = _state["client"]
            if client is not None:
                try:
                    client.finalize()
                except Exception:  # noqa: BLE001 — teardown continues
                    pass
            _state.update(world=None, self=None, client=None, pml=None,
                          finalized=True)
            COMM_WORLD = COMM_SELF = None


def _atexit_finalize() -> None:
    # Exiting without MPI_Finalize is erroneous (MPI-3.1 §8.7); a
    # collective barrier here would block this process forever (peers may
    # be dead), so close transports non-collectively and let the
    # launcher's errmgr act on the exit.
    if _state["world"] is None:
        return
    _log.verbose(0, "process exiting without finalize(); closing transports")
    try:
        finalize(_collective=False)
    except Exception:  # noqa: BLE001
        pass


def abort(errorcode: int = 1, msg: str = "") -> None:
    """≈ MPI_Abort: terminate ALL ranks of the job, not just this one.

    Under a launcher the abort rides the PMIx control plane (the HNP
    tears the job down, ≈ orterun's response to PMIx_Abort); a singleton
    simply exits with the code.  Does not return.
    """
    client = _state.get("client")
    _log.error("MPI_Abort(%d)%s", errorcode, f": {msg}" if msg else "")
    from ompi_tpu_torch.mpi import trace as _trace

    if _trace.active:
        # flush THIS rank's flight recorder before teardown; peers flush
        # from the SIGTERM the launcher's abort fans out
        _trace.crash_dump(reason=f"MPI_Abort({errorcode})")
    if client is not None:
        try:
            client.abort(msg or f"MPI_Abort({errorcode})",
                         status=int(errorcode))
        except Exception:  # noqa: BLE001 — the exit below still happens
            pass
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(int(errorcode) & 0xFF or 1)


def get_processor_name() -> str:
    """≈ MPI_Get_processor_name — the host identity the transports use."""
    from ompi_tpu_torch.core.sysinfo import host_identity

    return host_identity()


#: the MPI standard generation whose semantics this API follows
_MPI_VERSION = (3, 1)


def get_version() -> tuple[int, int]:
    """≈ MPI_Get_version: (version, subversion) of the MPI semantics."""
    return _MPI_VERSION


def get_library_version() -> str:
    """≈ MPI_Get_library_version (the JAX package's string, naming the
    port and its version)."""
    from ompi_tpu_torch import __version__

    return (f"ompi_tpu_torch {__version__} (MPI {_MPI_VERSION[0]}."
            f"{_MPI_VERSION[1]} semantics, CUDA-native)")


def wtime() -> float:
    """≈ MPI_Wtime: seconds from an arbitrary epoch, monotonic."""
    from ompi_tpu_torch.core.sysinfo import Timer

    return Timer.cycles() / 1e9


def wtick() -> float:
    """≈ MPI_Wtick: resolution of :func:`wtime` in seconds."""
    from ompi_tpu_torch.core.sysinfo import Timer

    return Timer.resolution_s()
