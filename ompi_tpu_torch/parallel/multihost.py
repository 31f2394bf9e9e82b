"""Job-wide device view: join the launched ranks into one process group
(the port's counterpart of the JAX package's ``parallel/multihost.py``).

The runtime side of the modex (≈ opal/mca/pmix/pmix.h:328-861: the
business-card exchange that feeds transport bring-up).  The launcher
exports three facts into every rank's environment:

- ``OMPI_TPU_COORD``  — ``host:port`` of the rendezvous (a free port on
  rank 0's host, picked by the launcher under ``tpurun --gpu``);
- ``OMPI_TPU_NHOSTS`` — how many hosts the job spans;
- rank identity (``OMPI_TPU_RANK``/``SIZE``) from pmix, and the card the
  rank is bound to (``OMPI_TPU_CHIP``).

:func:`initialize_from_env` turns those into one ``torch.distributed``
view: the rank binds its card (``torch.cuda.set_device``) and joins the
gloo group at ``tcp://<coord>``, the group kind :func:`make_mesh` joins
(its device sub-groups are NCCL when every rank owns its own card).
``make_mesh()`` without arguments then spans the job, and its own
``rank % device_count()`` card binding agrees with ``OMPI_TPU_CHIP``
(both are the rank's local index on a one-host job).

Where the JAX package joins ``jax.distributed`` (one process drives its
chips, so a multi-host job is the only case), a PyTorch rank owns one
card, so the port joins the group for every ``--gpu`` job, one host
included.

The card binding and the group's join are two steps
(:func:`bind_card_from_env`, then the join), because a group cannot take
a member's new life: the TCPStore's rank slot and NCCL's communicator
are fixed at the join, as the JAX package's coordination service refuses
a reconnecting incarnation.  Under a reviving errmgr policy (respawn,
selfheal) the launcher exports ``multihost_auto_init`` 0
(``errmgr.apply_host_plane_policy``), and a revived life
(``OMPI_TPU_RESTART``) never rejoins: such a rank still binds its card
and runs the one-process mesh on it (``make_mesh()`` then spans one
rank), and a device-plane job recovers by a restart from its
``ckpt`` snapshots.  :func:`shutdown` leaves the group under a 10 s
watchdog, or not at all (``graceful=False``) when a member is known dead
or revived: ``destroy_process_group`` on a group with a dead member can
block.
"""

from __future__ import annotations

import datetime
import os
import threading

from ompi_tpu_torch.core import output
from ompi_tpu_torch.core.config import VarType, register_var, var_registry

__all__ = ["ENV_COORD", "ENV_NHOSTS", "ENV_CHIP", "is_multihost_env",
           "bind_card_from_env", "initialize_from_env", "is_initialized",
           "shutdown"]

_log = output.get_stream("multihost")

ENV_COORD = "OMPI_TPU_COORD"
ENV_NHOSTS = "OMPI_TPU_NHOSTS"
ENV_CHIP = "OMPI_TPU_CHIP"

register_var("multihost", "init_timeout", VarType.DOUBLE, 60.0,
             "seconds to wait for all ranks to join the job's "
             "torch.distributed process group")
register_var("multihost", "auto_init", VarType.BOOL, True,
             "join the job-wide device view during MPI init when the "
             "launcher exported a coordinator address")

#: seconds the graceful leave may take before it is abandoned
_SHUTDOWN_WATCHDOG_S = 10.0

_lock = threading.Lock()
_state = {"initialized": False}


def is_multihost_env() -> bool:
    """Did the launcher export a rendezvous for this job's device view?"""
    return ENV_COORD in os.environ


def bind_card_from_env() -> bool:
    """Bind this process to the card the launcher gave it
    (``OMPI_TPU_CHIP``), without joining any group.  True when a card was
    bound; a rank with no card binding (a host-plane job) never imports
    torch here."""
    chip = os.environ.get(ENV_CHIP)
    if chip is None:
        return False
    import torch

    if not torch.cuda.is_available():
        return False
    torch.cuda.set_device(int(chip))
    _log.verbose(1, "multihost: bound card %s", chip)
    return True


def initialize_from_env() -> bool:
    """Join the job-wide process group if the env names a rendezvous.

    Returns True once this process is part of the group (idempotent),
    False when the launcher exported none.  Binds the rank's card first,
    so every later ``"cuda"`` tensor of this process lands on it.
    """
    with _lock:
        if _state["initialized"]:
            return True
        if not is_multihost_env():
            return False
        import torch.distributed as dist

        coord = os.environ[ENV_COORD]
        rank = int(os.environ.get("OMPI_TPU_RANK", "0"))
        size = int(os.environ.get("OMPI_TPU_SIZE", "1"))
        chip = os.environ.get(ENV_CHIP)
        bind_card_from_env()
        timeout = float(var_registry.get("multihost_init_timeout") or 60)
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coord}", rank=rank,
            world_size=size, timeout=datetime.timedelta(seconds=timeout))
        _state["initialized"] = True
        _log.verbose(1, "multihost: rank %d/%d joined %s (card %s)",
                     rank, size, coord, chip)
        return True


def is_initialized() -> bool:
    return _state["initialized"]


def shutdown(graceful: bool = True) -> None:
    """Leave the process group (call after the final rendezvous, so every
    rank leaves before rank 0's rendezvous store goes away).

    ``graceful=False`` skips ``destroy_process_group``: a member that died
    or was respawned mid-job never leaves, and the teardown could wait on
    it.  Process exit reclaims the group.  A graceful leave runs under a
    10 s watchdog, so ranks that disagree about a death (a report racing
    finalize) cost a logged delay, never a hang.
    """
    with _lock:
        if not _state["initialized"]:
            return
        _state["initialized"] = False
    if not graceful:
        _log.verbose(1, "multihost: skipping the group's teardown (a "
                     "member died or was respawned)")
        return

    def _do() -> None:
        import torch.distributed as dist

        if dist.is_initialized():
            try:
                dist.destroy_process_group()
            except Exception as e:  # noqa: BLE001 — teardown best-effort
                _log.verbose(1, "multihost shutdown: %r", e)

    t = threading.Thread(target=_do, daemon=True)
    t.start()
    t.join(timeout=_SHUTDOWN_WATCHDOG_S)
    if t.is_alive():
        _log.error("multihost: the process group's teardown did not "
                   "complete in %.0fs (a member gone?); abandoning the "
                   "wait", _SHUTDOWN_WATCHDOG_S)
