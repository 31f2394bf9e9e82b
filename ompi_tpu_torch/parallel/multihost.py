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
"""

from __future__ import annotations

import datetime
import os
import threading

from ompi_tpu_torch.core import output
from ompi_tpu_torch.core.config import VarType, register_var, var_registry

__all__ = ["ENV_COORD", "ENV_NHOSTS", "ENV_CHIP", "is_multihost_env",
           "initialize_from_env", "is_initialized", "shutdown"]

_log = output.get_stream("multihost")

ENV_COORD = "OMPI_TPU_COORD"
ENV_NHOSTS = "OMPI_TPU_NHOSTS"
ENV_CHIP = "OMPI_TPU_CHIP"

register_var("multihost", "init_timeout", VarType.DOUBLE, 60.0,
             "seconds to wait for all ranks to join the job's "
             "torch.distributed process group")

_lock = threading.Lock()
_state = {"initialized": False}


def is_multihost_env() -> bool:
    """Did the launcher export a rendezvous for this job's device view?"""
    return ENV_COORD in os.environ


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
        import torch
        import torch.distributed as dist

        coord = os.environ[ENV_COORD]
        rank = int(os.environ.get("OMPI_TPU_RANK", "0"))
        size = int(os.environ.get("OMPI_TPU_SIZE", "1"))
        chip = os.environ.get(ENV_CHIP)
        if chip is not None and torch.cuda.is_available():
            torch.cuda.set_device(int(chip))
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


def shutdown() -> None:
    """Leave the process group (call after the final barrier, so every
    rank leaves before rank 0's rendezvous store goes away)."""
    with _lock:
        if not _state["initialized"]:
            return
        _state["initialized"] = False
    import torch.distributed as dist

    if dist.is_initialized():
        try:
            dist.destroy_process_group()
        except Exception as e:  # noqa: BLE001 — teardown best-effort
            _log.verbose(1, "multihost shutdown: %r", e)
