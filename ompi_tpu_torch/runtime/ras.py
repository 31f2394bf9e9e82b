"""RAS — resource allocation framework (the port's trimmed copy of the JAX
package's ``runtime/ras.py``).

≈ orte/mca/ras: turns "where can I run" into a list of Nodes.  Components:

- ``localhost`` — N slots on this host (by default the cpus this process
  may schedule on, from ``core.hwtopo.discover``, which the launch path
  calls without the accelerator probe); the analog of oversubscribed
  local launch, the workhorse for tests.
- ``gpu``       — one slot per local CUDA card
  (``torch.cuda.device_count()``), with ``chips`` the card indices, so
  ranks map 1:1 onto cards (``tpurun --gpu``; it takes the place of the
  JAX package's ``tpu`` component).  More ranks than cards wrap around
  the cards (rmaps), so ranks share a card: the host plane still runs
  there, and the device route refuses the shared card.  There is no
  fallback: ``--gpu`` on a machine with no CUDA card fails with a
  message instead of dropping to ``localhost`` slots.
- ``hostfile`` — parses a hostfile (``name slots=N`` lines) named by
  ``--mca ras_hostfile``.  Every node's ranks start on this host: the
  launch onto other hosts (plm ssh) is left out.

Left out: the ``simulator`` component, which feeds the multi-host
simulated launch (plm sim; ROADMAP.md Queue 1 item 6).
"""

from __future__ import annotations

import os
from typing import Optional

from ompi_tpu_torch.core.config import VarType, register_var, var_registry
from ompi_tpu_torch.core.mca import Component, Framework
from ompi_tpu_torch.runtime.job import Job, Node

__all__ = ["ras_framework", "allocate", "NoCardError"]

ras_framework = Framework("ras", "resource allocation")


class NoCardError(RuntimeError):
    """``--gpu`` asked for cards and the machine has none."""


@ras_framework.component
class LocalhostRAS(Component):
    NAME = "localhost"
    PRIORITY = 10

    def register_params(self) -> None:
        register_var("ras", "localhost_slots", VarType.INT, 0,
                     "slots on localhost (0 = discovered topology: "
                     "cpus this process may schedule on)")

    def allocate(self, job: Job, **ctx) -> list[Node]:
        slots = var_registry.get("ras_localhost_slots")
        if not slots:
            # topology-derived default (≈ hwloc feeding ras): the cpuset
            # width, not raw cpu count — a containerized launcher sees its
            # quota, not the whole machine
            from ompi_tpu_torch.core.hwtopo import discover

            slots = discover().allowed_cpus
        # mpirun-style oversubscription: never under-allocate the job
        slots = max(slots, job.np)
        return [Node(name="localhost", slots=slots)]


@ras_framework.component
class GpuRAS(Component):
    """One slot per local CUDA card: ranks map 1:1 onto cards."""

    NAME = "gpu"
    PRIORITY = 50

    def query(self, **ctx):
        return self.PRIORITY if ctx.get("want_gpu", False) else None

    def allocate(self, job: Job, **ctx) -> list[Node]:
        import torch

        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise NoCardError(
                "--gpu: this machine has no CUDA card "
                "(torch.cuda.device_count() is 0), so no rank can be bound "
                "to one; run without --gpu for the host plane on CPU slots")
        return [Node(name=os.uname().nodename, slots=n,
                     chips=list(range(n)))]


@ras_framework.component
class HostfileRAS(Component):
    NAME = "hostfile"
    PRIORITY = 40

    def register_params(self) -> None:
        register_var("ras", "hostfile", VarType.STRING, "",
                     "path to hostfile (lines: <name> [slots=N])")

    def query(self, **ctx):
        path = ctx.get("hostfile") or var_registry.get("ras_hostfile")
        return self.PRIORITY if path else None

    def allocate(self, job: Job, hostfile: Optional[str] = None,
                 **ctx) -> list[Node]:
        path = hostfile or var_registry.get("ras_hostfile")
        nodes = []
        with open(path) as fh:
            for line in fh:
                line = line.split("#", 1)[0].strip()
                if not line:
                    continue
                parts = line.split()
                slots = 1
                for p in parts[1:]:
                    if p.startswith("slots="):
                        slots = int(p.split("=", 1)[1])
                nodes.append(Node(name=parts[0], slots=slots))
        return nodes


def allocate(job: Job, **context) -> Job:
    """Run the allocation phase: fill job.nodes (≈ orte_ras_base_allocate)."""
    comp = ras_framework.select(**context)
    job.nodes = comp.allocate(job, **context)
    if not job.nodes or sum(n.slots for n in job.nodes) == 0:
        raise RuntimeError("allocation produced no usable slots")
    return job
