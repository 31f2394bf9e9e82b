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
- ``simulator`` — fabricates a cluster from config vars, cloning
  orte/mca/ras/simulator/ras_sim_module.c:67-91 (``ras_sim_num_nodes``,
  ``ras_sim_slots_per_node``); never auto-selected (``--mca ras
  simulator``, which ``tpurun --plm sim`` sets).  It feeds the daemon
  tree's simulated hosts.  One rule is the port's own: where the JAX
  package's nodes carry fake chip names (``ras_sim_chips_per_node``, which
  the port registers and does not read), a PyTorch rank must bind a real
  card, so under ``want_gpu`` (``tpurun --plm sim --gpu``) the simulated
  nodes carry this machine's real cards, counted as the ``gpu`` component
  counts them.  With at least as many cards as nodes each node gets
  ``count // nodes`` distinct cards in order (2 hosts on a 4-card
  machine own cards 0, 1 and 2, 3); with fewer every node carries all of
  them.  The rank with local rank r on a node binds its node's card
  ``r % len(chips)``.  With no card it raises
  :class:`NoCardError`, as ``--gpu`` does.  Without ``want_gpu`` the nodes
  carry no cards and the launcher imports no torch.
- ``hostfile`` — parses a hostfile (``name slots=N`` lines) named by
  ``--hostfile`` or ``--mca ras_hostfile``; ``tpurun --plm ssh`` starts
  one daemon on each of its hosts.
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


def _card_count() -> int:
    """This machine's CUDA cards; :class:`NoCardError` when it has none."""
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise NoCardError(
            "--gpu: this machine has no CUDA card "
            "(torch.cuda.device_count() is 0), so no rank can be bound "
            "to one; run without --gpu for the host plane on CPU slots")
    return n


@ras_framework.component
class SimulatorRAS(Component):
    """Fake clusters (≈ ras_sim: num_nodes/slots params); under
    ``want_gpu`` the fake nodes share out the real cards."""

    NAME = "simulator"
    PRIORITY = 0  # never auto-selected; opt in via --mca ras simulator

    def register_params(self) -> None:
        register_var("ras", "sim_num_nodes", VarType.INT, 2,
                     "simulator: number of fake nodes")
        register_var("ras", "sim_slots_per_node", VarType.INT, 4,
                     "simulator: slots per fake node")
        register_var("ras", "sim_chips_per_node", VarType.INT, 0,
                     "simulator: the JAX package's fake chips per node; "
                     "not read here (the port's fake nodes carry the "
                     "real cards under --gpu and none without)")

    def query(self, **ctx):
        return self.PRIORITY if ctx.get("allow_simulator", True) else None

    def allocate(self, job: Job, **ctx) -> list[Node]:
        n = var_registry.get("ras_sim_num_nodes")
        slots = var_registry.get("ras_sim_slots_per_node")
        count = _card_count() if ctx.get("want_gpu", False) else 0
        per = count // n if count >= n else 0
        nodes = []
        for i in range(n):
            node = Node(name=f"sim{i:03d}", slots=slots)
            if count:
                node.chips = (list(range(i * per, i * per + per)) if per
                              else list(range(count)))
                node.topology = {"chips": len(node.chips), "cores": slots}
            nodes.append(node)
        return nodes


@ras_framework.component
class GpuRAS(Component):
    """One slot per local CUDA card: ranks map 1:1 onto cards."""

    NAME = "gpu"
    PRIORITY = 50

    def query(self, **ctx):
        return self.PRIORITY if ctx.get("want_gpu", False) else None

    def allocate(self, job: Job, **ctx) -> list[Node]:
        n = _card_count()
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
