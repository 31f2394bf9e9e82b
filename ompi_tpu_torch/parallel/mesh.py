"""Mesh construction for the port.

The JAX package addresses chips as a ``jax.sharding.Mesh`` whose axes
carry parallelism roles (dp/sp/tp/...), driven from one process.  PyTorch
on GPUs runs one process per rank, so the port's :class:`Mesh` is a
multi-process mesh: the ranks of a ``torch.distributed`` process group
laid out row-major over ``shape`` (``devices`` is that integer array of
ranks, the counterpart of ``jax.sharding.Mesh.devices``).  Rank ``r``
owns ``cuda:{r % torch.cuda.device_count()}`` (:func:`card_index`, the
launcher's ``OMPI_TPU_CHIP`` binding), or the CPU.

The mesh keeps two kinds of process groups, made at init by every rank
in one fixed order (``new_group`` is collective, so a group made lazily
by some ranks only would deadlock):

- **host groups** (gloo, CPU tensors) for handle exchange, object
  gathers and barriers;
- **device groups** for the collectives: NCCL when every rank of the
  group owns its own card, gloo when the mesh is on the CPU, and none
  when ranks of the group share a card (NCCL refuses two ranks of one
  communicator on one card; the one-sided ops, which need no device
  group, still run there).

There is one group of each kind for every set of axes and every
coordinate of the other axes, so a communicator over any subset of the
axes (``DeviceCommunicator.sub``) finds its group ready.

Without process-group arguments and with no group initialised,
:func:`make_mesh` gives the one-process mesh of the earlier slices: every
axis of size 1, no groups.
"""

from __future__ import annotations

import itertools
import math
import os
import socket
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "mesh_shape_for", "resolve_device",
           "local_block", "card_index"]


def resolve_device(device) -> torch.device:
    """The explicit ``torch.device`` for an entry point; a CUDA device on
    a machine without CUDA raises (the port never drops quietly to the
    CPU — callers that want the CPU say ``device="cpu"``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev


def mesh_shape_for(n_devices: int, axis_names: Sequence[str]) -> dict[str, int]:
    """Factor n_devices over the axes, largest factors innermost (the last
    axis gets the largest factor → tensor-parallel on the fastest links).

    Outer axes take the largest divisor ≤ the remaining geometric mean
    (rounded down), so the leftover — always ≥ the mean — lands innermost.
    """
    names = list(axis_names)
    shape = {name: 1 for name in names}
    remaining = n_devices
    for i, name in enumerate(names[:-1]):
        axes_left = len(names) - i
        target = int(math.floor(remaining ** (1 / axes_left)))
        f = 1
        for cand in range(max(1, target), 0, -1):
            if remaining % cand == 0:
                f = cand
                break
        shape[name] = f
        remaining //= f
    shape[names[-1]] = remaining
    return shape


def card_index(rank: int) -> int:
    """The card rank ``rank`` owns: ``rank % torch.cuda.device_count()``.
    On a one-host job that is the launcher's binding (``OMPI_TPU_CHIP``,
    local rank r on card r, wrapping); a launcher binding that disagrees
    raises instead of leaving two views of one rank's card."""
    idx = int(rank) % torch.cuda.device_count()
    chip = os.environ.get("OMPI_TPU_CHIP")
    if chip is not None and int(chip) != idx:
        raise RuntimeError(
            f"rank {rank}: the launcher bound card {chip} (OMPI_TPU_CHIP) "
            f"but the mesh binds rank % device_count() = {idx}; launch "
            f"one host's ranks with tpurun --gpu, which binds the same "
            f"card")
    return idx


def _card_id(device: torch.device) -> str:
    """The card's UUID (host and index where PyTorch does not give one)."""
    props = torch.cuda.get_device_properties(device)
    uuid = getattr(props, "uuid", None)
    return str(uuid) if uuid is not None else (
        f"{socket.gethostname()}:{device.index}")


class Mesh:
    """Named axes over the ranks of the process group (one rank, and no
    group, when none is initialised)."""

    def __init__(self, shape: dict[str, int], device="cuda") -> None:
        self.shape = {str(a): int(s) for a, s in shape.items()}
        self.axis_names = tuple(self.shape)
        sizes = tuple(self.shape.values())
        total = math.prod(sizes)
        distributed = dist.is_available() and dist.is_initialized()
        self.world_size = dist.get_world_size() if distributed else 1
        self.rank = dist.get_rank() if distributed else 0
        if total != self.world_size:
            raise ValueError(
                f"mesh shape {self.shape} needs {total} ranks, the process "
                f"group has {self.world_size} (start one process per rank "
                "and pass rank, world_size and init_method to make_mesh)")
        dev = resolve_device(device)
        if dev.type == "cuda" and distributed and dev.index is None:
            dev = torch.device("cuda", card_index(self.rank))
        self.device = dev
        #: ranks laid out row-major over the axes
        self.devices = np.arange(total).reshape(sizes)
        #: symmetric windows allocated over this mesh, by data pointer
        self.windows: dict = {}
        self.card_ids: Optional[list[str]] = None
        self._host: dict = {}
        self._device: dict = {}
        self._world_host = None
        if distributed:
            self._make_groups()

    # -- groups ------------------------------------------------------------

    def _make_groups(self) -> None:
        names = self.axis_names
        self._world_host = dist.new_group(list(range(self.world_size)),
                                          backend="gloo")
        if self.device.type == "cuda":
            self.card_ids = self.all_gather_object(_card_id(self.device))
        for k in range(1, len(names) + 1):
            for axes in itertools.combinations(names, k):
                key = frozenset(axes)
                others = [a for a in names if a not in axes]
                for fixed in itertools.product(
                        *(range(self.shape[a]) for a in others)):
                    members = sorted(self._members_at(
                        axes, dict(zip(others, fixed))))
                    mine = self.rank in members
                    if len(axes) == len(names):
                        host = self._world_host
                    else:
                        host = dist.new_group(members, backend="gloo")
                    device = host if self.device.type == "cpu" else None
                    if self.device.type == "cuda" and len(
                            {self.card_ids[r] for r in members}) == len(
                                members):
                        device = dist.new_group(members, backend="nccl")
                    if mine:
                        self._host[key] = host
                        self._device[key] = device

    def coords(self, rank: Optional[int] = None) -> tuple[int, ...]:
        """Coordinates of ``rank`` (default: mine) along each axis."""
        r = self.rank if rank is None else int(rank)
        return tuple(int(c) for c in np.unravel_index(
            r, tuple(self.shape.values())))

    def coord(self, axis: str) -> int:
        """My coordinate along ``axis``."""
        return self.coords()[self.axis_names.index(axis)]

    def _members_at(self, axes: Sequence[str], fixed: dict) -> list[int]:
        """Ranks row-major over ``axes`` (in that order) whose other
        coordinates are ``fixed``."""
        out = []
        for combo in itertools.product(*(range(self.shape[a]) for a in axes)):
            c = dict(fixed)
            c.update(zip(axes, combo))
            out.append(int(self.devices[tuple(c[a] for a in
                                              self.axis_names)]))
        return out

    def members(self, axes: Sequence[str]) -> list[int]:
        """The ranks of my group over ``axes``, in communicator rank order
        (row-major over ``axes`` as given)."""
        mine = dict(zip(self.axis_names, self.coords()))
        return self._members_at(list(axes), {a: mine[a] for a in
                                             self.axis_names if a not in axes})

    def host_group(self, axes: Sequence[str]):
        """My gloo group over ``axes`` (None without a process group)."""
        return self._host.get(frozenset(axes))

    def device_group(self, axes: Sequence[str]):
        """My device-collective group over ``axes``: None without a
        process group, or when ranks of the group share a card."""
        return self._device.get(frozenset(axes))

    @property
    def shares_card(self) -> bool:
        """True when two ranks of the mesh own the same card."""
        return (self.card_ids is not None
                and len(set(self.card_ids)) < len(self.card_ids))

    # -- host-plane helpers --------------------------------------------------

    def all_gather_object(self, obj) -> list:
        """Every rank's ``obj``, in rank order, over the host group."""
        if self._world_host is None:
            return [obj]
        out = [None] * self.world_size
        dist.all_gather_object(out, obj, group=self._world_host)
        return out

    def host_barrier(self, axes: Optional[Sequence[str]] = None) -> None:
        group = (self._world_host if axes is None
                 else self.host_group(axes))
        if group is not None:
            dist.barrier(group=group)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, device={str(self.device)!r}, "
                f"rank={self.rank})")


def make_mesh(axes: Optional[dict[str, int] | Sequence[str]] = None,
              device="cuda", *, rank: Optional[int] = None,
              world_size: Optional[int] = None,
              init_method: Optional[str] = None) -> Mesh:
    """Build a Mesh over the ranks of the process group.

    - ``make_mesh()`` → 1-D mesh ("world").
    - ``make_mesh({"dp": 2, "tp": 2})`` → explicit shape (must multiply to
      the world size; a -1 entry is inferred).
    - ``make_mesh(["dp", "tp"])`` → auto-factored shape.

    With ``rank``, ``world_size`` and ``init_method``
    (``tcp://127.0.0.1:<port>``, or ``file://<path>``) it first joins the
    process group (gloo; the device groups are made by the mesh), and on
    the card binds this process to the rank's card.  Without them it uses
    the group already initialised, or else gives the one-process mesh.
    """
    group_args = (rank, world_size, init_method)
    if any(a is not None for a in group_args):
        if any(a is None for a in group_args):
            raise ValueError("make_mesh: pass rank, world_size and "
                             "init_method together")
        dev = resolve_device(device)
        if dist.is_initialized():
            raise RuntimeError("make_mesh: a process group is already "
                               "initialised; call make_mesh without "
                               "rank/world_size/init_method to use it")
        if dev.type == "cuda":
            torch.cuda.set_device(card_index(int(rank)))
        dist.init_process_group("gloo", init_method=init_method,
                                rank=int(rank), world_size=int(world_size))
    n = dist.get_world_size() if dist.is_initialized() else 1
    if axes is None:
        return Mesh({"world": n}, device=device)
    if not isinstance(axes, dict):
        axes = mesh_shape_for(n, list(axes))
    sizes = dict(axes)
    unknown = [a for a, s in sizes.items() if s == -1]
    if len(unknown) == 1:
        known = math.prod(s for s in sizes.values() if s != -1)
        sizes[unknown[0]] = max(1, n // known)
    return Mesh(sizes, device=device)


def local_block(x, mesh: Mesh, spec: Sequence[Optional[str]]):
    """This rank's block of the global array ``x`` (numpy or torch) under
    ``spec``, a ``PartitionSpec``-like tuple: dimension i is split evenly
    over the mesh axis ``spec[i]`` and the block at my coordinate along
    it is kept; None, an axis the mesh lacks, or a missing entry keeps
    the dimension whole.  ``local_block(tokens, mesh, ("dp", "sp"))`` is
    the (B/dp, S/sp) token shard a rank passes to the training entry
    points: the JAX package's ``P("dp", "sp")`` block at its
    coordinates."""
    mine = dict(zip(mesh.axis_names, mesh.coords()))
    index = []
    for dim, ax in enumerate(spec):
        n = int(mesh.shape.get(ax, 1)) if ax is not None else 1
        if n == 1:
            index.append(slice(None))
            continue
        size = x.shape[dim]
        if size % n:
            raise ValueError(f"dimension {dim} ({size}) is not divisible "
                             f"by mesh axis {ax!r} ({n})")
        b = size // n
        index.append(slice(mine[ax] * b, (mine[ax] + 1) * b))
    return x[tuple(index)]
