"""In-process multi-rank harness of the port: N PMLs + communicators on
threads (the port's copy of ``tests/mpi/harness.py``'s ``run_ranks``; it
imports no JAX package).

Real matching, real frames: ranks of one process reach each other over
the proc BTL, or over the shm rings when ``btl="^proc"`` (``--mca btl
^proc``) leaves proc out, or over tcp sockets with ``btl="^proc,shm"``,
with no subprocess spawn cost; the launcher tests cover the full stack.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Optional

from ompi_tpu_torch.core.config import var_registry
from ompi_tpu_torch.mpi.comm import Communicator
from ompi_tpu_torch.mpi.group import Group
from ompi_tpu_torch.mpi.pml import PmlOb1


def run_ranks(n: int, fn: Callable[[Communicator], Any],
              timeout: float = 60.0, btl: Optional[str] = None) -> list[Any]:
    """Run fn(comm) on n in-process ranks; return per-rank results.
    ``btl`` is an MCA selection of the btl framework (``"^proc"``: the
    shm rings carry the frames) applied while the PMLs are built."""
    old = var_registry.get("btl_")
    if btl is not None:
        var_registry.set("btl_", btl)
    try:
        pmls = [PmlOb1(r) for r in range(n)]
    finally:
        var_registry.set("btl_", old)
    addrs = {r: p.address for r, p in enumerate(pmls)}
    for p in pmls:
        p.set_peers(addrs)
    comms = [
        Communicator(Group(range(n)), cid=0, pml=pmls[r], my_world_rank=r,
                     name=f"test{n}")
        for r in range(n)
    ]
    results: list[Any] = [None] * n
    errors: list[tuple[int, BaseException]] = []

    def runner(rank: int) -> None:
        try:
            results[rank] = fn(comms[rank])
        except BaseException as e:  # noqa: BLE001 — report to the main thread
            errors.append((rank, e))

    threads = [threading.Thread(target=runner, args=(r,), daemon=True)
               for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    alive = [i for i, t in enumerate(threads) if t.is_alive()]
    try:
        if alive:
            raise TimeoutError(
                f"ranks {alive} did not finish in {timeout}s "
                f"(errors so far: {errors})")
        if errors:
            rank, exc = errors[0]
            raise AssertionError(f"rank {rank} failed: {exc!r}") from exc
    finally:
        if not alive:
            for p in pmls:
                p.close()
    return results
