"""Rank processes for the port's multi-rank tests on the CPU.

One process per rank, as the port runs on the card: :class:`RankPool`
spawns ``WORLD`` processes that join one gloo process group (``file://``
init under a temporary directory, never a fixed port) and then run the
functions the test sends them, each rank on its own arguments, until the
pool closes.  A case that raises on any rank, or takes longer than
``CASE_TIMEOUT`` seconds, kills every rank; the next case starts a fresh
pool.

This module imports no JAX, so neither do the rank processes: the test
modules compute the JAX package's results in the parent and send numpy
arrays.  The rank-side bodies below run in the children.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import traceback
from multiprocessing.connection import wait

import numpy as np
import torch

WORLD = 4
CASE_TIMEOUT = 60.0
START_TIMEOUT = 120.0


def _serve(rank: int, world: int, init_path: str, conn) -> None:
    torch.set_num_threads(1)
    try:
        from ompi_tpu_torch.parallel.mesh import make_mesh

        _STATE["world"] = make_mesh(device="cpu", rank=rank,
                                    world_size=world,
                                    init_method="file://" + init_path)
        conn.send(("ok", rank))
    except BaseException:  # noqa: BLE001 — reported to the parent
        conn.send(("err", traceback.format_exc()))
        return
    while True:
        msg = conn.recv()
        if msg is None:
            break
        fn, kwargs = msg
        try:
            conn.send(("ok", fn(**kwargs)))
        except BaseException:  # noqa: BLE001 — reported to the parent
            conn.send(("err", traceback.format_exc()))
    import torch.distributed as dist

    dist.destroy_process_group()


class RankPool:
    """``WORLD`` rank processes on the CPU, started on first use."""

    def __init__(self, tmpdir: str, world: int = WORLD) -> None:
        self.tmpdir, self.world = str(tmpdir), world
        self._procs: list = []
        self._conns: list = []
        self._starts = 0

    def _start(self) -> None:
        ctx = mp.get_context("spawn")
        self._starts += 1
        init = os.path.join(self.tmpdir, f"pg-{self._starts}")
        for r in range(self.world):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_serve, args=(r, self.world, init, child),
                            daemon=True)
            p.start()
            child.close()
            self._procs.append(p)
            self._conns.append(parent)
        self._collect(START_TIMEOUT, "start")

    def _collect(self, timeout: float, what: str) -> list:
        results: dict = {}
        pending = dict(enumerate(self._conns))
        import time

        deadline = time.monotonic() + timeout
        while pending:
            left = deadline - time.monotonic()
            ready = wait(list(pending.values()), timeout=max(0.0, left))
            if not ready:
                self.close()
                raise TimeoutError(f"rank case {what}: ranks "
                                   f"{sorted(pending)} did not answer in "
                                   f"{timeout} s")
            for r, c in list(pending.items()):
                if c not in ready:
                    continue
                try:
                    status, value = c.recv()
                except EOFError:
                    status, value = "err", f"rank {r} died"
                if status != "ok":
                    self.close()
                    raise RuntimeError(f"rank case {what} failed on rank "
                                       f"{r}:\n{value}")
                results[r] = value
                del pending[r]
        return [results[r] for r in range(self.world)]

    def map(self, fn, per_rank: list[dict]) -> list:
        """``fn(**per_rank[r])`` on every rank r; the results in rank
        order."""
        if not self._procs:
            self._start()
        for c, kw in zip(self._conns, per_rank):
            c.send((fn, kw))
        return self._collect(CASE_TIMEOUT, getattr(fn, "__name__", "?"))

    def run(self, fn, **kwargs) -> list:
        """``fn(**kwargs)`` on every rank."""
        return self.map(fn, [kwargs] * self.world)

    def close(self) -> None:
        for c in self._conns:
            try:
                c.send(None)
            except (BrokenPipeError, OSError):
                pass
        for p in self._procs:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
        for c in self._conns:
            c.close()
        self._procs, self._conns = [], []


def shards(x: np.ndarray, n: int = WORLD) -> list[dict]:
    """Per-rank ``{"shard": block}`` of x split along axis 0."""
    return [{"shard": s} for s in np.split(x, n, axis=0)]


# ---------------------------------------------------------------------------
# rank side (runs in the children)
# ---------------------------------------------------------------------------

_STATE: dict = {}


def mesh(axes=None):
    """The world mesh, or a cached mesh over the same ranks with other
    axes (made by every rank in the same case, so its groups match)."""
    if axes is None:
        return _STATE["world"]
    from ompi_tpu_torch.parallel.mesh import make_mesh

    key = tuple(axes.items())
    if key not in _STATE:
        _STATE[key] = make_mesh(dict(axes), device="cpu")
    return _STATE[key]


def comm(axes=None, comm_axes=None):
    from ompi_tpu_torch.mpi.device_comm import DeviceCommunicator

    return DeviceCommunicator(mesh(axes), comm_axes)


def to_torch(a: np.ndarray, dtype: str = None) -> torch.Tensor:
    """numpy → torch; bfloat16 travels as its int16 bit pattern."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


def to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.detach().cpu().numpy()
    return np.asarray(t)


def resolve(arg):
    """"op:<name>" → the port's Op; the non-commutative "op:matmul"
    multiplies 2x2 matrices."""
    from ompi_tpu_torch.mpi import op as op_mod

    if isinstance(arg, str) and arg.startswith("op:"):
        name = arg[3:]
        if name == "matmul":
            return op_mod.create_op(lambda a, b: a @ b, commutative=False,
                                    device_fn=torch.matmul, name="matmul")
        return getattr(op_mod, name.upper())
    return arg


def call(shard, method, margs=(), mkw=None, squeeze=False, expand=False,
         axes=None, comm_axes=None, sub=None, large_bytes=None):
    """One communicator method on this rank's shard (``squeeze``: on
    shard[0], the result given its leading axis back, as the reference's
    ``s[0]`` … ``[None]``; ``expand``: the result alone given one)."""
    from ompi_tpu_torch.core.config import var_registry

    c = comm(axes, comm_axes)
    if sub is not None:
        c = c.sub(sub)
    x = to_torch(shard)
    if squeeze:
        x = x[0]
    var = "coll_device_generic_large_bytes"
    old = var_registry.get(var)
    if large_bytes is not None:
        var_registry.set(var, large_bytes)
    try:
        out = getattr(c, method)(x, *[resolve(a) for a in margs],
                                 **{k: resolve(v) for k, v in
                                    (mkw or {}).items()})
    finally:
        var_registry.set(var, old)
    return to_numpy(out[None] if squeeze or expand else out)


def rank_and_coords(axes):
    c = comm(axes)
    return c.rank(), c.coords(), c.size, c.axis_sizes


def mesh_facts(axes):
    m = mesh(axes)
    return {"rank": m.rank, "world_size": m.world_size,
            "devices": m.devices.tolist(), "members_tp": m.members(("tp",)),
            "members_dp": m.members(("dp",)),
            "groups": len(m._host), "shares_card": m.shares_card}


def compose(shard):
    """sin(x)·2, allreduce, / size — user compute around a collective."""
    c = comm()
    return to_numpy(c.allreduce(torch.sin(to_torch(shard)) * 2.0) / c.size)


def error_of(fn_name, *args, **kwargs):
    """The exception a rank-side body raises, as (type name, message)."""
    try:
        globals()[fn_name](*args, **kwargs)
    except Exception as e:  # noqa: BLE001 — the test inspects it
        return type(e).__name__, str(e)
    return None


def one_sided(kind, win, value=None, dtype=None, src=0, dst=0, root=0,
              driver=False):
    """This rank's window after one one-sided op on a window filled with
    ``win`` (and, for a get, the fetched result)."""
    from ompi_tpu_torch.ops import remote_dma, symmetric

    c = comm()
    w = c.window(win.shape, to_torch(win, dtype).dtype)
    w.copy_(to_torch(win, dtype))
    if kind == "put":
        v = to_torch(value, dtype)
        out = (c.run_method("put", w, v, margs=(src, dst)) if driver
               else remote_dma.window_put(w, v, src, dst, c))
    elif kind == "get":
        out = (c.run_method("get", w, margs=(src, dst)) if driver
               else remote_dma.window_get(w, src, dst, c))
    else:
        out = remote_dma.fetch_bcast(w, root, c)
    res = to_numpy(out).copy(), to_numpy(w).copy()
    symmetric.free(c.mesh, w)
    return res


def flat_axis_guard(method):
    c = comm({"x": 2, "y": 2}, ("x", "y"))
    w = torch.zeros((8, 128))
    try:
        if method == "put":
            c.put(w, torch.ones((8, 128)), 0, 1)
        else:
            c.get(w, 0, 1)
    except Exception as e:  # noqa: BLE001 — the test inspects it
        return type(e).__name__, str(e)
    return None


def heap_put_get(shape, value, put_pair, get_pair):
    """A heap block: PE put_pair[0] puts ``value`` at put_pair[1], quiet,
    then PE get_pair[1] gets PE get_pair[0]'s block."""
    from ompi_tpu_torch.shmem.device import DeviceSymmetricHeap

    heap = DeviceSymmetricHeap(comm())
    sym = heap.array(shape, np.float32, fill=0)
    v = torch.full(shape, value)
    blk = heap.put(sym, v, *put_pair)
    blk = heap.quiet(blk)
    out = heap.get(blk, *get_pair)
    return to_numpy(out).copy()


def device_window(local_shape, data, origin, target, get_origin):
    """DeviceWindow put/fence/local/get/fence/free on this rank."""
    from ompi_tpu_torch.mpi.osc import DeviceWindow

    c = comm()
    win = DeviceWindow(c, local_shape, np.float32)
    win.put(data, origin=origin, target=target)
    win.fence()
    local = win.local(c.rank())
    fetched = win.get(origin=get_origin, target=target)
    win.fence()
    other = error_of("_local_other", win)
    win.free()
    return local, fetched, other


def _local_other(win):
    win.local((win.comm.rank() + 1) % win.comm.size)


def heap_op(shard, body, fill=None, shape=None):
    """One of the heap's exchange and collective ops on this PE's block
    (``shard`` is (1, *block)); returns the result with a leading PE
    axis."""
    from ompi_tpu_torch.mpi import op as op_mod
    from ompi_tpu_torch.shmem.device import DeviceSymmetricHeap

    heap = DeviceSymmetricHeap(comm())
    if body == "alloc":
        return to_numpy(heap.array(shape, np.float32, fill=fill))[None]
    b = to_torch(shard)[0]
    fns = {
        "cshift": lambda c, x: heap.cshift(x, 1),
        "to_all_max": lambda c, x: heap.to_all(x, op=op_mod.MAX),
        "get_from": lambda c, x: heap.get_from(x, 1),
        "broadcast": lambda c, x: heap.broadcast(x, root=2),
        "put_to": lambda c, x: heap.put_to(x, [(0, 3)], fill=-1),
        "collect": lambda c, x: heap.collect(x),
        "compose": lambda c, x: heap.to_all(heap.cshift(x * 2.0, 1),
                                            op=op_mod.SUM),
        "alltoall": lambda c, x: heap.alltoall(x),
        "my_pe": lambda c, x: torch.full_like(x, heap.my_pe()),
        "barrier_all": lambda c, x: x + (heap.barrier_all() or 0),
    }
    return to_numpy(heap.run(fns[body], b))[None]
