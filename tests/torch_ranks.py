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


# ---------------------------------------------------------------------------
# rank side of the multi-rank training tests (tests/test_torch_mesh_*.py)
# ---------------------------------------------------------------------------

def sp_attention(kind, q, k, v, g, axes, causal=True, impl="jnp",
                 bwd_kernel=False):
    """``<kind>_attention`` on this rank's blocks over the mesh ``axes``
    and its VJP with cotangent ``g``: (out, dq, dk, dv)."""
    from ompi_tpu_torch.core.config import var_registry
    from ompi_tpu_torch.ops import flash_attention  # noqa: F401 — its var
    from ompi_tpu_torch.parallel import attention as A

    c = comm(axes)
    qt, kt, vt = (to_torch(a).requires_grad_(True) for a in (q, k, v))
    kw = {} if kind == "gathered" else {"impl": impl}
    var_registry.set("ops_flash_bwd_kernel", bwd_kernel)
    try:
        out = getattr(A, f"{kind}_attention")(c, qt, kt, vt, axis="sp",
                                              causal=causal, **kw)
        out.backward(to_torch(g))
    finally:
        var_registry.set("ops_flash_bwd_kernel", False)
    return tuple(to_numpy(t) for t in (out, qt.grad, kt.grad, vt.grad))


def _model(fields, axes, params, train=True):
    from ompi_tpu_torch.models import transformer as T
    from ompi_tpu_torch.models.weights import from_jax_params

    cfg = T.TransformerConfig(**fields)
    m = mesh(axes)
    return cfg, m, from_jax_params(params, cfg, "cpu", train=train, mesh=m)


def model_grads(fields, axes, params, tokens):
    """The flagship's loss and gradients on this rank as the step takes
    them (any ``grad_accum`` microbatches accumulated, the gradients
    summed over dp × sp), gathered over tp into whole leaves:
    (loss, {leaf: grad})."""
    from ompi_tpu_torch.models import transformer as T
    from ompi_tpu_torch.models.weights import to_numpy_params

    cfg, m, p = _model(fields, axes, params)
    loss, grads = T._make_loss_and_grads(cfg, m)(p, T.shard_tokens(tokens,
                                                                   m))
    return loss.item(), to_numpy_params(grads, mesh=m)


def model_forward(fields, axes, params, tokens):
    """``make_forward``'s logits for this rank's token shard."""
    from ompi_tpu_torch.models import transformer as T

    cfg, m, p = _model(fields, axes, params, train=False)
    return to_numpy(T.make_forward(cfg, m)(p, T.shard_tokens(tokens, m)))


def train_steps(fields, axes, params, tokens, steps=3, lr=1e-2,
                loop=False):
    """``steps`` optimizer steps (single steps, or one ``make_train_loop``
    call) on this rank's shard: (losses, whole params after, optimizer
    facts)."""
    from ompi_tpu_torch.models import transformer as T
    from ompi_tpu_torch.models.weights import to_numpy_params

    cfg, m, p = _model(fields, axes, params)
    toks = T.shard_tokens(tokens, m)
    if loop:
        run, init = T.make_train_loop(cfg, m, lr=lr, steps=steps)
        p, state, losses = run(p, init(p), toks)
        losses = losses.tolist()
    else:
        step, init = T.make_train_step(cfg, m, lr=lr)
        state, losses = init(p), []
        for _ in range(steps):
            p, state, loss = step(p, state, toks)
            losses.append(loss.item())
    facts = {"shapes": {k: tuple(t.shape) for k, t in p.items()}}
    if cfg.zero1_axis:
        facts["master"] = {k: t.numel() for k, t in state["master"].items()}
        facts["mu"] = {k: t.numel() for k, t in state["opt"].mu.items()}
        facts["nu"] = {k: t.numel() for k, t in state["opt"].nu.items()}
    return losses, to_numpy_params(p, mesh=m), facts


def stream_batches(corpus, seed, axes, batch, seq, n=2, start_step=0):
    """The first ``n`` batches of ``train_stream`` on this rank."""
    from ompi_tpu_torch.models import data as D

    stream = D.train_stream(D.ArraySource(corpus, seed=seed), mesh(axes),
                            batch, seq, start_step=start_step)
    try:
        return [to_numpy(next(stream)) for _ in range(n)]
    finally:
        stream.close()


# ---------------------------------------------------------------------------
# rank side of the MoE tests (tests/test_torch_moe*.py)
# ---------------------------------------------------------------------------

def moe_layer(x, params, g, axes, capacity=None):
    """``switch_moe`` on this rank's tokens ``x`` with its ep block of the
    experts, and its VJP with cotangent ``g``: (y, aux, {"x", "wg",
    "w1", "w2": the local gradients})."""
    from ompi_tpu_torch.parallel.mesh import local_block
    from ompi_tpu_torch.parallel.moe import switch_moe

    c = comm(axes)
    xt = to_torch(x).requires_grad_(True)
    p = {k: to_torch(np.ascontiguousarray(local_block(
        params[k], c.mesh, ("ep",) if k != "wg" else ()))
        ).requires_grad_(True) for k in ("wg", "w1", "w2")}
    y, aux = switch_moe(c, xt, p, axis="ep", capacity=capacity,
                        with_aux=True)
    grads = torch.autograd.grad((y * to_torch(g)).sum(),
                                [xt, p["wg"], p["w1"], p["w2"]])
    return to_numpy(y), aux.item(), dict(zip(("x", "wg", "w1", "w2"),
                                             map(to_numpy, grads)))


def decode_tokens(fields, axes, params, prompt, max_new):
    """Greedy ``make_decoder`` tokens for this rank's dp block of
    ``prompt``."""
    from ompi_tpu_torch.models.decode import make_decoder
    from ompi_tpu_torch.parallel.mesh import local_block

    cfg, m, p = _model(fields, axes, params, train=False)
    dec = make_decoder(cfg, m, max_new=max_new)
    return to_numpy(dec(p, local_block(prompt, m, ("dp",))))


# -- the MPI communicator's device route (test_torch_coll_xla.py) -----------

def mpi_comm(ranks=None, bind=True):
    """This rank's port ``Communicator`` over ``ranks`` (default: the
    world), bound to the world mesh's DeviceCommunicator (``bind`` on the
    world only: the binding must span the communicator's ranks)."""
    from ompi_tpu_torch.mpi.comm import Communicator
    from ompi_tpu_torch.mpi.device_comm import device_world
    from ompi_tpu_torch.mpi.group import Group

    m = mesh()
    ranks = tuple(range(m.world_size)) if ranks is None else tuple(ranks)
    key = ("mpi_comm", ranks, bind)
    if key not in _STATE:
        c = Communicator(Group(ranks), cid=0, my_world_rank=m.rank)
        _STATE[key] = c.bind_device(device_world(m)) if bind else c
    return _STATE[key]


def mpi_host_comm():
    """This rank's world ``Communicator`` with a PML of its own, bound to
    the world mesh's DeviceCommunicator: the PMLs' business cards go round
    over the mesh's host group (the exchange ``init()`` makes through
    PMIx)."""
    from ompi_tpu_torch.mpi.comm import Communicator
    from ompi_tpu_torch.mpi.device_comm import device_world
    from ompi_tpu_torch.mpi.group import Group
    from ompi_tpu_torch.mpi.pml import PmlOb1

    if "mpi_host" not in _STATE:
        m = mesh()
        pml = PmlOb1(m.rank)
        cards = m.all_gather_object(pml.address)
        pml.set_peers({r: a for r, a in enumerate(cards) if r != m.rank})
        c = Communicator(Group(range(m.world_size)), cid=0,
                         my_world_rank=m.rank, pml=pml)
        _STATE["mpi_host"] = c.bind_device(device_world(m))
    return _STATE["mpi_host"]


def staging_guard(fn):
    """``fn()`` with np.asarray, torch.Tensor.numpy and torch.Tensor.cpu
    watched: (result, the names of those called on a tensor)."""
    hits: list = []
    orig = np.asarray, torch.Tensor.numpy, torch.Tensor.cpu

    def asarray(a, *args, **kw):
        if isinstance(a, torch.Tensor):
            hits.append("np.asarray")
        return orig[0](a, *args, **kw)

    def numpy_(self, *args, **kw):
        hits.append("Tensor.numpy")
        return orig[1](self, *args, **kw)

    def cpu(self, *args, **kw):
        hits.append("Tensor.cpu")
        return orig[2](self, *args, **kw)

    np.asarray, torch.Tensor.numpy, torch.Tensor.cpu = asarray, numpy_, cpu
    try:
        out = fn()
    finally:
        np.asarray, torch.Tensor.numpy, torch.Tensor.cpu = orig
    return out, hits


def mpi_coll(slot, shard=None, margs=(), guard=True):
    """``comm.<slot>(tensor of shard, *margs)`` on the world
    communicator, watched for host staging: (result as numpy or None,
    staging calls)."""
    c = mpi_comm()
    args = [resolve(a) for a in margs]
    if slot == "barrier":
        fn = c.barrier
    else:
        x = to_torch(shard)
        fn = lambda: getattr(c, slot)(x, *args)  # noqa: E731
    out, hits = staging_guard(fn) if guard else (fn(), [])
    return (None if out is None else to_numpy(out)), hits


def mpi_errors(shard):
    """The refusals of the route on this rank, as (type name, message):
    an unbound communicator, a host buffer on the world communicator
    that has no PML, and, on a 2-rank communicator of ranks 0 and 1
    with no PML, rank 0's send and rank 1's recv of a tensor and of a
    host buffer; then the host route's answers on the world
    communicator with a PML: ``host_pml``, the allreduce of the shard,
    and ``p2p_pml``, what rank 1 receives of rank 0's shard (None on
    the other ranks)."""
    x = to_torch(shard)

    def err(fn):
        try:
            fn()
        except Exception as e:  # noqa: BLE001 — the test inspects it
            return type(e).__name__, str(e)
        return None

    out = {"unbound": err(lambda: mpi_comm(bind=False).allreduce(x)),
           "host": err(lambda: mpi_comm().allreduce(shard))}
    rank = mesh().rank
    if rank < 2:
        pair = mpi_comm((0, 1), bind=False)
        if rank == 0:
            out["p2p_device"] = err(lambda: pair.send(x, dest=1, tag=5))
            out["p2p_host"] = err(lambda: pair.send(shard, dest=1, tag=5))
        else:
            out["p2p_device"] = err(lambda: pair.recv(buf=x, source=0,
                                                      tag=5))
            out["p2p_host"] = err(lambda: pair.recv(source=0, tag=5))
    world = mpi_host_comm()
    out["host_pml"] = world.allreduce(shard)
    out["p2p_pml"] = None
    if rank == 0:
        world.send(shard, dest=1, tag=5)
    elif rank == 1:
        out["p2p_pml"] = world.recv(source=0, tag=5)
    return out


# ---------------------------------------------------------------------------
# rank side of tests/test_torch_tune.py, test_torch_pipeline.py and
# test_torch_ckpt.py
# ---------------------------------------------------------------------------

def tune(sizes, iters, out_dir):
    """``tune_device_colls`` over the world mesh, each rank given its own
    output path (``out_<rank>.conf``): (text, table, the paths that
    exist afterwards)."""
    from ompi_tpu_torch.tools.tune import tune_device_colls

    m = mesh()
    text, table = tune_device_colls(
        m, sizes=sizes, iters=iters,
        out_path=os.path.join(out_dir, f"out_{m.rank}.conf"))
    m.host_barrier()
    return text, table, sorted(os.listdir(out_dir))


def gpipe_run(x, w, b, microbatches, grad=False):
    """``gpipe`` over a pp = 4 mesh, stage d = gelu(h @ w[d] + b[d]) on
    rank d: (output, this stage's w and b gradients, x's gradient on
    this rank, stage_fn calls) for the loss Σ out² (gradients None
    without ``grad``)."""
    from ompi_tpu_torch.parallel.pipeline import gpipe

    c = comm({"pp": WORLD}, ("pp",))
    d = c.mesh.coord("pp")
    ws = to_torch(w[d]).requires_grad_(grad)
    bs = to_torch(b[d]).requires_grad_(grad)
    xt = to_torch(x).requires_grad_(grad)
    calls = []

    def stage(params, h):
        calls.append(1)
        pw, pb = params
        return torch.nn.functional.gelu(h @ pw + pb)

    out = gpipe(c, stage, (ws, bs), xt, microbatches, axis="pp")
    if not grad:
        return to_numpy(out), None, None, None, len(calls)
    (out ** 2).sum().backward()
    return (to_numpy(out), to_numpy(ws.grad), to_numpy(bs.grad),
            to_numpy(xt.grad), len(calls))


def resume_steps(fields, axes, params, toks, snap_at, more, store_dir,
                 lr=1e-2):
    """Train ``snap_at`` steps, snapshot through ``SnapshotStore`` (rank 0
    writes the JAX package's layout, ``weights.train_state``), train
    ``more`` steps (the uninterrupted run), then restore into fresh
    tensors on every rank and train the same ``more`` steps:
    (losses of the uninterrupted run, losses after the restore, whether
    every parameter and every optimizer leaf is bitwise equal, the
    optimizer leaves' shapes)."""
    from ompi_tpu_torch.ckpt import SnapshotStore
    from ompi_tpu_torch.models import transformer as T
    from ompi_tpu_torch.models.weights import (from_train_state,
                                               to_numpy_opt_state,
                                               to_numpy_params, train_state)

    cfg, m, p = _model(fields, axes, params)
    step, init = T.make_train_step(cfg, m, lr=lr)
    s = init(p)
    for t in toks[:snap_at]:
        p, s, _ = step(p, s, T.shard_tokens(t, m))
    store = SnapshotStore(store_dir, job="resume")
    state = train_state(p, s, cfg, mesh=m)
    if m.rank == 0:
        store.write_rank(0, 0, state)
        store.commit(0, nranks=1, extra={"step": snap_at})
    m.host_barrier()

    def run(p, s):
        losses = []
        for t in toks[snap_at:snap_at + more]:
            p, s, loss = step(p, s, T.shard_tokens(t, m))
            losses.append(loss.item())
        return losses, to_numpy_params(p, mesh=m), to_numpy_opt_state(
            s, cfg, params, mesh=m)

    ref = run(p, s)
    del p, s
    blobs = store.load_rank(store.latest(), 0)
    got = run(*from_train_state(blobs, cfg, "cpu", mesh=m))
    same = (all(np.array_equal(ref[1][k], got[1][k]) for k in ref[1])
            and all(np.array_equal(a, b) for a, b in zip(ref[2], got[2])))
    return ref[0], got[0], same, [np.shape(v) for v in ref[2]]


def dcp_cases(base):
    """DcpStore on the world (dp = 4): the (8, 4) array saved as two rows
    a rank and restored sharded and whole; a distinct row a rank as a
    DTensor (every row survives) and as a plain tensor (DCP keeps one
    rank's copy); (block back, placements, whole, parts, plains)."""
    from ompi_tpu_torch.ckpt import DcpStore, sharded

    m = mesh({"dp": WORLD})
    r = m.rank
    store = DcpStore(base, job="s", mesh=m)
    x = torch.arange(32, dtype=torch.float32).reshape(8, 4)
    block = x[2 * r:2 * r + 2]
    store.save(1, {"x": sharded(block, m, "dp"),
                   "part": sharded(torch.full((1, 3), float(r)), m, "dp"),
                   "plain": torch.full((3,), float(r))})
    back = store.restore(1, {"x": sharded(torch.empty(2, 4), m, "dp")})["x"]
    whole = store.restore(1)
    return (to_numpy(back.to_local()),
            [(type(p).__name__, getattr(p, "dim", None))
             for p in back.placements],
            to_numpy(whole["x"]), to_numpy(whole["part"]),
            to_numpy(whole["plain"]), store.latest())
