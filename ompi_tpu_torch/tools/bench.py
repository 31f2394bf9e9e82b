"""Benchmark tool of the port (the counterpart of the repo's ``bench.py``)
— prints ONE JSON line on stdout, always.

Run:
    python -m ompi_tpu_torch.tools.bench                 # on the card(s)
    python -m ompi_tpu_torch.tools.bench --cpu           # tests: CPU sizes
    python -m ompi_tpu_torch.tools.bench --cpu --ranks 2 # + 2 gloo ranks

The record is one JSON object: the primary metric's row, ``backend``
(``"gpu"``, or ``"cpu"`` under ``--cpu``), the card's name and power
limit as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
gives them (``nvidia_smi``), the torch and CUDA versions, the 12 matrix
rows (``matrix``, also written to ``build/ompi_tpu_torch/bench/
BENCH_MATRIX.json``), ``wall_s`` and the transport counters
(``counters``).  Diagnostics go to stderr.  The exit code is 0 when the
record is a result and 1 when it is an error record.

- The backend is probed in a **subprocess with escalating budgets**
  (``OMPI_TPU_BENCH_PROBE_BUDGETS``, ``OMPI_TPU_BENCH_PROBE_PAUSE``, as the
  reference): CUDA's init on a wedged card can hang as a tunnel can.  A
  probe that finds no card ends the run with one error record; the tool
  never moves to the CPU by itself (the reference's CPU fallback, its
  recovery window and its preflight pointer have no counterpart: a run
  that silently moved to the CPU would hide the device).  ``--cpu`` asks
  for the CPU, at the reference's CPU sizes (the tests).
- Everything runs under a top-level try/except that prints an error
  record instead of a traceback; a SIGTERM mid-run prints the record of
  the evidence so far (``_arm_signal_record``).

Primary metric:

- **one card** (or ``--cpu``): the flagship's **MFU** at the reference's
  configuration (vocab 32000, d_model 2048, 16 heads, 8 layers, d_ff 8192,
  seq 1024, plain ``"xla"`` attention, ``ce_chunk`` 256, bf16 compute,
  ``remat="dots"``, batch 16, a 32-step chain, tokens from numpy seed 0),
  timed by ``mfu_sweep.time_train_loop`` in a child process under a wall
  budget (``OMPI_TPU_BENCH_FLAGSHIP_BUDGET``); MFU = (6N + 12·L·D·S) FLOPs
  a token × tokens/s / the card's bf16 peak (``flagship.peak_flops``);
  ``vs_baseline`` = MFU / 0.40.
- **two or more cards**: MPI_Allreduce busbw, 2(n−1)/n · bytes / t at
  256 MiB a rank, t the slowest rank's, in a ``tpurun -np N --gpu`` job
  (one process a card) that also runs the device-plane matrix rows
  (``allreduce_sweep``, ``mesh_bcast_allgather``, ``grad_reduce_scatter``,
  ``oshmem_device``) and the tuner.  NCCL refuses two ranks on one card,
  so on one card those rows carry ``_ONE_CHIP_NOTE``; with ``--cpu
  --ranks N`` they run over N gloo ranks.

Timing: the reference's two-point slope runs one compiled loop at two
trip counts; here a loop of ``lo`` and one of ``hi`` eager calls, each
closed by a device synchronize, best of ``reps``; the slope cancels the
per-call constants.  A row keeps its repeats (``reps_lo_s``,
``reps_hi_s``).  The decode row's parameters are drawn on a thread
while the headline's child has the card (host work only; the row times
nothing until the child is done).  The shm rows' second process is
started with ``spawn``
(module-level child functions): the parent may hold a CUDA context and
threads by then, and a fork would copy them.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import socket
import subprocess
import sys
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Optional

import numpy as np

from ompi_tpu_torch.tools import flagship, mfu_sweep

#: the user's settings, the reference's names
ENV_PROBE_BUDGETS = "OMPI_TPU_BENCH_PROBE_BUDGETS"
ENV_PROBE_PAUSE = "OMPI_TPU_BENCH_PROBE_PAUSE"
ENV_FLAGSHIP_BUDGET = "OMPI_TPU_BENCH_FLAGSHIP_BUDGET"
# Escalating per-attempt budgets: a slow CUDA init gets three chances.
_PROBE_BUDGETS_S = tuple(
    int(x) for x in os.environ.get(ENV_PROBE_BUDGETS, "90,150,240").split(",")
    if x.strip()) or (90, 150, 240)
_PROBE_PAUSE_S = int(os.environ.get(ENV_PROBE_PAUSE, "30"))
_MATRIX_PATH = os.path.join(flagship.OUT_DIR, "bench", "BENCH_MATRIX.json")
_FLAGSHIP_BUDGET_S = int(os.environ.get(ENV_FLAGSHIP_BUDGET, "2100"))
#: the device-plane job's wall budget (tpurun --timeout), seconds
_PLANE_BUDGET_S = 1200
#: the tuner's per-shard f32 element counts under --cpu (tune.DEFAULT_SIZES,
#: up to 64 MiB a shard, on the card)
_TUNE_CPU_SIZES = (1 << 10, 1 << 14)

_SLOPE_COLLAPSED = ("two-point slope collapsed under timing noise; per-iter "
                    "cost is an upper bound (one dispatch / trip count, "
                    "dispatch overhead included)")

_ONE_CHIP_NOTE = ("single card — the collective degenerates to identity; "
                  "busbw is defined over NVLink (needs >=2 cards, one "
                  "process a card: NCCL refuses two ranks on one card), "
                  "this row times nothing; the hbm_copy row carries the "
                  "honest single-card memory-bandwidth record")

# Any device-path row below this on the card measures overhead, not the
# data plane (HBM ~3 TB/s, single-card "collectives" are copies).
_DEVICE_ROW_FLOOR_GIBPS = 10.0


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _tail(s, n: int = 300) -> str:
    if isinstance(s, bytes):
        s = s.decode("utf-8", errors="replace")
    return (s or "")[-n:]


@dataclasses.dataclass
class Devices:
    """What the rows run on: ``n`` cards (or gloo ranks under ``--cpu
    --ranks``), ``platform`` ``"gpu"`` or ``"cpu"``, the card's name, the
    device-plane job's rows (``plane``, n ≥ 2 only) and the decode row's
    numpy parameters being drawn (``decode_params``; None: the row draws
    them)."""

    n: int
    platform: str
    kind: str
    plane: Optional[dict] = None
    decode_params: Optional[Future] = None

    @property
    def device(self):
        """The one-card rows' device: card 0, or the CPU."""
        import torch

        return torch.device("cuda", 0) if self.platform == "gpu" else \
            torch.device("cpu")


# ---------------------------------------------------------------------------
# backend probe
# ---------------------------------------------------------------------------

_PROBE_CODE = (
    "import json, torch; ok = torch.cuda.is_available(); "
    "n = torch.cuda.device_count() if ok else 0; "
    "print(json.dumps({'n': n, 'platform': 'gpu' if n else None, "
    "'kind': torch.cuda.get_device_name(0) if n else None, "
    "'torch': torch.__version__, 'cuda': torch.version.cuda}))")


def _probe_backend() -> tuple[Optional[dict], list[dict]]:
    """Ask a subprocess what CUDA sees; retry a hung or failed init with
    escalating budgets.  A probe that runs and finds no card is final.

    Returns ({"n", "platform", "kind", "torch", "cuda"} | None,
    per-attempt diagnostics)."""
    attempts: list[dict] = []
    _partial["probe_attempts"] = attempts   # live view for the
    # terminal-signal record (list mutated in place below)
    for i, budget in enumerate(_PROBE_BUDGETS_S):
        rec = _probe_once(i + 1, budget)
        attempts.append(rec)
        if rec["outcome"] == "ok":
            return rec.pop("probe"), attempts
        if rec["outcome"].startswith("no CUDA"):
            break
        if i + 1 < len(_PROBE_BUDGETS_S):
            log(f"pausing {_PROBE_PAUSE_S}s before probe retry")
            time.sleep(_PROBE_PAUSE_S)
    return None, attempts


def _probe_once(attempt_no: int, budget: int) -> dict:
    """One subprocess backend probe.  Returns a diagnostic record; on
    success it carries the parsed probe dict under ``"probe"`` and
    ``outcome == "ok"``."""
    t0 = time.perf_counter()
    rec: dict = {"attempt": attempt_no, "budget_s": budget,
                 "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())}
    try:
        out = subprocess.run([sys.executable, "-c", _PROBE_CODE],
                             capture_output=True, text=True,
                             timeout=budget)
    except subprocess.TimeoutExpired as e:
        rec.update(outcome="timeout (runtime init hung)",
                   stderr_tail=_tail(e.stderr))
        log(f"backend probe attempt {attempt_no} timed out after {budget}s")
        return rec
    rec["wall_s"] = round(time.perf_counter() - t0, 1)
    if out.returncode != 0:
        rec.update(outcome=f"rc={out.returncode} (init failed)",
                   stderr_tail=_tail(out.stderr))
        log(f"backend probe attempt {attempt_no} failed "
            f"rc={out.returncode}: {_tail(out.stderr, 500)}")
        return rec
    try:
        probe = json.loads(out.stdout.strip().splitlines()[-1])
    except (ValueError, IndexError) as e:
        rec.update(outcome=f"unparseable ({e})",
                   stderr_tail=_tail(out.stdout, 200))
        log(f"backend probe unparseable ({e}): {_tail(out.stdout, 200)}")
        return rec
    if not probe["n"]:
        rec.update(outcome="no CUDA device (torch.cuda.is_available() is "
                           "false)", torch=probe.get("torch"))
        log("backend probe: no CUDA device")
        return rec
    rec.update(outcome="ok", probe=probe)
    return rec


def _nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({type(e).__name__}: {e})"
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else (
        f"unavailable (rc={out.returncode}: {_tail(out.stderr, 200)})")


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------

def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _slowest(comm, seconds: float) -> float:
    """MAX of ``seconds`` over the communicator's ranks (its host group);
    the value itself without one."""
    if comm is None or comm.size == 1:
        return seconds
    import torch
    import torch.distributed as dist

    t = torch.tensor([seconds], dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX,
                    group=comm.mesh.host_group(comm.axes))
    return float(t.item())


def _slope_time(make_fn, x, lo: int, hi: int, reps: int = 2, comm=None):
    """The two wall times of the two-point method: the SAME loop at
    ``lo`` and at ``hi`` trips, each run once to warm and ``reps`` times
    closed by a device synchronize (the ranks of ``comm`` meet before
    each and take the slowest rank's time); their slope cancels every
    per-call constant (``_slope_fields``).  ``make_fn(iters)`` returns a
    callable of ``x``.

    → (t_lo, t_hi, the lo repeats, the hi repeats), the best of each."""
    dev = x.device

    def timed(f):
        f(x)
        _sync(dev)                          # warm
        times = []
        for _ in range(reps):
            if comm is not None:
                comm.mesh.host_barrier(comm.axes)
            t0 = time.perf_counter()
            f(x)
            _sync(dev)
            times.append(_slowest(comm, time.perf_counter() - t0))
        return min(times), times

    (t_lo, r_lo), (t_hi, r_hi) = timed(make_fn(lo)), timed(make_fn(hi))
    return t_lo, t_hi, r_lo, r_hi


def _loop_maker(kernel):
    """make(iters) factory for the slope rows: ``iters`` calls of
    ``kernel`` on the loop carry (which must keep the input's shape)."""
    def make(iters):
        def run(x):
            y = x
            for _ in range(iters):
                y = kernel(y)
            return y
        return run

    return make


def _slope_fields(t_lo: float, t_hi: float, lo: int, hi: int):
    """The shared slope-or-bound POLICY: per-iter seconds + row fields
    from two wall times.  Collapse threshold and the suspect contract
    live here only."""
    extra = {"wall_lo_s": round(t_lo, 3), "wall_hi_s": round(t_hi, 3)}
    dt = (t_hi - t_lo) / (hi - lo)
    if dt <= 0 or (t_hi - t_lo) < 0.02 * t_lo:
        extra["suspect"] = _SLOPE_COLLAPSED
        return t_hi / hi, extra
    return dt, extra


def _slope_or_bound(make_fn, x, lo: int, hi: int, comm=None):
    """(per-iter seconds, extra-row-fields) — slope when clean, else the
    t_hi/hi upper bound with a ``suspect`` note; the fields keep the
    trip counts and every repeat's seconds."""
    t_lo, t_hi, r_lo, r_hi = _slope_time(make_fn, x, lo, hi, comm=comm)
    dt, extra = _slope_fields(t_lo, t_hi, lo, hi)
    extra.update(iters=[lo, hi], reps_lo_s=r_lo, reps_hi_s=r_hi)
    return dt, extra


def _loop_iters(platform: str) -> tuple[int, int]:
    """(lo, hi) trip counts: generous on the card where per-iter work is
    fast; small on the CPU where a 256MiB collective costs ~0.5s/iter of
    host memcpy."""
    return (4, 20) if platform == "gpu" else (2, 6)


def _flag_suspect(row: dict, backend: str) -> dict:
    if (backend == "gpu" and row.get("unit") == "GiB/s"
            and row.get("value", 0) < _DEVICE_ROW_FLOOR_GIBPS):
        row["suspect"] = ("below sanity floor "
                          f"({_DEVICE_ROW_FLOOR_GIBPS} GiB/s): likely "
                          "measuring dispatch/transfer, not the data plane")
    return row


# ---------------------------------------------------------------------------
# primary metrics
# ---------------------------------------------------------------------------

def bench_allreduce_busbw(devices: Devices) -> dict:
    """The ≥2-card headline, from the device-plane job (rank 0's row)."""
    return _plane_row(devices, "busbw")


def _flagship_config(on_cpu: bool):
    """(TransformerConfig fields, batch, chain, outer) of the headline:
    the reference's flagship at 468M parameters, or its small CPU
    branch."""
    base = dict(vocab=32_000, d_model=2048, n_heads=16, n_layers=8,
                d_ff=8192, seq=1024, attention="xla", ce_chunk=256)
    batch, chain, outer = 16, 32, 1
    if on_cpu:
        base.update(d_model=256, n_heads=8, n_layers=2, d_ff=1024, seq=256)
        batch, chain, outer = 2, 2, 1
    return base, batch, chain, outer


def bench_flagship_mfu(kind: str, cpu: bool = False) -> dict:
    """One-card flagship train step → MFU (PaLM-style accounting:
    6·N FLOPs/token for the dense path + 12·L·D·S for attention)."""
    import torch

    from ompi_tpu_torch.models.transformer import TransformerConfig
    from ompi_tpu_torch.parallel.mesh import make_mesh

    dev = flagship.device(cpu)
    mesh = make_mesh({"dp": 1, "sp": 1, "tp": 1}, device=dev)
    base, batch, chain, outer = _flagship_config(cpu)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, base["vocab"],
                          size=(batch, base["seq"])).astype(np.int32)
    cfg = TransformerConfig(**base, compute_dtype="bfloat16", remat="dots")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    dt, n_params, loss = mfu_sweep.time_train_loop(
        cfg, mesh, torch.from_numpy(tokens).to(dev), chain, outer)
    n_tokens = tokens.size
    model_flops = flagship.flops_per_token(cfg, n_params) * n_tokens
    toks_per_s = n_tokens / dt
    peak = None if cpu else flagship.peak_flops(kind)
    mfu = (model_flops / dt / peak) if peak else 0.0
    log(f"bf16 train step: {dt*1e3:.1f}ms, {toks_per_s:,.0f} tok/s, "
        f"{n_params/1e6:.0f}M params, model {model_flops/1e9:.1f} GFLOP/step, "
        f"peak={peak}, MFU={mfu*100:.1f}% (loss {loss:.3f})")
    return {
        "metric": f"flagship transformer train-step MFU (1 card {kind}, "
                  f"bf16, {n_params/1e6:.0f}M params, seq {base['seq']})",
        "value": round(mfu * 100, 2),
        "unit": "% MFU",
        # 40% MFU is the well-tuned-training-stack bar (the reference's)
        "vs_baseline": round(mfu / 0.40, 3) if peak else 0.0,
        "tokens_per_s": round(toks_per_s, 1),
        "step_ms": round(dt * 1e3, 2),
        "params": n_params,
        "loss": loss,
        "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                     if dev.type == "cuda" else None),
    }


def _flagship_guarded(kind: str, cpu: bool = False) -> dict:
    """Run the flagship MFU in a SUBPROCESS with a wall budget: a
    stalled step then costs the headline row, not the whole bench — the
    final JSON line still prints, with the stall recorded.
    ``--flagship-child`` is the child entry."""
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "ompi_tpu_torch.tools.bench",
             "--flagship-child", kind] + ["--cpu"] * cpu,
            capture_output=True, text=True, timeout=_FLAGSHIP_BUDGET_S,
            cwd=flagship.REPO)
        for line in (proc.stdout or "").splitlines():
            if line.startswith("RESULT "):
                return json.loads(line[len("RESULT "):])
        return {"metric": "flagship transformer train-step MFU",
                "value": 0.0, "unit": "% MFU", "vs_baseline": 0.0,
                "error": f"flagship child rc={proc.returncode}",
                "stderr_tail": _tail(proc.stderr, 600)}
    except subprocess.TimeoutExpired as e:
        return {"metric": "flagship transformer train-step MFU",
                "value": 0.0, "unit": "% MFU", "vs_baseline": 0.0,
                "error": (f"flagship timed out after "
                          f"{_FLAGSHIP_BUDGET_S}s (a stalled step)"),
                "stderr_tail": _tail(e.stderr, 600),
                "wall_s": round(time.perf_counter() - t0, 1)}


# ---------------------------------------------------------------------------
# the device plane: one process a card (tpurun --gpu), or gloo CPU ranks
# ---------------------------------------------------------------------------

def _plane_busbw(comm, platform: str) -> dict:
    """MPI_Allreduce busbw: 256 MiB a rank on the card (4 MiB on the
    CPU), rescaled by 1/n each trip so the carry stays finite."""
    import torch

    n = comm.size
    per_device = (1 << 28) if platform == "gpu" else (1 << 22)
    x = torch.ones((per_device // 4,), dtype=torch.float32,
                   device=comm.mesh.device)
    scale = 1.0 / n
    make = _loop_maker(lambda s: comm.allreduce(s).mul_(scale))
    dt, extra = _slope_or_bound(make, x, *_loop_iters(platform), comm=comm)
    busbw = 2 * (n - 1) / n * per_device / dt
    link = "NVLink" if platform == "gpu" else "gloo"
    log(f"allreduce {per_device/2**20:.0f}MiB/dev over {n} ranks: "
        f"{dt*1e3:.2f}ms/iter (slope) → busbw {busbw/2**30:.2f} GiB/s")
    return {"metric": f"MPI_Allreduce busbw over {link} ({n} ranks, fp32)",
            "unit": "GiB/s", "vs_baseline": 1.0,
            "value": round(busbw / 2**30, 3),
            "iter_ms": round(dt * 1e3, 2), **extra}


def _plane_allreduce_sweep(comm, platform: str) -> dict:
    """The allreduce sweep's device path: 4 KiB, 1 MiB and 64 MiB a
    shard → {label: {us, busbw_gibps}}."""
    import torch

    n = comm.size
    scale = 1.0 / n
    rows = {}
    for label, elems in (("4KiB", 1024), ("1MiB", 1 << 18),
                         ("64MiB", 1 << 24)):
        x = torch.ones((elems,), dtype=torch.float32, device=comm.mesh.device)
        make = _loop_maker(lambda s: comm.allreduce(s).mul_(scale))
        lo, hi = _loop_iters(platform)
        if elems <= (1 << 18):  # small payloads: longer loops, less noise
            lo, hi = lo * 4, hi * 4
        dt, extra = _slope_or_bound(make, x, lo, hi, comm=comm)
        rows[label] = {"us": round(dt * 1e6, 1),
                       "busbw_gibps": round(
                           2 * (n - 1) / n * elems * 4 / dt / 2**30, 3),
                       "reps_lo_s": extra["reps_lo_s"],
                       "reps_hi_s": extra["reps_hi_s"]}
        if "suspect" in extra:
            rows[label]["suspect"] = extra["suspect"]
    return rows


def _plane_mesh_bcast_allgather(comm, platform: str) -> dict:
    """Bcast + Allgather over a 2D mesh of the same ranks, mixed dtypes
    (float32, bfloat16, int32), 16 MiB of f32 a shard."""
    import torch

    from ompi_tpu_torch.mpi.device_comm import DeviceCommunicator
    from ompi_tpu_torch.parallel.mesh import make_mesh, mesh_shape_for

    n = comm.size
    shape = mesh_shape_for(n, ["x", "y"])
    mesh = make_mesh(shape, device=comm.mesh.device)
    comm2 = DeviceCommunicator(mesh, ("x", "y"))
    shard = 1 << 22
    me = comm2.rank()
    nbytes = 0
    total_dt = 0.0
    suspect = None
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        x = torch.ones((shard,), dtype=dtype, device=mesh.device)

        def kernel(s):
            # bcast + allgather, then slice this rank's shard back out so
            # the loop carry keeps the input's shape
            b = comm2.bcast(s, root=0)
            full = comm2.allgather(b)
            return full[me * shard:(me + 1) * shard]

        dt, extra = _slope_or_bound(_loop_maker(kernel), x,
                                    *_loop_iters(platform), comm=comm2)
        total_dt += dt
        nbytes += x.numel() * x.element_size() * n
        if "suspect" in extra:
            suspect = extra["suspect"]
    row = {"metric": f"Bcast+Allgather 2D mesh {tuple(shape.values())}, "
                     "mixed dtypes",
           "value": round(nbytes / total_dt / 2**30, 3), "unit": "GiB/s",
           "vs_baseline": 1.0}
    if suspect:
        row["suspect"] = suspect
    return row


def _grad_params(n: int, platform: str) -> int:
    """The gradient row's f32 parameter count: 7B where 15% of each
    rank's memory holds its shard, a multiple of n·1024."""
    if platform == "cpu":
        limit = 128 << 20  # CPU ranks share host RAM — stay small
    else:
        import torch

        limit = torch.cuda.get_device_properties(0).total_memory
    params = min(7_000_000_000, int(limit * 0.15 / 4) * n)
    return params - params % (n * 1024)


def _plane_grad_reduce_scatter(comm, platform: str) -> dict:
    """Data-parallel gradient reduce_scatter + allgather on float32
    buffers, sized to the card's memory (7B params when it fits)."""
    import torch

    n = comm.size
    params = _grad_params(n, platform)
    x = torch.ones((params // n,), dtype=torch.float32,
                   device=comm.mesh.device)
    nbytes = params * 4
    scale = 1.0 / n

    def kernel(s):
        scattered = comm.reduce_scatter(s).mul_(scale)
        return comm.allgather(scattered)

    dt, extra = _slope_or_bound(_loop_maker(kernel), x,
                                *_loop_iters(platform), comm=comm)
    gbps = 2 * nbytes / dt / 2**30  # RS + AG each move ~the buffer once
    return {"metric": f"grad reduce_scatter+allgather ({params/1e9:.2f}B "
                      f"fp32 params, {n} dev)",
            "unit": "GiB/s", "vs_baseline": 1.0, "params": params,
            "value": round(gbps, 3), "step_ms": round(dt * 1e3, 2), **extra}


def _plane_oshmem_device(comm, platform: str) -> dict:
    """oshmem max-reduction + circular shift on the device path
    (max_to_all = all_reduce MAX, circular shift = p2p ring), 16 MiB a
    rank."""
    import torch

    from ompi_tpu_torch.mpi.op import MAX

    n = comm.size
    elems = 1 << 22
    x = torch.arange(comm.rank() * elems, (comm.rank() + 1) * elems,
                     dtype=torch.float32, device=comm.mesh.device)

    def kernel(s):
        m = comm.allreduce(s, MAX)              # shmem_float_max_to_all
        return comm.shift(m, 1, axis="world")   # circular shift, 1 hop

    dt, extra = _slope_or_bound(_loop_maker(kernel), x,
                                *_loop_iters(platform), comm=comm)
    nbytes = elems * 4 * n
    return {"metric": f"oshmem max_to_all + circular shift ({n} dev, "
                      f"{elems * 4 / 2**20:.0f}MiB/dev)",
            "unit": "GiB/s", "vs_baseline": 1.0,
            "value": round(nbytes / dt / 2**30, 3), **extra}


def _plane_tuned_crossovers(comm, platform: str) -> dict:
    """The tuner over the job's ranks; rank 0 ships the rules file next
    to coll/xla only when the ranks are cards."""
    return _tune_row(comm.mesh, comm.size, platform)


#: the device-plane job's rows, in the order every rank runs them
_PLANE_ROWS = (("busbw", _plane_busbw),
               ("allreduce_sweep", _plane_allreduce_sweep),
               ("mesh_bcast_allgather", _plane_mesh_bcast_allgather),
               ("grad_reduce_scatter", _plane_grad_reduce_scatter),
               ("oshmem_device", _plane_oshmem_device),
               ("tuned_crossovers", _plane_tuned_crossovers))


def _plane_rank_main(cpu: bool) -> None:
    """One rank of the device-plane job: join the job's process group,
    run ``_PLANE_ROWS``; rank 0 prints ``RESULT {row name: row}``.  A
    row that raises on one rank may leave its peers in a collective:
    the launcher's timeout bounds the job."""
    import torch.distributed as dist

    from ompi_tpu_torch.mpi.device_comm import device_world
    from ompi_tpu_torch.parallel import multihost
    from ompi_tpu_torch.parallel.mesh import make_mesh

    if not multihost.initialize_from_env():
        raise SystemExit("bench --plane-rank: run under tpurun (no "
                         "OMPI_TPU_COORD in the environment)")
    mesh = make_mesh(device="cpu" if cpu else "cuda")
    comm = device_world(mesh)
    platform = "cpu" if cpu else "gpu"
    out = {}
    for name, fn in _PLANE_ROWS:
        t0 = time.perf_counter()
        try:
            out[name] = fn(comm, platform)
        except Exception as e:  # noqa: BLE001 — every row must land
            out[name] = {"error": f"{type(e).__name__}: {e}"}
        out[name]["wall_s"] = round(time.perf_counter() - t0, 2)
    if mesh.rank == 0:
        print("RESULT " + json.dumps(out), flush=True)
    mesh.host_barrier()
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _device_plane_job(devices: Devices) -> dict:
    """Run ``_PLANE_ROWS`` over ``devices.n`` ranks, one process a card
    (``tpurun --gpu``) or gloo CPU ranks (the rendezvous exported by
    hand) → rank 0's rows."""
    cpu = devices.platform == "cpu"
    cmd = [sys.executable, "-m", "ompi_tpu_torch.tools.tpurun",
           "-np", str(devices.n), "--timeout", str(_PLANE_BUDGET_S),
           "--no-tag-output"]
    if cpu:
        cmd += ["-x", f"OMPI_TPU_COORD=127.0.0.1:{_free_port()}",
                "-x", "OMPI_TPU_NHOSTS=1"]
    else:
        cmd.append("--gpu")
    cmd += ["--", sys.executable, "-m", "ompi_tpu_torch.tools.bench",
            "--plane-rank"] + ["--cpu"] * cpu
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=_PLANE_BUDGET_S + 60, cwd=flagship.REPO)
    for line in proc.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise RuntimeError(f"device-plane job rc={proc.returncode}: "
                       f"{_tail(proc.stderr, 600)}")


def _plane_row(devices: Devices, name: str) -> dict:
    """Row ``name`` of the device-plane job; raises its error."""
    rows = devices.plane or {}
    if "error" in rows and name not in rows:
        raise RuntimeError(rows["error"])
    row = rows.get(name)
    if row is None:
        raise RuntimeError(f"the device-plane job gave no {name!r} row")
    if "error" in row:
        raise RuntimeError(row["error"])
    row = dict(row)
    row["plane_wall_s"] = row.pop("wall_s")
    return row


# ---------------------------------------------------------------------------
# BASELINE.md config matrix → BENCH_MATRIX.json
# ---------------------------------------------------------------------------

def run_ranks(n: int, fn: Callable, timeout: float = 60.0) -> list:
    """Run fn(comm) on n in-process ranks (threads, one PML each); return
    per-rank results (the tests/mpi/harness shape)."""
    from ompi_tpu_torch.mpi.comm import Communicator
    from ompi_tpu_torch.mpi.group import Group
    from ompi_tpu_torch.mpi.pml import PmlOb1

    pmls = [PmlOb1(r) for r in range(n)]
    addrs = {r: p.address for r, p in enumerate(pmls)}
    for p in pmls:
        p.set_peers(addrs)
    comms = [Communicator(Group(range(n)), cid=0, pml=pmls[r],
                          my_world_rank=r, name=f"bench{n}")
             for r in range(n)]
    results: list[Any] = [None] * n
    errors: list = []

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
    if alive:
        raise TimeoutError(f"ranks {alive} did not finish in {timeout}s "
                           f"(errors so far: {errors})")
    for p in pmls:
        p.close()
    if errors:
        rank, exc = errors[0]
        raise RuntimeError(f"rank {rank} failed: {exc!r}") from exc
    return results


def matrix_ring_latency() -> dict:
    """Config 1: 4-rank send/recv ring (host path), p50 lap."""
    laps = 200
    msg = np.array([0], np.int32)

    def ring(comm):
        rank, size = comm.rank, comm.size
        nxt, prv = (rank + 1) % size, (rank - 1) % size
        times = []
        for i in range(20 + laps):
            if rank == 0:
                t0 = time.perf_counter()
                comm.send(msg, dest=nxt, tag=1)
                comm.recv(source=prv, tag=1)
                if i >= 20:
                    times.append(time.perf_counter() - t0)
            else:
                m = comm.recv(source=prv, tag=1)
                comm.send(m, dest=nxt, tag=1)
        return times

    results = run_ranks(4, ring, timeout=120.0)
    lap_us = np.array(results[0]) * 1e6
    p50 = float(np.percentile(lap_us, 50))
    return {
        "metric": "ring_c 4-rank lap latency p50 (host path)",
        "value": round(p50, 1), "unit": "us", "vs_baseline": 1.0,
        "per_hop_us": round(p50 / 4, 2), "laps_us": lap_us.tolist(),
    }


def matrix_allreduce_sweep(devices: Devices) -> dict:
    """Config 2: OSU-style MPI_Allreduce size sweep — the device path
    (the job's all_reduce per size; a note on one card) with the host
    path (coll/tuned algorithms over 4 in-process ranks) alongside for
    the crossover picture."""
    n = devices.n
    if n == 1:
        dev_rows = {label: {"us": None, "note": _ONE_CHIP_NOTE}
                    for label in ("4KiB", "1MiB", "64MiB")}
    else:
        dev_rows = _plane_row(devices, "allreduce_sweep")
        dev_rows.pop("plane_wall_s")

    host_rows = {}
    for label, elems in (("4B", 1), ("4KiB", 1024), ("1MiB", 1 << 18)):
        payload = np.ones(elems, np.float32)
        iters = 30 if elems <= 1024 else 10

        def body(comm_):
            comm_.allreduce(payload)          # warm routes
            t0 = time.perf_counter()
            for _ in range(iters):
                comm_.allreduce(payload)
            return (time.perf_counter() - t0) / iters

        dts = run_ranks(4, body, timeout=120.0)
        host_rows[label] = {"us": round(max(dts) * 1e6, 1)}

    row = {
        "metric": f"MPI_Allreduce sweep ({n} dev all_reduce | 4-rank host "
                  "tuned)",
        "value": dev_rows["64MiB"].get("busbw_gibps", 0.0), "unit": "GiB/s",
        "vs_baseline": 1.0,
        "device_path": dev_rows, "host_path_4rank": host_rows,
    }
    if n == 1:
        row["note"] = _ONE_CHIP_NOTE
    return row


def matrix_mesh_bcast_allgather(devices: Devices) -> dict:
    """Config 3: Bcast + Allgather over a 2D mesh, mixed dtypes."""
    from ompi_tpu_torch.parallel.mesh import mesh_shape_for

    if devices.n == 1:
        shape = mesh_shape_for(1, ["x", "y"])
        return {
            "metric": f"Bcast+Allgather 2D mesh {tuple(shape.values())}, "
                      "mixed dtypes",
            "value": 0.0, "unit": "GiB/s", "vs_baseline": 1.0,
            "note": _ONE_CHIP_NOTE,
        }
    return _plane_row(devices, "mesh_bcast_allgather")


def matrix_hbm_copy(devices: Devices) -> dict:
    """HBM-bandwidth calibration: slope-timed read+write sweep of one
    card's memory (``y.add_(1)`` a trip).  The sanity floor for every
    bandwidth row — a single-card self-put can never beat it, and on one
    card it is the honest 'what the memory system can do' record the
    n=1 rows point at."""
    import torch

    gpu = devices.platform == "gpu"
    n_elems = (1 << 26) if gpu else (1 << 22)
    x = torch.ones((n_elems,), dtype=torch.float32, device=devices.device)
    nbytes = x.numel() * 4
    lo, hi = (8, 72) if gpu else (2, 10)
    dt, extra = _slope_or_bound(_loop_maker(lambda y: y.add_(1.0)), x,
                                lo, hi)
    # each iteration reads the buffer and writes it back
    gbps = 2 * nbytes / dt / 2**30
    return {
        "metric": f"HBM read+write bandwidth ({nbytes >> 20}MiB fp32, "
                  f"1 device)",
        "value": round(gbps, 2), "unit": "GiB/s", "vs_baseline": 1.0,
        "per_iter_ms": round(dt * 1e3, 3), **extra,
    }


def matrix_grad_reduce_scatter(devices: Devices) -> dict:
    """Config 4: data-parallel gradient reduce_scatter + allgather on
    float32 buffers, sized to the card's memory (7B params when it
    fits)."""
    n = devices.n
    if n == 1:
        params = _grad_params(1, devices.platform)
        return {"metric": f"grad reduce_scatter+allgather "
                          f"({params/1e9:.2f}B fp32 params, {n} dev)",
                "unit": "GiB/s", "vs_baseline": 1.0, "params": params,
                "value": 0.0, "note": _ONE_CHIP_NOTE}
    return _plane_row(devices, "grad_reduce_scatter")


def matrix_oshmem_device(devices: Devices) -> dict:
    """Config 5: oshmem max-reduction + circular shift on the device
    path (symmetric-heap semantics: every rank holds an
    identically-shaped shard)."""
    n = devices.n
    if n == 1:
        return {"metric": f"oshmem max_to_all + circular shift ({n} dev, "
                          "16MiB/dev)",
                "unit": "GiB/s", "vs_baseline": 1.0, "value": 0.0,
                "note": _ONE_CHIP_NOTE}
    return _plane_row(devices, "oshmem_device")


def _pingpong_child(c2p, p2c, result_q) -> None:
    """The echoing process of ``matrix_shm_pingpong`` (spawned)."""
    from ompi_tpu_torch.mpi.btl_shm import ShmBTL

    frames = []
    btl = ShmBTL(1, lambda p, h, b: frames.append((h, b)))
    c2p.put(btl.address)
    peer_card = p2c.get()
    btl.connect(0, peer_card)
    # echo every frame back until the stop marker
    seen = 0
    deadline = time.perf_counter() + 60
    while time.perf_counter() < deadline:
        if len(frames) > seen:
            h, b = frames[seen]
            if h.get("t") == "stop":
                break
            seen += 1
            btl.send(0, h, b)
        else:
            time.sleep(0)
    result_q.put(seen)
    btl.close()


def matrix_shm_pingpong() -> dict:
    """Two real PROCESSES ping-ponging raw frames over the shm BTL rings
    — the deployment-shape same-host data-plane number (the reference's
    vader BTL benchmark shape), exercising the fused native frame
    engine without GIL sharing between ranks."""
    import multiprocessing as mp

    from ompi_tpu_torch.mpi.btl_shm import ShmBTL

    ctx = mp.get_context("spawn")
    c2p, p2c, result_q = ctx.Queue(), ctx.Queue(), ctx.Queue()
    proc = ctx.Process(target=_pingpong_child, args=(c2p, p2c, result_q),
                       daemon=True)
    proc.start()
    frames = []
    btl = ShmBTL(0, lambda p, h, b: frames.append((h, b)))
    try:
        peer_card = c2p.get(timeout=60)
        p2c.put(btl.address)
        btl.connect(1, peer_card)
        hdr = {"t": "eager", "tag": 1, "cid": 0, "seq": 0, "dt": "<i4",
               "elems": 16, "shp": [16]}
        payload = b"\x01" * 64
        laps = []
        warm, iters = 50, 400
        for i in range(warm + iters):
            target = len(frames) + 1   # BEFORE the send: the echo can land
            t0 = time.perf_counter()    # before this line otherwise
            btl.send(1, hdr, payload)
            deadline = t0 + 10
            while len(frames) < target and time.perf_counter() < deadline:
                time.sleep(0)   # yield: the poller thread appends frames
            if i >= warm:
                laps.append(time.perf_counter() - t0)
        # the child's own marker, never a PML frame  # lint: frame-ok
        btl.send(1, {"t": "stop"}, b"")
        echoed = result_q.get(timeout=30)
        proc.join(timeout=10)
    finally:
        btl.close()
        if proc.is_alive():
            proc.kill()
            proc.join(timeout=10)
    lap_us = np.array(laps) * 1e6
    p50 = float(np.percentile(lap_us, 50))
    return {
        "metric": "shm BTL 2-process ping-pong p50 (64B frames, fused "
                  "native ring)",
        "value": round(p50, 2), "unit": "us", "vs_baseline": 1.0,
        "one_way_us": round(p50 / 2, 2), "echoed": echoed,
        "laps_us": lap_us.tolist(),
    }


_MSGRATE_N = 20_000


def _msgrate_child(c2p, p2c) -> None:
    """The receiving process of ``matrix_shm_msgrate`` (spawned)."""
    from ompi_tpu_torch.mpi.comm import Communicator
    from ompi_tpu_torch.mpi.group import Group
    from ompi_tpu_torch.mpi.pml import PmlOb1

    pml = PmlOb1(1)
    c2p.put(pml.address)
    peers = p2c.get()
    pml.set_peers(peers)
    comm = Communicator(Group(range(2)), cid=0, pml=pml, my_world_rank=1)
    buf = np.zeros(16, np.int32)
    for _ in range(_MSGRATE_N):
        comm.recv(buf=buf, source=0, tag=1)
    comm.send(buf, dest=0, tag=2)   # ack closes the clock
    pml.close()


def matrix_shm_msgrate() -> dict:
    """Two real PROCESSES, PML-level small-message rate over the shm BTL
    — total CPU work per message (send prologue + C ring publish + fused
    drain + match + deliver)."""
    import multiprocessing as mp

    from ompi_tpu_torch.mpi.comm import Communicator
    from ompi_tpu_torch.mpi.group import Group
    from ompi_tpu_torch.mpi.pml import PmlOb1

    n_msgs = _MSGRATE_N
    ctx = mp.get_context("spawn")
    c2p, p2c = ctx.Queue(), ctx.Queue()
    proc = ctx.Process(target=_msgrate_child, args=(c2p, p2c), daemon=True)
    proc.start()
    pml = PmlOb1(0)
    try:
        peers = {0: pml.address, 1: c2p.get(timeout=60)}
        p2c.put(peers)
        pml.set_peers(peers)
        comm = Communicator(Group(range(2)), cid=0, pml=pml,
                            my_world_rank=0)
        msg = np.arange(16, dtype=np.int32)
        comm.send(msg, dest=1, tag=1)   # warm the route + ring
        t0 = time.perf_counter()
        for _ in range(n_msgs - 1):
            comm.send(msg, dest=1, tag=1)
        comm.recv(source=1, tag=2)
        dt = time.perf_counter() - t0
        proc.join(timeout=10)
    finally:
        pml.close()
        if proc.is_alive():
            proc.kill()
            proc.join(timeout=10)
    return {
        "metric": "shm PML 2-process message rate (64B, fused native "
                  "engine)",
        "value": round(n_msgs / dt),
        "unit": "msg/s", "vs_baseline": 1.0,
        "us_per_msg": round(dt / n_msgs * 1e6, 2),
        "n_cores": os.cpu_count(),
    }


def matrix_remote_dma(devices: Devices) -> dict:
    """One-sided put (the port's ``window_put``, ≈ btl_put): the self-put
    on card 0 into a symmetric window — on the card one launch of the
    TMA ring kernel a put (``launches``: the put kernel's launches in
    the row).  ``correct`` holds the whole destination shard of one put
    into a zeroed window against the source."""
    import torch

    from ompi_tpu_torch.mpi.device_comm import device_world
    from ompi_tpu_torch.ops import remote_dma, symmetric
    from ompi_tpu_torch.parallel.mesh import make_mesh

    dev = devices.device
    mesh = make_mesh(device=dev)
    comm = device_world(mesh)
    # 64 MiB on the card; small on the CPU
    elems = (1 << 24) if devices.platform == "gpu" else (1 << 13)
    win = symmetric.allocate(mesh, (elems,), torch.float32, fill=0)
    before = remote_dma.put_launch_count
    try:
        val = torch.ones((elems,), dtype=torch.float32, device=dev)
        make = _loop_maker(
            lambda w: remote_dma.window_put(w, val, src=0, dst=0, comm=comm))
        lo, hi = _loop_iters(devices.platform)
        dt, rdma_extra = _slope_or_bound(make, win, lo, hi)
        win.zero_()
        remote_dma.window_put(win, val, src=0, dst=0, comm=comm)
        _sync(dev)
        ok = bool(torch.equal(win, val))
    finally:
        symmetric.free(mesh, win)
    nbytes = elems * 4
    size = (f"{nbytes >> 20}MiB" if nbytes >= 1 << 20
            else f"{nbytes >> 10}KiB")
    return {
        "metric": f"one-sided put {size} self (1 card)",
        "value": round(nbytes / dt / 2**30, 3), "unit": "GiB/s",
        "vs_baseline": 1.0, "correct": ok, "n_devices": 1,
        "shape": [elems], "dtype": "float32",
        "launches": remote_dma.put_launch_count - before, **rdma_extra,
    }


def _decode_case(on_card: bool):
    """(TransformerConfig, batch, prompt_len, lo, hi) of the decode row:
    the flagship's widths (468M) with generous KV room at batch 16, or
    the small f32 CPU branch."""
    from ompi_tpu_torch.models.transformer import TransformerConfig

    if on_card:
        cfg = TransformerConfig(
            vocab=32_000, d_model=2048, n_heads=16, n_layers=8,
            d_ff=8192, seq=512 + 256, attention="xla",
            compute_dtype="bfloat16")
        return cfg, 16, 512, 32, 192
    cfg = TransformerConfig(
        vocab=512, d_model=128, n_heads=8, n_layers=2, d_ff=256,
        seq=96, attention="xla", compute_dtype="float32")
    return cfg, 2, 32, 4, 16


def _decode_prompt(cfg, batch: int, prompt_len: int) -> np.ndarray:
    return np.random.default_rng(0).integers(
        0, cfg.vocab, size=(batch, prompt_len)).astype(np.int32)


def _tokens_digest(tokens) -> str:
    """sha256 of a token array's int32 bytes (C order)."""
    return hashlib.sha256(np.ascontiguousarray(
        np.asarray(tokens), dtype=np.int32).tobytes()).hexdigest()


def matrix_decode_throughput(devices: Devices) -> dict:
    """Inference headline: greedy KV-cache decode tokens/s on one card.

    Two decoders at different ``max_new``; the slope across them cancels
    BOTH the prefill pass and the per-call constants, leaving the
    steady-state per-token step cost of the cached decode loop.
    ``tokens_sha256`` digests the ``hi`` decoder's output tokens."""
    from ompi_tpu_torch.models import transformer as tfm
    from ompi_tpu_torch.models.decode import make_decoder
    from ompi_tpu_torch.models.weights import from_jax_params
    from ompi_tpu_torch.parallel.mesh import make_mesh

    dev = devices.device
    cfg, batch, prompt_len, lo, hi = _decode_case(devices.platform == "gpu")
    mesh = make_mesh({"dp": 1, "sp": 1, "tp": 1}, device=dev)
    params_np = (devices.decode_params.result()
                 if devices.decode_params is not None
                 else tfm.init_params(cfg))
    params = from_jax_params(params_np, cfg, dev, mesh=mesh)
    del params_np
    prompt = _decode_prompt(cfg, batch, prompt_len)
    outs = {}

    def timed(max_new: int):
        dec = make_decoder(cfg, mesh, max_new=max_new)
        out = dec(params, prompt)
        _sync(dev)                            # warm
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            out = dec(params, prompt)
            _ = int(out[0, -1])               # value-readback fence
            times.append(time.perf_counter() - t0)
        outs[max_new] = out
        return min(times), times

    (t_lo, r_lo), (t_hi, r_hi) = timed(lo), timed(hi)
    dt, extra = _slope_fields(t_lo, t_hi, lo, hi)
    row = {
        "metric": f"greedy KV-cache decode ({batch}x{prompt_len} prompt, "
                  f"1 card)",
        "unit": "tokens/s", "vs_baseline": 1.0,
        "value": round(batch / dt, 1), **extra,
        "iters": [lo, hi], "reps_lo_s": r_lo, "reps_hi_s": r_hi,
        "tokens_sha256": _tokens_digest(outs[hi].cpu().numpy()),
    }
    if "suspect" not in extra:
        row["ms_per_token"] = round(dt * 1e3, 3)
    return row


def matrix_flash_bwd_kernel(devices: Devices) -> dict:
    """The flash-attention BACKWARD kernels (opt-in path): forward +
    backward through autograd with ``ops_flash_bwd_kernel`` = 1, one
    warm call and one timed call; on the card the forward, dq and dk/dv
    kernels launch once each a call (``launches`` holds the deltas of
    their counters over both calls)."""
    import torch

    from ompi_tpu_torch.core.config import var_registry

    fa = flagship.flash_module()        # registers the ops_flash_* vars
    dev = devices.device
    old = var_registry.get("ops_flash_bwd_kernel")
    var_registry.set("ops_flash_bwd_kernel", 1)
    try:
        b, t, h, d = 2, 512, 4, 128
        rng = np.random.default_rng(0)
        q, k, v = (torch.from_numpy(rng.normal(size=(b, t, h, d))).to(
            device=dev, dtype=torch.bfloat16).requires_grad_()
            for _ in range(3))

        def grads_of():
            out = fa.flash_attention(q, k, v, causal=True)
            return torch.autograd.grad(out.to(torch.float32).sum(),
                                       (q, k, v))

        before = flagship.flash_counts()
        grads = grads_of()
        _sync(dev)
        t0 = time.perf_counter()
        grads = grads_of()
        _sync(dev)
        dt = time.perf_counter() - t0
        after = flagship.flash_counts()
        finite = all(bool(torch.isfinite(g.float()).all()) for g in grads)
        return {
            "metric": f"flash bwd kernels (seq {t}, "
                      f"{'cuda' if dev.type == 'cuda' else 'cpu plain'})",
            "value": round(dt * 1e3, 2), "unit": "ms", "vs_baseline": 1.0,
            "grads_finite": finite, "shape": [b, t, h, d],
            "dtype": "bfloat16",
            "launches": {k_: after[k_] - before[k_] for k_ in after},
        }
    finally:
        var_registry.set("ops_flash_bwd_kernel", old)


def _tune_row(mesh, n: int, platform: str) -> dict:
    """The tuner over ``mesh``'s ranks → the row; the rules file is
    shipped next to coll/xla only from two or more cards (at one rank
    every collective is a copy and the tuner withholds rules: a
    header-only file would still change what a later run reads)."""
    from ompi_tpu_torch.mpi.coll import rules
    from ompi_tpu_torch.tools.tune import (DEFAULT_OUT, DEFAULT_SIZES,
                                           tune_device_colls)

    out_path = DEFAULT_OUT if platform == "gpu" and n >= 2 else None
    sizes = DEFAULT_SIZES if platform == "gpu" else _TUNE_CPU_SIZES
    text, table = tune_device_colls(mesh, sizes=sizes, out_path=out_path)
    rule_lines = [ln for ln in text.splitlines()
                  if ln and not ln.startswith("#")]
    if out_path:
        shipped = out_path
    elif platform == "gpu":
        shipped = "no (one card: crossovers are copies, rules withheld)"
    else:
        shipped = "no (cpu)"
    return {
        "metric": f"measured coll crossovers ({n} dev)",
        "value": len(rule_lines), "unit": "rules", "vs_baseline": 1.0,
        "rules": rule_lines, "table_us": table,
        "meta": rules.parse(text).meta, "shipped": shipped,
    }


def matrix_tuned_crossovers(devices: Devices, backend: str) -> dict:
    """Run the measured-crossover tuner (``tools/tune.py``): on two or
    more cards in the device-plane job, which ships the rules file next
    to coll/xla; on one card (or the CPU) here, writing nothing."""
    if devices.n >= 2:
        return _plane_row(devices, "tuned_crossovers")
    from ompi_tpu_torch.parallel.mesh import make_mesh

    return _tune_row(make_mesh(device=devices.device), 1, devices.platform)


def run_matrix(devices: Devices, backend: str) -> list[dict]:
    rows: list[dict] = []
    # live view: a SIGTERM mid-matrix still emits the rows that DID
    # complete
    _partial["matrix"] = rows
    for name, fn in (
            ("ring_latency", matrix_ring_latency),
            ("shm_pingpong", matrix_shm_pingpong),
            ("shm_msgrate", matrix_shm_msgrate),
            ("hbm_copy", lambda: matrix_hbm_copy(devices)),
            ("allreduce_sweep", lambda: matrix_allreduce_sweep(devices)),
            ("mesh_bcast_allgather",
             lambda: matrix_mesh_bcast_allgather(devices)),
            ("grad_reduce_scatter",
             lambda: matrix_grad_reduce_scatter(devices)),
            ("oshmem_device", lambda: matrix_oshmem_device(devices)),
            ("remote_dma", lambda: matrix_remote_dma(devices)),
            ("decode_throughput",
             lambda: matrix_decode_throughput(devices)),
            ("flash_bwd_kernel",
             lambda: matrix_flash_bwd_kernel(devices)),
            ("tuned_crossovers",
             lambda: matrix_tuned_crossovers(devices, backend))):
        t0 = time.perf_counter()
        try:
            row = fn()
        except Exception as e:  # noqa: BLE001 — every row must land
            row = {"metric": name, "value": 0, "unit": "error",
                   "vs_baseline": 0, "error": f"{type(e).__name__}: {e}"}
        row["config"] = name
        row["backend"] = backend
        row["wall_s"] = round(time.perf_counter() - t0, 2)
        _flag_suspect(row, backend)
        log(f"matrix[{name}]: {json.dumps(row)}")
        rows.append(row)
    try:
        os.makedirs(os.path.dirname(_MATRIX_PATH), exist_ok=True)
        with open(_MATRIX_PATH, "w") as f:
            json.dump(rows, f, indent=1)
        log(f"matrix written to {_MATRIX_PATH}")
    except OSError as e:
        log(f"matrix write failed: {e}")
    return rows


# ---------------------------------------------------------------------------

# partial evidence for the terminal-signal record: the probe parks its
# attempts list here, run_matrix its rows
_partial: dict = {}


def _arm_signal_record() -> None:
    """The one-JSON-line contract must survive a kill of a too-long run:
    on SIGTERM, emit the record with the evidence so far.  Disarm with
    _disarm_signal_record() right before the real record prints — the
    contract is ONE line, never two."""
    import signal

    def on_term(signum, frame):
        rec = {
            "metric": "bench run (interrupted before completion)",
            "value": 0.0, "unit": "% MFU", "vs_baseline": 0.0,
            "backend": "killed-mid-run",
            "error": f"interrupted by signal {signum}",
            "phase": _partial.get("phase", "probe"),
        }
        rec.update({k: v for k, v in _partial.items() if k != "phase"})
        # os.write, not print: a signal landing mid-print would make a
        # buffered-io call reentrant (RuntimeError inside the handler)
        os.write(1, (json.dumps(rec) + "\n").encode())
        os._exit(1)

    try:
        signal.signal(signal.SIGTERM, on_term)
    except ValueError:
        pass    # not the main thread (imported as a library)


def _disarm_signal_record() -> None:
    import signal

    try:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
    except ValueError:
        pass


def _counters_snapshot() -> dict:
    """The flight-recorder counter block (never raises — the one-line
    record contract survives an import problem)."""
    try:
        from ompi_tpu_torch.mpi import trace as _trace

        return _trace.counters_snapshot()
    except Exception as e:  # noqa: BLE001
        return {"error": f"{type(e).__name__}: {e}"}


def _parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m ompi_tpu_torch.tools.bench",
        description="the port's benchmark tool: one JSON line on stdout")
    ap.add_argument("--cpu", action="store_true",
                    help="run every row on the CPU at the reference's CPU "
                         "sizes (tests); without it the rows need a card")
    ap.add_argument("--ranks", type=int, default=1,
                    help="with --cpu: gloo ranks of the device-plane rows "
                         "(2 or more runs them and the busbw headline)")
    ap.add_argument("--flagship-child", default=None, metavar="KIND",
                    help=argparse.SUPPRESS)
    ap.add_argument("--plane-rank", action="store_true",
                    help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = _parse(argv)
    if args.flagship_child is not None:
        # child: no signal handler — a TERM'd child must die visibly so
        # the parent's rc check reports it
        rec = bench_flagship_mfu(args.flagship_child, args.cpu)
        print("RESULT " + json.dumps(rec), flush=True)
        return 0
    if args.plane_rank:
        _plane_rank_main(args.cpu)
        return 0
    t_start = time.perf_counter()
    _arm_signal_record()
    if args.cpu:
        probe, attempts = {"n": max(1, args.ranks), "platform": "cpu",
                           "kind": "cpu"}, []
    else:
        probe, attempts = _probe_backend()
    if probe is None:
        rec = {"metric": "bench error", "value": 0, "unit": "error",
               "vs_baseline": 0, "backend": "none",
               "error": "no CUDA card: the bench runs on the card (pass "
                        "--cpu to run its CPU sizes)",
               "probe_attempts": attempts,
               "wall_s": round(time.perf_counter() - t_start, 1)}
        _disarm_signal_record()
        print(json.dumps(rec), flush=True)
        return 1
    _partial["phase"] = "headline+matrix"
    backend = probe["platform"]
    devices = Devices(n=probe["n"], platform=backend, kind=probe["kind"])
    log(f"backend: {probe}")
    card = {"kind": devices.kind, "n_devices": devices.n}
    if backend == "gpu":
        card.update(nvidia_smi=_nvidia_smi(), torch=probe.get("torch"),
                    cuda=probe.get("cuda"))
    _partial.update(card)
    from ompi_tpu_torch.models.transformer import init_params

    with ThreadPoolExecutor(1) as pool:
        # the decode row's 468M draw is host work: it runs while the
        # headline's child (or job) has the card
        devices.decode_params = pool.submit(
            init_params, _decode_case(backend == "gpu")[0])
        if devices.n >= 2:
            try:
                devices.plane = _device_plane_job(devices)
            except (RuntimeError, OSError, ValueError,
                    subprocess.TimeoutExpired) as e:
                devices.plane = {"error": f"{type(e).__name__}: {e}"}
            try:
                result = bench_allreduce_busbw(devices)
            except RuntimeError as e:
                result = {"metric": "MPI_Allreduce busbw", "value": 0.0,
                          "unit": "GiB/s", "vs_baseline": 0.0,
                          "error": str(e)}
        else:
            result = _flagship_guarded(devices.kind, args.cpu)
        result["backend"] = backend
        result.update(card)
        if len(attempts) > 1:
            result["probe_attempts"] = [
                {k: a[k] for k in ("attempt", "outcome") if k in a}
                for a in attempts]
        try:
            rows = run_matrix(devices, backend)
        except Exception as e:  # noqa: BLE001 — matrix must not kill the primary
            log(f"matrix failed: {type(e).__name__}: {e}")
            rows = _partial.get("matrix", [])
    result["matrix"] = rows
    result["wall_s"] = round(time.perf_counter() - t_start, 1)
    # provenance: which transport fast paths this run exercised
    result["counters"] = _counters_snapshot()
    _partial["counters"] = result["counters"]
    _disarm_signal_record()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except BaseException as e:  # noqa: BLE001 — stdout must stay one JSON line
        import traceback

        traceback.print_exc(file=sys.stderr)
        print(json.dumps({
            "metric": "bench error", "value": 0, "unit": "error",
            "vs_baseline": 0, "error": f"{type(e).__name__}: {e}"}),
            flush=True)
        rc = 1
    raise SystemExit(rc)
