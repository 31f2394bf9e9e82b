"""Flagship MFU config sweep on the card (the port's counterpart of the
repo's ``tools/mfu_sweep.py``).

Each row of ``GRID`` (batch, ``ce_chunk``, ``remat``, attention, the
dtypes, ``grad_accum``, sequence length, MCA variables) trains the
flagship of ``tools/flagship.py`` in a fresh child process under its
own wall-clock budget: a row that hangs or runs out of memory costs one
row, not the sweep.  The child sets the row's ``_mca`` variables in
``var_registry`` (``ops_flash_bwd_kernel`` stays off unless a row turns
it on), draws ``init_params`` seed 0 and one batch of tokens (numpy
seed 0), and times ``chain``-step ``make_train_loop`` calls
(:func:`time_train_loop`, the counterpart of ``bench._time_train_loop``):
one call to warm up, then ``outer`` timed calls closed by a value
readback of the last loss; step time = wall / (outer · chain).  MFU =
(6N + 12·L·D·S) FLOPs a token × tokens/s / ``flagship.peak_flops`` (the
H100's 989e12; null on any other device and with ``--cpu``).

The children start ``AHEAD`` rows ahead: while a row runs, the next
rows' children import, draw their parameters on the host (importing
``torch._dynamo`` meanwhile, which ``torch.utils.checkpoint`` would
import at the first step) and create their CUDA context (a process's first
touch of the card takes seconds on its own), then wait for their turn
(a line on their stdin).  A
waiting child launches no work on the card, so a row's steps have the
card to themselves; a row's budget runs from its turn.  The reference's
``bench._enable_compile_cache`` (a shared XLA compile cache) has no
counterpart: the port compiles no program, and its kernels are built
once into ``build/ompi_tpu_torch/`` and loaded from there by every
child.

``ops_flash_block_q``/``_k`` choose the Pallas kernels' tiling in the JAX
package; in the port they are only the tiling rule the sequence must
meet, and the Hopper kernels keep their own tiles.  So the rows
``b16-flash-bq256`` and ``b16-flash-bk512`` time the same kernels as a
row without them; their records say so.

``matmul_peak`` is the calibration row: an 8192² bf16 chain
``y = (y @ y) · 1e-4`` (one cuBLAS GEMM a link, the scale in its
epilogue) at 8 and at 72 links, timed with CUDA events; the slope
between them is one GEMM's time, its share of the 989 TFLOP/s peak the
realistic ceiling of every row; ``dispatch_rt_ms`` is one trivial op's
round trip closed by a value readback.

A record is one JSON line appended to ``build/ompi_tpu_torch/
MFU_SWEEP.jsonl`` (or ``--out``), never to the repo root's
``MFU_SWEEP.jsonl``: the label, ``batch``, the row's config keys,
``backend`` (the card's name), ``mfu_pct``, ``step_ms``,
``tokens_per_s``, ``loss``, ``params``, ``import_s`` (the child's
time before its turn: imports, the draw, ``init_s`` of CUDA context),
``wall_s`` (the child's time but for its wait, ``wait_s``), ``peak_gib``
and the flash kernels' launches over the child's warm and timed steps
(``flash_launches``); a row that fails
gives ``error`` instead (``timeout after <budget>s``, or ``no result``
with the child's exit code and the end of its stderr).

Usage:
    python -m ompi_tpu_torch.tools.mfu_sweep                # the 30 rows
    python -m ompi_tpu_torch.tools.mfu_sweep --quick        # QUICK
    python -m ompi_tpu_torch.tools.mfu_sweep LABEL ...      # these rows
    python -m ompi_tpu_torch.tools.mfu_sweep --cpu --small b16-chunk128-dots
    python -m ompi_tpu_torch.tools.mfu_sweep --layers 1 LABEL ...   # cut depth

The rows run on the card; ``--cpu`` asks for the CPU (a row without it
on a machine with no CUDA device fails) and ``--small`` for
``flagship.SMALL``'s widths, sequence and batch (the tests);
``--layers N`` cuts the rows' depth and keeps their widths and
sequences (a record's ``n_layers``).  The exit code is 1 if any row
failed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Optional

from ompi_tpu_torch.tools import flagship

GRID = [
    # (label, config, per-row budget seconds).  "matmul_peak" is the
    # calibration row: the share of the bf16 peak one large GEMM reaches
    ("matmul_peak", None, 600),
    ("b16-chunk128-dots", {"batch": 16, "ce_chunk": 128, "remat": "dots",
                           "attention": "flash"}, 1500),
    ("b16-chunk128-noremat", {"batch": 16, "ce_chunk": 128, "remat": None,
                              "attention": "flash"}, 1500),
    # the materialized plain attention in place of the flash kernels
    ("b16-chunk128-xla", {"batch": 16, "ce_chunk": 128,
                          "remat": "dots", "attention": "xla"}, 1500),
    ("b16-noremat-xla", {"batch": 16, "ce_chunk": 128, "remat": None,
                         "attention": "xla"}, 1500),
    # the loss's chunk: fewer chunks, larger unembed products
    ("b16-chunk256-dots", {"batch": 16, "ce_chunk": 256, "remat": "dots",
                           "attention": "flash"}, 1500),
    ("b16-chunk512-dots", {"batch": 16, "ce_chunk": 512, "remat": "dots",
                           "attention": "flash"}, 1500),
    ("b32-chunk128-dots", {"batch": 32, "ce_chunk": 128, "remat": "dots",
                           "attention": "flash", "chain": 4, "outer": 1},
     1800),
    ("b32-chunk128-noremat", {"batch": 32, "ce_chunk": 128, "remat": None,
                              "attention": "flash", "chain": 4, "outer": 1},
     1800),
    ("b16-full-dots", {"batch": 16, "ce_chunk": 0, "remat": "dots",
                       "attention": "flash"}, 1500),
    # the flash backward kernels (dq, dk/dv) in place of the recompute
    # backward
    ("b16-chunk128-dots-pbwd", {"batch": 16, "ce_chunk": 128,
                                "remat": "dots", "attention": "flash",
                                "_mca": {"ops_flash_bwd_kernel": 1}}, 1800),
    # longer chains: the per-call host cost spread over more steps
    ("b16-chunk128-dots-chain32", {"batch": 16, "ce_chunk": 128,
                                   "remat": "dots", "attention": "flash",
                                   "chain": 32, "outer": 1}, 1800),
    ("b16-xla-ce512", {"batch": 16, "ce_chunk": 512, "remat": "dots",
                       "attention": "xla"}, 1500),
    ("b16-xla-chain32", {"batch": 16, "ce_chunk": 128, "remat": "dots",
                         "attention": "xla", "chain": 32, "outer": 1},
     1800),
    ("b32-xla", {"batch": 32, "ce_chunk": 128, "remat": "dots",
                 "attention": "xla", "chain": 4, "outer": 1}, 1800),
    ("b16-flash-ce256-chain32", {"batch": 16, "ce_chunk": 256,
                                 "remat": "dots", "attention": "flash",
                                 "chain": 32, "outer": 1}, 1800),
    ("b16-xla-ce256-chain32", {"batch": 16, "ce_chunk": 256,
                               "remat": "dots", "attention": "xla",
                               "chain": 32, "outer": 1}, 1800),
    # batch 24, and batch 32 with every layer recomputed
    ("b24-xla-ce256-chain24", {"batch": 24, "ce_chunk": 256,
                               "remat": "dots", "attention": "xla",
                               "chain": 24, "outer": 1}, 1800),
    ("b32-xla-full-chain16", {"batch": 32, "ce_chunk": 256,
                              "remat": "full", "attention": "xla",
                              "chain": 16, "outer": 1}, 1800),
    ("b32-flash-full-chain16", {"batch": 32, "ce_chunk": 256,
                                "remat": "full", "attention": "flash",
                                "chain": 16, "outer": 1}, 1800),
    ("b16-xla-ce256-chain64", {"batch": 16, "ce_chunk": 256,
                               "remat": "dots", "attention": "xla",
                               "chain": 64, "outer": 1}, 2400),
    # a bf16 first moment
    ("b32-xla-mubf16-chain16", {"batch": 32, "ce_chunk": 256,
                                "remat": "dots", "attention": "xla",
                                "adam_mu_dtype": "bfloat16",
                                "chain": 16, "outer": 1}, 1800),
    ("b24-xla-mubf16-chain24", {"batch": 24, "ce_chunk": 256,
                                "remat": "dots", "attention": "xla",
                                "adam_mu_dtype": "bfloat16",
                                "chain": 24, "outer": 1}, 1800),
    # bf16 parameter storage over an f32 master copy
    ("b16-xla-pbf16-chain32", {"batch": 16, "ce_chunk": 256,
                               "remat": "dots", "attention": "xla",
                               "param_dtype": "bfloat16",
                               "adam_mu_dtype": "bfloat16",
                               "chain": 32, "outer": 1}, 1800),
    # batch 32 as 2 microbatches of 16, one optimizer pass a step
    ("b32-accum2-xla-chain16", {"batch": 32, "grad_accum": 2,
                                "ce_chunk": 256, "remat": "dots",
                                "attention": "xla",
                                "chain": 16, "outer": 1}, 1800),
    # the flash block variables (the tiling rule only, in the port)
    ("b16-flash-bq256", {"batch": 16, "ce_chunk": 256, "remat": "dots",
                         "attention": "flash", "chain": 16, "outer": 1,
                         "_mca": {"ops_flash_block_q": 256,
                                  "ops_flash_block_k": 256}}, 1800),
    ("b16-flash-bk512", {"batch": 16, "ce_chunk": 256, "remat": "dots",
                         "attention": "flash", "chain": 16, "outer": 1,
                         "_mca": {"ops_flash_block_q": 128,
                                  "ops_flash_block_k": 512}}, 1800),
    # longer sequences at the same tokens a step: attention's FLOPs a
    # token grow with S (12·L·D·S)
    ("b8-s2048-xla-chain16", {"batch": 8, "seq": 2048, "ce_chunk": 256,
                              "remat": "dots", "attention": "xla",
                              "chain": 16, "outer": 1}, 1800),
    ("b8-s2048-flash-chain16", {"batch": 8, "seq": 2048, "ce_chunk": 256,
                                "remat": "dots", "attention": "flash",
                                "chain": 16, "outer": 1}, 1800),
    ("b4-s4096-flash-chain16", {"batch": 4, "seq": 4096, "ce_chunk": 256,
                                "remat": "dots", "attention": "flash",
                                "chain": 16, "outer": 1}, 1800),
]

_QUICK_LABELS = ["matmul_peak", "b16-chunk128-dots", "b32-chunk128-dots"]
QUICK = [row for row in GRID if row[0] in _QUICK_LABELS]

#: rows whose children are started before their turn
AHEAD = 3
#: matmul_peak's side and link counts (``--small``: a side the CPU takes)
MATMUL_N, MATMUL_SMALL_N, MATMUL_ITERS = 8192, 256, (8, 72)
#: what the block rows' records say
BLOCK_NOTE = ("ops_flash_block_q/_k are the port's tiling rule only; the "
              "Hopper kernels keep their own tiles, so this row times the "
              "same kernels as a row without them")


def time_train_loop(cfg, mesh, tokens, chain: int, outer: int,
                    params=None):
    """(seconds a step, parameters, the last loss) of ``outer`` timed
    calls of a ``chain``-step ``make_train_loop`` at lr 1e-3, after one
    warm call; ``params`` are trainable leaves on the mesh's device,
    ``init_params(cfg)`` seed 0 through ``from_jax_params(...,
    train=True)`` by default (``torch._dynamo`` imported during the
    draw, ``flagship.importing_dynamo``).  The clock is closed by a value readback
    of the last loss, which waits for every step before it."""
    from ompi_tpu_torch.models import transformer as tfm
    from ompi_tpu_torch.models.weights import from_jax_params

    if params is None:
        with flagship.importing_dynamo():
            params_np = tfm.init_params(cfg)
        params = from_jax_params(params_np, cfg, mesh.device, train=True,
                                 mesh=mesh)
    n_params = flagship.count_params(params)
    loop, init_opt = tfm.make_train_loop(cfg, mesh, lr=flagship.LR,
                                         steps=chain)
    opt_state = init_opt(params)
    params, opt_state, losses = loop(params, opt_state, tokens)   # warm
    _ = float(losses[-1])
    t0 = time.perf_counter()
    for _ in range(outer):
        params, opt_state, losses = loop(params, opt_state, tokens)
    loss = float(losses[-1])
    dt = (time.perf_counter() - t0) / (outer * chain)
    return dt, n_params, loss


def _init_device(dev) -> float:
    """Create this process's CUDA context (no kernel runs); → seconds."""
    import torch

    t0 = time.time()
    if dev.type == "cuda":
        torch.empty(1, device=dev)
        torch.cuda.synchronize(dev)
    return time.time() - t0


def _wait_turn(gate) -> float:
    """Block until the parent gives this child the card (a line on
    ``gate``); → the seconds waited."""
    t0 = time.time()
    if gate is not None and not gate.readline():
        raise SystemExit("mfu_sweep: the parent went away")
    return time.time() - t0


def _peak_memory_gib(dev):
    import torch

    if dev.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(dev) / 2 ** 30


def run_row(cfg: dict, cpu: bool, small: bool, gate=None,
            layers: Optional[int] = None) -> dict:
    """One training row in this process → its record (without the
    label), at ``layers`` of depth (default the config's).  The device
    is resolved first (no card and no ``--cpu`` fails here), then the
    host half (``flagship.draw``, which imports ``torch._dynamo``
    meanwhile), then ``gate`` is waited on."""
    from ompi_tpu_torch.core.config import var_registry

    t0 = time.time()
    fa = flagship.flash_module()          # registers the ops_* variables
    dev = flagship.device(cpu)
    row = dict(cfg)
    batch = row.pop("batch")
    chain = row.pop("chain", 8)
    outer = row.pop("outer", 2)
    mca = row.pop("_mca", None)
    for k, v in (mca or {}).items():
        var_registry.set(k, v)
    drawn = flagship.draw(flagship.cut(flagship.SMALL if small else None,
                                       layers),
                          flagship.SMALL_BATCH if small else batch, **row)
    init_s = _init_device(dev)
    import_s = time.time() - t0
    wait_s = _wait_turn(gate)
    t_dev = time.time()
    s = flagship.build(dev, drawn=drawn)
    # build() switches the backward kernels on for the profiling tools; a
    # row runs them only where its _mca asks, as the reference's child
    var_registry.set("ops_flash_bwd_kernel",
                     bool((mca or {}).get("ops_flash_bwd_kernel", False)))
    fa.launch_count = fa.dq_launch_count = fa.dkv_launch_count = 0
    dt, n_params, loss = time_train_loop(s.cfg, s.mesh, s.tokens, chain,
                                         outer, s.params)
    n_tokens = s.tokens.numel()
    peak = None if cpu else flagship.peak_flops(s.kind)
    mfu = (flagship.flops_per_token(s.cfg, n_params) * n_tokens / dt / peak
           if peak else None)
    rec = {"batch": s.batch, **{k: getattr(s.cfg, k) for k in row},
           "backend": s.kind,
           "mfu_pct": mfu * 100 if mfu is not None else None,
           "step_ms": dt * 1e3, "tokens_per_s": n_tokens / dt,
           "loss": loss, "params": n_params, "import_s": import_s,
           "wall_s": import_s + time.time() - t_dev, "wait_s": wait_s,
           "init_s": init_s,
           "chain": chain, "outer": outer, "seq": s.cfg.seq,
           "n_layers": s.cfg.n_layers,
           "flash_launches": flagship.flash_counts(),
           "peak_gib": _peak_memory_gib(dev)}
    if mca:
        rec["mca"] = mca
        if {"ops_flash_block_q", "ops_flash_block_k"} & set(mca):
            rec["note"] = BLOCK_NOTE
    return rec


def matmul_peak(cpu: bool, small: bool, gate=None) -> dict:
    """The calibration row in this process → its record."""
    import numpy as np
    import torch

    dev = flagship.device(cpu)
    n = MATMUL_SMALL_N if small else MATMUL_N
    lo, hi = MATMUL_ITERS
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (n, n), dtype=np.float32)).to(torch.bfloat16)
    _init_device(dev)
    _wait_turn(gate)
    x = x.to(dev)
    z = torch.zeros((8, 128), device=dev)
    z = z + 1.0
    flagship.sync(dev)
    t0 = time.perf_counter()
    z = z + 1.0
    _ = float(z[0, 0])
    dispatch_ms = (time.perf_counter() - t0) * 1e3
    bufs = (torch.empty_like(x), torch.empty_like(x))

    def chain(iters):
        y = x
        for i in range(iters):
            out = bufs[i % 2]
            out.addmm_(y, y, beta=0.0, alpha=1e-4)
            y = out
        return y

    def timed(iters) -> float:
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            chain(iters)
            b.record()
            b.synchronize()
            return a.elapsed_time(b) / 1e3
        t = time.perf_counter()
        chain(iters)
        return time.perf_counter() - t

    def best(iters) -> float:
        chain(iters)                     # warm
        flagship.sync(dev)
        return min(timed(iters) for _ in range(3))

    t_lo, t_hi = best(lo), best(hi)
    dt = (t_hi - t_lo) / (hi - lo)
    tf = 2 * n ** 3 / dt / 1e12
    kind = flagship.device_kind(dev)
    peak = None if cpu else flagship.peak_flops(kind)
    return {"n": n, "iters": [lo, hi], "ms": dt * 1e3,
            "dispatch_rt_ms": dispatch_ms, "wall_lo_s": t_lo,
            "wall_hi_s": t_hi, "tflops": tf,
            "pct_of_peak": tf * 1e12 / peak * 100 if peak else None,
            "peak_tflops": peak / 1e12 if peak else None, "backend": kind}


def _start(label: str, cfg, cpu: bool, small: bool,
           layers: Optional[int] = None) -> subprocess.Popen:
    """A row's child, started at once: it does its host half and then
    waits for a line on its stdin."""
    return subprocess.Popen(
        [sys.executable, "-m", "ompi_tpu_torch.tools.mfu_sweep", "--child",
         label, json.dumps(cfg)] + ["--cpu"] * cpu + ["--small"] * small
        + (["--layers", str(layers)] if layers is not None else []),
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=flagship.REPO)


def _finish(label: str, proc: subprocess.Popen, budget: float) -> dict:
    """Give ``proc`` its turn and wait at most ``budget`` seconds for
    its record."""
    t0 = time.time()
    try:
        out, err = proc.communicate("go\n", timeout=budget)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        return {"label": label, "error": f"timeout after {budget}s",
                "wall_s": time.time() - t0}
    for line in out.splitlines():
        if line.startswith("RESULT "):
            rec = json.loads(line[len("RESULT "):])
            rec["label"] = label
            return rec
    return {"label": label, "error": "no result", "rc": proc.returncode,
            "stderr_tail": err[-800:], "wall_s": time.time() - t0}


def run_one(label: str, cfg, budget: float, cpu: bool = False,
            small: bool = False) -> dict:
    """One row in a fresh child under ``budget`` seconds → its record."""
    return _finish(label, _start(label, cfg, cpu, small), budget)


def _select(names: list, quick: bool) -> list:
    if quick:
        return QUICK
    if not names:
        return GRID
    by = {label: (label, cfg, budget) for label, cfg, budget in GRID}
    unknown = [n for n in names if n not in by]
    if unknown:
        sys.exit(f"unknown row(s) {unknown}; known: {sorted(by)}")
    return [by[n] for n in names]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("labels", nargs="*", metavar="LABEL",
                    help="rows of GRID (default: all)")
    ap.add_argument("--quick", action="store_true",
                    help=f"the rows {', '.join(_QUICK_LABELS)}")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--small", action="store_true",
                    help="tiny model (CPU smoke / tests)")
    ap.add_argument("--layers", type=int, default=None,
                    help="the rows' depth (widths unchanged; default the "
                         "config's)")
    ap.add_argument("--out", default=flagship.SWEEP,
                    help="JSONL file the rows are appended to")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        _label, cfg = args.labels
        cfg = json.loads(cfg)
        rec = (matmul_peak(args.cpu, args.small, gate=sys.stdin)
               if cfg is None else
               run_row(cfg, args.cpu, args.small, gate=sys.stdin,
                       layers=args.layers))
        print("RESULT " + json.dumps(rec), flush=True)
        return []
    grid = _select(args.labels, args.quick)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    recs = []
    procs = [None] * len(grid)
    try:
        for i, (label, cfg, budget) in enumerate(grid):
            for j in range(i, min(i + AHEAD + 1, len(grid))):
                if procs[j] is None:
                    procs[j] = _start(grid[j][0], grid[j][1], args.cpu,
                                      args.small, args.layers)
            print(f"[sweep] {label} (budget {budget}s) ...", flush=True)
            rec = _finish(label, procs[i], budget)
            rec["ts"] = time.strftime("%Y-%m-%dT%H:%MZ", time.gmtime())
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
            print(f"[sweep] {label}: {json.dumps(rec)}", flush=True)
            recs.append(rec)
    finally:
        for proc in procs:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.communicate()
    if any("error" in r for r in recs):
        raise SystemExit(1)
    return recs


if __name__ == "__main__":
    main()
