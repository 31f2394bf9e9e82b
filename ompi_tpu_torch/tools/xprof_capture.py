"""Capture a torch.profiler trace of flagship train steps and summarize it
(the port's counterpart of the repo's ``tools/xprof_capture.py``).

Wraps ``--steps`` train steps of the flagship (``tools/flagship.py``)
in ``torch.profiler`` (CPU and CUDA activities) after one warm step,
keeps the Chrome trace (open it in Perfetto or chrome://tracing), and
prints ONE JSON line saying where the step time went: the fraction in
tensor-core work (``mxu``: GEMMs and the flash kernels), copies and
layout, collectives, and everything else.

On the card the summary counts device events only (kernels, memcpys,
memsets); a trace with none raises.  With ``--cpu`` it counts the host
operators' self time instead (their nesting would count a time twice).

Usage:
    python -m ompi_tpu_torch.tools.xprof_capture             # the card
    python -m ompi_tpu_torch.tools.xprof_capture --cpu 1 --small
    python -m ompi_tpu_torch.tools.xprof_capture --layers 1   # cut depth

Artifacts: ``<out>/trace.json`` (default out
``build/ompi_tpu_torch/xprof_trace``) and ``summary.json`` beside it;
the summary also on stdout.  Its keys: ``events``, ``total_op_ms``,
``fractions``, ``top_ops_ms``, ``backend``, ``steps``,
``traced_wall_ms``, ``params``, ``trace``, and the port's ``n_layers``,
``flash_launches`` (the kernels' counters over the traced steps) and
``flash_events`` (the trace's events of each flash kernel).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional

from ompi_tpu_torch.tools import flagship

# Event name → category.  The reference's keywords (HLO op names) first,
# then the card's: cuBLAS/CUTLASS GEMM kernels (gemm, gemv, xmma, nvjet,
# cutlass) and the port's own flash kernels are tensor-core work, NCCL's
# kernels collectives, memcpy and memset copies.
_COLLECTIVE = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute", "collective", "send", "recv",
               "psum", "ppermute", "nccl")
_MXU = ("dot", "convolution", "einsum", "matmul",
        "gemm", "gemv", "xmma", "nvjet", "cutlass",
        "flash_fwd_", "bwd_dq_", "bwd_dkv_")
#: the CPU's matrix-product operators, whose names carry no keyword
_MXU_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm",
            "aten::_weight_int8pack_mm")
_COPY = ("copy", "transpose", "memset", "bitcast", "reshape", "slice",
         "concatenate", "pad", "broadcast", "gather", "scatter",
         "dynamic-update", "convert", "memcpy")
#: the port's three flash kernels, by a fragment of their names
FLASH = {"flash_fwd": "flash_fwd_", "flash_bwd_dq": "bwd_dq_",
         "flash_bwd_dkv": "bwd_dkv_"}
#: Chrome-trace categories of device work
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def categorize(name: str) -> str:
    n = name.lower()
    for k in _COLLECTIVE:
        if k in n:
            return "collective"
    if name in _MXU_OPS:
        return "mxu"
    for k in _MXU:
        if k in n:
            return "mxu"
    for k in _COPY:
        if k in n:
            return "copy"
    return "other"


def _self_times(events: list) -> list:
    """(name, self µs) of nested host operator events: each event's
    duration less its children's on the same thread."""
    out = []
    by_thread: dict = {}
    for e in events:
        by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    for evs in by_thread.values():
        evs.sort(key=lambda e: (float(e["ts"]), -float(e["dur"])))
        stack: list = []      # [end, name, self]
        for e in evs:
            ts, dur = float(e["ts"]), float(e["dur"])
            while stack and stack[-1][0] <= ts:
                out.append(tuple(stack.pop()[1:]))
            if stack:
                stack[-1][2] -= dur
            stack.append([ts + dur, e["name"], dur])
        out.extend(tuple(s[1:]) for s in stack)
    return out


def summarize_trace(path: str, device: bool) -> dict:
    """Per-category fractions of one Chrome trace's durations: device
    events (kernels, memcpys, memsets) with ``device``, else the host
    operators' self times."""
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
    if device:
        timed = [(e["name"], float(e["dur"])) for e in events
                 if e.get("cat") in _DEVICE_CATS]
        if not timed:
            raise RuntimeError(f"no device event in the trace {path}: the "
                               f"profiler saw no kernel")
    else:
        timed = _self_times([e for e in events if e.get("cat") == "cpu_op"])
    per_cat: dict[str, float] = {}
    per_op: dict[str, float] = {}
    n_events = 0
    for name, dur in timed:
        if dur <= 0:
            continue
        n_events += 1
        cat = categorize(name)
        per_cat[cat] = per_cat.get(cat, 0.0) + dur
        per_op[name] = per_op.get(name, 0.0) + dur
    total = sum(per_cat.values()) or 1.0
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:8]
    return {
        "events": n_events,
        "total_op_ms": total / 1e3,
        "fractions": {k: v / total for k, v in
                      sorted(per_cat.items(), key=lambda kv: -kv[1])},
        "top_ops_ms": {k: v / 1e3 for k, v in top},
        "flash_events": {k: sum(1 for name, _ in timed if frag in name)
                         for k, frag in FLASH.items()},
    }


def capture(out_dir: str, steps: int, small: bool, cpu: bool,
            layers: Optional[int] = None) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ompi_tpu_torch.models import transformer as tfm

    dev = flagship.device(cpu)
    # the flagship (or its CPU-smoke shrink, the reference's), at
    # ``layers`` of depth where given
    s = flagship.build(dev, flagship.cut(flagship.SMALL if small else None,
                                         layers),
                       flagship.SMALL_BATCH if small else None)
    step, init_opt = tfm.make_train_step(s.cfg, s.mesh, lr=flagship.LR)
    opt_state = init_opt(s.params)
    params = s.params
    # warm outside the trace: cuBLAS handles, the kernels' first loads
    params, opt_state, loss = step(params, opt_state, s.tokens)
    flagship.sync(dev)

    os.makedirs(out_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    before = flagship.flash_counts()
    t0 = time.perf_counter()
    with profile(activities=activities) as prof:
        s.tokens[:1].clone()      # a window may miss its first event
        for _ in range(steps):
            params, opt_state, loss = step(params, opt_state, s.tokens)
        flagship.sync(dev)
    wall = time.perf_counter() - t0
    after = flagship.flash_counts()
    loss = float(loss)
    if not torch.isfinite(torch.tensor(loss)):
        raise RuntimeError(f"the traced steps' loss is {loss}")
    trace = os.path.join(os.path.abspath(out_dir), "trace.json")
    prof.export_chrome_trace(trace)
    summary = summarize_trace(trace, device=dev.type == "cuda")
    summary.update(
        backend=s.kind, steps=steps, traced_wall_ms=wall * 1e3,
        params=s.n_params, n_layers=s.cfg.n_layers, trace=trace, loss=loss,
        flash_launches={k: after[k] - before[k] for k in after})
    with open(os.path.join(os.path.dirname(trace), "summary.json"),
              "w") as f:
        json.dump(summary, f, indent=1)
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(flagship.OUT_DIR,
                                                  "xprof_trace"))
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--small", action="store_true",
                    help="tiny model (CPU smoke / tests)")
    ap.add_argument("--layers", type=int, metavar="N",
                    help="the model's depth (default: the config's); the "
                         "widths stay")
    ap.add_argument("--cpu", type=int, metavar="N", default=0,
                    help="run on the CPU (N = 1: one process is one "
                         "device)")
    args = ap.parse_args(argv)
    if args.cpu > 1:
        ap.error("--cpu takes 1: a process of the port is one device")
    summary = capture(args.out, args.steps, args.small, bool(args.cpu),
                      args.layers)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
