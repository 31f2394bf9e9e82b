"""Measure the one-sided put and get kernels of a checkout on one card.

    python ompi_tpu_torch/tools/rma_probe.py [--root DIR] [--sweep]

Imports ``ompi_tpu_torch`` from ``--root`` (default: the checkout this
file is in), so the same script measures an earlier tree beside this
one.  Prints one JSON line with the card's name and power limit and:

- ``handshake``: put and get of 64 MiB f32 with the whole flag
  handshake (``both``: wait on ready, arrive at the counter, release
  done), with the wait alone, with the arrival and release alone, and
  with none of it (``Sync()``), ms by CUDA events over 20 back-to-back
  calls;
- ``small``: a 4 KiB put: the device time of one launch in the same
  four modes (torch.profiler over 50); with the whole handshake the
  call rate (CUDA events over 200 back-to-back calls), the host time of
  a call (perf_counter over 1000 calls), and that host call split into
  the wrapper's checks, its launch
  plan (or grid), its pointer marshalling, the stream lookup and the C
  call (each part timed alone over 1000 calls; the checks are the
  wrapper's time with the C call stubbed, less the other parts);
- with ``--sweep`` (a tree that has ``copy_plan``): puts of 64 and
  256 MiB without the handshake over ring plans (chunk bytes: the
  plan's, 8 and 32 KiB; stages and loads ahead) through the C entry,
  each checked bitwise, beside the default plan and ``Tensor.copy_``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import types

MIB = 1 << 20


def _cuda_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def _host_us(fn, n=1000):
    """Host time of one call in µs, over ``n`` calls (then a synchronize,
    outside the timing, so the queue does not fill)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return secs / n * 1e6


def _device_us(fn, name, n=50):
    """Mean device time of the kernels whose name holds ``name``, from
    torch.profiler over ``n`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for e in prof.key_averages():
        if e.device_type.name == "CUDA" and name in e.key:
            total += getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
            count += e.count
    return {"us": total / count if count else None, "launches": count}


class _Words:
    """One call's flag words on the card: ready set far ahead, so every
    wait passes at once; ``modes`` are the Syncs of the four modes (each
    that arrives with a counter of its own, so its last block releases)."""

    def __init__(self, rd, dev):
        import torch

        self.flags = torch.zeros(5, dtype=torch.int64, device=dev)
        self.flags[0] = 1 << 62
        ready, done, status, counter, counter2 = (
            self.flags[i:i + 1] for i in range(5))
        self.sync = rd.Sync(wait=[ready], release=[done], counter=counter,
                            status=status, seq=1)
        self.modes = {
            "both": self.sync,
            "wait": rd.Sync(wait=[ready], status=status, seq=1),
            "release": rd.Sync(release=[done], counter=counter2,
                               status=status, seq=1),
            "none": rd.Sync()}


def _split(rd, land, src, sync):
    """The host call of a 4 KiB put, split into its parts (µs)."""
    import torch

    dev = src.device
    total = _host_us(lambda: rd.put_kernel(land, src, sync))
    real = rd._fns
    if hasattr(rd, "copy_plan"):
        f = real()
        idx = dev.index
        words = (*sync.wait, *sync.release, sync.counter, sync.status)
        plan = rd._plan(src.nbytes, True, f.sms(idx))
        ptrs = [src.data_ptr(), land.data_ptr(),
                *(w.data_ptr() for w in words)]
        call = rd._CALL.pack(*ptrs, sync.seq, sync.arrived + plan.grid,
                             plan.address, f.stream(idx), 0, idx)
        parts = {
            "plan": _host_us(lambda: rd._plan(src.nbytes, True, f.sms(idx))),
            "marshal": _host_us(lambda: rd._CALL.pack(
                src.data_ptr(), land.data_ptr(),
                *(rd._addr(w, idx) for w in words), sync.seq, 0,
                plan.address, 0, 0, idx)),
            "stream": _host_us(lambda: f.stream(idx)),
            "c_call": _host_us(lambda: f.ring(call))}
        stub = types.SimpleNamespace(**{**vars(f), "ring": lambda *a: 0})
    else:
        copy, sig = real()
        grid = rd.grid_for(src.nbytes)
        args = (0, dev.index, src.data_ptr(), rd._ptrs([land]), 1,
                src.nbytes, rd._ptrs(sync.wait), 1, rd._ptrs(sync.release),
                1, sync.counter.data_ptr(), sync.arrived + grid,
                sync.status.data_ptr(), sync.seq, grid,
                torch.cuda.current_stream(dev).cuda_stream)
        parts = {
            "plan": _host_us(lambda: rd.grid_for(src.nbytes)),
            "marshal": _host_us(lambda: (
                rd._ptrs([land]), rd._ptrs(sync.wait),
                rd._ptrs(sync.release), rd._ptr(sync.counter),
                rd._ptr(sync.status))),
            "stream": _host_us(
                lambda: torch.cuda.current_stream(dev).cuda_stream),
            "c_call": _host_us(lambda: copy(*args))}
        stub = (lambda *a: 0, sig)
    rd._fns = lambda: stub
    try:
        no_c_call = _host_us(lambda: rd.put_kernel(land, src, sync))
    finally:
        rd._fns = real
    parts["checks"] = no_c_call - parts["plan"] - parts["marshal"] \
        - parts["stream"]
    return {"total_us": total, "wrapper_without_c_call_us": no_c_call,
            "parts_us": parts}


def _handshake(rd, dev):
    """64 MiB put and get with and without the handshake (ms)."""
    import torch

    src = torch.randn(16 * MIB, device=dev)
    land = torch.empty_like(src)
    w = _Words(rd, dev)
    out = {}
    for name, fn in (("put", rd.put_kernel), ("get", rd.get_kernel)):
        out[name] = {f"{mode}_ms": _cuda_ms(lambda: fn(land, src, sync))
                     for mode, sync in w.modes.items()}
        torch.cuda.synchronize()
        if not torch.equal(land, src):
            raise AssertionError(f"{name} of 64 MiB differs from its source")
    return out


def _small(rd, dev):
    import torch

    src = torch.randn(1024, device=dev)
    land = torch.empty_like(src)
    w = _Words(rd, dev)
    call = lambda: rd.put_kernel(land, src, w.sync)  # noqa: E731
    out = {"call_rate_us": _cuda_ms(call, iters=200, warmup=20) * 1e3,
           "copy_call_rate_us": _cuda_ms(lambda: land.copy_(src), iters=200,
                                         warmup=20) * 1e3,
           "device": {mode: _device_us(
               lambda: rd.put_kernel(land, src, sync), "rma_put_kernel")
               for mode, sync in w.modes.items()},
           "host": _split(rd, land, src, w.sync)}
    torch.cuda.synchronize()
    if not torch.equal(land, src):
        raise AssertionError("put of 4 KiB differs from its source")
    return out


def _sweep(rd, dev):
    """Puts of 64 and 256 MiB over ring plans, without the handshake."""
    import torch

    f = rd._fns()
    idx = dev.index
    sms = f.sms(idx)
    rows = []
    for nbytes in (64 * MIB, 256 * MIB):
        src = torch.randint(-2**31, 2**31 - 1, (nbytes // 4,),
                            dtype=torch.int32, device=dev)
        land = torch.empty_like(src)
        base = rd.copy_plan(nbytes, src.data_ptr(), land.data_ptr(), sms)
        plans = [("default", base)]
        for stage in (base.stage, 8 << 10, 32 << 10):
            for stages, ahead in ((4, 2), (3, 2), (2, 2), (4, 3), (6, 3),
                                  (8, 4)):
                if stages * stage > rd.MAX_RING_BYTES:
                    continue
                plans.append((f"{stage >> 10}K:{stages}x+{ahead}",
                              dataclasses.replace(
                                  base, stage=stage, stages=stages,
                                  ahead=ahead, smem=stages * stage,
                                  grid=min(sms, -(-nbytes // stage)))))

        def run(plan):
            err = f.ring(rd._CALL.pack(src.data_ptr(), land.data_ptr(), 0, 0,
                                       0, 0, 0, 0, plan.address,
                                       f.stream(idx), 0, idx))
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err} {plan}")

        copy_ms = _cuda_ms(lambda: land.copy_(src))
        for name, plan in plans:
            land.zero_()
            ms = _cuda_ms(lambda: run(plan))
            torch.cuda.synchronize()
            rows.append({"bytes": nbytes, "plan": name, "ms": ms,
                         "copy_ms": copy_ms, "equal": torch.equal(land, src)})
        del src, land
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    here = os.path.dirname(os.path.abspath(__file__))
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    from ompi_tpu_torch.ops import remote_dma as rd

    if not os.path.abspath(rd.__file__).startswith(os.path.join(root, "")):
        print(f"rma_probe: imported {rd.__file__}, not from {root}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("rma_probe: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    out = {"root": args.root, "card": smi,
           "handshake": _handshake(rd, dev), "small": _small(rd, dev)}
    if args.sweep:
        out["sweep"] = _sweep(rd, dev)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
