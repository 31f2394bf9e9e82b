"""Flagship step-time breakdown on the card: forward only against forward
+ backward against the full optimizer step (the port's counterpart of
the repo's ``tools/step_breakdown.py``).

Each phase runs in its own child process (``fwd``, ``grad``, ``full``),
on the flagship train step of ``tools/flagship.py``; the children start
together and draw their parameters at once, then take the device one
after another.  A phase times a
chain of 32 calls after one warm call, with a device synchronize before
and after the timed loop; each call of the chain depends on the one
before (the previous loss, times 1e-20, is added to the final norm's
scale: invisible in f32, but the next call's kernels wait for it), so
the chain times the calls back to back.  ``fwd`` is the loss alone
(no autograd graph), ``grad`` the loss and every gradient, ``full``
``make_train_step``'s step (the chain's steps depend on each other
through the parameters).  A record carries the flash kernels' launches
over its timed chain.

If fwd-only MFU is far above the train step's, the backward (remat
recompute, the attention backward) is the target; if it is already low,
the forward itself is.  MFU = (6N + 12·L·D·S)·scale FLOPs a token ×
tokens/s / the card's bf16 peak (989e12 on an H100), scale 1/3 for
``fwd``; off an H100 (or with ``--cpu``) it is null.

Usage:
    python -m ompi_tpu_torch.tools.step_breakdown [fwd] [grad] [full]
    python -m ompi_tpu_torch.tools.step_breakdown --cpu --small fwd
    python -m ompi_tpu_torch.tools.step_breakdown --layers 1   # cut depth

Appends one JSON line per phase (label ``breakdown-<phase>``) to
``build/ompi_tpu_torch/MFU_SWEEP.jsonl`` and prints it as
``[breakdown] <phase>: {json}``.
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

PHASES = ("fwd", "grad", "full")
CHAIN = 32


def _bump(params, carry) -> None:
    """The chain's data dependency: ``carry`` × 1e-20 into ``lnf``."""
    import torch

    with torch.no_grad():
        params["lnf"].add_(carry.detach().to(params["lnf"].dtype) * 1e-20)


def run_phase(phase: str, cpu: bool, small: bool, chain: int = CHAIN,
              gate=None, layers: Optional[int] = None) -> dict:
    """One phase in this process: → its record.  With ``gate`` (a file)
    the host half (imports, the parameters' draw) runs first, then one
    line is read from ``gate`` before the device is touched.  ``layers``
    cuts the depth (:func:`flagship.cut`)."""
    import torch

    from ompi_tpu_torch.models import transformer as tfm

    if phase not in PHASES:
        raise ValueError(f"unknown phase {phase!r}; one of {PHASES}")
    t0 = time.time()
    drawn = flagship.draw(flagship.cut(flagship.SMALL if small else None,
                                       layers),
                          flagship.SMALL_BATCH if small else None)
    if gate is not None and not gate.readline():
        raise SystemExit(f"step_breakdown {phase}: the parent went away")
    t_gate = time.time()
    dev = flagship.device(cpu)
    s = flagship.build(dev, drawn=drawn)
    params, tokens = s.params, s.tokens
    if phase == "fwd":
        loss_fn = tfm.make_loss_fn(s.cfg, s.mesh)

        def call(carry):
            _bump(params, carry)
            with torch.no_grad():
                return loss_fn(params, tokens)
        scale = 1.0 / 3.0        # fwd ≈ 1/3 of the 6N fwd+bwd accounting
    elif phase == "grad":
        loss_fn = tfm.make_loss_fn(s.cfg, s.mesh)
        keys = list(params)

        def call(carry):
            _bump(params, carry)
            loss = loss_fn(params, tokens)
            grads = torch.autograd.grad(loss, [params[k] for k in keys])
            return loss.detach() + grads[0].reshape(-1)[0].float() * 0
        scale = 1.0
    else:
        step, init_opt = tfm.make_train_step(s.cfg, s.mesh, lr=flagship.LR)
        opt_state = init_opt(params)

        def call(carry):
            nonlocal params, opt_state
            params, opt_state, loss = step(params, opt_state, tokens)
            return loss
        scale = 1.0
    carry = torch.zeros((), device=dev)
    carry = call(carry)                    # warm
    flagship.sync(dev)
    before = flagship.flash_counts()
    t1 = time.perf_counter()
    for _ in range(chain):
        carry = call(carry)
    flagship.sync(dev)
    dt = (time.perf_counter() - t1) / chain
    launches = {k: v - before[k] for k, v in flagship.flash_counts().items()}
    loss = float(carry)
    fpt = flagship.flops_per_token(s.cfg, s.n_params) * scale
    peak = flagship.peak_flops(s.kind)
    mfu = fpt * tokens.numel() / dt / peak if peak and not cpu else None
    return {"phase": phase, "backend": s.kind,
            "mfu_pct": mfu * 100 if mfu is not None else None,
            "step_ms": dt * 1e3, "loss": loss, "params": s.n_params,
            "chain": chain, "batch": s.batch, "seq": s.cfg.seq,
            "n_layers": s.cfg.n_layers,
            "flash_launches": launches, "wall_s": time.time() - t0,
            "device_wall_s": time.time() - t_gate}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("phases", nargs="*", metavar="phase",
                    help=f"any of {', '.join(PHASES)} (default: all)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--small", action="store_true",
                    help="tiny model (CPU smoke / tests)")
    ap.add_argument("--layers", type=int, metavar="N",
                    help="the model's depth (default: the config's); the "
                         "widths stay")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    bad = sorted(set(args.phases) - set(PHASES))
    if bad:
        ap.error(f"unknown phase(s) {bad}; choose from {PHASES}")
    if args.child:
        (phase,) = args.phases
        print("RESULT " + json.dumps(run_phase(
            phase, args.cpu, args.small, gate=sys.stdin,
            layers=args.layers)), flush=True)
        return []
    os.makedirs(flagship.OUT_DIR, exist_ok=True)
    phases = args.phases or list(PHASES)
    # every child draws its parameters at once; each then waits for its
    # turn on the device, so no two phases share it
    children = {phase: subprocess.Popen(
        [sys.executable, "-m", "ompi_tpu_torch.tools.step_breakdown",
         "--child", phase] + ["--cpu"] * args.cpu + ["--small"] * args.small
        + (["--layers", str(args.layers)] if args.layers else []),
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=flagship.REPO) for phase in phases}
    recs = []
    try:
        for phase, proc in children.items():
            t0 = time.time()
            try:
                out, err = proc.communicate("go\n", timeout=1500)
                rec = None
                for line in out.splitlines():
                    if line.startswith("RESULT "):
                        rec = json.loads(line[len("RESULT "):])
                if rec is None:
                    rec = {"error": "no result", "rc": proc.returncode,
                           "stderr_tail": err[-700:]}
            except subprocess.TimeoutExpired:
                rec = {"error": "timeout", "wall_s": time.time() - t0}
            rec["label"] = f"breakdown-{phase}"
            rec["ts"] = time.strftime("%Y-%m-%dT%H:%MZ", time.gmtime())
            with open(flagship.SWEEP, "a") as f:
                f.write(json.dumps(rec) + "\n")
            print(f"[breakdown] {phase}: {json.dumps(rec)}", flush=True)
            recs.append(rec)
    finally:
        for proc in children.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    if any("error" in r for r in recs):
        raise SystemExit(1)
    return recs


if __name__ == "__main__":
    main()
