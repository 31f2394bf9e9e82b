"""FLOPs and bytes of one flagship train step as PyTorch's dispatcher sees
them, turned into a roofline bound (the port's counterpart of the repo's
``tools/cost_analysis.py``, which asks XLA's compiler; eager PyTorch has
no compiled program to ask).

One train step of the flagship (``tools/flagship.py``) runs under a
``TorchDispatchMode`` that counts, for every operator it dispatches:

- FLOPs by ``torch.utils.flop_counter``'s formulas (matrix products,
  convolutions, attention; 0 for elementwise work);
- bytes: each tensor argument plus each output, once a call (an unfused
  upper bound: every operator reads its inputs from HBM and writes its
  outputs back); views and allocations move none.

The port's flash kernels are launches behind ``torch.autograd.Function``
and pass the dispatcher by, so their FLOPs and bytes are added from
their shapes and the launch counters: the forward 4·BH·D per live causal
(query, key) pair, dq 6 and dk/dv 8, each reading q, k, v (and g, lse,
dm) once and writing its outputs once.  On the CPU the wrappers run
their plain versions, which the dispatcher does see.

    step_time >= max(flops / peak_flops, bytes / hbm_bw)

Usage:  python -m ompi_tpu_torch.tools.cost_analysis [--cpu] [--small]
            [--layers N]
Prints the record and appends it (label ``cost-analysis``) to
``build/ompi_tpu_torch/MFU_SWEEP.jsonl``.  The bounds are null off an
H100 (no peak).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ompi_tpu_torch.tools import flagship

#: the ``--small`` config (the reference's)
SMALL = dict(vocab=1024, d_model=256, n_heads=4, n_layers=2, d_ff=1024,
             seq=256, ce_chunk=64)
#: operators that allocate without writing (their outputs carry no data)
_ALLOC = ("empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided")


def live_pairs(t_q, t_k, causal, q_off, k_off) -> int:
    """(query, key) pairs a causal mask on global positions leaves."""
    if not causal:
        return t_q * t_k
    qpos = q_off + np.arange(t_q)[:, None]
    kpos = k_off + np.arange(t_k)[None, :]
    return int((qpos >= kpos).sum())


def flash_costs(bh, t_q, t_k, d, itemsize, causal=True, q_off=0,
                k_off=0) -> dict:
    """(FLOPs, bytes) of one launch of each flash kernel: the forward
    reads q, k, v and writes o and the f32 lse; dq reads q, k, v, g and
    the f32 lse and dm and writes dq; dk/dv reads the same and writes dk
    and dv."""
    pairs = live_pairs(t_q, t_k, causal, q_off, k_off)
    ins = (2 * t_q + 2 * t_k) * bh * d * itemsize
    return {
        "flash_fwd": (4 * bh * d * pairs, ins + bh * t_q * 4),
        "flash_bwd_dq": (6 * pairs * d * bh,
                         ins + 2 * bh * t_q * 4 + t_q * bh * d * itemsize),
        "flash_bwd_dkv": (8 * pairs * d * bh,
                          ins + 2 * bh * t_q * 4
                          + 2 * t_k * bh * d * itemsize),
    }


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


class CostMode(TorchDispatchMode):
    """Counts FLOPs and bytes of every dispatched operator."""

    def __init__(self) -> None:
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        if not func.is_view and func._overloadpacket.__name__ not in _ALLOC:
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out


def analyze(cpu: bool, small: bool, layers: Optional[int] = None) -> dict:
    from ompi_tpu_torch.models import transformer as tfm

    t0 = time.time()
    dev = flagship.device(cpu)
    s = flagship.build(dev, flagship.cut(SMALL if small else None, layers),
                       flagship.SMALL_BATCH if small else None)
    step, init_opt = tfm.make_train_step(s.cfg, s.mesh, lr=flagship.LR)
    opt_state = init_opt(s.params)
    params, opt_state, _ = step(s.params, opt_state, s.tokens)  # warm
    flagship.sync(dev)
    before = flagship.flash_counts()
    with CostMode() as mode:
        params, opt_state, loss = step(params, opt_state, s.tokens)
        flagship.sync(dev)
    launches = {k: v - before[k] for k, v in flagship.flash_counts().items()}
    cfg = s.cfg
    per = flash_costs(s.batch * cfg.n_heads, cfg.seq, cfg.seq, cfg.head_dim,
                      torch.empty((), dtype=tfm.torch_dtype(
                          cfg.compute_dtype)).element_size())
    k_flops = sum(per[k][0] * n for k, n in launches.items())
    k_bytes = sum(per[k][1] * n for k, n in launches.items())
    flops, nbytes = mode.flops + k_flops, mode.bytes + k_bytes
    analytic = flagship.flops_per_token(cfg, s.n_params) * s.tokens.numel()
    kind = s.kind
    peak, bw = flagship.peak_flops(kind), flagship.hbm_bw(kind)
    if cpu:
        peak = bw = None
    return {
        "label": "cost-analysis", "backend": kind, "batch": s.batch,
        "seq": cfg.seq, "n_layers": cfg.n_layers, "params": s.n_params,
        "loss": float(loss),
        "flops": flops, "bytes_accessed": nbytes,
        "dispatch_flops": mode.flops, "dispatch_bytes": mode.bytes,
        "dispatch_ops": mode.ops, "kernel_flops": k_flops,
        "kernel_bytes": k_bytes, "flash_launches": launches,
        "analytic_flops": analytic, "flops_over_analytic": flops / analytic,
        "flops_bound_ms": flops / peak * 1e3 if peak else None,
        "bytes_bound_ms": nbytes / bw * 1e3 if bw else None,
        "arith_intensity": flops / nbytes if nbytes else None,
        "peak_flops": peak, "hbm_bw": bw,
        "wall_s": time.time() - t0,
        "ts": time.strftime("%Y-%m-%dT%H:%MZ", time.gmtime()),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--small", action="store_true",
                    help="the small config (CPU smoke / tests)")
    ap.add_argument("--layers", type=int, metavar="N",
                    help="the model's depth (default: the config's); the "
                         "widths stay")
    args = ap.parse_args(argv)
    rec = analyze(args.cpu, args.small, args.layers)
    os.makedirs(flagship.OUT_DIR, exist_ok=True)
    with open(flagship.SWEEP, "a") as f:
        f.write(json.dumps(rec) + "\n")
    print(json.dumps(rec, indent=1))
    return rec


if __name__ == "__main__":
    main()
