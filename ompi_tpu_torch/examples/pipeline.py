"""A GPipe pipeline over every rank of a job: ``init()``, ``make_mesh({"pp":
N})`` over the job's process group, and ``parallel.gpipe`` of N stages
(stage d = gelu(h @ w[d] + b[d]) on rank d), forward and backward, held
against the sequential chain of all N stages computed on every rank.

Run on 4 cards:
``python -m ompi_tpu_torch.tools.tpurun -np 4 --gpu -- python -m
ompi_tpu_torch.examples.pipeline`` (the flagship's width: 2048, 16·512
tokens, bf16, 8 microbatches).  ``--device cpu`` runs on gloo CPU ranks
(f32), with the rendezvous exported by hand (``-x
OMPI_TPU_COORD=127.0.0.1:<port> -x OMPI_TPU_NHOSTS=1``).

Each rank prints one ``pipeline {json}`` line: its stage, the largest
difference of the output from the sequential chain's and of its stage's
w and b gradients from the chain's (relative to the largest reference
value), x's gradient summed over the ranks against the chain's, and on
the card the fwd + bwd ms of the pipeline and of the chain (CUDA events).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

import ompi_tpu_torch
from ompi_tpu_torch.mpi.device_comm import device_world
from ompi_tpu_torch.parallel import gpipe
from ompi_tpu_torch.parallel.mesh import make_mesh


def _stage(params, h):
    w, b = params
    return torch.nn.functional.gelu(h @ w + b)


def _rel(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--width", type=int, default=2048)
    p.add_argument("--tokens", type=int, default=16 * 512)
    p.add_argument("--microbatches", type=int, default=8)
    args = p.parse_args(argv)
    comm = ompi_tpu_torch.init()
    mesh = make_mesh({"pp": comm.size}, device=args.device)
    dc = device_world(mesh)
    d, pp, D = mesh.coord("pp"), comm.size, args.width
    dtype = torch.bfloat16 if args.device == "cuda" else torch.float32
    rng = np.random.default_rng(0)          # the same draws on every rank
    w = rng.normal(0, D ** -0.5, size=(pp, D, D)).astype(np.float32)
    b = rng.normal(0, 0.1, size=(pp, D)).astype(np.float32)
    x = rng.normal(size=(args.tokens, D)).astype(np.float32)

    def leaves():
        return [torch.from_numpy(a).to(mesh.device, dtype).requires_grad_()
                for a in (w, b, x)]

    def pipeline():
        lw, lb, lx = leaves()
        out = gpipe(dc, _stage, (lw[d], lb[d]), lx, args.microbatches)
        out.float().square().sum().backward()
        return out.detach(), lw.grad[d], lb.grad[d], lx.grad

    def chain():
        lw, lb, lx = leaves()
        h = lx
        for s in range(pp):
            h = _stage((lw[s], lb[s]), h)
        h.float().square().sum().backward()
        return h.detach(), lw.grad[d], lb.grad[d], lx.grad

    out, gw, gb, gx = pipeline()
    ref, rw, rb, rx = chain()
    gx_sum = dc.allreduce(gx.float())
    res = {"rank": comm.rank, "stage": d, "pp": pp, "width": D,
           "tokens": args.tokens, "microbatches": args.microbatches,
           "dtype": str(dtype).removeprefix("torch."),
           "out_rel_err": _rel(out, ref), "w_grad_rel_err": _rel(gw, rw),
           "b_grad_rel_err": _rel(gb, rb),
           "x_grad_rel_err": _rel(gx_sum, rx)}
    if args.device == "cuda":
        def ms(fn, n=5):
            fn()
            torch.cuda.synchronize()
            a, z = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            for _ in range(n):
                fn()
            z.record()
            z.synchronize()
            return a.elapsed_time(z) / n

        res["pipeline_ms"], res["chain_ms"] = ms(pipeline), ms(chain)
    print("pipeline " + json.dumps(res), flush=True)
    ompi_tpu_torch.finalize()
    return res


if __name__ == "__main__":
    main()
