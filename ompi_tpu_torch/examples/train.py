"""End-to-end training on a mesh of the job's ranks: the full stack in one
file (the port's copy of the repo's ``examples/train.py``, printing the
same lines).

data pipeline (deterministic windows, this rank's dp block, device
prefetch) → the dp × sp × tp transformer step → a snapshot checkpoint at
half the steps → a resumed stream that reproduces the exact batch
stream from the saved step.

Run:  python -m ompi_tpu_torch.tools.tpurun -np 1 --gpu -- python -m ompi_tpu_torch.examples.train [--steps 6] [--ckpt-dir DIR]

``--device cpu`` runs on the CPU (several ranks join one gloo group when
the rendezvous is exported by hand, ``-x OMPI_TPU_COORD=127.0.0.1:<port>
-x OMPI_TPU_NHOSTS=1``).  The mesh is ``mesh_shape_for(ranks, ["dp",
"tp"])`` with sp = 1; every rank writes its own w1 block into the
snapshot and rank 0 commits it and prints, last, one ``train {json}``
line: its device, the mesh and every step's loss at full precision.
"""

from __future__ import annotations

import argparse
import json
import tempfile

import numpy as np
import torch
import torch.distributed as dist

import ompi_tpu_torch
from ompi_tpu_torch.ckpt.store import SnapshotStore
from ompi_tpu_torch.models import data as data_mod
from ompi_tpu_torch.models import transformer as tfm
from ompi_tpu_torch.models.weights import from_jax_params
from ompi_tpu_torch.parallel.mesh import make_mesh, mesh_shape_for


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    ompi_tpu_torch.init()
    n = dist.get_world_size() if dist.is_initialized() else 1
    shape = mesh_shape_for(n, ["dp", "tp"])
    mesh = make_mesh({"dp": shape["dp"], "sp": 1, "tp": shape["tp"]},
                     device=args.device)
    cfg = tfm.TransformerConfig(
        vocab=512, d_model=128, n_heads=8, n_layers=2, d_ff=512,
        seq=64, attention="xla", compute_dtype="float32",
        adam_mu_dtype="bfloat16")
    batch = 4 * shape["dp"]
    lead = mesh.rank == 0

    params = from_jax_params(tfm.init_params(cfg), cfg, device=mesh.device,
                             train=True, mesh=mesh)
    step, init_opt = tfm.make_train_step(cfg, mesh, lr=3e-3)
    opt_state = init_opt(params)

    corpus = (np.arange(32_768) * 2654435761 % cfg.vocab).astype(np.int32)
    src = data_mod.ArraySource(corpus, seed=0)
    stream = data_mod.train_stream(src, mesh, batch, cfg.seq)

    base = args.ckpt_dir or (tempfile.mkdtemp() if lead else None)
    base = mesh.all_gather_object(base)[0]    # rank 0's directory
    store = SnapshotStore(base, job="demo")
    half = args.steps // 2
    losses = []
    for i in range(args.steps):
        params, opt_state, loss = step(params, opt_state, next(stream))
        losses.append(float(loss))
        if lead:
            print(f"step {i}: loss {losses[-1]:.4f}")
        if i + 1 == half:
            store.write_rank(0, mesh.rank, {
                "w1": params["w1"].detach().cpu().numpy(),
                "step": np.int64(i + 1)})
            mesh.host_barrier()
            if lead:
                store.commit(0, nranks=n)
                print(f"checkpoint at step {i + 1} -> "
                      f"{store.snapshot_dir(0)}")
    stream.close()

    # resume: the (seed, step) contract reproduces the stream exactly
    resumed = data_mod.train_stream(src, mesh, batch, cfg.seq,
                                    start_step=half)
    live = data_mod.train_stream(src, mesh, batch, cfg.seq)
    for _ in range(half + 1):     # batches 0..half; keep batch[half]
        ref = next(live)
    if not torch.equal(next(resumed), ref):
        raise RuntimeError("resume: the batch stream differs from the "
                           "live stream at the checkpointed step")
    resumed.close()
    live.close()
    if lead:
        print("resume: batch stream reproduced from checkpointed step — ok")
        print("train " + json.dumps({"device": str(mesh.device),
                                     "mesh": mesh.shape, "losses": losses}),
              flush=True)
    ompi_tpu_torch.finalize()
    return losses


if __name__ == "__main__":
    main()
