"""KV-cache greedy generation on a mesh of the job's ranks
(``models/decode.py``; the port's copy of the repo's
``examples/generate.py``, printing the same lines).

Prefill through the training backbone, then cached single-token steps:
the batch is split over dp, the heads (and the KV cache) over tp, with
``mesh_shape_for(ranks, ["dp", "tp"])`` over the launched ranks.

Run:  python -m ompi_tpu_torch.tools.tpurun -np 1 --gpu -- python -m ompi_tpu_torch.examples.generate

``--device cpu`` runs on the CPU (several ranks join one gloo group when
the rendezvous is exported by hand, ``-x OMPI_TPU_COORD=127.0.0.1:<port>
-x OMPI_TPU_NHOSTS=1``).  The rank at dp 0, tp 0 prints the mesh, the
global prompt and output shapes and the first two generated rows.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch.distributed as dist

import ompi_tpu_torch
from ompi_tpu_torch.models import transformer as tfm
from ompi_tpu_torch.models.decode import make_decoder
from ompi_tpu_torch.models.weights import from_jax_params
from ompi_tpu_torch.parallel.mesh import local_block, make_mesh, mesh_shape_for


def main(argv=None) -> np.ndarray:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    ompi_tpu_torch.init()
    n = dist.get_world_size() if dist.is_initialized() else 1
    shape = mesh_shape_for(n, ["dp", "tp"])
    mesh = make_mesh({"dp": shape["dp"], "sp": 1, "tp": shape["tp"]},
                     device=args.device)
    cfg = tfm.TransformerConfig(
        vocab=512, d_model=128, n_heads=8, n_layers=2, d_ff=512,
        seq=64, attention="xla", compute_dtype="float32")
    params = from_jax_params(tfm.init_params(cfg), cfg, device=mesh.device,
                             mesh=mesh)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab,
                          size=(2 * shape["dp"], 8)).astype(np.int32)
    dec = make_decoder(cfg, mesh, max_new=12)
    out = dec(params, local_block(prompt, mesh, ("dp",))).cpu().numpy()
    if mesh.rank == 0:
        print(f"mesh {dict(mesh.shape)}; prompt {prompt.shape} -> "
              f"{(prompt.shape[0], out.shape[1])}")
        for row in out[:2]:
            print("  ", row.tolist())
    ompi_tpu_torch.finalize()
    return out


if __name__ == "__main__":
    main()
