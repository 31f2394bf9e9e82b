"""The port's checkpoint stores and resume on the card (``gpu``-marked;
skipped without CUDA).  This file imports no JAX, so it runs on a machine
without it: ``python -m pytest -m gpu tests/test_torch_ckpt_card.py``.

- bf16, float8_e4m3fn and f32 tensors on the card round-trip through
  ``SnapshotStore`` bit for bit, and come back as CPU tensors;
- the small config of tests/ckpt/test_full_stack_resume.py (bf16 params
  with an f32 master, bf16 Adam moments, 2-microbatch accumulation) on
  the card, snapshotted after 3 steps through each store
  (``SnapshotStore``, ``DcpStore``), resumes for 2 steps with losses and
  every parameter bit for bit equal to the uninterrupted run.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ompi_tpu_torch.ckpt import DcpStore, SnapshotStore
from ompi_tpu_torch.models import transformer as T
from ompi_tpu_torch.models.weights import (from_jax_params, from_train_state,
                                           train_state)
from ompi_tpu_torch.parallel.mesh import make_mesh

FULL = dict(vocab=128, d_model=64, n_heads=4, n_layers=2, d_ff=128, seq=32,
            attention="flash", compute_dtype="float32",
            param_dtype="bfloat16", adam_mu_dtype="bfloat16", grad_accum=2)
BATCH, SNAP_AT, MORE = 4, 3, 2


def _toks(n=SNAP_AT + MORE, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, FULL["vocab"], size=(BATCH, FULL["seq"]))
            .astype(np.int32) for _ in range(n)]


@pytest.mark.gpu
def test_store_roundtrip_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    st = SnapshotStore(str(tmp_path))
    state = {"bf": torch.randn(64, device="cuda").to(torch.bfloat16),
             "f8": torch.randn(64, device="cuda").to(torch.float8_e4m3fn),
             "w": torch.randn(8, 8, device="cuda")}
    st.write_rank(0, 0, state)
    st.commit(0, nranks=1)
    out = st.load_rank(0, 0)
    assert isinstance(out["w"], np.ndarray)
    for k, v in state.items():
        t = torch.as_tensor(out[k])
        assert t.device.type == "cpu"
        assert torch.equal(t.cuda().view(torch.uint8),
                           v.view(torch.uint8)), k


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["npz", "dcp"])
def test_resume_on_the_card_is_bitwise(tmp_path, kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = T.TransformerConfig(**FULL)
    params_np = T.init_params(cfg, seed=5)
    mesh = make_mesh({"dp": 1, "sp": 1, "tp": 1}, device="cuda")
    step, init = T.make_train_step(cfg, mesh, lr=1e-2)
    p = from_jax_params(params_np, cfg, "cuda", train=True)
    s = init(p)
    toks = _toks()
    for t in toks[:SNAP_AT]:
        p, s, _ = step(p, s, t)
    snap = train_state(p, s, cfg)
    if kind == "npz":
        st = SnapshotStore(str(tmp_path))
        st.write_rank(0, 0, snap)
        st.commit(0, nranks=1)
        blobs = st.load_rank(0, 0)
    else:
        st = DcpStore(str(tmp_path))
        st.save(0, snap)
        blobs = st.restore(0)
    ref = [step(p, s, t)[2].item() for t in toks[SNAP_AT:]]
    p2, s2 = from_train_state(blobs, cfg, "cuda")
    got = [step(p2, s2, t)[2].item() for t in toks[SNAP_AT:]]
    assert got == ref
    for k in p:
        assert torch.equal(p[k], p2[k]), k
