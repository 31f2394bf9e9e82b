"""Port bodies of the JAX package's test modules that are bound to JAX
itself (its lowering, ``jax.distributed``, its sharded arrays): each
asserts on the port what its reference asserts on the JAX package.

- ``tests/parallel/test_degenerate_elision.py`` reads the lowered HLO for
  collective ops.  The port has no lowering to read: on a one-rank mesh
  its model calls nothing of ``torch.distributed`` (each call counted by
  a stub), and on a 2 × 2 mesh of four gloo ranks it does.  The one-rank
  case's train step is also held by ``tests/test_torch_mesh_train.py``
  ``test_one_rank_mesh_makes_no_process_group_call``.
- ``tests/ckpt/test_zero1_ckpt.py`` snapshots ZeRO-1 state held as
  ``jax.Array`` shards.  Its port body snapshots the port's ZeRO-1 state
  (the optimizer tree 1/dp a rank) after two steps on a dp 2 × tp 2 mesh,
  restores it into fresh tensors and holds two more steps to the run
  that never stopped, bit for bit: ``tests/test_torch_ckpt.py``
  ``test_zero1_on_a_dp2_tp2_mesh_resumes_bitwise`` (the rank body
  ``resume_steps`` of ``tests/torch_ranks.py``) stands in for it.
- ``tests/runtime/test_dcn_sim.py`` joins ``jax.distributed`` across two
  simulated hosts and its child program is JAX code.  The port body
  launches four ranks on two simulated hosts of the port's launcher,
  which join one process group through ``parallel/multihost.py``; a
  ``{dcn: 2, ici: 2}`` mesh puts the ``dcn`` axis across the host
  boundary, ``--mca coll_xla_dcn_axes dcn`` must steer coll/xla's
  decision to the neighbour-shaped forms over it (and keep the fused
  forms over ``ici``), and the rs_ag and qint8 allreduces must run across
  the boundary with the reference's bounds.
"""

from __future__ import annotations

import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from ompi_tpu_torch.models import transformer as T
from ompi_tpu_torch.models.weights import from_jax_params
from ompi_tpu_torch.parallel.mesh import make_mesh
from tests.torch_ranks import RankPool

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: the reference's config, at the port's f32 attention path
FIELDS = dict(vocab=256, d_model=64, n_heads=4, n_layers=2, d_ff=128,
              seq=64, attention="gathered", ce_chunk=32,
              compute_dtype="float32")

#: the torch.distributed calls a collective of the port goes through
_PG_CALLS = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
             "all_gather", "broadcast", "send", "recv", "isend", "irecv",
             "batch_isend_irecv", "all_to_all_single", "all_to_all",
             "barrier")


def _count_pg_calls(monkeypatch) -> list:
    import torch.distributed as dist

    calls: list = []
    for name in _PG_CALLS:
        real = getattr(dist, name)

        def stub(*a, _n=name, _real=real, **k):
            calls.append(_n)
            return _real(*a, **k)

        monkeypatch.setattr(dist, name, stub)
    return calls


def _loss_and_grads(mesh, batch: int) -> float:
    cfg = T.TransformerConfig(**FIELDS)
    step, init = T.make_train_step(cfg, mesh, lr=1e-2)
    p = from_jax_params(T.init_params(cfg), cfg, "cpu", train=True)
    toks = torch.zeros((batch, cfg.seq), dtype=torch.int64)
    p, _state, loss = step(p, init(p), toks)
    return float(loss.item())


def test_one_chip_model_has_zero_collective_ops(monkeypatch):
    calls = _count_pg_calls(monkeypatch)
    mesh = make_mesh({"dp": 1, "sp": 1, "tp": 1}, device="cpu")
    assert np.isfinite(_loss_and_grads(mesh, batch=2))
    assert calls == []


def _multi_axis_calls(fields, axes):
    """Rank body: one train step of this rank's shard on a multi-axis
    mesh, counting the ``torch.distributed`` calls it makes."""
    from tests import torch_ranks as TR

    cfg, m, p = TR._model(fields, axes,
                          T.init_params(T.TransformerConfig(**fields)))
    toks = T.shard_tokens(np.zeros((4, cfg.seq), np.int32), m)
    mp = pytest.MonkeyPatch()
    try:
        calls = _count_pg_calls(mp)
        step, init = T.make_train_step(cfg, m, lr=1e-2)
        p, _state, loss = step(p, init(p), toks)
    finally:
        mp.undo()
    return float(loss.item()), len(calls)


def test_multi_axis_model_still_communicates(tmp_path):
    pool = RankPool(tmp_path)
    try:
        res = pool.run(_multi_axis_calls, fields=FIELDS,
                       axes={"dp": 2, "sp": 1, "tp": 2})
    finally:
        pool.close()
    assert all(n > 0 for _loss, n in res), res
    assert np.isfinite(res[0][0])
    assert len({loss for loss, _n in res}) == 1


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_PROG = r"""
import os
import numpy as np
import torch
import ompi_tpu_torch

comm = ompi_tpu_torch.init()
from ompi_tpu_torch.core.config import var_registry
from ompi_tpu_torch.mpi.coll.xla import XlaColl
from ompi_tpu_torch.mpi.device_comm import DeviceCommunicator
from ompi_tpu_torch.parallel.mesh import make_mesh

# 2 hosts x 2 ranks -> mesh {dcn: 2, ici: 2}; the dcn axis spans the
# simulated host boundary (one row of ranks per host)
mesh = make_mesh({'dcn': 2, 'ici': 2}, device='cpu')
assert mesh.world_size == 4
assert var_registry.get('coll_xla_dcn_axes') == 'dcn'
d = comm.rank // 2
assert os.environ['OMPI_TPU_FAKE_HOST'].endswith(str(d)), (
    os.environ['OMPI_TPU_FAKE_HOST'], comm.rank)

dcn_comm = DeviceCommunicator(mesh, ('dcn',))
ici_comm = DeviceCommunicator(mesh, ('ici',))
comp = XlaColl()
# over the DCN axis: neighbor-shaped algorithms
assert comp._decide('allreduce', None, dcn_comm, 1024) == 'rs_ag'
assert comp._decide('allgather', None, dcn_comm, 1024) == 'ring'
assert comp._decide('bcast', None, dcn_comm, 1024) == 'ring'
# over the intra-slice axis: the fused forms stay
assert comp._decide('allreduce', None, ici_comm, 1024) == 'psum'
assert comp._decide('allgather', None, ici_comm, 1024) == 'all_gather'

# the DCN-shaped allreduce runs across the boundary: each dcn row holds
# (2, 128) ones, summed over the 2 rows
y = dcn_comm.allreduce_rs_ag(torch.ones(2, 128))
assert torch.equal(y, torch.full((2, 128), 2.0)), y
print(f'rank {comm.rank}: dcn-shaped allreduce across slices ok')

# quantized allreduce over the same boundary, forced via the config var
var_registry.set('coll_xla_allreduce_algorithm', 'qint8')
assert comp._decide('allreduce', None, dcn_comm, 1 << 20) == 'qint8'
full = np.random.default_rng(0).normal(size=(8, 256)).astype(np.float32)
yq = dcn_comm.allreduce_qint8(torch.from_numpy(full[4 * d:4 * d + 4]))
want = full.reshape(2, 4, 256).sum(axis=0)
rel = np.linalg.norm(yq.numpy() - want) / np.linalg.norm(want)
assert rel < 0.02, rel
var_registry.set('coll_xla_allreduce_algorithm', '')
print(f'rank {comm.rank}: qint8 allreduce across dcn ok (rel {rel:.4f})')
ompi_tpu_torch.finalize()
"""


def test_dcn_axis_routing_across_sim_slices():
    env = dict(os.environ)
    env.pop("OMPI_TPU_RANK", None)
    r = subprocess.run(
        [sys.executable, "-m", "ompi_tpu_torch.tools.tpurun", "-np", "4",
         "--plm", "sim", "--hosts", "2", "--slots", "2",
         "-x", f"OMPI_TPU_COORD=127.0.0.1:{_free_port()}",
         "-x", "OMPI_TPU_NHOSTS=2",
         "--mca", "coll_xla_dcn_axes", "dcn", "--",
         sys.executable, "-c", _PROG],
        capture_output=True, text=True, timeout=240, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr + r.stdout
    for rank in range(4):
        assert f"rank {rank}: dcn-shaped allreduce across slices ok" \
            in r.stdout
        assert f"rank {rank}: qint8 allreduce across dcn ok" in r.stdout
