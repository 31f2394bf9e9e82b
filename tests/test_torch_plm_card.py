"""``--gpu`` ranks that an orted launched on a simulated host
(``tpurun --plm sim --hosts 2 -np 2 --gpu``, both ranks on card 0), at a
small size: (b1) one process group of 2 at the plm's rendezvous, the
forward kernel against its plain version, the device route refusing the
shared card and the facade's ``Allreduce`` of a CUDA tensor into numpy
over tcp; (b2) under respawn, rank 1's first life SIGKILLs itself and
its orted revives it on the same host and card with no rendezvous; (c)
a rank SIGKILLs its own orted: the job fails and no rank outlives it.
These need a card and skip without one; the file imports no JAX.  Run
on the card with ``python -m pytest -m gpu tests/test_torch_plm_card.py``.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import time

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
SIM = ["--plm", "sim", "--hosts", "2", "-np", "2", "--gpu"]

PRELUDE = r"""
import json, os, signal, time
import numpy as np
import torch
import ompi_tpu_torch
import importlib
fa = importlib.import_module("ompi_tpu_torch.ops.flash_attention")
from ompi_tpu_torch.parallel import multihost

def flash():
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn((2, 256, 2, 128), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    before = fa.launch_count
    o, lse = fa.flash_attention_lse(q, k, v, causal=True)
    ro, rlse = fa.flash_attention_lse_reference(q, k, v, causal=True)
    return (bool(torch.allclose(o.float(), ro.float(), atol=3e-2, rtol=3e-2)
                 and torch.allclose(lse, rlse, atol=3e-2, rtol=3e-2)),
            fa.launch_count - before)

e = os.environ
life = int(e.get("OMPI_TPU_RESTART") or 0)
comm = ompi_tpu_torch.init()
row = {"rank": comm.rank, "life": life, "pid": os.getpid(),
       "chip": e.get("OMPI_TPU_CHIP"), "coord": e.get("OMPI_TPU_COORD"),
       "nhosts": e.get("OMPI_TPU_NHOSTS"), "host": e["OMPI_TPU_FAKE_HOST"],
       "grouped": multihost.is_initialized(),
       "device": torch.cuda.current_device()}
"""

B1 = PRELUDE + r"""
import torch.distributed as dist
from ompi_tpu_torch.compat import MPI
from ompi_tpu_torch.mpi.device_comm import device_world
from ompi_tpu_torch.parallel.mesh import make_mesh
row["group_size"] = dist.get_world_size()
row["flash"] = flash()
n = 1 << 20
def tensor(r):
    gen = torch.Generator(device="cuda").manual_seed(900 + r)
    return torch.randint(0, 1000, (n,), device="cuda", generator=gen).float()
mine, other = tensor(comm.rank), tensor(1 - comm.rank)
comm.bind_device(device_world(make_mesh(device="cuda")))
try:
    comm.allreduce(mine)
    row["device_error"] = None
except NotImplementedError as err:
    row["device_error"] = str(err)
row["route"] = comm.pml.endpoint.route(1 - comm.rank)
red = np.zeros(n, np.float32)
MPI.COMM_WORLD.Allreduce(mine, red)
row["bitwise"] = red.tobytes() == (mine + other).cpu().numpy().tobytes()
print("ROW " + json.dumps(row), flush=True)
ompi_tpu_torch.finalize()
"""

B2 = PRELUDE + r"""
row["flash"] = flash()
print("ROW " + json.dumps(row), flush=True)
if comm.rank == 1 and life == 0:
    os.kill(os.getpid(), signal.SIGKILL)
ompi_tpu_torch.finalize()
"""

C = PRELUDE + r"""
torch.ones(1 << 20, device="cuda").sum().item()
print("ROW " + json.dumps(row), flush=True)
if comm.rank == 1:
    time.sleep(0.5)
    os.kill(os.getppid(), signal.SIGKILL)
time.sleep(60)
"""


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _run(*args, prog, timeout=240):
    r = subprocess.run([sys.executable, "-m", "ompi_tpu_torch.tools.tpurun",
                        "--timeout", "180", *args, "--", sys.executable,
                        "-c", prog], capture_output=True, text=True,
                       timeout=timeout, cwd=ROOT)
    rows = [json.loads(ln.split("ROW ", 1)[1]) for ln in r.stdout.splitlines()
            if "ROW " in ln]
    return r, rows


def _gone(pids, within=5.0) -> list:
    deadline = time.monotonic() + within
    while True:
        left = []
        for pid in pids:
            try:
                os.kill(pid, 0)
                left.append(pid)
            except ProcessLookupError:
                pass
        if not left or time.monotonic() > deadline:
            return left
        time.sleep(0.1)


@pytest.mark.gpu
def test_daemon_launched_gpu_ranks_join_one_group():
    _card()
    r, rows = _run(*SIM, prog=B1)
    assert r.returncode == 0, r.stderr[-3000:]
    assert sorted(x["rank"] for x in rows) == [0, 1]
    assert sorted(x["host"] for x in rows) == ["sim000", "sim001"]
    for x in rows:
        assert x["chip"] == "0" and x["device"] == 0 and x["nhosts"] == "2"
        assert x["grouped"] and x["group_size"] == 2
        assert x["flash"] == [True, 1], x
        assert "share a card" in x["device_error"], x
        assert x["route"] == "tcp" and x["bitwise"], x
    assert rows[0]["coord"] == rows[1]["coord"] is not None


@pytest.mark.gpu
def test_daemon_revives_a_gpu_rank_on_its_card():
    _card()
    r, rows = _run(*SIM, "--mca", "errmgr", "respawn", prog=B2)
    assert r.returncode == 0, r.stderr[-3000:]
    lives = {(x["rank"], x["life"]): x for x in rows}
    assert sorted(lives) == [(0, 0), (1, 0), (1, 1)]
    for key, x in lives.items():
        assert x["chip"] == "0" and x["device"] == 0 and not x["grouped"]
        assert x["flash"] == [True, 1], (key, x)
        assert (x["coord"] is None) == (x["life"] > 0), (key, x)
    assert lives[(1, 1)]["host"] == lives[(1, 0)]["host"]
    assert _gone([x["pid"] for x in rows]) == []


@pytest.mark.gpu
def test_a_gpu_rank_dies_with_its_daemon():
    _card()
    r, rows = _run(*SIM, prog=C, timeout=120)
    assert r.returncode != 0
    assert "daemon" in r.stderr.lower() or "died" in r.stderr.lower()
    assert sorted(x["rank"] for x in rows) == [0, 1]
    assert _gone([x["pid"] for x in rows]) == []
