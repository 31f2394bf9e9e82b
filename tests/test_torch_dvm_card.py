"""``--gpu`` tenants of a standing pool (``tpurun --dvm-start --plm sim
--hosts 2 --slots 4 --gpu``), at a small size: (b1) two 2-rank tenants
submitted at once, each on one simulated host and card 0 with its own
rendezvous and process group of 2, the forward kernel against its plain
version, and neither the pool's HNP nor an orted on the card; (b2) a
tenant whose rank 1 freezes in its 3rd host collective while it holds
its CUDA context: the pool's watchdog names it, the remediation actor
SIGCONTs it, it runs the kernel again and the tenant exits 0; and
``--dvm-stop`` with a ``--gpu`` tenant running one SIGSTOPped rank:
nothing of the pool or the tenant is left alive or on the card.  These
need a card and skip without one; the file imports no JAX.  Run on the
card with ``python -m pytest -m gpu tests/test_torch_dvm_card.py``.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import threading
import time
import urllib.request

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
TPURUN = [sys.executable, "-m", "ompi_tpu_torch.tools.tpurun"]
POOL = ["--plm", "sim", "--hosts", "2", "--slots", "4", "--gpu",
        "--metrics-port", "0", "--mca", "trace_metrics_push_period", "0.5",
        "--mca", "coll_stuck_timeout", "2"]

PROG = r"""
import json, os, signal, sys, time
import numpy as np
import torch
import ompi_tpu_torch
import importlib
fa = importlib.import_module("ompi_tpu_torch.ops.flash_attention")
from ompi_tpu_torch.parallel import multihost
from ompi_tpu_torch.testing import faultinject

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

mode = sys.argv[1]
e = os.environ
comm = ompi_tpu_torch.init()
row = {"rank": comm.rank, "pid": os.getpid(), "jobid": e["OMPI_TPU_JOBID"],
       "chip": e.get("OMPI_TPU_CHIP"), "coord": e.get("OMPI_TPU_COORD"),
       "host": e["OMPI_TPU_FAKE_HOST"], "grouped": multihost.is_initialized(),
       "device": torch.cuda.current_device(), "flash": flash()}
if row["grouped"]:
    import torch.distributed as dist
    row["group"] = [dist.get_rank(), dist.get_world_size()]
if mode == "stall":
    for step in range(6):
        faultinject.step()
        comm.allreduce(np.full(8, float(comm.rank + step)))
    row["flash_after"] = flash()
elif mode == "stop":
    with open(sys.argv[2] + str(comm.rank), "w") as f:
        json.dump(row, f)
    if comm.rank == 1:
        os.kill(os.getpid(), signal.SIGSTOP)
    time.sleep(120)
print("ROW " + json.dumps(row), flush=True)
ompi_tpu_torch.finalize()
"""


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _on_card() -> list:
    """The compute processes nvidia-smi lists (in a container its pids
    need not be this namespace's, so the tests compare counts; this
    process holds no CUDA context)."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,"
                          "used_memory", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def _alive(pids) -> list:
    left = []
    for pid in pids:
        try:
            with open(f"/proc/{pid}/stat") as f:
                if f.read().rsplit(")", 1)[1].split()[0] != "Z":
                    left.append(pid)
        except OSError:
            pass
    return left


class _Pool:
    def __init__(self, tmp: pathlib.Path) -> None:
        self.uri = str(tmp / "gpu.uri")
        self.proc = subprocess.Popen(
            TPURUN + ["--dvm-start", *POOL, "--dvm-uri", self.uri],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=ROOT)
        deadline = time.monotonic() + 90
        while not os.path.exists(self.uri):
            assert self.proc.poll() is None, self.proc.stderr.read()
            assert time.monotonic() < deadline, "the pool never came up"
            time.sleep(0.1)
        with open(self.uri + ".metrics") as f:
            self.http = f.read().strip()
        ps = subprocess.run(TPURUN + ["--dvm-ps", "--dvm-uri", self.uri],
                            capture_output=True, text=True, timeout=60,
                            cwd=ROOT)
        self.pids = [self.proc.pid] + [d["pid"] for d in
                                       json.loads(ps.stdout)["daemons"]]

    def submit(self, *args, mca=(), timeout=240):
        return subprocess.run(
            TPURUN + ["--dvm-submit", "-np", "2", "--dvm-uri", self.uri,
                      *mca, "--", sys.executable, "-c", PROG, *args],
            capture_output=True, text=True, timeout=timeout, cwd=ROOT)

    def stop(self) -> None:
        subprocess.run(TPURUN + ["--dvm-stop", "--dvm-uri", self.uri],
                       capture_output=True, timeout=60, cwd=ROOT)
        try:
            self.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=10)


def _rows(r) -> dict:
    return {x["rank"]: x for x in (
        json.loads(ln.split("ROW ", 1)[1]) for ln in r.stdout.splitlines()
        if "ROW " in ln)}


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    _card()
    p = _Pool(tmp_path_factory.mktemp("dvm_card"))
    yield p
    p.stop()


@pytest.mark.gpu
def test_two_gpu_tenants_at_once(pool):
    assert _on_card() == [], "the pool holds a CUDA context"
    res = {}
    ts = [threading.Thread(target=lambda t=t: res.__setitem__(
        t, pool.submit("b1"))) for t in ("x", "y")]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    rows = {}
    for tag, r in res.items():
        assert r.returncode == 0, r.stderr[-3000:]
        rows[tag] = _rows(r)
        assert sorted(rows[tag]) == [0, 1]
        for x in rows[tag].values():
            assert x["chip"] == "0" and x["device"] == 0 and x["grouped"]
            assert x["flash"] == [True, 1], x
            assert x["group"] == [x["rank"], 2]
        assert rows[tag][0]["coord"] == rows[tag][1]["coord"] is not None
        assert rows[tag][0]["host"] == rows[tag][1]["host"]
    assert rows["x"][0]["coord"] != rows["y"][0]["coord"]
    assert rows["x"][0]["host"] != rows["y"][0]["host"]


@pytest.mark.gpu
def test_a_stalled_gpu_rank_is_probed_and_recovers(pool):
    r = pool.submit("stall", mca=("--mca", "faultinject_plan",
                                  "rank=1:stall@coll=3",
                                  "--mca", "faultinject_seed", "0"))
    assert r.returncode == 0, r.stderr[-3000:]
    rows = _rows(r)
    assert sorted(rows) == [0, 1]
    for x in rows.values():
        assert x["flash"] == [True, 1] and x["flash_after"] == [True, 1], x
    jobid = int(rows[1]["jobid"])
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        with urllib.request.urlopen(pool.http + "/status", timeout=10) as f:
            doc = json.load(f)
        job = {j["jobid"]: j for j in doc["jobs"]}.get(jobid, {})
        events = job.get("ft_events", [])
        acts = {e["info"].get("action"): e for e in events
                if e["kind"] == "remediate"}
        if "recovered" in acts:
            break
        time.sleep(0.5)
    assert any(e["kind"] == "doctor" and e["rank"] == 1
               and e["info"].get("verdict") == "straggler" for e in events)
    assert acts["sigcont"]["rank"] == 1 and "recovered" in acts, events


@pytest.mark.gpu
def test_dvm_stop_ends_a_stopped_gpu_tenant(tmp_path):
    _card()
    p = _Pool(tmp_path)
    marker = str(tmp_path / "up")
    tenant = subprocess.Popen(
        TPURUN + ["--dvm-submit", "-np", "2", "--dvm-uri", p.uri, "--",
                  sys.executable, "-c", PROG, "stop", marker],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)
    try:
        deadline = time.monotonic() + 180
        while not all(os.path.exists(marker + str(k)) for k in (0, 1)):
            assert time.monotonic() < deadline and tenant.poll() is None
            time.sleep(0.2)
        time.sleep(1.0)
        rows = {k: json.load(open(marker + str(k))) for k in (0, 1)}
        ranks = [x["pid"] for x in rows.values()]
        with open(f"/proc/{rows[1]['pid']}/stat") as f:
            assert f.read().rsplit(")", 1)[1].split()[0] == "T"
        assert len(_on_card()) == 2, _on_card()
    finally:
        p.stop()
        tenant.wait(timeout=60)
    assert not os.path.exists(p.uri)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        left = _alive(ranks + p.pids) + _on_card()
        if not left:
            break
        time.sleep(0.2)
    assert not left, left
