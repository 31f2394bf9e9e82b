"""The port's standing DVM (``runtime/dvm.py``, ``tpurun --dvm-*``), held
against the JAX package's.

The cases of ``tests/runtime/test_dvm.py`` run the JAX package's own
bodies on the port through ``tests/torch_mirror.py`` (the reference's
bytecode, every assertion kept; its ``tpurun`` helpers and its rank
programs name the port's package): warm submissions on the same
daemons, ``--dvm-ps`` during and after a job, the ``/metrics`` and
``/status`` scrape of a live tenant, exit codes, ``--mca`` shipped to
the ranks, the missing-pool error and an mpi4py-spelled script.  The
respawn case is copied with the port's ``RESPAWN_APP`` (the reference's
is a module string the mirror cannot rewrite); the clean case was
mirrored with the daemon tree (``tests/test_torch_plm.py``).

The port's own cases: the HNP and the orteds of a host pool import no
torch; a ``--gpu`` pool's tenants (the card count monkeypatched) get
the hosts' cards and one rendezvous per tenant, first lives only; the
JAX package's client speaks to the port's pool over the same line-JSON
protocol and reads the same keys; ``--dvm-stop`` removes the uri files
and ends a tenant whose rank is stopped.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import pathlib
import signal
import subprocess
import sys
import threading
import time

import pytest

import tests.runtime.test_dvm as ref_dvm
from ompi_tpu_torch.core.config import var_registry as pvars
from tests.test_torch_errmgr import RESPAWN_APP
from tests.torch_mirror import mirror

ROOT = pathlib.Path(__file__).resolve().parents[1]
TPURUN = [sys.executable, "-m", "ompi_tpu_torch.tools.tpurun"]


def _port(fn):
    return mirror(fn, True, [])


def tpurun(*args, timeout=120, env_extra=None):
    env = dict(os.environ)
    env.pop("OMPI_TPU_RANK", None)
    env.update(env_extra or {})
    return subprocess.run(TPURUN + list(args), capture_output=True,
                          text=True, timeout=timeout, env=env, cwd=ROOT)


@contextlib.contextmanager
def standing_vm(tmp_path, *extra_args):
    """The reference's ``_standing_vm`` on the port (2 hosts, 4 slots)."""
    with _port(ref_dvm._standing_vm)(tmp_path, *extra_args) as uri:
        yield uri


@pytest.fixture
def dvm(tmp_path):
    with standing_vm(tmp_path) as uri:
        yield uri


# -- tests/runtime/test_dvm.py, on the port ------------------------------------

@pytest.mark.parametrize("name", [
    "test_two_jobs_one_vm_second_faster",
    "test_dvm_ps_shows_daemons_and_history",
    "test_dvm_ps_live_job",
    "test_dvm_propagates_nonzero_exit",
    "test_dvm_submit_ships_mca_env",
    "test_dvm_runs_mpi4py_facade_script"])
def test_dvm_case_on_the_port(name, tmp_path):
    import inspect

    fn = _port(getattr(ref_dvm, name))
    args = {"dvm": None, "tmp_path": tmp_path}
    params = list(inspect.signature(fn).parameters)
    with standing_vm(tmp_path) as uri:
        args["dvm"] = uri
        fn(*[args[p] for p in params])


@pytest.mark.parametrize("name", ["test_dvm_metrics_scrape_end_to_end",
                                  "test_no_dvm_running_clear_error"])
def test_dvm_case_with_its_own_pool(name, tmp_path):
    _port(getattr(ref_dvm, name))(tmp_path)


def test_dvm_respawn_recovers_rank(tmp_path):
    """``test_dvm_respawn_recovers_rank`` with the port's RESPAWN_APP:
    errmgr/respawn through the STANDING VM — a rank dies mid-job, the
    daemon revives it from its snapshot, p2p heals, the job exits 0."""
    with standing_vm(tmp_path, "--mca", "errmgr", "respawn") as uri:
        r = tpurun("--dvm-submit", "-np", "3", "--dvm-uri", uri, "--",
                   sys.executable, "-c", RESPAWN_APP,
                   env_extra={"CKPT_DIR": str(tmp_path)})
    out = r.stdout + r.stderr
    assert r.returncode == 0, out[-2000:]
    assert "rank 1 resumed at step 3" in out
    assert "rank 1 got rndv payload" in out


# -- the port's own ------------------------------------------------------------

def test_dvm_reports_the_first_failure_not_a_killed_rank(dvm):
    """Rank 1 exits 3 at once; the abort errmgr then kills rank 0 (exit
    -15).  The tenant's code is the first failure's, 3, as on the
    launcher's and the plm's paths, not the first non-zero code in rank
    order (143)."""
    prog = ("import os, sys, time\n"
            "if os.environ['OMPI_TPU_RANK'] == '1':\n"
            "    sys.exit(3)\n"
            "time.sleep(60)\n")
    r = tpurun("--dvm-submit", "-np", "2", "--dvm-uri", dvm, "--",
               sys.executable, "-c", prog)
    assert r.returncode == 3, (r.returncode, r.stderr[-2000:])


def test_host_pool_hnp_and_orteds_import_no_torch(dvm):
    """A tenant of a host pool: its rank, its orted (the rank's parent)
    and the pool's HNP (the orted's parent, ``tpurun --dvm-start``) have
    loaded no torch; the tenant carries the pool's control address."""
    prog = (
        "import os, sys\n"
        "def parent(pid):\n"
        "    with open(f'/proc/{pid}/stat') as f:\n"
        "        return int(f.read().rsplit(')', 1)[1].split()[1])\n"
        "def has_torch(pid):\n"
        "    with open(f'/proc/{pid}/maps') as f:\n"
        "        return any('/torch/' in ln or 'libtorch' in ln for ln in f)\n"
        "orted = os.getppid()\n"
        "hnp = parent(orted)\n"
        "with open(f'/proc/{orted}/cmdline') as f:\n"
        "    assert 'ompi_tpu_torch.runtime.orted' in f.read()\n"
        "with open(f'/proc/{hnp}/cmdline') as f:\n"
        "    assert '--dvm-start' in f.read()\n"
        "import ompi_tpu_torch\n"
        "comm = ompi_tpu_torch.init()\n"
        "print('TORCH', comm.rank, 'torch' in sys.modules, has_torch(orted),"
        " has_torch(hnp), bool(os.environ.get('OMPI_TPU_DVM_URI')),"
        " flush=True)\n"
        "ompi_tpu_torch.finalize()\n")
    r = tpurun("--dvm-submit", "-np", "2", "--dvm-uri", dvm, "--",
               sys.executable, "-c", prog)
    assert r.returncode == 0, r.stderr
    rows = sorted(ln.split("TORCH ", 1)[1] for ln in r.stdout.splitlines()
                  if "TORCH " in ln)
    assert rows == ["0 False False False True",
                    "1 False False False True"], r.stdout


@pytest.fixture
def two_card_pool(monkeypatch, tmp_path):
    """An in-process ``--gpu`` pool of four simulated hosts × 1 slot over
    four cards (the count monkeypatched, as ``test_torch_plm.py`` does):
    each host owns one card, and the gang scheduler places a 2-rank
    tenant over two hosts.  Under respawn, so a revived life shows."""
    import torch

    import ompi_tpu_torch.runtime.ras  # noqa: F401 — registers the vars
    from ompi_tpu_torch.runtime.dvm import DvmHnp

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    values = {"ras_": "simulator", "ras_sim_num_nodes": 4,
              "ras_sim_slots_per_node": 1, "errmgr_": "respawn"}
    saved = {name: pvars.get(name) for name in values}
    for name, value in values.items():
        pvars.set(name, value)
    hnp = DvmHnp(plm_name="sim", want_gpu=True,
                 uri_path=str(tmp_path / "gpu.uri"))
    try:
        hnp.start(np_slots=4)
        yield hnp
    finally:
        hnp.shutdown()
        for name, value in saved.items():
            pvars.set(name, value)


_GPU_ENV_PROG = (
    "import os, json, sys\n"
    "e = os.environ\n"
    "life = int(e.get('OMPI_TPU_RESTART') or 0)\n"
    "print('GPUENV ' + json.dumps({k: e.get(k) for k in ("
    "'OMPI_TPU_RANK', 'OMPI_TPU_JOBID', 'OMPI_TPU_CHIP', "
    "'OMPI_TPU_FAKE_HOST', 'OMPI_TPU_COORD', 'OMPI_TPU_NHOSTS', "
    "'OMPI_TPU_RESTART')}), flush=True)\n"
    "import time; time.sleep(1.0)\n"
    "if e['OMPI_TPU_RANK'] == '1' and not life and sys.argv[1] == 'a':\n"
    "    os._exit(3)\n")


def test_gpu_pool_tenants_cards_and_rendezvous(two_card_pool):
    """Two 2-rank tenants submitted at once to a ``--gpu`` pool: each
    spans two simulated hosts (one rank a host, the host's card), each
    tenant's first lives share one rendezvous and the two tenants' differ;
    tenant a's rank 1 dies, and its revived life keeps its host and card
    and gets no rendezvous."""
    from ompi_tpu_torch.runtime import dvm

    rows: dict = {"a": [], "b": []}
    rcs = {}

    def submit(tag):
        def sink(rank, stream, text):
            for ln in text.splitlines():
                if ln.startswith("GPUENV "):
                    rows[tag].append(json.loads(ln[7:]))

        rcs[tag] = dvm.submit([sys.executable, "-c", _GPU_ENV_PROG, tag],
                              np_=2, uri=two_card_pool.uri_path, sink=sink)

    ts = [threading.Thread(target=submit, args=(t,)) for t in ("a", "b")]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert rcs == {"a": 0, "b": 0}, (rcs, rows)
    firsts = {}
    for tag in ("a", "b"):
        first = {int(r["OMPI_TPU_RANK"]): r for r in rows[tag]
                 if not r["OMPI_TPU_RESTART"]}
        assert sorted(first) == [0, 1], rows[tag]
        assert len({r["OMPI_TPU_FAKE_HOST"] for r in first.values()}) == 2
        for r in first.values():
            assert r["OMPI_TPU_CHIP"] == r["OMPI_TPU_FAKE_HOST"][-1]
            assert r["OMPI_TPU_NHOSTS"] == "2"
            assert r["OMPI_TPU_COORD"] == first[0]["OMPI_TPU_COORD"]
            assert r["OMPI_TPU_COORD"].startswith("127.0.0.1:")
        firsts[tag] = first
    hosts = [r["OMPI_TPU_FAKE_HOST"] for f in firsts.values()
             for r in f.values()]
    assert sorted(hosts) == ["sim000", "sim001", "sim002", "sim003"]
    assert firsts["a"][0]["OMPI_TPU_COORD"] != firsts["b"][0]["OMPI_TPU_COORD"]
    assert firsts["a"][0]["OMPI_TPU_JOBID"] != firsts["b"][0]["OMPI_TPU_JOBID"]
    (revived,) = [r for r in rows["a"] if r["OMPI_TPU_RESTART"]]
    assert revived["OMPI_TPU_RANK"] == "1"
    assert revived["OMPI_TPU_FAKE_HOST"] == firsts["a"][1]["OMPI_TPU_FAKE_HOST"]
    assert revived["OMPI_TPU_CHIP"] == firsts["a"][1]["OMPI_TPU_CHIP"]
    assert revived["OMPI_TPU_COORD"] is None
    assert revived["OMPI_TPU_NHOSTS"] is None
    assert not [r for r in rows["b"] if r["OMPI_TPU_RESTART"]]


def test_revive_elsewhere_binds_the_new_hosts_card(two_card_pool):
    """Remediation's rung 2 moves a wedged rank to another host: the
    proc's node, its card and the slot accounting move together (the
    reap itself is stubbed out)."""
    from ompi_tpu_torch.runtime import dvm as dvm_mod
    from ompi_tpu_torch.runtime.job import AppContext, Job, Proc

    hnp = two_card_pool
    a, b = hnp.vm_job.nodes[:2]
    assert (a.chips, b.chips) == ([0], [1])
    job = Job([AppContext(argv=["x"], np=1)])
    job.procs = [Proc(rank=0, node=a, local_rank=0)]
    job.procs[0].chip = 0
    a.slots_inuse = 1
    sub = dvm_mod._Submission(job, ["x"], 1, io.StringIO())
    sub.placed = [(a, 1)]
    reaped = []
    hnp._reap_reported = lambda j, r, why: reaped.append((j.jobid, r))
    try:
        hnp._revive_elsewhere(sub, 0, "test")
        proc = job.procs[0]
        assert proc.node is b and proc.chip == 1
        assert (a.slots_inuse, b.slots_inuse) == (0, 1)
        assert sub.placed == [(b, 1)]
        assert reaped == [(job.jobid, 0)]
    finally:
        a.slots_inuse = b.slots_inuse = 0


def test_jax_client_speaks_to_the_port_pool(dvm):
    """The control channel is the JAX package's line-JSON protocol: its
    client runs a job on the port's pool, reads the same verdict and
    exit keys, and its ``ps`` reads the reference's table keys."""
    from ompi_tpu.runtime import dvm as jdvm
    from ompi_tpu_torch.runtime import dvm as pdvm

    verdicts, lines = [], []
    rc = jdvm.submit([sys.executable, "-c", "print('hi from the port')"],
                     np_=2, uri=dvm, on_verdict=verdicts.append,
                     sink=lambda r, s, t: lines.append((r, s, t)))
    assert rc == 0
    assert set(verdicts[0]) == {"verdict", "jobid", "queue_depth"}
    assert verdicts[0]["verdict"] == "queued"
    assert sorted(lines) == [(0, "out", "hi from the port\n"),
                             (1, "out", "hi from the port\n")]
    for client in (jdvm, pdvm):
        table = client.ps(dvm)
        assert set(table) == {"daemons", "current_job", "jobs",
                              "queue_depth", "history"}
        assert set(table["history"][-1]) == {"jobid", "argv", "np", "rc",
                                             "finished"}
        assert set(table["daemons"][0]) == {"vpid", "host", "slots",
                                            "slots_inuse", "chips", "pid"}
    with pytest.raises(RuntimeError, match="no running job"):
        jdvm.shrink(999, 0, uri=dvm)
    # a raw request the reference does not know gets its error reply
    import socket

    host, port = open(dvm).read().strip().rsplit(":", 1)
    with socket.create_connection((host, int(port)), timeout=10) as s:
        s.sendall(b'{"cmd": "nope"}\n')
        reply = json.loads(s.makefile().readline())
    assert reply == {"error": "unknown cmd 'nope'"}


def test_port_client_against_a_rejecting_pool(dvm):
    """The port's client raises ``DvmRejected`` with the reference's
    verdict keys for a job that can never fit."""
    from ompi_tpu_torch.runtime import dvm as pdvm

    with pytest.raises(pdvm.DvmRejected) as e:
        pdvm.submit([sys.executable, "-c", "pass"], np_=99, uri=dvm)
    assert set(e.value.verdict) == {"verdict", "reason"}
    assert "can never fit" in e.value.verdict["reason"]


def test_dvm_stop_removes_uri_files_and_ends_a_stopped_tenant(tmp_path):
    """``--dvm-stop`` with a tenant running one SIGSTOPped rank: the
    pool's HNP, its orteds and both ranks are gone, and so are the uri
    file and its ``.metrics`` sidecar."""
    uri = str(tmp_path / "stop.uri")
    env = dict(os.environ)
    env.pop("OMPI_TPU_RANK", None)
    server = subprocess.Popen(
        TPURUN + ["--dvm-start", "--hosts", "2", "--slots", "4",
                  "--metrics-port", "0", "--dvm-uri", uri],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=ROOT)
    tenant = None
    try:
        deadline = time.monotonic() + 60
        while not os.path.exists(uri):
            assert server.poll() is None, server.stderr.read()
            assert time.monotonic() < deadline, "dvm uri never appeared"
            time.sleep(0.1)
        prog = ("import os, signal, time\n"
                "print('PID', os.environ['OMPI_TPU_RANK'], os.getpid(),"
                " os.getppid(), flush=True)\n"
                "if os.environ['OMPI_TPU_RANK'] == '1':\n"
                "    os.kill(os.getpid(), signal.SIGSTOP)\n"
                "time.sleep(120)\n")
        tenant = subprocess.Popen(
            TPURUN + ["--dvm-submit", "-np", "2", "--dvm-uri", uri, "--",
                      sys.executable, "-c", prog],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=ROOT)
        pids = {}
        for line in tenant.stdout:
            if "PID " in line:
                rank, pid, orted = line.split("PID ", 1)[1].split()
                pids[int(rank)] = (int(pid), int(orted))
            if len(pids) == 2:
                break
        time.sleep(0.5)
        with open(f"/proc/{pids[1][0]}/stat") as f:
            assert f.read().rsplit(")", 1)[1].split()[0] == "T"
        r = tpurun("--dvm-stop", "--dvm-uri", uri, timeout=60)
        assert r.returncode == 0, r.stderr
        assert server.wait(timeout=60) == 0
        tenant.wait(timeout=60)
        assert not os.path.exists(uri)
        assert not os.path.exists(uri + ".metrics")
        procs = {pid for pair in pids.values() for pid in pair}
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            left = [p for p in procs if os.path.exists(f"/proc/{p}")
                    and open(f"/proc/{p}/stat").read().rsplit(")", 1)[1]
                    .split()[0] != "Z"]
            if not left:
                break
            time.sleep(0.1)
        assert not left, left
    finally:
        for p in (tenant, server):
            if p is not None and p.poll() is None:
                p.send_signal(signal.SIGKILL)
                p.wait(timeout=10)
