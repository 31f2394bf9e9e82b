"""The port's multi-host launch: the daemon tree (``runtime/plm.py``,
``runtime/orted.py``, ``runtime/rtc.py``, ``runtime/clean.py``, the
``simulator`` RAS and ``tpurun --plm``), held against the JAX package's.

The launched cases of ``tests/runtime/test_plm.py`` run the JAX
package's own bodies on the port through ``tests/torch_mirror.py`` (the
reference's bytecode, every assertion kept; its ``tpurun`` helper and its
rank programs name the port's package): ranks on two simulated hosts,
a collective across them, exit codes, aborts, stdin, the lifeline, the
modex.  ``test_sim_ring_example`` runs the port's ring example as a
module (the reference runs ``examples/ring.py`` by path), and the JAX
package's ``jax.distributed`` bootstrap becomes one gloo process group
of two ranks joined at a rendezvous passed with ``-x``.  The ssh cases
skip as the reference's do, on the reference's own probe.  The rtc case
of ``tests/core/test_sysinfo_notifier.py`` is copied and runs on both
packages; the
``clean`` case of ``tests/runtime/test_dvm.py`` is copied with its
monkeypatch pointed at the port's uri-file function.

The port's own cases: the HNP and the orted of a host job import no
torch; the ``--plm sim --gpu`` environment (cards with the card count
monkeypatched, the rendezvous for first lives only); ``--map-by``;
``--mca rtc_bind core``; the clock-sync prober over a mixed tree; a
rank dies with its SIGKILLed orted; ``--timeout``; and ``tpurun
--clean`` on a dead inbox.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import pathlib
import subprocess
import sys
import time

import pytest

import tests.runtime.test_plm as ref_plm
from ompi_tpu_torch.core.config import var_registry as pvars
from tests.torch_mirror import mirror

ROOT = pathlib.Path(__file__).resolve().parents[1]
TPURUN = [sys.executable, "-m", "ompi_tpu_torch.tools.tpurun"]


def tpurun(*args, timeout=120, stdin_data=None):
    env = dict(os.environ)
    env.pop("OMPI_TPU_RANK", None)
    return subprocess.run(TPURUN + list(args), capture_output=True,
                          text=True, timeout=timeout, env=env, cwd=ROOT,
                          input=stdin_data)


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tagged(out: str, tag: str) -> list:
    rows = []
    for line in out.splitlines():
        if tag + " " in line:
            rows.append(json.loads(line.split(tag + " ", 1)[1]))
    return rows


# -- tests/runtime/test_plm.py, on the port ------------------------------------

@pytest.mark.parametrize("name", [
    "test_sim_hello_two_hosts", "test_sim_cross_host_allgather",
    "test_sim_nonzero_exit_propagates", "test_sim_app_abort_kills_job",
    "test_sim_stdin_to_rank0", "test_sim_daemon_death_aborts_job",
    "test_sim_pmix_modex_across_hosts"])
def test_plm_case_on_the_port(name):
    mirror(getattr(ref_plm, name), True, [])()


def test_sim_ring_example():
    r = tpurun("-np", "4", "--plm", "sim", "--hosts", "2", "--",
               sys.executable, "-m", "ompi_tpu_torch.examples.ring")
    assert r.returncode == 0, r.stderr
    assert "Process 0 decremented value: 0" in r.stdout
    # the reference's lines, tagged by the tree's IOF as [mh,rank]
    want = [f"Process 0 sending 10 to 1, tag 201 (4 processes in ring)",
            "Process 0 sent to 1"]
    want += [f"Process 0 decremented value: {v}" for v in range(9, -1, -1)]
    want = [f"[mh,0]{x}" for x in want]
    want += [f"[mh,{r_}]Process {r_} exiting" for r_ in range(4)]
    assert sorted(ln for ln in r.stdout.splitlines() if ln) == sorted(want)


def test_sim_multihost_process_group_bootstrap():
    """The port's counterpart of ``test_sim_multihost_jax_bootstrap``: 2
    sim hosts × 1 rank join one gloo process group at the rendezvous
    given with ``-x`` (the plm exports one only under ``--gpu``), and
    each rank sees ``OMPI_TPU_NHOSTS=2`` and a distinct host."""
    prog = (
        "import os\n"
        "import torch.distributed as dist\n"
        "import ompi_tpu_torch\n"
        "from ompi_tpu_torch.parallel import multihost\n"
        "comm = ompi_tpu_torch.init()\n"
        "assert multihost.is_initialized()\n"
        "assert dist.get_world_size() == 2, dist.get_world_size()\n"
        "assert dist.get_rank() == comm.rank\n"
        "host = os.environ['OMPI_TPU_FAKE_HOST']\n"
        "hosts = comm.allgather(int(host[3:]))\n"  # 'sim000' → 0
        "assert len(set(int(h) for h in hosts)) == 2, hosts\n"
        "import torch\n"
        "t = torch.tensor([float(comm.rank + 1)])\n"
        "dist.all_reduce(t)\n"
        "print(f'rank {comm.rank}: group of {dist.get_world_size()} "
        "nhosts {os.environ[\"OMPI_TPU_NHOSTS\"]} sum {t.item():.0f}', "
        "flush=True)\n"
        "ompi_tpu_torch.finalize()\n")
    r = tpurun("-np", "2", "--plm", "sim", "--hosts", "2", "--timeout", "150",
               "-x", f"OMPI_TPU_COORD=127.0.0.1:{_free_port()}",
               "-x", "OMPI_TPU_NHOSTS=2", "--", sys.executable, "-c", prog,
               timeout=180)
    assert r.returncode == 0, r.stderr + r.stdout
    assert "rank 0: group of 2 nhosts 2 sum 3" in r.stdout
    assert "rank 1: group of 2 nhosts 2 sum 3" in r.stdout


@pytest.mark.parametrize("name", ["test_ssh_plm_localhost",
                                  "test_ssh_plm_localhost_real"])
def test_ssh_plm_on_the_port(name):
    # the reference's own probe; the bodies run only where it succeeds
    if not ref_plm._ssh_localhost_ok():
        pytest.skip("passwordless ssh to localhost unavailable")
    mirror(getattr(ref_plm, name), True, [])()


@pytest.mark.parametrize("pkg", ["ompi_tpu", "ompi_tpu_torch"])
def test_rtc_bind_child(pkg):
    """``tests/core/test_sysinfo_notifier.py::test_rtc_bind_child`` on
    each package (copied: that module's other imports have no port
    counterpart, so it cannot be mirrored whole)."""
    import importlib

    var_registry = importlib.import_module(f"{pkg}.core.config").var_registry
    bind_child = importlib.import_module(f"{pkg}.runtime.rtc").bind_child

    assert bind_child(os.getpid(), 0) is None     # default: none
    var_registry.set("rtc_bind", "core")
    allowed = sorted(os.sched_getaffinity(0))
    try:
        cpu = bind_child(os.getpid(), 1)
        if len(allowed) < 2:
            assert cpu is None            # single-cpu host: no-op
        else:
            assert cpu == allowed[1 % len(allowed)]
            assert os.sched_getaffinity(0) == {cpu}
    finally:
        # restore INSIDE finally: a failed assert must not leave the
        # whole pytest process pinned to one cpu
        os.sched_setaffinity(0, set(allowed))
        var_registry.set("rtc_bind", "none")


# -- tests/runtime/test_dvm.py::test_clean_sweeps_dead_inboxes ----------------

def test_clean_sweeps_dead_inboxes(tmp_path, monkeypatch):
    """≈ orte-clean: a dead rank's shm inbox (doorbell with no reader)
    and an unmapped old segment go; a LIVE inbox and a MAPPED segment
    stay.  Hermetic: the sweep roots and the DVM-uri probe are pinned
    into tmp_path (the real per-user uri file must never be touched)."""
    import mmap

    from ompi_tpu_torch.runtime import clean as clean_mod

    base = str(tmp_path)
    monkeypatch.setattr(clean_mod, "_dirs", lambda: [base])
    monkeypatch.setattr(clean_mod, "default_uri_path",
                        lambda: os.path.join(base, "no-such-uri"))
    dead = os.path.join(base, "otpu-shm-dead1")
    os.mkdir(dead)
    os.mkfifo(os.path.join(dead, "doorbell"))
    live = os.path.join(base, "otpu-shm-live1")
    os.mkdir(live)
    os.mkfifo(os.path.join(live, "doorbell"))
    rd = os.open(os.path.join(live, "doorbell"),
                 os.O_RDONLY | os.O_NONBLOCK)
    for inbox in (dead, live):   # past the grace a starting rank gets
        os.utime(inbox, (1, 1))
    seg = os.path.join(base, "otpu-shfp-0-deadbeef-1")
    open(seg, "wb").write(b"\0" * 8)
    os.utime(seg, (1, 1))
    mapped = os.path.join(base, "otpu-shwin-x-0-2")
    with open(mapped, "wb") as f:
        f.write(b"\0" * 4096)
    os.utime(mapped, (1, 1))
    mf = open(mapped, "r+b")
    mm = mmap.mmap(mf.fileno(), 4096)
    try:
        would = {p for p, _r in clean_mod.scan()}
        assert dead in would and seg in would
        assert live not in would and mapped not in would
        removed = clean_mod.clean()
        assert set(removed) == {dead, seg}
        assert not os.path.exists(dead) and not os.path.exists(seg)
        assert os.path.exists(live) and os.path.exists(mapped)
        # --clean-age: the big hammer takes anything old, mapped or not
        assert mapped in {p for p, _r in clean_mod.scan(age=60)}
        # a dead DVM's uri file: a local port that refuses
        uri = os.path.join(base, "no-such-uri")
        with open(uri, "w") as f:
            f.write(f"127.0.0.1:{_free_port()}\n")
        assert (uri, "DVM uri, local port refused") in clean_mod.scan()
    finally:
        mm.close()
        mf.close()
        os.close(rd)


def test_the_jax_clean_case_agrees(tmp_path, monkeypatch):
    """The same artifacts through both packages' ``scan``: the same
    verdicts, reason for reason."""
    from ompi_tpu.runtime import clean as jclean
    from ompi_tpu.runtime import dvm as jdvm
    from ompi_tpu_torch.runtime import clean as pclean

    assert pclean.default_uri_path() == jdvm.default_uri_path()
    base = str(tmp_path)
    for mod in (jclean, pclean):
        monkeypatch.setattr(mod, "_dirs", lambda: [base])
    monkeypatch.setattr(jdvm, "default_uri_path",
                        lambda: os.path.join(base, "no-such-uri"))
    monkeypatch.setattr(pclean, "default_uri_path",
                        lambda: os.path.join(base, "no-such-uri"))
    for i in range(3):
        d = os.path.join(base, f"otpu-shm-dead{i}")
        os.mkdir(d)
        os.mkfifo(os.path.join(d, "doorbell"))
    nodb = os.path.join(base, "otpu-shm-nodoorbell")
    os.mkdir(nodb)
    for i in range(3):   # past the port's grace for a starting rank
        os.utime(os.path.join(base, f"otpu-shm-dead{i}"), (1, 1))
    os.utime(nodb, (1, 1))
    for name in ("otpu-shfp-a", ".seg-b", "otpu-shwin-c", "other-d"):
        path = os.path.join(base, name)
        open(path, "wb").write(b"x")
        os.utime(path, (1, 1))
    assert sorted(pclean.scan()) == sorted(jclean.scan())
    assert sorted(pclean.scan(age=10)) == sorted(jclean.scan(age=10))
    assert len(pclean.scan()) == 6


def test_clean_spares_a_fresh_inbox(tmp_path, monkeypatch):
    """A rank makes its doorbell FIFO before it opens the read end, so
    an inbox with no reader yet may belong to a rank still starting up:
    within ``_INBOX_GRACE_S`` of its last change it is not judged, past
    it the same inbox is swept."""
    from ompi_tpu_torch.runtime import clean as clean_mod

    base = str(tmp_path)
    monkeypatch.setattr(clean_mod, "_dirs", lambda: [base])
    monkeypatch.setattr(clean_mod, "default_uri_path",
                        lambda: os.path.join(base, "no-such-uri"))
    inbox = os.path.join(base, "otpu-shm-starting")
    os.mkdir(inbox)
    os.mkfifo(os.path.join(inbox, "doorbell"))
    assert clean_mod.scan() == []
    assert clean_mod.clean() == [] and os.path.isdir(inbox)
    old = time.time() - clean_mod._INBOX_GRACE_S - 1
    os.utime(inbox, (old, old))
    assert clean_mod.scan() == [(inbox, "no doorbell reader (rank gone)")]


# -- the port's own ------------------------------------------------------------

def test_host_job_daemons_and_hnp_import_no_torch():
    """A host job through the tree: its rank, its orted (the rank's
    parent) and the HNP (the orted's parent) have loaded no torch."""
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
        "    assert 'ompi_tpu_torch.tools.tpurun' in f.read()\n"
        "import ompi_tpu_torch\n"
        "comm = ompi_tpu_torch.init()\n"
        "print('TORCH', comm.rank, os.environ['OMPI_TPU_FAKE_HOST'],\n"
        "      'torch' in sys.modules, has_torch(orted), has_torch(hnp),\n"
        "      os.environ['OMPI_TPU_ORTED_PID'] == str(orted), flush=True)\n"
        "ompi_tpu_torch.finalize()\n")
    r = tpurun("-np", "2", "--plm", "sim", "--hosts", "2", "--",
               sys.executable, "-c", prog)
    assert r.returncode == 0, r.stderr
    rows = sorted(ln.split("TORCH ", 1)[1] for ln in r.stdout.splitlines()
                  if "TORCH " in ln)
    assert rows == ["0 sim000 False False False True",
                    "1 sim001 False False False True"], r.stdout


@pytest.fixture
def sim_ras():
    """The port's registry set for two simulated hosts of three slots
    (what ``tpurun --plm sim --hosts 2 -np 5`` sets), restored after."""
    import ompi_tpu_torch.runtime.ras  # noqa: F401 — registers the vars

    values = {"ras_": "simulator", "ras_sim_num_nodes": 2,
              "ras_sim_slots_per_node": 3}
    saved = {name: pvars.get(name) for name in values}
    for name, value in values.items():
        pvars.set(name, value)
    yield
    for name, value in saved.items():
        pvars.set(name, value)


def test_sim_gpu_env_cards_and_first_life_rendezvous(monkeypatch, sim_ras):
    """``--plm sim --gpu`` with two cards (the count monkeypatched, as
    the local launcher's test does): each of the two simulated hosts
    owns one card, so sim000's three ranks bind card 0 and sim001's two
    bind card 1, and every rank of the first lives gets one rendezvous
    and OMPI_TPU_NHOSTS=2."""
    import torch

    from ompi_tpu_torch.runtime.job import AppContext, Job
    from ompi_tpu_torch.runtime.plm import MultiHostLauncher

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    prog = ("import os, json\n"
            "e = os.environ\n"
            "print('GPUENV ' + json.dumps({k: e.get(k) for k in ("
            "'OMPI_TPU_RANK', 'OMPI_TPU_LOCAL_RANK', 'OMPI_TPU_CHIP', "
            "'OMPI_TPU_FAKE_HOST', 'OMPI_TPU_COORD', 'OMPI_TPU_NHOSTS', "
            "'OMPI_TPU_RESTART')}), flush=True)\n")
    job = Job([AppContext(argv=[sys.executable, "-c", prog], np=5)])
    launcher = MultiHostLauncher(plm_name="sim", want_gpu=True,
                                 stdin_target="none")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert launcher.run(job) == 0
    rows = {int(r["OMPI_TPU_RANK"]): r for r in _tagged(buf.getvalue(),
                                                        "GPUENV")}
    assert sorted(rows) == list(range(5))
    assert [p.chip for p in job.procs] == [0, 0, 0, 1, 1]
    for rank, row in rows.items():
        host = "sim000" if rank < 3 else "sim001"
        local = rank if rank < 3 else rank - 3
        assert row["OMPI_TPU_FAKE_HOST"] == host
        assert row["OMPI_TPU_LOCAL_RANK"] == str(local)
        assert row["OMPI_TPU_CHIP"] == str(0 if rank < 3 else 1)
        assert row["OMPI_TPU_NHOSTS"] == "2"
        assert row["OMPI_TPU_COORD"] == rows[0]["OMPI_TPU_COORD"]
        assert row["OMPI_TPU_RESTART"] is None
    assert rows[0]["OMPI_TPU_COORD"].startswith("127.0.0.1:")


def test_sim_host_job_exports_no_rendezvous_and_no_card():
    r = tpurun("-np", "2", "--plm", "sim", "--hosts", "2", "--",
               sys.executable, "-c",
               "import os; print('ENV', os.environ.get('OMPI_TPU_CHIP'), "
               "os.environ.get('OMPI_TPU_COORD'), "
               "os.environ.get('OMPI_TPU_NHOSTS'))")
    assert r.returncode == 0, r.stderr
    assert r.stdout.count("ENV None None None") == 2, r.stdout


def test_revived_life_gets_no_rendezvous_through_the_tree():
    """Under respawn the orted revives rank 1 through TAG_RESPAWN on the
    same simulated host: its first life saw the rendezvous, the revived
    life (OMPI_TPU_RESTART=1) does not, and keeps its local rank."""
    prog = ("import os, sys\n"
            "e = os.environ\n"
            "life = int(e.get('OMPI_TPU_RESTART') or 0)\n"
            "print('LIFE', e['OMPI_TPU_RANK'], life, e['OMPI_TPU_FAKE_HOST'],"
            " e.get('OMPI_TPU_COORD'), e.get('OMPI_TPU_NHOSTS'), flush=True)\n"
            "if e['OMPI_TPU_RANK'] == '1' and not life:\n"
            "    os._exit(3)\n")
    r = tpurun("-np", "2", "--plm", "sim", "--hosts", "2",
               "--mca", "errmgr", "respawn",
               "-x", "OMPI_TPU_COORD=127.0.0.1:1", "-x", "OMPI_TPU_NHOSTS=2",
               "--", sys.executable, "-c", prog)
    assert r.returncode == 0, r.stderr
    lines = sorted(ln.split("LIFE ", 1)[1] for ln in r.stdout.splitlines()
                   if "LIFE " in ln)
    assert lines == ["0 0 sim000 127.0.0.1:1 2", "1 0 sim001 127.0.0.1:1 2",
                     "1 1 sim001 None None"], r.stdout


def test_map_by_bynode_and_byslot():
    prog = ("import os; print('MAP', os.environ['OMPI_TPU_RANK'], "
            "os.environ['OMPI_TPU_FAKE_HOST'], "
            "os.environ['OMPI_TPU_LOCAL_RANK'])")
    got = {}
    for policy in ("byslot", "bynode"):
        r = tpurun("-np", "4", "--plm", "sim", "--hosts", "2", "--map-by",
                   policy, "--", sys.executable, "-c", prog)
        assert r.returncode == 0, r.stderr
        got[policy] = sorted(ln.split("MAP ", 1)[1]
                             for ln in r.stdout.splitlines() if "MAP " in ln)
    assert got["byslot"] == ["0 sim000 0", "1 sim000 1", "2 sim001 0",
                             "3 sim001 1"]
    assert got["bynode"] == ["0 sim000 0", "1 sim001 0", "2 sim000 1",
                             "3 sim001 1"]


def test_rtc_bind_core_pins_each_rank_to_one_cpu():
    allowed = sorted(os.sched_getaffinity(0))
    if len(allowed) < 2:
        pytest.skip("one schedulable cpu: rtc_bind core is a no-op")
    prog = ("import os; print('CPU', os.environ['OMPI_TPU_FAKE_HOST'], "
            "sorted(os.sched_getaffinity(0)))")
    r = tpurun("-np", "4", "--plm", "sim", "--hosts", "2", "--mca",
               "rtc_bind", "core", "--", sys.executable, "-c", prog)
    assert r.returncode == 0, r.stderr
    rows = [ln.split("CPU ", 1)[1].split(" ", 1) for ln in
            r.stdout.splitlines() if "CPU " in ln]
    assert len(rows) == 4
    by_host: dict = {}
    for host, cpus in rows:
        cpus = json.loads(cpus)
        assert len(cpus) == 1 and cpus[0] in allowed
        by_host.setdefault(host, []).append(cpus[0])
    for host, cpus in by_host.items():
        assert len(set(cpus)) == 2, by_host   # distinct within a host
    # the local launcher binds its children the same way
    r = tpurun("-np", "2", "--mca", "rtc_bind", "core", "--",
               sys.executable, "-c", "import os; print('CPU', "
               "sorted(os.sched_getaffinity(0)))")
    assert r.returncode == 0, r.stderr
    assert sorted(ln.split("CPU ", 1)[1] for ln in r.stdout.splitlines()
                  if "CPU " in ln) == [f"[{allowed[0]}]", f"[{allowed[1]}]"]


@pytest.mark.parametrize("hnp_pkg", ["ompi_tpu_torch", "ompi_tpu"])
def test_clock_prober_offsets_on_one_machine(hnp_pkg):
    """The daemon-side prober against an HNP responder (the port's, or
    the JAX package's over the same wire): on one machine the measured
    offset to the root lies within rtt/2 of 0."""
    import importlib

    from ompi_tpu_torch.runtime import clocksync, rml

    hmod = importlib.import_module(f"{hnp_pkg}.runtime.rml")
    hsync = importlib.import_module(f"{hnp_pkg}.runtime.clocksync")
    hnp, daemon = hmod.RmlNode(0), rml.RmlNode(1)
    hsync.install_responder(hnp, lambda: 0)
    prober = clocksync.ClockProber(daemon, period=0.05)
    try:
        hnp.dial_children([(1, daemon.uri)])
        assert daemon.wait_parent(5.0)
        prober.start()
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and prober.est.sample_count() < 8:
            time.sleep(0.02)
        st = prober.stats()
        assert st["samples"] >= 8 and st["responder"] == 0, st
        off = prober.offset_to_root_ns()
        assert off is not None and abs(off) <= st["rtt_ns"] / 2 + 1, st
    finally:
        prober.stop()
        daemon.close()
        hnp.close()


def test_rank_dies_with_its_sigkilled_daemon(tmp_path):
    """test_sim_daemon_death_aborts_job's body with a check the
    reference lacks: the rank that SIGKILLed its orted (and its
    co-resident rank) must be gone soon after, not asleep until its
    own end — an orphan would keep its card's context."""
    pids = tmp_path / "pids"
    pids.mkdir()
    prog = ("import os, signal, time\n"
            "rank = int(os.environ['OMPI_TPU_RANK'])\n"
            f"open(os.path.join({str(pids)!r}, str(rank)), 'w')"
            ".write(str(os.getpid()))\n"
            "if rank == 3:\n"
            "    time.sleep(0.5)\n"
            "    os.kill(os.getppid(), signal.SIGKILL)\n"
            "time.sleep(60)\n")
    t0 = time.monotonic()
    r = tpurun("-np", "4", "--plm", "sim", "--hosts", "2", "--",
               sys.executable, "-c", prog, timeout=60)
    assert r.returncode != 0
    assert "died" in r.stderr.lower() or "daemon" in r.stderr.lower()
    assert time.monotonic() - t0 < 30, "the job waited for its orphans"
    deadline = time.monotonic() + 5.0
    alive = []
    while time.monotonic() < deadline:
        alive = []
        for f in pids.iterdir():
            try:
                os.kill(int(f.read_text()), 0)
                alive.append(f.name)
            except ProcessLookupError:
                pass
        if not alive:
            break
        time.sleep(0.1)
    assert sorted(f.name for f in pids.iterdir()) == ["0", "1", "2", "3"]
    assert alive == [], f"ranks {alive} outlived their job"


def test_timeout_kills_the_tree_job():
    t0 = time.monotonic()
    r = tpurun("-np", "2", "--plm", "sim", "--hosts", "2", "--timeout", "3",
               "--", sys.executable, "-c", "import time; time.sleep(60)",
               timeout=60)
    assert r.returncode == 124, (r.returncode, r.stderr)
    assert "timed out" in r.stderr
    assert time.monotonic() - t0 < 30


def test_clean_cli_sweeps_a_dead_inbox(tmp_path, monkeypatch, capsys):
    """``tpurun --clean`` (its ``main``, in this process, with the sweep
    roots pinned into tmp_path so no other job's artifacts are judged):
    a dead rank's inbox (a doorbell nobody reads) is listed by the dry
    run, removed by the sweep, and gone from a second dry run."""
    from ompi_tpu_torch.runtime import clean as clean_mod
    from ompi_tpu_torch.tools import tpurun as tpurun_mod

    base = str(tmp_path)
    monkeypatch.setattr(clean_mod, "_dirs", lambda: [base])
    monkeypatch.setattr(clean_mod, "default_uri_path",
                        lambda: os.path.join(base, "no-such-uri"))
    dead = os.path.join(base, "otpu-shm-dead")
    os.mkdir(dead)
    os.mkfifo(os.path.join(dead, "doorbell"))
    os.utime(dead, (1, 1))
    assert tpurun_mod.main(["--clean", "--clean-dry-run"]) == 0
    err = capsys.readouterr().err
    assert f"would remove {dead}" in err
    assert "would remove 1 stale artifact(s)" in err
    assert os.path.isdir(dead)
    assert tpurun_mod.main(["--clean"]) == 0
    err = capsys.readouterr().err
    assert f"removing {dead}" in err and "removed 1 stale" in err
    assert not os.path.exists(dead)
    assert tpurun_mod.main(["--clean", "--clean-dry-run"]) == 0
    err = capsys.readouterr().err
    assert dead not in err and "would remove 0 stale" in err


def test_metrics_uplink_reaches_the_hnp_through_the_tree(monkeypatch,
                                                         sim_ras):
    """``trace_metrics_push_period`` > 0: each orted runs its collector,
    its ranks push their pvars to it, the daemons hop the merged deltas
    up (``TAG_METRICS``) and the HNP's ``MetricsAggregate`` holds a row
    for every rank of the job, stamped with its daemon's clock offset."""
    from ompi_tpu_torch.runtime.job import AppContext, Job
    from ompi_tpu_torch.runtime.plm import MultiHostLauncher

    monkeypatch.setenv("OMPI_TPU_MCA_trace_metrics_push_period", "0.2")
    monkeypatch.setenv("OMPI_TPU_MCA_clock_sync_period", "0.1")
    prog = ("import time, numpy as np, ompi_tpu_torch\n"
            "comm = ompi_tpu_torch.init()\n"
            "for _ in range(5):\n"
            "    comm.allreduce(np.ones(4))\n"
            "time.sleep(1.5)\n"
            "ompi_tpu_torch.finalize()\n")
    job = Job([AppContext(argv=[sys.executable, "-c", prog], np=4)])
    launcher = MultiHostLauncher(plm_name="sim", stdin_target="none")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert launcher.run(job) == 0
    snap = launcher.metrics_agg.snapshot()
    assert sorted(snap) == [job.jobid], snap.keys()
    rows = snap[job.jobid]
    assert sorted(rows) == [0, 1, 2, 3], rows.keys()
    for rank, (_ts, values) in rows.items():
        assert values, rank
    offsets = [v.get("rank_clock_to_root_ns") for _t, v in rows.values()]
    assert any(o is not None for o in offsets), offsets


def test_simulator_ras_deals_cards_per_node(monkeypatch, sim_ras):
    """Under ``want_gpu`` the two simulated hosts share out the cards:
    with 4 cards they own 0, 1 and 2, 3, with 3 cards one each (the
    rest unused), with 1 card both carry it; without ``want_gpu`` no
    host carries a card (and no card count is asked for)."""
    import torch

    from ompi_tpu_torch.runtime import ras
    from ompi_tpu_torch.runtime.job import AppContext, Job

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    job = Job([AppContext(argv=["x"], np=4)])
    for count, chips in ((4, [[0, 1], [2, 3]]), (3, [[0], [1]]),
                         (2, [[0], [1]]), (1, [[0], [0]])):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
        ras.allocate(job, want_gpu=True)
        assert [n.chips for n in job.nodes] == chips, count
        assert [n.topology["chips"] for n in job.nodes] == [
            len(c) for c in chips]
    monkeypatch.setattr(torch.cuda, "device_count",
                        lambda: pytest.fail("counted cards"))
    ras.allocate(job)
    assert [n.chips for n in job.nodes] == [None, None]
    assert [n.name for n in job.nodes] == ["sim000", "sim001"]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ras.NoCardError):
        ras.allocate(job, want_gpu=True)


def test_remote_hnp_address_is_never_loopback(monkeypatch):
    """``--plm ssh`` to a remote host: the PMIx URI handed to its ranks
    carries the first address this host's names resolve to that is not
    loopback; a host whose names resolve only to loopback (127.0.1.1 in
    Debian-family /etc/hosts) aborts the job before any daemon starts,
    with the reason."""
    import socket

    from ompi_tpu_torch.runtime import rmaps
    from ompi_tpu_torch.runtime.job import AppContext, Job, Node
    from ompi_tpu_torch.runtime.plm import MultiHostLauncher

    def resolver(addrs):
        return lambda name, port, family=0, *a, **k: [
            (socket.AF_INET, socket.SOCK_STREAM, 6, "", (ad, 0))
            for ad in addrs]

    launcher = MultiHostLauncher(plm_name="ssh")
    launcher._pool_nodes = [Node(name="node-b.example", slots=1)]
    monkeypatch.setattr(socket, "getaddrinfo",
                        resolver(["127.0.1.1", "10.1.2.3"]))
    assert launcher._my_address() == "10.1.2.3"
    monkeypatch.setattr(socket, "getaddrinfo", resolver(["127.0.1.1"]))
    with pytest.raises(RuntimeError, match="resolve only to loopback"):
        launcher._my_address()
    job = Job([AppContext(argv=["x"], np=1)])
    job.nodes = [Node(name="node-b.example", slots=1)]
    rmaps.map_job(job)
    assert launcher._vm_up(job) is False
    assert "resolve only to loopback" in job.abort_reason
    assert launcher._daemon_popen == [] and launcher.rml is None
    # every node this host: loopback, with no lookup at all
    monkeypatch.setattr(socket, "getaddrinfo",
                        lambda *a, **k: pytest.fail("resolved"))
    launcher._pool_nodes = [Node(name="localhost", slots=1)]
    assert launcher._my_address() == "127.0.0.1"
