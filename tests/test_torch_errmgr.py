"""The port's errmgr policies (``ompi_tpu_torch/runtime/errmgr.py``) and
the local launcher's respawn, held against the JAX package's.

Each case mirrors one of ``tests/runtime/test_errmgr_policies.py`` or
``tests/runtime/test_respawn.py``, with every assertion kept.  The unit
cases drive a policy with a fake launcher and run once per package
(``pkg``), so both packages' policies reach the same verdicts on the same
job; the launched cases run the port's ``tpurun`` on this machine's CPU.
The daemon tree's cases close the file: the notify policy surviving a
daemon's death, the respawn across the tree (``TAG_RESPAWN``), the
heartbeat clamp on the backoff and the batched propagation of a daemon's
ranks, through ``tests/torch_mirror.py`` where a body maps cleanly (the
reference's bytecode; the heartbeat monitor's own cases are in
``tests/test_torch_rml.py``).
"""

from __future__ import annotations

import importlib
import os
import pathlib
import subprocess
import sys
import time
import types

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
TPURUN = [sys.executable, "-m", "ompi_tpu_torch.tools.tpurun"]


def _package(name: str) -> types.SimpleNamespace:
    mod = lambda m: importlib.import_module(f"{name}.{m}")  # noqa: E731
    return types.SimpleNamespace(
        name=name, errmgr=mod("runtime.errmgr"),
        notifier=mod("runtime.notifier"), job=mod("runtime.job"),
        launcher=mod("runtime.launcher"),
        vars=mod("core.config").var_registry)


@pytest.fixture(params=["ompi_tpu", "ompi_tpu_torch"])
def pkg(request):
    return _package(request.param)


def tpurun(*args, timeout=120, env_extra=None):
    env = dict(os.environ)
    env.pop("OMPI_TPU_RANK", None)
    if env_extra:
        env.update(env_extra)
    return subprocess.run(TPURUN + list(args), capture_output=True,
                          text=True, timeout=timeout, env=env, cwd=ROOT)


class _FakeLauncher:
    """Just enough launcher surface for unit-driving a policy."""

    def __init__(self):
        self.killed = False
        self.respawned = []
        self.server = None
        self.rml = None

    def kill_job(self, job, exclude=None):
        self.killed = True

    def respawn_proc(self, job, proc):
        self.respawned.append(proc.rank)
        return True


class _RecordingNotifier:
    NAME = "recorder"
    PRIORITY = 100

    def __init__(self):
        self.events = []

    def query(self, **ctx):
        return self.PRIORITY

    def notify(self, severity, event, detail):
        self.events.append((severity, event, detail))


@pytest.fixture
def recorder(monkeypatch, pkg):
    rec = _RecordingNotifier()
    monkeypatch.setattr(pkg.notifier.notifier_framework, "select",
                        lambda **ctx: rec)
    return rec


def _failed_proc(pkg, job, rank=1, rc=9):
    proc = job.procs[rank] if job.procs else pkg.job.Proc(rank=rank)
    proc.state = pkg.job.ProcState.ABORTED
    proc.exit_code = rc
    return proc


def _job(pkg, np_=3):
    J = pkg.job
    job = J.Job([J.AppContext(argv=["true"], np=np_)])
    job.procs = [J.Proc(rank=r) for r in range(np_)]
    return job


# -- continue ----------------------------------------------------------------

def test_continue_policy_neither_kills_nor_aborts(pkg):
    launcher, job = _FakeLauncher(), _job(pkg)
    proc = _failed_proc(pkg, job)
    pkg.errmgr.ErrmgrContinue().proc_failed(launcher, job, proc)
    assert not launcher.killed
    assert job.aborted_proc is None          # job exit stays 0


def test_continue_job_reaps_dead_rank_without_killing_survivors():
    prog = ("import os, sys, ompi_tpu_torch\n"
            "comm = ompi_tpu_torch.init()\n"
            "if comm.rank == 1:\n"
            "    os._exit(5)\n"
            "print(f'rank {comm.rank} survived', flush=True)\n"
            "ompi_tpu_torch.finalize()\n")
    r = tpurun("-np", "3", "--mca", "errmgr", "continue", "--",
               sys.executable, "-c", prog)
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert "rank 0 survived" in r.stdout
    assert "rank 2 survived" in r.stdout
    assert "rank 1 survived" not in r.stdout


# -- notify ------------------------------------------------------------------

def test_notify_policy_propagates_without_killing(pkg, recorder):
    launcher, job = _FakeLauncher(), _job(pkg)

    class _Server:
        def __init__(self):
            self.died = []

        def proc_died(self, rank, reason=""):
            self.died.append((rank, reason))

    launcher.server = _Server()
    proc = _failed_proc(pkg, job)
    pkg.errmgr.ErrmgrNotify().proc_failed(launcher, job, proc)
    assert not launcher.killed
    assert job.aborted_proc is None
    assert launcher.server.died and launcher.server.died[0][0] == 1
    assert "exit code 9" in launcher.server.died[0][1]
    assert any(ev == "rank-failed" for _s, ev, _d in recorder.events)


def test_notify_surfaces_err_proc_failed_to_survivors():
    """Under notify, a survivor's send to the dead rank raises
    MPI_ERR_PROC_FAILED quickly (control-plane detector), instead of
    stalling for the full 30 s pml_retry_window."""
    prog = (
        "import os, time, numpy as np, ompi_tpu_torch\n"
        "from ompi_tpu_torch.mpi.constants import (MPIException,\n"
        "    ERR_PROC_FAILED)\n"
        "comm = ompi_tpu_torch.init()\n"
        "if comm.rank == 1:\n"
        "    os._exit(7)\n"
        "time.sleep(1.0)\n"   # give the launcher time to reap rank 1
        "t0 = time.monotonic()\n"
        "try:\n"
        "    comm.send(np.array([1.0]), dest=1)\n"
        "    print('send unexpectedly succeeded', flush=True)\n"
        "except MPIException as e:\n"
        "    took = time.monotonic() - t0\n"
        "    ok = e.error_class == ERR_PROC_FAILED and took < 10.0\n"
        "    print(f'failfast ok={ok} took={took:.1f}', flush=True)\n"
        "ompi_tpu_torch.finalize()\n")
    r = tpurun("-np", "2", "--mca", "errmgr", "notify", "--",
               sys.executable, "-c", prog)
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert "failfast ok=True" in r.stdout, (r.stdout, r.stderr)


# -- respawn notifier emission -----------------------------------------------

def test_respawn_emits_notifier_event(pkg, recorder):
    launcher, job = _FakeLauncher(), _job(pkg)
    proc = _failed_proc(pkg, job)
    pkg.errmgr.ErrmgrRespawn().proc_failed(launcher, job, proc)
    assert launcher.respawned == [1]
    assert not launcher.killed
    events = [ev for _s, ev, _d in recorder.events]
    assert "rank-respawn" in events
    sev, _ev, detail = recorder.events[events.index("rank-respawn")]
    assert sev >= pkg.notifier.Severity.WARN
    assert "rank 1" in detail


def test_respawn_exhaustion_aborts_and_notifies(pkg, recorder):
    launcher, job = _FakeLauncher(), _job(pkg)
    proc = _failed_proc(pkg, job)
    proc.restarts = pkg.vars.get("errmgr_max_restarts")
    pkg.errmgr.ErrmgrRespawn().proc_failed(launcher, job, proc)
    assert launcher.killed
    assert job.aborted_proc is proc


# -- host-plane policy applies to every REVIVING policy -----------------------

def test_host_plane_policy_applies_to_all_reviving_policies(pkg):
    E = pkg.errmgr
    key = pkg.vars.ENV_PREFIX + "multihost_auto_init"
    for policy in (E.ErrmgrRespawn(), E.ErrmgrSelfheal()):
        env = {}
        E.apply_host_plane_policy(policy, env)
        assert env.get(key) == "0", policy.NAME


def test_host_plane_policy_keeps_user_override(pkg):
    E = pkg.errmgr
    key = pkg.vars.ENV_PREFIX + "multihost_auto_init"
    env = {key: "1"}
    E.apply_host_plane_policy(E.ErrmgrSelfheal(), env)
    assert env[key] == "1"                   # explicit setting wins
    env = {}
    E.apply_host_plane_policy(E.ErrmgrSelfheal(), env, {key: "1"})
    assert key not in env                    # set in a base env: respected


def test_host_plane_policy_ignores_non_reviving_policies(pkg):
    E = pkg.errmgr
    key = pkg.vars.ENV_PREFIX + "multihost_auto_init"
    for policy in (E.ErrmgrNotify(), E.ErrmgrContinue()):
        env = {}
        E.apply_host_plane_policy(policy, env)
        assert key not in env, policy.NAME


# -- respawn, launched -------------------------------------------------------

RESPAWN_APP = r"""
import os, sys
import numpy as np
import ompi_tpu_torch
from ompi_tpu_torch.ckpt.store import SnapshotStore

comm = ompi_tpu_torch.init()
rank = comm.rank
store = SnapshotStore(os.environ["CKPT_DIR"], job=f"rank{rank}")
restarted = int(os.environ.get("OMPI_TPU_RESTART", "0"))

start, acc = 0, 0.0
if restarted:
    seq = store.latest()
    state = store.load_rank(seq, 0)
    start, acc = int(state["step"]) + 1, float(state["acc"])
    print(f"rank {rank} resumed at step {start} from snapshot {seq}",
          flush=True)

for step in range(start, 5):
    acc += rank * 10 + step
    store.write_rank(step, 0, {"step": np.int64(step), "acc": np.float64(acc)})
    store.commit(step, 1)
    if rank == 1 and not restarted and step == 2:
        os._exit(9)   # die AFTER committing snapshot 2

# post-restart p2p both ways: revived 1 -> 0, then 0 -> revived 1 over
# the REBOUND route — eager first, then a rendezvous-sized buffer (the
# fragment pipeline must also ride the healed route)
if rank == 1:
    comm.send(np.array([acc]), dest=0, tag=7)
    ack = comm.recv(source=0, tag=8)
    print(f"rank 1 got ack {float(ack[0]):.0f}", flush=True)
    big = comm.recv(source=0, tag=9)
    assert big.shape == (50_000,) and float(big[0]) == 42.0, big[:3]
    print("rank 1 got rndv payload", flush=True)
elif rank == 0:
    peer_acc = comm.recv(source=1, tag=7)
    comm.send(peer_acc + 1, dest=1, tag=8)
    comm.send(np.full(50_000, 42.0), dest=1, tag=9)   # > eager limit

print(f"rank {rank} acc={acc:.0f}", flush=True)
ompi_tpu_torch.finalize()
"""


def test_respawn_recovers_rank_with_ckpt(tmp_path):
    r = tpurun("-np", "3", "--mca", "errmgr", "respawn", "--",
               sys.executable, "-c", RESPAWN_APP,
               env_extra={"CKPT_DIR": str(tmp_path)})
    assert r.returncode == 0, (r.stdout, r.stderr)
    # rank 1 died after step 2, revived, resumed at 3, recomputed nothing
    assert "rank 1 resumed at step 3 from snapshot 2" in r.stdout
    # acc for rank 1 = sum(10+s for s in 0..4) = 60; rank 0 = 0+1+2+3+4=10
    assert "rank 1 acc=60" in r.stdout
    assert "rank 0 acc=10" in r.stdout
    assert "rank 2 acc=110" in r.stdout
    # the rebound 0→1 route delivered the ack (61)
    assert "rank 1 got ack 61" in r.stdout
    assert "rank 1 got rndv payload" in r.stdout


def test_respawn_exhausted_aborts(tmp_path):
    prog = ("import os, ompi_tpu_torch\n"
            "comm = ompi_tpu_torch.init()\n"
            "os._exit(3) if comm.rank == 1 else None\n"
            "import time; time.sleep(30)\n")
    r = tpurun("-np", "2", "--mca", "errmgr", "respawn",
               "--mca", "errmgr_max_restarts", "1", "--",
               sys.executable, "-c", prog,
               env_extra={"CKPT_DIR": str(tmp_path)})
    assert r.returncode != 0
    assert "restart" in (r.stdout + r.stderr).lower()


CHAOS_APP = r"""
import os
import numpy as np
import ompi_tpu_torch
from ompi_tpu_torch.ckpt.msglog import MessageLog
from ompi_tpu_torch.ckpt.store import SnapshotStore

comm = ompi_tpu_torch.init()
rank, size = comm.rank, comm.size
store = SnapshotStore(os.environ["CKPT_DIR"], job=f"rank{rank}")
restarted = int(os.environ.get("OMPI_TPU_RESTART", "0"))

# the uncoordinated-recovery recipe: sender-side message log with
# auto-replay on peer revival (no mid-run mark(): a replayed message the
# peer already consumed parks harmlessly in its unexpected queue —
# per-step tags never re-match)
log = MessageLog(comm).attach(auto_replay=True)

start, acc = 0, 0.0
if restarted:
    seq = store.latest()
    state = store.load_rank(seq, 0)
    start, acc = int(state["step"]) + 1, float(state["acc"])
    print(f"rank {rank} resumed at step {start}", flush=True)

# kill schedule: three DIFFERENT ranks die at three different steps
# (first life only) — every surviving rank must rebind to each revived
# peer in turn while the ring keeps moving
DEATHS = {1: 2, 2: 4, 3: 6}

right, left = (rank + 1) % size, (rank - 1) % size
for step in range(start, 8):
    out = np.array([float(rank * 100 + step)])
    sreq = comm.isend(out, dest=right, tag=step)
    got = comm.recv(source=left, tag=step)
    sreq.wait()
    assert float(got[0]) == left * 100 + step, (step, got)
    acc += float(got[0])
    store.write_rank(step, 0, {"step": np.int64(step),
                               "acc": np.float64(acc)})
    store.commit(step, 1)
    if not restarted and DEATHS.get(rank) == step:
        os._exit(9)

print(f"rank {rank} chaos done acc={acc:.0f}", flush=True)
ompi_tpu_torch.finalize()
"""


def test_chaos_multiple_sequential_failures(tmp_path):
    """Three different ranks die at different steps under sustained ring
    traffic; each revives from its snapshot, peers rebind, and the
    message log auto-replays the sends that died with the old
    incarnation's transport."""
    r = tpurun("-np", "4", "--mca", "errmgr", "respawn", "--",
               sys.executable, "-c", CHAOS_APP,
               env_extra={"CKPT_DIR": str(tmp_path)}, timeout=240)
    out = r.stdout + r.stderr
    assert r.returncode == 0, out[-3000:]
    for rank in range(4):
        assert f"rank {rank} chaos done" in out, out[-3000:]
    for rank in (1, 2, 3):
        assert f"rank {rank} resumed at step" in out, out[-3000:]


# -- degrade-to-abort arms (unit: no subprocess) -------------------------------

class _RespawningLauncher:
    def __init__(self, ok=True):
        self.killed = False
        self.respawned = []
        self.server = None
        self.rml = None
        self._ok = ok

    def kill_job(self, job, exclude=None):
        self.killed = True

    def respawn_proc(self, job, proc):
        self.respawned.append(proc.rank)
        if self._ok:
            proc.restarts += 1   # budget burn (mirrors the real launchers)
            proc.lives += 1      # identity: monotone across budget resets
            proc.launched_at = time.monotonic()
        return self._ok


class _HookLessLauncher:
    """A launcher without respawn_proc (custom integrations)."""

    def __init__(self):
        self.killed = False
        self.server = None
        self.rml = None

    def kill_job(self, job, exclude=None):
        self.killed = True


def _unit_job(pkg, np_=3, fail_rank=1):
    J = pkg.job
    job = J.Job([J.AppContext(argv=["true"], np=np_)])
    job.procs = [J.Proc(rank=r, state=J.ProcState.RUNNING)
                 for r in range(np_)]
    proc = job.procs[fail_rank]
    proc.state = J.ProcState.ABORTED
    proc.exit_code = 9
    return job, proc


def test_respawn_launcher_without_hook_degrades_to_abort(pkg):
    launcher, (job, proc) = _HookLessLauncher(), _unit_job(pkg)
    pkg.errmgr.ErrmgrRespawn().proc_failed(launcher, job, proc)
    assert launcher.killed
    assert job.aborted_proc is proc
    assert "rank 1" in job.abort_reason


def test_respawn_start_failure_degrades_to_abort(pkg):
    launcher = _RespawningLauncher(ok=False)
    job, proc = _unit_job(pkg)
    pkg.errmgr.ErrmgrRespawn().proc_failed(launcher, job, proc)
    assert launcher.respawned == [1]   # it tried before giving up
    assert launcher.killed
    assert job.aborted_proc is proc


def test_respawn_budget_exhaustion_degrades_to_abort(pkg):
    launcher = _RespawningLauncher()
    job, proc = _unit_job(pkg)
    proc.restarts = pkg.vars.get("errmgr_max_restarts")
    proc.launched_at = time.monotonic()   # instant re-death: no reset
    pkg.errmgr.ErrmgrRespawn().proc_failed(launcher, job, proc)
    assert launcher.respawned == []
    assert launcher.killed
    assert job.aborted_proc is proc
    assert "restart" in job.abort_reason


def test_respawn_crash_loop_backoff_and_budget_reset(pkg, monkeypatch):
    """An instant re-death sleeps the (doubling) backoff before its
    revive; a life that outlived errmgr_min_uptime_s resets the budget
    so a long-running rank's occasional deaths never exhaust it."""
    E = pkg.errmgr
    sleeps = []
    monkeypatch.setattr(E, "_sleep", sleeps.append)
    launcher = _RespawningLauncher()
    job, proc = _unit_job(pkg)
    policy = E.ErrmgrRespawn()
    # crash-loop death (uptime ~0): burns a slot, sleeps the base backoff
    proc.restarts = 1
    proc.launched_at = time.monotonic() - 0.01
    policy.proc_failed(launcher, job, proc)
    assert launcher.respawned == [1]
    assert sleeps == [E._BACKOFF_BASE]
    assert not launcher.killed
    # earned-uptime death: budget resets, no backoff, revive proceeds
    # even though restarts sat AT the limit before the reset
    launcher2 = _RespawningLauncher()
    job2, proc2 = _unit_job(pkg)
    proc2.restarts = pkg.vars.get("errmgr_max_restarts")
    proc2.launched_at = (time.monotonic()
                         - pkg.vars.get("errmgr_min_uptime_s") - 1.0)
    sleeps.clear()
    policy.proc_failed(launcher2, job2, proc2)
    assert launcher2.respawned == [1]
    assert sleeps == []
    assert not launcher2.killed


def test_respawn_pre_registration_death_burns_budget(pkg, monkeypatch):
    """A life that crashed during boot (never registered with the PMIx
    server, so launched_at is None) burns a budget slot with backoff —
    boot time must not earn the crash-loop budget back."""
    E = pkg.errmgr
    sleeps = []
    monkeypatch.setattr(E, "_sleep", sleeps.append)
    launcher = _RespawningLauncher()
    job, proc = _unit_job(pkg)
    proc.restarts, proc.lives = 1, 1
    proc.launched_at = None
    E.ErrmgrRespawn().proc_failed(launcher, job, proc)
    assert launcher.respawned == [1]
    assert proc.restarts == 2          # burned, not reset
    assert sleeps == [E._BACKOFF_BASE]
    assert not launcher.killed


def test_respawn_budget_reset_keeps_lives_monotone(pkg, monkeypatch):
    """The earned-uptime budget reset must not regress the incarnation
    the next life announces (survivors fence anything lower)."""
    E = pkg.errmgr
    monkeypatch.setattr(E, "_sleep", lambda s: None)
    launcher = _RespawningLauncher()
    job, proc = _unit_job(pkg)
    proc.restarts, proc.lives = 2, 2
    proc.launched_at = (time.monotonic()
                        - pkg.vars.get("errmgr_min_uptime_s") - 1.0)
    E.ErrmgrRespawn().proc_failed(launcher, job, proc)
    assert launcher.respawned == [1]
    assert proc.restarts == 1 and proc.lives == 3
    assert not launcher.killed


def test_proc_env_carries_monotone_life_number(pkg):
    """OMPI_TPU_RESTART (the incarnation everything keys on: snapshot
    restore, PML si stamps, first-life-only fault plans) comes from the
    monotone proc.lives, not the governor-resettable restart budget."""
    launcher = pkg.launcher.LocalLauncher()

    class _Uri:
        uri = "tcp://127.0.0.1:1"

    launcher.server = _Uri()
    job, proc = _unit_job(pkg)
    proc.lives, proc.restarts = 3, 0   # budget reset; identity keeps 3
    env = launcher._proc_env(job, proc)
    assert env["OMPI_TPU_RESTART"] == "3"


# -- the port's own: a --gpu rank's new life ---------------------------------

def test_revived_gpu_rank_keeps_its_card_and_gets_no_rendezvous():
    """A ``--gpu`` rank's revived life keeps ``OMPI_TPU_CHIP`` and is
    given no ``OMPI_TPU_COORD``: the process group cannot take a
    member's new life, so the life binds its card and runs alone; its
    first life got both."""
    from ompi_tpu_torch.runtime.launcher import ENV_COORD, LocalLauncher
    from ompi_tpu_torch.runtime.pmix import ENV_CHIP

    launcher = LocalLauncher(want_gpu=True)

    class _Uri:
        uri = "tcp://127.0.0.1:1"

    launcher.server = _Uri()
    launcher.coord = "127.0.0.1:2"
    job, proc = _unit_job(_package("ompi_tpu_torch"))
    proc.chip = 0
    first = launcher._proc_env(job, proc)
    assert first[ENV_COORD] == "127.0.0.1:2" and first[ENV_CHIP] == "0"
    assert "OMPI_TPU_RESTART" not in first
    proc.lives = 1
    revived = launcher._proc_env(job, proc)
    assert revived[ENV_CHIP] == "0" and revived["OMPI_TPU_RESTART"] == "1"
    assert ENV_COORD not in revived


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


GROUP_APP = r"""
import os, time
import numpy as np
import ompi_tpu_torch
from ompi_tpu_torch.mpi.constants import (ERR_PROC_FAILED, ERR_REVOKED,
    MPIException)
from ompi_tpu_torch.parallel import multihost
from ompi_tpu_torch.testing import faultinject

comm = ompi_tpu_torch.init()
me = comm.rank
life = int(os.environ.get("OMPI_TPU_RESTART") or 0)
print(f"rank {me} life {life} group={multihost.is_initialized()}",
      flush=True)
acc = 0.0
for step in range(4):
    faultinject.step()
    try:
        acc += float(comm.allreduce(np.array([1.0 + step]))[0])
    except MPIException as e:
        if e.error_class not in (ERR_PROC_FAILED, ERR_REVOKED):
            raise
        comm.revoke()
        comm = comm.shrink()
        acc += float(comm.allreduce(np.array([1.0 + step]))[0])
        print(f"rank {me} shrank to {comm.size} at step {step}", flush=True)
t0 = time.monotonic()
ompi_tpu_torch.finalize()
print(f"rank {me} acc={acc:.0f} finalize_s={time.monotonic() - t0:.3f}",
      flush=True)
"""


def test_notify_job_in_a_process_group_finalizes_without_the_dead(tmp_path):
    """A job whose ranks joined one gloo group (the rendezvous passed by
    hand, as ``--gpu`` exports it) loses rank 1 under notify: rank 0
    revokes, shrinks and finishes on the host route, and its finalize
    leaves the group without waiting on the dead member (well inside
    the 10 s watchdog); the job exits 0, not at ``--timeout``."""
    r = tpurun("-np", "2", "--timeout", "90", "--mca", "errmgr", "notify",
               "--mca", "faultinject_plan", "rank=1:kill@step=1",
               "-x", f"OMPI_TPU_COORD=127.0.0.1:{_free_port()}",
               "-x", "OMPI_TPU_NHOSTS=1", "--",
               sys.executable, "-c", GROUP_APP)
    out = r.stdout + r.stderr
    assert r.returncode == 0, out[-3000:]
    assert "rank 0 life 0 group=True" in out, out[-3000:]
    assert "rank 0 shrank to 1 at step 1" in out, out[-3000:]
    line = next(ln for ln in r.stdout.splitlines() if "rank 0 acc=" in ln)
    assert "acc=11" in line, line
    assert float(line.split("finalize_s=")[1]) < 10.0, line


@pytest.mark.parametrize("auto_init", [None, "1"])
def test_revived_life_never_rejoins_the_process_group(tmp_path, auto_init):
    """Under respawn a job with a rendezvous runs without the group
    (``multihost_auto_init`` 0 from the policy); with the user's explicit
    ``multihost_auto_init 1`` the first life joins and the revived life
    still does not (a group cannot take a member's new life)."""
    mca = [] if auto_init is None else ["--mca", "multihost_auto_init",
                                        auto_init]
    r = tpurun("-np", "1", "--timeout", "90", "--mca", "errmgr", "respawn",
               *mca, "--mca", "faultinject_plan", "rank=0:kill@step=2",
               "-x", f"OMPI_TPU_COORD=127.0.0.1:{_free_port()}",
               "-x", "OMPI_TPU_NHOSTS=1", "--",
               sys.executable, "-c", GROUP_APP)
    out = r.stdout + r.stderr
    assert r.returncode == 0, out[-3000:]
    first = "True" if auto_init == "1" else "False"
    assert f"rank 0 life 0 group={first}" in out, out[-3000:]
    assert "rank 0 life 1 group=False" in out, out[-3000:]
    assert "rank 0 acc=10" in out, out[-3000:]


# -- the daemon tree -----------------------------------------------------------

import tests.runtime.test_errmgr_policies as ref_policies  # noqa: E402
import tests.runtime.test_fleet_bounds as ref_fleet  # noqa: E402
import tests.runtime.test_respawn as ref_respawn  # noqa: E402
from tests.torch_mirror import mirror  # noqa: E402

PORTS = pytest.mark.parametrize("port", [False, True], ids=["jax", "port"])


def test_notify_daemon_death_fails_its_ranks_job_continues(tmp_path):
    mirror(ref_policies.test_notify_daemon_death_fails_its_ranks_job_continues,
           True, [])(tmp_path)


@PORTS
def test_plm_teardown_timeouts_are_registered_vars(port):
    mirror(ref_policies.test_plm_teardown_timeouts_are_registered_vars,
           port, [])()


@PORTS
def test_backoff_clamped_below_daemon_heartbeat_timeout(port, monkeypatch):
    mirror(ref_respawn.test_backoff_clamped_below_daemon_heartbeat_timeout,
           port, [])(monkeypatch)


@PORTS
def test_batched_daemon_ranks_failed_sends_one_xcast(port):
    mirror(ref_fleet.test_batched_daemon_ranks_failed_sends_one_xcast,
           port, [])()


def test_respawn_across_daemon_tree(tmp_path):
    """``tests/runtime/test_respawn.py::test_respawn_across_daemon_tree``
    with the port's RESPAWN_APP (the reference's is a module string the
    mirror cannot rewrite): the daemon owning the failed rank revives it
    through TAG_RESPAWN and the job completes with snapshot recovery."""
    r = tpurun("-np", "3", "--plm", "sim", "--hosts", "2",
               "--mca", "errmgr", "respawn",
               "--mca", "multihost_auto_init", "0", "--",
               sys.executable, "-c", RESPAWN_APP,
               env_extra={"CKPT_DIR": str(tmp_path)})
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert "rank 1 resumed at step 3 from snapshot 2" in r.stdout
    assert "rank 1 acc=60" in r.stdout
    assert "rank 1 got ack 61" in r.stdout


def test_selfheal_daemon_loss_batch_escalates_to_shrink(pkg, recorder):
    """Selfheal's batched arm: the lost host's ranks are unrevivable, so
    the whole batch takes the shrink rung in one decision (one
    propagation xcast, one escalate event) while survivors run; with no
    survivor left it aborts."""
    sent = []

    class _Rml:
        def xcast(self, tag, payload):
            sent.append((tag, payload))

    launcher = _FakeLauncher()
    launcher.rml = _Rml()
    launcher.server = types.SimpleNamespace(
        proc_died=lambda *a, **k: None)
    job = _job(pkg, 4)
    for p in job.procs:
        p.state = pkg.job.ProcState.RUNNING
    dead = job.procs[2:]
    for p in dead:
        p.state = pkg.job.ProcState.ABORTED
    pkg.errmgr.ErrmgrSelfheal().daemon_ranks_failed(launcher, job, dead)
    assert len(sent) == 1 and sent[0][1][0] == [2, 3]
    assert not launcher.killed
    events = [e for _s, e, _d in recorder.events]
    assert events == ["selfheal-escalate"]
    assert "degrading to shrink" in recorder.events[0][2]
    # no carrier left: the same batch aborts the job
    sent.clear()
    for p in job.procs:
        p.state = pkg.job.ProcState.ABORTED
    pkg.errmgr.ErrmgrSelfheal().daemon_ranks_failed(launcher, job, dead)
    assert launcher.killed and job.aborted_proc is dead[0]
    assert "selfheal ladder exhausted" in job.abort_reason
