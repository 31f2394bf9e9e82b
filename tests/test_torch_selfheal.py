"""The port's errmgr selfheal ladder, incarnation rejoin fence and
stale-failure-report gate, held against the JAX package's.

Each case mirrors one of ``tests/runtime/test_selfheal.py`` that needs no
orted daemon tree, with every assertion kept: the unit cases run once per
package (``pkg``: the policy, the PML and FT sidecar, the PMIx server and
client of each), so both reach the same verdicts on the same inputs, and
the launched cases run the port's ``tpurun`` on this machine's CPU.  The
PML fence cases run on both PML paths, the native matching engine and the
pure-Python matcher (``native``).  Also here: the PMIx revive that drops
a dead life's hang-doctor port (``tests/runtime/test_doctor.py``).
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
        pmix=mod("runtime.pmix"), ft=mod("mpi.ft"), pml=mod("mpi.pml"),
        trace=mod("mpi.trace"), vars=mod("core.config").var_registry)


@pytest.fixture(params=["ompi_tpu", "ompi_tpu_torch"])
def pkg(request):
    return _package(request.param)


@pytest.fixture(params=[True, False], ids=["native", "python"])
def native(request, pkg):
    """The PML's matching path: the compiled engine or the Python one."""
    old = pkg.vars.get("pml_native_match")
    pkg.vars.set("pml_native_match", request.param)
    yield request.param
    pkg.vars.set("pml_native_match", old)


def tpurun(*args, timeout=150, env_extra=None):
    env = dict(os.environ)
    env.pop("OMPI_TPU_RANK", None)
    if env_extra:
        env.update(env_extra)
    return subprocess.run(TPURUN + list(args), capture_output=True,
                          text=True, timeout=timeout, env=env, cwd=ROOT)


class _Server:
    def __init__(self):
        self.died = []
        self.revived = []

    def proc_died(self, rank, reason=""):
        self.died.append((rank, reason))

    def proc_revived(self, rank, incarnation=None):
        self.revived.append((rank, incarnation))


class _Launcher:
    """Launcher surface for unit-driving the selfheal ladder."""

    def __init__(self, server=True, respawn_ok=True):
        self.killed = False
        self.respawned = []
        self.server = _Server() if server else None
        self.rml = None
        self._respawn_ok = respawn_ok

    def kill_job(self, job, exclude=None):
        self.killed = True

    def respawn_proc(self, job, proc):
        self.respawned.append(proc.rank)
        if not self._respawn_ok:
            return False
        proc.restarts += 1   # budget burn (mirrors the real launchers)
        proc.lives += 1      # identity: monotone across budget resets
        proc.launched_at = time.monotonic()
        if self.server is not None:
            self.server.proc_revived(proc.rank, proc.lives)
        return True


class _HookLessLauncher:
    """No respawn_proc at all (a custom launcher without the hook)."""

    def __init__(self):
        self.killed = False
        self.server = _Server()
        self.rml = None

    def kill_job(self, job, exclude=None):
        self.killed = True


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


def _job(pkg, np_=3):
    J = pkg.job
    job = J.Job([J.AppContext(argv=["true"], np=np_)])
    job.procs = [J.Proc(rank=r, state=J.ProcState.RUNNING)
                 for r in range(np_)]
    return job


def _fail(job, rank=1, rc=9):
    proc = job.procs[rank]
    proc.state = type(proc.state).ABORTED
    proc.exit_code = rc
    return proc


# -- rung 1: propagate + revive ---------------------------------------------

def test_selfheal_propagates_then_revives(pkg, recorder):
    launcher, job = _Launcher(), _job(pkg)
    proc = _fail(job)
    before = pkg.trace.counters["errmgr_selfheal_revives_total"]
    pkg.errmgr.ErrmgrSelfheal().proc_failed(launcher, job, proc)
    # notify rung ran first: the dead-set carries the reason
    assert launcher.server.died and launcher.server.died[0][0] == 1
    assert "exit code 9" in launcher.server.died[0][1]
    # then the revive rung
    assert launcher.respawned == [1]
    assert launcher.server.revived == [(1, 1)]
    assert not launcher.killed
    assert job.aborted_proc is None
    assert pkg.trace.counters["errmgr_selfheal_revives_total"] == before + 1
    assert any(ev == "rank-respawn" for _s, ev, _d in recorder.events)


# -- rung 2: degrade to notify/shrink ---------------------------------------

def test_budget_exhaustion_escalates_to_shrink(pkg, recorder):
    launcher, job = _Launcher(), _job(pkg)
    proc = _fail(job)
    proc.restarts = pkg.vars.get("errmgr_max_restarts")
    proc.launched_at = time.monotonic()   # instant re-death: no reset
    before = pkg.trace.counters["errmgr_selfheal_escalations_total"]
    pkg.errmgr.ErrmgrSelfheal().proc_failed(launcher, job, proc)
    assert launcher.respawned == []
    assert not launcher.killed            # the job continues smaller
    assert job.aborted_proc is None
    assert pkg.trace.counters[
        "errmgr_selfheal_escalations_total"] == before + 1
    escal = [d for _s, ev, d in recorder.events
             if ev == "selfheal-escalate"]
    assert escal and "degrading to shrink" in escal[0]


def test_failed_respawn_start_escalates_to_shrink(pkg, recorder):
    launcher, job = _Launcher(respawn_ok=False), _job(pkg)
    proc = _fail(job)
    pkg.errmgr.ErrmgrSelfheal().proc_failed(launcher, job, proc)
    assert launcher.respawned == [1]      # it tried
    assert not launcher.killed
    assert job.aborted_proc is None
    assert any(ev == "selfheal-escalate" for _s, ev, _d in recorder.events)


def test_daemon_lost_rank_skips_revive(pkg, recorder):
    launcher, job = _Launcher(), _job(pkg)
    proc = _fail(job)
    proc.daemon_lost = True
    pkg.errmgr.ErrmgrSelfheal().proc_failed(launcher, job, proc)
    assert launcher.respawned == []       # unrevivable: no daemon
    assert not launcher.killed
    escal = [d for _s, ev, d in recorder.events
             if ev == "selfheal-escalate"]
    assert escal and "daemon died" in escal[0]


def test_hookless_launcher_escalates_to_shrink(pkg, recorder):
    launcher, job = _HookLessLauncher(), _job(pkg)
    proc = _fail(job)
    pkg.errmgr.ErrmgrSelfheal().proc_failed(launcher, job, proc)
    assert not launcher.killed            # survivors carry the job
    assert job.aborted_proc is None


# -- rung 3: abort only when shrink is impossible ----------------------------

def test_no_survivors_escalates_to_abort(pkg, recorder):
    launcher, job = _Launcher(), _job(pkg)
    for p in job.procs:
        p.state = pkg.job.ProcState.ABORTED       # everyone else died too
    proc = _fail(job)
    proc.restarts = pkg.vars.get("errmgr_max_restarts")
    proc.launched_at = time.monotonic()
    pkg.errmgr.ErrmgrSelfheal().proc_failed(launcher, job, proc)
    assert launcher.killed
    assert job.aborted_proc is proc
    assert "ladder exhausted" in job.abort_reason


def test_no_control_plane_escalates_to_abort(pkg, recorder):
    launcher, job = _Launcher(server=False), _job(pkg)
    proc = _fail(job)
    proc.restarts = pkg.vars.get("errmgr_max_restarts")
    proc.launched_at = time.monotonic()
    pkg.errmgr.ErrmgrSelfheal().proc_failed(launcher, job, proc)
    assert launcher.killed
    assert job.aborted_proc is proc


def test_terminated_survivors_still_count_as_carriers(pkg, recorder):
    """Ranks that already finished cleanly carry the job: escalation
    degrades to shrink (exit 0 semantics), not abort — a crash-looping
    straggler must not retroactively fail a job whose other ranks all
    completed their work."""
    launcher, job = _Launcher(), _job(pkg)
    for p in job.procs:
        p.state = pkg.job.ProcState.TERMINATED
    proc = _fail(job)
    proc.restarts = pkg.vars.get("errmgr_max_restarts")
    proc.launched_at = time.monotonic()
    pkg.errmgr.ErrmgrSelfheal().proc_failed(launcher, job, proc)
    assert not launcher.killed
    assert job.aborted_proc is None


# -- crash-loop gating -------------------------------------------------------

def test_crash_loop_burns_budget_with_backoff(pkg, recorder, monkeypatch):
    sleeps = []
    monkeypatch.setattr(pkg.errmgr, "_sleep", sleeps.append)
    launcher, job = _Launcher(), _job(pkg)
    policy = pkg.errmgr.ErrmgrSelfheal()
    # life 1 died instantly after its revive
    proc = _fail(job)
    proc.restarts = 1
    proc.launched_at = time.monotonic() - 0.01
    policy.proc_failed(launcher, job, proc)
    assert launcher.respawned == [1]
    assert sleeps == [pkg.errmgr._BACKOFF_BASE]
    # the next instant re-death doubles the backoff
    _fail(job)
    job.procs[1].launched_at = time.monotonic() - 0.01
    job.procs[1].restarts = 1   # pretend budget not yet exhausted
    policy.proc_failed(launcher, job, job.procs[1])
    assert sleeps == [pkg.errmgr._BACKOFF_BASE, 2 * pkg.errmgr._BACKOFF_BASE]


def test_min_uptime_earns_budget_back(pkg, recorder, monkeypatch):
    sleeps = []
    monkeypatch.setattr(pkg.errmgr, "_sleep", sleeps.append)
    launcher, job = _Launcher(), _job(pkg)
    proc = _fail(job)
    # at the budget limit, but the last life ran LONGER than min_uptime:
    # the previous revive counts as successful — budget resets, no
    # backoff, and the rank is revived instead of escalated
    proc.restarts = pkg.vars.get("errmgr_max_restarts")
    proc.launched_at = (time.monotonic()
                        - pkg.vars.get("errmgr_min_uptime_s") - 1.0)
    pkg.errmgr.ErrmgrSelfheal().proc_failed(launcher, job, proc)
    assert launcher.respawned == [1]
    assert sleeps == []
    assert not any(ev == "selfheal-escalate"
                   for _s, ev, _d in recorder.events)


def test_budget_reset_does_not_regress_incarnation(pkg, recorder, monkeypatch):
    """The governor resets the BUDGET counter, never the incarnation: a
    rank that earned its uptime back and later dies again must announce
    a strictly HIGHER life than survivors already adopted, or the
    incarnation fence drops every frame from the new life forever (and
    the server's stale-report gate regresses with it)."""
    monkeypatch.setattr(pkg.errmgr, "_sleep", lambda s: None)
    launcher, job = _Launcher(), _job(pkg)
    proc = _fail(job)
    # two crash-loop revives behind it (survivors adopted life 2), then
    # this life EARNED its uptime — the budget resets on this death
    proc.restarts = 2
    proc.lives = 2
    proc.launched_at = (time.monotonic()
                        - pkg.vars.get("errmgr_min_uptime_s") - 1.0)
    pkg.errmgr.ErrmgrSelfheal().proc_failed(launcher, job, proc)
    assert launcher.respawned == [1]
    assert proc.restarts == 1          # budget: reset, then one burn
    assert proc.lives == 3             # identity: strictly monotone
    assert launcher.server.revived[-1] == (1, 3)


def test_pre_registration_death_burns_budget(pkg, recorder, monkeypatch):
    """A life that died before its PMIx registration (launched_at is
    None — a crash during interpreter boot) is the crash-loopiest case
    of all: it must burn a budget slot with backoff, never earn the
    budget back just because boot took longer than min_uptime."""
    sleeps = []
    monkeypatch.setattr(pkg.errmgr, "_sleep", sleeps.append)
    launcher, job = _Launcher(), _job(pkg)
    proc = _fail(job)
    proc.restarts = 1
    proc.lives = 1
    proc.launched_at = None            # never registered this life
    pkg.errmgr.ErrmgrSelfheal().proc_failed(launcher, job, proc)
    assert launcher.respawned == [1]
    assert proc.restarts == 2          # burned, not reset
    assert sleeps == [pkg.errmgr._BACKOFF_BASE]


def test_min_uptime_zero_restores_classic_budget(pkg, recorder, monkeypatch):
    """Gate disabled (errmgr_min_uptime_s 0) means CLASSIC budget
    semantics: revives count against errmgr_max_restarts with no reset
    and no backoff — NOT 'every revive is successful', which would
    reset the budget forever and revive a deterministic crasher in a
    tight loop that never reaches the degrade rung."""
    sleeps = []
    monkeypatch.setattr(pkg.errmgr, "_sleep", sleeps.append)
    old = pkg.vars.get("errmgr_min_uptime_s")
    pkg.vars.set("errmgr_min_uptime_s", 0.0)
    try:
        launcher, job = _Launcher(), _job(pkg)
        proc = _fail(job)
        proc.restarts = 1   # below the limit: revive, no reset/backoff
        proc.launched_at = None
        pkg.errmgr.ErrmgrSelfheal().proc_failed(launcher, job, proc)
        assert launcher.respawned == [1]
        assert proc.restarts == 2      # burned, never reset
        assert sleeps == []            # and never delayed
        # at the limit the ladder still degrades (bounded revives)
        proc2 = _fail(job)
        proc2.restarts = pkg.vars.get("errmgr_max_restarts")
        pkg.errmgr.ErrmgrSelfheal().proc_failed(launcher, job, proc2)
        assert launcher.respawned == [1]   # no second revive
        assert any(ev == "selfheal-escalate"
                   for _s, ev, _d in recorder.events)
    finally:
        pkg.vars.set("errmgr_min_uptime_s", old)


# -- incarnation rejoin fence (PML data + FT control planes) ----------------

def _mk_pml(pkg, monkeypatch, incarnation=0):
    if incarnation:
        monkeypatch.setenv("OMPI_TPU_RESTART", str(incarnation))
    else:
        monkeypatch.delenv("OMPI_TPU_RESTART", raising=False)
    PmlOb1 = pkg.pml.PmlOb1

    return PmlOb1(0)


def test_pml_fence_drops_pre_restart_data_frames(pkg, native, monkeypatch):
    pml = _mk_pml(pkg, monkeypatch, incarnation=1)
    try:
        base = pml.pvar_fenced.read()
        pml._on_frame(1, {"t": "eager", "tag": 0, "cid": 0, "seq": 0,
                          "dt": "<f8", "elems": 1, "shp": [1], "ep": 0},
                      b"\x00" * 8)
        assert pml.pvar_fenced.read() == base + 1
        # the frame was dropped, not queued for matching
        assert pml.iprobe(1, 0, 0) is None
    finally:
        pml.close()


def test_ft_fence_drops_frames_stamped_for_dead_life(pkg, monkeypatch):
    pml_ft = pkg.ft.pml_ft

    pml = _mk_pml(pkg, monkeypatch, incarnation=1)
    try:
        ft = pml_ft(pml)
        before = pkg.trace.counters["ft_fenced_frames_total"]
        # an agree ack stamped for life 0 of this (now life-1) rank
        ft.on_ft_frame(1, {"t": "ft", "op": "agree_a", "cid": 7,
                           "aseq": 0, "from": 1, "w": 0, "n": 0})
        assert pkg.trace.counters["ft_fenced_frames_total"] == before + 1
        # the current life's stamp passes
        ft.on_ft_frame(1, {"t": "ft", "op": "agree_a", "cid": 7,
                           "aseq": 0, "from": 1, "w": 0, "n": 0, "de": 1})
        assert pkg.trace.counters["ft_fenced_frames_total"] == before + 1
    finally:
        pml.close()


def test_ft_fence_drops_frames_from_dead_life_of_peer(pkg, monkeypatch):
    pml_ft = pkg.ft.pml_ft

    pml = _mk_pml(pkg, monkeypatch)
    try:
        ft = pml_ft(pml)
        pml._peer_inc[1] = 2   # peer is known to be in its 3rd life
        before = pkg.trace.counters["ft_fenced_frames_total"]
        ft.on_ft_frame(1, {"t": "ft", "op": "beat", "ep": 99, "v": {},
                           "n": 0, "si": 1})
        assert pkg.trace.counters["ft_fenced_frames_total"] == before + 1
        # the dead life's (high) epoch must not have refreshed the clock
        assert 1 not in ft._beats or ft._beats[1][0] == 0
    finally:
        pml.close()


def test_beats_exempt_from_destination_epoch_fence(pkg, monkeypatch):
    """A beat proves the SENDER is alive regardless of which of my lives
    it was stamped for — fencing it would starve a revived rank's gossip
    clocks in its rejoin window and trigger a survivor kill storm."""
    pml_ft = pkg.ft.pml_ft

    pml = _mk_pml(pkg, monkeypatch, incarnation=1)
    try:
        ft = pml_ft(pml)
        ft.on_ft_frame(1, {"t": "ft", "op": "beat", "ep": 3, "v": {},
                           "n": 0})   # no de stamp: sender not adopted yet
        assert 1 in ft._beats and ft._beats[1][0] == 3
    finally:
        pml.close()


def test_si_stamped_frame_revives_locally_dead_peer(pkg, monkeypatch):
    """Direct transport evidence of a new incarnation un-declares a
    locally-held death — under selfheal the runtime's dead window can be
    shorter than a detector poll period, so the poll diff alone may
    never observe the revival."""
    pml_ft = pkg.ft.pml_ft

    pml = _mk_pml(pkg, monkeypatch)
    try:
        ft = pml_ft(pml)
        ft.detector.mark_failed(1, "gossip: test")
        revived = []
        ft.detector.add_revive_listener(revived.append)
        ft.on_ft_frame(1, {"t": "ft", "op": "beat", "ep": 1, "v": {},
                           "n": 0, "si": 1})
        assert not ft.detector.is_dead(1, poll=False)
        assert revived == [1]
    finally:
        pml.close()


def test_adopt_resets_gossip_entry_without_local_death(pkg, monkeypatch):
    """A survivor that never observed the (short) dead window still
    holds the dead life's high gossip epoch and stale clock — the adopt
    itself must reset the entry, or the healthy new life (whose epochs
    restart at 0 and can never transitively pass the stale high one)
    would be re-declared a window later and SIGKILLed."""
    pml_ft = pkg.ft.pml_ft

    pml = _mk_pml(pkg, monkeypatch)
    try:
        ft = pml_ft(pml)
        # dead life's view: epoch 50, last advance long ago; this rank
        # never declared the death (not in the detector)
        ft._beats[1] = [50, time.monotonic() - 100.0]
        assert not ft.detector.is_dead(1, poll=False)
        # first frame from the new life (si=1): entry must reset
        ft.on_ft_frame(1, {"t": "ft", "op": "beat", "ep": 2, "v": {},
                           "n": 0, "si": 1})
        assert ft._beats[1][0] <= 2          # stale epoch 50 is gone
        assert ft._beats[1][1] > time.monotonic() - 1.0
        # once per life: a later beat must NOT re-reset (epochs advance)
        ft.on_ft_frame(1, {"t": "ft", "op": "beat", "ep": 7, "v": {},
                           "n": 0, "si": 1})
        assert ft._beats[1][0] == 7
    finally:
        pml.close()


def test_stale_third_party_view_cannot_repoison_reset_entry(pkg, monkeypatch):
    """After the once-per-life reset, an in-flight view from a
    not-yet-adopted survivor carries the DEAD life's high epoch — the
    cross-life merge must ignore it (it would pin the entry above the
    new life's restarted epochs and wipe the boot grace), while
    same-life views keep merging and a NEWER-life view spreads the
    revival transitively."""
    pml_ft = pkg.ft.pml_ft

    pml = _mk_pml(pkg, monkeypatch)
    try:
        ft = pml_ft(pml)
        # rank 2 was adopted as life 1; its entry was reset
        ft.peer_reincarnated(2, 1)
        ft._beats[2] = [3, time.monotonic() + 4.0]   # boot-graced, epoch 3
        graced = ft._beats[2][1]
        # stale view from peer 1 (life-0 epoch 50): must not merge
        ft.on_ft_frame(1, {"t": "ft", "op": "beat", "ep": 1,
                           "v": {2: [50, 0]}, "n": 0})
        assert ft._beats[2][0] == 3
        assert ft._beats[2][1] == graced      # boot grace intact
        # same-life view advances the epoch without pulling the clock back
        ft.on_ft_frame(1, {"t": "ft", "op": "beat", "ep": 2,
                           "v": {2: [5, 1]}, "n": 0})
        assert ft._beats[2][0] == 5
        assert ft._beats[2][1] >= graced
        # a newer-life view is transitive revival evidence: entry resets
        ft.detector.mark_failed(2, "test")
        ft.on_ft_frame(1, {"t": "ft", "op": "beat", "ep": 3,
                           "v": {2: [9, 2]}, "n": 0})
        assert ft._gossip_inc[2] == 2
        assert ft._beats[2][0] == 0           # fresh life, fresh clock
        assert not ft.detector.is_dead(2, poll=False)
    finally:
        pml.close()


def test_si_stamped_data_frame_revives_locally_dead_peer(pkg, native, monkeypatch):
    """An si-stamped DATA frame can outrun the rebind frame across
    transports — it is the same revival evidence and must un-declare a
    locally-held death (else the one-shot msglog replay event fires
    against a still-poisoned detector and is lost for good)."""
    pml_ft = pkg.ft.pml_ft

    pml = _mk_pml(pkg, monkeypatch)
    try:
        ft = pml_ft(pml)
        ft.detector.mark_failed(1, "gossip: test")
        pml._on_frame(1, {"t": "eager", "tag": 0, "cid": 0, "seq": 0,
                          "dt": "<f8", "elems": 1, "shp": [1], "si": 1},
                      b"\x00" * 8)
        assert not ft.detector.is_dead(1, poll=False)
        assert pml._peer_inc[1] == 1
    finally:
        pml.close()


# -- stale failure reports (the racing-reporter kill loop) -------------------

def test_stale_failure_report_cannot_kill_the_new_life(pkg):
    pmix = pkg.pmix

    server = pmix.PMIxServer(size=3)
    try:
        reaped = []
        server.on_failed_report = lambda r, reason: reaped.append(r)
        client = pmix.PMIxClient(uri=server.uri, rank=0, size=3)
        # first reporter: fresh — the launcher hook reaps, then revives
        client.report_failed(2, "gossip: silent", incarnation=0)
        assert reaped == [2]
        server.proc_revived(2, incarnation=1)
        # second reporter raced: its evidence is about the DEAD life —
        # it must neither re-poison the dead-set nor re-reap (which
        # would SIGKILL the freshly-revived pid)
        client.report_failed(2, "gossip: silent", incarnation=0)
        assert reaped == [2]
        assert 2 not in client.failed_ranks()
        # a report about the CURRENT life is a real (new) failure
        client.report_failed(2, "gossip: silent again", incarnation=1)
        assert reaped == [2, 2]
        client.finalize()
    finally:
        server.close()


def test_report_about_cleanly_finished_rank_is_ignored(pkg):
    """A finished rank's beats stop with its transports — a late gossip
    suspicion about it is completion, not failure: no dead-set poison,
    no reap of the recycled pid slot."""
    pmix = pkg.pmix

    server = pmix.PMIxServer(size=2)
    try:
        reaped = []
        server.on_failed_report = lambda r, reason: reaped.append(r)
        client = pmix.PMIxClient(uri=server.uri, rank=0, size=2)
        server.proc_finished(1)
        client.report_failed(1, "gossip: silent", incarnation=0)
        assert reaped == []
        assert 1 not in client.failed_ranks()
        client.finalize()
    finally:
        server.close()


def test_boot_wedged_life_is_rereapable(pkg):
    """A revived life that wedges BEFORE registering can never announce
    its incarnation, so every survivor report stays stamped with the
    dead life's — after pmix_register_grace_s those reports must be
    accepted (the wedged pid is re-reaped) instead of dropped forever,
    which would stall the job on an unreapable corpse."""
    pmix = pkg.pmix

    server = pmix.PMIxServer(size=3)
    try:
        reaped = []
        server.on_failed_report = lambda r, reason: reaped.append(r)
        client = pmix.PMIxClient(uri=server.uri, rank=0, size=3)
        server.proc_revived(2, incarnation=1)
        # inside the grace window: boot may still be in progress — a
        # stale-incarnation report is dropped like any other
        client.report_failed(2, "gossip: silent", incarnation=0)
        assert reaped == []
        # grace expired and life 1 never registered: boot-wedged — the
        # same stale-stamped report now reaps it
        server._revived_at[2] -= (
            pkg.vars.get("pmix_register_grace_s") + 1.0)
        client.report_failed(2, "gossip: silent", incarnation=0)
        assert reaped == [2]
        # a REGISTERED life whose incarnation still never reached the
        # reporter is the other wedge (hung between reg and its
        # announce/beats): within grace old-life evidence stays fenced
        # (boot may be in progress) ...
        server.proc_revived(2, incarnation=2)
        c2 = pmix.PMIxClient(uri=server.uri, rank=2, size=3)
        assert client.report_failed(2, "gossip: old evidence",
                                    incarnation=1) == "stale"
        assert reaped == [2]
        # ...but past grace the report is accepted — dropping it forever
        # would leave an announce-wedged pid unreapable
        server._revived_at[2] -= (
            pkg.vars.get("pmix_register_grace_s") + 1.0)
        client.report_failed(2, "gossip: old evidence", incarnation=1)
        assert reaped == [2, 2]
        c2.finalize()
        client.finalize()
    finally:
        server.close()


def test_adopted_life_closes_wedge_escape(pkg):
    """Once any survivor reports having adopted a revived life's
    incarnation, that life provably announced — it cannot be
    boot-wedged, so a stale-incarnation report arriving long after
    grace (a partitioned reporter, or an arena probe on the dead
    life's cached pid) must stay dropped instead of SIGKILLing the
    long-healthy rank."""
    pmix = pkg.pmix

    server = pmix.PMIxServer(size=3)
    try:
        reaped = []
        server.on_failed_report = lambda r, reason: reaped.append(r)
        client = pmix.PMIxClient(uri=server.uri, rank=0, size=3)
        server.proc_revived(2, incarnation=1)
        client.peer_adopted(2, 1)   # a survivor saw the new life announce
        # hours past grace: without the adoption close this would be
        # the "wedged" arm and reap the healthy pid
        server._revived_at[2] -= (
            pkg.vars.get("pmix_register_grace_s") + 3600.0)
        assert client.report_failed(
            2, "arena: cached dead-life pid", incarnation=0) == "stale"
        assert reaped == []
        # a report about the CURRENT life is a real (new) failure
        client.report_failed(2, "gossip: silent again", incarnation=1)
        assert reaped == [2]
        # the adoption is per-life: the NEXT life reopens the escape
        server.proc_revived(2, incarnation=2)
        server._revived_at[2] -= (
            pkg.vars.get("pmix_register_grace_s") + 1.0)
        client.report_failed(2, "gossip: silent", incarnation=1)
        assert reaped == [2, 2]
        client.finalize()
    finally:
        server.close()


def test_register_grace_zero_disables_wedge_escape(pkg):
    """grace == 0 turns the wedge escape off entirely: stale reports
    always drop, no matter how long ago the revive was.  An always-open
    escape (the grace > 0 precondition missing) would let any racing
    stale report SIGKILL a legitimately booting revived rank."""
    pmix = pkg.pmix

    server = pmix.PMIxServer(size=3)
    old = pkg.vars.get("pmix_register_grace_s")
    pkg.vars.set("pmix_register_grace_s", 0.0)
    try:
        reaped = []
        server.on_failed_report = lambda r, reason: reaped.append(r)
        client = pmix.PMIxClient(uri=server.uri, rank=0, size=3)
        server.proc_revived(2, incarnation=1)
        # far past any plausible boot window — with grace armed this
        # would be the boot-wedged arm; disabled, it must stay fenced
        server._revived_at[2] -= 3600.0
        assert client.report_failed(
            2, "gossip: silent", incarnation=0) == "stale"
        assert reaped == []
        client.finalize()
    finally:
        pkg.vars.set("pmix_register_grace_s", old)
        server.close()


def test_stale_gated_report_is_remembered_for_retry(pkg):
    """A push the server stale-gated is kept (stale_reported) so the
    gossip loop can re-push it — the one-shot declare has already
    fired, and if the revived life wedges nobody else will ever
    re-report it.  An accepted push, or new-incarnation evidence
    reviving the rank locally, clears the retry slot."""
    FailureDetector = pkg.ft.FailureDetector

    class _StubClient:
        def __init__(self):
            self.verdict = "stale"
            self.pushes = []

        def report_failed(self, rank, reason, incarnation=0):
            self.pushes.append((rank, incarnation))
            return self.verdict

    det = FailureDetector()
    det._client = stub = _StubClient()
    det.mark_failed(3, "gossip: rank silent")
    assert det.report_to_runtime(3, "gossip: rank silent", 0)
    assert det.stale_reported() == {3}      # gated → queued for retry
    # the retry the gossip loop issues finally lands (wedge escape):
    # the verdict is no longer stale and the slot clears
    stub.verdict = None
    assert det.report_to_runtime(3, "gossip: retry", 0)
    assert det.stale_reported() == set()
    # gated again, then the rank revives on new-incarnation evidence:
    # the pending retry must die with the old life's suspicion
    stub.verdict = "stale"
    det.report_to_runtime(3, "gossip: rank silent", 0)
    assert det.stale_reported() == {3}
    det.revive(3)
    assert det.stale_reported() == set()
    assert stub.pushes == [(3, 0)] * 3


def test_poll_cannot_remark_a_raced_revive(pkg):
    """A direct-evidence revive landing while a runtime poll's RPC is in
    flight must not be undone by the (stale) reply: re-marking would
    fail pending ops toward the healthy new life for a poll period and,
    mid msglog auto-replay, lose the one-shot replay for good."""
    FailureDetector = pkg.ft.FailureDetector

    det = FailureDetector()

    class _RacingClient:
        calls = 0

        def failed_ranks(self):
            self.calls += 1
            if self.calls == 1:
                # the new life's si frame arrives mid-RPC
                det.revive(2)
                return {2: "runtime-declared"}
            return {}

    det._client = stub = _RacingClient()
    det.mark_failed(2, "gossip: test")
    revives = []
    det.add_revive_listener(revives.append)
    det.poll_runtime(force=True)
    assert not det.is_dead(2, poll=False)   # the stale reply lost
    assert 2 not in det._runtime_marked     # and left no baseline entry
    det.poll_runtime(force=True)            # server clears the rank:
    assert revives == [2]                   # no second revive event
    assert stub.calls == 2


def test_adopt_notices_ride_poll_hook_and_requeue_on_failure(pkg):
    """peer_reincarnated runs on transport reader threads, so the
    adoption notice is queued, not pushed — the detector poll (and the
    gossip loop) drains it; a failed push is re-queued, because the
    notice must eventually close the server's wedge escape."""
    pml_ft = pkg.ft.pml_ft

    class _Client:
        def __init__(self):
            self.adopted = []
            self.fail_next = True

        def failed_ranks(self):
            return {}

        def peer_adopted(self, rank, inc):
            if self.fail_next:
                self.fail_next = False
                raise OSError("control plane hiccup")
            self.adopted.append((rank, inc))

    pml = None
    try:
        PmlOb1 = pkg.pml.PmlOb1

        pml = PmlOb1(0)
        ft = pml_ft(pml)
        ft.detector._client = client = _Client()
        ft.peer_reincarnated(1, 2)
        assert ft._adopt_notify == {1: 2}
        ft.detector.poll_runtime(force=True)   # push fails → re-queued
        assert client.adopted == [] and ft._adopt_notify == {1: 2}
        ft.detector.poll_runtime(force=True)   # retry lands
        assert client.adopted == [(1, 2)] and ft._adopt_notify == {}
        # once per life: a repeat adopt of the same life queues nothing
        ft.peer_reincarnated(1, 2)
        assert ft._adopt_notify == {}
    finally:
        if pml is not None:
            pml.close()


def test_stale_reannounce_cannot_cancel_a_real_death(pkg, native, monkeypatch):
    """Rebind frames are also the rate-limited fence-heal re-announce of
    an ESTABLISHED life — an in-flight one from a life that has since
    been declared hung must not un-declare the (newer) suspicion, nor
    cancel its stale-gated wedge-escape retry.  Only the adopt
    TRANSITION (a NEW life's rebind) is revival evidence, exactly like
    the si paths."""
    pml_ft = pkg.ft.pml_ft

    pml = _mk_pml(pkg, monkeypatch)
    try:
        ft = pml_ft(pml)
        pml._peer_inc[1] = 1           # peer's life 1 already adopted
        ft._gossip_inc[1] = 1
        ft.detector.mark_failed(1, "gossip: silent")   # ...then it hung
        # an in-flight re-announce from life 1 (inc == known)
        pml._on_frame(1, {"t": "rebind", "card": pml.address, "inc": 1},
                      b"")
        assert ft.detector.is_dead(1, poll=False)      # suspicion stands
        # the NEXT life's rebind is real revival evidence
        pml._on_frame(1, {"t": "rebind", "card": pml.address, "inc": 2},
                      b"")
        assert not ft.detector.is_dead(1, poll=False)
    finally:
        pml.close()


def test_transitive_adopter_stamps_reports_with_gossip_inc(pkg, monkeypatch):
    """A survivor that adopted a new life only TRANSITIVELY (third-party
    beat view → peer_reincarnated) has no direct evidence in
    pml._peer_inc — its failure reports must still carry the adopted
    life: its own 'adopted' push closed the server's wedge escape, so a
    0-stamped report about a later-wedged life would be stale-gated
    forever and the hung pid unreapable."""
    pml_ft = pkg.ft.pml_ft

    class _Client:
        def __init__(self):
            self.pushes = []

        def report_failed(self, rank, reason, incarnation=0):
            self.pushes.append((rank, incarnation))
            return None

        def failed_ranks(self):
            return {}

        def peer_adopted(self, rank, inc):
            pass

    pml = _mk_pml(pkg, monkeypatch)
    try:
        ft = pml_ft(pml)
        ft.detector._client = client = _Client()
        ft.peer_reincarnated(1, 2)            # a beat view named life 2
        assert pml._peer_inc.get(1, 0) == 0   # no direct evidence
        assert ft.adopted_inc(1) == 2         # ...but adopted all the same
        ft._gossip_declare(1, 9.9)
        assert client.pushes == [(1, 2)]
    finally:
        pml.close()


def test_internal_typeerror_is_not_mistaken_for_legacy_client(pkg):
    """The legacy-surface probe (no incarnation parameter) reads the
    client's signature once — a TypeError raised INSIDE a modern
    client's report_failed must surface as a failed push, not trigger
    a duplicate 2-arg re-send."""
    FailureDetector = pkg.ft.FailureDetector

    class _ModernButBroken:
        def __init__(self):
            self.pushes = 0

        def report_failed(self, rank, reason, incarnation=0):
            self.pushes += 1
            raise TypeError("unpackable reason object")   # internal bug

    class _Legacy:
        def __init__(self):
            self.pushes = []

        def report_failed(self, rank, reason):   # no incarnation param
            self.pushes.append((rank, reason))
            return None

    det = FailureDetector()
    det._client = broken = _ModernButBroken()
    assert det.report_to_runtime(3, "gossip: silent", 1) is False
    assert broken.pushes == 1   # no double-send
    # a genuinely legacy surface is detected from the signature and
    # called without the incarnation argument
    det2 = FailureDetector()
    det2._client = legacy = _Legacy()
    assert det2.report_to_runtime(3, "gossip: silent", 1)
    assert legacy.pushes == [(3, "gossip: silent")]


def test_registration_fires_contact_hook_once_per_life(pkg):
    """The 'reg' a PMIxClient sends at construction starts the errmgr
    governor's uptime clock — once per life, re-armed by a revive."""
    pmix = pkg.pmix

    server = pmix.PMIxServer(size=3)
    try:
        contacts = []
        server.on_client_contact = contacts.append
        c_a = pmix.PMIxClient(uri=server.uri, rank=0, size=3)
        assert contacts == [0]
        # a duplicate registration of the same life does not re-fire
        c_b = pmix.PMIxClient(uri=server.uri, rank=0, size=3)
        assert contacts == [0]
        # a revive opens a new life: its registration fires again
        server.proc_revived(0, incarnation=1)
        c_c = pmix.PMIxClient(uri=server.uri, rank=0, size=3)
        assert contacts == [0, 0]
        for c in (c_a, c_b, c_c):
            c.finalize()
    finally:
        server.close()


def test_pmix_revive_drops_the_dead_life_doctor_port(pkg):
    pmix = pkg.pmix
    server = pmix.PMIxServer(size=2)
    try:
        client = pmix.PMIxClient(uri=server.uri, rank=0, size=2)
        client.register_doctor(4242)
        assert client.doctor_ports() == {0: 4242}
        assert pmix.query_doctor_ports(server.uri) == {0: 4242}
        # a revive drops the dead life's port until re-registration
        server.proc_revived(0)
        assert pmix.query_doctor_ports(server.uri) == {}
        client.finalize()
    finally:
        server.close()


# -- integration: the full cycle under the local launcher --------------------

SELFHEAL_APP = r"""
import os, time
import numpy as np
import ompi_tpu_torch
from ompi_tpu_torch.ckpt import snapc
from ompi_tpu_torch.ckpt.msglog import MessageLog
from ompi_tpu_torch.ckpt.store import SnapshotStore
from ompi_tpu_torch.mpi.constants import ERR_PROC_FAILED, MPIException

comm = ompi_tpu_torch.init()
rank, size = comm.rank, comm.size
store = SnapshotStore(os.environ["CKPT_DIR"], job=f"rank{rank}")
log = MessageLog(comm).attach(auto_replay=True)

start, acc = 0, 0.0
restored = snapc.auto_restore(comm, store, rank=0)
if restored is not None:
    seq, state = restored
    start, acc = int(state["step"]) + 1, float(state["acc"])
    print(f"rank {rank} resumed at step {start} from snapshot {seq}",
          flush=True)

def heal_retry(fn):
    while True:
        try:
            return fn()
        except MPIException as e:
            if e.error_class != ERR_PROC_FAILED:
                raise
            time.sleep(0.1)

right, left = (rank + 1) % size, (rank - 1) % size
for step in range(start, 5):
    out = np.array([float(rank * 100 + step)])
    heal_retry(lambda: comm.isend(out, dest=right, tag=step).wait())
    got = heal_retry(lambda: comm.recv(source=left, tag=step))
    assert float(got[0]) == left * 100 + step, (step, got)
    acc += float(got[0])
    store.write_rank(step, 0, {"step": np.int64(step),
                               "acc": np.float64(acc)})
    store.commit(step, 1)
    if rank == 1 and step == 2 and not snapc.restart_incarnation():
        os._exit(9)   # die AFTER committing snapshot 2

print(f"rank {rank} selfheal done acc={acc:.0f}", flush=True)
ompi_tpu_torch.finalize()
"""


def test_selfheal_revives_and_converges(tmp_path):
    """Kill → propagate → revive → snapshot restore → msglog replay →
    incarnation-fenced rejoin, end to end on the local launcher; the
    ring converges to the full-world answer."""
    r = tpurun("-np", "3", "--mca", "errmgr", "selfheal", "--",
               sys.executable, "-c", SELFHEAL_APP,
               env_extra={"CKPT_DIR": str(tmp_path)})
    out = r.stdout + r.stderr
    assert r.returncode == 0, out[-3000:]
    assert "rank 1 resumed at step 3 from snapshot 2" in out, out[-3000:]
    for rank in range(3):
        left = (rank - 1) % 3
        acc = sum(left * 100 + s for s in range(5))
        assert f"rank {rank} selfheal done acc={acc:.0f}" in out, \
            (rank, out[-3000:])


def test_selfheal_crashloop_escalates_job_survives(tmp_path):
    """A rank that dies at the same step in every life exhausts the
    (min-uptime-gated) revive budget and the ladder degrades to shrink:
    survivors finish, the job exits 0, and the revive/escalation event
    counts are exact."""
    prog = ("import os, time, ompi_tpu_torch\n"
            "from ompi_tpu_torch.testing import faultinject\n"
            "comm = ompi_tpu_torch.init()\n"
            "for step in range(5):\n"
            "    faultinject.step()\n"
            "    time.sleep(0.2)\n"
            "print(f'rank {comm.rank} done', flush=True)\n"
            "ompi_tpu_torch.finalize()\n")
    r = tpurun("-np", "2", "--mca", "errmgr", "selfheal",
               "--mca", "errmgr_max_restarts", "1",
               "--mca", "errmgr_min_uptime_s", "60",
               "--mca", "faultinject_plan", "rank=1:crash@step=1", "--",
               sys.executable, "-c", prog,
               env_extra={"CKPT_DIR": str(tmp_path)})
    out = r.stdout + r.stderr
    assert r.returncode == 0, out[-3000:]
    assert "rank 0 done" in out, out[-3000:]
    assert "rank 1 done" not in out, out[-3000:]
    assert out.count("selfheal revive") == 1, out[-3000:]
    assert "selfheal-escalate" in out and "degrading to shrink" in out, \
        out[-3000:]
