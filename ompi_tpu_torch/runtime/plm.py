"""PLM — process lifecycle management: launching the daemon VM (the port's
copy of the JAX package's ``runtime/plm.py``, whole).

≈ orte/mca/plm (plm_rsh_module.c:102,697: the ssh tree-spawn) plus the HNP
launch logic of plm_base_launch_support.c.  Components start one orted per
allocated node; the :class:`MultiHostLauncher` drives the full job DAG
(clone of state_hnp.c:74-112):

    INIT → ALLOCATE → MAP → LAUNCH_DAEMONS → VM_READY → LAUNCH_APPS
         → RUNNING → TERMINATED/ABORTED

Components:

- ``sim`` — daemons are local child processes with simulated host
  identities (``--fake-host sim-host-N``): the multi-host control plane,
  modex routing, IOF tree, and cross-"host" data paths all run for real on
  one machine (ranks on different sim-hosts refuse shm and ride tcp).
  This is the test fixture the reference gets from ras_sim + rsh on
  localhost.
- ``ssh`` — real remote spawn over ssh (non-interactive auth assumed,
  exactly plm/rsh's contract): one daemon per host of the hostfile; app
  procs then bind their local cards.

The port's device plane: under ``want_gpu`` (``tpurun --plm sim --gpu``)
the nodes share out this machine's cards (the ``simulator`` RAS), the
orted gives each rank its card, and the HNP exports the rendezvous of
the job's ``torch.distributed`` process group (``OMPI_TPU_COORD``, where
rank 0 serves it, and ``OMPI_TPU_NHOSTS``) as the local launcher does.
``sim`` probes a free port on 127.0.0.1; ``ssh`` derives one from the
jobid, since the HNP cannot probe rank 0's host.  A job without
``want_gpu`` gets no rendezvous, and its HNP imports no torch.  A revived
life keeps its card and gets no rendezvous (``runtime/orted.py``).

``timeout`` is mpirun's ``--timeout``: past it the job is killed through
the tree and :meth:`MultiHostLauncher.run` gives 124, as the local
launcher does.
"""

from __future__ import annotations

import os
import shlex
import subprocess
import sys
import threading
import time
from typing import Optional

from ompi_tpu_torch.core import output
from ompi_tpu_torch.core.config import VarType, register_var, var_registry
from ompi_tpu_torch.core.mca import Component, Framework
from ompi_tpu_torch.runtime import clocksync
from ompi_tpu_torch.runtime import errmgr as errmgr_mod
from ompi_tpu_torch.runtime import launcher as _launcher  # launcher_* vars
from ompi_tpu_torch.runtime import pmix, ras, rmaps, rml
from ompi_tpu_torch.runtime.job import Job, JobState, Proc, ProcState
from ompi_tpu_torch.runtime.state import StateMachine

__all__ = ["plm_framework", "MultiHostLauncher"]

_log = output.get_stream("plm")

plm_framework = Framework("plm", "process lifecycle management")

register_var("plm", "daemon_timeout", VarType.DOUBLE, 30.0,
             "seconds to wait for daemons to phone home / wire up")
register_var("plm", "ssh_args", VarType.STRING,
             "-o BatchMode=yes -o StrictHostKeyChecking=no",
             "extra arguments for the ssh transport")
register_var("plm", "ssh_python", VarType.STRING, "",
             "python interpreter to exec on remote hosts (empty = same "
             "path as the HNP's sys.executable)")
register_var("plm", "exit_report_timeout", VarType.DOUBLE, 3.0,
             "seconds to wait for straggler rank-exit reports during "
             "teardown (VM stop mid-job, daemon loss) before accounting "
             "the job without them")
register_var("plm", "loss_epoch_window", VarType.DOUBLE, 0.25,
             "seconds the HNP's reparent worker waits after a daemon "
             "death for more deaths to join the same loss epoch — a "
             "correlated rack loss collapses into ONE batched adoption "
             "round (O(orphans) frames) instead of a per-dead-vpid "
             "storm (0 = handle each death immediately)")
register_var("plm", "daemon_drain_timeout", VarType.DOUBLE, 5.0,
             "seconds the VM teardown waits for orted daemons to exit "
             "after the SHUTDOWN xcast before killing them")


def _orted_env() -> dict:
    """The daemon's environment: this one, with the package importable
    whatever the daemon's cwd (≈ plm_rsh prefixing its install dirs)."""
    env = dict(os.environ)
    root = _launcher._pkg_root()
    pypath = env.get("PYTHONPATH", "")
    if root not in pypath.split(os.pathsep):
        env["PYTHONPATH"] = root + (os.pathsep + pypath if pypath else "")
    return env


def _orted_argv(hnp_uri: str, vpid: int, ndaemons: int,
                fake_host: Optional[str] = None) -> list[str]:
    argv = [sys.executable, "-m", "ompi_tpu_torch.runtime.orted",
            "--hnp", hnp_uri, "--vpid", str(vpid),
            "--ndaemons", str(ndaemons)]
    if fake_host:
        argv += ["--fake-host", fake_host]
    return argv


@plm_framework.component
class SimPlm(Component):
    """Local daemon processes with simulated host identities."""

    NAME = "sim"
    PRIORITY = 10

    def spawn_daemons(self, job: Job, hnp_uri: str) -> list[subprocess.Popen]:
        procs = []
        for i, node in enumerate(job.nodes):
            argv = _orted_argv(hnp_uri, i + 1, len(job.nodes) + 1,
                               fake_host=node.name)
            procs.append(subprocess.Popen(
                argv, env=_orted_env(), start_new_session=True))
        return procs


@plm_framework.component
class SshPlm(Component):
    """≈ plm/rsh: 'ssh <node> orted ...' per allocated host."""

    NAME = "ssh"
    PRIORITY = 20

    def query(self, **ctx):
        return self.PRIORITY if ctx.get("remote_hosts") else None

    def spawn_daemons(self, job: Job, hnp_uri: str) -> list[subprocess.Popen]:
        ssh_args = shlex.split(var_registry.get("plm_ssh_args") or "")
        # ≈ plm_rsh prefixing PATH/LD_LIBRARY_PATH on the remote command
        # (plm_rsh_module.c): env does NOT travel over ssh, so the remote
        # python must be told where this framework lives (same-path
        # assumption for the interpreter itself — shared-filesystem
        # clusters; override the interpreter via plm_ssh_python).
        pkg_root = _launcher._pkg_root

        procs = []
        for i, node in enumerate(job.nodes):
            orted = _orted_argv(hnp_uri, i + 1, len(job.nodes) + 1)
            py = var_registry.get("plm_ssh_python") or orted[0]
            remote = (f"PYTHONPATH={shlex.quote(pkg_root())}"
                      "${PYTHONPATH:+:$PYTHONPATH} "
                      + " ".join(shlex.quote(a) for a in [py, *orted[1:]]))
            argv = ["ssh", *ssh_args, node.name, remote]
            procs.append(subprocess.Popen(
                argv, env=dict(os.environ), start_new_session=True))
        return procs


class MultiHostLauncher:
    """The HNP for a daemon-tree launch (≈ orterun driving state_hnp)."""

    def __init__(self, plm_name: str = "sim", want_gpu: bool = False,
                 stdin_target: str = "none",
                 timeout: Optional[float] = None, **select_ctx) -> None:
        self.want_gpu = want_gpu
        # mpirun --timeout: past it the job is killed and run() gives 124
        self.timeout = timeout
        self.timed_out = False
        # validate before any daemon exists: a bad --stdin must fail the
        # CLI, not blow up the state machine mid-launch
        if stdin_target not in ("all", "none") and not str(stdin_target).isdigit():
            raise ValueError(
                f"--stdin must be a rank number, 'all' or 'none' "
                f"(got {stdin_target!r})")
        self.stdin_target = str(stdin_target)
        self.select_ctx = select_ctx
        self.plm = plm_framework.lookup(plm_name)
        self.sm = StateMachine()
        self.sm.add_state(JobState.INIT, lambda sm, job: JobState.ALLOCATE)
        self.sm.add_state(JobState.ALLOCATE, self._st_allocate)
        self.sm.add_state(JobState.MAP, self._st_map)
        self.sm.add_state(JobState.LAUNCH_APPS, self._st_launch)
        self.sm.add_state(JobState.RUNNING, self._st_running)
        self._errmgr = errmgr_mod.errmgr_framework.select(**select_ctx)
        self.rml: Optional[rml.RmlNode] = None
        self.server: Optional[pmix.PMIxServer] = None
        self._daemon_popen: list[subprocess.Popen] = []
        self._registered: dict[int, tuple[str, str]] = {}  # vpid→(uri,host)
        self._ready: set[int] = set()
        self._cv = threading.Condition()
        self._killed = False
        self._lost_daemon: Optional[int] = None            # vpid, if died
        self._dead_daemons: set[int] = set()   # every vpid ever declared
        # dead (link EOF / Popen / heartbeat / orphan report) — the
        # idempotence guard AND the ancestry map re-parenting skips over
        self._np_hint = 1 << 30                            # set at launch
        self._cur_job: Optional[Job] = None
        self._n_daemons = 0        # world size minus the HNP, set at _vm_up
        # the EFFECTIVE routing tree: vpid → current parent, seeded from
        # the static tree at wire time and rewritten by every adoption.
        # Loss epochs compute orphanhood against THIS map (not the static
        # tree), so a dead adopter's previously adopted children are
        # re-orphaned and re-homed — never left holding a child-link to
        # a corpse — and an already-re-homed orphan is never adopted twice
        self._eff_parent: dict[int, int] = {}
        # loss-epoch queue: detectors (link EOF on reader threads, the
        # heartbeat sweep, Popen polls, orphan reports) only ENQUEUE dead
        # vpids; one worker thread coalesces deaths within
        # plm_loss_epoch_window into a single batched adoption round.
        # Serializing epochs through one worker is also the concurrency
        # fix: overlapping subtree losses can no longer race two
        # _reparent_orphans bodies into double adoptions
        self._loss_cv = threading.Condition()
        self._loss_q: list[int] = []
        self._loss_worker: Optional[threading.Thread] = None
        #: reparent-storm telemetry, asserted by the simfleet tests: one
        #: epoch per correlated loss, frames bounded by
        #: orphans + adopter groups (strictly O(orphans))
        self.reparent_epochs_total = 0
        self.reparent_orphans_total = 0
        self.reparent_frames_total = 0
        # the standing allocation the daemon vpids index into (vpid =
        # pool index + 1) — job.nodes may be a gang-placed SUBSET of
        # these on a multi-tenant DVM, so vpid↔node lookups must never
        # go through job.nodes
        self._pool_nodes: list = []
        self._hnp_addr = "127.0.0.1"      # set by _vm_up
        # every job with apps launched and not yet retired, keyed by
        # jobid: the exit/IOF/doctor routers resolve payloads here (a
        # multi-tenant DVM runs several at once)
        self._jobs_by_id: dict[int, Job] = {}
        self._persistent = False          # DVM mode: VM outlives jobs
        self._vm_stop = threading.Event()
        self._hb_monitor: Optional[rml.HeartbeatMonitor] = None
        # terminal stage of the metrics uplink: TAG_METRICS deltas from
        # the daemon tree fold in here, keyed by jobid and rank — what
        # the DVM scrape endpoint and --dvm-ps read
        from ompi_tpu_torch.runtime.metrics import MetricsAggregate

        self.metrics_agg = MetricsAggregate()

    # -- state handlers ----------------------------------------------------

    def _st_allocate(self, sm: StateMachine, job: Job) -> JobState:
        ras.allocate(job, want_gpu=self.want_gpu, **self.select_ctx)
        return JobState.MAP

    def _st_map(self, sm: StateMachine, job: Job) -> JobState:
        rmaps.map_job(job, **self.select_ctx)
        return JobState.LAUNCH_APPS

    def _st_launch(self, sm: StateMachine, job: Job) -> Optional[JobState]:
        if not self._vm_up(job):
            return JobState.ABORTED
        self._launch_apps(job)
        return JobState.RUNNING

    def _vm_up(self, job: Job) -> bool:
        """LAUNCH_DAEMONS + VM_READY: spawn one orted per node and wire
        the routed tree.  The VM outlives a single job in DVM mode (≈
        orte-dvm), which is why this phase is separate from app launch."""
        n_daemons = len(job.nodes)
        self._np_hint = job.np
        self._cur_job = job
        self._pool_nodes = list(job.nodes)
        self._n_daemons = n_daemons
        # the address ranks dial the PMIx server at: resolved before any
        # daemon exists, so a host that cannot give one aborts cleanly
        try:
            self._hnp_addr = self._my_address()
        except RuntimeError as e:
            job.abort_reason = str(e)
            job.aborted_proc = job.procs[0]
            return False
        self.rml = rml.RmlNode(0)
        self.rml.register_recv(rml.TAG_REGISTER, self._on_register)
        self.rml.register_recv(rml.TAG_DAEMON_READY, self._on_ready)
        self.rml.register_recv(rml.TAG_IOF, self._on_iof)
        self.rml.register_recv(rml.TAG_PROC_EXIT, self._route_proc_exit)
        self.rml.register_recv(rml.TAG_ORPHANED, self._on_orphaned)
        self.rml.register_recv(rml.TAG_REPARENT_ACK, self._on_reparent_ack)
        self.rml.register_recv(rml.TAG_METRICS,
                               lambda o, p: self.metrics_agg.merge(p))
        # answer the daemons' clock-sync pingpongs: the HNP is the root
        # clock domain, so its offset-to-root is 0 by definition
        clocksync.install_responder(self.rml, lambda: 0)
        self.rml.on_peer_lost = self._on_daemon_lost
        # liveness beats (rml_heartbeat_period > 0): any beat — or any
        # other up-traffic from the daemon — refreshes its clock; silence
        # past rml_heartbeat_timeout is a daemon death the socket never
        # reported (hung host, half-open link)
        self._hb_monitor = rml.HeartbeatMonitor(self._on_daemon_lost)
        self.rml.register_recv(
            rml.TAG_HEARTBEAT,
            lambda o, vpid: self._hb_monitor.beat(vpid))

        self._daemon_popen = self.plm.spawn_daemons(job, self.rml.uri)
        threading.Thread(target=self._daemon_monitor, args=(job,),
                         daemon=True).start()
        timeout = var_registry.get("plm_daemon_timeout")
        with self._cv:
            ok = self._cv.wait_for(
                lambda: (len(self._registered) >= n_daemons
                         or self._lost_daemon is not None), timeout=timeout)
        if not ok or self._lost_daemon is not None:
            job.abort_reason = (
                f"daemon {self._lost_daemon} died during launch"
                if self._lost_daemon is not None else
                f"only {len(self._registered)}/{n_daemons} daemons "
                f"reported within {timeout}s")
            job.aborted_proc = job.procs[0]
            self.kill_job(job)
            return False

        # VM_READY: wire the routed tree (vpid 0 = me, 1..N = daemons).
        # Dial my own children BEFORE sending any WIRE: a daemon replies
        # DAEMON_READY up the tree, so its up-link must exist (orted also
        # gates the reply on wait_parent — belt and suspenders).
        total = n_daemons + 1
        with self._cv:
            self._eff_parent = {v: (rml.tree_parent(v) or 0)
                                for v in range(1, total)}
        uris = {0: self.rml.uri}
        uris.update({v: u for v, (u, _h) in self._registered.items()})
        self.rml.dial_children(
            [(c, uris[c]) for c in rml.tree_children(0, total)])
        # only the policies that survive a daemon death (notify, selfheal)
        # should have orphans wait for adoption instead of applying the
        # lifeline teardown — the flag rides the WIRE payload
        reparent = getattr(self._errmgr, "TOLERATES_DAEMON_LOSS", False)
        for v in range(1, total):
            children = [(c, uris[c]) for c in rml.tree_children(v, total)]
            self.rml.send_direct(self.rml.boot_links[v], rml.TAG_WIRE,
                                 {"children": children,
                                  "reparent": reparent})
        with self._cv:
            ok = self._cv.wait_for(
                lambda: (len(self._ready) >= n_daemons
                         or self._lost_daemon is not None), timeout=timeout)
        if not ok or self._lost_daemon is not None:
            job.abort_reason = (
                f"daemon {self._lost_daemon} died during tree wiring"
                if self._lost_daemon is not None
                else "daemon tree wiring timed out")
            job.aborted_proc = job.procs[0]
            self.kill_job(job)
            return False
        # daemons are wired: arm the liveness watchdog (no-op when
        # rml_heartbeat_period is 0) with its timeout scaled to this
        # world's tree depth — a 9-daemon timeout on a 1000-daemon world
        # declares healthy-but-busy daemons dead during a reparent wave
        self._hb_monitor.set_world(total)
        for vpid in self._registered:
            self._hb_monitor.watch(vpid)
        self._hb_monitor.start()
        if reparent and self._loss_worker is None:
            self._loss_worker = threading.Thread(
                target=self._loss_epoch_worker, name="plm-loss-epoch",
                daemon=True)
            self._loss_worker.start()
        return True

    def _node_vpid(self, node) -> int:
        """The daemon vpid owning a pool node (identity lookup against
        the STANDING allocation — a gang-placed job's job.nodes is a
        subset of the pool in arbitrary least-loaded order, so indexing
        job.nodes would address the wrong daemon)."""
        for i, n in enumerate(self._pool_nodes):
            if n is node:
                return i + 1
        return 0

    def _launch_apps(self, job: Job) -> None:
        """LAUNCH_APPS: fresh pmix rendezvous sized to this job, then one
        xcast with the whole map; daemons pick their rows."""
        self._cur_job = job
        self._np_hint = job.np
        job.exited = {}
        job.killed = False
        server = pmix.PMIxServer(
            size=job.np, host="0.0.0.0",
            on_abort=lambda r, s, m: self._on_abort(job, r, s, m))
        # rank-plane gossip feedback: a reported hung rank is reaped by
        # its owning daemon (TAG_KILL_RANK) so the exit report flows and
        # the errmgr policy runs — without this a SIGSTOP'd pid would
        # stall _wait_ranks forever
        server.on_failed_report = \
            lambda r, reason: self._reap_reported(job, r, reason)
        # uptime clock (errmgr crash-loop governor): starts at each
        # rank's PMIx registration so boot doesn't count toward
        # errmgr_min_uptime_s
        server.on_client_contact = \
            lambda r: self._mark_contact(job, r)
        # per-job rendezvous: concurrent tenants each get their own
        # server/port; self.server mirrors the latest for the non-DVM
        # single-job paths (and custom-launcher compat in errmgr)
        job.pmix_server = server
        self.server = server
        self._jobs_by_id[job.jobid] = job
        app = job.apps[0]
        env = dict(app.env)
        # the xcast env overlays the daemons' os.environ (orted merge
        # order), so the client's own environ counts as an explicit
        # user setting here
        errmgr_mod.apply_host_plane_policy(self._errmgr, env, os.environ)
        env[pmix.ENV_URI] = server.uri.replace("0.0.0.0", self._hnp_addr)
        env[pmix.ENV_SIZE] = str(job.np)
        env[pmix.ENV_JOBID] = str(job.jobid)
        if self.want_gpu:
            env.update(self._coord_env(job))
        by_daemon = []
        for node in job.nodes:
            rows = [(p.rank, p.local_rank,
                     None if p.chip is None else str(p.chip))
                    for p in job.procs_on(node)]
            by_daemon.append((self._node_vpid(node), rows))
        stdin_rank = (self.stdin_target if self.stdin_target in ("all",)
                      else None if self.stdin_target == "none"
                      else int(self.stdin_target))
        self.rml.xcast(rml.TAG_LAUNCH, {
            "jobid": job.jobid, "by_daemon": by_daemon, "argv": app.argv,
            "env": env, "cwd": app.cwd, "stdin_rank": stdin_rank})
        for p in job.procs:
            p.state = ProcState.RUNNING
        if stdin_rank is not None:
            self._start_stdin_pump(stdin_rank)

    def _wait_ranks(self, job: Job) -> None:
        """Block until every rank reported (or the VM lost a daemon)."""
        # A lost daemon is a lost lifeline (≈ ORTE aborting the job when an
        # orted dies): its ranks' PROC_EXIT reports are gone forever, so
        # waiting only on rank exits would hang.
        with self._cv:
            done = self._cv.wait_for(
                lambda: (len(job.exited) >= job.np
                         or self._lost_daemon is not None
                         or self._vm_stop.is_set()),
                timeout=self.timeout)
            lost = self._lost_daemon
        report_wait = var_registry.get("plm_exit_report_timeout")
        if not done:
            # mpirun --timeout: kill the job through the tree, give the
            # exit reports a moment, and account it aborted (exit 124)
            self.timed_out = True
            print(f"tpurun: job timed out after {self.timeout:g}s — "
                  f"aborting (mpirun --timeout semantics)",
                  file=sys.stderr, flush=True)
            if job.aborted_proc is None:
                job.abort_reason = f"timed out after {self.timeout:g}s"
                job.aborted_proc = job.procs[0]
            self.kill_job(job)
            with self._cv:
                self._cv.wait_for(lambda: len(job.exited) >= job.np,
                                  timeout=report_wait)
            return
        if self._vm_stop.is_set() and len(job.exited) < job.np:
            # VM shutdown ordered mid-job (DVM stop): ranks were killed
            # with the daemons; give their exit reports a moment, then
            # account the job as aborted rather than hanging forever
            with self._cv:
                self._cv.wait_for(lambda: len(job.exited) >= job.np,
                                  timeout=report_wait)
            if job.aborted_proc is None and len(job.exited) < job.np:
                job.abort_reason = "VM shut down while the job was running"
                job.aborted_proc = job.procs[0]
            return
        if lost is not None and len(job.exited) < job.np:
            if job.aborted_proc is None:
                job.abort_reason = (
                    f"daemon {lost} (host "
                    f"{self._registered.get(lost, ('?', '?'))[1]}) died "
                    f"before its ranks reported")
                job.aborted_proc = job.procs[0]
            self.kill_job(job)
            # best effort: wait only for ranks whose daemon still lives —
            # the dead daemon's ranks can never report
            lost_node = (self._pool_nodes[lost - 1]
                         if 0 < lost <= len(self._pool_nodes) else None)
            dead = ({p.rank for p in job.procs_on(lost_node)}
                    if lost_node is not None else set())
            alive = [p.rank for p in job.procs if p.rank not in dead]
            with self._cv:
                self._cv.wait_for(
                    lambda: all(r in job.exited for r in alive),
                    timeout=report_wait)

    def _teardown_vm(self) -> None:
        with self._cv:
            self._vm_stop.set()
            self._cv.notify_all()   # wake a _wait_ranks blocked mid-job
        with self._loss_cv:
            self._loss_cv.notify_all()  # release the loss-epoch worker
        if self._hb_monitor is not None:
            self._hb_monitor.stop()
        self.rml.xcast(rml.TAG_SHUTDOWN, None)
        deadline = (time.monotonic()
                    + var_registry.get("plm_daemon_drain_timeout"))
        for p in self._daemon_popen:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
        if self.server is not None:
            self.server.close()
        self.rml.close()

    def _st_running(self, sm: StateMachine, job: Job) -> JobState:
        self._wait_ranks(job)
        self._teardown_vm()
        return (JobState.ABORTED if job.aborted_proc is not None
                else JobState.TERMINATED)

    # -- rml handlers ------------------------------------------------------

    def _on_register(self, origin: int, payload) -> None:
        vpid, uri, hostname = payload
        with self._cv:
            self._registered[vpid] = (uri, hostname)
            self._cv.notify_all()

    def _on_ready(self, origin: int, payload) -> None:
        with self._cv:
            self._ready.add(payload)
            self._cv.notify_all()

    def _on_iof(self, origin: int, payload) -> None:
        _jobid, rank, stream, raw = payload
        sink = sys.stdout if stream == "out" else sys.stderr
        line = bytes(raw).decode(errors="replace")
        if var_registry.get("launcher_tag_output"):
            line = f"[mh,{rank}]{line}"
        sink.write(line)
        sink.flush()

    def _route_proc_exit(self, origin: int, payload) -> None:
        """TAG_PROC_EXIT router: resolve the owning job by jobid and feed
        the job-scoped handler.  A report for an already-retired job
        (raced with a jobid-scoped kill) is dropped — its submission has
        been accounted."""
        jobid, rank, rc, errmsg = payload
        with self._cv:
            job = self._jobs_by_id.get(int(jobid)) or self._cur_job
        if job is None or not (0 <= int(rank) < len(job.procs)):
            return
        self._on_proc_exit(job, (int(rank), rc, errmsg))

    def respawn_proc(self, job: Job, proc) -> bool:
        """errmgr/respawn hook for the daemon tree: xcast a revival order;
        the daemon owning the rank relaunches it with OMPI_TPU_RESTART.
        Spawn failure on the daemon surfaces as another TAG_PROC_EXIT
        (exit 127), which re-enters the errmgr until restarts exhaust."""
        from ompi_tpu_torch.runtime import ftevents

        proc.restarts += 1   # budget burn (governor may reset it)
        proc.lives += 1      # identity: monotone, survives budget resets
        # the revival order carries the rank's CURRENT placement: the
        # daemon whose vpid matches `target` adopts the row and spawns
        # (a remediation may have migrated proc.node to a less-loaded
        # host); every other daemon drops any stale row it still holds
        try:
            self.rml.xcast(rml.TAG_RESPAWN, {
                "jobid": job.jobid, "rank": proc.rank, "lives": proc.lives,
                "target": (self._node_vpid(proc.node)
                           if proc.node is not None else 0),
                "local_rank": proc.local_rank,
                "chip": None if proc.chip is None else str(proc.chip)})
        except Exception as e:  # noqa: BLE001 — tree may be tearing down
            _log.error("respawn xcast for rank %d failed: %r", proc.rank, e)
            return False
        ftevents.record("revive", jobid=job.jobid, rank=proc.rank,
                        lives=proc.lives)
        # only a successful revival order flips the state — a failed xcast
        # must leave ABORTED so _on_proc_exit records the exit (the job
        # would otherwise wait forever on a rank nobody revived)
        proc.exit_code = None
        proc.state = ProcState.RUNNING
        proc.launched_at = None  # stamped again at PMIx registration
        server = getattr(job, "pmix_server", None) or self.server
        if server is not None:
            server.proc_revived(proc.rank, proc.lives)
        return True

    def _on_proc_exit(self, job: Job, payload) -> None:
        rank, rc, errmsg = payload
        proc = job.procs[rank]
        proc.exit_code = rc
        server = getattr(job, "pmix_server", None) or self.server
        if proc.state == ProcState.KILLED_BY_CMD:
            pass
        elif rc == 0:
            proc.state = ProcState.TERMINATED
            # a clean finisher's stopped beats are completion, not a
            # hang — gate late gossip reports about it
            if server is not None:
                server.proc_finished(rank)
        else:
            proc.state = (ProcState.FAILED_TO_START if errmsg
                          else ProcState.ABORTED)
            if server is not None:
                server.proc_died(rank)
            self._errmgr.proc_failed(self, job, proc)
            if proc.state == ProcState.RUNNING:
                return  # errmgr revived the rank; its exit is yet to come
        with self._cv:
            job.exited[rank] = rc
            self._cv.notify_all()

    def _on_daemon_lost(self, vpid: int) -> None:
        """A daemon vanished: RML link EOF (crash/SIGKILL/host death),
        heartbeat silence (hung host, half-open link), or an orphan's
        report.  Under a daemon-loss-tolerant errmgr policy (notify,
        selfheal) the daemon's ranks become proc-failure events
        propagated to the survivors, its orphaned tree children re-wire
        to the nearest live ancestor, and the job continues; every other
        policy treats a lost daemon as a lost lifeline and aborts."""
        with self._cv:
            if vpid in self._dead_daemons:
                return  # several detectors race to the same corpse
            self._dead_daemons.add(vpid)
            cur = self._cur_job
            if self._killed or self._vm_stop.is_set() or (
                    not self._persistent and cur is not None
                    and len(cur.exited) >= self._np_hint):
                return  # normal teardown, not a failure
            # a multi-tenant pool may have several jobs with ranks on the
            # dead host — every one of them takes the loss (fall back to
            # the current job so the single-job path behaves as before)
            jobs = ([j for j in self._jobs_by_id.values()
                     if not j.killed] or
                    ([cur] if cur is not None else []))
            job = jobs[0] if jobs else None
            reparent = (getattr(self._errmgr, "TOLERATES_DAEMON_LOSS",
                                False)
                        and job is not None
                        and 0 < vpid <= len(self._pool_nodes))
            if reparent:
                for j in jobs:
                    self._fail_daemon_ranks(j, vpid)
            else:
                if self._lost_daemon is None:
                    self._lost_daemon = vpid
                self._cv.notify_all()
        from ompi_tpu_torch.runtime import ftevents

        ftevents.record("daemon_lost",
                        jobid=(job.jobid if reparent and job else 0),
                        vpid=vpid, contained=bool(reparent))
        if reparent:
            # confine the loss: the dead daemon's live children re-wire
            # to their grandparent instead of applying the lifeline rule.
            # Survivors are busy re-wiring for the next stretch — hold
            # heartbeat declarations so the wave itself cannot cascade
            # into false daemon deaths
            if self._hb_monitor is not None:
                window = float(
                    var_registry.get("plm_loss_epoch_window") or 0)
                self._hb_monitor.grace(1.0 + 2 * window)
            self._enqueue_loss(vpid)
            return
        from ompi_tpu_torch.runtime.notifier import Severity, notify

        notify(Severity.CRITICAL, "daemon-lost",
               f"orted vpid {vpid} vanished (host death/crash); "
               f"aborting the job")

    def _on_orphaned(self, origin: int, payload) -> None:
        """An orphan's bootstrap-link report: its tree parent's link hit
        EOF before any HNP-side detector fired — the fastest daemon-death
        signal there is, so feed it into the same (idempotent) path."""
        orphan, lost_parent = payload
        _log.verbose(1, "orted %d reports parent %d lost", orphan,
                     lost_parent)
        self._on_daemon_lost(int(lost_parent))

    def _enqueue_loss(self, vpid: int) -> None:
        """Hand a detected death to the loss-epoch worker (or, when no
        worker runs — direct unit-test drives of _on_daemon_lost — run a
        one-death epoch inline)."""
        if self._loss_worker is None:
            self._reparent_epoch({int(vpid)})
            return
        with self._loss_cv:
            self._loss_q.append(int(vpid))
            self._loss_cv.notify_all()

    def _loss_epoch_worker(self) -> None:
        """The single thread every adoption round runs on.  Detectors
        enqueue; this worker sleeps ``plm_loss_epoch_window`` after the
        first death of a round so a correlated loss (a rack dying in one
        tick, detected by N racing link EOFs / heartbeat expiries /
        orphan reports) collapses into ONE batched epoch.  The window is
        measured from the first death and is NOT extended by later ones
        — epoch latency stays bounded under a trickling failure."""
        while not self._vm_stop.is_set():
            with self._loss_cv:
                while not self._loss_q and not self._vm_stop.is_set():
                    self._loss_cv.wait(0.5)
                if self._vm_stop.is_set():
                    return
            window = float(var_registry.get("plm_loss_epoch_window") or 0)
            deadline = time.monotonic() + window
            with self._loss_cv:
                while True:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or self._vm_stop.is_set():
                        break
                    self._loss_cv.wait(remaining)
                batch = set(self._loss_q)
                self._loss_q.clear()
            if batch and not self._vm_stop.is_set():
                try:
                    self._reparent_epoch(batch)
                except Exception as e:  # noqa: BLE001 — worker survives
                    _log.error("reparent epoch for %s failed: %r",
                               sorted(batch), e)

    def _reparent_orphans(self, dead_vpid: int) -> None:
        """Compat shim: a single-death adoption round."""
        self._reparent_epoch({int(dead_vpid)})

    def _reparent_epoch(self, new_dead: set[int]) -> None:
        """One batched adoption round for a loss epoch: every live
        daemon whose EFFECTIVE parent is now dead gets exactly one
        TAG_REPARENT naming its new parent (the nearest live ancestor
        along the effective tree), and each adopter gets ONE TAG_ADOPT
        listing all its new children — total frames = orphans + adopter
        groups, O(orphans) regardless of how many daemons died at once.
        Deeper descendants keep their live links; only severed edges are
        rebuilt.  Orphanhood is computed against the effective-parent
        map (updated here on every adoption), so a dead ADOPTER's
        previously adopted children are re-homed and nobody is adopted
        twice — all epochs run serialized on the loss worker."""
        with self._cv:
            dead = set(self._dead_daemons) | set(new_dead)
            registered = dict(self._registered)
            eff = dict(self._eff_parent)
        orphans = sorted(v for v, p in eff.items()
                         if p in dead and v not in dead
                         and v in registered)
        if not orphans:
            return
        if self._hb_monitor is not None:
            # survivors re-wire now: no dead-declarations mid-round
            self._hb_monitor.grace(2.0)

        def live_ancestor(v: int) -> int:
            p = eff.get(v, 0)
            for _hop in range(len(eff) + 1):   # cycle-proof bound
                if p == 0 or p not in dead:
                    return p
                p = eff.get(p, 0)
            return 0

        by_adopter: dict[int, list[tuple[int, str]]] = {}
        frames = 0
        for o in orphans:
            adopter = live_ancestor(o)
            boot = self.rml.boot_links.get(o)
            if boot is None:
                continue
            try:
                self.rml.send_direct(boot, rml.TAG_REPARENT, adopter)
            except OSError as e:
                _log.error("reparent order to orted %d failed: %r", o, e)
                continue
            frames += 1
            by_adopter.setdefault(adopter, []).append(
                (o, registered[o][0]))
        if not by_adopter:
            return
        placed: dict[int, int] = {}   # orphan → adopter, orders sent
        for adopter, adoptees in sorted(by_adopter.items()):
            try:
                if adopter == 0:
                    self.rml.dial_children(adoptees)
                else:
                    aboot = self.rml.boot_links.get(adopter)
                    if aboot is None:
                        continue
                    self.rml.send_direct(aboot, rml.TAG_ADOPT, adoptees)
                    frames += 1
            except OSError as e:
                _log.error("adoption order under %d failed: %r",
                           adopter, e)
                continue
            for o, _u in adoptees:
                placed[o] = adopter
        with self._cv:
            self._eff_parent.update(placed)
        self.reparent_epochs_total += 1
        self.reparent_orphans_total += len(placed)
        self.reparent_frames_total += frames
        ordered = sorted(placed)
        adopters = sorted(by_adopter)
        _log.verbose(0, "re-parenting orteds %s under %s (epoch: vpids "
                     "%s died)", ordered, adopters, sorted(new_dead))
        from ompi_tpu_torch.mpi import trace as trace_mod

        if trace_mod.active:
            trace_mod.instant("errmgr", "reparent", rank=-1,
                              dead_vpid=min(new_dead),
                              dead=sorted(new_dead),
                              adopter=adopters[0], orphans=ordered)
        from ompi_tpu_torch.runtime import ftevents
        from ompi_tpu_torch.runtime.notifier import Severity, notify

        ftevents.record(
            "reparent",
            jobid=(self._cur_job.jobid if self._cur_job else 0),
            vpid=min(new_dead), dead=sorted(new_dead),
            adopter=adopters[0], adopters=adopters,
            orphans=ordered, frames=frames)
        notify(Severity.WARN, "daemon-reparent",
               f"orted vpid(s) {sorted(new_dead)} died mid-tree; orphans "
               f"{ordered} re-parented under vpid(s) {adopters} in one "
               f"batched round ({frames} frames; loss confined)")

    def _on_reparent_ack(self, origin: int, payload) -> None:
        vpid, new_parent = payload
        _log.verbose(1, "orted %d re-wired under %d", vpid, new_parent)

    def _mark_contact(self, job: Job, rank: int) -> None:
        """PMIx server hook: the rank's current life registered — start
        its uptime clock (errmgr_min_uptime_s measures from here)."""
        if job is not None and 0 <= rank < len(job.procs):
            job.procs[rank].launched_at = time.monotonic()

    def _reap_reported(self, job: Job, rank: int, reason: str) -> None:
        """Order the owning daemon to SIGKILL one reported-hung rank."""
        from ompi_tpu_torch.runtime import ftevents

        _log.verbose(1, "reaping reported-dead rank %d via the tree: %s",
                     rank, reason or "gossip-declared")
        ftevents.record(
            "reap", jobid=job.jobid,
            rank=rank, reason=reason or "gossip-declared")
        try:
            self.rml.xcast(rml.TAG_KILL_RANK, (job.jobid, rank))
        except Exception as e:  # noqa: BLE001 — tree may be tearing down
            _log.error("kill-rank xcast for %d failed: %r", rank, e)

    def _fail_daemon_ranks(self, job: Job, vpid: int) -> None:
        """With self._cv held: a dead daemon's ranks can never report —
        declare each of them failed NOW (the errmgr policy propagates
        each death to the survivors) and record synthetic exits so
        _wait_ranks completes on the survivors alone."""
        node = self._pool_nodes[vpid - 1]
        victims = [p for p in job.procs_on(node)
                   if p.rank not in job.exited]
        server = getattr(job, "pmix_server", None) or self.server
        for proc in victims:
            proc.state = ProcState.ABORTED
            proc.exit_code = -9
            # no revival order can reach a rank whose daemon died with
            # its host — a reviving policy (selfheal) must degrade to
            # its shrink rung instead of marking the rank RUNNING and
            # waiting forever on an exit that cannot come
            proc.daemon_lost = True
            if server is not None:
                server.proc_died(
                    proc.rank,
                    reason=f"daemon vpid {vpid} (host {node.name}) died")
            job.exited[proc.rank] = -9
        self._cv.notify_all()
        # notify's and selfheal's daemon-lost arms are non-blocking (an
        # xcast + a log line, no revive attempt) and take no plm locks,
        # so running them with self._cv held is safe — and the synthetic
        # exits above are already visible.  Policies exposing the batched
        # arm get the whole victim set in ONE call (one propagation
        # xcast per dead daemon instead of one per dead rank)
        if not victims:
            return
        batch = getattr(self._errmgr, "daemon_ranks_failed", None)
        if batch is not None:
            batch(self, job, victims)
        else:
            for proc in victims:
                self._errmgr.proc_failed(self, job, proc)

    def _daemon_monitor(self, job: Job) -> None:
        """Poll orted Popen handles: a dead daemon before job end = abort
        (first loss ends the watch — the job is coming down anyway) —
        EXCEPT under the notify policy, where the job continues and the
        monitor must keep watching for further daemon deaths: a
        non-HNP-child daemon's link EOF lands at its tree parent, not
        here, so Popen polling is the only detector the HNP always has.
        In DVM mode the monitor runs for the VM's lifetime."""
        handled: set[int] = set()
        notify = getattr(self._errmgr, "TOLERATES_DAEMON_LOSS", False)
        while True:
            if self._vm_stop.is_set():
                return
            with self._cv:
                # _killed is job-scoped on a persistent VM (reset per
                # submission): the monitor must outlive an aborted job
                if (not self._persistent
                        and (self._killed or len(job.exited) >= job.np)):
                    return
            for i, p in enumerate(self._daemon_popen):
                if i + 1 in handled:
                    continue
                if p.poll() is not None:
                    handled.add(i + 1)
                    self._on_daemon_lost(i + 1)
                    if not notify:
                        return
            time.sleep(0.25)

    def _on_abort(self, job: Job, rank: int, status: int, msg: str) -> None:
        proc = job.procs[rank]
        if job.aborted_proc is None:
            job.aborted_proc = proc
            job.abort_reason = f"rank {rank} called abort: {msg}"
            job.abort_status = status
        self.kill_job(job)

    # -- control -----------------------------------------------------------

    def kill_job(self, job: Job, exclude: Optional[Proc] = None) -> None:
        """errmgr entry point: xcast a jobid-scoped kill; the daemons
        SIGTERM/SIGKILL that job's ranks and drop its state — co-tenants
        on the same pool are untouched."""
        if job.killed or self.rml is None:
            return
        job.killed = True
        if not self._persistent:
            # single-job launch: the job dying means the VM is coming
            # down — keep the launcher-global latch for the monitor and
            # the daemon-loss teardown checks
            self._killed = True
        for p in job.procs:
            if p.state == ProcState.RUNNING and p is not exclude:
                p.state = ProcState.KILLED_BY_CMD
        self.rml.xcast(rml.TAG_KILL, job.jobid)

    def _start_stdin_pump(self, target) -> None:
        """IOF stdin forwarding (≈ iof.h:27-43; default target rank 0).
        Raw-fd reads, not sys.stdin.buffer: a daemon thread blocked in a
        buffered read holds the buffer lock, and interpreter shutdown
        aborts when it cannot reacquire it (the local launcher's rule)."""
        def pump() -> None:
            try:
                fd = sys.stdin.fileno()
            except (AttributeError, ValueError, OSError):
                fd = None   # stdin replaced (pytest capture)
            try:
                while fd is not None:
                    chunk = os.read(fd, 1 << 16)
                    if not chunk:
                        break
                    self.rml.xcast(rml.TAG_STDIN, (target, chunk))
            except (OSError, ValueError):
                pass
            try:
                self.rml.xcast(rml.TAG_STDIN, (target, None))  # EOF
            except Exception:
                pass

        threading.Thread(target=pump, daemon=True).start()

    def _my_address(self) -> str:
        """An address the daemons' hosts can dial: loopback when every
        node is this host (sim, or ssh to localhost), else the first
        address this host's names resolve to that is not loopback (the
        JAX package routes a UDP probe toward an outside address for it;
        the port asks only its own resolver).  A remote job on a host
        whose names resolve only to loopback (Debian-family /etc/hosts
        maps the host name to 127.0.1.1) fails here, before any rank is
        launched: remote ranks handed a loopback URI could never
        register."""
        import socket as _s

        local = {"localhost", "127.0.0.1", "::1", os.uname().nodename}
        if self.plm.NAME == "sim" or all(
                n.name in local for n in self._pool_nodes):
            return "127.0.0.1"
        for name in (_s.gethostname(), _s.getfqdn()):
            try:
                infos = _s.getaddrinfo(name, None, _s.AF_INET)
            except OSError:
                continue
            for *_rest, sockaddr in infos:
                if not sockaddr[0].startswith("127."):
                    return sockaddr[0]
        raise RuntimeError(
            f"plm: this host's names ({_s.gethostname()!r}) resolve only "
            "to loopback, so the remote daemons' ranks could not dial "
            "the PMIx server back; give the host name a routable address "
            "(DNS or /etc/hosts)")

    def _coord_env(self, job: Job) -> dict[str, str]:
        """The rendezvous of the job's process group: rank 0's host serves
        it on a port the HNP picks; every rank learns (coord, nhosts) and
        ``parallel.multihost.initialize_from_env()`` does the rest (the
        JAX package's ``jax.distributed`` coordinator env)."""
        import socket as _s

        if self.plm.NAME == "sim":
            # rank 0 binds on this host: a real free-port probe works
            with _s.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            host0 = "127.0.0.1"
        else:
            # rank 0 binds on its (remote) host, which the
            # HNP cannot probe — derive a port from the jobid in the
            # dynamic range to make collisions unlikely (the reference's
            # oob/tcp static-port story has the same limitation)
            port = 49152 + (job.jobid * 211 + os.getpid()) % 16000
            host0 = job.procs[0].node.name
        return {_launcher.ENV_COORD: f"{host0}:{port}",
                _launcher.ENV_NHOSTS: str(len(job.nodes))}

    # -- entry -------------------------------------------------------------

    def run(self, job: Job) -> int:
        self.sm.run_to_completion(job, JobState.INIT)
        if self.timed_out:
            return 124
        if job.aborted_proc is not None:
            output.show_help("launcher", "job-aborted",
                             jobid=job.jobid,
                             reason=job.abort_reason or "unknown")
            if job.abort_status is not None:
                return job.abort_status or 1
            rc = job.aborted_proc.exit_code or 1
            return 128 - rc if rc < 0 else rc
        return 0
